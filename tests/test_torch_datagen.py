"""The port's THOR datagen (``datagen/`` and ``cli/generate_thor_data.py``)
against the JAX package's, on the CPU. Datagen is numpy on the host in
both packages (the port's TSDF and voxel indices run on the CPU), so every
output must be equal, bit for bit:

- every case of ``tests/test_datagen.py``: the name rules, receptacle
  boxes, the alignment transform, the relation accumulator and the
  relation miner (its descriptions and the scene arrays it carves);
- ``tests/test_datagen_pipeline.py``'s chain: a synthetic datapoint ->
  ``scene_data_from_thor_datapoint`` -> ``write_scene_hdf5`` (every HDF5
  array equal) -> each package's ``generate_relevancy dataset`` writer on
  the CPU (maps within 2 float16 ulp of the largest, as
  ``tests/test_torch_relevancy_dataset.py`` holds them) -> the port's
  datasets (items equal to JAX's on the same file) -> one OVSSC train step
  (within rtol 1e-4 of JAX's, as ``tests/test_torch_vool.py`` holds one);
- ``generate_thor_data.main`` against ``tests/mock_ai2thor.py``, as
  ``tests/test_thor_datagen_driver.py`` runs JAX's: the same files with
  the same HDF5 arrays, the same controller calls, the resume skip.
"""
import copy
import os
import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mock_ai2thor
from semantic_abstraction_tpu import datagen as jdg
from semantic_abstraction_tpu.cli import generate_relevancy as jgr
from semantic_abstraction_tpu.cli import generate_thor_data as jgt
from semantic_abstraction_tpu.data import datasets as jds
from semantic_abstraction_tpu.runtime import train as jtrain
from semantic_abstraction_tpu_torch import datagen as tdg
from semantic_abstraction_tpu_torch.cli import generate_relevancy as tgr
from semantic_abstraction_tpu_torch.cli import generate_thor_data as tgt
from semantic_abstraction_tpu_torch.data import datasets as tds
from semantic_abstraction_tpu_torch.datagen import naming as tnaming
from semantic_abstraction_tpu_torch.models import convert as tconv
from semantic_abstraction_tpu_torch.runtime import train as ttrain
from test_datagen import RAW_NAMES, _toy_scene
from test_datagen_pipeline import DIST, SCENE_ID, _fake_datapoint, _fake_world
from test_thor_datagen_driver import _write_exported_pkl
from test_torch_data import assert_same
from torch_data_cases import jax_native  # noqa: F401 (a fixture)
from torch_net_cases import CASES, OPT, to_jax, to_torch


def assert_tree_equal(a, b, where=""):
    """Equal values: arrays bit for bit (dtype and shape included), dicts
    and sequences element by element."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, dict):
        assert list(a) == list(b), (where, list(a), list(b))
        for k in a:
            assert_tree_equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_tree_equal(x, y, f"{where}[{i}]")
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


# ---------------------------------------------------------------------------
# tests/test_datagen.py's cases
# ---------------------------------------------------------------------------


def test_the_port_exports_the_jax_names():
    assert tdg.__all__ == jdg.__all__
    for name in ("ALL_SCENES", "TEST_SCENES", "CAM_INTR", "SCENE_BOUNDS"):
        assert_tree_equal(getattr(tdg, name), getattr(jdg, name), name)


@pytest.mark.parametrize("raw", RAW_NAMES)
def test_class_reduction_matches_jax(raw):
    assert tdg.class_reduction_rule(raw) == jdg.class_reduction_rule(raw)
    assert tnaming.process_class_name(raw) == jdg.naming.process_class_name(raw)


@pytest.mark.parametrize("name", ["GarbageCan", "TVStand", "Mug", "CounterTop",
                                  "ShelvingUnit", "AreaRug"])
def test_normalize_object_type_matches_jax(name):
    assert tdg.normalize_object_type(name) == jdg.normalize_object_type(name)
    assert tdg.camel_case_split(name) == jdg.camel_case_split(name)


def test_receptacle_obb_matches_jax():
    line = "Cabinet_1|(1,0,0,0)(0,1,0,0)(0,0,1,0)(0,0,0,1)|(2,2,2)|(0,0,0)\n"
    tinfo, jinfo = tdg.parse_receptacle_line(line), jdg.parse_receptacle_line(line)
    assert_tree_equal(tinfo, jinfo)
    pts = np.random.RandomState(0).uniform(-2, 2, (200, 3))
    got = tdg.check_inside_receptacle(pts, tinfo)
    assert_tree_equal(got, jdg.check_inside_receptacle(pts, jinfo))
    assert got.any() and not got.all()


@pytest.mark.parametrize("dist", [2.0, 3.0])
def test_gt_alignment_transform_matches_jax(dist):
    pose = np.eye(4)
    pose[:3, 3] = [1.0, 2.0, 0.5]
    assert_tree_equal(tdg.gt_alignment_transform(pose, dist),
                      jdg.gt_alignment_transform(pose, dist))


def test_relation_accumulator_matches_jax():
    calls = [("mug", "on", "table"), ("mug", "behind", "table"),
             ("table", "in front of", "mug"), ("mug", "on", "table"),
             ("mug", "on", "floor"), ("mug", "behind", "ceiling light"),
             ("apple", "in", "fridge"), ("apple", "on the left of", "fridge")]
    accs = (tdg.RelationAccumulator(), jdg.RelationAccumulator())
    for i, (t, rel, r) in enumerate(calls):
        got = [a.should_add(t, rel, r) for a in accs]
        assert got[0] == got[1], (t, rel, r)
        if got[0]:
            for a in accs:
                a.add(t, rel, r, i)


def _mine(mod, scene, **kw):
    return mod.get_all_relations(scene_data=scene, **kw)


def test_directional_relation_matches_jax():
    kw = dict(receptacle_masks={},
              objects_info={"Table|1": {"objectType": "Table",
                                        "salientMaterials": ["Wood"],
                                        "parentReceptacles": None}},
              remapped_visible_obj_ids={"Table|1": 4, "Mug|1": 3},
              all_remapped_obj_ids={"Table|1": 4, "Mug|1": 3},
              visibility_pts_mask=np.zeros(400, bool))
    ts, js = _toy_scene(), _toy_scene()
    got, want = _mine(tdg, ts, **copy.deepcopy(kw)), _mine(jdg, js, **copy.deepcopy(kw))
    assert "behind" in want["spatial_relation_name"]
    assert_tree_equal(got, want)
    assert_tree_equal(ts, js)


def test_receptacle_relation_and_hidden_carving_match_jax():
    mask = np.zeros(400, bool)
    mask[200:] = True
    kw = dict(receptacle_masks={"Cabinet_1": {"mask": mask, "xyz_pts": None}},
              objects_info={
                  "Mug|1": {"objectType": "Mug", "salientMaterials": None,
                            "parentReceptacles": ["Cabinet|1"]},
                  "Cabinet|1": {"objectType": "Cabinet", "salientMaterials": ["Wood"],
                                "parentReceptacles": None}},
              remapped_visible_obj_ids={"Cabinet|1": 4},
              all_remapped_obj_ids={"Cabinet|1": 4, "Mug|1": 3},
              visibility_pts_mask=np.zeros(400, bool))
    scenes = []
    for _ in range(2):
        s = _toy_scene()
        s["objid_to_class"] = np.array(
            ["empty[0]", "wall[1]", "floor[2]", "mug[3]", "cabinet[4]"]).astype("S")
        scenes.append(s)
    got = _mine(tdg, scenes[0], **copy.deepcopy(kw))
    want = _mine(jdg, scenes[1], **copy.deepcopy(kw))
    assert "in" in want["spatial_relation_name"] and "banana" in want["target_obj_name"]
    assert_tree_equal(got, want)
    assert_tree_equal(scenes[0], scenes[1])  # the carved ids and the new classes


# ---------------------------------------------------------------------------
# tests/test_datagen_pipeline.py's chain
# ---------------------------------------------------------------------------


def _h5_arrays(path):
    """Every dataset of an HDF5 file by name, region references read
    through (``data/<key>`` holds refs into the top-level datasets)."""
    out = {}
    with h5py.File(str(path), "r") as f:
        def visit(name, obj):
            if not isinstance(obj, h5py.Dataset):
                return
            if obj.dtype == h5py.regionref_dtype:
                out[name] = [np.array(f[r][r]) for r in obj[()].reshape(-1)]
            else:
                out[name] = np.array(obj)
        f.visititems(visit)
    return out


@pytest.fixture(scope="module")
def chain(tmp_path_factory, jax_native):
    tmp = tmp_path_factory.mktemp("chain")
    rng = np.random.RandomState(0)
    exported, position, rotation = _fake_world(tmp, rng)
    datapoint = _fake_datapoint(rng, position, rotation)
    scenes = {}
    for name, mod in (("jax", jdg), ("port", tdg)):
        scenes[name] = mod.scene_data_from_thor_datapoint(
            np.random.RandomState(1), copy.deepcopy(datapoint), DIST, exported,
            num_output_pts=5000)
    dirs = {}
    for name, gt in (("jax", jgt), ("port", tgt)):
        d = tmp / name
        d.mkdir()
        gt.write_scene_hdf5(str(d / f"{SCENE_ID}_0.hdf5"), scenes[name])
        dirs[name] = d
    written = {k: _h5_arrays(d / f"{SCENE_ID}_0.hdf5") for k, d in dirs.items()}
    args = ["--random-weights", "--saliency_config", "chefer_et_al",
            "--compute_dtype", "float32"]
    jgr.main(["dataset", str(dirs["jax"])] + args)
    tgr.main(["dataset", str(dirs["port"])] + args + ["--device", "cpu"])
    return scenes, written, dirs


def test_scene_data_matches_jax(chain):
    scenes, _, _ = chain
    assert scenes["jax"] is not None and scenes["jax"]["full_xyz_pts"].shape == (1, 5000, 3)
    assert "on" in scenes["jax"]["descriptions"]["spatial_relation_name"]
    assert_tree_equal(scenes["port"], scenes["jax"])


def test_written_scene_hdf5_matches_jax(chain):
    _, written, _ = chain
    assert "data/descriptions/spatial_relation_name" in written["jax"]
    assert written["port"].keys() == written["jax"].keys()
    for k in written["jax"]:
        assert_tree_equal(written["port"][k], written["jax"][k], k)


def test_relevancy_writer_on_the_datagen_scene_matches_jax(chain):
    _, _, dirs = chain
    key = "rgb|chefer_et_al"
    stored = {}
    for name, d in dirs.items():
        with h5py.File(str(d / f"{SCENE_ID}_0.hdf5"), "r") as f:
            g = f["data/saliencies"]
            stored[name] = (np.array(g[key + "|saliency_text_labels"]),
                            np.array(g[key + "|saliency_text_label_features"]),
                            np.stack([np.array(f["saliencies"][r])[0] for r in g[key][:]]))
    (jl, jf, jm), (tl, tf, tm) = stored["jax"], stored["port"]
    assert tl.tobytes() == jl.tobytes() and tm.shape == jm.shape
    np.testing.assert_allclose(tf, jf, atol=1e-5, rtol=0)
    assert np.abs(jm).max() > 0
    assert np.abs(tm - jm).max() <= 2.0**-9 * np.abs(jm).max()


def _items(d, kind):
    out = []
    for mod in (jds, tds):
        cfg = mod.DataConfig(num_input_pts=256, num_output_pts=256,
                             saliency_config="chefer_et_al", domain_randomization=False)
        cls = mod.SceneCompletionDataset if kind == "ovssc" else mod.ObjectLocalizationDataset
        out.append(cls(str(d), [f"{SCENE_ID}_0.hdf5"], cfg)[0])
    return out


@pytest.mark.parametrize("kind", ["ovssc", "vool"])
def test_datasets_read_the_datagen_scene_like_jax(chain, kind):
    _, _, dirs = chain
    want, got = _items(dirs["port"], kind)
    assert_same(want, got, kind)
    if kind == "ovssc":
        assert got["input_feature_pts"].shape == (4, 256, 1)
        assert got["output_label_pts"].sum() > 0
    else:
        assert not got["padding_mask"].all()


def test_train_step_on_the_datagen_scene_matches_jax(chain):
    _, _, dirs = chain
    _, item = _items(dirs["port"], "ovssc")
    keys = ("input_xyz_pts", "input_feature_pts", "output_xyz_pts", "output_label_pts",
            "out_of_bounds_pts", "out_of_frustum_pts_mask", "padding_mask")
    b = {k: np.asarray(item[k])[None] for k in keys}
    b["output_label_pts"] = b["output_label_pts"].astype(np.float32)
    case = CASES["ovssc/semantic_abstraction"]
    params = case.jax_params(0)
    jtx = jtrain.make_optimizer(**OPT)
    _, js = jtrain.make_train_step(case.jax_loss(), case.jcfg, jtx,
                                   compute_dtype=jnp.float32, donate=False)(
        jtrain.init_train_state(jax.tree_util.tree_map(jnp.asarray, params), jtx), to_jax(b))
    ttx = ttrain.make_optimizer(**OPT)
    _, ts = ttrain.make_train_step(case.torch_loss(), case.tcfg, ttx,
                                   compute_dtype=torch.float32)(
        ttrain.init_train_state(tconv.from_jax_params(params, case.tcfg, device="cpu"), ttx),
        to_torch(b))
    for k in ("loss", "accuracy", "grad_norm"):
        np.testing.assert_allclose(float(ts[k]), float(js[k]), rtol=1e-4, err_msg=k)


# ---------------------------------------------------------------------------
# generate_thor_data against the mock simulator
# ---------------------------------------------------------------------------


@pytest.fixture()
def thor_mock():
    ctrl = mock_ai2thor.install()
    yield ctrl
    mock_ai2thor.uninstall()


def test_generate_thor_data_matches_jax(thor_mock, tmp_path):
    exp = tmp_path / "exported"
    exp.mkdir()
    rng = np.random.RandomState(0)
    for scene_id in jdg.TEST_SCENES[:2]:
        _write_exported_pkl(str(exp), scene_id, rng)
    argv = ["--exported-scenes", str(exp), "--num-datapoints", "2", "--workers", "1",
            "--test-only", "--num-output-pts", "4000"]
    calls = {}
    for name, gt in (("jax", jgt), ("port", tgt)):
        thor_mock.created.clear()
        thor_mock.instances.clear()
        gt.main([str(tmp_path / name)] + argv)
        calls[name] = (list(thor_mock.created),
                       [(c.teleports, c.randomize_calls, c.stopped)
                        for c in thor_mock.instances])
    assert calls["port"] == calls["jax"] and len(calls["jax"][0]) == 2
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == [f"{jdg.TEST_SCENES[0]}_0.hdf5", f"{jdg.TEST_SCENES[1]}_1.hdf5"]
    assert sorted(os.listdir(tmp_path / "port")) == files
    for f in files:
        want, got = _h5_arrays(tmp_path / "jax" / f), _h5_arrays(tmp_path / "port" / f)
        assert "data/domain_randomized_rgb" in want
        assert got.keys() == want.keys()
        for k in want:
            assert_tree_equal(got[k], want[k], f"{f}:{k}")
    # resume: a second sweep of the port skips the existing files
    mtimes = {f: os.path.getmtime(tmp_path / "port" / f) for f in files}
    thor_mock.created.clear()
    tgt.main([str(tmp_path / "port")] + argv)
    assert thor_mock.created == []
    assert {f: os.path.getmtime(tmp_path / "port" / f) for f in files} == mtimes


def test_generate_thor_data_without_ai2thor_exits_with_the_jax_message(tmp_path, monkeypatch):
    mock_ai2thor.uninstall()
    monkeypatch.setitem(sys.modules, "ai2thor", None)
    msgs = []
    for gt in (jgt, tgt):
        with pytest.raises(SystemExit) as e:
            gt.run_simulator("FloorPlan1_physics", False, np.random.RandomState(0))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "ai2thor is required" in msgs[0]

