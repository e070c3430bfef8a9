"""The port's ``generate_relevancy dataset`` writer against the JAX
package's, on the CPU.

- ``_scene_labels``: the stored label array byte for byte JAX's, on scenes
  with synonyms, ground truth, descriptions and neither.
- The whole writer against JAX's ``cmd_dataset`` on copies of one corpus,
  ``--random-weights`` (both packages draw the same ViT-B/32 for a seed),
  ``chefer_et_al`` (no jitter) and f32: stored labels equal, features
  within atol 1e-5, and maps within 2 float16 ulp of the largest map value
  (``max|diff| <= 2**-9 * max|map|``, the tolerance of
  ``tests/test_torch_saliency.py``: the f32 pipelines agree to ~1e-6 and
  the maps are rounded to float16 before they are stored).
- The port alone: resume, overwrite truncation, ``--num-shards``
  disjointness, the store shape, and the pipelined loop on the CPU.

Each package's extractor is built once for the file (``build_saliency``
is patched to hand out the cached one)."""
import os
import shutil

import h5py
import numpy as np
import pytest
import torch

from semantic_abstraction_tpu.cli import generate_relevancy as jgr
from semantic_abstraction_tpu_torch.cli import generate_relevancy as tgr
from synthetic_scene import make_scene

ARGS = ["--random-weights", "--saliency_config", "chefer_et_al",
        "--compute_dtype", "float32"]
PORT_ARGS = ARGS + ["--device", "cpu"]


@pytest.fixture(scope="module")
def extractors():
    return {}


@pytest.fixture(autouse=True)
def cached_saliency(extractors, monkeypatch):
    for mod in (jgr, tgr):
        build = mod.build_saliency

        def cached(args, mod=mod, build=build):
            if mod not in extractors:
                extractors[mod] = build(args)
            return extractors[mod]

        monkeypatch.setattr(mod, "build_saliency", cached)


def _strip(path):
    with h5py.File(str(path), "a") as f:
        del f["data/saliencies"]
        del f["saliencies"]


def _corpus(d, seeds=(1, 2), **kw):
    names = []
    for i, seed in enumerate(seeds):
        name = f"FloorPlan{i + 1}_physics_0.hdf5"
        make_scene(os.path.join(str(d), name), np.random.RandomState(seed), h=32, w=32, **kw)
        _strip(os.path.join(str(d), name))
        names.append(name)
    return names


def _stored(path, key="rgb|chefer_et_al"):
    with h5py.File(str(path), "r") as f:
        g = f["data/saliencies"]
        labels = np.array(g[key + "|saliency_text_labels"])
        feats = np.array(g[key + "|saliency_text_label_features"])
        maps = np.stack([np.array(f["saliencies"][r])[0] for r in g[key][:]])
        rows = f["saliencies"].shape
    return labels, feats, maps, rows


def test_scene_labels_match_jax(tmp_path):
    cases = [dict(classes=("chair", "television", "sofa")),
             dict(classes=("chair", "table"), num_descs=1),
             dict(classes=("bed", "armchair", "sofa", "desk"), num_descs=5)]
    for i, kw in enumerate(cases):
        path = make_scene(tmp_path / f"s{i}.hdf5", np.random.RandomState(i), **kw)
        if i == 1:  # no ground truth: every objid class, seg or not
            with h5py.File(path, "a") as f:
                del f["data/full_objid_pts"]
        with h5py.File(path, "r") as f:
            for use_gt in (True, False):
                want, got = jgr._scene_labels(f, use_gt), tgr._scene_labels(f, use_gt)
                assert got == want
                stored = np.array(got + ["mean"]).astype("S")
                assert stored.tobytes() == np.array(want + ["mean"]).astype("S").tobytes()
                assert stored.dtype == np.array(want + ["mean"]).astype("S").dtype


def test_writer_matches_jax(tmp_path):
    a, b = tmp_path / "jax", tmp_path / "port"
    a.mkdir()
    names = _corpus(a)
    shutil.copytree(a, b, dirs_exist_ok=True)
    jgr.main(["dataset", str(a)] + ARGS)
    tgr.main(["dataset", str(b)] + PORT_ARGS)
    for name in names:
        jl, jf, jm, jrows = _stored(a / name)
        tl, tf, tm, trows = _stored(b / name)
        assert tl.dtype == jl.dtype and tl.tobytes() == jl.tobytes()
        assert trows == jrows and tm.shape == jm.shape == (len(jl), 32, 32)
        np.testing.assert_allclose(tf, jf, atol=1e-5, rtol=0)
        np.testing.assert_allclose(np.linalg.norm(tf, axis=-1), 1.0, atol=1e-5)
        assert np.abs(jm).max() > 0
        assert np.abs(tm - jm).max() <= 2.0**-9 * np.abs(jm).max()


def test_resume_skips_done_scenes(tmp_path):
    names = _corpus(tmp_path, seeds=(3,))
    (tmp_path / "FloorPlan0_corrupt_0.hdf5").write_bytes(b"not an hdf5 file")
    tgr.main(["dataset", str(tmp_path)] + PORT_ARGS)
    path = tmp_path / names[0]
    before = os.path.getmtime(path)
    labels = _stored(path)[0]
    assert b"mean" in labels.tolist() and b"couch" in labels.tolist()
    tgr.main(["dataset", str(tmp_path)] + PORT_ARGS)
    assert os.path.getmtime(path) == before


def test_overwrite_truncates_rows(tmp_path):
    names = _corpus(tmp_path, seeds=(5,))
    path = tmp_path / names[0]
    tgr.main(["dataset", str(tmp_path)] + PORT_ARGS)
    labels, _, _, rows1 = _stored(path)
    tgr.main(["dataset", str(tmp_path)] + PORT_ARGS + ["--overwrite", "--seed", "1"])
    _, _, maps, rows2 = _stored(path)
    assert rows2 == rows1  # truncated, not appended
    mean_idx = labels.tolist().index(b"mean")
    with h5py.File(str(path), "r") as f:
        np.testing.assert_array_equal(np.array(f["saliencies"][mean_idx]), maps[mean_idx])


def test_foreign_group_appends_with_a_warning(tmp_path, caplog):
    """Another config's refs point into the rows: a rewrite appends (the
    reference's semantics) and says so."""
    names = _corpus(tmp_path, seeds=(6,))
    path = tmp_path / names[0]
    tgr.main(["dataset", str(tmp_path)] + PORT_ARGS)
    with h5py.File(str(path), "a") as f:
        g = f["data/saliencies"]
        for suffix in ("", "|saliency_text_labels", "|saliency_text_label_features"):
            g["rgb|ours" + suffix] = np.array(g["rgb|chefer_et_al" + suffix])
        rows1 = f["saliencies"].shape[0]
    tgr.main(["dataset", str(tmp_path), "--overwrite"] + PORT_ARGS)
    assert any("foreign groups" in r.message for r in caplog.records)
    with h5py.File(str(path), "r") as f:
        assert f["saliencies"].shape[0] == 2 * rows1


def test_num_shards_are_disjoint_and_complete(tmp_path):
    names = _corpus(tmp_path, seeds=(7, 8, 9))

    def done():
        out = set()
        for n in names:
            with h5py.File(str(tmp_path / n), "r") as f:
                if "data/saliencies/rgb|chefer_et_al" in f:
                    out.add(n)
        return out

    tgr.main(["dataset", str(tmp_path), "--num-shards", "2", "--shard-id", "0"] + PORT_ARGS)
    assert done() == {names[0], names[2]}
    tgr.main(["dataset", str(tmp_path), "--num-shards", "2", "--shard-id", "1"] + PORT_ARGS)
    assert done() == set(names)


@pytest.mark.parametrize("prealloc", [True, False])
def test_store_shape(tmp_path, prealloc):
    """A preallocated ``saliencies`` fixes the store shape and wins over
    ``--store-shape``; the maps are cut to it on the device by the same
    gather as the host's nearest-exact resize."""
    path = make_scene(tmp_path / "FloorPlan1_physics_0.hdf5", np.random.RandomState(4),
                      h=32, w=32, rel_h=16, rel_w=8)
    with h5py.File(path, "a") as f:
        del f["data/saliencies"]
        if not prealloc:
            del f["saliencies"]
    tgr.main(["dataset", str(tmp_path), "--store-shape", "8", "16"] + PORT_ARGS)
    _, _, maps, rows = _stored(path)
    assert rows[1:] == ((16, 8) if prealloc else (8, 16))


def test_nearest_exact_gather_matches_jax_and_the_host():
    import jax.numpy as jnp

    from semantic_abstraction_tpu_torch.data.transforms import resize_nearest_exact_np

    maps = np.random.RandomState(13).randn(5, 48, 64).astype(np.float16)
    for out_hw in ((24, 32), (16, 20), (48, 64)):
        got = tgr.nearest_exact(torch.as_tensor(maps), out_hw).numpy()
        want = np.asarray(jgr._nearest_exact_device((48, 64), out_hw)(jnp.asarray(maps)))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, resize_nearest_exact_np(maps, out_hw))


def test_pipelined_writes_each_item_once_in_order():
    seen, errors = [], []

    def extract(i):
        if i == 2:
            raise ValueError("bad scene")
        return [torch.full((2, 3), float(i)), torch.arange(4) + i]

    def write(i, arrays):
        if i == 4:
            raise OSError("disk full")
        seen.append((i, [a.copy() for a in arrays]))

    stats = []
    failures = tgr.pipelined(range(6), extract, write, "cpu",
                             on_error=lambda i, e: errors.append((i, type(e))),
                             stats=stats)
    assert failures == 2 and errors == [(2, ValueError), (4, OSError)]
    assert [i for i, _ in seen] == [0, 1, 3, 5]
    for i, (m, v) in seen:
        np.testing.assert_array_equal(m, np.full((2, 3), float(i), np.float32))
        np.testing.assert_array_equal(v, np.arange(4) + i)
    assert [s["bytes"] for s in stats] == [56] * 4
    assert all(s["copy_ms"] is None and s["overlapped"] is None and s["wait_ms"] == 0
               for s in stats)
    with pytest.raises(ValueError):
        tgr.pipelined(range(3), extract, write, "cpu")


def test_dataset_parser_has_no_label_bucket():
    with pytest.raises(SystemExit):
        tgr.parser().parse_args(["dataset", "d", "--label-bucket", "4"])
    args = tgr.parser().parse_args(["dataset", "d"])
    assert args.device == "cuda" and args.prompt is None
    assert tgr.dataset_prompt(args) == tgr.THOR_PROMPT == jgr.THOR_PROMPT
    args.file_path = "/data/nyu/scenes"
    assert tgr.dataset_prompt(args) == tgr.DEFAULT_PROMPT == jgr.DEFAULT_PROMPT
