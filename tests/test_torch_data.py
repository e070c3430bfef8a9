"""The port's input pipeline against the JAX package's, on the CPU: the
numpy transforms, the native loader kernels and their numpy twins, the HDF5
helpers, dataset items and loader batches.

Both packages run the same numpy on the same files and seeds, so every
comparison here is bit for bit (``assert_array_equal`` and equal dtypes),
with no tolerance.
"""
import os
import subprocess
import sys
import warnings

import h5py
import numpy as np
import pytest

from semantic_abstraction_tpu import native as jnative
from semantic_abstraction_tpu.data import datasets as jds
from semantic_abstraction_tpu.data import loader as jld
from semantic_abstraction_tpu.data import transforms as jtf
from semantic_abstraction_tpu_torch import native as tnative
from semantic_abstraction_tpu_torch.data import datasets as tds
from semantic_abstraction_tpu_torch.data import hdf5 as th5
from semantic_abstraction_tpu_torch.data import loader as tld
from semantic_abstraction_tpu_torch.data import transforms as ttf
from torch_data_cases import jax_native, make_corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUNDS = np.array([[-1.0, -1.0, -0.1], [1.0, 1.0, 1.9]])


@pytest.fixture(scope="module", autouse=True)
def jax_native_loaded(jax_native):
    """The JAX package's items and samples take its native kernels."""
    return jax_native


def assert_same(a, b, where=""):
    """Equal values of equal types: arrays bit for bit with one dtype,
    lists and dicts element by element."""
    assert type(a) is type(b), (where, type(a), type(b))
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype,
                                                           a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, dict):
        assert list(a) == list(b), (where, list(a), list(b))
        for k in a:
            assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    else:
        assert a == b, (where, a, b)


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------


def _pose(th=0.3):
    pose = np.eye(4)
    pose[:3, :3] = [[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]]
    pose[:3, 3] = [0.1, -0.2, 0.3]
    return pose


INTR = np.array([[20.0, 0, 16], [0, 20.0, 12], [0, 0, 1]])


def _transform_cases():
    """name -> fn(module, rs) returning the value to compare."""
    def pts(rs, n=2000):
        return ((rs.rand(n, 3) - 0.3) * 3).astype(np.float32)

    def subsample(mod, rs, k, replace, transform):
        n = 500
        xyz = pts(rs, n)
        probs = rs.rand(n)
        return mod.transform_filter_subsample(
            xyz, BOUNDS, k, probs, replace, np.random.RandomState(3),
            transform_matrix=(jtf.random_domain_transform(
                np.random.RandomState(4), BOUNDS, 0.1, 0.3, 0.1) if transform else None),
            feats=rs.rand(n, 2).astype(np.float32),
            stacked=rs.rand(3, n, 1).astype(np.float32),
            ids=rs.randint(0, 9, n).astype(np.int32), none=None)

    return {
        "depth_to_pointcloud": lambda m, rs: m.depth_to_pointcloud_np(
            rs.uniform(0.5, 2, (12, 16)).astype(np.float32), INTR),
        "depth_to_pointcloud_posed": lambda m, rs: m.depth_to_pointcloud_np(
            rs.uniform(0.5, 2, (12, 16)).astype(np.float32), INTR, _pose()),
        "check_pts_in_frustum": lambda m, rs: m.check_pts_in_frustum_np(
            pts(rs), (24, 32), _pose(), INTR),
        "check_pts_in_frustum_f64": lambda m, rs: m.check_pts_in_frustum_np(
            pts(rs).astype(np.float64), (24, 32), _pose(), INTR),
        "filter_pts_bounds": lambda m, rs: m.filter_pts_bounds_np(pts(rs), BOUNDS),
        "filter_pts_bounds_f64": lambda m, rs: m.filter_pts_bounds_np(
            pts(rs).astype(np.float64), BOUNDS),
        "filter_pts_bounds_batched": lambda m, rs: m.filter_pts_bounds_np(
            pts(rs).reshape(4, -1, 3), BOUNDS),
        "euler2mat": lambda m, rs: m.euler2mat(*rs.randn(3)),
        "compose_affine": lambda m, rs: m.compose_affine(
            rs.randn(3), m.euler2mat(*rs.randn(3)), rs.rand(3) + 1),
        "random_domain_transform": lambda m, rs: m.random_domain_transform(
            rs, BOUNDS, 0.1, 0.3, 0.1),
        "weighted_sample": lambda m, rs: m.weighted_sample(rs, rs.rand(300), 40, False),
        "weighted_sample_replace": lambda m, rs: m.weighted_sample(
            rs, rs.rand(300), 400, True),
        "transform_filter_subsample": lambda m, rs: subsample(m, rs, 64, False, False),
        "transform_filter_subsample_dr": lambda m, rs: subsample(m, rs, 64, False, True),
        "transform_filter_subsample_replace": lambda m, rs: subsample(m, rs, 900, False, True),
        "transform_filter_subsample_all": lambda m, rs: subsample(m, rs, -1, False, True),
        "compute_empty_mask": lambda m, rs: m.compute_empty_mask(
            BOUNDS, rs.uniform(0.5, 2, (24, 24)), INTR, _pose(), 10),
        "balanced_class_subsample": lambda m, rs: m.balanced_class_subsample(
            rs.randint(0, 4, 500), 60, rs),
        "balanced_class_subsample_flat": lambda m, rs: m.balanced_class_subsample(
            rs.randint(0, 4, 500), 60, rs, balanced=False),
        "resize_bilinear": lambda m, rs: m.resize_bilinear_np(
            rs.randn(3, 12, 16).astype(np.float32), (24, 32)),
        "resize_bilinear_f64_down": lambda m, rs: m.resize_bilinear_np(
            rs.randn(2, 24, 32), (7, 9)),
        "resize_nearest_exact": lambda m, rs: m.resize_nearest_exact_np(
            rs.randn(3, 24, 32).astype(np.float32), (12, 10)),
        "balanced_subsample_probabilities": lambda m, rs: m.balanced_subsample_probabilities(
            (rs.rand(200) < 0.2).astype(np.float32)),
    }


TRANSFORM_CASES = _transform_cases()


@pytest.mark.parametrize("native_on", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("name", sorted(TRANSFORM_CASES))
def test_transform_matches_jax(name, native_on, monkeypatch):
    """Each transform bit for bit, with the native kernels and with their
    numpy twins (both packages' ``native`` switched off)."""
    if not native_on:
        for mod in (jnative, tnative):
            monkeypatch.setattr(mod, "_TRIED", True)
            monkeypatch.setattr(mod, "_LIB", None)
    fn = TRANSFORM_CASES[name]
    assert_same(fn(jtf, np.random.RandomState(7)), fn(ttf, np.random.RandomState(7)), name)


# ---------------------------------------------------------------------------
# native
# ---------------------------------------------------------------------------


def test_native_builds_and_matches_jax_and_the_numpy_twins():
    assert tnative.available() and jnative.available()
    rs = np.random.RandomState(0)
    pts = ((rs.rand(20000, 3) - 0.3) * 3).astype(np.float32)
    pts[:4] = [[-1.0, -1.0, -0.1], [1.0, 1.0, 1.9], [-1.0000001, 0, 0], [1.0000001, 0, 0]]
    ref = np.all((pts >= BOUNDS[0]) & (pts <= BOUNDS[1]), axis=-1)
    assert_same(tnative.bounds_mask(pts, BOUNDS), ref)
    assert_same(tnative.bounds_mask(pts, BOUNDS), jnative.bounds_mask(pts, BOUNDS))
    pose, intr = _pose(), np.array([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]])
    inv = np.linalg.inv(pose)
    cam = pts @ inv[:3, :3].T + inv[:3, 3]
    z = cam[:, 2]
    sz = np.where(z == 0, 1e-12, z)
    px = intr[0, 0] / sz * cam[:, 0] + intr[0, 2]
    py = intr[1, 1] / sz * cam[:, 1] + intr[1, 2]
    ref = (px >= 0) & (px < 640) & (py >= 0) & (py < 480) & (z > 0)
    assert_same(tnative.frustum_mask(pts, (480, 640), pose, intr), ref)
    assert_same(tnative.frustum_mask(pts, (480, 640), pose, intr),
                jnative.frustum_mask(pts, (480, 640), pose, intr))
    assert tnative.bounds_mask(pts.astype(np.float64), BOUNDS) is None


@pytest.mark.parametrize("replace", [False, True])
def test_native_weighted_sample_matches_jax(replace):
    p = np.random.RandomState(1).rand(5000)
    p[:100] = 0.0
    k = 3000 if replace else 400
    a = tnative.weighted_sample(np.random.RandomState(2), p, k, replace)
    b = jnative.weighted_sample(np.random.RandomState(2), p, k, replace)
    assert_same(a, b)
    if not replace:
        assert len(np.unique(a)) == k and (p[a] > 0).all()
    with pytest.raises(ValueError):
        tnative.weighted_sample(np.random.RandomState(2), p, 4950, False)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32, np.int64, np.uint8,
                                   np.int16])
def test_native_gathers_match_numpy(dtype):
    rs = np.random.RandomState(3)
    src = (rs.rand(500, 7) * 100).astype(dtype)
    idx = rs.randint(0, 500, 200)
    assert_same(tnative.gather_rows(src, idx), src[idx])
    assert_same(tnative.gather_rows(src[:, 0], idx), src[idx, 0])
    stacked = (rs.rand(3, 500, 2) * 100).astype(dtype)
    assert_same(tnative.gather_axis1(stacked, idx), stacked[:, idx])
    with pytest.raises(IndexError):
        tnative.gather_rows(np.zeros((10, 2), np.float32), np.array([11]))


_BUILD_ONE = """
import sys
from semantic_abstraction_tpu_torch import native
native.BUILD_DIR = sys.argv[1]
assert native.available()
"""


def test_native_builds_race_free_across_processes(tmp_path):
    """Four processes build into one empty directory at once: each writes
    its own temporary name and renames it, so all load one library and no
    temporary is left."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = REPO
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_ONE, str(tmp_path)],
                              env=env, cwd=REPO, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    for p in procs:
        _, err = p.communicate(timeout=240)
        assert p.returncode == 0, err
    names = os.listdir(tmp_path)
    assert len(names) == 1 and names[0].endswith(".so"), names


def test_native_build_failure_warns(tmp_path, monkeypatch):
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(tnative, "_SRC", str(tmp_path / "missing.cc"))
    (tmp_path / "missing.cc").write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "_TRIED", False)
    monkeypatch.setattr(tnative, "_LIB", None)
    with pytest.warns(RuntimeWarning, match="numpy twins run instead"):
        assert not tnative.available()
    assert os.listdir(tmp_path) == ["missing.cc"]  # the temporary is gone


# ---------------------------------------------------------------------------
# hdf5
# ---------------------------------------------------------------------------


def test_hdf5_helpers_round_trip(tmp_path):
    from semantic_abstraction_tpu.data import hdf5 as jh5

    path = str(tmp_path / "scene.hdf5")
    struct = th5.get_datastructure((6, 8), (3, 4), (2, 2, 2), 10)
    assert struct == jh5.get_datastructure((6, 8), (3, 4), (2, 2, 2), 10)
    th5.init_dataset(path, struct)
    rs = np.random.RandomState(0)
    depth = rs.rand(2, 6, 8).astype(np.float32)
    with h5py.File(path, "a") as f:
        assert f["rgb"].compression == "gzip" and f["rgb"].maxshape == (None, 6, 8, 3)
        refs = th5.resize_and_add_data(f["depth"], depth)
        f["data/depth"] = np.array(refs, h5py.regionref_dtype)
        th5.write_to_hdf5(f, "meta", {"name": "x", "n": 3, "arr": np.arange(4)})
        with pytest.raises(KeyError):
            th5.write_to_hdf5(f, "meta", {"n": 4})
        th5.write_to_hdf5(f, "meta", {"n": 4}, replace=True)
    with h5py.File(path, "r") as f:
        got = th5.deref_h5py(f["depth"], f["data/depth"])
        assert_same(got, depth)
        assert_same(got, jh5.deref_h5py(f["depth"], f["data/depth"]))
        assert_same(th5.deref_h5py(f["depth"], []), np.zeros((0, 6, 8), np.float32))
        assert f["meta"].attrs["n"] == 4 and "arr" not in f["meta"]


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    names = make_corpus(d, n_scenes=3, splits={"train": [0, 1, 2]})
    return str(d), names


CFG = dict(num_input_pts=256, num_output_pts=128, seed=5)
DS_CASES = {
    "dr": dict(cfg=dict(CFG)),
    "no_dr": dict(cfg=dict(CFG, domain_randomization=False)),
    "return_vis": dict(cfg=dict(CFG, domain_randomization=False), return_vis=True),
    "synonyms": dict(cfg=dict(CFG), use_synonyms=True),
    "dr_rgb": dict(cfg=dict(CFG), domain_randomized_rgb=True),
    "patch_masks_vmin_noise": dict(cfg=dict(
        CFG, network_inputs=("patch_masks", "saliency"), saliency_vmin=0.001,
        xyz_pts_noise=0.01, offset_patch_mask=True, num_patches=5, num_descs=5)),
    "unbalanced_replace": dict(cfg=dict(
        CFG, balance_spatial_sampling=False, balance_spatial_relations=False,
        always_replace_subsample_pts=True, num_output_pts=700)),
    "rgb": dict(cfg=dict(CFG, network_inputs=("rgb",))),
}


def _datasets(kind, corpus, case):
    d, names = corpus
    kw = {k: v for k, v in case.items() if k != "cfg"}
    out = []
    for mod in (jds, tds):
        cls = mod.SceneCompletionDataset if kind == "ovssc" else mod.ObjectLocalizationDataset
        out.append(cls(d, names, mod.DataConfig(**case["cfg"]), **kw))
    return out


@pytest.mark.parametrize("case", sorted(DS_CASES))
@pytest.mark.parametrize("kind", ["ovssc", "vool"])
def test_dataset_items_match_jax(kind, case, corpus):
    """Every item of every scene at two epochs, key for key and bit for bit."""
    jd, td = _datasets(kind, corpus, DS_CASES[case])
    assert len(jd) == len(td) == 3
    for epoch in (0, 3):
        jd.set_epoch(epoch)
        td.set_epoch(epoch)
        for i in range(len(td)):
            assert_same(jd[i], td[i], f"{kind}/{case} epoch {epoch} item {i}")


def test_gt_seg_items_match_jax(corpus):
    d, names = corpus
    cfg = dict(CFG, subtract_mean_relevancy=False)
    jd = jds.SceneCompletionDataset(d, names, jds.DataConfig(**cfg), use_gt_seg=True)
    td = tds.SceneCompletionDataset(d, names, tds.DataConfig(**cfg), use_gt_seg=True)
    for i in range(len(td)):
        assert_same(jd[i], td[i], f"gt_seg item {i}")


@pytest.mark.parametrize("kind", ["ovssc", "vool"])
def test_tsdf_items_match_jax(kind, corpus, monkeypatch):
    """The ``tsdf`` input: every other key bit for bit, and ``tsdf_vol``
    within atol 1e-5 of JAX's except at voxels whose pixel or truncation
    test sits at a rounding tie (``test_torch_fusion.tie_voxels``, from the
    frame JAX fused); those are counted, and here there are none."""
    from semantic_abstraction_tpu.ops import fusion as jfu
    from test_torch_fusion import tie_voxels

    fused = []
    integrate = jfu.TSDFVolume.integrate

    def spy(self, color_im, depth_im, cam_intr, cam_pose, obs_weight=1.0):
        fused.append((self, (np.asarray(depth_im, np.float32),
                             np.asarray(cam_intr, np.float32), np.asarray(cam_pose))))
        return integrate(self, color_im, depth_im, cam_intr, cam_pose, obs_weight)

    monkeypatch.setattr(jfu.TSDFVolume, "integrate", spy)
    case = dict(cfg=dict(CFG, network_inputs=("saliency", "tsdf"), tsdf_shape=(32, 32, 32)))
    jd, td = _datasets(kind, corpus, case)
    differ_at_ties = 0
    for i in range(len(td)):
        fused.clear()
        j, t = jd[i], td[i]
        jt, tt = j.pop("tsdf_vol"), t.pop("tsdf_vol")
        assert_same(j, t, f"{kind} tsdf item {i}")
        assert tt.shape == jt.shape == (32, 32, 32) and tt.dtype == jt.dtype == np.float32
        assert (jt != -1).any() and (jt == -1).any()  # observed and unobserved voxels
        (vol, frame), = fused
        ties = tie_voxels(np.asarray(vol._vox_world), [frame], vol._trunc_margin)
        differ = (np.abs(tt - jt) > 1e-5).reshape(-1)
        assert not (differ & ~ties).any(), f"item {i}: {(differ & ~ties).sum()} voxels"
        differ_at_ties += int(differ.sum())
    assert differ_at_ties == 0


def test_synonyms_and_relations_are_the_jax_tables():
    from semantic_abstraction_tpu.models.nets import RELATION_TO_ID
    from semantic_abstraction_tpu_torch.models.nets import RELATION_TO_ID as T_ID

    assert tds.SYNONYMS == jds.SYNONYMS and tds.INV_SYNONYMS == jds.INV_SYNONYMS
    assert T_ID == RELATION_TO_ID


# ---------------------------------------------------------------------------
# loader
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shards", [1, 3])
@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("n", [0, 7, 10])
def test_sharded_sampler_matches_jax(n, shuffle, drop_last, shards):
    for shard in range(shards):
        kw = dict(num_shards=shards, shard_id=shard, shuffle=shuffle, seed=2**33 + 5,
                  drop_last=drop_last)
        js, ts = jld.ShardedSampler(n, **kw), tld.ShardedSampler(n, **kw)
        for epoch in (0, 4):
            js.set_epoch(epoch)
            ts.set_epoch(epoch)
            assert_same(ts.indices_with_pad(), js.indices_with_pad())


@pytest.mark.parametrize("kind", ["ovssc", "vool"])
def test_collate_and_collate_padded_match_jax(kind, corpus):
    """Train items (static shapes) through ``collate``; ragged
    ``return_vis`` items through ``collate_padded`` at two buckets."""
    jd, td = _datasets(kind, corpus, DS_CASES["no_dr"])
    jitems = [jd[i] for i in range(3)]
    titems = [td[i] for i in range(3)]
    assert_same(tld.collate(titems), jld.collate(jitems))
    jd, td = _datasets(kind, corpus, DS_CASES["return_vis"])
    jitems = [jd[i] for i in range(3)]
    titems = [td[i] for i in range(3)]
    for bucket in (64, 2048):
        assert_same(tld.collate_padded(titems, bucket), jld.collate_padded(jitems, bucket))


LOADER_CASES = {
    "train": dict(case="dr", batch_size=2, drop_last=True, shuffle=True),
    "eval_padded": dict(case="return_vis", batch_size=2, pad_to_full_batches=True,
                        pad_static_shapes=True, point_bucket=256),
    "eval_sharded": dict(case="return_vis", batch_size=1, num_shards=2, shard_id=1),
}


@pytest.mark.parametrize("num_workers", [0, 2])
@pytest.mark.parametrize("name", sorted(LOADER_CASES))
@pytest.mark.parametrize("kind", ["ovssc", "vool"])
def test_dataloader_batches_match_jax(kind, name, num_workers, corpus):
    """Every batch of two epochs, ``_sample_pad`` flags included."""
    spec = dict(LOADER_CASES[name])
    jd, td = _datasets(kind, corpus, DS_CASES[spec.pop("case")])
    skw = dict(num_shards=spec.pop("num_shards", 1), shard_id=spec.pop("shard_id", 0),
               shuffle=spec.pop("shuffle", False), seed=3,
               drop_last=spec.get("drop_last", False))
    jl = jld.DataLoader(jd, num_workers=num_workers, sampler=jld.ShardedSampler(len(jd), **skw),
                        **spec)
    tl = tld.DataLoader(td, num_workers=num_workers, sampler=tld.ShardedSampler(len(td), **skw),
                        **spec)
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        jb, tb = list(jl), list(tl)
        assert len(tb) == len(jb) == len(tl) > 0
        for i, (a, b) in enumerate(zip(jb, tb)):
            assert_same(a, b, f"{kind}/{name} epoch {epoch} batch {i}")
        if "pad_to_full_batches" in spec or skw["num_shards"] > 1:
            assert all("_sample_pad" in b for b in tb[-1:])


def test_dataloader_early_break_releases_workers(corpus):
    jd, td = _datasets("ovssc", corpus, DS_CASES["dr"])
    loader = tld.DataLoader(td, batch_size=1, num_workers=2, shuffle=False)
    it = iter(loader)
    first = next(it)
    it.close()
    assert_same(first["scene_id"], [td[0]["scene_id"]])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert len(list(loader)) == 3


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kind", ["ovssc", "vool"])
def test_chip_smoke_memory_items_match_dataset_items(kind, corpus):
    """``chip_smoke.MemoryScenes`` (the card's machine has no h5py) serves
    items with a train item's keys in order, and its types, dtypes and
    shapes, at the corpus's sizes."""
    d, names = corpus
    mem = _chip_smoke().MemoryScenes(kind, n_scenes=2, length=3, h=24, w=32, rel_h=12,
                                     rel_w=16, full_pts=600, num_input=256,
                                     num_output=128)
    cls = tds.SceneCompletionDataset if kind == "ovssc" else tds.ObjectLocalizationDataset
    ref = cls(d, names, tds.DataConfig(num_input_pts=256, num_output_pts=128))[0]
    for item in (mem[0], mem[2]):
        assert list(item) == list(ref)
        for k, v in ref.items():
            assert type(item[k]) is type(v), k
            if isinstance(v, np.ndarray):
                assert (item[k].dtype, item[k].shape) == (v.dtype, v.shape), k
            elif isinstance(v, list):
                assert len(item[k]) == len(v) and all(isinstance(x, str) for x in item[k]), k
    assert mem.cfg.scene_bounds == tds.DataConfig().scene_bounds
    assert not np.array_equal(mem[0]["output_xyz_pts"], mem[1]["output_xyz_pts"])
