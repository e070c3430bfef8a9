"""The port's ``visualize`` CLI against the JAX package's, on the CPU.

- The dense decoder against JAX's ``make_dense_decoder`` on weights carried
  by ``from_jax_params``: atol 1e-5, rtol 1e-4 (the tolerance of JAX's own
  ``test_dense_decode_matches_direct``); with and without a pointer.
- ``DenseArgmax``, the dense grid, ``export_obj`` and the frustum mask
  against JAX's, exactly.
- ``cmd_ovssc`` and ``cmd_vool`` of every approach against JAX's on one
  ``.pth`` that both ``--load`` (the two packages' random inits differ),
  f32, with the relevancy extractor replaced on both sides by one seeded
  stand-in (``FakeSaliency``: the relevancy itself is held by
  ``tests/test_torch_saliency.py`` and the writer test): OVSSC's argmax may
  differ only where JAX's top two logits, or its max and the cutoff, are
  within 1e-4, its carving mask only there and at TSDF rounding ties
  (``test_torch_fusion.tie_voxels``), and where neither differs its meshes
  are byte for byte JAX's; VOOL's kept
  points may differ only where the logit is within 1e-4 of the band's
  edge, and their jet colors only where the heat is within 1e-3 of a bin
  of matplotlib's 256-entry table.
- The whole CLI on the port alone with the real random ViT-B/32
  (``--device cpu``), and the turntable renders.
"""
import argparse
import pickle
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_abstraction_tpu.cli import generate_relevancy as jgr
from semantic_abstraction_tpu.data.transforms import check_pts_in_frustum_np as j_frustum
from semantic_abstraction_tpu.cli import visualize as jvis
from semantic_abstraction_tpu.ops import fusion as jfu
from semantic_abstraction_tpu.runtime import experiment as jexp
from semantic_abstraction_tpu_torch.cli import generate_relevancy as tgr
from semantic_abstraction_tpu_torch.cli import visualize as tvis
from semantic_abstraction_tpu_torch.models import from_jax_params
from semantic_abstraction_tpu_torch.models.convert import to_reference_state_dict
from semantic_abstraction_tpu_torch.runtime import experiment as texp
from test_torch_fusion import tie_voxels
from torch_data_cases import jax_native  # noqa: F401 - the fixture


@pytest.fixture(scope="module", autouse=True)
def jax_native_loaded(jax_native):
    """JAX's frustum mask takes its native kernel, whose double arithmetic
    the port's device mask follows."""
    return jax_native


BOUNDS = ((-1.0, -1.0, -0.1), (1.0, 1.0, 1.9))
SMALL = dict(voxel_shape=[16, 16, 16], scene_bounds=[-1.0, -1.0, -0.1, 1.0, 1.0, 1.9],
             unet_num_channels=8, unet_f_maps=4, unet_num_groups=2, unet_num_levels=3,
             network_inputs=["saliency"], use_pts_feat_extractor=True,
             pts_feat_extractor_hidden_dim=16, reduce_method="max",
             decoder_concat_xyz_pts=True, pointing_method="cosine_sim", pointing_dim=16)
H = W = 48
TOL = 1e-4


def test_sample_points_and_export_obj_match_jax(tmp_path):
    np.testing.assert_array_equal(tvis.get_sample_points((5, 4, 6), BOUNDS),
                                  jvis.get_sample_points((5, 4, 6), BOUNDS))
    g = np.mgrid[0:16, 0:16, 0:16].astype(np.float32)
    occ = (np.sqrt(((g - 8) ** 2).sum(0)) < 5).astype(np.float32)
    assert tvis.export_obj(occ, str(tmp_path / "t.obj"))
    assert jvis.export_obj(occ, str(tmp_path / "j.obj"))
    assert (tmp_path / "t.obj").read_bytes() == (tmp_path / "j.obj").read_bytes()
    assert not tvis.export_obj(np.zeros((8, 8, 8), np.float32), str(tmp_path / "e.obj"))


def _jax_net(task, approach, seed=0):
    ns = argparse.Namespace(**SMALL)
    jcfg = jexp.model_cfg_from_args(task, approach, ns)
    params = jexp.APPROACHES[(task, approach)][1](jax.random.PRNGKey(seed), jcfg)
    tcfg = texp.model_cfg_from_args(task, approach, ns)
    numpy_params = jax.tree_util.tree_map(np.asarray, params)
    return jcfg, params, tcfg, from_jax_params(numpy_params, tcfg, device="cpu")


@pytest.mark.parametrize("pointer", [False, True])
def test_dense_decoder_matches_jax(pointer):
    """The sweep over a chunked grid (the last chunk ragged) against JAX's,
    on the channel-0 output and pointed at a class feature."""
    from semantic_abstraction_tpu.models.decoder import pointing_attention_paired as j_point
    from semantic_abstraction_tpu_torch.models import pointing_attention_paired as t_point

    approach = "semantic_aware" if pointer else "semantic_abstraction"
    jcfg, params, tcfg, model = _jax_net("ovssc", approach)
    ccfg_j, ccfg_t = getattr(jcfg, "completion", jcfg), getattr(tcfg, "completion", tcfg)
    cparams = params["completion"] if pointer else params
    rs = np.random.RandomState(0)
    c = ccfg_t.unet_num_channels
    vol = rs.randn(1, c, 16, 16, 16).astype(np.float32)
    pts = rs.uniform(-1.2, 2.0, (1000, 3)).astype(np.float32)
    cf = rs.randn(512).astype(np.float32) if pointer else None
    jpost = tpost = None
    if pointer:
        def jpost(feats, q):
            return j_point(params["pointer"], key=q, query=feats, method="cosine_sim",
                           pointing_dim=512, temperature=0.07)

        def tpost(feats, q):
            return t_point(model.semantic_class_pointer, q, feats, "cosine_sim", 512, 0.07)
    chunks, n = jvis._upload_chunks(pts, chunk=256)
    jdec = jvis.make_dense_decoder(ccfg_j.grid, (16, 16, 16), True, post=jpost)
    want = np.asarray(jdec(cparams["decoder"], jnp.asarray(vol.transpose(0, 2, 3, 4, 1)),
                           chunks, jnp.asarray(cf) if pointer else jnp.zeros(()))).reshape(-1)[:n]
    tdec = tvis.make_dense_decoder(ccfg_t.grid, True, post=tpost, chunk=256)
    with torch.no_grad():
        got = tdec(model.visual_sampler, torch.as_tensor(vol), torch.as_tensor(pts),
                   torch.as_tensor(cf) if pointer else None)
    assert got.shape == (1000,)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4)


def test_dense_argmax_matches_jax():
    rs = np.random.RandomState(1)
    outs = [rs.randn(300).astype(np.float32) for _ in range(4)]
    outs[2][:50] = outs[1][:50]  # ties keep the earlier class
    j, t = jvis.DenseArgmax(), tvis.DenseArgmax()
    for ci, o in enumerate(outs):
        j.update(jnp.asarray(o), ci)
        t.update(torch.as_tensor(o), ci)
    jp, je = j.finalize(290, 0.3)
    tp, te = t.finalize(290, 0.3)
    assert tp.dtype == torch.uint8 and te.dtype == torch.bool
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_array_equal(te.numpy(), je)


def test_frustum_mask_is_the_hosts():
    from semantic_abstraction_tpu_torch.data.transforms import check_pts_in_frustum_np

    rs = np.random.RandomState(2)
    pose = np.eye(4)
    pose[:3, 3] = [0.1, -0.2, -0.4]
    pts = tvis.get_sample_points((30, 30, 30), BOUNDS)
    pts = np.concatenate([pts, rs.uniform(-2, 3, (5000, 3)).astype(np.float32)])
    intr = np.array([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]], np.float32)
    got = tvis.frustum_mask(torch.as_tensor(pts), (H, W), pose, intr).numpy()
    assert got.any() and (~got).any()
    np.testing.assert_array_equal(got, check_pts_in_frustum_np(pts, (H, W), pose, intr))
    np.testing.assert_array_equal(got, j_frustum(pts, (H, W), pose, intr))


class FakeSaliency:
    """A seeded stand-in for the CLIP extractor, the same numbers for both
    packages: maps and features are drawn from each label's crc32."""

    def __init__(self, as_array):
        self.as_array = as_array

    @staticmethod
    def _draw(label, shape, scale):
        return np.random.RandomState(zlib.crc32(label.encode())).randn(*shape) * scale

    def get_clip_saliency(self, img, labels, prompts=None, config=None, key=None,
                          generator=None):
        maps = np.stack([self._draw(l, img.shape[:2], 0.01) for l in labels]).astype(np.float16)
        return self.as_array(maps), self.text_features(labels)

    def text_features(self, names):
        return self.as_array(np.stack([self._draw(n + "/t", (512,), 1.0) for n in names])
                             .astype(np.float32))

    def zeroshot_weights(self, names, prompts):
        f = np.stack([self._draw(n + "/z", (512,), 1.0) for n in names])
        return self.as_array((f / np.linalg.norm(f, axis=-1, keepdims=True)).T.astype(np.float32))


@pytest.fixture
def fake_saliency(monkeypatch):
    monkeypatch.setattr(jgr, "build_saliency", lambda args: FakeSaliency(jnp.asarray))
    monkeypatch.setattr(tgr, "build_saliency", lambda args: FakeSaliency(torch.as_tensor))


def _scene(tmp_path, rs):
    depth = rs.uniform(0.5, 1.6, (H, W)).astype(np.float32)
    depth[:, :8] = 3.0  # far wall: some grid points lie in front of the surface
    scene = {
        "rgb": rs.randint(0, 255, (H, W, 3), dtype=np.uint8),
        "depth": depth,
        "cam_intr": np.array([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]], np.float32),
        "cam_extr": np.eye(4, dtype=np.float32),
        "ovssc_obj_classes": ["chair", "table", "sofa"],
        "descriptions": [("mug", "on", "table"), ("chair", "behind", "sofa")],
    }
    path = tmp_path / "kitchen.pkl"
    with open(path, "wb") as f:
        pickle.dump(scene, f)
    return str(path)


def _checkpoint(tmp_path, task, approach):
    """One ``.pth`` (reference layout) and its ``args.pkl``, from JAX's
    init at the small config."""
    _, _, _, model = _jax_net(task, approach, seed=3)
    d = tmp_path / "ckpt"
    d.mkdir()
    torch.save({"net": to_reference_state_dict(model), "epochs": 1}, str(d / "net.pth"))
    with open(d / "args.pkl", "wb") as f:
        pickle.dump(dict(SMALL, approach=approach), f)
    return str(d / "net.pth")


def _argv(cmd, scene, ckpt, dump, extra=()):
    return [cmd, scene, "--load", ckpt, "--dump-path", dump, "--sampling_shape", "16", "16",
            "16", "--num_input_pts", "256", "--compute_dtype", "float32",
            "--saliency_config", "chefer_et_al", *extra]


@pytest.mark.parametrize("approach", ["semantic_abstraction", "semantic_aware"])
def test_ovssc_inference_matches_jax(approach, tmp_path, fake_saliency, monkeypatch):
    scene = _scene(tmp_path, np.random.RandomState(4))
    ckpt = _checkpoint(tmp_path, "ovssc", approach)
    outs, final = [], {}
    update, finalize = jvis.DenseArgmax.update, jvis.DenseArgmax.finalize

    def spy_update(self, out, ci):
        outs.append(np.asarray(out, np.float32).reshape(-1))
        return update(self, out, ci)

    def spy_finalize(self, n, cutoff):
        final["pred"], final["empty"] = finalize(self, n, cutoff)
        return final["pred"], final["empty"]

    monkeypatch.setattr(jvis.DenseArgmax, "update", spy_update)
    monkeypatch.setattr(jvis.DenseArgmax, "finalize", spy_finalize)
    cutoff = ["--cutoff", "-0.5" if approach == "semantic_abstraction" else "-100"]
    jvis.main(_argv("ovssc-inference", scene, ckpt, str(tmp_path / "j"), cutoff))
    args = tvis.parser().parse_args(
        _argv("ovssc-inference", scene, ckpt, str(tmp_path / "t"), cutoff + ["--device", "cpu"]))
    got = tvis.cmd_ovssc(args)

    logits = np.stack(outs)[:, :16**3]
    top2 = np.sort(logits, axis=0)[-2:]
    pred = got["prediction"].reshape(-1)
    assert len(set(pred.tolist())) > 1  # more than one class wins somewhere
    bad = pred != final["pred"]
    assert not (bad & (top2[1] - top2[0] > TOL)).any()
    # JAX's carving mask, from its own frustum test and TSDF
    with open(scene, "rb") as f:
        data = pickle.load(f)
    tsdf = jfu.TSDFVolume(np.asarray(BOUNDS).T, voxel_size=2.0 / 16)
    tsdf.integrate(data["rgb"], data["depth"], data["cam_intr"], data["cam_extr"])
    in_frustum = j_frustum(tvis.get_sample_points((16, 16, 16), BOUNDS), (H, W),
                           data["cam_extr"], data["cam_intr"])
    jkeep = ~final["empty"] & in_frustum & ~(tsdf.get_volume()[0].reshape(-1) > 0)
    ties = tie_voxels(np.asarray(tsdf._vox_world),
                      [(data["depth"], data["cam_intr"], data["cam_extr"])],
                      tsdf._trunc_margin)
    ties |= np.abs(top2[1] - float(cutoff[1])) <= TOL
    keep_differs = got["keep"].reshape(-1) != jkeep
    assert jkeep.any() and not (keep_differs & ~ties).any()
    names = sorted(p.name for p in (tmp_path / "j" / "kitchen").glob("*.obj"))
    assert names and names == sorted(p.split("/")[-1] for p in got["written"])
    if not (bad.any() or keep_differs.any()):
        for name in names:
            assert ((tmp_path / "t" / "kitchen" / name).read_bytes()
                    == (tmp_path / "j" / "kitchen" / name).read_bytes())


def _read_ply(path):
    with open(path) as f:
        lines = f.read().splitlines()
    rows = lines[lines.index("end_header") + 1:]
    arr = np.array([r.split() for r in rows], np.float64).reshape(-1, 6)
    return arr[:, :3], arr[:, 3:]


# a band that keeps part of the grid at each approach's logit scale
@pytest.mark.parametrize("approach,band", [("semantic_abstraction", 3.0),
                                           ("semantic_aware", 3.0), ("clip_spatial", 0.2)])
def test_vool_inference_matches_jax(approach, band, tmp_path, fake_saliency):
    scene = _scene(tmp_path, np.random.RandomState(5))
    ckpt = _checkpoint(tmp_path, "vool", approach)
    band = ["--vool-band", str(band)]
    jvis.main(_argv("vool-inference", scene, ckpt, str(tmp_path / "j"), band))
    args = tvis.parser().parse_args(
        _argv("vool-inference", scene, ckpt, str(tmp_path / "t"), band + ["--device", "cpu"]))
    got = tvis.cmd_vool(args)
    grid = tvis.get_sample_points((16, 16, 16), BOUNDS)
    assert len(got["logits"]) == 2
    for (t, r, f), logits in got["logits"].items():
        name = f"{t}_{r}_{f}".replace(" ", "_") + ".ply"
        jpts, jcol = _read_ply(tmp_path / "j" / "kitchen" / name)
        tpts, tcol = _read_ply(tmp_path / "t" / "kitchen" / name)
        assert 0 < len(jpts) < len(grid)
        edge = np.abs(logits - (logits.max() - args.vool_band)) <= TOL
        tkeep = {tuple(p) for p in np.round(tpts, 5)}
        jkeep = {tuple(p) for p in np.round(jpts, 5)}
        edge_pts = {tuple(p) for p in np.round(grid[edge], 5)}
        assert not ((tkeep ^ jkeep) - edge_pts)
        if tkeep == jkeep:
            # jet is a 256-entry table: a heat at a bin edge may take the
            # neighbouring entry
            kept = logits > logits.max() - args.vool_band
            p = np.exp(logits[kept])
            heat = (p - p.min()) / max(1e-9, p.max() - p.min())
            at_edge = np.abs(heat * 256 - np.round(heat * 256)) < 1e-3
            assert not ((tcol != jcol).any(1) & ~at_edge).any()
    for name in ("scene_rgb.ply",):
        assert ((tmp_path / "t" / "kitchen" / name).read_bytes()
                == (tmp_path / "j" / "kitchen" / name).read_bytes())


def test_restore_net_reads_args_pkl(tmp_path):
    ckpt = _checkpoint(tmp_path, "vool", "clip_spatial")
    args = tvis.parser().parse_args(["vool-inference", "s.pkl", "--load", ckpt,
                                     "--device", "cpu"])  # approach and voxels from args.pkl
    cfg, model, approach = tvis._restore_net(args, "vool")
    assert approach == "clip_spatial" and cfg.completion.voxel_shape == (16, 16, 16)
    assert cfg.completion.unet_num_levels == 3
    assert not any(p.requires_grad for p in model.parameters())


def test_whole_cli_on_the_port(tmp_path):
    """Both inference commands with the real random ViT-B/32 on the CPU, at
    the JAX package's defaults for the net (no args.pkl, random weights),
    then both turntable renders."""
    scene = _scene(tmp_path, np.random.RandomState(6))
    dump = str(tmp_path / "vis")
    common = ["--dump-path", dump, "--voxel_shape", "32", "32", "32", "--sampling_shape",
              "12", "12", "12", "--num_input_pts", "256", "--random-weights",
              "--saliency_config", "chefer_et_al", "--compute_dtype", "float32",
              "--device", "cpu"]
    timings = {}
    args = tvis.parser().parse_args(["ovssc-inference", scene, "--cutoff", "-100"] + common)
    out = tvis.cmd_ovssc(args, timings)
    assert out["written"] and out["prediction"].shape == (12, 12, 12)
    assert set(timings) == {"clip", "relevancy", "unet", "sweep", "tsdf", "readback", "export"}
    tvis.main(["vool-inference", scene] + common)
    files = {p.name for p in (tmp_path / "vis" / "kitchen").iterdir()}
    assert {"scene_rgb.ply", "mug_on_table.ply", "chair_behind_sofa.ply"} <= files
    tvis.main(["ovssc-visualize", str(tmp_path / "vis" / "kitchen"), "--n_frames", "2"])
    tvis.main(["vool-visualize", str(tmp_path / "vis" / "kitchen"), "--n_frames", "2"])
    files = {p.stem for p in (tmp_path / "vis" / "kitchen").iterdir()}
    assert {"completion", "mug_on_table", "chair_behind_sofa"} <= files


def test_inference_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    args = tvis.parser().parse_args(["ovssc-inference", "s.pkl"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tvis._restore_net(args, "ovssc")
