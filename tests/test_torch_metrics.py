"""The port's eval metrics against the JAX package on the CPU: ``iou``,
``prediction_analysis``, ``voxelize_points``, ``point_and_voxel_stats``
(the voxelize-once cutoff sweep), the eval cutoffs, the detailed-stats
DataFrame, and the metric pass over an eval step's outputs.

Tolerances: values rtol 1e-6 (the same counts divided in f32) with NaN at
the same places; voxel grids and masks exactly equal. The batch has
padded rows, out-of-bounds points, an all-ignored row, a row with no
positive label and a row with no positive prediction.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_abstraction_tpu.runtime import experiment as jexp
from semantic_abstraction_tpu.runtime import metrics as jmet
from semantic_abstraction_tpu.runtime import train as jtrain
from semantic_abstraction_tpu_torch.models import convert as tconv
from semantic_abstraction_tpu_torch.runtime import metrics as tmet
from semantic_abstraction_tpu_torch.runtime import train as ttrain
from torch_net_cases import CASES, batch, to_jax, to_torch

BOUNDS = ((-1.0, -1.0, -0.1), (1.0, 1.0, 1.9))
CUTOFFS = {
    "detailed": tuple(float(c) for c in np.arange(-2.5, 0, 0.1)),
    "vool": (-2.0,),
    "ovssc": (0.0,),
}


def _eval_outputs(rs, b=3, p=4, n=300):
    """Logits, labels, points and the ignore mask of an eval batch."""
    logits = (rs.randn(b, p, n) * 2).astype(np.float32)
    label = rs.rand(b, p, n) < 0.3
    xyz = rs.uniform(-1.3, 2.2, (b, p, n, 3)).astype(np.float32)
    lo, hi = np.asarray(BOUNDS[0]), np.asarray(BOUNDS[1])
    ignore = ((xyz < lo) | (xyz > hi)).any(-1)   # out of bounds
    ignore[2, 3] = True                          # a padded row
    ignore[1, 1] = True                          # an all-ignored row
    label[0, 2] = False                          # no positive label
    logits[0, 3] = -5.0                          # no positive prediction
    return logits, label, xyz, ignore


def _assert_same(got, want, exact=False):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_iou_matches_jax(masked):
    rs = np.random.RandomState(0)
    pred, lab = rs.rand(5, 40) < 0.4, rs.rand(5, 40) < 0.4
    pred[1], lab[1] = False, False  # empty union: NaN
    mask = rs.rand(5, 40) < 0.7 if masked else None
    want = jmet.iou(jnp.asarray(pred), jnp.asarray(lab),
                    None if mask is None else jnp.asarray(mask))
    got = tmet.iou(torch.as_tensor(pred), torch.as_tensor(lab),
                   None if mask is None else torch.as_tensor(mask))
    _assert_same(got, want)
    assert np.isnan(got[1].item())


def test_prediction_analysis_matches_jax():
    logits, label, _, ignore = _eval_outputs(np.random.RandomState(1))
    want = jmet.prediction_analysis(jnp.asarray(logits > 0), jnp.asarray(label),
                                    jnp.asarray(ignore))
    got = tmet.prediction_analysis(torch.as_tensor(logits > 0), torch.as_tensor(label),
                                   torch.as_tensor(ignore))
    assert got.keys() == want.keys()
    for k in want:
        _assert_same(got[k], want[k])
    assert np.isnan(got["iou"][1, 1].item()) and np.isnan(got["recall"][0, 2].item())
    assert np.isnan(got["precision"][0, 3].item())


def test_voxelize_points_matches_jax():
    logits, label, xyz, ignore = _eval_outputs(np.random.RandomState(2))
    want = jmet.voxelize_points(jnp.asarray(logits > 0), jnp.asarray(label),
                                jnp.asarray(xyz), (8, 8, 8), np.asarray(BOUNDS),
                                jnp.asarray(ignore))
    got = tmet.voxelize_points(torch.as_tensor(logits > 0), torch.as_tensor(label),
                               torch.as_tensor(xyz), (8, 8, 8), BOUNDS,
                               torch.as_tensor(ignore))
    assert got.keys() == want.keys()
    for k in want:
        _assert_same(got[k], want[k], exact=True)


@pytest.mark.parametrize("cutoffs", list(CUTOFFS))
def test_point_and_voxel_stats_matches_jax(cutoffs):
    """At 32^3 voxels (and 16^3 beside it for the 25 detailed cutoffs)."""
    cut = CUTOFFS[cutoffs]
    shapes = ((32, 32, 32), (16, 16, 16)) if cutoffs == "detailed" else ((32, 32, 32),)
    logits, label, xyz, ignore = _eval_outputs(np.random.RandomState(3))
    want = jmet.point_and_voxel_stats(jnp.asarray(logits), jnp.asarray(label),
                                      jnp.asarray(xyz), jnp.asarray(ignore), cut,
                                      np.asarray(BOUNDS), shapes)
    got = tmet.point_and_voxel_stats(torch.as_tensor(logits), torch.as_tensor(label),
                                     torch.as_tensor(xyz), torch.as_tensor(ignore), cut,
                                     BOUNDS, shapes)
    assert got.keys() == want.keys() and len(got) == 5 * (1 + len(shapes))
    for k in want:
        assert got[k].shape == (len(cut), 3, 4), k
        _assert_same(got[k], want[k])
    assert torch.isnan(got["point_iou"][:, 1, 1]).all()


def test_voxel_sweep_equals_voxelizing_at_each_cutoff():
    """The voxelize-once sweep against the reference's loop: threshold the
    points at each cutoff, then voxelize (``voxelize_points``)."""
    logits, label, xyz, ignore = _eval_outputs(np.random.RandomState(4))
    t = [torch.as_tensor(a) for a in (logits, label, xyz, ignore)]
    cut = CUTOFFS["detailed"]
    stats = tmet.point_and_voxel_stats(*t, cut, BOUNDS)
    for ci, c in enumerate(cut):
        vox = tmet.voxelize_points(t[0] > c, t[1], t[2], (32, 32, 32), BOUNDS, t[3])
        want = tmet.prediction_analysis(vox["prediction"], vox["label"], vox["ignore"])
        for k, v in want.items():
            _assert_same(stats[f"voxel32x32x32_{k}"][ci], v, exact=True)


@pytest.mark.parametrize("task", ["ovssc", "vool"])
@pytest.mark.parametrize("detailed", [False, True])
def test_eval_cutoffs_match_jax(task, detailed):
    assert tmet.eval_cutoffs_for(task, detailed) == jexp.eval_cutoffs_for(task, detailed)
    assert len(tmet.eval_cutoffs_for(task, detailed)) == (25 if detailed else 1)


def test_detailed_stats_frame_matches_jax():
    logits, label, xyz, ignore = _eval_outputs(np.random.RandomState(5))
    cut = CUTOFFS["detailed"][:3]
    stats = tmet.point_and_voxel_stats(*(torch.as_tensor(a) for a in
                                         (logits, label, xyz, ignore)), cut, BOUNDS)
    stats = {k: v.numpy() for k, v in stats.items()}
    meta = {"scene_id": [f"s{i}" for i in range(3) for _ in range(4)],
            "label": [f"l{j}" for _ in range(3) for j in range(4)]}
    pad = np.zeros((3, 4), bool)
    pad[2, 3] = True
    pd = pytest.importorskip("pandas")
    got = tmet.detailed_stats_frame(stats, cut, meta, pad)
    want = jmet.detailed_stats_frame(stats, cut, meta, pad)
    assert len(got) == 3 * 12 and got["point_iou"].isna().sum() >= 3
    pd.testing.assert_frame_equal(got, want)


def test_metric_pass_over_a_vool_eval_step_matches_jax():
    """The slice end to end on the CPU: SemAbsVOOL's eval step, then the
    25-cutoff sweep at 32^3 voxels over its logits, both packages from the
    same weights and batch (a padded description included)."""
    case = CASES["vool/semantic_abstraction"]
    params = case.jax_params(3)
    b = batch(case, np.random.RandomState(6), b=2)
    b["padding_mask"][1, 1] = True
    cut = CUTOFFS["detailed"]
    jaux = jtrain.make_eval_step(case.jax_loss(), case.jcfg, compute_dtype=jnp.float32)(
        jax.tree_util.tree_map(jnp.asarray, params), to_jax(b))
    want = jmet.point_and_voxel_stats(jaux["logits"], jnp.asarray(b["output_label_pts"]),
                                      jnp.asarray(b["output_xyz_pts"]), jaux["ignore"], cut,
                                      np.asarray(BOUNDS))
    taux = ttrain.make_eval_step(case.torch_loss(), case.tcfg, compute_dtype=torch.float32)(
        tconv.from_jax_params(params, case.tcfg, device="cpu"), to_torch(b))
    got = tmet.point_and_voxel_stats(taux["logits"], torch.as_tensor(b["output_label_pts"]),
                                     torch.as_tensor(b["output_xyz_pts"]), taux["ignore"],
                                     cut, BOUNDS)
    assert got.keys() == want.keys()
    for k in want:
        # logits agree to 1e-5, so a point within that of a cutoff could
        # flip: none does in this batch, and the stats agree exactly
        _assert_same(got[k], want[k])
    assert torch.isnan(got["point_iou"][:, 1, 1]).all()
