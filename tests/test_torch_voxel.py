"""The port's VoxelGrid against the JAX package's, on the CPU.

Index math is compared exactly (the same f32 ops in the same order); the
scatter within atol=rtol=1e-6 ("max" is exact; "mean" divides sums taken
in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_abstraction_tpu.ops.voxel import VoxelGrid as JaxGrid
from semantic_abstraction_tpu_torch.ops.voxel import VoxelGrid

BOUNDS = ((-1.0, -1.0, -0.1), (1.0, 1.0, 1.9))
SHAPE = (8, 6, 10)


def _grids():
    return (JaxGrid.from_bounds(BOUNDS, SHAPE), VoxelGrid.from_bounds(BOUNDS, SHAPE))


def _points(rs, *shape):
    # about a fifth of the points lie outside the bounds, on every side
    return rs.uniform(-1.4, 2.3, shape + (3,)).astype(np.float32)


@pytest.mark.parametrize("cast_to_int", [True, False])
def test_points_to_idxs_truncates_then_clamps(cast_to_int):
    jg, tg = _grids()
    pts = _points(np.random.RandomState(0), 3, 500)
    pts[0, :4] = [[-1.0, -1.0, -0.1], [1.0, 1.0, 1.9], [-5, 0, 0], [0.999, -0.999, 1.0]]
    want = np.asarray(jg.points_to_idxs(jnp.asarray(pts), cast_to_int))
    got = tg.points_to_idxs(torch.as_tensor(pts), cast_to_int).numpy()
    np.testing.assert_array_equal(got, want)
    if cast_to_int:
        np.testing.assert_array_equal(
            tg.flatten_idxs(torch.as_tensor(got)).numpy(),
            np.asarray(jg.flatten_idxs(jnp.asarray(want))))


@pytest.mark.parametrize("reduce_method", ["max", "mean"])
@pytest.mark.parametrize("channels", [16, 3])  # 16 takes JAX's packed path
@pytest.mark.parametrize("masked", [False, True])
def test_scatter_points_matches_jax(reduce_method, channels, masked):
    jg, tg = _grids()
    rs = np.random.RandomState(channels)
    b, n = 2, 700  # ~3 points a voxel: shared bins and empty bins
    pts = _points(rs, b, n)
    feats = rs.randn(b, n, channels).astype(np.float32)
    mask = rs.rand(b, n) > 0.3 if masked else None
    want = np.asarray(jg.scatter_points(
        jnp.asarray(pts), jnp.asarray(feats), reduce_method,
        valid_mask=None if mask is None else jnp.asarray(mask)))
    got = tg.scatter_points(torch.as_tensor(pts), torch.as_tensor(feats),
                            reduce_method,
                            valid_mask=None if mask is None else torch.as_tensor(mask))
    assert got.shape == (b, channels) + SHAPE and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    assert (want == 0).any() and (want != 0).any()


def test_scatter_points_rejects_unknown_reduction():
    _, tg = _grids()
    with pytest.raises(ValueError):
        tg.scatter_points(torch.zeros(1, 4, 3), torch.zeros(1, 4, 2), "sum")
