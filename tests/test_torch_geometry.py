"""The port's geometry primitives and marching tetrahedra against the JAX
package's, on the CPU.

Geometry: the same f32 inputs through both, within atol 1e-5 (the port
sums the 3-wide products elementwise in index order, JAX's HIGHEST-precision
einsum in its own order). Masks are compared exactly away from their
boundaries. Marching: the port's copy gives the same vertices and faces,
array for array."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_abstraction_tpu.ops import geometry as jgeo
from semantic_abstraction_tpu.ops.marching import marching_tetrahedra as j_march
from semantic_abstraction_tpu_torch.ops import geometry as tgeo
from semantic_abstraction_tpu_torch.ops.marching import marching_tetrahedra as t_march

ATOL = 1e-5


def _pose(rs):
    th = rs.uniform(-0.6, 0.6, 3)
    cx, cy, cz = np.cos(th)
    sx, sy, sz = np.sin(th)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    pose = np.eye(4)
    pose[:3, :3] = rz @ ry @ rx
    pose[:3, 3] = rs.uniform(-0.3, 0.3, 3)
    return pose.astype(np.float32)


INTR = np.array([[30.0, 0, 24.5], [0, 28.0, 16.0], [0, 0, 1]], np.float32)


def _both(fn_name, *args):
    j = getattr(jgeo, fn_name)(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a
                                 for a in args])
    t = getattr(tgeo, fn_name)(*[torch.as_tensor(a) if isinstance(a, np.ndarray) else a
                                 for a in args])
    return np.asarray(j), t.numpy()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("lead", [(), (2,)])
def test_transform_pointcloud(seed, lead):
    rs = np.random.RandomState(seed)
    pts = rs.uniform(-2, 2, lead + (300, 3)).astype(np.float32)
    pose = np.stack([_pose(rs) for _ in range(2)]) if lead else _pose(rs)
    j, t = _both("transform_pointcloud", pts, pose)
    assert t.shape == j.shape and t.dtype == np.float32
    np.testing.assert_allclose(t, j, atol=ATOL, rtol=0)
    # a 3x4 transform reads the same rows
    j3, t3 = _both("transform_pointcloud", pts, pose[..., :3, :])
    np.testing.assert_allclose(t3, j3, atol=ATOL, rtol=0)


def test_filter_pts_bounds_is_inclusive():
    rs = np.random.RandomState(2)
    bounds = np.array([[-1.0, -1.0, -0.1], [1.0, 1.0, 1.9]], np.float32)
    pts = rs.uniform(-1.5, 2.4, (1000, 3)).astype(np.float32)
    pts[:2] = bounds  # both corners lie inside
    j, t = _both("filter_pts_bounds", pts, bounds)
    assert t.dtype == np.bool_ and t[:2].all()
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("with_pose", [False, True])
def test_depth_to_pointcloud(with_pose):
    rs = np.random.RandomState(3)
    depth = rs.uniform(0.3, 2.0, (32, 48)).astype(np.float32)
    args = (depth, INTR) + ((_pose(rs),) if with_pose else ())
    j, t = _both("depth_to_pointcloud", *args)
    assert t.shape == (32 * 48, 3)
    np.testing.assert_allclose(t, j, atol=ATOL, rtol=0)


def test_project_pts_to_2d():
    rs = np.random.RandomState(4)
    view = _pose(rs)
    # points in front of the flipped camera: z_c < 0 before the flip
    cam = np.stack([rs.uniform(-1, 1, 400), rs.uniform(-1, 1, 400),
                    -rs.uniform(0.5, 3, 400)], -1)
    inv = np.linalg.inv(view.astype(np.float64))
    world = (cam @ inv[:3, :3].T + inv[:3, 3]).astype(np.float32)
    j, t = _both("project_pts_to_2d", world, view, INTR)
    # pixel rows and columns reach ~60: atol 1e-5 on the depth, and 1e-5
    # relative on the pixel coordinates
    np.testing.assert_allclose(t[:, 2], j[:, 2], atol=ATOL, rtol=0)
    np.testing.assert_allclose(t[:, :2], j[:, :2], atol=ATOL, rtol=1e-5)


def test_check_pts_in_frustum():
    rs = np.random.RandomState(5)
    pose = _pose(rs)
    pts = rs.uniform(-2, 3, (4000, 3)).astype(np.float32)
    j, t = _both("check_pts_in_frustum", pts, (32, 48), pose, INTR)
    assert j.any() and (~j).any()
    # away from the frame's edges, where the two sums may round apart
    inv = np.linalg.inv(pose.astype(np.float64))
    cam = pts @ inv[:3, :3].T + inv[:3, 3]
    px = INTR[0, 0] / cam[:, 2] * cam[:, 0] + INTR[0, 2]
    py = INTR[1, 1] / cam[:, 2] * cam[:, 1] + INTR[1, 2]
    edge = ((np.abs(px) < 1e-3) | (np.abs(px - 48) < 1e-3) | (np.abs(py) < 1e-3)
            | (np.abs(py - 32) < 1e-3) | (np.abs(cam[:, 2]) < 1e-6))
    np.testing.assert_array_equal(t[~edge], j[~edge])


def _volumes():
    rs = np.random.RandomState(6)
    g = np.mgrid[0:18, 0:14, 0:16].astype(np.float32)
    sphere = np.sqrt(((g - np.array([9, 7, 8])[:, None, None, None]) ** 2).sum(0)) - 5.0
    noise = rs.randn(12, 10, 11).astype(np.float32)
    return {"sphere": sphere, "noise": noise, "flat": np.ones((6, 6, 6), np.float32),
            "thin": rs.randn(1, 5, 5).astype(np.float32)}


@pytest.mark.parametrize("name", ["sphere", "noise", "flat", "thin"])
@pytest.mark.parametrize("level", [0.0, 0.5])
def test_marching_tetrahedra_is_the_jax_copy(name, level):
    vol = _volumes()[name]
    jv, jf = j_march(vol, level=level)
    tv, tf = t_march(vol, level=level)
    assert tv.dtype == jv.dtype and tf.dtype == jf.dtype
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    if name in ("sphere", "noise"):
        assert len(tf) > 10
