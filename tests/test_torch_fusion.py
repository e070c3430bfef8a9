"""The port's TSDF fusion against the JAX package's, on the CPU.

``integrate`` over two frames: tsdf and weight within atol 1e-5 of JAX's
and color equal, except at voxels whose pixel rounds at a tie. The two
camera transforms sum the same f32 products in other orders (JAX's dot,
the port's elementwise sum), so a voxel whose projection lies within
rounding of a half pixel may pick the neighbouring pixel, and a voxel
whose depth difference sits on the truncation margin may flip validity.
Those voxels are counted and each must be one of these ties. Meshes, point
clouds and the PLY writers then agree array for array and byte for byte
(on volumes of equal values)."""
import numpy as np
import pytest
import torch

from semantic_abstraction_tpu.ops import fusion as jfu
from semantic_abstraction_tpu_torch.ops import fusion as tfu

ATOL = 1e-5
BOUNDS = np.array([[-1.0, 1.0], [-1.0, 1.0], [-0.1, 1.9]])
H, W = 24, 32
INTR = np.array([[20.0, 0, W / 2], [0, 20.0, H / 2], [0, 0, 1]], np.float32)


def _frames(rs):
    poses = [np.eye(4, dtype=np.float32)]
    th = 0.2
    p = np.eye(4)
    p[:3, :3] = [[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]]
    p[:3, 3] = [-0.2, 0.05, 0.1]
    poses.append(p.astype(np.float32))
    frames = []
    for pose in poses:
        depth = rs.uniform(0.5, 1.8, (H, W)).astype(np.float32)
        depth[rs.rand(H, W) < 0.1] = 0.0  # holes
        rgb = rs.randint(0, 256, (H, W, 3)).astype(np.uint8)
        frames.append((rgb, depth, pose))
    return frames


def tie_voxels(vox_world, frames, trunc, eps=1e-4):
    """Voxels where some frame's pixel lies within ``eps`` of a half pixel,
    or the depth difference within ``eps`` of the truncation margin
    (computed in float64 from JAX's formula). ``frames``: (depth, intr,
    camera-to-world pose) each."""
    tie = np.zeros(len(vox_world), bool)
    for depth, intr, pose in frames:
        h, w = depth.shape
        inv = np.linalg.inv(np.asarray(pose, np.float64))
        cam = vox_world.astype(np.float64) @ inv[:3, :3].T + inv[:3, 3]
        z = np.where(cam[:, 2] == 0, 1e-12, cam[:, 2])
        px = cam[:, 0] * intr[0, 0] / z + intr[0, 2]
        py = cam[:, 1] * intr[1, 1] / z + intr[1, 2]
        for p in (px, py):
            tie |= np.abs(np.abs(p - np.floor(p)) - 0.5) < eps
        ix = np.clip(np.round(px), 0, w - 1).astype(int)
        iy = np.clip(np.round(py), 0, h - 1).astype(int)
        tie |= np.abs(depth[iy, ix] - cam[:, 2] + trunc) < eps
    return tie


@pytest.fixture(scope="module")
def fused():
    rs = np.random.RandomState(0)
    frames = _frames(rs)
    jv = jfu.TSDFVolume(BOUNDS, voxel_size=0.125)
    tv = tfu.TSDFVolume(BOUNDS, voxel_size=0.125, device="cpu")
    for rgb, depth, pose in frames:
        jv.integrate(rgb, depth, INTR, pose)
        tv.integrate(rgb, depth, INTR, pose)
    return jv, tv, frames


def test_volume_layout_and_grid_match_jax(fused):
    jv, tv, _ = fused
    np.testing.assert_array_equal(tv.vol_dim, jv.vol_dim)
    np.testing.assert_array_equal(tv.vol_origin, jv.vol_origin)
    np.testing.assert_array_equal(tv._vox_world.numpy(), np.asarray(jv._vox_world))
    tsdf, color = tv.get_volume()
    assert tsdf.shape == tuple(jv.vol_dim) and tsdf.dtype == np.float32
    assert color.shape == (3,) + tuple(jv.vol_dim) and color.dtype == np.uint8


def test_integrate_two_frames_matches_jax(fused):
    jv, tv, frames = fused
    j_tsdf = np.asarray(jv._state["tsdf"])
    j_w = np.asarray(jv._state["weight"])
    j_c = np.asarray(jv._state["color"])
    t_tsdf, t_w, t_c = tv._tsdf.numpy(), tv._weight.numpy(), tv._color.numpy()
    # both frames observed a good share of the volume
    assert (j_w == 2).sum() > 100 and (j_w == 1).sum() > 100
    differ = ((np.abs(t_tsdf - j_tsdf) > ATOL) | (np.abs(t_w - j_w) > ATOL)
              | (t_c != j_c).any(0))
    ties = tie_voxels(np.asarray(jv._vox_world),
                      [(depth, INTR, pose) for _, depth, pose in frames], 5 * 0.125)
    assert not (differ & ~ties).any(), (
        f"{(differ & ~ties).sum()} voxels differ away from a rounding tie")
    assert differ.sum() <= ties.sum()


def test_integrate_without_color_and_with_weight():
    rs = np.random.RandomState(1)
    (_, depth, pose), = _frames(rs)[:1]
    jv = jfu.TSDFVolume(BOUNDS, voxel_size=0.25)
    tv = tfu.TSDFVolume(BOUNDS, voxel_size=0.25, device="cpu")
    for v in (jv, tv):
        v.integrate(None, depth, INTR, pose, obs_weight=0.5)
        v.integrate(None, depth * 1.1, INTR, pose, obs_weight=2.0)
    np.testing.assert_allclose(tv.get_volume()[0], jv.get_volume()[0], atol=ATOL, rtol=0)
    np.testing.assert_array_equal(tv.get_volume()[1], jv.get_volume()[1])


def _with_jax_state(jv):
    """A port volume holding JAX's exact state, so that what is read from
    it is compared on equal values."""
    tv = tfu.TSDFVolume(BOUNDS, voxel_size=jv.voxel_size, device="cpu")
    tv._tsdf = torch.as_tensor(np.array(jv._state["tsdf"]))
    tv._weight = torch.as_tensor(np.array(jv._state["weight"]))
    tv._color = torch.as_tensor(np.array(jv._state["color"]))
    return tv


def test_mesh_point_cloud_and_writers_match_jax(fused, tmp_path):
    jv = fused[0]
    tv = _with_jax_state(jv)
    jm, tm = jv.get_mesh(), tv.get_mesh()
    assert len(jm[1]) > 10
    for a, b in zip(tm, jm):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tv.get_point_cloud(), jv.get_point_cloud())
    for mod, name in ((jfu, "j"), (tfu, "t")):
        mod.meshwrite(str(tmp_path / f"{name}.ply"), *jm)
        mod.pcwrite(str(tmp_path / f"{name}_pc.ply"), jv.get_point_cloud())
    for stem in ("", "_pc"):
        assert ((tmp_path / f"t{stem}.ply").read_bytes()
                == (tmp_path / f"j{stem}.ply").read_bytes())


def test_frustum_and_rigid_transform_match_jax():
    rs = np.random.RandomState(2)
    _, depth, pose = _frames(rs)[1]
    np.testing.assert_array_equal(tfu.get_view_frustum(depth, INTR, pose),
                                  jfu.get_view_frustum(depth, INTR, pose))
    pts = rs.randn(50, 3)
    np.testing.assert_array_equal(tfu.rigid_transform(pts, pose),
                                  jfu.rigid_transform(pts, pose))


def test_volume_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tfu.TSDFVolume(BOUNDS, voxel_size=0.25)
