"""Volumetric TSDF fusion on tensors, and the mesh and point-cloud writers.

Counterpart of ``semantic_abstraction_tpu/ops/fusion.py`` (reference
fusion.py:34-334). ``TSDFVolume`` keeps its state (tsdf, weight and a
(3, N) color volume) as tensors on its device, ``cuda`` unless the caller
asks for another, and ``integrate`` is one function of tensor ops over every
voxel: no scalar loop, no scatter. The voxel centres (``vox_world``, N x 3
f32: 166 MB at 240^3) are built once, on that device.

The semantics are the JAX package's, step for step:

- truncation margin 5 voxels, the distance clamped to [-1, 1];
- unobserved voxels start at tsdf = -1, weight 0;
- the cumulative moving average with the frame's ``obs_weight``;
- the pixel of a voxel rounds half to even (``torch.round``, as
  ``jnp.round``), a voxel at z == 0 divides by 1e-12 (``safe_z``), and the
  flat pixel index is clamped into the image before the gather; voxels
  outside the frame or behind the camera are masked afterwards;
- color is averaged per channel, rounded every step and clamped at 255;
  ``get_volume`` returns tsdf (X, Y, Z) float32 and color (3, X, Y, Z)
  uint8, the reference's layout after unpacking.

The camera transform is summed in index order from elementwise products,
never a matmul (no TF32 on the card). The pixel is kept as a rounded float
until the gather, so a voxel whose projection overflows int32 is masked out
without an integer cast of it.

Meshing (``get_mesh``, ``get_point_cloud``) reads the volume back and runs
the host's marching tetrahedra (``ops/marching.py``), as the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from .marching import marching_tetrahedra


def _f32(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x).to(device=device, dtype=torch.float32)


def integrate_step(tsdf: torch.Tensor, weight: torch.Tensor, color: torch.Tensor,
                   color_im: torch.Tensor, depth_im: torch.Tensor,
                   cam_intr: torch.Tensor, cam_pose_inv: torch.Tensor,
                   obs_weight: torch.Tensor, vox_world: torch.Tensor,
                   trunc_margin: float):
    """One frame into the (tsdf (N,), weight (N,), color (3, N)) state ->
    the new state. ``color_im`` (H, W, 3) and ``depth_im`` (H, W) f32;
    ``cam_pose_inv`` the world-to-camera 4x4."""
    im_h, im_w = depth_im.shape
    rot, trans = cam_pose_inv[:3, :3], cam_pose_inv[:3, 3]
    vx, vy, vz = vox_world[:, 0], vox_world[:, 1], vox_world[:, 2]

    def cam(i):
        return vx * rot[i, 0] + vy * rot[i, 1] + vz * rot[i, 2] + trans[i]

    pix_z = cam(2)
    safe_z = torch.where(pix_z == 0, 1e-12, pix_z)
    pix_x = torch.round(cam(0) * cam_intr[0, 0] / safe_z + cam_intr[0, 2])
    pix_y = torch.round(cam(1) * cam_intr[1, 1] / safe_z + cam_intr[1, 2])
    valid_pix = ((pix_x >= 0) & (pix_x < im_w) & (pix_y >= 0) & (pix_y < im_h)
                 & (pix_z > 0))
    lin = (pix_y.clamp(0, im_h - 1).long() * im_w
           + pix_x.clamp(0, im_w - 1).long())
    depth_val = torch.where(valid_pix, depth_im.reshape(-1)[lin], 0.0)
    depth_diff = depth_val - pix_z
    valid = (depth_val > 0) & (depth_diff >= -trunc_margin)
    dist = torch.clamp(depth_diff / trunc_margin, -1.0, 1.0)

    w_new = torch.where(valid, weight + obs_weight, weight)
    tsdf_new = torch.where(
        valid, (weight * tsdf + obs_weight * dist) / w_new.clamp_min(1e-12), tsdf)
    color_new = torch.where(valid, color_im.reshape(-1, 3)[lin].t(), 0.0)
    color_upd = torch.clamp_max(torch.round(
        (weight[None] * color + obs_weight * color_new)
        / w_new[None].clamp_min(1e-12)), 255.0)
    color = torch.where(valid[None], color_upd, color)
    return tsdf_new, w_new, color


class TSDFVolume:
    """A TSDF volume over ``vol_bnds`` ((3, 2) xyz min/max, meters) at
    ``voxel_size`` meters, its state on ``device`` (cuda unless asked)."""

    def __init__(self, vol_bnds, voxel_size: float, device=None):
        vol_bnds = np.asarray(vol_bnds, dtype=np.float64)
        assert vol_bnds.shape == (3, 2)
        assert (vol_bnds[:, 0] < vol_bnds[:, 1]).all()
        from ..clip.model import resolve_device  # clip.model imports ops

        self.device = resolve_device(device)
        self._voxel_size = float(voxel_size)
        self._trunc_margin = 5.0 * self._voxel_size
        self._vol_dim = np.ceil(
            (vol_bnds[:, 1] - vol_bnds[:, 0]) / self._voxel_size
        ).astype(int)
        vol_bnds[:, 1] = vol_bnds[:, 0] + self._vol_dim * self._voxel_size
        self._vol_bnds = vol_bnds
        self._vol_origin = vol_bnds[:, 0].astype(np.float32)

        axes = [torch.arange(int(d), device=self.device, dtype=torch.float32)
                for d in self._vol_dim]
        vox_coords = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1).reshape(-1, 3)
        # f32(voxel_size) * index + origin, the JAX package's numpy order
        self._vox_world = (torch.as_tensor(self._vol_origin, device=self.device)
                           + torch.tensor(self._voxel_size, dtype=torch.float32,
                                          device=self.device) * vox_coords)
        n = vox_coords.shape[0]
        self._tsdf = -torch.ones(n, device=self.device)
        self._weight = torch.zeros(n, device=self.device)
        self._color = torch.zeros(3, n, device=self.device)

    @property
    def voxel_size(self) -> float:
        return self._voxel_size

    @property
    def vol_dim(self) -> np.ndarray:
        return self._vol_dim

    @property
    def vol_origin(self) -> np.ndarray:
        return self._vol_origin

    def integrate(self, color_im, depth_im, cam_intr, cam_pose, obs_weight=1.0):
        """Fuse one RGB-D frame (reference fusion.py:121-195). Arrays or
        tensors; the pose is inverted on the host in float64, as in the JAX
        package."""
        dev = self.device
        depth = _f32(depth_im, dev)
        color = (torch.zeros(*depth.shape, 3, device=dev) if color_im is None
                 else _f32(color_im, dev))
        pose = cam_pose.cpu().numpy() if torch.is_tensor(cam_pose) else cam_pose
        pose_inv = np.linalg.inv(np.asarray(pose, dtype=np.float64)).astype(np.float32)
        intr = cam_intr.cpu().numpy() if torch.is_tensor(cam_intr) else cam_intr
        self._tsdf, self._weight, self._color = integrate_step(
            self._tsdf, self._weight, self._color, color, depth,
            _f32(np.asarray(intr, dtype=np.float32), dev), _f32(pose_inv, dev),
            torch.tensor(np.float32(obs_weight), device=dev), self._vox_world,
            self._trunc_margin)

    def volume(self):
        """(tsdf (X, Y, Z) float32, color (3, X, Y, Z) uint8) on the device."""
        dims = tuple(int(d) for d in self._vol_dim)
        return self._tsdf.reshape(dims), self._color.reshape((3,) + dims).to(torch.uint8)

    def get_volume(self):
        """(tsdf (X, Y, Z) float32, color (3, X, Y, Z) uint8) on the host,
        channel order r, g, b (reference fusion.py:197-209)."""
        tsdf, color = self.volume()
        return tsdf.cpu().numpy(), color.cpu().numpy()

    def get_point_cloud(self) -> np.ndarray:
        """(N, 6) [x y z r g b] surface point cloud (fusion.py:211-228)."""
        tsdf, color = self.get_volume()
        verts, _ = marching_tetrahedra(tsdf, level=0.0)
        if len(verts) == 0:
            return np.zeros((0, 6), np.float32)
        vi = np.clip(np.round(verts).astype(int), 0, np.asarray(tsdf.shape) - 1)
        rgb = color[:, vi[:, 0], vi[:, 1], vi[:, 2]].T
        world = verts * self._voxel_size + self._vol_origin
        return np.hstack([world, rgb.astype(np.float32)])

    def get_mesh(self):
        """(verts, faces, norms, colors) — reference fusion.py:230-248."""
        tsdf, color = self.get_volume()
        verts, faces = marching_tetrahedra(tsdf, level=0.0)
        if len(verts) == 0:
            z3 = np.zeros((0, 3))
            return z3.astype(np.float32), np.zeros((0, 3), np.int32), z3, z3.astype(np.uint8)
        vi = np.clip(np.round(verts).astype(int), 0, np.asarray(tsdf.shape) - 1)
        colors = color[:, vi[:, 0], vi[:, 1], vi[:, 2]].T
        norms = vertex_normals(verts, faces)
        world = verts * self._voxel_size + self._vol_origin
        return world.astype(np.float32), faces, norms, colors


def vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals."""
    fn = np.cross(
        verts[faces[:, 1]] - verts[faces[:, 0]],
        verts[faces[:, 2]] - verts[faces[:, 0]],
    )
    vn = np.zeros_like(verts)
    for i in range(3):
        np.add.at(vn, faces[:, i], fn)
    norm = np.linalg.norm(vn, axis=1, keepdims=True)
    return vn / np.maximum(norm, 1e-12)


def rigid_transform(xyz: np.ndarray, transform: np.ndarray) -> np.ndarray:
    """Apply a 4x4 homogeneous transform to (N, 3) points (fusion.py:251-256)."""
    xyz_h = np.hstack([xyz, np.ones((len(xyz), 1), xyz.dtype)])
    return (xyz_h @ np.asarray(transform).T)[:, :3]


def get_view_frustum(depth_im, cam_intr, cam_pose) -> np.ndarray:
    """(3, 5) world-frame view-frustum corners of a depth image
    (reference fusion.py:258-275)."""
    im_h, im_w = depth_im.shape
    max_depth = float(np.max(depth_im))
    cam_intr = np.asarray(cam_intr, dtype=np.float64)
    corners_pix = np.array(
        [[0, 0], [im_w, 0], [im_w, im_h], [0, im_h]], dtype=np.float64
    )
    pts = [np.zeros(3)]
    for u, v in corners_pix:
        x = (u - cam_intr[0, 2]) * max_depth / cam_intr[0, 0]
        y = (v - cam_intr[1, 2]) * max_depth / cam_intr[1, 1]
        pts.append(np.array([x, y, max_depth]))
    pts = np.stack(pts, axis=0)
    return rigid_transform(pts, cam_pose).T


def meshwrite(filename, verts, faces, norms, colors):
    """ASCII PLY mesh writer (reference fusion.py:278-308 output format)."""
    with open(filename, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write(
            "property float x\nproperty float y\nproperty float z\n"
            "property float nx\nproperty float ny\nproperty float nz\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        )
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_index\nend_header\n")
        for v, n, c in zip(verts, norms, colors):
            f.write(
                f"{v[0]:f} {v[1]:f} {v[2]:f} {n[0]:f} {n[1]:f} {n[2]:f} "
                f"{int(c[0])} {int(c[1])} {int(c[2])}\n"
            )
        for face in faces:
            f.write(f"3 {face[0]} {face[1]} {face[2]}\n")


def pcwrite(filename, xyzrgb):
    """ASCII PLY point-cloud writer (reference fusion.py:311-334 format)."""
    xyz, rgb = xyzrgb[:, :3], xyzrgb[:, 3:].astype(np.uint8)
    with open(filename, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(xyz)}\n")
        f.write(
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        )
        f.write("end_header\n")
        for p, c in zip(xyz, rgb):
            f.write(f"{p[0]:f} {p[1]:f} {p[2]:f} {int(c[0])} {int(c[1])} {int(c[2])}\n")
