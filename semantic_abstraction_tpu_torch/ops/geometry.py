"""Point-cloud geometry primitives on tensors.

Counterpart of ``semantic_abstraction_tpu/ops/geometry.py`` (reference
point_cloud.py): the same functions on torch tensors of any device, masks
instead of ragged filtered arrays.

Every product runs in the inputs' dtype and never in TF32: the JAX package
asks for ``Precision.HIGHEST`` on its two einsums, and a ``torch.matmul``
on the card would round f32 inputs to TF32 under
``torch.backends.cuda.matmul.allow_tf32``. The 3-wide contractions are
therefore written as elementwise products summed in index order.
"""
from __future__ import annotations

from typing import Optional

import torch


def _rotate(xyz_pts: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """``xyz_pts @ rot.T`` over (..., N, 3) points and a (..., 3, 3)
    rotation, as elementwise products summed over j = 0, 1, 2."""
    x = xyz_pts[..., :, None, :]  # (..., N, 1, 3)
    r = rot[..., None, :, :]  # (..., 1, 3, 3): r[..., i, j]
    prod = x * r
    return prod[..., 0] + prod[..., 1] + prod[..., 2]


def transform_pointcloud(xyz_pts: torch.Tensor, rigid_transform: torch.Tensor) -> torch.Tensor:
    """Apply a rigid transform (3x4 or 4x4) to an (..., N, 3) point cloud."""
    rot = rigid_transform[..., :3, :3]
    trans = rigid_transform[..., :3, 3]
    return _rotate(xyz_pts, rot) + trans[..., None, :]


def filter_pts_bounds(xyz_pts: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """Boolean mask of points inside axis-aligned ``bounds`` ((2, 3): lower,
    upper), inclusive on both ends."""
    return ((xyz_pts >= bounds[0]) & (xyz_pts <= bounds[1])).all(dim=-1)


def depth_to_pointcloud(depth_img: torch.Tensor, cam_intr: torch.Tensor,
                        cam_pose: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Unproject an (H, W) depth image to an (H*W, 3) point cloud, in camera
    coordinates, or world coordinates if ``cam_pose`` (camera-to-world)
    is given."""
    img_h, img_w = depth_img.shape
    kw = dict(dtype=depth_img.dtype, device=depth_img.device)
    pixel_y, pixel_x = torch.meshgrid(torch.arange(img_h, **kw),
                                      torch.arange(img_w, **kw), indexing="ij")
    z = depth_img
    x = (pixel_x - cam_intr[0, 2]) * z / cam_intr[0, 0]
    y = (pixel_y - cam_intr[1, 2]) * z / cam_intr[1, 1]
    cam_pts = torch.stack([x, y, z], dim=-1).reshape(-1, 3)
    if cam_pose is not None:
        cam_pts = transform_pointcloud(cam_pts, cam_pose)
    return cam_pts


def project_pts_to_2d(pts: torch.Tensor, camera_view_matrix: torch.Tensor,
                      camera_intrinsic: torch.Tensor) -> torch.Tensor:
    """Project (N, 3) world points to (N, 3) of (row, col, depth), in the
    reference's OpenGL convention: y and z are negated after the view
    transform, before the intrinsics."""
    pts_c = transform_pointcloud(pts, camera_view_matrix[:3, :])
    flip = torch.tensor([1.0, -1.0, -1.0], dtype=pts_c.dtype, device=pts_c.device)
    pts_flipped = pts_c * flip
    coords = _rotate(pts_flipped, camera_intrinsic)
    pix = coords[:, :2] / coords[:, 2:3]
    return torch.stack([pix[:, 1], pix[:, 0], pts_flipped[:, 2]], dim=-1)


def check_pts_in_frustum(xyz_pts: torch.Tensor, depth_shape, cam_pose: torch.Tensor,
                         cam_intr: torch.Tensor) -> torch.Tensor:
    """Boolean mask of world points inside the view frustum of a camera at
    ``cam_pose`` (camera-to-world, 4x4) with an (H, W) image: in frame and
    z > 0."""
    h, w = depth_shape
    cam_pts = transform_pointcloud(xyz_pts, torch.linalg.inv(cam_pose))
    pix_z = cam_pts[..., 2]
    pix_x = cam_intr[0, 0] / pix_z * cam_pts[..., 0] + cam_intr[0, 2]
    pix_y = cam_intr[1, 1] / pix_z * cam_pts[..., 1] + cam_intr[1, 2]
    return (pix_x >= 0) & (pix_x < w) & (pix_y >= 0) & (pix_y < h) & (pix_z > 0)
