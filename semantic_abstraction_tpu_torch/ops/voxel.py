"""Voxel grid index math and the point -> voxel scatter, in PyTorch.

Counterpart of ``semantic_abstraction_tpu/ops/voxel.py`` ``VoxelGrid`` in
its dense layout (the reference's ``VirtualGrid`` + torch_scatter):

- ``points_to_idxs``: the float index is truncated toward zero, then
  clamped per axis to [0, dim - 1]; with ``cast_to_int=False`` the float
  index itself is clamped.
- ``flatten_idxs``: row-major bin ids over (gx, gy, gz).
- ``scatter_points``: "max" or "mean" of (B, N, C) point features into a
  (B, C, gx, gy, gz) volume through ``scatter_reduce(include_self=False)``
  on a zero output, so bins that receive no point are 0 (torch_scatter's
  convention). ``valid_mask`` routes dropped points to a trash bin past the
  end. The reduction runs in the features' dtype (f32 on the model path).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

_REDUCE = {"max": "amax", "mean": "mean"}


@dataclasses.dataclass(frozen=True)
class VoxelGrid:
    """World-coordinate <-> voxel-index mapping over axis-aligned bounds."""

    lower: Tuple[float, float, float]
    upper: Tuple[float, float, float]
    grid_shape: Tuple[int, int, int] = (32, 32, 32)

    @classmethod
    def from_bounds(cls, scene_bounds, grid_shape=(32, 32, 32)) -> "VoxelGrid":
        scene_bounds = np.asarray(scene_bounds, dtype=np.float64)
        return cls(lower=tuple(float(v) for v in scene_bounds[0]),
                   upper=tuple(float(v) for v in scene_bounds[1]),
                   grid_shape=tuple(int(v) for v in grid_shape))

    @property
    def num_voxels(self) -> int:
        return int(np.prod(self.grid_shape))

    def points_to_idxs(self, points: torch.Tensor,
                       cast_to_int: bool = True) -> torch.Tensor:
        """World points (..., 3) -> clamped voxel indices (int64, or the
        clamped float index without ``cast_to_int``). The arithmetic is the
        JAX package's, op for op, in the points' dtype."""
        kw = dict(dtype=points.dtype, device=points.device)
        lc = torch.tensor(self.lower, **kw)
        uc = torch.tensor(self.upper, **kw)
        hi = torch.tensor(self.grid_shape, **kw) - 1
        idx_f = (points - lc) * (hi / (uc - lc))
        if cast_to_int:
            idx = torch.trunc(idx_f).to(torch.int64)
            top = torch.tensor(self.grid_shape, device=points.device) - 1
            return torch.minimum(idx.clamp_min(0), top)
        return torch.minimum(idx_f.clamp_min(0.0), hi)

    def flatten_idxs(self, idxs: torch.Tensor) -> torch.Tensor:
        """Row-major flatten of (..., 3) voxel indices to scalar bin ids."""
        _, gy, gz = self.grid_shape
        return idxs[..., 0] * (gy * gz) + idxs[..., 1] * gz + idxs[..., 2]

    def scatter_points(self, xyz_pts: torch.Tensor, feature_pts: torch.Tensor,
                       reduce_method: str = "max",
                       valid_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, N, 3) points and (B, N, C) features -> (B, C, gx, gy, gz)."""
        if reduce_method not in _REDUCE:
            raise ValueError(f"unknown reduce_method {reduce_method!r}")
        if xyz_pts.dim() == 2:
            xyz_pts, feature_pts = xyz_pts[None], feature_pts[None]
        batch, num_pts, channels = feature_pts.shape
        nv = self.num_voxels
        flat = self.flatten_idxs(self.points_to_idxs(xyz_pts))
        seg = flat + torch.arange(batch, device=flat.device)[:, None] * nv
        if valid_mask is not None:
            # invalid points land in a trash bin past the end
            seg = torch.where(valid_mask.to(torch.bool), seg,
                              torch.full_like(seg, batch * nv))
        num_bins = batch * nv + (valid_mask is not None)
        feats = feature_pts.reshape(batch * num_pts, channels)
        index = seg.reshape(-1, 1).expand(-1, channels)
        out = feats.new_zeros((num_bins, channels)).scatter_reduce(
            0, index, feats, _REDUCE[reduce_method], include_self=False)
        vol = out[: batch * nv].reshape(batch, *self.grid_shape, channels)
        return vol.permute(0, 4, 1, 2, 3).contiguous()
