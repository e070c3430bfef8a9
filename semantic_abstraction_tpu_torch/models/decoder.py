"""Implicit volumetric decoder (the reference's ImplicitVolumetricDecoder).

Counterpart of ``semantic_abstraction_tpu/models/decoder.py``
``implicit_decoder``: sample the feature volume trilinearly at continuous
query points, optionally concatenate the sample coords, and run
Linear -> LeakyReLU(0.01) -> Linear per point. Two reference quirks are
kept because trained checkpoints bake them in: the clamped float voxel
index is normalized by ``grid_shape`` (not ``grid_shape - 1``), and
coordinate component 0 (world x) indexes the volume's last axis.
Pointing attention belongs to the VOOL nets and is not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.sampling import grid_sample_3d
from ..ops.voxel import VoxelGrid
from .params import init_linear_, linear, linear_params


class ImplicitDecoder(nn.Module):
    """``mlp`` = Sequential(Linear, LeakyReLU, Linear), the reference keys."""

    def __init__(self, hidden_size: int, output_dim: int,
                 concat_xyz_pts: bool = False):
        super().__init__()
        self.mlp = nn.Sequential(
            linear_params(hidden_size + 3 * int(concat_xyz_pts), hidden_size),
            nn.LeakyReLU(0.01),
            linear_params(hidden_size, output_dim),
        )


def init_implicit_decoder(generator: torch.Generator, hidden_size: int,
                          output_dim: int,
                          concat_xyz_pts: bool = False) -> ImplicitDecoder:
    dec = ImplicitDecoder(hidden_size, output_dim, concat_xyz_pts)
    init_linear_(dec.mlp[0], generator)
    init_linear_(dec.mlp[2], generator)
    return dec


def implicit_decoder(dec: ImplicitDecoder, features_vol: torch.Tensor,
                     grid: VoxelGrid, query_points: torch.Tensor,
                     concat_xyz_pts: bool = False) -> torch.Tensor:
    """(B, C, gx, gy, gz) volume + (B, N, 3) world points -> (B, N, out),
    in the volume's dtype."""
    idx_f = grid.points_to_idxs(query_points, cast_to_int=False)
    shape = torch.tensor(grid.grid_shape, dtype=idx_f.dtype, device=idx_f.device)
    coords = (2.0 * (idx_f / shape) - 1.0).detach()  # data, not parameters
    sampled = grid_sample_3d(features_vol, coords)  # (B, N, C)
    if concat_xyz_pts:
        sampled = torch.cat([sampled, coords.to(sampled.dtype)], dim=-1)
    h = F.leaky_relu(linear(dec.mlp[0], sampled), negative_slope=0.01)
    return linear(dec.mlp[2], h)
