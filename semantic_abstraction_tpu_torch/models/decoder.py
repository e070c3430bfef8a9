"""Implicit volumetric decoder and pointing attention (the reference's
ImplicitVolumetricDecoder and PointingAttention).

Counterpart of ``semantic_abstraction_tpu/models/decoder.py``:

- ``implicit_decoder``: sample the feature volume trilinearly at
  continuous query points, optionally concatenate the sample coords, and
  run Linear -> LeakyReLU(0.01) -> Linear per point. Two reference quirks
  are kept because trained checkpoints bake them in: the clamped float
  voxel index is normalized by ``grid_shape`` (not ``grid_shape - 1``), and
  coordinate component 0 (world x) indexes the volume's last axis.
- ``pointing_attention`` (key against query through ``_prep_input``'s
  broadcast) and ``pointing_attention_paired`` (one key row per query
  set): ``dot_product`` (/sqrt(d)), ``cosine_sim`` (each norm clamped at
  1e-8, /temperature) and ``additive`` (tanh, then the learned
  ``pointer_v`` readout).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.sampling import grid_sample_3d
from ..ops.voxel import VoxelGrid
from .params import Params, init_linear_, linear, linear_params

POINTING_METHODS = ("dot_product", "cosine_sim", "additive")


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


class PointingAttention(nn.Module):
    """The reference's PointingAttention: ``pointer_v`` (weight (1, d), no
    bias) for the ``additive`` method, no parameters for the others."""

    def __init__(self, pointing_dim: int, method: str = "cosine_sim"):
        super().__init__()
        if method not in POINTING_METHODS:
            raise ValueError(f"unknown pointing method {method!r}")
        if method == "additive":
            self.pointer_v = Params(weight=(1, pointing_dim))


def init_pointing_attention(generator: torch.Generator, pointing_dim: int,
                            method: str = "cosine_sim") -> PointingAttention:
    """``pointer_v`` from U(-1/sqrt(d), 1/sqrt(d)), as the JAX package."""
    pointer = PointingAttention(pointing_dim, method)
    if method == "additive":
        bound = pointing_dim ** -0.5
        with torch.no_grad():
            pointer.pointer_v.weight.uniform_(-bound, bound, generator=generator)
    return pointer


def _prep_input(key: torch.Tensor, query: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Broadcast shaping of the reference (net.py:275-292): key
    (B, K, ..., D) and query (B, Q, ..., D) of other shapes become
    (B, K, 1, ..., D) and (B, 1, Q, ..., D)."""
    if key.shape == query.shape:
        return key, query
    for _ in range(key.dim() - 3):
        query = query.unsqueeze(2)
    for _ in range(query.dim() - key.dim()):
        key = key.unsqueeze(-2)
    return key.unsqueeze(2), query.unsqueeze(1)


def _norm(x: torch.Tensor) -> torch.Tensor:
    """|x| over the last axis as the JAX package's compiled
    ``jnp.linalg.norm`` computes it: squares summed in f32, the sum rounded
    to x's dtype, then its root (``torch.linalg.vector_norm`` rounds a bf16
    norm once, at the root, and moves VOOL's bf16 logits by up to 0.07)."""
    return torch.sqrt(x.float().square().sum(-1).to(x.dtype))


def _cosine(key: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """(k . q) / (max(|k|, 1e-8) max(|q|, 1e-8)) over the last axis: the JAX
    formula (``F.cosine_similarity`` clamps the product of the norms)."""
    kn = _norm(key).clamp_min(1e-8)
    qn = _norm(query).clamp_min(1e-8)
    return (key * query).sum(-1) / (kn * qn)


def _point(pointer: PointingAttention, key: torch.Tensor, query: torch.Tensor,
           method: str, pointing_dim: Optional[int],
           temperature: float) -> torch.Tensor:
    if method == "dot_product":
        d = pointing_dim if pointing_dim is not None else key.shape[-1]
        return (query * key).sum(-1) / math.sqrt(d)
    if method == "cosine_sim":
        return _cosine(key, query) / temperature
    if method == "additive":
        h = torch.tanh(query + key)
        return torch.matmul(h, pointer.pointer_v.weight.to(h.dtype).t())[..., 0]
    raise ValueError(f"unknown pointing method {method!r}")


def pointing_attention(pointer: PointingAttention, key: torch.Tensor,
                       query: torch.Tensor, method: str = "cosine_sim",
                       pointing_dim: Optional[int] = None,
                       temperature: float = 0.07) -> torch.Tensor:
    """key (B, K, ..., D) x query (B, Q, ..., D) -> similarity logits
    (reference net.py:294-316). VOOL's pointer: key (B*D, M, pd) against
    query (B*D, 1, pd) gives (B*D, M, 1)."""
    key, query = _prep_input(key, query)
    return _point(pointer, key, query, method, pointing_dim, temperature)


def pointing_attention_paired(pointer: PointingAttention, key: torch.Tensor,
                              query: torch.Tensor, method: str = "cosine_sim",
                              pointing_dim: Optional[int] = None,
                              temperature: float = 0.07) -> torch.Tensor:
    """key (..., D) against query (..., M, D) -> (..., M): the reference's
    per-patch pointer loop (SemanticAwareOVSSC, net.py:449-466) as one
    broadcast."""
    return _point(pointer, key[..., None, :], query, method, pointing_dim,
                  temperature)
