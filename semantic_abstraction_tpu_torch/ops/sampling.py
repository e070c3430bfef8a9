"""Interpolation: the relevancy path's resize matrices and the implicit
decoder's trilinear volume sampler.

- ``resize_matrix``: a copy of ``semantic_abstraction_tpu.ops.sampling``'s
  ``_cubic_kernel`` and ``resize_matrix`` (the port imports nothing of the
  JAX package). The matrices are built once per (in, out, method) on the
  host and applied on the device as two ``torch.matmul`` calls.
- ``grid_sample_3d``: counterpart of the JAX ``grid_sample_3d`` (dense
  NCDHW form), torch ``grid_sample`` with border padding and
  ``align_corners=True``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def grid_sample_3d(vol: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample a (B, C, D, H, W) volume at (B, N, 3) normalized coords in
    [-1, 1]; returns (B, N, C) in the volume's dtype.

    coords[..., 0] indexes W (the last axis), [..., 1] H, [..., 2] D, as in
    torch's ``grid_sample``. The decoder passes (x, y, z)-ordered coords of
    an (x, y, z)-laid-out volume, so world-x indexes the last axis: the
    reference's quirk, baked into its checkpoints.

    The volume is sampled as f32 with f32 coords and the result cast back:
    ``grid_sample`` takes its grid in the volume's dtype, and a bf16 grid
    would put the normalized coords on a 2^-7 lattice (up to half a voxel
    off at 128^3), while the JAX sampler computes its indices and fractions
    in f32. The coords carry no gradient.
    """
    b, n = coords.shape[:2]
    grid = coords.detach().float().reshape(b, n, 1, 1, 3)
    out = F.grid_sample(vol.float(), grid, mode="bilinear",
                        padding_mode="border", align_corners=True)
    return out.reshape(b, -1, n).transpose(1, 2).to(vol.dtype)


def _cubic_kernel(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    """Catmull-Rom cubic (a=-0.5), the kernel used by both PIL and torch."""
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    w = np.where(
        ax <= 1.0,
        (a + 2.0) * ax3 - (a + 3.0) * ax2 + 1.0,
        np.where(ax < 2.0, a * ax3 - 5.0 * a * ax2 + 8.0 * a * ax - 4.0 * a, 0.0),
    )
    return w


@functools.lru_cache(maxsize=None)
def resize_matrix(in_size: int, out_size: int, method: str = "bilinear_torch"):
    """Precompute a dense (out_size, in_size) 1-D interpolation matrix.

    methods:
    - "bilinear_torch":  torch ``F.interpolate(mode="bilinear",
      align_corners=False, antialias=False)`` row weights.
    - "bilinear_torch_ac": same with align_corners=True.
    - "bicubic_pil": PIL's antialiased BICUBIC resample weights (support
      scaled by the downsampling factor, weights normalized to sum 1). This
      is the CLIP tile-preprocess resize.

    Cached per (in, out, method); returns a float32 numpy array. Callers
    must not write into it.
    """
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    if method in ("bilinear_torch", "bilinear_torch_ac"):
        if method == "bilinear_torch_ac" and out_size > 1:
            scale = (in_size - 1) / (out_size - 1)
            centers = np.arange(out_size) * scale
        else:
            scale = in_size / out_size
            centers = (np.arange(out_size) + 0.5) * scale - 0.5
        centers = np.clip(centers, 0.0, in_size - 1)
        lo = np.floor(centers).astype(int)
        hi = np.minimum(lo + 1, in_size - 1)
        frac = centers - lo
        mat[np.arange(out_size), lo] += 1.0 - frac
        mat[np.arange(out_size), hi] += frac
    elif method == "bicubic_pil":
        scale = in_size / out_size
        filterscale = max(scale, 1.0)
        support = 2.0 * filterscale
        for i in range(out_size):
            center = (i + 0.5) * scale
            xmin = max(int(center - support + 0.5), 0)
            xmax = min(int(center + support + 0.5), in_size)
            xs = np.arange(xmin, xmax)
            w = _cubic_kernel((xs - center + 0.5) / filterscale)
            s = w.sum()
            if s != 0:
                w = w / s
            mat[i, xmin:xmax] = w
    else:
        raise ValueError(f"unknown resize method {method!r}")
    return mat.astype(np.float32)
