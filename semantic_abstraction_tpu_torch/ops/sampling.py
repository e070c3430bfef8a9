"""Interpolation matrices for the relevancy path (numpy, host-side).

A copy of ``semantic_abstraction_tpu.ops.sampling._cubic_kernel`` and
``resize_matrix``: the port imports nothing of the JAX package. The
matrices are built once per (in, out, method) on the host and applied on
the device as two ``torch.matmul`` calls.
"""
from __future__ import annotations

import functools

import numpy as np


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
