"""Per-channel moments for GroupNorm: the CUDA kernel, its plain PyTorch
version and the autograd wrapper.

Counterpart of ``semantic_abstraction_tpu/ops/pallas_kernels.py``'s
``channel_moments`` (Pallas body ``_moments_kernel``). The kernel source is
``csrc/channel_moments.cu`` (design and bound noted there).
``channel_moments`` takes (B, C, S) and returns (s1, s2) = (sum x, sum x^2)
over S, both (B, C) float32:

- a CUDA tensor launches the kernel, or raises on what the kernel does not
  take (dtype, layout);
- a CPU tensor takes the plain version ``channel_moments_reference``.

The backward pass is plain torch, ``g1 + 2 x g2`` in f32 cast to x's dtype:
what JAX differentiates through the two f32 sums of ``group_norm``. The
JAX package has no backward kernel for these moments.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VEC_BYTES = 16      # one vector load
SMS = 132           # H100 SXM streaming multiprocessors
BLOCKS_PER_SM = 8   # 8 blocks of 256 threads fill an SM's 2048 threads
MIN_VECS = 4        # each thread of a full block reads at least 4 vectors


def channel_moments_reference(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain (sum x, sum x^2) over the last axis in f32: the CPU path and
    the kernel's oracle."""
    xf = x.float()
    return xf.sum(-1), xf.square().sum(-1)


def plan(rows: int, s: int, elt: int) -> Tuple[int, int, int]:
    """(chunk, splits, threads) of the launch for ``rows`` rows of ``s``
    elements of ``elt`` bytes: each row is cut into ``splits`` chunks of
    ``chunk`` elements (a multiple of 8, so that every chunk of a 16-byte
    aligned row starts aligned), enough for about BLOCKS_PER_SM blocks on
    each SM but none smaller than a full block's MIN_VECS vectors a
    thread; ``threads`` covers a small row's vectors with whole warps."""
    vec = VEC_BYTES // elt
    splits = max(1, min(_cdiv(SMS * BLOCKS_PER_SM, rows),
                        _cdiv(s, 256 * vec * MIN_VECS), 65535))
    chunk = _cdiv(_cdiv(s, splits), 8) * 8
    splits = _cdiv(s, chunk)
    threads = min(256, max(32, _cdiv(_cdiv(chunk, vec), 32) * 32))
    return chunk, splits, threads


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _check(x: torch.Tensor) -> None:
    if x.dim() != 3:
        raise ValueError(f"channel_moments takes (B, C, S), got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"channel_moments takes float32 or bfloat16, got {x.dtype}")
    if x.numel() == 0:
        raise ValueError(f"channel_moments takes a non-empty tensor, got {tuple(x.shape)}")
    if not x.is_contiguous():
        # the kernel reads each (b, c) row as one contiguous run of S; a
        # channels-last or sliced view would need a copy, which the caller
        # must make (or avoid) on purpose
        raise ValueError(f"channel_moments needs a contiguous (B, C, S) tensor, "
                         f"got strides {x.stride()}")


@functools.lru_cache(maxsize=None)
def _kernel():
    """The built library's launch function with its C signature."""
    lib = _build.load("channel_moments")
    lib.channel_moments_max_threads.argtypes = []
    lib.channel_moments_max_threads.restype = ctypes.c_int
    if lib.channel_moments_max_threads() != 256:
        raise RuntimeError("built channel_moments kernel disagrees on its block size")
    fn = lib.channel_moments_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 3
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    return fn


def _launch(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the CUDA kernel; counts one launch on ``channel_moments.launches``."""
    _check(x)
    b, c, s = x.shape
    rows = b * c
    chunk, splits, threads = plan(rows, s, x.element_size())
    fn = _kernel()
    s1 = torch.empty((b, c), dtype=torch.float32, device=x.device)
    s2 = torch.empty((b, c), dtype=torch.float32, device=x.device)
    partial = (torch.empty(2 * rows * splits, dtype=torch.float32, device=x.device)
               if splits > 1 else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), s1.data_ptr(), s2.data_ptr(),
                 partial.data_ptr() if partial is not None else None,
                 rows, s, chunk, splits, threads, _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"channel_moments kernel launch failed: cudaError {err}")
    channel_moments.launches += 1
    return s1, s2


class _ChannelMoments(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _launch(x)

    @staticmethod
    def backward(ctx, g1, g2):
        (x,) = ctx.saved_tensors
        gx = g1.float()[..., None] + 2.0 * x.float() * g2.float()[..., None]
        return gx.to(x.dtype)


def channel_moments(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, C, S) -> (sum x, sum x^2) over S, both (B, C) float32."""
    if x.device.type == "cpu":
        return channel_moments_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"channel_moments runs on cuda or cpu, got {x.device}")
    return _ChannelMoments.apply(x)


channel_moments.launches = 0  # kernel launches since the caller last set it to 0
