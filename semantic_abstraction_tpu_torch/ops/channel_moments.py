"""Per-channel moments for GroupNorm: the CUDA kernels of both directions,
their plain PyTorch versions and the autograd wrapper.

Counterpart of ``semantic_abstraction_tpu/ops/pallas_kernels.py``'s
``channel_moments`` (Pallas body ``_moments_kernel``). The kernel source is
``csrc/channel_moments.cu`` (design and bound noted there).
``channel_moments`` takes (B, C, S) and returns (s1, s2) = (sum x, sum x^2)
over S, both (B, C) float32:

- a CUDA tensor launches the forward kernel, or raises on what the kernel
  does not take (dtype, layout);
- a CPU tensor takes the plain version ``channel_moments_reference``.

Its gradient, ``g1 + 2 x g2`` in f32 cast to x's dtype, is what JAX
differentiates through the two f32 sums of ``group_norm``. On the card it
is the backward kernel (``channel_moments_backward``), bit for bit equal to
the plain ``channel_moments_backward_reference``; the JAX package has no
backward kernel, XLA fuses that gradient itself.

``plan`` is the host side of both kernels' launch: which rows go to lane
groups and which to blocks, and how many blocks a row.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VEC_BYTES = 16       # one vector load
THREADS = 256        # threads of a block, both regimes
MAX_GROUP = 32       # lanes of one short row: at most a warp
GROUP_VECS = 4       # a short row gives each of its lanes at most 4 vectors
MAX_SPLITS = 8       # blocks of one long row: the portable cluster size
TARGET_BLOCKS = 256  # blocks of a long-row launch: about 2 an SM, one wave
MIN_VECS = 32        # each thread of a split reads at least 32 vectors (128 KB
                     # a block); 4 and 16 measured no faster
                     # (scripts/torch_moments_sweep.py)


class Plan(NamedTuple):
    """The launch of both kernels for (rows, s): ``group`` lanes a row
    (short rows, THREADS / group rows a block; 0 in the block regime), and
    ``splits`` blocks a row of ``chunk`` elements each (block regime; 1 and
    s for short rows)."""
    group: int
    splits: int
    chunk: int


def plan(rows: int, s: int, elt: int, target_blocks: int = TARGET_BLOCKS,
         min_vecs: int = MIN_VECS) -> Plan:
    """The launch for ``rows`` rows of ``s`` elements of ``elt`` bytes.

    A row of at most MAX_GROUP * GROUP_VECS 16-byte vectors is a short row:
    a group of lanes (its vector count rounded up to a power of two, at
    most a warp) sums it. A longer row gets up to MAX_SPLITS blocks (one
    cluster), about ``target_blocks`` blocks in all but none with fewer than
    ``min_vecs`` vectors a thread; each chunk is a multiple of 8 elements,
    so that every chunk of a 16-byte aligned row starts aligned."""
    vec = VEC_BYTES // elt
    vecs = _cdiv(s, vec)
    if vecs <= MAX_GROUP * GROUP_VECS:
        return Plan(min(MAX_GROUP, 1 << (vecs - 1).bit_length()), 1, s)
    splits = max(1, min(MAX_SPLITS, target_blocks // rows, s // (THREADS * vec * min_vecs)))
    chunk = _cdiv(_cdiv(s, splits), 8) * 8
    return Plan(0, _cdiv(s, chunk), chunk)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def channel_moments_reference(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain (sum x, sum x^2) over the last axis in f32: the CPU path and
    the forward kernel's oracle."""
    xf = x.float()
    return xf.sum(-1), xf.square().sum(-1)


def channel_moments_backward_reference(x: torch.Tensor, g1: torch.Tensor,
                                       g2: torch.Tensor) -> torch.Tensor:
    """Plain gradient of (sum x, sum x^2) over the last axis: g1 + 2 x g2 in
    f32, cast to x's dtype. The CPU path and the backward kernel's oracle
    (the kernel rounds each step alike, so the two agree bit for bit)."""
    gx = g1.float()[..., None] + 2.0 * x.float() * g2.float()[..., None]
    return gx.to(x.dtype)


def _check(x: torch.Tensor) -> None:
    if x.dim() != 3:
        raise ValueError(f"channel_moments takes (B, C, S), got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"channel_moments takes float32 or bfloat16, got {x.dtype}")
    if x.numel() == 0:
        raise ValueError(f"channel_moments takes a non-empty tensor, got {tuple(x.shape)}")
    if not x.is_contiguous():
        # the kernels read each (b, c) row as one contiguous run of S; a
        # channels-last or sliced view would need a copy, which the caller
        # must make (or avoid) on purpose
        raise ValueError(f"channel_moments needs a contiguous (B, C, S) tensor, "
                         f"got strides {x.stride()}")


def _check_grads(x: torch.Tensor, g1: torch.Tensor, g2: torch.Tensor) -> None:
    _check(x)
    for g in (g1, g2):
        if (g.shape != x.shape[:2] or g.dtype != torch.float32 or g.device != x.device
                or not g.is_contiguous()):
            raise ValueError(f"channel_moments_backward takes contiguous (B, C) float32 "
                             f"gradients on {x.device}, got {tuple(g.shape)} {g.dtype} "
                             f"strides {g.stride()} on {g.device}")


@functools.lru_cache(maxsize=None)
def _kernels():
    """The built library's (forward, backward) launch functions with their C
    signatures."""
    lib = _build.load("channel_moments")
    lib.channel_moments_threads.argtypes = []
    lib.channel_moments_threads.restype = ctypes.c_int
    if lib.channel_moments_threads() != THREADS:
        raise RuntimeError("built channel_moments kernel disagrees on its block size")
    plan_args = [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2 + [ctypes.c_longlong, ctypes.c_int,
                                                                ctypes.c_void_p]
    fwd = lib.channel_moments_launch
    fwd.restype = ctypes.c_int
    fwd.argtypes = [ctypes.c_void_p] * 3 + plan_args
    bwd = lib.channel_moments_backward_launch
    bwd.restype = ctypes.c_int
    bwd.argtypes = [ctypes.c_void_p] * 4 + plan_args
    return fwd, bwd


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _launch(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the forward kernel; counts one launch on ``channel_moments.launches``."""
    _check(x)
    b, c, s = x.shape
    p = plan(b * c, s, x.element_size())
    fwd, _ = _kernels()
    s1 = torch.empty((b, c), dtype=torch.float32, device=x.device)
    s2 = torch.empty((b, c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = fwd(x.data_ptr(), s1.data_ptr(), s2.data_ptr(), b * c, s, p.group, p.splits,
                  p.chunk, _DTYPES[x.dtype], _stream(x))
    if err != 0:
        raise RuntimeError(f"channel_moments kernel launch failed: cudaError {err}")
    channel_moments.launches += 1
    return s1, s2


def _launch_backward(x: torch.Tensor, g1: torch.Tensor, g2: torch.Tensor) -> torch.Tensor:
    """Run the backward kernel; counts one launch on
    ``channel_moments_backward.launches``."""
    _check_grads(x, g1, g2)
    b, c, s = x.shape
    p = plan(b * c, s, x.element_size())
    _, bwd = _kernels()
    gx = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = bwd(x.data_ptr(), gx.data_ptr(), g1.data_ptr(), g2.data_ptr(), b * c, s,
                  p.group, p.splits, p.chunk, _DTYPES[x.dtype], _stream(x))
    if err != 0:
        raise RuntimeError(f"channel_moments backward kernel launch failed: cudaError {err}")
    channel_moments_backward.launches += 1
    return gx


class _ChannelMoments(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _launch(x)

    @staticmethod
    def backward(ctx, g1, g2):
        (x,) = ctx.saved_tensors
        # the (B, C) gradients arrive contiguous from group_norm; a
        # broadcast one is made so here, x itself is never copied
        return _launch_backward(x, g1.contiguous(), g2.contiguous())


def channel_moments(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, C, S) -> (sum x, sum x^2) over S, both (B, C) float32."""
    if x.device.type == "cpu":
        return channel_moments_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"channel_moments runs on cuda or cpu, got {x.device}")
    return _ChannelMoments.apply(x)


def channel_moments_backward(x: torch.Tensor, g1: torch.Tensor,
                             g2: torch.Tensor) -> torch.Tensor:
    """The gradient of ``channel_moments`` at x (B, C, S) for the (B, C)
    float32 gradients g1, g2 of its two sums: g1 + 2 x g2, in x's dtype."""
    if x.device.type == "cpu":
        return channel_moments_backward_reference(x, g1, g2)
    if x.device.type != "cuda":
        raise ValueError(f"channel_moments_backward runs on cuda or cpu, got {x.device}")
    return _launch_backward(x, g1, g2)


channel_moments.launches = 0  # forward launches since the caller last set it to 0
channel_moments_backward.launches = 0  # backward launches, likewise
