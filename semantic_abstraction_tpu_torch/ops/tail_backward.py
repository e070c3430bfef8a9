"""The LayerNorm and quick-GELU backward of the general Chefer tail: the
CUDA kernels and their plain PyTorch versions.

They replace no Pallas kernel: the JAX package leaves both backward
passes to XLA. The kernel source is ``csrc/tail_backward.cu`` (design and
bound noted there). ``clip/model.py``'s autograd Functions for
``layer_norm`` and ``quick_gelu`` call them from their backward:

- ``layer_norm_backward(g, x, mean, rstd, scale)``: the input gradient of
  ``layer_norm`` from its output gradient g, its input x (one dtype), the
  (..., 1) f32 mean and 1/std its forward computed, and its scale;
- ``quick_gelu_backward(g, x)``: the input gradient of ``quick_gelu``.

Both compute in f32 and round once to x's dtype. Both are
``torch.library`` custom ops: the batched backward of
``autograd.grad(..., is_grads_batched=True)`` runs under the legacy vmap,
which has no batching rule for them and so calls them once a label on the
label's real (B, T, W) slice, a tensor a ctypes launch can read. For
either:

- a CUDA tensor launches the kernel, or raises on what the kernel does not
  take (dtype, layout, a LayerNorm row wider than ``MAX_VECTORS`` 16-byte
  vectors);
- a CPU tensor takes the plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_VECTORS = 256  # a LayerNorm row's bound in 16-byte vectors (tail_backward_max_vectors())
GELU_ALPHA = 1.702


def layer_norm_backward_reference(g: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
                                  rstd: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain version in f32: the CPU path and the kernel's oracle."""
    xhat = (x.float() - mean) * rstd
    gy = g.float() * scale.float()
    dx = rstd * (gy - gy.mean(dim=-1, keepdim=True)
                 - xhat * (gy * xhat).mean(dim=-1, keepdim=True))
    return dx.to(x.dtype)


def quick_gelu_backward_reference(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain version in f32: the CPU path and the kernel's oracle."""
    x32 = x.float()
    s = torch.sigmoid(GELU_ALPHA * x32)
    return (g.float() * (s + GELU_ALPHA * x32 * s * (1.0 - s))).to(x.dtype)


def _check(name: str, g: torch.Tensor, x: torch.Tensor) -> None:
    if g.shape != x.shape:
        raise ValueError(f"{name}: g and x must share one shape, got {tuple(g.shape)}, "
                         f"{tuple(x.shape)}")
    if g.dtype != x.dtype or x.dtype not in _DTYPES:
        raise TypeError(f"{name} takes g and x of one of float32 or bfloat16, got "
                        f"{g.dtype}, {x.dtype}")
    if g.device != x.device:
        raise ValueError(f"{name}: g and x must be on one device")
    if x.numel() == 0:
        raise ValueError(f"{name} takes non-empty tensors, got {tuple(x.shape)}")
    for a in (g, x):
        if not a.is_contiguous() or a.data_ptr() % 16:
            raise ValueError(f"{name} needs contiguous, 16-byte aligned tensors, got "
                             f"strides {a.stride()} at address {a.data_ptr():#x}")


@functools.lru_cache(maxsize=None)
def _kernels():
    """The built library's two launch functions with their C signatures."""
    lib = _build.load("tail_backward")
    lib.tail_backward_max_vectors.argtypes = []
    lib.tail_backward_max_vectors.restype = ctypes.c_int
    if lib.tail_backward_max_vectors() != MAX_VECTORS:
        raise RuntimeError("built tail_backward kernel disagrees on its row bound")
    ln = lib.layer_norm_backward_launch
    ln.restype = ctypes.c_int
    ln.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                             ctypes.c_void_p])
    gelu = lib.quick_gelu_backward_launch
    gelu.restype = ctypes.c_int
    gelu.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    return ln, gelu


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_layer_norm(g, x, mean, rstd, scale):
    """Run the LayerNorm kernel; counts one launch on
    ``layer_norm_backward.launches``."""
    _check("layer_norm_backward", g, x)
    w = x.shape[-1]
    rows = x.numel() // w
    per16 = 16 // x.element_size()
    if w % per16 or w > MAX_VECTORS * per16:
        raise ValueError(f"layer_norm_backward takes rows of a multiple of {per16} and at "
                         f"most {MAX_VECTORS * per16} {x.dtype} elements, got {w}")
    mean, rstd = mean.float().contiguous(), rstd.float().contiguous()
    gamma = scale.float().contiguous()
    if mean.numel() != rows or rstd.numel() != rows or gamma.numel() != w:
        raise ValueError(f"layer_norm_backward: mean and rstd need {rows} values and scale "
                         f"{w}, got {mean.numel()}, {rstd.numel()}, {gamma.numel()}")
    if not (mean.device == rstd.device == gamma.device == x.device):
        raise ValueError("layer_norm_backward: every input must be on one device")
    if gamma.data_ptr() % 16:
        raise ValueError("layer_norm_backward needs a 16-byte aligned scale")
    ln, _ = _kernels()
    dx = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = ln(g.data_ptr(), x.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                 gamma.data_ptr(), dx.data_ptr(), rows, w, _DTYPES[x.dtype], _stream(x))
    if err != 0:
        raise RuntimeError(f"layer_norm_backward kernel launch failed: cudaError {err}")
    layer_norm_backward.launches += 1
    return dx


def _launch_quick_gelu(g, x):
    """Run the quick-GELU kernel; counts one launch on
    ``quick_gelu_backward.launches``."""
    _check("quick_gelu_backward", g, x)
    _, gelu = _kernels()
    dx = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = gelu(g.data_ptr(), x.data_ptr(), dx.data_ptr(), x.numel(), _DTYPES[x.dtype],
                   _stream(x))
    if err != 0:
        raise RuntimeError(f"quick_gelu_backward kernel launch failed: cudaError {err}")
    quick_gelu_backward.launches += 1
    return dx


@torch.library.custom_op("semantic_abstraction_tpu_torch::layer_norm_backward",
                         mutates_args=())
def layer_norm_backward(g: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
                        rstd: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """d(layer_norm)/dx applied to g -> x's shape and dtype (see the module
    doc)."""
    if x.device.type == "cpu":
        return layer_norm_backward_reference(g, x, mean, rstd, scale)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm_backward runs on cuda or cpu, got {x.device}")
    return _launch_layer_norm(g, x, mean, rstd, scale)


@torch.library.custom_op("semantic_abstraction_tpu_torch::quick_gelu_backward",
                         mutates_args=())
def quick_gelu_backward(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """d(quick_gelu)/dx applied to g -> x's shape and dtype (see the module
    doc)."""
    if x.device.type == "cpu":
        return quick_gelu_backward_reference(g, x)
    if x.device.type != "cuda":
        raise ValueError(f"quick_gelu_backward runs on cuda or cpu, got {x.device}")
    return _launch_quick_gelu(g, x)


layer_norm_backward.launches = 0  # kernel launches since the caller last set it to 0
quick_gelu_backward.launches = 0
