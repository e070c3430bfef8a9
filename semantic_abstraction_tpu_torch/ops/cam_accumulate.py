"""Chefer relevancy accumulation: the CUDA kernel and its plain PyTorch
version.

Counterpart of ``semantic_abstraction_tpu/ops/pallas_kernels.py``'s
``chefer_cam_accumulate`` (Pallas body ``_cam_accum_kernel``) and
``cam_accumulate_reference``. The kernel source is
``csrc/cam_accumulate.cu`` (design and bound noted there).
``cam_accumulate(grad, attn, r_mat, positive_attn_only)`` returns

    r_mat + mean_heads(relu?(grad * attn)) @ r_mat

for grad (L, B, H, T, T), attn (B, H, T, T) (not broadcast over the labels)
in f32 or bf16, and r_mat (L, B, T, T) f32, computed in f32:

- a CUDA tensor launches the kernel, or raises on what the kernel does not
  take (dtype, shape, a last axis of non-unit stride, more than
  ``MAX_TOKENS`` tokens). The kernel reads every input through its strides,
  so the gradcam's first R, an identity expanded with stride 0, goes in as
  it is; no input is copied.
- a CPU tensor takes the plain version ``cam_accumulate_reference``.

It has no backward: the gradcam runs it under ``torch.no_grad``, and the
JAX kernel has no ``custom_vjp`` either.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_TOKENS = 1024  # the kernel's shared-memory bound (cam_accumulate_max_tokens())


def cam_accumulate_reference(grad: torch.Tensor, attn: torch.Tensor,
                             r_mat: torch.Tensor,
                             positive_attn_only: bool = True) -> torch.Tensor:
    """Plain version in f32: the CPU path and the kernel's oracle."""
    cam = grad.float() * attn[None].float()
    if positive_attn_only:
        cam = cam.clamp_min(0.0)
    cam = cam.mean(dim=2)  # over heads -> (L, B, T, T)
    return r_mat + torch.matmul(cam, r_mat)


def _check(grad: torch.Tensor, attn: torch.Tensor, r_mat: torch.Tensor) -> None:
    if grad.dim() != 5 or grad.shape[-1] != grad.shape[-2]:
        raise ValueError(f"grad must be (L, B, H, T, T), got {tuple(grad.shape)}")
    l, b, h, t, _ = grad.shape
    if tuple(attn.shape) != (b, h, t, t):
        raise ValueError(f"attn must be (B, H, T, T) = {(b, h, t, t)}, got "
                         f"{tuple(attn.shape)}")
    if tuple(r_mat.shape) != (l, b, t, t):
        raise ValueError(f"r_mat must be (L, B, T, T) = {(l, b, t, t)}, got "
                         f"{tuple(r_mat.shape)}")
    if grad.dtype != attn.dtype or grad.dtype not in _DTYPES:
        raise TypeError(f"grad and attn take one of float32 or bfloat16, got "
                        f"{grad.dtype}, {attn.dtype}")
    if r_mat.dtype != torch.float32:
        raise TypeError(f"r_mat must be float32, got {r_mat.dtype}")
    if grad.numel() == 0:
        raise ValueError(f"cam_accumulate takes non-empty tensors, got {tuple(grad.shape)}")
    if t > MAX_TOKENS:
        raise ValueError(f"cam_accumulate takes at most {MAX_TOKENS} tokens, got {t}")
    for name, a in (("grad", grad), ("attn", attn), ("r_mat", r_mat)):
        if a.stride(-1) != 1:
            raise ValueError(f"cam_accumulate needs unit stride on the last axis of "
                             f"{name}, got strides {a.stride()}")


@functools.lru_cache(maxsize=None)
def _kernel():
    """The built library's launch function with its C signature."""
    lib = _build.load("cam_accumulate")
    lib.cam_accumulate_max_tokens.argtypes = []
    lib.cam_accumulate_max_tokens.restype = ctypes.c_int
    if lib.cam_accumulate_max_tokens() != MAX_TOKENS:
        raise RuntimeError("built cam_accumulate kernel disagrees on its token bound")
    fn = lib.cam_accumulate_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    return fn


def _launch(grad, attn, r_mat, positive_attn_only):
    """Run the CUDA kernel; counts one launch on ``cam_accumulate.launches``."""
    _check(grad, attn, r_mat)
    if not (grad.device == attn.device == r_mat.device):
        raise ValueError("grad, attn and r_mat must be on one device")
    l, b, h, t, _ = grad.shape
    fn = _kernel()
    out = torch.empty((l, b, t, t), dtype=torch.float32, device=grad.device)
    strides = (ctypes.c_longlong * 10)(*grad.stride()[:4], *attn.stride()[:3],
                                       *r_mat.stride()[:3])
    with torch.cuda.device(grad.device):
        stream = torch.cuda.current_stream(grad.device).cuda_stream
        err = fn(grad.data_ptr(), attn.data_ptr(), r_mat.data_ptr(), out.data_ptr(),
                 l, b, h, t, strides, int(bool(positive_attn_only)),
                 _DTYPES[grad.dtype], stream)
    if err != 0:
        raise RuntimeError(f"cam_accumulate kernel launch failed: cudaError {err}")
    cam_accumulate.launches += 1
    return out


def cam_accumulate(grad: torch.Tensor, attn: torch.Tensor, r_mat: torch.Tensor,
                   positive_attn_only: bool = True) -> torch.Tensor:
    """One Chefer relevancy step -> (L, B, T, T) f32 (see the module doc)."""
    if grad.device.type == "cpu":
        return cam_accumulate_reference(grad, attn, r_mat, positive_attn_only)
    if grad.device.type != "cuda":
        raise ValueError(f"cam_accumulate runs on cuda or cpu, got {grad.device}")
    return _launch(grad, attn, r_mat, positive_attn_only)


cam_accumulate.launches = 0  # kernel launches since the caller last set it to 0
