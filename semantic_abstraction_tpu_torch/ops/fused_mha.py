"""Fused multi-head self-attention: the CUDA kernel, its plain PyTorch
version and the autograd wrapper.

Counterpart of ``semantic_abstraction_tpu/ops/pallas_kernels.py``'s
``fused_mha`` (Pallas body ``_fused_mha_kernel``). The kernel source is
``csrc/fused_mha.cu`` (design and bound noted there): one tensor-core body
for each dtype, bf16 products in bf16 and f32 products as three TF32
products each, both walking K and V in 64-key tiles through 16-byte async
copies. ``fused_mha`` takes (B, T, W) q, k, v, q unscaled, and returns
(B, T, W):

- a CUDA tensor launches the kernel, or raises on what the kernel does not
  take (head dim, more than ``MAX_TOKENS`` tokens, dtype, layout: rows that
  are not 16-byte aligned, in either dtype);
- a CPU tensor takes the plain version ``mha_reference``.

The backward pass differentiates the plain version, as the JAX
``custom_vjp`` does: no relevancy path differentiates through this
attention, but ``encode_image`` stays differentiable.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIM = 64  # the kernel's compiled head dim (fused_mha_head_dim())
MAX_TOKENS = 2048  # the kernel's token bound (fused_mha_max_tokens())


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  num_heads: int) -> torch.Tensor:
    """Plain MHA on (B, T, W) inputs: the CPU path and the kernel's oracle.

    q is UNSCALED; it is scaled by head_dim**-0.5 in the input dtype, the
    logits and softmax are f32, the probs are cast back to the input dtype
    before the value product (JAX ``mha_reference``).
    """
    b, t, w = q.shape
    hd = w // num_heads

    def to_heads(a):
        return a.reshape(b, t, num_heads, hd).transpose(1, 2)

    qh, kh, vh = to_heads(q) * (hd**-0.5), to_heads(k), to_heads(v)
    logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.matmul(probs, vh)
    return out.transpose(1, 2).reshape(b, t, w)


def _check(q, k, v, num_heads):
    if not (q.shape == k.shape == v.shape) or q.dim() != 3:
        raise ValueError(f"q, k, v must share one (B, T, W) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"fused_mha takes float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    b, t, w = q.shape
    if w % num_heads or w // num_heads != HEAD_DIM:
        raise ValueError(f"fused_mha takes head_dim {HEAD_DIM}, got "
                         f"width {w} / {num_heads} heads")
    if t > MAX_TOKENS:
        raise ValueError(f"fused_mha takes at most {MAX_TOKENS} tokens, got {t}")
    for a in (q, k, v):
        if a.stride(-1) != 1:
            raise ValueError("fused_mha needs unit stride on the last axis")
        # rows go through 16-byte async copies
        per16 = 16 // a.element_size()
        if a.data_ptr() % 16 or a.stride(0) % per16 or a.stride(1) % per16:
            raise ValueError(f"fused_mha needs 16-byte aligned rows, got {a.dtype} "
                             f"strides {a.stride()} at address {a.data_ptr():#x}")


@functools.lru_cache(maxsize=None)
def _kernel():
    """The built library's launch function with its C signature, built at
    first use."""
    lib = _build.load("fused_mha")
    for query, want in ((lib.fused_mha_head_dim, HEAD_DIM),
                        (lib.fused_mha_max_tokens, MAX_TOKENS)):
        query.argtypes, query.restype = [], ctypes.c_int
        if query() != want:
            raise RuntimeError(f"built fused_mha kernel disagrees: {query.__name__}")
    fn = lib.fused_mha_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 6 + [ctypes.c_int, ctypes.c_void_p])
    return fn


def _launch(q, k, v, num_heads):
    """Run the CUDA kernel; counts one launch on ``fused_mha.launches``."""
    _check(q, k, v, num_heads)
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    b, t, w = q.shape
    fn = _kernel()
    out = torch.empty((b, t, w), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, t, w, num_heads,
                 q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                 v.stride(0), v.stride(1), _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"fused_mha kernel launch failed: cudaError {err}")
    fused_mha.launches += 1
    return out


class _FusedMHA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, num_heads):
        ctx.save_for_backward(q, k, v)
        ctx.num_heads = num_heads
        return _launch(q, k, v, num_heads)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            q_, k_, v_ = (a.detach().requires_grad_() for a in (q, k, v))
            out = mha_reference(q_, k_, v_, ctx.num_heads)
            dq, dk, dv = torch.autograd.grad(out, (q_, k_, v_), g)
        return dq, dk, dv, None


def fused_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              num_heads: int) -> torch.Tensor:
    """Fused MHA on (B, T, W) q/k/v (q unscaled) -> (B, T, W)."""
    if q.device.type == "cpu":
        return mha_reference(q, k, v, num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"fused_mha runs on cuda or cpu, got {q.device}")
    return _FusedMHA.apply(q, k, v, num_heads)


fused_mha.launches = 0  # kernel launches since the caller last set it to 0
