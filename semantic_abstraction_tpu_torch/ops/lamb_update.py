"""Gradient clipping to a global norm and LAMB over every leaf of a model:
the CUDA multi-tensor update, its plain PyTorch version and the chunk
table.

Replaces no Pallas kernel: the JAX package leaves optax's clip and LAMB to
XLA's fusion. The kernel source is ``csrc/lamb_update.cu`` (design and
bound noted there). ``Leaves`` holds one step's tensors: each leaf's
parameter, gradient (None where the forward never read it: a zero
gradient, allocated by no one), and LAMB's two moments, with each param
group's range of leaves. Then

- ``global_grad_norm(leaves)`` is the norm of every gradient before
  clipping (optax ``global_norm``), a 0-dim float32 tensor;
- ``lamb_update_(leaves, group, ...)`` clips the group's gradients in
  place to that norm (``p.grad * max_norm / norm`` where ``norm >=
  max_norm``), updates the moments in place and steps the parameters.

Float32 CUDA leaves launch the kernels, one for the norm and two for each
group's update, whatever the number of leaves, and read nothing back; the
table reaches the card by one asynchronous copy from pinned memory. A
leaf of another dtype or layout raises. CPU leaves take the plain version,
the per-leaf arithmetic of ``grad_norm_reference`` and
``lamb_update_reference``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence, Tuple

import torch

from . import _build

THREADS = 256     # threads of a block, every kernel
LEAF_FIELDS = 6   # int64 words a leaf in the table: p, g or 0, m, v, numel, first chunk
CHUNK = 1 << 14   # elements a block: SemAbs3D's 121 leaves make 2,251 chunks


def chunk_table(numels: Sequence[int], chunk: int = CHUNK) -> Tuple[List[int], List[int]]:
    """(first chunk of each leaf, leaf of each chunk): each leaf cut into
    chunks of ``chunk`` elements, its last one shorter; a leaf of no
    elements has none."""
    first, leaf_of = [], []
    for i, n in enumerate(numels):
        first.append(len(leaf_of))
        leaf_of.extend([i] * -(-n // chunk))
    return first, leaf_of


@functools.lru_cache(maxsize=8)
def _table_shape(numels: Tuple[int, ...], chunk: int):
    """The table's words that follow from the leaves' sizes: (numel, first
    chunk) a leaf, and the tail (leaf of each chunk, the counter word 0)."""
    first, leaf_of = chunk_table(numels, chunk)
    return list(zip(numels, first)), leaf_of + [0]


def grad_norm_reference(grads: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient element (optax
    ``global_norm``); a leaf without a gradient adds nothing. The CPU path
    and the kernel's oracle."""
    sums = [g.float().square().sum() for g in grads if g is not None]
    return torch.stack(sums).sum().sqrt() if sums else torch.zeros(())


@torch.no_grad()
def lamb_update_reference(params, grads, exp_avgs, exp_avg_sqs, *, lr: float, betas,
                          eps: float, weight_decay: float, clamp_weight_norm: float,
                          norm: Optional[torch.Tensor] = None,
                          max_norm: Optional[float] = None) -> None:
    """The clip, then LAMB leaf by leaf (``models/lamb.py`` states the
    rules), in place: ``p.grad``, the moments and the parameters. A leaf
    whose gradient is None takes zeros. The CPU path and the kernel's
    oracle."""
    if norm is not None:
        scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
        for g in grads:
            if g is not None:
                g.mul_(scale)
    b1, b2 = betas
    for p, g, m, v in zip(params, grads, exp_avgs, exp_avg_sqs):
        if g is None:
            g = torch.zeros_like(p)
        mu = b1 * m + (1 - b1) * g
        nu = b2 * v + (1 - b2) * g * g
        m.copy_(mu)
        v.copy_(nu)
        adam_step = mu / (torch.sqrt(nu) + eps)
        if weight_decay != 0.0:
            adam_step = adam_step + weight_decay * p
        weight_norm = torch.linalg.vector_norm(p).clamp(0.0, clamp_weight_norm)
        adam_norm = torch.linalg.vector_norm(adam_step)
        trust = torch.where((weight_norm == 0.0) | (adam_norm == 0.0),
                            torch.ones_like(weight_norm),
                            weight_norm / adam_norm.clamp_min(1e-30))
        p.add_((-lr * trust) * adam_step)


def _check(params, grads, exp_avgs, exp_avg_sqs) -> torch.device:
    """The one CUDA device of every leaf; raises on what the kernels do not
    take: another dtype or device, a strided tensor, a mismatched shape."""
    dev = params[0].device
    for p, g, m, v in zip(params, grads, exp_avgs, exp_avg_sqs):
        for t in (p, m, v) if g is None else (p, g, m, v):
            if t.dtype != torch.float32 or t.device != dev or not t.is_contiguous():
                raise ValueError(f"lamb_update takes contiguous float32 leaves on {dev}, got "
                                 f"{t.dtype} strides {t.stride()} on {t.device}")
            if t.shape != p.shape:
                raise ValueError(f"lamb_update: a leaf's tensors differ in shape: "
                                 f"{tuple(t.shape)} and {tuple(p.shape)}")
    return dev


class Leaves:
    """One step's leaves, in the order of ``groups`` ((start, stop) of each
    param group). On the card it also holds the chunk table, uploaded
    here, and the kernels' scratch: per-chunk partial sums and the norm."""

    def __init__(self, params: List[torch.Tensor], grads: List[Optional[torch.Tensor]],
                 exp_avgs: List[torch.Tensor], exp_avg_sqs: List[torch.Tensor],
                 groups: List[Tuple[int, int]], chunk: int = CHUNK):
        self.params, self.grads = params, grads
        self.exp_avgs, self.exp_avg_sqs = exp_avgs, exp_avg_sqs
        self.groups, self.chunk = groups, chunk
        self.table = None
        if not params or params[0].device.type == "cpu":
            return
        if params[0].device.type != "cuda":
            raise ValueError(f"lamb_update runs on cuda or cpu, got {params[0].device}")
        dev = _check(params, grads, exp_avgs, exp_avg_sqs)
        if chunk < 4 or chunk % 4:
            raise ValueError(f"lamb_update's chunk must be a positive multiple of 4, got {chunk}")
        static, tail = _table_shape(tuple(p.numel() for p in params), chunk)
        words = []
        for p, g, m, v, (numel, first) in zip(params, grads, exp_avgs, exp_avg_sqs, static):
            words += (p.data_ptr(), 0 if g is None else g.data_ptr(), m.data_ptr(),
                      v.data_ptr(), numel, first)
        self.n_chunks = len(tail) - 1
        # pinned, so that the copy is asynchronous; PyTorch's host allocator
        # keeps the pinned block until the copy is done
        host = torch.tensor(words + tail, dtype=torch.int64).pin_memory()
        self.table = host.to(dev, non_blocking=True)
        self.group_chunks = [
            (static[a][1] if a < len(params) else self.n_chunks,
             static[b][1] if b < len(params) else self.n_chunks) for a, b in groups]
        # partial sums of g^2, p^2, u^2 a chunk
        self.partials = torch.empty(3 * self.n_chunks, dtype=torch.float32, device=dev)

    def holds(self, params, grads, exp_avgs, exp_avg_sqs) -> bool:
        """Whether these are this step's tensors, one for one."""
        return all(len(a) == len(b) and all(x is y for x, y in zip(a, b)) for a, b in (
            (self.params, params), (self.grads, grads), (self.exp_avgs, exp_avgs),
            (self.exp_avg_sqs, exp_avg_sqs)))


@functools.lru_cache(maxsize=None)
def _kernels():
    """The built library's (norm, update) launch functions with their C
    signatures."""
    lib = _build.load("lamb_update")
    for fn in (lib.lamb_update_threads, lib.lamb_update_leaf_fields):
        fn.argtypes, fn.restype = [], ctypes.c_int
    if (lib.lamb_update_threads(), lib.lamb_update_leaf_fields()) != (THREADS, LEAF_FIELDS):
        raise RuntimeError("built lamb_update kernel disagrees on its block size or table")
    norm = lib.lamb_grad_norm_launch
    norm.restype = ctypes.c_int
    norm.argtypes = [ctypes.c_void_p] + [ctypes.c_longlong] * 3 + [ctypes.c_void_p] * 3
    update = lib.lamb_update_launch
    update.restype = ctypes.c_int
    update.argtypes = ([ctypes.c_void_p] + [ctypes.c_longlong] * 5 + [ctypes.c_void_p]
                       + [ctypes.c_float] * 9 + [ctypes.c_void_p] * 2)
    return norm, update


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def global_grad_norm(leaves: Leaves) -> torch.Tensor:
    """The norm of every leaf's gradient, before clipping; one launch on
    the card, counted on ``global_grad_norm.launches``."""
    if leaves.table is None:
        return grad_norm_reference(leaves.grads)
    dev = leaves.table.device
    norm = torch.empty((), dtype=torch.float32, device=dev)
    launch, _ = _kernels()
    with torch.cuda.device(dev):
        err = launch(leaves.table.data_ptr(), len(leaves.params), leaves.n_chunks,
                     leaves.chunk, leaves.partials.data_ptr(), norm.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"lamb_update norm kernel launch failed: cudaError {err}")
    global_grad_norm.launches += 1
    return norm


def lamb_update_(leaves: Leaves, group: int, *, lr: float, betas, eps: float,
                 weight_decay: float, clamp_weight_norm: float,
                 norm: Optional[torch.Tensor] = None, max_norm: Optional[float] = None) -> None:
    """Clip group ``group``'s gradients to ``norm`` (when given; the norm of
    ``global_grad_norm`` over the same leaves) and take its LAMB step at
    ``lr``, in place; two launches on the card, counted on
    ``lamb_update_.launches``."""
    start, stop = leaves.groups[group]
    if leaves.table is None:
        lamb_update_reference(
            leaves.params[start:stop], leaves.grads[start:stop], leaves.exp_avgs[start:stop],
            leaves.exp_avg_sqs[start:stop], lr=lr, betas=betas, eps=eps,
            weight_decay=weight_decay, clamp_weight_norm=clamp_weight_norm, norm=norm,
            max_norm=max_norm)
        return
    lo, hi = leaves.group_chunks[group]
    if lo == hi:
        return
    if norm is not None and (norm.device != leaves.table.device or norm.dtype != torch.float32):
        raise ValueError(f"lamb_update takes a float32 norm on {leaves.table.device}, got "
                         f"{norm.dtype} on {norm.device}")
    _, launch = _kernels()
    b1, b2 = betas
    dev = leaves.table.device
    p = leaves.partials
    with torch.cuda.device(dev):
        err = launch(leaves.table.data_ptr(), len(leaves.params), leaves.n_chunks, lo, hi,
                     leaves.chunk, None if norm is None else norm.data_ptr(),
                     0.0 if max_norm is None else max_norm, -lr, b1, 1 - b1, b2, 1 - b2, eps,
                     weight_decay, clamp_weight_norm, p[leaves.n_chunks:].data_ptr(),
                     _stream(dev))
    if err != 0:
        raise RuntimeError(f"lamb_update kernel launch failed: cudaError {err}")
    lamb_update_.launches += 2


global_grad_norm.launches = 0  # kernel launches since the caller last set it to 0
lamb_update_.launches = 0  # likewise: two a param group's update
