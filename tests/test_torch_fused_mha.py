"""The port's fused_mha against the JAX package's, on the CPU (the plain
version). The CUDA kernel's own tests are in test_torch_fused_mha_card.py.

Tolerances: f32 atol=2e-4, rtol=1e-3 (sums in another order than XLA's,
as the JAX kernel tests allow)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_abstraction_tpu.ops.pallas_kernels import (
    fused_mha as jax_fused_mha,
    mha_reference as jax_mha_reference,
)
from semantic_abstraction_tpu_torch.ops import fused_mha as fm

F32 = dict(atol=2e-4, rtol=1e-3)


def _qkv(seed, b, t, w):
    rs = np.random.RandomState(seed)
    return [rs.randn(b, t, w).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("b,t,w,heads", [
    (4, 50, 768, 12),   # ViT-B/32 tile shape, small batch
    (90, 10, 256, 4),   # the JAX kernel's padded-batch case
    (3, 17, 128, 2),
])
def test_plain_version_matches_jax(b, t, w, heads):
    q, k, v = _qkv(b * t, b, t, w)
    out_t = fm.fused_mha(*(torch.as_tensor(a) for a in (q, k, v)), heads)
    out_kernel = jax_fused_mha(*(jnp.asarray(a) for a in (q, k, v)), heads, True)
    out_ref = jax_mha_reference(*(jnp.asarray(a) for a in (q, k, v)), heads)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_kernel), **F32)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_ref), **F32)


def test_strided_views_match_contiguous():
    """q, k, v as views of one (B, T, 3W) qkv (the main path's layout)."""
    qkv = torch.as_tensor(np.random.RandomState(1).randn(5, 50, 3 * 128)
                          .astype(np.float32))
    views = qkv.split(128, dim=-1)
    out_v = fm.fused_mha(*views, 2)
    out_c = fm.fused_mha(*(a.contiguous() for a in views), 2)
    torch.testing.assert_close(out_v, out_c, atol=0, rtol=0)


def test_autograd_function_backward_matches_jax_vjp(monkeypatch):
    """The autograd.Function (the card's path) differentiates the plain
    version, as the JAX custom_vjp does. The launch is swapped for the
    plain version so that the Function runs on the CPU."""
    monkeypatch.setattr(fm, "_launch",
                        lambda q, k, v, h: fm.mha_reference(q, k, v, h))
    b, t, w, heads = 2, 16, 128, 2
    q, k, v = _qkv(6, b, t, w)
    qt, kt, vt = (torch.as_tensor(a).requires_grad_() for a in (q, k, v))
    torch.sin(fm._FusedMHA.apply(qt, kt, vt, heads)).sum().backward()

    def loss(q_, k_, v_):
        return jnp.sum(jnp.sin(jax_fused_mha(q_, k_, v_, heads, True)))

    grads = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    for got, want in zip((qt.grad, kt.grad, vt.grad), grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-3)


@pytest.mark.parametrize("shape,heads,dtype,err", [
    ((2, 50, 768), 4, torch.float32, ValueError),    # head_dim 192
    ((2, 50, 768), 7, torch.float32, ValueError),    # W % heads != 0
    ((2, 50, 768), 12, torch.float16, TypeError),    # dtype
    ((1, 2049, 128), 2, torch.float32, ValueError),  # above the token bound
])
def test_kernel_checks_reject_unsupported(shape, heads, dtype, err):
    a = torch.zeros(shape, dtype=dtype)
    with pytest.raises(err):
        fm._check(a, a, a, heads)


def test_kernel_checks_reject_strided_last_axis():
    a = torch.zeros(2, 50, 1536)[..., ::2]
    with pytest.raises(ValueError):
        fm._check(a, a, a, 12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["row stride", "start"])
def test_kernel_checks_reject_rows_off_16_bytes(dtype, kind):
    """Both bodies copy q, k and v rows 16 bytes at a time: a row stride or
    a start that is not a multiple of 16 bytes raises, in f32 as in bf16."""
    a = (torch.zeros(2, 50, 770, dtype=dtype)[..., :768] if kind == "row stride"
         else torch.zeros(2, 50, 776, dtype=dtype)[..., 2:770])
    with pytest.raises(ValueError, match="16-byte aligned"):
        fm._check(a, a, a, 12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_checks_take_the_paths_qkv_views(dtype):
    """q, k, v as views of one (B, T, 3W) projection, as the ViT blocks
    pass them, are aligned in both dtypes."""
    q, k, v = torch.zeros(4, 50, 3 * 768, dtype=dtype).split(768, dim=-1)
    fm._check(q, k, v, 12)
