"""The port's channel_moments (its plain version, the CPU path) and the
GroupNorm built on it, against the JAX package on the CPU. The CUDA
kernel's own tests are in test_torch_channel_moments_card.py.

Tolerances: moments rtol=1e-5, atol=1e-4 (f32 sums of up to 4096 terms in
another order than XLA's, and against a float64 numpy sum); GroupNorm
values atol=rtol=1e-4 and gradients rtol=1e-3, atol=1e-5 (the same f32
math, sums in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_abstraction_tpu.models.unet3d import group_norm as jax_group_norm
from semantic_abstraction_tpu.ops.pallas_kernels import (
    channel_moments as jax_channel_moments,
)
from semantic_abstraction_tpu_torch.models.unet3d import group_norm
from semantic_abstraction_tpu_torch.ops import channel_moments as cm

MOMENTS = dict(rtol=1e-5, atol=1e-4)


def _x(seed, *shape):
    rs = np.random.RandomState(seed)
    return (rs.randn(*shape) * 2 + 0.5).astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 8, 4096), (3, 16, 256), (1, 24, 1024)])
def test_plain_version_matches_jax_kernel(shape):
    x = _x(1, *shape)
    want = jax_channel_moments(jnp.asarray(x), interpret=True)
    assert want is not None
    got = cm.channel_moments(torch.as_tensor(x))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == shape[:2]
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **MOMENTS)


@pytest.mark.parametrize("shape", [(2, 4, 64), (4, 512, 64), (1, 3, 100)])
def test_plain_version_at_shapes_jax_refuses(shape):
    """C % 8 != 0 or S below the Pallas chunk: the Pallas kernel returns
    None; the port takes any (B, C, S)."""
    x = _x(2, *shape)
    assert jax_channel_moments(jnp.asarray(x), interpret=True) is None
    s1, s2 = cm.channel_moments(torch.as_tensor(x))
    x64 = x.astype(np.float64)
    np.testing.assert_allclose(s1.numpy(), x64.sum(-1), **MOMENTS)
    np.testing.assert_allclose(s2.numpy(), (x64 * x64).sum(-1), **MOMENTS)


def test_plain_version_of_bf16_sums_in_f32():
    x = torch.as_tensor(_x(3, 2, 8, 512)).to(torch.bfloat16)
    s1, s2 = cm.channel_moments(x)
    assert s1.dtype == s2.dtype == torch.float32
    x64 = x.double()
    torch.testing.assert_close(s1.double(), x64.sum(-1), **MOMENTS)
    torch.testing.assert_close(s2.double(), x64.square().sum(-1), **MOMENTS)


def test_autograd_function_backward_matches_plain(monkeypatch):
    """The autograd.Function (the card's path) has the plain version's
    gradient. The launch is swapped for the plain version so that the
    Function runs on the CPU."""
    monkeypatch.setattr(cm, "_launch", cm.channel_moments_reference)
    x = torch.as_tensor(_x(4, 2, 6, 300))
    w1, w2 = torch.as_tensor(_x(5, 2, 6)), torch.as_tensor(_x(6, 2, 6))
    xa = x.clone().requires_grad_()
    s1, s2 = cm._ChannelMoments.apply(xa)
    (s1 * w1 + torch.sin(s2) * w2).sum().backward()
    xb = x.clone().requires_grad_()
    r1, r2 = cm.channel_moments_reference(xb)
    (r1 * w1 + torch.sin(r2) * w2).sum().backward()
    torch.testing.assert_close(xa.grad, xb.grad, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape,dtype,err", [
    ((2, 8), torch.float32, ValueError),            # not (B, C, S)
    ((2, 8, 64), torch.float16, TypeError),         # dtype
    ((2, 8, 0), torch.float32, ValueError),         # empty
])
def test_kernel_checks_reject_unsupported(shape, dtype, err):
    with pytest.raises(err):
        cm._check(torch.zeros(shape, dtype=dtype))


def test_kernel_checks_reject_a_channels_last_view():
    """What a channels-last conv output looks like through group_norm's
    view: the wrapper raises rather than copying."""
    x = torch.zeros(2, 16, 4, 4, 4).to(memory_format=torch.channels_last_3d)
    with pytest.raises(ValueError):
        cm._check(x.view(2, 16, -1))


@pytest.mark.parametrize("rows,s,elt", [
    (64, 128**3, 2), (64, 64**3, 4), (2048, 64, 2), (2048, 64, 4), (1, 5, 4),
    (8, 1000, 2), (3, 10**6 + 3, 4),
])
def test_plan_covers_each_row_once(rows, s, elt):
    chunk, splits, threads = cm.plan(rows, s, elt)
    assert chunk % 8 == 0 and threads % 32 == 0 and 32 <= threads <= 256
    assert (splits - 1) * chunk < s <= splits * chunk
    assert splits <= 65535
    if rows * s >= 2**20:  # a large tensor gives every SM blocks
        assert rows * splits >= cm.SMS


@pytest.mark.parametrize("c,num_groups", [(16, 8), (32, 8), (4, 8), (6, 2)])
def test_group_norm_values_and_grads_match_jax(c, num_groups):
    """Values and d/dx, d/dscale, d/dbias, including C < num_groups (one
    group)."""
    rs = np.random.RandomState(c)
    x = (rs.randn(2, c, 6, 5, 4) * 3 + 1).astype(np.float32)
    scale = rs.randn(c).astype(np.float32)
    bias = rs.randn(c).astype(np.float32)
    w = rs.randn(2, c, 6, 5, 4).astype(np.float32)

    def jloss(x_, s_, b_):
        return jnp.sum(jnp.sin(jax_group_norm(x_, s_, b_, num_groups)) * w)

    want = jax_group_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                          num_groups)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))

    xt, st, bt = (torch.as_tensor(a).requires_grad_() for a in (x, scale, bias))
    out = group_norm(xt, st, bt, num_groups)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)
    (torch.sin(out) * torch.as_tensor(w)).sum().backward()
    for got, jg in zip((xt.grad, st.grad, bt.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(jg), rtol=1e-3, atol=1e-5)
