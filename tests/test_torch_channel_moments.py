"""The port's channel_moments (its plain version, the CPU path), its
backward's plain version and the GroupNorm built on them, against the JAX
package on the CPU; and the host side of the two CUDA kernels: the launch
plan at the UNet's shapes and the kernels' walk over a row, modelled here.
The CUDA kernels' own tests are in test_torch_channel_moments_card.py.

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
    gradient. Both launches are swapped for their plain versions so that
    the Function runs on the CPU; the backward goes through its own launch
    once, with the (B, C) f32 gradients of the two sums."""
    calls = []

    def backward_reference(x, g1, g2):
        calls.append((g1.shape, g1.dtype, g1.is_contiguous(), g2.shape, g2.dtype))
        return cm.channel_moments_backward_reference(x, g1, g2)

    monkeypatch.setattr(cm, "_launch", cm.channel_moments_reference)
    monkeypatch.setattr(cm, "_launch_backward", backward_reference)
    for dtype in (torch.float32, torch.bfloat16):
        calls.clear()
        x = torch.as_tensor(_x(4, 2, 6, 300)).to(dtype)
        w1, w2 = torch.as_tensor(_x(5, 2, 6)), torch.as_tensor(_x(6, 2, 6))
        xa = x.clone().requires_grad_()
        s1, s2 = cm._ChannelMoments.apply(xa)
        (s1 * w1 + torch.sin(s2) * w2).sum().backward()
        xb = x.clone().requires_grad_()
        r1, r2 = cm.channel_moments_reference(xb)
        (r1 * w1 + torch.sin(r2) * w2).sum().backward()
        assert xa.grad.dtype == dtype
        torch.testing.assert_close(xa.grad, xb.grad, rtol=1e-6, atol=1e-6)
        assert calls == [((2, 6), torch.float32, True, (2, 6), torch.float32)]


def test_backward_reference_matches_jax_vjp_of_the_two_sums():
    """``channel_moments_backward_reference`` against ``jax.vjp`` of the
    JAX UNet's two f32 sums (``models/unet3d.py:75-76`` without the / n),
    at f32. Tolerance rtol 1e-6, atol 1e-6: the same three f32 operations,
    which XLA may contract into a multiply-add one rounding apart. (At bf16
    JAX rounds each sum's cotangent to bf16 before it adds them; the port,
    as the reference's PyTorch autograd, rounds once.)"""
    x = _x(7, 2, 8, 1000)
    g1, g2 = _x(8, 2, 8), _x(9, 2, 8)

    def sums(v):
        return (v.astype(jnp.float32).sum(axis=2),
                jnp.square(v.astype(jnp.float32)).sum(axis=2))

    _, vjp = jax.vjp(sums, jnp.asarray(x))
    (want,) = vjp((jnp.asarray(g1), jnp.asarray(g2)))
    got = cm.channel_moments_backward_reference(
        torch.as_tensor(x), torch.as_tensor(g1), torch.as_tensor(g2))
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_backward_wrapper_takes_the_plain_version_on_the_cpu():
    x = torch.as_tensor(_x(10, 3, 4, 64)).bfloat16()
    g1, g2 = torch.as_tensor(_x(11, 3, 4)), torch.as_tensor(_x(12, 3, 4))
    before = cm.channel_moments_backward.launches
    got = cm.channel_moments_backward(x, g1, g2)
    assert torch.equal(got, cm.channel_moments_backward_reference(x, g1, g2))
    assert cm.channel_moments_backward.launches == before


@pytest.mark.parametrize("shape,dtype,err", [
    ((2, 8), torch.float32, ValueError),            # not (B, C, S)
    ((2, 8, 64), torch.float16, TypeError),         # dtype
    ((2, 8, 0), torch.float32, ValueError),         # empty
])
def test_kernel_checks_reject_unsupported(shape, dtype, err):
    with pytest.raises(err):
        cm._check(torch.zeros(shape, dtype=dtype))


@pytest.mark.parametrize("make", [
    lambda: torch.zeros(3, 2),                       # (C, B): another shape
    lambda: torch.zeros(2, 3, dtype=torch.float64),  # dtype
    lambda: torch.zeros(3, 2).t(),                   # a transposed view
])
def test_backward_checks_reject_unsupported_grads(make):
    """The backward kernel reads g1 and g2 as (B, C) float32 runs."""
    x = torch.zeros(2, 3, 8)
    with pytest.raises(ValueError):
        cm._check_grads(x, make(), torch.zeros(2, 3))
    with pytest.raises(ValueError):
        cm._check_grads(x, torch.zeros(2, 3), make())
    cm._check_grads(x, torch.zeros(2, 3), torch.zeros(2, 3))


def test_kernel_checks_reject_a_channels_last_view():
    """What a channels-last conv output looks like through group_norm's
    view: the wrapper raises rather than copying."""
    x = torch.zeros(2, 16, 4, 4, 4).to(memory_format=torch.channels_last_3d)
    with pytest.raises(ValueError):
        cm._check(x.view(2, 16, -1))


# (C, S) of every GroupNorm of the full-size UNet (f_maps 16, 6 levels,
# 128^3 voxels); OVSSC runs them at B = 4 volumes, VOOL at B = 8
UNET_SHAPES = [(16, 128**3), (16, 64**3), (32, 64**3), (32, 32**3), (64, 32**3),
               (64, 16**3), (128, 16**3), (128, 8**3), (256, 8**3), (256, 4**3),
               (512, 4**3)]
PATH_SHAPES = [(b * c, s) for b in (4, 8) for c, s in UNET_SHAPES]
SMS = 132  # H100 SXM streaming multiprocessors


def _blocks(p, rows):
    """The launch's blocks, as the kernel sizes its grid from the plan."""
    return -(-rows // (cm.THREADS // p.group)) if p.group else rows * p.splits


def _segments(p, rows, s):
    """The (row, start, length) row segments of a plan, one a group (short
    rows) or a block (longer rows)."""
    if p.group:
        return [(r, 0, s) for r in range(rows)]
    return [(r, k * p.chunk, min(p.chunk, s - k * p.chunk))
            for r in range(rows) for k in range(p.splits)]


def _walk(offset, n, lane, lanes, elt):
    """The elements of a row segment of n elements, starting ``offset``
    bytes past a 16-byte boundary, that one of its ``lanes`` lanes visits,
    as the kernel walks it: a scalar head to the first 16-byte boundary,
    16-byte vectors strided by the lanes, a scalar tail."""
    v = 16 // elt
    head = min(n, ((16 - offset % 16) % 16) // elt)
    nv = (n - head) // v
    out = list(range(lane, head, lanes))
    for i in range(lane, nv, lanes):
        out += range(head + i * v, head + (i + 1) * v)
    return out + list(range(head + nv * v + lane, n, lanes))


@pytest.mark.parametrize("rows,s,elt", [
    (64, 128**3, 2), (64, 64**3, 4), (2048, 64, 2), (2048, 64, 4), (1, 5, 4),
    (8, 1000, 2), (3, 10**6 + 3, 4),
])
def test_plan_covers_each_row_once(rows, s, elt):
    p = cm.plan(rows, s, elt)
    vec = 16 // elt
    if p.group:  # lane groups: one a row, each lane at most GROUP_VECS vectors
        assert p.splits == 1 and p.chunk == s
        assert p.group & (p.group - 1) == 0 and 1 <= p.group <= cm.MAX_GROUP
        assert p.group * cm.GROUP_VECS * vec >= s
        per = cm.THREADS // p.group
        assert (_blocks(p, rows) - 1) * per < rows <= _blocks(p, rows) * per
    else:  # blocks: 1..MAX_SPLITS chunks tile each row, a multiple of 8 each
        assert p.chunk % 8 == 0 and 1 <= p.splits <= cm.MAX_SPLITS
        assert (p.splits - 1) * p.chunk < s <= p.splits * p.chunk
        assert p.splits == 1 or s >= p.splits * cm.THREADS * vec * cm.MIN_VECS // 2
    if rows * s >= 2**20:  # a large tensor gives every SM a block, where
        # its rows allow (a cluster holds at most MAX_SPLITS blocks of a row)
        assert _blocks(p, rows) >= min(SMS, rows * cm.MAX_SPLITS)
    segs = _segments(p, rows, s)
    assert sum(n for _, _, n in segs) == rows * s
    for r in (0, rows - 1):
        assert [(a, n) for rr, a, n in segs if rr == r] == [
            (a, n) for a, n in zip(range(0, s, p.chunk), [p.chunk] * (s // p.chunk) +
                                   [s % p.chunk] * (s % p.chunk > 0))]


@pytest.mark.parametrize("elt", [2, 4])
@pytest.mark.parametrize("rows,s", PATH_SHAPES)
def test_plan_picks_each_regime_at_the_path_shapes(rows, s, elt):
    """Lane groups at S = 4^3 and 8^3 (8 lanes for 64 bf16, 16 for 64 f32,
    a warp for 512), one block a row at 16^3 and 32^3, and from 64^3 on a
    cluster of blocks a row, about TARGET_BLOCKS blocks in all (4 a row for
    the 64 rows of level 0 at B = 4, 2 at B = 8) but never fewer than one
    a row."""
    p = cm.plan(rows, s, elt)
    if s <= 8**3:
        assert p.group == min(32, s * elt // 16) and _blocks(p, rows) == rows * p.group // 256
    elif s <= 32**3:
        assert p == (0, 1, s) and _blocks(p, rows) == rows
    else:
        assert p.group == 0
        assert _blocks(p, rows) == max(rows, min(cm.TARGET_BLOCKS, rows * cm.MAX_SPLITS))
    assert rows * s == sum(n for _, _, n in _segments(p, rows, s))


@pytest.mark.parametrize("elt", [2, 4])
@pytest.mark.parametrize("rows,s", [(1, 1), (6, 5), (21, 1001), (5, 70001), (3, 130),
                                    (4, 64), (2, 4096)])
def test_kernel_walk_visits_each_element_once(rows, s, elt):
    """The kernel's walk of every segment of the plan (``_walk``, for each
    lane of its group or block), rows laid end to end from a 16-byte
    boundary as in a contiguous tensor: every element once."""
    p = cm.plan(rows, s, elt)
    lanes = p.group or cm.THREADS
    seen = np.zeros(rows * s, np.int64)
    for r, a, n in _segments(p, rows, s):
        base = r * s + a
        for lane in range(lanes):
            np.add.at(seen, base + np.asarray(_walk(base * elt, n, lane, lanes, elt),
                                              np.int64), 1)
    assert (seen == 1).all()


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
