"""The arithmetic of the tensor-core kernels, modelled in plain torch on the
CPU and held against the JAX package's references.

``csrc/fused_mha.cu`` (bf16 and f32) and ``csrc/cam_accumulate.cu`` run on
the card only. What they compute differs from their plain versions in the
order and the precision of the sums, and that is what these models repeat,
step by step, so that the designs' numerics are pinned here:

- fused_mha, bf16: 64-key tiles; raw logits in f32 from bf16 products; keys past
  T set to -inf; pass one takes the row max and an online-rescaled sum of
  exp(c s - c max) = 2^(c' s - c' max) (c = hd^-0.5, c' = c log2 e); pass
  two forms the normalised
  probabilities, rounds them to bf16 and accumulates P V in f32 tile by
  tile; the output is rounded to bf16 once. Tolerance: the card test's bf16
  atol 2e-2, rtol 1e-2.
- fused_mha, f32: one walk over 32-key tiles; S = q k^T and O += P V each
  as three TF32 products (below; the small parts cut to TF32, not rounded);
  keys past T set to -inf; the running row
  max and sum, with the sum and O rescaled by 2^(c' (m_old - m_new)) when
  the max grows; O times 1/sum once at the end. Tolerance: the card test's
  f32 atol and rtol 1e-4. One TF32 product, or a walk that does not
  rescale, does not hold it.
- cam_accumulate: the product cam @ R as three TF32 products (each f32
  operand split into big = tf32(x), small = tf32(x - big); small*big +
  big*small + big*big). Products of TF32 values are exact in f32, so an f32
  matmul of the parts is the tensor cores' arithmetic up to the order of
  the sums. Tolerance: 1e-5 of |R| + |cam| @ |R|, the card test's. One TF32
  product alone does not hold it, which is why the kernel takes three.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_abstraction_tpu.ops.pallas_kernels import (
    cam_accumulate_reference as jax_cam_reference,
    mha_reference as jax_mha_reference,
)

KEYS = 64  # keys of one K/V tile of fused_mha.cu's bf16 body
KEYS_F32 = 32  # keys of one K/V tile of its f32 body
BF16 = dict(atol=2e-2, rtol=1e-2)


def tile_walk_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  heads: int) -> torch.Tensor:
    """fused_mha.cu's bf16 arithmetic on (B, T, W) bf16 q, k, v."""
    b, t, w = q.shape
    hd = w // heads

    def to_heads(a):
        return a.reshape(b, t, heads, hd).transpose(1, 2).float()

    qh, kh, vh = to_heads(q), to_heads(k), to_heads(v)
    ntiles = -(-t // KEYS)
    pad = ntiles * KEYS - t
    kh = torch.nn.functional.pad(kh, (0, 0, 0, pad))  # zero-filled rows past T
    vh = torch.nn.functional.pad(vh, (0, 0, 0, pad))
    c = torch.tensor(math.log2(math.e), dtype=torch.float32) / math.sqrt(hd)
    live = torch.arange(ntiles * KEYS) < t

    def logits(j):
        sl = slice(j * KEYS, (j + 1) * KEYS)
        s = torch.matmul(qh, kh[:, :, sl].transpose(-1, -2))
        return s.masked_fill(~live[sl], -math.inf)

    m = torch.full((b, heads, t), -math.inf)
    total = torch.zeros((b, heads, t))
    for j in range(ntiles):
        s = logits(j)
        m_new = torch.maximum(m, s.amax(-1))
        total = (total * torch.exp2((m - m_new) * c)
                 + torch.exp2(s * c - (m_new * c)[..., None]).sum(-1))
        m = m_new
    inv = 1.0 / total
    out = torch.zeros((b, heads, t, hd))
    for j in range(ntiles):
        p = (torch.exp2(logits(j) * c - (m * c)[..., None]) * inv[..., None]).to(torch.bfloat16)
        out = out + torch.matmul(p.float(), vh[:, :, j * KEYS:(j + 1) * KEYS])
    return out.to(torch.bfloat16).transpose(1, 2).reshape(b, t, w)


@pytest.mark.parametrize("t", [1, 17, 50, 65, 257, 577])
def test_fused_mha_tile_walk_matches_jax_reference(t):
    b, w, heads = 2, 128, 2
    rs = np.random.RandomState(t)
    q, k, v = (rs.randn(b, t, w).astype(np.float32) for _ in range(3))
    got = tile_walk_mha(*(torch.as_tensor(a).to(torch.bfloat16) for a in (q, k, v)), heads)
    want = jax_mha_reference(*(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)), heads)
    torch.testing.assert_close(got.float(), torch.as_tensor(np.asarray(want, np.float32)),
                               **BF16)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 mantissa bits), to nearest with ties away from
    zero, as ``cvt.rna.tf32.f32``: add half of the dropped 13 bits' unit to
    the magnitude's bits and clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor):
    big = tf32(x)
    return big, tf32(x - big)


def split_tf32_cut(x: torch.Tensor):
    """fused_mha.cu's f32 split: big = tf32(x) as above, and small = x - big
    cut to TF32 (the low 13 bits cleared: the tensor core reads only the
    top 19 bits of a .tf32 operand)."""
    big = tf32(x)
    small = ((x - big).contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)
    return big, small


def tf32_product(a: torch.Tensor, b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """a @ b as fused_mha.cu takes it in f32: small(a) big(b) + big(a)
    small(b) + big(a) big(b), or the one big(a) big(b) with passes=1."""
    (ab, asm), (bb, bsm) = split_tf32_cut(a), split_tf32_cut(b)
    prod = torch.matmul(ab, bb)
    if passes == 3:
        prod = torch.matmul(asm, bb) + torch.matmul(ab, bsm) + prod
    return prod


def tile_walk_mha_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                      passes: int = 3, rescale: bool = True) -> torch.Tensor:
    """fused_mha.cu's f32 arithmetic on (B, T, W) f32 q, k, v; with
    rescale=False the walk never rescales the running sum and O."""
    b, t, w = q.shape
    hd = w // heads

    def to_heads(a):
        return a.reshape(b, t, heads, hd).transpose(1, 2)

    qh, kh, vh = to_heads(q), to_heads(k), to_heads(v)
    ntiles = -(-t // KEYS_F32)
    pad = ntiles * KEYS_F32 - t
    kh = torch.nn.functional.pad(kh, (0, 0, 0, pad))  # zero-filled rows past T
    vh = torch.nn.functional.pad(vh, (0, 0, 0, pad))
    c = torch.tensor(math.log2(math.e), dtype=torch.float32) / math.sqrt(hd)
    live = torch.arange(ntiles * KEYS_F32) < t
    m = torch.full((b, heads, t), -math.inf)
    total = torch.zeros((b, heads, t))
    out = torch.zeros((b, heads, t, hd))
    for j in range(ntiles):
        sl = slice(j * KEYS_F32, (j + 1) * KEYS_F32)
        s = tf32_product(qh, kh[:, :, sl].transpose(-1, -2), passes)
        s = s.masked_fill(~live[sl], -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2((m - m_new) * c) if rescale else torch.ones_like(m)
        p = torch.exp2(s * c - (m_new * c)[..., None])
        total = total * alpha + p.sum(-1)
        out = out * alpha[..., None] + tf32_product(p, vh[:, :, sl], passes)
        m = m_new
    out = out * (1.0 / total)[..., None]
    return out.transpose(1, 2).reshape(b, t, w)


F32 = dict(atol=1e-4, rtol=1e-4)
# the token counts of RAGGED_SHAPES in tests/test_torch_fused_mha_card.py
# (every edge of the query and key tiles up to the 2048-token bound), at
# B = 1 and a narrow width; and the relevancy paths' shapes (ViT-B/32 at
# T = 50, ViT-L/14 at T = 257 and 577) cut to small B
RAGGED_TOKENS = (1, 16, 17, 50, 63, 64, 65, 197, 256, 257, 577, 2048)
F32_PATH_SHAPES = [(2, 50, 768), (2, 257, 1024), (1, 577, 1024)]


def f32_case(b, t, w):
    rs = np.random.RandomState(1000 + t)
    q, k, v = (rs.randn(b, t, w).astype(np.float32) for _ in range(3))
    want = np.asarray(jax_mha_reference(*(jnp.asarray(a) for a in (q, k, v)), w // 64))
    return [torch.as_tensor(a) for a in (q, k, v)], torch.as_tensor(np.array(want))


@pytest.mark.parametrize("b,t,w", [(1, t, 128) for t in RAGGED_TOKENS] + F32_PATH_SHAPES)
def test_fused_mha_f32_tile_walk_matches_jax_reference(b, t, w):
    (q, k, v), want = f32_case(b, t, w)
    torch.testing.assert_close(tile_walk_mha_f32(q, k, v, w // 64), want, **F32)


@pytest.mark.parametrize("b,t,w", [(1, 50, 128)] + F32_PATH_SHAPES)
def test_one_tf32_product_breaks_the_f32_mha_tolerance(b, t, w):
    """Why the f32 body takes three products: big*big alone misses 1e-4."""
    (q, k, v), want = f32_case(b, t, w)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(tile_walk_mha_f32(q, k, v, w // 64, passes=1), want, **F32)


@pytest.mark.parametrize("b,t,w", [(1, 257, 128), (1, 2048, 128)] + F32_PATH_SHAPES[1:])
def test_a_walk_without_the_rescale_breaks_the_f32_mha_tolerance(b, t, w):
    """Past one key tile the running max grows, and the sum and O must
    follow it."""
    (q, k, v), want = f32_case(b, t, w)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(tile_walk_mha_f32(q, k, v, w // 64, rescale=False), want,
                                   **F32)


def cam_of(grad, attn, positive):
    cam = grad.float() * attn[None].float()
    if positive:
        cam = cam.clamp_min(0.0)
    return cam.mean(dim=2)


def three_tf32_step(grad, attn, r, positive=True, passes=3):
    """cam_accumulate.cu's product: R + (small*big + big*small + big*big),
    or the one big*big product with passes=1."""
    (ab, asm), (bb, bsm) = split_tf32(cam_of(grad, attn, positive)), split_tf32(r)
    prod = torch.matmul(ab, bb)
    if passes == 3:
        prod = torch.matmul(asm, bb) + torch.matmul(ab, bsm) + prod
    return r + prod


def cam_inputs(seed, l, b, h, t):
    rs = np.random.RandomState(seed)
    grad = (0.05 * rs.randn(l, b, h, t, t)).astype(np.float32)
    logits = 4 * rs.randn(b, h, t, t)
    attn = np.exp(logits - logits.max(-1, keepdims=True))
    attn = (attn / attn.sum(-1, keepdims=True)).astype(np.float32)
    r = (np.eye(t) + 0.1 * rs.rand(l, b, t, t)).astype(np.float32)
    return grad, attn, r


def rel_err(got, grad, attn, r, positive=True):
    """Largest |got - JAX reference| over |R| + |cam| @ |R|."""
    want = torch.as_tensor(np.array(jax_cam_reference(
        jnp.asarray(grad.numpy()), jnp.asarray(attn.numpy())[None], jnp.asarray(r.numpy()),
        positive)))
    scale = r.abs() + torch.matmul(
        (grad.float() * attn[None].float()).abs().mean(dim=2), r.abs())
    return ((got - want).abs() / scale).max().item()


@pytest.mark.parametrize("x,want", [
    (1.0, 1.0),
    (1.0 + 2.0**-11, 1.0 + 2.0**-10),          # a tie rounds away from zero
    (-(1.0 + 2.0**-11), -(1.0 + 2.0**-10)),
    (1.0 + 2.0**-12, 1.0),                     # below the tie
    (1.0 + 3 * 2.0**-12, 1.0 + 2.0**-10),      # above it
    (3.0e-5, None),                            # small values keep 11 significant bits
])
def test_tf32_rounding(x, want):
    got = tf32(torch.tensor([x], dtype=torch.float32)).item()
    if want is not None:
        assert got == want
    mant = np.frexp(np.float32(got))[0] * 2.0**11
    assert mant == np.round(mant) and abs(got - x) <= 2.0**-11 * abs(x)


def test_split_tf32_is_exact_to_22_bits():
    x = torch.as_tensor(np.random.RandomState(0).randn(4096).astype(np.float32))
    big, small = split_tf32(x)
    assert torch.equal(tf32(big), big) and torch.equal(tf32(small), small)
    assert ((big + small - x).abs() <= 2.0**-21 * x.abs()).all()


def test_cut_split_tf32_is_exact_to_21_bits():
    """fused_mha's split: a small part cut, not rounded, to TF32 loses at
    most one more bit."""
    x = torch.as_tensor(np.random.RandomState(1).randn(4096).astype(np.float32))
    big, small = split_tf32_cut(x)
    assert torch.equal(tf32(big), big) and torch.equal(tf32(small), small)
    assert ((big + small - x).abs() <= 2.0**-20 * x.abs()).all()


@pytest.mark.parametrize("positive", [True, False])
@pytest.mark.parametrize("t", [50, 257])
def test_three_tf32_products_hold_the_tolerance(t, positive):
    grad, attn, r = (torch.as_tensor(a) for a in cam_inputs(t, 2, 1, 2, t))
    assert rel_err(three_tf32_step(grad, attn, r, positive), grad, attn, r, positive) <= 1e-5


@pytest.mark.parametrize("t", [50, 257])
def test_three_tf32_products_hold_over_thirteen_chained_steps(t):
    """The gradcam's 13 tail blocks at ViT-L/14: each step from the model's
    own R holds 1e-5 against JAX, and the chains end within 1e-5."""
    l, b, h = 2, 1, 2
    r_model = r_ref = torch.eye(t).expand(l, b, t, t)
    for step in range(13):
        grad, attn, _ = (torch.as_tensor(a) for a in cam_inputs(100 + step, l, b, h, t))
        nxt = three_tf32_step(grad, attn, r_model)
        assert rel_err(nxt, grad, attn, r_model) <= 1e-5, step
        r_model = nxt
        r_ref = torch.as_tensor(np.array(jax_cam_reference(
            jnp.asarray(grad.numpy()), jnp.asarray(attn.numpy())[None],
            jnp.asarray(r_ref.numpy()))))
    torch.testing.assert_close(r_model, r_ref, rtol=1e-5, atol=1e-5)


def test_one_tf32_product_breaks_the_tolerance():
    """Why the kernel takes three products: big*big alone misses 1e-5 at
    ViT-L/14's T = 257."""
    t = 257
    grad, attn, r = (torch.as_tensor(a) for a in cam_inputs(t, 2, 1, 2, t))
    assert rel_err(three_tf32_step(grad, attn, r, passes=1), grad, attn, r) > 1e-5
