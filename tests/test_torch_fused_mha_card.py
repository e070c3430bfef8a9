"""The CUDA fused_mha kernel against its plain PyTorch version, on the card.

Every test here is marked ``gpu`` and skips without a CUDA card: the kernel
has no CPU mode. The file imports neither JAX nor the JAX package, so that
it runs on a machine with the card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_fused_mha_card.py

Tolerances: f32 atol=rtol=1e-4 (each product as three TF32 products,
about 2^-21 of its magnitude, and sums in another order than cuBLAS); bf16
atol=2e-2, rtol=1e-2 (the probs and the output round to bf16, 1 ulp = 2^-8
relative, on outputs of magnitude <= 2; the tensor-core sums run in another
order than cuBLAS's).
"""
import pytest
import torch

from semantic_abstraction_tpu_torch.ops import fused_mha as fm

TOLS = {
    torch.float32: dict(atol=1e-4, rtol=1e-4),
    torch.bfloat16: dict(atol=2e-2, rtol=1e-2),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv_views(device, b, t, w, dtype, seed):
    """q, k, v as strided views of one (B, T, 3W) projection, as on the
    main path."""
    g = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn(b, t, 3 * w, device=device, generator=g).to(dtype)
    return qkv.split(w, dim=-1)


# ViT-B/32 tile chunks of the main path (T = 50: 12, 42, 45, 48 rows) and
# the batches 32, 64, 90; ViT-B/16 (197); ViT-L/14 at 224 and 336 px (257,
# 577) at its width of 16 heads; and at B = 1, every ragged edge of the
# query and K/V tiles (1, 16, 17, 63, 64, 65, 256, 257: bf16 tiles of 64 rows
# and 64 keys, f32 row tiles of 16 in CTAs of 128 and 32 keys), the first
# version's 256-token bound and the 2048-token bound
PATH_SHAPES = [(b, 50, 768) for b in (12, 32, 42, 45, 48, 64, 90)] + [
    (8, 197, 768), (48, 257, 1024), (48, 577, 1024)]
RAGGED_SHAPES = [(1, t, 768) for t in (1, 16, 17, 50, 63, 64, 65, 197, 256, 257, 577, 2048)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,w", PATH_SHAPES + RAGGED_SHAPES + [
    (4, 1, 768), (4, 16, 768), (4, 17, 768), (3, 256, 768), (4, 577, 1024)])
def test_kernel_matches_plain_version(cuda, dtype, b, t, w):
    heads = w // 64
    q, k, v = _qkv_views(cuda, b, t, w, dtype, seed=b + t)
    before = fm.fused_mha.launches
    out = fm.fused_mha(q, k, v, heads)
    torch.cuda.synchronize()
    assert fm.fused_mha.launches == before + 1
    assert out.shape == (b, t, w) and out.dtype == dtype
    torch.testing.assert_close(out.float(), fm.mha_reference(q, k, v, heads).float(),
                               **TOLS[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,w", [(48, 50, 768), (48, 257, 1024), (2, 577, 1024)])
def test_kernel_is_deterministic(cuda, dtype, b, t, w):
    q, k, v = _qkv_views(cuda, b, t, w, dtype, seed=7)
    assert torch.equal(fm.fused_mha(q, k, v, w // 64), fm.fused_mha(q, k, v, w // 64))


@pytest.mark.gpu
def test_kernel_backward_is_the_plain_versions(cuda):
    q, k, v = (a.contiguous().requires_grad_()
               for a in _qkv_views(cuda, 4, 50, 128, torch.float32, seed=1))
    torch.sin(fm.fused_mha(q, k, v, 2)).sum().backward()
    q2, k2, v2 = (a.detach().clone().requires_grad_() for a in (q, k, v))
    torch.sin(fm.mha_reference(q2, k2, v2, 2)).sum().backward()
    for got, want in zip((q.grad, k.grad, v.grad), (q2.grad, k2.grad, v2.grad)):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,heads,dtype,err", [
    ((2, 50, 768), 4, torch.float32, ValueError),    # head_dim 192
    ((2, 50, 768), 12, torch.float16, TypeError),    # dtype
    ((2, 2049, 768), 12, torch.float32, ValueError),  # above the token bound
    ((2, 50, 772), 12, torch.bfloat16, ValueError),  # bf16 rows not 16-byte aligned
    ((2, 50, 770), 12, torch.float32, ValueError),   # f32 rows not 16-byte aligned
])
def test_kernel_raises_on_what_it_does_not_take(cuda, shape, heads, dtype, err):
    a = torch.zeros(shape, dtype=dtype, device=cuda)[..., :768]
    before = fm.fused_mha.launches
    with pytest.raises(err):
        fm.fused_mha(a, a, a, heads)
    assert fm.fused_mha.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_raises_on_rows_that_start_off_16_bytes(cuda, dtype):
    a = torch.zeros((2, 50, 776), dtype=dtype, device=cuda)[..., 2:770]
    before = fm.fused_mha.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        fm.fused_mha(a, a, a, 12)
    assert fm.fused_mha.launches == before
