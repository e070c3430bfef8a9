"""The CUDA channel_moments kernels, forward and backward, against their
plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA card: the kernel
has no CPU mode. The file imports neither JAX nor the JAX package, so that
it runs on a machine with the card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_channel_moments_card.py

Tolerance: the forward kernel and the plain version sum the same f32
values (bf16 inputs widen exactly) in another order, so s2 (all terms >= 0)
agrees to rtol 1e-5, and s1 to 1e-5 of sum |x| (its terms cancel). The
backward kernel rounds each step as the plain version does: bit for bit.
"""
import pytest
import torch

from semantic_abstraction_tpu_torch.ops import channel_moments as cm

# (C, S) of every GroupNorm of the full-size UNet (f_maps 16, 6 levels,
# 128^3 voxels); OVSSC runs them at B = 4 volumes, VOOL at B = 8
UNET_SHAPES = [(16, 128**3), (16, 64**3), (32, 64**3), (32, 32**3), (64, 32**3),
               (64, 16**3), (128, 16**3), (128, 8**3), (256, 8**3), (256, 4**3),
               (512, 4**3)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def assert_moments_close(got, x):
    """The stated tolerance, against the plain version on the same x."""
    s1, s2 = got
    r1, r2 = cm.channel_moments_reference(x)
    abs_sum = x.float().abs().sum(-1)
    assert s1.dtype == s2.dtype == torch.float32 and s1.shape == x.shape[:2]
    assert ((s1 - r1).abs() <= 1e-5 * abs_sum + 1e-6).all(), (s1 - r1).abs().max()
    assert ((s2 - r2).abs() <= 1e-5 * r2 + 1e-6).all(), (s2 - r2).abs().max()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,s", UNET_SHAPES)
@pytest.mark.parametrize("b", [4, 8])
def test_kernel_matches_plain_version(cuda, dtype, c, s, b):
    g = torch.Generator(device=cuda).manual_seed(c + s)
    x = (torch.randn(b, c, s, device=cuda, generator=g) * 2 + 0.5).to(dtype)
    before = cm.channel_moments.launches
    got = cm.channel_moments(x)
    torch.cuda.synchronize()
    assert cm.channel_moments.launches == before + 1
    assert_moments_close(got, x)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,s", UNET_SHAPES)
def test_inference_rows_match_plain_version(cuda, dtype, c, s):
    """B = 1, forward only: the UNet of visualize's inference, one volume a
    class or a description's stream, under no_grad."""
    test_kernel_matches_plain_version(cuda, dtype, c, s, 1)


def grads(x, seed=0):
    g = torch.Generator(device=x.device).manual_seed(seed)
    return (torch.randn(x.shape[:2], device=x.device, generator=g),
            torch.randn(x.shape[:2], device=x.device, generator=g) / x.shape[2])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,s", UNET_SHAPES)
@pytest.mark.parametrize("b", [4, 8])
def test_backward_kernel_equals_plain_version(cuda, dtype, c, s, b):
    g = torch.Generator(device=cuda).manual_seed(c + s)
    x = (torch.randn(b, c, s, device=cuda, generator=g) * 2 + 0.5).to(dtype)
    g1, g2 = grads(x)
    before = cm.channel_moments_backward.launches
    got = cm.channel_moments_backward(x, g1, g2)
    torch.cuda.synchronize()
    assert cm.channel_moments_backward.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got, cm.channel_moments_backward_reference(x, g1, g2))


@pytest.mark.gpu
@pytest.mark.parametrize("b,c,s", [(1, 1, 1), (2, 3, 5), (3, 7, 1001), (1, 5, 70001)])
def test_kernel_takes_odd_shapes(cuda, b, c, s):
    """Rows that are not 16-byte aligned take scalar heads and tails;
    ragged splits end early. Both directions, and a view that starts off
    16 bytes (so x and its fresh gradient lie unlike against 16 bytes)."""
    for dtype in (torch.float32, torch.bfloat16):
        for x in (torch.randn(b, c, s, device=cuda).to(dtype),
                  torch.randn(b * c * s + 1, device=cuda).to(dtype)[1:].view(b, c, s)):
            assert_moments_close(cm.channel_moments(x), x)
            g1, g2 = grads(x)
            assert torch.equal(cm.channel_moments_backward(x, g1, g2),
                               cm.channel_moments_backward_reference(x, g1, g2))


@pytest.mark.gpu
@pytest.mark.parametrize("b,c,s", [(4, 16, 64**3), (8, 16, 128**3), (8, 512, 4**3)])
def test_kernel_is_deterministic(cuda, b, c, s):
    """Both directions give the same bits from call to call: a cluster of
    blocks a row, one block a row and lane groups."""
    x = torch.randn(b, c, s, device=cuda, dtype=torch.bfloat16)
    a, b_ = cm.channel_moments(x), cm.channel_moments(x)
    assert torch.equal(a[0], b_[0]) and torch.equal(a[1], b_[1])
    g1, g2 = grads(x)
    assert torch.equal(cm.channel_moments_backward(x, g1, g2),
                       cm.channel_moments_backward(x, g1, g2))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4, 16, 128**3), (4, 64, 16**3), (8, 512, 4**3)])
def test_forward_is_one_device_kernel(cuda, shape):
    """One call of the forward runs one device kernel in each regime (no
    finishing pass, no scratch to clear), and so does the backward."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(*shape, device=cuda, dtype=torch.bfloat16)
    g1, g2 = grads(x)
    cm.channel_moments(x)
    cm.channel_moments_backward(x, g1, g2)
    torch.cuda.synchronize()
    for call in (lambda: cm.channel_moments(x), lambda: cm.channel_moments_backward(x, g1, g2)):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(kernels) == 1 and "moments_" in kernels[0].name, [e.name for e in kernels]


@pytest.mark.gpu
def test_kernel_backward_is_the_plain_versions(cuda):
    x = torch.randn(2, 8, 4096, device=cuda).requires_grad_()
    w1, w2 = torch.randn(2, 8, device=cuda), torch.randn(2, 8, device=cuda)
    before = cm.channel_moments_backward.launches
    s1, s2 = cm.channel_moments(x)
    (s1 * w1 + torch.sin(s2 / 4096) * w2).sum().backward()
    assert cm.channel_moments_backward.launches == before + 1
    x2 = x.detach().clone().requires_grad_()
    r1, r2 = cm.channel_moments_reference(x2)
    (r1 * w1 + torch.sin(r2 / 4096) * w2).sum().backward()
    torch.testing.assert_close(x.grad, x2.grad, atol=1e-5, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("make,err", [
    (lambda d: torch.zeros(2, 8, 64, device=d, dtype=torch.float16), TypeError),
    (lambda d: torch.zeros(2, 8, 128, device=d)[..., ::2], ValueError),
    (lambda d: torch.zeros(2, 8, 4, 4, 4, device=d).to(
        memory_format=torch.channels_last_3d).view(2, 8, -1), ValueError),
])
def test_kernel_raises_on_what_it_does_not_take(cuda, make, err):
    before = cm.channel_moments.launches, cm.channel_moments_backward.launches
    with pytest.raises(err):
        cm.channel_moments(make(cuda))
    x = make(cuda)
    with pytest.raises(err):
        cm.channel_moments_backward(x, *grads(x))
    assert (cm.channel_moments.launches, cm.channel_moments_backward.launches) == before
