"""The CUDA cam_accumulate kernel against its plain PyTorch version, on the
card.

Every test here is marked ``gpu`` and skips without a CUDA card: the kernel
has no CPU mode. The file imports neither JAX nor the JAX package, so that
it runs on a machine with the card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cam_accumulate_card.py

Tolerance: both versions widen the inputs to f32 exactly and sum in f32 in
another order (the kernel's FMA chain, cuBLAS with TF32 off), so each
output agrees to 1e-5 of the sum of the magnitudes of its terms,
|R| + |cam| @ |R|.
"""
import pytest
import torch

from semantic_abstraction_tpu_torch.ops import cam_accumulate as ca


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def make_inputs(device, l, b, h, t, dtype, seed, identity=False):
    """Attention probabilities (rows sum to 1), signed gradients, and a
    relevancy R: the gradcam's first R (the identity expanded with stride
    0) or a later, dense one."""
    g = torch.Generator(device=device).manual_seed(seed)
    attn = torch.softmax(4 * torch.randn(b, h, t, t, device=device, generator=g), -1)
    grad = torch.randn(l, b, h, t, t, device=device, generator=g) * 0.05
    eye = torch.eye(t, device=device)
    if identity:
        r = eye.expand(l, b, t, t)
    else:
        r = eye + 0.1 * torch.rand(l, b, t, t, device=device, generator=g)
    return grad.to(dtype), attn.to(dtype), r


def assert_cam_close(out, grad, attn, r, positive):
    ref = ca.cam_accumulate_reference(grad, attn, r, positive)
    cam_abs = (grad.float() * attn[None].float()).abs().mean(dim=2)
    scale = r.abs() + torch.matmul(cam_abs, r.abs())
    assert out.shape == ref.shape and out.dtype == torch.float32
    err = (out - ref).abs()
    assert (err <= 1e-5 * scale).all(), (err / scale).max()


@pytest.mark.gpu
@pytest.mark.parametrize("positive", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [50, 257, 577])
def test_kernel_matches_plain_version(cuda, t, dtype, positive):
    grad, attn, r = make_inputs(cuda, 3, 2, 4, t, dtype, seed=t)
    before = ca.cam_accumulate.launches
    out = ca.cam_accumulate(grad, attn, r, positive)
    torch.cuda.synchronize()
    assert ca.cam_accumulate.launches == before + 1
    assert_cam_close(out, grad, attn, r, positive)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [50, 257, 577])
def test_kernel_takes_the_stride_zero_identity(cuda, t, dtype):
    grad, attn, r = make_inputs(cuda, 2, 3, 2, t, dtype, seed=t + 1, identity=True)
    assert r.stride()[:2] == (0, 0)
    out = ca.cam_accumulate(grad, attn, r, True)
    assert_cam_close(out, grad, attn, r, True)


@pytest.mark.gpu
def test_chained_steps_match_plain_version(cuda):
    """Three steps of the gradcam's loop, each from the kernel's own R."""
    t = 257
    r = r_ref = torch.eye(t, device=cuda).expand(2, 2, t, t)
    for step in range(3):
        grad, attn, _ = make_inputs(cuda, 2, 2, 4, t, torch.bfloat16, seed=step)
        r = ca.cam_accumulate(grad, attn, r, True)
        r_ref = ca.cam_accumulate_reference(grad, attn, r_ref, True)
    torch.testing.assert_close(r, r_ref, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_kernel_is_deterministic(cuda):
    grad, attn, r = make_inputs(cuda, 9, 4, 16, 257, torch.bfloat16, seed=3)
    assert torch.equal(ca.cam_accumulate(grad, attn, r), ca.cam_accumulate(grad, attn, r))


@pytest.mark.gpu
@pytest.mark.parametrize("which,make,err", [
    ("grad", lambda a: a.half(), TypeError),
    ("r", lambda a: a.to(torch.bfloat16), TypeError),
    ("attn", lambda a: a[:1], ValueError),
    ("grad", lambda a: a.transpose(-1, -2), ValueError),
])
def test_kernel_raises_on_what_it_does_not_take(cuda, which, make, err):
    args = dict(zip(("grad", "attn", "r"), make_inputs(cuda, 2, 2, 2, 50, torch.float32, 0)))
    args[which] = make(args[which])
    before = ca.cam_accumulate.launches
    with pytest.raises(err):
        ca.cam_accumulate(args["grad"], args["attn"], args["r"])
    assert ca.cam_accumulate.launches == before


@pytest.mark.gpu
def test_kernel_refuses_more_tokens_than_its_bound(cuda):
    t = ca.MAX_TOKENS + 1
    grad = torch.zeros(1, 1, 1, t, t, device=cuda)
    with pytest.raises(ValueError):
        ca.cam_accumulate(grad, grad[0], grad[:, :, 0])
