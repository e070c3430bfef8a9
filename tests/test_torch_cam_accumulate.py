"""The port's cam_accumulate against the JAX package's on the CPU: its plain
version against ``cam_accumulate_reference`` and against the Pallas
``chefer_cam_accumulate`` in interpret mode, and the wrapper's checks. The
CUDA kernel's own tests are in test_torch_cam_accumulate_card.py.

Tolerance: f32 rtol 1e-5, atol 1e-6 on outputs of magnitude ~1 (the same
f32 arithmetic, the (T, T) product summed in another order). bf16 inputs
are rounded once by numpy-made f32 values cast in both frameworks, then
widened exactly, so they take the same tolerance. Against the Pallas
kernel: atol=rtol=1e-4, as the JAX package's own kernel test allows."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_abstraction_tpu.ops.pallas_kernels import (
    cam_accumulate_reference as jax_reference,
    chefer_cam_accumulate,
)
from semantic_abstraction_tpu_torch.ops import cam_accumulate as ca

F32 = dict(rtol=1e-5, atol=1e-6)
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(seed, l, b, h, t):
    """Signed gradients, attention rows that sum to 1, and a dense R."""
    rs = np.random.RandomState(seed)
    grad = (0.05 * rs.randn(l, b, h, t, t)).astype(np.float32)
    logits = 4 * rs.randn(b, h, t, t)
    attn = np.exp(logits - logits.max(-1, keepdims=True))
    attn = (attn / attn.sum(-1, keepdims=True)).astype(np.float32)
    r = (np.eye(t) + 0.1 * rs.rand(l, b, t, t)).astype(np.float32)
    return grad, attn, r


@pytest.mark.parametrize("t", [50, 257])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("positive", [True, False])
def test_plain_version_matches_jax_reference(t, dtype, positive):
    tdt, jdt = DTYPES[dtype]
    grad, attn, r = _inputs(t, 2, 2, 3, t)
    got = ca.cam_accumulate(torch.as_tensor(grad).to(tdt), torch.as_tensor(attn).to(tdt),
                            torch.as_tensor(r), positive)
    want = jax_reference(jnp.asarray(grad).astype(jdt), jnp.asarray(attn)[None].astype(jdt),
                         jnp.asarray(r), positive)
    assert got.shape == (2, 2, t, t) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_three_chained_steps_match_jax_reference():
    """The gradcam's loop from the stride-0 identity, three tail blocks."""
    l, b, h, t = 2, 3, 4, 50
    r_t = torch.eye(t).expand(l, b, t, t)
    r_j = jnp.broadcast_to(jnp.eye(t, dtype=jnp.float32), (l, b, t, t))
    for step in range(3):
        grad, attn, _ = _inputs(10 + step, l, b, h, t)
        r_t = ca.cam_accumulate(torch.as_tensor(grad), torch.as_tensor(attn), r_t)
        r_j = jax_reference(jnp.asarray(grad), jnp.asarray(attn)[None], r_j)
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), **F32)


@pytest.mark.parametrize("t", [50, 257])
def test_plain_version_matches_pallas_kernel(t):
    """The Pallas kernel always applies the ReLU and takes the attention
    broadcast over the labels; the port takes it once."""
    l, b, h = 2, 2, 3
    grad, attn, r = _inputs(t + 1, l, b, h, t)
    got = ca.cam_accumulate(torch.as_tensor(grad), torch.as_tensor(attn),
                            torch.as_tensor(r), True)
    attn_b = np.broadcast_to(attn[None], grad.shape)
    want = chefer_cam_accumulate(jnp.asarray(grad), jnp.asarray(attn_b), jnp.asarray(r),
                                 interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_cpu_path_is_the_plain_version():
    grad, attn, r = (torch.as_tensor(a) for a in _inputs(0, 2, 2, 2, 17))
    torch.testing.assert_close(ca.cam_accumulate(grad, attn, r, False),
                               ca.cam_accumulate_reference(grad, attn, r, False),
                               rtol=0, atol=0)


def _good(l=2, b=3, h=4, t=9):
    return (torch.zeros(l, b, h, t, t), torch.zeros(b, h, t, t), torch.zeros(l, b, t, t))


@pytest.mark.parametrize("case,err", [
    ("labels", ValueError),       # R for 3 labels, grad for 2
    ("tiles", ValueError),        # attn for 2 tiles, grad for 3
    ("heads", ValueError),        # attn with 5 heads, grad with 4
    ("tokens", ValueError),       # attn at T = 8, grad at 9
    ("grad_rank", ValueError),    # grad without its label axis
    ("dtype", TypeError),         # float16 grad and attn
    ("mixed", TypeError),         # bf16 grad, f32 attn
    ("r_dtype", TypeError),       # bf16 R
    ("stride", ValueError),       # grad's last axis strided
    ("too_long", ValueError),     # above the kernel's token bound
])
def test_kernel_checks_reject_what_the_kernel_does_not_take(case, err):
    grad, attn, r = _good()
    if case == "labels":
        r = torch.zeros(3, 3, 9, 9)
    elif case == "tiles":
        attn = torch.zeros(2, 4, 9, 9)
    elif case == "heads":
        attn = torch.zeros(3, 5, 9, 9)
    elif case == "tokens":
        attn = torch.zeros(3, 4, 8, 8)
    elif case == "grad_rank":
        grad = grad[0]
    elif case == "dtype":
        grad, attn = grad.half(), attn.half()
    elif case == "mixed":
        grad = grad.to(torch.bfloat16)
    elif case == "r_dtype":
        r = r.to(torch.bfloat16)
    elif case == "stride":
        grad = grad.transpose(-1, -2)
    elif case == "too_long":
        t = ca.MAX_TOKENS + 1
        grad, attn, r = (torch.zeros(()).expand(*s) for s in
                         ((1, 1, 1, t, t), (1, 1, t, t), (1, 1, t, t)))
    with pytest.raises(err):
        ca._check(grad, attn, r)


def test_kernel_checks_take_the_stride_zero_identity():
    grad, attn, _ = _good()
    ca._check(grad, attn, torch.eye(9).expand(2, 3, 9, 9))
