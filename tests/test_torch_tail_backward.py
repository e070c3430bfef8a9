"""The general tail's LayerNorm and quick-GELU backward route on the CPU:
``clip/model.py``'s ``_LayerNorm`` and ``_QuickGelu`` against the composite
``layer_norm`` and ``quick_gelu`` they stand for, the plain versions of
``ops/tail_backward.py`` under the labels' batched backward, where the
route engages and where it does not, and the kernel wrappers' checks. The
CUDA kernels' own tests are in test_torch_tail_backward_card.py; the
general gradcam against the JAX package is test_torch_multitail.py's.

Tolerances: f32 rtol 1e-5, atol 1e-6 on gradients of magnitude ~1 (the
same f32 arithmetic as autograd's chain, sums in another order). In bf16
the route rounds once, so it lies within half a bf16 ulp (2^-8 relative)
of the f32 gradient of the same bf16 inputs, plus 2^-20 of the gradient's
scale for the f32 sums; autograd's bf16 chain rounds at every op and is
held to 2^-6 of that scale."""
import numpy as np
import pytest
import torch

from semantic_abstraction_tpu_torch.clip import model as tm
from semantic_abstraction_tpu_torch.clip import relevancy as tr
from semantic_abstraction_tpu_torch.clip import saliency as ts
from semantic_abstraction_tpu_torch.ops import tail_backward as tb

F32 = dict(rtol=1e-5, atol=1e-6)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
LABELS = 9
# 3 blocks of width 128 (2 heads of 64), patch 32 (T = 50): num_layers=0
# leaves 2 tail blocks on the general path, 1 the closed form
SMALL = dict(embed_dim=32, image_resolution=224, vision_layers=3, vision_width=128,
             vision_patch_size=32, context_length=77, vocab_size=49408, text_width=64,
             text_heads=1, text_layers=1)


def _inputs(seed, dtype, shape=(2, 7, 64)):
    """x off zero mean and unit variance, an affine scale and bias, and
    one output gradient a label."""
    rs = np.random.RandomState(seed)
    x = torch.as_tensor(2.0 * rs.randn(*shape) + 0.5, dtype=torch.float32).to(dtype)
    scale = torch.as_tensor(1.0 + 0.3 * rs.randn(shape[-1]), dtype=torch.float32)
    bias = torch.as_tensor(0.1 * rs.randn(shape[-1]), dtype=torch.float32)
    g = torch.as_tensor(rs.randn(LABELS, *shape), dtype=torch.float32).to(dtype)
    return x, scale, bias, g


def _composite(fn, scale, bias):
    return ((lambda x: tm.layer_norm(x, scale, bias)) if fn == "layer_norm"
            else tm.quick_gelu)


def _routed(fn, scale, bias):
    return ((lambda x: tm._LayerNorm.apply(x, scale, bias, 1e-5)) if fn == "layer_norm"
            else tm._QuickGelu.apply)


def _batched_grad(f, x, g):
    x = x.detach().requires_grad_()
    (dx,) = torch.autograd.grad(f(x), x, g, is_grads_batched=True)
    return dx


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("fn", ["layer_norm", "quick_gelu"])
def test_route_forward_is_bitwise_the_composite(fn, dtype):
    x, scale, bias, _ = _inputs(0, DTYPES[dtype])
    want = _composite(fn, scale, bias)(x)
    got = _routed(fn, scale, bias)(x.detach().requires_grad_())
    assert got.dtype == want.dtype and torch.equal(got.detach(), want)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("fn", ["layer_norm", "quick_gelu"])
def test_batched_backward_matches_autograd(fn, dtype):
    """9 labels through ``is_grads_batched``, as the general tail runs
    them: the route's plain version against autograd's chain."""
    x, scale, bias, g = _inputs(1, DTYPES[dtype])
    got = _batched_grad(_routed(fn, scale, bias), x, g)
    want = _batched_grad(_composite(fn, scale, bias), x, g)
    assert got.shape == (LABELS, *x.shape) and got.dtype == x.dtype
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want.numpy(), **F32)
        return
    exact = _batched_grad(_composite(fn, scale, bias), x.float(), g.float())
    scale_of = exact.abs().max()
    err = (got.float() - exact).abs()
    assert (err <= 2.0**-8 * exact.abs() + 2.0**-20 * scale_of).all(), err.max()
    assert (want.float() - got.float()).abs().max() <= 2.0**-6 * scale_of


def test_layer_norm_parameter_gradients_match_autograd():
    x, scale, bias, g = _inputs(2, torch.float32)
    leaves = [a.clone().requires_grad_() for a in (x, scale, bias)]
    want = torch.autograd.grad(tm.layer_norm(*leaves), leaves, g[0])
    got = torch.autograd.grad(tm._LayerNorm.apply(*leaves, 1e-5), leaves, g[0])
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_allclose(a.numpy(), b.numpy(), **F32)


@pytest.fixture(scope="module")
def small():
    cfg = tm.ClipConfig(**SMALL)
    model = tm.init_clip_params(3, cfg, device="cpu")
    rs = np.random.RandomState(5)
    tiles = torch.as_tensor(rs.randn(2, 3, 224, 224).astype(np.float32))
    zw = torch.as_tensor(rs.randn(32, LABELS).astype(np.float32))
    return model, cfg, tiles, zw


@pytest.fixture
def applies(monkeypatch):
    """Counts of the route's autograd Functions engaged, by name."""
    counts = {"layer_norm": 0, "quick_gelu": 0}
    for name, fn in (("layer_norm", tm._LayerNorm), ("quick_gelu", tm._QuickGelu)):
        def counted(*a, _name=name, _apply=fn.apply):
            counts[_name] += 1
            return _apply(*a)
        monkeypatch.setattr(fn, "apply", counted)
    return counts


@pytest.fixture
def op_calls(monkeypatch):
    """(name, shape, contiguous) of each call the custom ops make to their
    plain versions: under the batched backward, one a label."""
    calls = []
    for name in ("layer_norm_backward_reference", "quick_gelu_backward_reference"):
        fn = getattr(tb, name)

        def counted(g, x, *rest, _name=name, _fn=fn):
            calls.append((_name.split("_backward")[0], tuple(g.shape), g.is_contiguous()))
            return _fn(g, x, *rest)
        monkeypatch.setattr(tb, name, counted)
    return calls


def test_general_gradcam_runs_each_recorded_block_once_a_label(small, applies, op_calls):
    """2 tail blocks: 2 ln_2, 1 ln_1 (the first tail block's input needs
    no gradient) and 2 GELUs, each called once a label on the label's
    contiguous (B, T, W) or (B, T, 4W) slice; the head scan adds none."""
    model, cfg, tiles, zw = small
    tr.gradcam(model.visual, tiles, zw, cfg, num_layers=0)
    assert applies == {"layer_norm": 3, "quick_gelu": 2}
    b, t, w = tiles.shape[0], cfg.vision_tokens, cfg.vision_width
    assert sorted(op_calls) == sorted(
        [("layer_norm", (b, t, w), True)] * (3 * LABELS)
        + [("quick_gelu", (b, t, 4 * w), True)] * (2 * LABELS))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_general_gradcam_equals_the_autograd_route(small, monkeypatch, dtype):
    """The maps through the route against the same gradcam with autograd
    differentiating the composite functions: f32 to F32; bf16 to 2^-6 of
    the largest map value (the two round their bf16 gradients at other
    points)."""
    model, cfg, tiles, zw = small
    kw = dict(num_layers=0, compute_dtype=DTYPES[dtype])
    got = tr.gradcam(model.visual, tiles, zw, cfg, **kw)
    monkeypatch.setattr(tm, "_recorded", lambda x: False)
    want = tr.gradcam(model.visual, tiles, zw, cfg, **kw)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want.numpy(), **F32)
    else:
        assert (got - want).abs().max() <= 2.0**-6 * want.abs().max()


@pytest.mark.parametrize("path", ["closed_form", "text_features", "visual_feature"])
def test_other_paths_never_reach_the_route(small, applies, path):
    """The closed form (one tail block) differentiates its CLS rows through
    ``_ln`` and ``quick_gelu`` directly; the text encoder and the visual
    feature run under no_grad."""
    model, cfg, tiles, zw = small
    if path == "closed_form":
        tr.gradcam(model.visual, tiles, zw, cfg, num_layers=1)
    elif path == "text_features":
        ts.ClipSaliency(model, cfg).text_features(["a chair", "a table"])
    else:
        img = np.random.RandomState(6).randint(0, 255, (40, 56, 3), dtype=np.uint8)
        ts.ClipSaliency(model, cfg).get_visual_feature(img)
    assert applies == {"layer_norm": 0, "quick_gelu": 0}


def _bad_inputs(case):
    x = torch.zeros(2, 4, 64)
    g = torch.zeros(2, 4, 64)
    if case == "shape":
        g = torch.zeros(2, 4, 32)
    elif case == "dtype":
        x, g = x.half(), g.half()
    elif case == "mixed":
        g = g.bfloat16()
    elif case == "strided":
        g = torch.zeros(2, 64, 4).transpose(1, 2)
    elif case == "misaligned":
        g = torch.zeros(2 * 4 * 64 + 1)[1:].view(2, 4, 64)
    elif case == "empty":
        x, g = torch.zeros(0, 4, 64), torch.zeros(0, 4, 64)
    return g, x


BAD = [("shape", ValueError), ("dtype", TypeError), ("mixed", TypeError),
       ("strided", ValueError), ("misaligned", ValueError), ("empty", ValueError)]


@pytest.mark.parametrize("case,err", BAD)
@pytest.mark.parametrize("fn", ["layer_norm", "quick_gelu"])
def test_kernel_checks_reject_what_the_kernels_do_not_take(fn, case, err):
    """The checks run before the kernel is built, so they run here."""
    g, x = _bad_inputs(case)
    with pytest.raises(err):
        if fn == "layer_norm":
            stats = torch.zeros(*x.shape[:-1], 1)
            tb._launch_layer_norm(g, x, stats, stats, torch.ones(x.shape[-1]))
        else:
            tb._launch_quick_gelu(g, x)


@pytest.mark.parametrize("w", [60, 2056])
def test_layer_norm_check_rejects_rows_the_kernel_does_not_take(w):
    """bf16 rows of a multiple of 8 elements and at most 2048."""
    x = torch.zeros(3, w, dtype=torch.bfloat16)
    stats = torch.zeros(3, 1)
    with pytest.raises(ValueError, match="rows of a multiple"):
        tb._launch_layer_norm(x, x, stats, stats, torch.ones(w))


def test_cpu_ops_are_the_plain_versions():
    x, scale, _, g = _inputs(4, torch.float32)
    xr = x.float()
    mean = xr.mean(-1, keepdim=True)
    rstd = torch.rsqrt(xr.var(-1, keepdim=True, unbiased=False) + 1e-5)
    before = (tb.layer_norm_backward.launches, tb.quick_gelu_backward.launches)
    assert torch.equal(tb.layer_norm_backward(g[0], x, mean, rstd, scale),
                       tb.layer_norm_backward_reference(g[0], x, mean, rstd, scale))
    assert torch.equal(tb.quick_gelu_backward(g[0], x),
                       tb.quick_gelu_backward_reference(g[0], x))
    assert (tb.layer_norm_backward.launches, tb.quick_gelu_backward.launches) == before
