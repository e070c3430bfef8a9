"""The CUDA LayerNorm and quick-GELU backward kernels against their plain
PyTorch versions, and the general gradcam through them, on the card.

Every test here is marked ``gpu`` and skips without a CUDA card: the
kernels have no CPU mode. The file imports neither JAX nor the JAX
package, so that it runs on a machine with the card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_tail_backward_card.py

Tolerances. Kernel against plain version: both compute in f32 from the
same inputs; the LayerNorm's two row sums are taken in another order, and
the kernel's exponential is CUDA's ``expf`` against PyTorch's sigmoid, so
f32 outputs agree to 1e-5 of the row's largest |dx| (the LayerNorm
cancels there) and rtol 1e-5 elementwise beside it, and bf16 outputs, each
rounded once from such f32 values, to one bf16 ulp (2^-7 relative) plus
the same f32 slack. Maps: ``MAPS_GAP`` below.
"""
import pytest
import torch

from semantic_abstraction_tpu_torch.clip import model as tm
from semantic_abstraction_tpu_torch.clip import relevancy as tr
from semantic_abstraction_tpu_torch.ops import tail_backward as tb

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the vitl14-relevancy-ours cell's tile chunks, T = 257, width 1024 (the
# MLP's hidden width 4096)
CHUNKS = [12, 90, 104, 105]
T, W = 257, 1024
LABELS = 9
VIT_L_14 = dict(embed_dim=768, image_resolution=224, vision_layers=24, vision_width=1024,
                vision_patch_size=14, context_length=77, vocab_size=49408, text_width=768,
                text_heads=12, text_layers=12)
VIT_B_32 = dict(VIT_L_14, embed_dim=512, vision_layers=12, vision_width=768,
                vision_patch_size=32, text_width=512, text_heads=8)
# the cell's limit on the worst label's |maps - ref| / |ref|
# (benchmark/limits/vitl14-relevancy-ours.json)
CELL_LIMIT = 0.0025
# the route's maps against the autograd route's, both bf16, for one gradcam
# of 12 tiles (no average over tiles, flips and scales, as a cell's image
# has): half the cell's limit. Read 0.00088 there, while each route's gap
# to the f32 gradcam read 0.0029-0.0030 (NVIDIA H100 80GB HBM3, 700 W)
MAPS_GAP = CELL_LIMIT / 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(out, ref, dtype):
    """out within the module doc's tolerance of ref, row by row."""
    assert out.shape == ref.shape and out.dtype == ref.dtype
    o, r = out.float(), ref.float()
    row_max = r.abs().amax(dim=-1, keepdim=True)
    rel = 2.0**-7 if dtype == torch.bfloat16 else 1e-5
    err = (o - r).abs()
    bound = rel * r.abs() + 1e-5 * row_max
    assert (err <= bound).all(), (err / bound).max()


def _ln_inputs(device, b, t, w, dtype, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    x = (2.0 * torch.randn(b, t, w, device=device, generator=g) + 0.5).to(dtype)
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    rstd = torch.rsqrt(x32.var(-1, keepdim=True, unbiased=False) + 1e-5)
    scale = 1.0 + 0.3 * torch.randn(w, device=device, generator=g)
    grad = torch.randn(b, t, w, device=device, generator=g).to(dtype)
    return grad, x, mean, rstd, scale


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b", CHUNKS)
def test_layer_norm_kernel_matches_plain_version(cuda, b, dtype):
    args = _ln_inputs(cuda, b, T, W, DTYPES[dtype], seed=b)
    before = tb.layer_norm_backward.launches
    out = tb.layer_norm_backward(*args)
    torch.cuda.synchronize()
    assert tb.layer_norm_backward.launches == before + 1
    _close(out, tb.layer_norm_backward_reference(*args), DTYPES[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("w", [8, 64, 512, 768, 776, 1000, 1016])
def test_layer_norm_kernel_takes_other_widths(cuda, w, dtype):
    """Rows of one vector to the f32 bound, some ending in masked lanes
    (776, 1000, 1016); f32 rows take up to 1024, bf16 up to 2048."""
    dt = DTYPES[dtype]
    args = _ln_inputs(cuda, 3, 37, w, dt, seed=w)
    _close(tb.layer_norm_backward(*args), tb.layer_norm_backward_reference(*args), dt)


@pytest.mark.gpu
def test_layer_norm_kernel_takes_the_widest_bf16_row(cuda):
    args = _ln_inputs(cuda, 2, 5, 2048, torch.bfloat16, seed=2048)
    _close(tb.layer_norm_backward(*args), tb.layer_norm_backward_reference(*args),
           torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b", CHUNKS)
def test_quick_gelu_kernel_matches_plain_version(cuda, b, dtype):
    g = torch.Generator(device=cuda).manual_seed(b)
    x = (3.0 * torch.randn(b, T, 4 * W, device=cuda, generator=g)).to(DTYPES[dtype])
    grad = torch.randn(b, T, 4 * W, device=cuda, generator=g).to(DTYPES[dtype])
    before = tb.quick_gelu_backward.launches
    out = tb.quick_gelu_backward(grad, x)
    torch.cuda.synchronize()
    assert tb.quick_gelu_backward.launches == before + 1
    _close(out, tb.quick_gelu_backward_reference(grad, x), DTYPES[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n", [1, 7, 8, 1000, 1003, 2**20 + 5])
def test_quick_gelu_kernel_takes_ragged_lengths(cuda, n, dtype):
    """Lengths off the vector width go through the scalar tail."""
    g = torch.Generator(device=cuda).manual_seed(n)
    x = (3.0 * torch.randn(n, device=cuda, generator=g)).to(DTYPES[dtype])
    grad = torch.randn(n, device=cuda, generator=g).to(DTYPES[dtype])
    out = tb.quick_gelu_backward(grad, x)
    _close(out[None], tb.quick_gelu_backward_reference(grad, x)[None], DTYPES[dtype])


@pytest.mark.gpu
def test_kernels_are_deterministic(cuda):
    args = _ln_inputs(cuda, 12, T, W, torch.bfloat16, seed=5)
    assert torch.equal(tb.layer_norm_backward(*args), tb.layer_norm_backward(*args))
    grad, x = args[0].repeat(1, 1, 4), args[1].repeat(1, 1, 4)
    assert torch.equal(tb.quick_gelu_backward(grad, x), tb.quick_gelu_backward(grad, x))


def _visual(spec, device, seed):
    """A ViT tower at the published widths with seeded random weights:
    LayerNorm scales near 1, small biases, weights at fan-in scale."""
    cfg = tm.ClipConfig(**spec)
    visual = tm.VisionTransformer(cfg).to(device)
    g = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, p in visual.named_parameters():
            r = torch.randn(p.shape, device=device, generator=g)
            if p.dim() == 1:
                p.copy_(1.0 + 0.1 * r if "ln_" in name and name.endswith("weight")
                        else 0.02 * r)
            else:
                p.copy_(r * p[0].numel() ** -0.5)
    return visual.requires_grad_(False), cfg


def _tiles(device, b, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(b, 3, 224, 224, device=device, generator=g),
            torch.randn(768, LABELS, device=device, generator=g) / 768**0.5)


@pytest.mark.gpu
def test_launches_per_gradcam_call(cuda):
    """ViT-L/14 (13 tail blocks at num_layers=10): 13 ln_2 and 12 ln_1
    (the first tail block's input needs no gradient), 13 GELUs, each once
    a label: 38 x 9 = 342 launches. ViT-B/32 (the closed form): none."""
    counters = (tb.layer_norm_backward, tb.quick_gelu_backward)
    for spec, want in ((VIT_L_14, (25 * LABELS, 13 * LABELS)), (VIT_B_32, (0, 0))):
        visual, cfg = _visual(spec, cuda, seed=0)
        tiles, zw = _tiles(cuda, 2, seed=1)
        for c in counters:
            c.launches = 0
        tr.gradcam(visual, tiles, zw[: cfg.embed_dim], cfg, num_layers=10,
                   compute_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        assert tuple(c.launches for c in counters) == want, spec["vision_width"]
        del visual


def _worst_label_gap(maps, ref):
    """The cell's measure: the worst label's |maps - ref| / |ref|."""
    d = (maps.float() - ref.float()).flatten(1).norm(dim=1)
    return (d / ref.float().flatten(1).norm(dim=1)).max().item()


@pytest.mark.gpu
def test_vit_l14_maps_match_the_autograd_route(cuda, monkeypatch):
    """One ViT-L/14 tile chunk of the cell (12 tiles), bf16: the maps
    through the kernels against the same gradcam with autograd
    differentiating the composite LayerNorm and quick-GELU, to
    ``MAPS_GAP``; and, against the f32 gradcam, the route no further off
    than autograd's (5% of room: the route rounds once where autograd's
    chain rounds at every op)."""
    visual, cfg = _visual(VIT_L_14, cuda, seed=2)
    tiles, zw = _tiles(cuda, 12, seed=3)
    kw = dict(num_layers=10, compute_dtype=torch.bfloat16)
    route = tr.gradcam(visual, tiles, zw, cfg, **kw)
    f32 = tr.gradcam(visual, tiles, zw, cfg, num_layers=10, compute_dtype=torch.float32)
    monkeypatch.setattr(tm, "_recorded", lambda x: False)
    autograd = tr.gradcam(visual, tiles, zw, cfg, **kw)
    gaps = {"route_vs_autograd": _worst_label_gap(route, autograd),
            "route_vs_f32": _worst_label_gap(route, f32),
            "autograd_vs_f32": _worst_label_gap(autograd, f32)}
    print(f"ViT-L/14 maps, worst label's relative L2 gap: {gaps}")
    assert gaps["route_vs_autograd"] <= MAPS_GAP, gaps
    assert gaps["route_vs_f32"] <= 1.05 * gaps["autograd_vs_f32"], gaps
