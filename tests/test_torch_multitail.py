"""The multi-tail relevancy slice against the JAX package on the CPU: the
general gradcam (more than one block after ``num_layers``, as ViT-L/14 at
the reference's num_layers=10), ``ClipSaliency`` over it, a patch-14
config at T = 257 tokens, the ViT-L/14 config read from a state dict, and
the ``--clip-ckpt`` route of the CLI on a 13-block model. Small widths
(128 = 2 heads of 64, or 64 = 1 head); weights cross with
``from_jax_params`` or a saved state dict.

Tolerances: gradcam f32 atol=2e-4, rtol=1e-3 on relevancies of magnitude
~1 (autograd against jax.vjp, sums in another order); float16 maps within
2 f16 ulp of the largest value (max|diff| <= 2**-9 * max|map|), as
test_torch_saliency.py allows."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_abstraction_tpu.clip import convert as jc
from semantic_abstraction_tpu.clip import model as jm
from semantic_abstraction_tpu.clip import relevancy as jr
from semantic_abstraction_tpu.clip import saliency as js
from semantic_abstraction_tpu_torch.cli import generate_relevancy as tcli
from semantic_abstraction_tpu_torch.clip import convert as tc
from semantic_abstraction_tpu_torch.clip import model as tm
from semantic_abstraction_tpu_torch.clip import relevancy as tr
from semantic_abstraction_tpu_torch.clip import saliency as ts

F32 = dict(atol=2e-4, rtol=1e-3)
TEXT = dict(embed_dim=32, context_length=77, vocab_size=49408, text_width=64,
            text_heads=1, text_layers=1)
# 4 blocks: num_layers=0 leaves 3 tail blocks
FOUR_BLOCKS = dict(image_resolution=224, vision_layers=4, vision_width=128,
                   vision_patch_size=32, **TEXT)
# patch 14 at 224 px: T = 257, the 50-token-anchored position quirk
PATCH14 = dict(image_resolution=224, vision_layers=3, vision_width=128,
               vision_patch_size=14, **TEXT)
# OpenAI ViT-L/14, the published shape
VIT_L_14 = dict(embed_dim=768, image_resolution=224, vision_layers=24,
                vision_width=1024, vision_patch_size=14, context_length=77,
                vocab_size=49408, text_width=768, text_heads=12, text_layers=12)
LABELS = ["chair", "table", "sofa"]


def _models(spec, seed):
    cfg_j, cfg_t = jm.ClipConfig(**spec), tm.ClipConfig(**spec)
    params = jm.init_clip_params(jax.random.PRNGKey(seed), cfg_j)
    model = tc.from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg_t,
                               device="cpu")
    return params, cfg_j, model, cfg_t


@pytest.mark.parametrize("spec,num_layers,tiles", [
    (FOUR_BLOCKS, 0, 3),   # 3 tail blocks at T = 50
    (PATCH14, 0, 2),       # 2 tail blocks at T = 257
])
@pytest.mark.parametrize("positive", [True, False])
def test_multitail_gradcam_matches_jax(spec, num_layers, tiles, positive):
    params, cfg_j, model, cfg_t = _models(spec, seed=2)
    rs = np.random.RandomState(7)
    x = rs.randn(tiles, 3, 224, 224).astype(np.float32)
    zw = rs.randn(32, 4).astype(np.float32)
    want = jr.gradcam(params["visual"], jnp.asarray(x), jnp.asarray(zw), cfg_j,
                      num_layers=num_layers, positive_attn_only=positive)
    got = tr.gradcam(model.visual, torch.as_tensor(x), torch.as_tensor(zw), cfg_t,
                     num_layers=num_layers, positive_attn_only=positive)
    g = spec["image_resolution"] // spec["vision_patch_size"]
    assert got.shape == (4, tiles, g, g) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def _counting(fn, calls):
    def wrapper(grad, attn, r_mat, positive_attn_only):
        calls.append((tuple(grad.shape), tuple(attn.shape), positive_attn_only))
        return fn(grad, attn, r_mat, positive_attn_only)
    return wrapper


@pytest.mark.parametrize("positive", [True, False])
def test_general_path_accumulates_every_tail_block_through_cam_accumulate(
        monkeypatch, positive):
    _, _, model, cfg_t = _models(FOUR_BLOCKS, seed=3)
    calls = []
    monkeypatch.setattr(tr, "cam_accumulate", _counting(tr.cam_accumulate, calls))
    x = torch.as_tensor(np.random.RandomState(1).randn(2, 3, 224, 224).astype(np.float32))
    zw = torch.as_tensor(np.random.RandomState(2).randn(32, 5).astype(np.float32))
    tr.gradcam(model.visual, x, zw, cfg_t, num_layers=0, positive_attn_only=positive)
    # one call per tail block, attention not broadcast over the 5 labels
    assert calls == [((5, 2, 2, 50, 50), (2, 2, 50, 50), positive)] * 3


def test_multitail_saliency_matches_jax():
    params, cfg_j, model, cfg_t = _models(FOUR_BLOCKS, seed=0)
    sj = js.ClipSaliency(params, cfg_j, tile_batch_size=8, num_layers=0)
    st = ts.ClipSaliency(model, cfg_t, tile_batch_size=8, num_layers=0)
    img = np.random.RandomState(3).randint(0, 255, (64, 96, 3), dtype=np.uint8)
    crops = [(64, 16), (32, 8)]
    cj = js.SaliencyConfig(crops=tuple(js.CropSpec(*c) for c in crops),
                           horizontal_flipping=True, augmentations=0)
    ct = ts.SaliencyConfig(crops=tuple(ts.CropSpec(*c) for c in crops),
                           horizontal_flipping=True, augmentations=0)
    mj, _ = sj.get_clip_saliency(img, LABELS, ["a photo of a {}"], cj)
    mt, _ = st.get_clip_saliency(img, LABELS, ["a photo of a {}"], ct)
    assert mt.shape == (3, 64, 96) and mt.dtype == torch.float16
    mj = np.asarray(mj, np.float32)
    assert np.abs(mj).max() > 0
    diff = np.abs(mt.float().numpy() - mj).max()
    assert diff <= 2.0**-9 * np.abs(mj).max(), diff


def _state_dict_shapes(spec):
    """Key -> shape of an OpenAI ViT CLIP state dict."""
    vw, tw, e = spec["vision_width"], spec["text_width"], spec["embed_dim"]
    p = spec["vision_patch_size"]
    tokens = (spec["image_resolution"] // p) ** 2 + 1
    shapes = {"visual.conv1.weight": (vw, 3, p, p), "visual.class_embedding": (vw,),
              "visual.positional_embedding": (tokens, vw), "visual.proj": (vw, e),
              "token_embedding.weight": (spec["vocab_size"], tw),
              "positional_embedding": (spec["context_length"], tw),
              "text_projection": (tw, e), "logit_scale": ()}
    for name, w in (("visual.ln_pre", vw), ("visual.ln_post", vw), ("ln_final", tw)):
        shapes.update({f"{name}.weight": (w,), f"{name}.bias": (w,)})
    for prefix, w, n in (("visual.transformer", vw, spec["vision_layers"]),
                         ("transformer", tw, spec["text_layers"])):
        for i in range(n):
            b = f"{prefix}.resblocks.{i}."
            shapes.update({b + "attn.in_proj_weight": (3 * w, w),
                           b + "attn.in_proj_bias": (3 * w,),
                           b + "attn.out_proj.weight": (w, w), b + "attn.out_proj.bias": (w,),
                           b + "mlp.c_fc.weight": (4 * w, w), b + "mlp.c_fc.bias": (4 * w,),
                           b + "mlp.c_proj.weight": (w, 4 * w), b + "mlp.c_proj.bias": (w,)})
            for ln in ("ln_1", "ln_2"):
                shapes.update({b + ln + ".weight": (w,), b + ln + ".bias": (w,)})
    return shapes


def test_config_from_state_dict_reads_vit_l14_like_jax():
    """Zero-stride views: no full-size tensor is allocated."""
    sd = {k: np.broadcast_to(np.float32(0), s)
          for k, s in _state_dict_shapes(VIT_L_14).items()}
    got, want = tc.config_from_state_dict(sd), jc.config_from_state_dict(sd)
    assert got == tm.ClipConfig(**VIT_L_14)
    for field in ("embed_dim", "image_resolution", "vision_layers", "vision_width",
                  "vision_patch_size", "context_length", "vocab_size", "text_width",
                  "text_heads", "text_layers"):
        assert getattr(got, field) == getattr(want, field), field
    assert (got.vision_heads, got.vision_tokens) == (16, 257)


def test_clip_ckpt_route_matches_jax(tmp_path):
    """The route a ViT-L/14 user takes: ``build_saliency`` with --clip-ckpt
    on a saved state dict of a model deeper than 12 blocks (here 13 blocks
    of width 64), so the CLI's num_layers=10 leaves 2 tail blocks; the
    chefer_et_al crops keep it short."""
    spec = dict(image_resolution=224, vision_layers=13, vision_width=64,
                vision_patch_size=32, **TEXT)
    path = str(tmp_path / "clip.pt")
    torch.save(tm.init_clip_params(4, tm.ClipConfig(**spec), device="cpu").state_dict(), path)
    args = tcli.parser().parse_args(
        ["image", "--clip-ckpt", path, "--device", "cpu", "--compute_dtype", "float32",
         "--saliency_config", "chefer_et_al", "--labels", *LABELS])
    sal = tcli.build_saliency(args)
    assert sal.cfg == tm.ClipConfig(**spec) and sal.num_layers == 10
    img = np.random.RandomState(5).randint(0, 255, (32, 48, 3), dtype=np.uint8)
    maps = tcli.relevancy(sal, img, args)

    # the JAX loader returns numpy leaves, which its jitted text encoder
    # cannot index with traced tokens: hand it device arrays
    params, cfg_j = jc.load_clip_checkpoint(path)
    sj = js.ClipSaliency(jax.tree_util.tree_map(jnp.asarray, params), cfg_j,
                         compute_dtype=jnp.float32)
    mj, _ = sj.get_clip_saliency(img, LABELS, [tcli.DEFAULT_PROMPT],
                                 js.saliency_configs["chefer_et_al"](32))
    mj = np.asarray(mj, np.float32)
    assert maps.shape == (3, 32, 48) and maps.dtype == torch.float16
    assert np.abs(mj).max() > 0
    assert np.abs(maps.float().numpy() - mj).max() <= 2.0**-9 * np.abs(mj).max()
