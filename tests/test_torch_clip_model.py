"""The port's CLIP model, weights and tokenizer against the JAX package on
the CPU, at a small config (ViT width 128 = 2 heads of 64).

Tolerance: f32 atol=2e-4, rtol=1e-3 (the same math; sums in another order).
Weights and token ids compare exactly."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_abstraction_tpu.clip import model as jm
from semantic_abstraction_tpu.clip.convert import (
    config_from_state_dict as jax_config_from_state_dict,
    convert_clip_state_dict,
)
from semantic_abstraction_tpu.clip.tokenizer import tokenize as jax_tokenize
from semantic_abstraction_tpu_torch.clip import convert as tc
from semantic_abstraction_tpu_torch.clip import model as tm
from semantic_abstraction_tpu_torch.clip import tokenizer as ttok
from semantic_abstraction_tpu_torch.clip.saliency import IMAGENET_TEMPLATES

F32 = dict(atol=2e-4, rtol=1e-3)

SMALL = dict(embed_dim=32, image_resolution=224, vision_layers=3,
             vision_width=128, vision_patch_size=32, context_length=77,
             vocab_size=49408, text_width=64, text_heads=2, text_layers=2)


@pytest.fixture(scope="module")
def models():
    cfg_j, cfg_t = jm.ClipConfig(**SMALL), tm.ClipConfig(**SMALL)
    params = jm.init_clip_params(jax.random.PRNGKey(7), cfg_j)
    model = tm.init_clip_params(7, cfg_t, device="cpu")
    return params, cfg_j, model, cfg_t


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_trees_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)


def test_init_clip_params_equals_jax_init(models):
    params, _, model, cfg_t = models
    _assert_trees_equal(params, tc.to_jax_params(model, cfg_t))


def test_from_jax_params_round_trip(models):
    params, _, _, cfg_t = models
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = tc.from_jax_params(tree, cfg_t, device="cpu")
    _assert_trees_equal(params, tc.to_jax_params(model, cfg_t))


def test_openai_state_dict_loader_matches_jax_converter():
    cfg = tm.ClipConfig(**SMALL)
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in tm.CLIP(cfg).state_dict().items()}
    rs = np.random.RandomState(3)
    sd = {k: np.asarray(rs.randn(*s), np.float32) for k, s in shapes.items()}
    sd["visual.proj"] = sd["visual.proj"].astype(np.float16)  # fp16 upcast
    params_j, cfg_j = convert_clip_state_dict(sd)
    model, cfg_t = tc.from_openai_state_dict(sd, device="cpu")
    # the inferred config (text heads = width // 64) equals the JAX one
    assert dataclasses.asdict(cfg_t) == {
        k: getattr(cfg_j, k) for k in dataclasses.asdict(cfg_t)}
    assert jax_config_from_state_dict(sd) == cfg_j
    _assert_trees_equal(params_j, tc.to_jax_params(model, cfg_t))


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_layer_norm(dtype):
    rs = np.random.RandomState(0)
    x = (rs.randn(3, 5, 128) * 3 + 1).astype(dtype)
    s, b = rs.randn(128).astype(np.float32), rs.randn(128).astype(np.float32)
    got = tm.layer_norm(torch.as_tensor(x), torch.as_tensor(s), torch.as_tensor(b))
    want = np.asarray(jm.layer_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b)))
    assert got.dtype == torch.from_numpy(x).dtype
    tol = F32 if dtype == np.float32 else dict(atol=2e-3, rtol=2e-3)  # f16 ulp
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32), **tol)


@pytest.mark.parametrize("res", [224, 192])  # T = 50, and T = 37 (pos quirk)
def test_vit_forward_and_encode_image(models, res):
    params, cfg_j, model, cfg_t = models
    px = np.random.RandomState(res).randn(2, 3, res, res).astype(np.float32)
    fj, pj = jm.vit_forward(params["visual"], jnp.asarray(px), cfg_j)
    with torch.no_grad():
        ft, pt = tm.vit_forward(model.visual, torch.as_tensor(px), cfg_t)
        et = tm.encode_image(model, torch.as_tensor(px), cfg_t)
    ej = jm.encode_image(params, jnp.asarray(px), cfg_j)
    assert pt.shape == pj.shape
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), **F32)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), **F32)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), **F32)


def test_interpolated_pos_embed_when_length_already_matches():
    """T != 50 interpolates (anchored to 50) even when the embedding has T
    rows: a 160 px config has 26 tokens and a 26-row embedding."""
    pos = np.random.RandomState(2).randn(26, 16).astype(np.float32)
    got = tm.interpolate_positional_emb(torch.as_tensor(pos), 26)
    want = jm.interpolate_positional_emb(jnp.asarray(pos), 26)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert not np.allclose(got.numpy(), pos)


def test_encode_text(models):
    params, cfg_j, model, cfg_t = models
    tokens = jax_tokenize(["a photo of a chair.", "wall", "abstract painting "
                           "of a vespa"])
    want = jm.encode_text(params["text"], jnp.asarray(tokens), cfg_j)
    with torch.no_grad():
        got = tm.encode_text(model, torch.as_tensor(tokens), cfg_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


TEXTS = ([t.format("ping pong table") for t in IMAGENET_TEMPLATES[:20]]
         + ["it's 3 o'clock!", "a photo of a 3D-printed vase, isn't it?",
            "Café &amp; résumé -- 42 items", "  spaced   out  "])


def test_tokenizer_matches_jax():
    np.testing.assert_array_equal(ttok.tokenize(TEXTS), jax_tokenize(TEXTS))


def test_tokenizer_fallback_pattern_matches_jax(monkeypatch):
    """The card's machine may lack ``regex``: the ``re`` fallback pattern
    must give the same ids on the repo's labels and prompts."""
    monkeypatch.setattr(ttok, "_TOKEN_PATTERN", ttok._FALLBACK_PATTERN)
    np.testing.assert_array_equal(ttok.tokenize(TEXTS), jax_tokenize(TEXTS))
