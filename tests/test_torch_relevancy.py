"""The port's gradcam against the JAX package on the CPU (small ViT: width
128 = 2 heads of 64, 3 blocks).

Tolerance: f32 atol=2e-4, rtol=1e-3 on relevancies of magnitude ~1 (the
same math, autograd vs closed form / jax.vjp, sums in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_abstraction_tpu.clip import model as jm
from semantic_abstraction_tpu.clip import relevancy as jr
from semantic_abstraction_tpu_torch.clip import model as tm
from semantic_abstraction_tpu_torch.clip import relevancy as tr

F32 = dict(atol=2e-4, rtol=1e-3)
SMALL = dict(embed_dim=32, image_resolution=224, vision_layers=3,
             vision_width=128, vision_patch_size=32, context_length=77,
             vocab_size=49408, text_width=64, text_heads=2, text_layers=1)


@pytest.fixture(scope="module")
def setup():
    cfg_j, cfg_t = jm.ClipConfig(**SMALL), tm.ClipConfig(**SMALL)
    params = jm.init_clip_params(jax.random.PRNGKey(1), cfg_j)
    model = tm.init_clip_params(1, cfg_t, device="cpu")
    rs = np.random.RandomState(4)
    tiles = rs.randn(3, 3, 224, 224).astype(np.float32)
    zw = rs.randn(32, 4).astype(np.float32)
    return params, cfg_j, model, cfg_t, tiles, zw


# num_layers=1 leaves one tail block (the closed form, the CLI's case at
# ViT-B/32); num_layers=0 leaves two (the general path)
@pytest.mark.parametrize("num_layers", [1, 0])
@pytest.mark.parametrize("positive", [True, False])
def test_gradcam_matches_jax(setup, num_layers, positive):
    params, cfg_j, model, cfg_t, tiles, zw = setup
    want = jr.gradcam(params["visual"], jnp.asarray(tiles), jnp.asarray(zw),
                      cfg_j, num_layers=num_layers, positive_attn_only=positive)
    got = tr.gradcam(model.visual, torch.as_tensor(tiles), torch.as_tensor(zw),
                     cfg_t, num_layers=num_layers, positive_attn_only=positive)
    assert got.shape == (4, 3, 7, 7) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def _general_tail(visual, tiles, zw, cfg, num_layers, positive):
    """The general tail on the head's output, at any number of tail blocks:
    the oracle of the closed form."""
    n_head = num_layers + 1
    with torch.no_grad():
        x_mid = tr._vit_head(visual, tiles, cfg, torch.float32, n_head)
    return tr._gradcam_general_tail(visual, x_mid, zw, cfg, n_head,
                                    cfg.vision_layers - n_head, positive, torch.float32)


@pytest.mark.parametrize("positive", [True, False])
def test_closed_form_equals_general_path(setup, positive):
    _, _, model, cfg_t, tiles, zw = setup
    args = (model.visual, torch.as_tensor(tiles), torch.as_tensor(zw), cfg_t)
    closed = tr.gradcam(*args, num_layers=1, positive_attn_only=positive)
    general = _general_tail(*args, num_layers=1, positive=positive)
    torch.testing.assert_close(closed, general, **F32)


def test_gradcam_rejects_no_tail(setup):
    _, _, model, cfg_t, tiles, zw = setup
    with pytest.raises(ValueError):
        tr.gradcam(model.visual, torch.as_tensor(tiles), torch.as_tensor(zw),
                   cfg_t, num_layers=2)


def test_zeroshot_weights_from_features():
    feats = np.random.RandomState(5).randn(3, 4, 32).astype(np.float32)
    got = tr.zeroshot_weights_from_features(torch.as_tensor(feats))
    want = jr.zeroshot_weights_from_features(jnp.asarray(feats))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
