"""The port's ModifiedResNet CLIP tower (``clip/resnet.py``), its weight
conversions and ``ClipSaliency.get_visual_feature`` against the JAX
package on the CPU.

The towers come from a seeded numpy state dict in the reference layout
(``chip_smoke.resnet_clip_state_dict``): 4 stages of one bottleneck at
width 8, 64 px, a 32-wide output, and a (2, 1, 2, 1) variant with blocks
that have no downsample. Tolerances:
- f32: within 1e-4 of the output's largest magnitude (the port is ~5e-7
  from JAX there: the same convolutions and sums in another order);
- bf16: the port's bf16 tower within a tenth of JAX's own bf16-vs-f32 move
  from JAX's bf16 output (it is 0: the port folds BatchNorm and sums the
  average pool's window in bf16 as JAX does; ``nn.BatchNorm2d``'s and
  ``avg_pool2d``'s roundings were 1.3 and 0.66 of that move here);
- ``get_visual_feature`` (f32, a 2-block ViT at 64 px and the ResNet, a
  portrait and a landscape image, with and without a tile mask): 1e-4 of
  the features' largest magnitude.
"""
import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_abstraction_tpu.clip import convert as jconv
from semantic_abstraction_tpu.clip import model as jm
from semantic_abstraction_tpu.clip import resnet as jres
from semantic_abstraction_tpu.clip.saliency import ClipSaliency as JaxClipSaliency
from semantic_abstraction_tpu_torch.clip import convert as tconv
from semantic_abstraction_tpu_torch.clip import model as tm
from semantic_abstraction_tpu_torch.clip import resnet as tres
from semantic_abstraction_tpu_torch.clip.saliency import ClipSaliency


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
            __file__))), "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


resnet_clip_state_dict = _chip_smoke().resnet_clip_state_dict
TOWERS = {"1111": (1, 1, 1, 1), "2121": (2, 1, 2, 1)}
SMALL_TEXT = dict(text_width=64, text_layers=1, context_length=16, vocab_size=64)
VIT = dict(embed_dim=32, image_resolution=64, vision_layers=2, vision_width=64,
           vision_patch_size=16, context_length=16, vocab_size=64, text_width=64,
           text_heads=1, text_layers=1)


def small_state_dict(layers, seed=0):
    return resnet_clip_state_dict(seed, layers=layers, width=8, resolution=64,
                                  embed_dim=32, **SMALL_TEXT)


@pytest.fixture(scope="module", params=list(TOWERS))
def tower(request):
    """(state dict, JAX params and config, port module and config)."""
    sd = small_state_dict(TOWERS[request.param])
    params, jcfg = jconv.convert_clip_state_dict(sd)
    model, tcfg = tconv.from_openai_state_dict(sd, device="cpu")
    return sd, jax.tree_util.tree_map(jnp.asarray, params), jcfg, model, tcfg


def _pixels(seed=1, b=3, r=64):
    return np.random.RandomState(seed).randn(b, 3, r, r).astype(np.float32)


def _close(got, want, rel=1e-4):
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def test_config_from_state_dict_matches_jax(tower):
    sd, _, jcfg, _, tcfg = tower
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.vision_arch == "resnet" and tcfg.vision_heads == 4
    assert tres.resnet_config_from_state_dict(sd) == jres.resnet_config_from_state_dict(sd)


def test_tower_f32_matches_jax(tower):
    sd, params, jcfg, model, tcfg = tower
    px = _pixels()
    want = np.asarray(jres.modified_resnet_forward(params["visual"], jnp.asarray(px),
                                                   jcfg.vision_heads))
    with torch.no_grad():
        got = tres.modified_resnet_forward(model.visual, torch.as_tensor(px)).numpy()
    assert got.shape == (3, 32)
    _close(got, want)


def test_tower_bf16_matches_jax_bf16(tower):
    _, params, jcfg, model, _ = tower
    px = jnp.asarray(_pixels())
    j32 = np.asarray(jres.modified_resnet_forward(params["visual"], px, jcfg.vision_heads))
    j16 = np.asarray(jres.modified_resnet_forward(params["visual"], px, jcfg.vision_heads,
                                                  jnp.bfloat16).astype(jnp.float32))
    with torch.no_grad():
        t16 = tres.modified_resnet_forward(model.visual, torch.tensor(np.asarray(px)),
                                           torch.bfloat16)
    assert t16.dtype == torch.bfloat16
    move = np.abs(j16 - j32).max()
    assert move > 0
    assert np.abs(t16.float().numpy() - j16).max() <= 0.1 * move


def test_jax_params_round_trip(tower):
    """``from_jax_params`` carries JAX's ResNet pytree (HWIO convs, (in,
    out) linears, raw BatchNorm buffers) into the module, and
    ``to_jax_params`` gives it back leaf for leaf."""
    sd, params, jcfg, _, tcfg = tower
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = tconv.from_jax_params(tree, tcfg, device="cpu")
    back = tconv.to_jax_params(model, tcfg)
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    got = dict((jax.tree_util.keystr(k), v)
               for k, v in jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(leaves)
    for k, v in leaves:
        np.testing.assert_array_equal(got[jax.tree_util.keystr(k)], v)
    px = _pixels(2)
    want = np.asarray(jm.encode_image(params, jnp.asarray(px), jcfg))
    with torch.no_grad():
        _close(tm.encode_image(model, torch.as_tensor(px), tcfg).numpy(), want)


def test_encode_image_dispatches_on_the_tower(tower):
    _, params, jcfg, model, tcfg = tower
    px = _pixels(4, b=2)
    with torch.no_grad():
        got = tm.encode_image(model, torch.as_tensor(px), tcfg).numpy()
    _close(got, np.asarray(jm.encode_image(params, jnp.asarray(px), jcfg)))
    assert isinstance(model.visual, tres.ModifiedResNet)
    vit_cfg = tm.ClipConfig(**VIT)
    assert isinstance(tm.CLIP(vit_cfg).visual, tm.VisionTransformer)


def test_resnet_refusals(tower):
    _, params, jcfg, model, tcfg = tower
    mask = np.zeros((5, 5), np.float32)
    with pytest.raises(ValueError, match="transformer-only"):
        jm.encode_image(params, jnp.asarray(_pixels(b=1)), jcfg, tile_attn_mask=mask)
    with pytest.raises(ValueError, match="transformer-only"):
        tm.encode_image(model, torch.as_tensor(_pixels(b=1)), tcfg,
                        tile_attn_mask=torch.as_tensor(mask))
    img = np.zeros((64, 64, 3), np.uint8)
    with pytest.raises(ValueError, match="transformer-only"):
        ClipSaliency(model, tcfg).get_clip_saliency(img, ["mug"])
    with pytest.raises(ValueError, match="transformer-only"):
        JaxClipSaliency(params, jcfg).get_clip_saliency(img, ["mug"])
    with pytest.raises(ValueError, match="ViT tower only"):
        tm.init_clip_params(0, tcfg, device="cpu")


def test_load_clip_checkpoint_reads_an_rn_state_dict(tower, tmp_path):
    """An RN-style ``.pt`` (a pickled state dict, ``num_batches_tracked``
    included) through ``--clip-ckpt``'s loader."""
    sd, params, jcfg, _, tcfg = tower
    path = str(tmp_path / "rn.pt")
    torch.save({k: torch.as_tensor(v) for k, v in sd.items()}, path)
    model, cfg = tconv.load_clip_checkpoint(path, device="cpu")
    assert cfg == tcfg
    px = _pixels(5, b=1)
    with torch.no_grad():
        got = tm.encode_image(model, torch.as_tensor(px), cfg).numpy()
    _close(got, np.asarray(jm.encode_image(params, jnp.asarray(px), jcfg)))


# ---------------------------------------------------------------------------
# get_visual_feature
# ---------------------------------------------------------------------------

SHAPES = {"portrait": (100, 72), "landscape": (72, 100)}


@pytest.fixture(scope="module")
def extractors():
    """(JAX, port) extractors over the same weights: a 2-block ViT and
    the (1, 1, 1, 1) ResNet, f32."""
    out = {}
    jcfg, tcfg = jm.ClipConfig(**VIT), tm.ClipConfig(**VIT)
    out["vit"] = (JaxClipSaliency(jm.init_clip_params(jax.random.PRNGKey(3), jcfg), jcfg),
                  ClipSaliency(tm.init_clip_params(3, tcfg, device="cpu"), tcfg))
    sd = small_state_dict(TOWERS["1111"])
    params, jcfg = jconv.convert_clip_state_dict(sd)
    model, tcfg = tconv.from_openai_state_dict(sd, device="cpu")
    out["resnet"] = (JaxClipSaliency(jax.tree_util.tree_map(jnp.asarray, params), jcfg),
                     ClipSaliency(model, tcfg))
    return out


def _tile_mask(t, seed=6):
    """An additive (T, T) mask: -inf on a third of the pairs, never on the
    diagonal."""
    rs = np.random.RandomState(seed)
    mask = np.where(rs.rand(t, t) < 0.33, -np.inf, 0.0).astype(np.float32)
    np.fill_diagonal(mask, 0.0)
    return mask


@pytest.mark.parametrize("arch", ["vit", "resnet"])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("masked", [False, True])
def test_get_visual_feature_matches_jax(extractors, arch, shape, masked):
    jsal, tsal = extractors[arch]
    h, w = SHAPES[shape]
    img = np.random.RandomState(h).randint(0, 255, (h, w, 3), dtype=np.uint8)
    mask = _tile_mask(tsal.cfg.vision_tokens) if masked else None
    if masked and arch == "resnet":
        with pytest.raises(ValueError, match="transformer-only"):
            tsal.get_visual_feature(img, mask)
        return
    want = np.asarray(jsal.get_visual_feature(img, mask))
    got = tsal.get_visual_feature(img, mask)
    assert got.shape == want.shape == (32,) and got.dtype == torch.float32
    _close(got.numpy(), want)
    if masked:  # the mask reaches the blocks
        assert not np.allclose(want, np.asarray(jsal.get_visual_feature(img)))
