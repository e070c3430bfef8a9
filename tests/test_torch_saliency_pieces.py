"""Pieces of the port's saliency pipeline against the JAX package on the
CPU: the crop plan and resize matrices (bit-exact), tile extraction, the
jitter ops on injected factors, and the ``image`` CLI's split entry points.

Tolerance: f32 atol=1e-5 on [0, 1] pixels (elementwise ops; the hue op's
divisions and floor may round differently in the last bit)."""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_abstraction_tpu.clip import saliency as js
from semantic_abstraction_tpu.ops.sampling import resize_matrix as jax_resize_matrix
import semantic_abstraction_tpu_torch.clip as clip_pkg
from semantic_abstraction_tpu_torch.cli import generate_relevancy as cli
from semantic_abstraction_tpu_torch.clip import saliency as ts
from semantic_abstraction_tpu_torch.ops.sampling import resize_matrix

PIX = dict(atol=1e-5, rtol=0)


@pytest.mark.parametrize("hw,cfg", [
    ((480, 640), "ours"), ((224, 224), "ours"), ((300, 400), "ours"),
    ((480, 640), "chefer_et_al"),
])
def test_tile_plan_bit_exact(hw, cfg):
    crops_j = js.saliency_configs[cfg](hw[0]).crops
    crops_t = ts.saliency_configs[cfg](hw[0]).crops
    for pj, pt in zip(js.tile_plan(hw, crops_j, 6), ts.tile_plan(hw, crops_t, 6)):
        assert (pj.tile_size, pj.stride, pj.nx, pj.ny) == (
            pt.tile_size, pt.stride, pt.nx, pt.ny)
        np.testing.assert_array_equal(pj.offsets, pt.offsets)
        np.testing.assert_array_equal(pj.count, pt.count)


@pytest.mark.parametrize("args", [
    (480, 224, "bicubic_pil"), (53, 224, "bicubic_pil"), (300, 224, "bicubic_pil"),
    (7, 120, "bilinear_torch"), (7, 30, "bilinear_torch"),
    (10, 4, "bilinear_torch_ac"),
])
def test_resize_matrix_bit_exact(args):
    np.testing.assert_array_equal(resize_matrix(*args), jax_resize_matrix(*args))


def test_extract_tiles_matches_jax():
    rs = np.random.RandomState(0)
    images = rs.rand(2, 3, 64, 80).astype(np.float32)
    offsets = np.asarray([[0, 0], [10, 20], [32, 48]], np.int32)
    want = js.extract_tiles(jnp.asarray(images), jnp.asarray(offsets), 32)
    idx = torch.arange(2).repeat_interleave(3)
    got = ts.extract_tiles(torch.as_tensor(images), idx,
                           torch.as_tensor(np.tile(offsets, (2, 1))).long(), 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def image():
    rs = np.random.RandomState(1)
    img = rs.rand(3, 24, 32).astype(np.float32)
    img[:, :4, :4] = 0.5  # grey patch: the hue op's c == 0 branch
    img[0, 4:8, :4] = 1.0
    return img


@pytest.mark.parametrize("name,factor", [
    ("_adjust_brightness", 1.37), ("_adjust_contrast", 0.61),
    ("_adjust_saturation", 1.52), ("_adjust_hue", 0.083), ("_adjust_hue", -0.09),
])
def test_jitter_op_matches_jax(image, name, factor):
    got = getattr(ts, name)(torch.as_tensor(image), factor)
    want = getattr(js, name)(jnp.asarray(image), jnp.float32(factor))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PIX)


def test_color_jitter_applies_ops_in_the_given_order(image):
    factors = np.asarray([0.8, 1.3, 0.5, 0.05], np.float32)
    order = [3, 0, 2, 1]
    want = jnp.asarray(image)
    ops = [js._adjust_brightness, js._adjust_contrast, js._adjust_saturation,
           js._adjust_hue]
    for op in order:
        want = ops[op](want, jnp.float32(factors[op]))
    got = ts.color_jitter(torch.as_tensor(image), torch.as_tensor(factors),
                          torch.as_tensor(order))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PIX)


def test_draw_jitter_ranges():
    g = torch.Generator().manual_seed(0)
    for _ in range(50):
        f, order = ts.draw_jitter(g)
        assert ((f[:3] >= 0.4) & (f[:3] <= 1.6)).all() and abs(float(f[3])) <= 0.1
        assert sorted(order.tolist()) == [0, 1, 2, 3]


def _cli_args(**kw):
    args = cli.parser().parse_args(["image", "--random-weights"])
    return argparse.Namespace(**{**vars(args), **kw})


def test_cli_defaults_to_cuda_and_raises_without_it():
    args = cli.parser().parse_args(["image", "--random-weights"])
    assert args.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.build_saliency(args)


def test_cli_relevancy_on_cpu(monkeypatch):
    """The image path on a tiny image (chefer_et_al config: two tiles)
    through build_saliency + relevancy, with ViT-B/32's 12 blocks (so the
    CLI's num_layers=10 leaves one tail block) at a narrow width."""
    small = ts.ClipConfig(embed_dim=32, vision_width=128, text_width=64,
                          text_heads=1, text_layers=1)
    monkeypatch.setattr(clip_pkg, "VIT_B_32", small)
    args = _cli_args(device="cpu", compute_dtype="float32",
                     saliency_config="chefer_et_al", labels=["vase", "wall"])
    sal = cli.build_saliency(args)
    assert sal.cfg == small
    img = np.random.RandomState(2).randint(0, 255, (48, 64, 3), dtype=np.uint8)
    maps = cli.relevancy(sal, img, args)
    assert maps.shape == (2, 48, 64) and maps.dtype == torch.float16
    assert torch.isfinite(maps).all() and (maps != 0).any()
