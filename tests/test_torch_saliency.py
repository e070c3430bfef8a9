"""The port's whole ``get_clip_saliency`` against the JAX package's on the
CPU (small ViT: width 128 = 2 heads of 64, 2 blocks, num_layers=0 so the
general gradcam path runs; jitter off, since the two frameworks' random
draws differ and the jitter ops are held separately).

Tolerance: the maps are float16; the f32 pipelines agree to ~1e-6, so the
maps may differ by the f16 rounding of that: 2 ulp of the largest value
(max|diff| <= 2**-9 * max|map|)."""
import jax
import numpy as np
import pytest
import torch

from semantic_abstraction_tpu.clip import model as jm
from semantic_abstraction_tpu.clip import saliency as js
from semantic_abstraction_tpu_torch.clip import model as tm
from semantic_abstraction_tpu_torch.clip import saliency as ts

SMALL = dict(embed_dim=32, image_resolution=224, vision_layers=2,
             vision_width=128, vision_patch_size=32, context_length=77,
             vocab_size=49408, text_width=64, text_heads=2, text_layers=1)
LABELS = ["chair", "table", "sofa"]


@pytest.fixture(scope="module")
def extractors():
    params = jm.init_clip_params(jax.random.PRNGKey(0), jm.ClipConfig(**SMALL))
    model = tm.init_clip_params(0, tm.ClipConfig(**SMALL), device="cpu")
    sj = js.ClipSaliency(params, jm.ClipConfig(**SMALL), tile_batch_size=8,
                         num_layers=0)
    st = ts.ClipSaliency(model, tm.ClipConfig(**SMALL), tile_batch_size=8,
                         num_layers=0)
    img = np.random.RandomState(3).randint(0, 255, (64, 96, 3), dtype=np.uint8)
    return sj, st, img


def _compare(extractors, crops, flip, distractors=()):
    sj, st, img = extractors
    cj = js.SaliencyConfig(crops=tuple(js.CropSpec(*c) for c in crops),
                           horizontal_flipping=flip, augmentations=0)
    ct = ts.SaliencyConfig(crops=tuple(ts.CropSpec(*c) for c in crops),
                           horizontal_flipping=flip, augmentations=0)
    mj, fj = sj.get_clip_saliency(img, LABELS, ["a photo of a {}"], cj,
                                  distractor_labels=distractors)
    mt, ft = st.get_clip_saliency(img, LABELS, ["a photo of a {}"], ct,
                                  distractor_labels=distractors)
    assert mt.shape == (3, 64, 96) and mt.dtype == torch.float16
    mj = np.asarray(mj, np.float32)
    assert np.abs(mj).max() > 0
    diff = np.abs(mt.float().numpy() - mj).max()
    assert diff <= 2.0**-9 * np.abs(mj).max(), diff
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("flip", [True, False])
def test_get_clip_saliency_matches_jax(extractors, flip):
    _compare(extractors, [(64, 16), (32, 8)], flip)


def test_distractors_match_jax(extractors):
    _compare(extractors, [(64, 16), (32, 8)], True, distractors=("lamp", "sofa"))


def test_dead_crop_and_duplicate_tile_size_match_jax(extractors):
    """A crop too big for the image still counts in the divisor, and two
    crops of one tile size share one canvas and count."""
    _compare(extractors, [(64, 16), (32, 8), (32, 16), (128, 8)], False)


def test_no_live_crop_raises(extractors):
    _, st, img = extractors
    config = ts.SaliencyConfig(crops=(ts.CropSpec(128, 8),), augmentations=0)
    with pytest.raises(ValueError, match="no crop"):
        st.get_clip_saliency(img, LABELS, config=config)


def test_jitter_draws_follow_the_generator(extractors):
    """Seeded generators give the same maps; another seed other maps."""
    _, st, img = extractors
    config = ts.SaliencyConfig(crops=(ts.CropSpec(64, 32),), augmentations=2,
                               horizontal_flipping=False)

    def run(seed):
        return st.get_clip_saliency(img, LABELS[:1], config=config,
                                    generator=torch.Generator().manual_seed(seed))[0]

    torch.testing.assert_close(run(5), run(5), atol=0, rtol=0)
    assert not torch.equal(run(5), run(6))
