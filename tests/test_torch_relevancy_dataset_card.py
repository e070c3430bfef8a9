"""The dataset writer's pipelined loop on the card.

``pipelined`` copies scene i's tensors to pinned host memory on a side
stream while scene i + 1 is dispatched, and must hand ``write`` scene i's
arrays only after that copy has completed. Every test here is marked
``gpu`` and skips without a CUDA card. The file imports neither JAX nor the
JAX package:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_relevancy_dataset_card.py

Tolerance: the pipelined maps against a synchronous extraction of the same
scene and seed within 2 float16 ulp of the largest map value (the
tolerance of the CPU parity tests); the synthetic tensors exactly.
"""
import numpy as np
import pytest
import torch

from semantic_abstraction_tpu_torch.cli import generate_relevancy as cli
from semantic_abstraction_tpu_torch.clip import ClipConfig, ClipSaliency, init_clip_params

SMALL = dict(embed_dim=32, image_resolution=224, vision_layers=2, vision_width=128,
             vision_patch_size=32, context_length=77, vocab_size=49408, text_width=64,
             text_heads=2, text_layers=1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the pipeline's copies and events are the card's")
    return torch.device("cuda")


@pytest.mark.gpu
def test_pipelined_scenes_equal_a_synchronous_run(cuda):
    """3 small scenes through the writer's extraction: the sink sees each
    once, in order, equal to a synchronous run, and every copy is timed."""
    cfg = ClipConfig(**SMALL)
    sal = ClipSaliency(init_clip_params(0, cfg, device=cuda), cfg,
                       compute_dtype=torch.bfloat16, num_layers=0)
    rs = np.random.RandomState(0)
    items = [(si, ["chair", "table", "sofa", f"mug on a shelf {si}"],
              rs.randint(0, 255, (240, 320, 3), np.uint8)) for si in range(3)]

    def extract(item):
        si, labels, img = item
        return cli.extract_scene(sal, img, labels, cli.THOR_PROMPT, "ours", si, (120, 160))

    want = [[t.cpu().numpy() for t in extract(item)] for item in items]
    seen, stats = [], []
    assert cli.pipelined(items, extract, lambda item, arrays: seen.append(
        (item[0], [a.copy() for a in arrays])), cuda, stats=stats) == 0
    assert [si for si, _ in seen] == [0, 1, 2]
    for (si, (maps, feats)), (wmaps, wfeats) in zip(seen, want):
        assert maps.shape == (4, 120, 160) and maps.dtype == np.float16
        tol = 2.0**-9 * np.abs(wmaps.astype(np.float32)).max()
        assert np.abs(maps.astype(np.float32) - wmaps.astype(np.float32)).max() <= tol
        np.testing.assert_allclose(feats, wfeats, atol=1e-6, rtol=0)
    assert [s["overlapped"] is None for s in stats] == [False, False, True]
    assert all(s["copy_ms"] > 0 and s["bytes"] == 4 * 120 * 160 * 2 + 4 * 32 * 4
               for s in stats)


@pytest.mark.gpu
def test_write_never_reads_a_buffer_before_its_copy(cuda):
    """Each item's tensor comes out of a long chain of kernels and is 64 MB:
    a write that read its pinned buffer before the copy's event completed
    would see stale or partial values."""
    def extract(i):
        x = torch.full((4096, 4096), 1.0, device=cuda)
        eye = torch.eye(4096, device=cuda)
        for _ in range(20):
            x = x @ eye  # keeps the device busy, the values exact
        return [x * i, torch.full((7,), float(i), device=cuda)]

    seen = []
    cli.pipelined(range(1, 6), extract, lambda i, arrays: seen.append(
        (i, bool((arrays[0] == i).all()), bool((arrays[1] == i).all()))), cuda)
    assert seen == [(i, True, True) for i in range(1, 6)]
