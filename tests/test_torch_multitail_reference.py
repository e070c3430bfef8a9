"""The general gradcam tail (ViT-L/14's path: several blocks past
``num_layers``) against the benchmark's plain reference on the CPU, and
the benchmark's counts and path module for the ``vitl14-relevancy-ours`` cell.

- The port's ``ClipSaliency`` ("ours", float32) on a tiny ViT with three
  tail blocks, two heads of 64 and T = 17 against
  ``benchmark/reference/clip_multitail.py`` on the same seeded weights,
  image, labels and jitter seed; the port with one tail block's
  accumulation left out does not pass.
- The general path's FLOP count against ``FlopCounterMode`` over the
  reference's ``tile_relevancy``, and K2's bound at PERF.md's shapes.
- The tail's three spans under a profiler (general path only).
- The cell's path module through the harness at a tiny size: correct, and its
  control and fault not correct.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils.flop_counter import FlopCounterMode

from benchmark import counts, counts_multitail, harness, weights
from benchmark.reference import clip as ref_clip
from benchmark.reference import clip_multitail as ref_multitail
from benchmark.tests import tiny
from semantic_abstraction_tpu_torch import trace
from semantic_abstraction_tpu_torch.clip import ClipSaliency, saliency_configs
from semantic_abstraction_tpu_torch.clip import relevancy as rel
from semantic_abstraction_tpu_torch.clip.convert import from_openai_state_dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXT = dict(embed_dim=32, context_length=77, vocab_size=49408, text_width=64, text_heads=1,
            text_layers=1)
# 14 blocks at num_layers = 10: three tail blocks; width 128: two heads of 64;
# 64 px at patch 16: T = 17, so the positional embedding is interpolated
THREE_TAIL = dict(image_resolution=64, vision_layers=14, vision_width=128,
                  vision_patch_size=16, **TEXT)
LABELS, PROMPT = ["vase", "wall"], "a photograph of a {} in a home."
# the port's maps are float16: each element within 2^-11 of its size
F16_REL = 1e-3


@pytest.fixture(scope="module")
def three_tail():
    torch.set_num_threads(2)
    sd = weights.clip_state_dict(THREE_TAIL, 3, "cpu")
    model, cfg = from_openai_state_dict(sd, device="cpu")
    img = np.random.default_rng(1).integers(0, 256, (32, 40, 3), dtype=np.uint8)
    ref = ref_multitail.relevancy(sd, THREE_TAIL, img, LABELS, PROMPT, "ours", 5)
    return ClipSaliency(model, cfg, compute_dtype=torch.float32), img, ref


def port_maps(sal, img):
    maps, _ = sal.get_clip_saliency(img, LABELS, [PROMPT], saliency_configs["ours"](img.shape[0]),
                                    generator=torch.Generator().manual_seed(5))
    return maps


def worst_gap(maps, ref):
    return max(float((maps[k].float() - ref[k]).norm() / ref[k].norm()) for k in range(len(ref)))


def test_general_tail_saliency_matches_the_reference(three_tail):
    sal, img, ref = three_tail
    assert worst_gap(port_maps(sal, img), ref) < F16_REL


@pytest.mark.parametrize("left_out", [0, 1, 2])
def test_a_tail_block_left_out_fails_the_reference(three_tail, monkeypatch, left_out):
    """The control: one tail block's cam not accumulated reads 0.29-0.45."""
    sal, img, ref = three_tail
    real, calls = rel.cam_accumulate, []

    def cam(grad, attn, r_mat, positive):
        calls.append(None)
        if (len(calls) - 1) % 3 == left_out:
            return r_mat
        return real(grad, attn, r_mat, positive)

    monkeypatch.setattr(rel, "cam_accumulate", cam)
    assert worst_gap(port_maps(sal, img), ref) > 100 * F16_REL


def test_the_multitail_reference_is_clip_py_at_one_tail_block_and_50_tokens():
    """Where ``clip.py`` is exact (one tail block, T = 50) the two agree;
    the f32 sums differ in order only."""
    c = dict(THREE_TAIL, image_resolution=112, vision_layers=12)
    sd = weights.clip_state_dict(c, 4, "cpu")
    g = torch.Generator().manual_seed(0)
    pixels = torch.randn(2, 3, 112, 112, generator=g)
    zw = torch.randn(32, 3, generator=g)
    zw = zw / zw.norm(dim=0)
    a = ref_multitail.tile_relevancy(sd, c, pixels, zw, 10)
    b = ref_clip.tile_relevancy(sd, c, pixels, zw, 10)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("spec,labels", [(THREE_TAIL, 3), (dict(THREE_TAIL, vision_layers=13), 2)])
def test_tile_flops_match_the_flop_counter(spec, labels):
    """Within the label logits' products, which the count leaves out (the
    port feeds each label's cotangent to the features directly): the
    forward (N, E) @ (E, L) and one (N, L) @ (L, E) a label's backward."""
    sd = weights.clip_state_dict(spec, 5, "cpu")
    g = torch.Generator().manual_seed(1)
    zw = torch.randn(spec["embed_dim"], labels, generator=g)
    pixels = torch.randn(1, 3, spec["image_resolution"], spec["image_resolution"], generator=g)
    with FlopCounterMode(display=False) as fc:
        ref_multitail.tile_relevancy(sd, spec, pixels, zw / zw.norm(dim=0), 10)
    counted = fc.get_total_flops()
    mine = counts_multitail.relevancy_tile_flops(spec, labels)
    assert 0 <= counted - mine <= 2 * spec["embed_dim"] * labels * (labels + 1)


def test_vit_l14_image_flops():
    """ViT-L/14 at 480x640, 9 labels: 74.1 GFLOP of head and 87.6 of tail a
    tile, 89.6 a label back; 3,120 tiles."""
    c = dict(embed_dim=768, image_resolution=224, vision_layers=24, vision_width=1024,
             vision_patch_size=14, context_length=77, vocab_size=49408, text_width=768,
             text_heads=12, text_layers=12)
    tile = counts_multitail.relevancy_tile_flops(c, 9)
    assert 967.5e9 < tile < 968.0e9
    image = counts_multitail.relevancy_image_flops(c, 480, 640, "ours", 9)
    assert image == counts.text_flops(c, 9) + 3120 * tile


@pytest.mark.parametrize("shape,dtype,bound_ms", [
    ((9, 48, 16, 257), "bfloat16", 0.3710),
    ((9, 48, 16, 257), "float32", 0.6738),
    ((9, 48, 12, 50), "bfloat16", 0.01118),
    ((9, 48, 12, 50), "float32", 0.01977),
])
def test_cam_bound_is_perf_md_s(shape, dtype, bound_ms):
    """PERF.md's K2 rows, to the four digits it gives: bytes bound all four."""
    got = counts_multitail.cam_bound_s(*shape, dtype) * 1e3
    assert float(f"{got:.4g}") == bound_ms, got


@pytest.mark.parametrize("layers,leaves", [
    (12, []),  # one tail block: the closed form opens no span of its own
    (14, ["sa.relevancy.tail.forward", "sa.relevancy.tail.backward", "sa.relevancy.tail.cam"]),
])
def test_the_general_tail_opens_three_spans(layers, leaves):
    spec = dict(THREE_TAIL, vision_layers=layers)
    model, cfg = from_openai_state_dict(weights.clip_state_dict(spec, 6, "cpu"), device="cpu")
    model.requires_grad_(False)
    g = torch.Generator().manual_seed(2)
    tiles = torch.randn(2, 3, 64, 64, generator=g)
    zw = torch.randn(32, 2, generator=g)
    trace.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            out = rel.gradcam(model.visual, tiles, zw, cfg)
        recs = trace.records()
    finally:
        trace.clear()
    tail = [r for r in recs if r.name == "sa.relevancy.tail"]
    assert len(tail) == 1 and tail[0].parent is None
    assert [r.name for r in recs if r.parent is tail[0]] == leaves
    assert torch.equal(out, rel.gradcam(model.visual, tiles, zw, cfg))


# -- the cell's path module through the harness, at a tiny size -------------

TINY_L14 = dict(image_resolution=64, vision_layers=13, vision_width=128, vision_patch_size=16,
                embed_dim=32, text_width=64, text_heads=1, text_layers=1,
                compute_dtype="float32")
TINY_TRAFFIC = dict(height=48, width=64, labels=["vase", "wall"],
                    saliency_config="chefer_et_al", tile_batch_size=4)
CELL = "vitl14-relevancy-ours"


@pytest.fixture(scope="module")
def tiny_bench(tmp_path_factory):
    bench = tiny.make_copy(str(tmp_path_factory.mktemp("bench")))
    tiny.edit_json(os.path.join(bench, "configs", "clip-vit-l14.json"), TINY_L14)
    tiny.edit_json(os.path.join(bench, "traffic", "images-480x640-9labels-l14.json"),
                   TINY_TRAFFIC)
    return bench


def test_the_cell_runs_correct_and_reads_its_tail(tiny_bench):
    """Traced on the CPU: correct; the tail's backward share is read, K2's
    roofline is not (no device kernels)."""
    trace.clear()
    try:
        line = tiny.run_cell(tiny_bench, CELL, trace=True)
    finally:
        trace.clear()
    assert line["correct"], line["checks"]
    assert 0.0 < line["metrics"]["tail_backward_stream_pct.relevancy"]["value"] < 100.0
    assert 0.0 < line["metrics"]["tail_stream_pct.relevancy"]["value"] < 100.0
    assert "cam_accumulate_roofline.relevancy" not in line["metrics"]


def test_the_cell_with_an_altered_answer_is_not_correct(tiny_bench, monkeypatch):
    from semantic_abstraction_tpu_torch.cli import generate_relevancy as gr

    real = gr.relevancy
    monkeypatch.setattr(gr, "relevancy",
                        lambda sal, img, args: real(sal, img, args)[[1, 1]])
    line = tiny.run_cell(tiny_bench, CELL)
    assert not line["correct"], line["checks"]


def test_the_cell_s_control_and_fault_are_judged_not_correct(tiny_bench):
    torch.set_num_threads(2)
    manifest = harness.Manifest(tiny_bench)
    run = harness.Run(manifest, CELL, 11, 0.5, False, device="cpu")
    path = harness.load_module(os.path.join(tiny_bench, "paths", "relevancy_multitail.py"),
                                 "path_relevancy_multitail")
    for name, numbers in path.control(run).items():
        judged = harness.Run(manifest, CELL, 11, 0.5, False, device="cpu")
        assert not judged.judge(numbers), (name, numbers)


def test_the_multitail_reference_loads_nothing_of_the_program():
    code = (f"import json, sys; sys.path.insert(0, {ROOT!r})\n"
            "import benchmark.reference.clip_multitail, benchmark.counts_multitail\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=ROOT, timeout=300)
    found = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not found & {"jax", "jaxlib", "flax", "semantic_abstraction_tpu",
                        "semantic_abstraction_tpu_torch"}, found
