"""The port's stage spans (``semantic_abstraction_tpu_torch.trace``) on the
CPU: nothing with the profiler off; under ``torch.profiler`` the buffer and
the chrome trace hold the same spans, nested alike; the relevancy image and
the train step give their stages, and the same numbers as without the
profiler, bit for bit."""
import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from semantic_abstraction_tpu_torch import trace
from semantic_abstraction_tpu_torch.cli import visualize
from semantic_abstraction_tpu_torch.clip import model as cm
from semantic_abstraction_tpu_torch.clip import saliency as cs
from semantic_abstraction_tpu_torch.models import SemAbs3DConfig, init_net
from semantic_abstraction_tpu_torch.runtime import (
    experiment, init_train_state, make_optimizer, make_train_step, ovssc_forward_loss)

CLIP = dict(embed_dim=32, image_resolution=64, vision_layers=3, vision_width=64,
            vision_patch_size=16, context_length=77, vocab_size=49408, text_width=32,
            text_heads=1, text_layers=1)
LABELS = ["chair", "table", "sofa"]
IMAGE_LEAVES = {"sa.relevancy." + s for s in
                ("text", "images", "plan", "tiles", "head", "tail", "canvas")}
TAIL_LEAVES = ["sa.relevancy.tail." + s for s in ("forward", "backward", "cam")]
STEP_LEAVES = ["sa.train.forward", "sa.train.backward", "sa.train.clip",
               "sa.train.optimizer"]


@pytest.fixture(autouse=True)
def empty_buffer():
    trace.clear()
    yield
    trace.clear()


def profiled(fn):
    """fn() under the CPU profiler -> (its result, the chrome trace's events)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def annotations(prof, tmp_path):
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation"
            and e["name"].startswith("sa.")]


def nested(n):
    with trace.span(f"sa.test.{n}"):
        if n:
            nested(n - 1)


def test_off_records_nothing_and_enters_no_annotation(monkeypatch, tmp_path):
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name))
    assert not torch.autograd._profiler_enabled()
    nested(3)
    d = {}
    with trace.timed("sa.test.timed", d, "t"):
        pass
    assert trace.records() == [] and entered == [] and trace.dropped() == 0
    assert d["t"] >= 0.0
    monkeypatch.undo()
    _, prof = profiled(lambda: None)
    assert annotations(prof, tmp_path) == []


def test_chrome_trace_holds_the_buffer_nested_alike(tmp_path):
    _, prof = profiled(lambda: [nested(2), nested(1)])
    recs = trace.records()
    assert [r.name for r in recs] == ["sa.test.2", "sa.test.1", "sa.test.0",
                                      "sa.test.1", "sa.test.0"]
    assert [None if r.parent is None else recs.index(r.parent) for r in recs] == \
        [None, 0, 1, None, 3]
    for r in recs:
        assert r.end_ns >= r.begin_ns and r.stream_ms == r.host_ms >= 0.0
        if r.parent is not None:
            assert r.parent.begin_ns <= r.begin_ns and r.end_ns <= r.parent.end_ns
    events = sorted(annotations(prof, tmp_path), key=lambda e: float(e["ts"]))
    assert [e["name"] for e in events] == [r.name for r in recs]
    for e, r in zip(events, recs):
        if r.parent is not None:
            p = events[recs.index(r.parent)]
            assert float(p["ts"]) <= float(e["ts"])
            assert float(e["ts"]) + float(e["dur"]) <= float(p["ts"]) + float(p["dur"])


def test_the_buffer_keeps_its_cap_and_counts_the_rest(monkeypatch, tmp_path):
    monkeypatch.setattr(trace, "CAP", 3)
    _, prof = profiled(lambda: nested(4))
    assert [r.name for r in trace.records()] == ["sa.test.4", "sa.test.3", "sa.test.2"]
    assert trace.dropped() == 2
    assert len(annotations(prof, tmp_path)) == 5
    trace.clear()
    assert trace.records() == [] and trace.dropped() == 0


def test_timed_adds_seconds_and_is_a_span():
    d = {"t": 1.0}

    def run():
        for _ in range(2):
            with trace.timed("sa.test.t", d, "t"):
                torch.ones(4).sum()

    profiled(run)
    assert d["t"] > 1.0
    assert [r.name for r in trace.records()] == ["sa.test.t"] * 2
    with pytest.raises(KeyError):
        with trace.timed("sa.test.raises", d, "u"):
            raise KeyError
    assert "u" not in d


def test_visualize_stages_are_spans():
    timings = {}
    stages = visualize._Stages(torch.device("cpu"), timings)
    plain = visualize._Stages(torch.device("cpu"), None)

    def run():
        with stages("unet"):
            torch.ones(4).sum()
        with plain("sweep"):
            torch.ones(4).sum()

    profiled(run)
    assert [r.name for r in trace.records()] == ["sa.visualize.unet", "sa.visualize.sweep"]
    assert set(timings) == {"unet"}


def test_loop_stages_are_spans_and_keep_their_host_seconds():
    batch = {"input_xyz_pts": np.zeros((1, 8, 3), np.float32)}

    def step(state, db):
        assert db["input_xyz_pts"].shape == (1, 8, 3)
        return state, {"loss": torch.tensor(0.5), "grad_norm": torch.tensor(1.0)}

    def loader():  # a generator: the loop closes its iterator
        yield batch
        yield batch
        time.sleep(0.2)  # the wait that finds the loader exhausted

    (_, steps, record), _ = profiled(lambda: experiment._train_epoch(
        None, step, loader(), "ovssc", "cpu", None, None, 0, 0, experiment._Profile()))
    assert steps == 2 and record["steps"] == 2
    assert 0.0 <= record["loader_wait_s"] < 0.2 and record["device_batch_s"] > 0.0
    assert [r.name for r in trace.records()] == [
        "sa.loop.wait", "sa.loop.device_batch"] * 2 + ["sa.loop.wait"]


def expected_counts(img, config, n_labels, tile_batch, prompt_batch, extra):
    """Each leaf's spans in one image, from the crop plan and the chunking."""
    h, w = img.shape[:2]
    live = [p for p in cs.tile_plan((h, w), config.crops, 1 + config.augmentations)
            if p.offsets.shape[0]]
    flips = 2 if config.horizontal_flipping else 1
    chunks = 0
    for p in live:
        n = (1 + config.augmentations) * p.offsets.shape[0]
        chunks += -(-n // cs._chunk_size(n, tile_batch))
    label_chunks = -(-(n_labels + extra) // prompt_batch)
    return {"sa.relevancy.text": 1 + (extra > 0), "sa.relevancy.images": 1,
            "sa.relevancy.plan": 1 + len(live), "sa.relevancy.tiles": chunks * flips,
            "sa.relevancy.head": chunks * flips * label_chunks,
            "sa.relevancy.tail": chunks * flips * (label_chunks + (label_chunks > 1)),
            "sa.relevancy.canvas": chunks * (flips - 1) + len(live) + 1 + (extra > 0)}


@pytest.mark.parametrize("num_layers,flip,distractors", [
    (1, True, ()),             # one tail block: the closed form
    (0, False, ("lamp",)),     # two tail blocks: the general path, a distractor
])
def test_relevancy_image_spans_and_maps_equal(num_layers, flip, distractors):
    cfg = cm.ClipConfig(**CLIP)
    sal = cs.ClipSaliency(cm.init_clip_params(0, cfg, device="cpu"), cfg,
                          tile_batch_size=5, prompt_batch_size=2, num_layers=num_layers)
    img = np.random.RandomState(1).randint(0, 255, (48, 80, 3), dtype=np.uint8)
    config = cs.SaliencyConfig(crops=(cs.CropSpec(48, 16), cs.CropSpec(32, 16),
                                      cs.CropSpec(96, 8)),
                               horizontal_flipping=flip, augmentations=1)

    def run():
        return sal.get_clip_saliency(img, LABELS, ["a {}"], config,
                                     generator=torch.Generator().manual_seed(3),
                                     distractor_labels=distractors)[0]

    off = run()
    assert trace.records() == []
    on, _ = profiled(run)
    assert torch.equal(on, off)
    recs = trace.records()
    image = [r for r in recs if r.name == "sa.relevancy.image"]
    assert len(image) == 1 and image[0].parent is None
    leaves = [r for r in recs if r.parent is image[0]]
    counts = {n: sum(r.name == n for r in leaves) for n in IMAGE_LEAVES}
    assert counts == expected_counts(img, config, len(LABELS), 5, 2, len(distractors))
    # the rest sit in the tail spans: the general path's three in each of its
    # gradcam calls, the closed form's none
    inner = [[r.name for r in recs if r.parent is t]
             for t in leaves if t.name == "sa.relevancy.tail"]
    assert len(recs) == 1 + len(leaves) + sum(map(len, inner))
    general = [n for n in inner if n]
    assert general == [TAIL_LEAVES] * (counts["sa.relevancy.head"] if num_layers == 0 else 0)
    assert sum(r.host_ms for r in leaves) <= image[0].host_ms


def test_train_step_spans_and_parameters_equal():
    cfg = SemAbs3DConfig(voxel_shape=(16, 16, 16), unet_num_channels=8, unet_f_maps=4,
                         unet_num_groups=2, unet_num_levels=3,
                         pts_feat_extractor_hidden_dim=16)
    rs = np.random.RandomState(0)
    b, p, n, m = 1, 2, 64, 128
    q = rs.uniform(-1.2, 2.1, (b, p, m, 3)).astype(np.float32)
    batch = {k: torch.as_tensor(v) for k, v in {
        "input_xyz_pts": rs.uniform(-1, 1.9, (b, n, 3)).astype(np.float32),
        "input_feature_pts": rs.randn(b, p, n, 1).astype(np.float32),
        "output_xyz_pts": q,
        "output_label_pts": rs.randint(0, 2, (b, p, m)).astype(np.uint8),
        "out_of_bounds_pts": rs.rand(b, p, m) < 0.1,
        "out_of_frustum_pts_mask": rs.rand(b, p, m) < 0.05,
        "padding_mask": np.zeros((b, p), np.bool_)}.items()}

    def two_steps():
        tx = make_optimizer(num_training_steps=10)
        state = init_train_state(init_net(0, cfg, device="cpu"), tx)
        step = make_train_step(ovssc_forward_loss, cfg, tx, compute_dtype=torch.float32)
        for _ in range(2):
            state, stats = step(state, batch)
        return {k: v.detach().clone() for k, v in state.model.state_dict().items()}, stats

    (off, s_off) = two_steps()
    assert trace.records() == []
    (on, s_on), _ = profiled(two_steps)
    assert off.keys() == on.keys() and all(torch.equal(off[k], on[k]) for k in off)
    assert all(torch.equal(s_off[k], s_on[k]) for k in s_off)
    recs = trace.records()
    steps = [r for r in recs if r.name == "sa.train.step"]
    assert len(steps) == 2
    for s in steps:
        assert [r.name for r in recs if r.parent is s] == STEP_LEAVES
    assert len(recs) == 2 * (1 + len(STEP_LEAVES))
