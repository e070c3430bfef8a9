"""The relevancy path on a ViT with more than one block past ``num_layers``
(ViT-L/14: 13): ``generate_relevancy image`` as a closed loop of one
client, through the general gradcam tail, K1 over the head scan and K2
over every tail block.

Set-up, the window, the traced request and the requests served are
``relevancy.py``'s (its ``build`` and ``serve``). What differs is counted
and checked here: the image's FLOPs and K2's bound from
``counts_multitail``, K1's and K2's launches an image (printed to stderr
from the port's launch counters), and the float32 reference of the kept
requests from ``reference/clip_multitail.py``, whose tail gradient and
positional embedding follow the sources where ``reference/clip.py``'s
single-tail reading stops.
"""
from __future__ import annotations

import sys
import time

from benchmark import counts, counts_multitail, weights
from benchmark.paths.relevancy import WARM_INDEX, build, clip_fields, gap, serve
from benchmark.reference import clip_multitail as ref_clip
from benchmark.reference.semabs3d import tf32_off
from benchmark.traffic import requests


def run(r):
    from semantic_abstraction_tpu_torch.ops.cam_accumulate import cam_accumulate
    from semantic_abstraction_tpu_torch.ops.fused_mha import fused_mha

    t, c = r.traffic, r.config
    sal = build(r)
    request = serve(r, sal)
    request(WARM_INDEX)
    # K1 and K2 count their launches
    kernels = {"fused_mha": fused_mha, "cam_accumulate": cam_accumulate}
    for fn in kernels.values():
        fn.launches = 0
    done = {}

    def one(i):
        r.attempted += 1
        done[i] = request(i)

    n = r.loop(one)
    print("launches an image " + " ".join(f"{k} {fn.launches / n:g}"
                                          for k, fn in kernels.items()),
          file=sys.stderr, flush=True)
    r.e2e["maps_per_s"] = len(t["labels"]) * n / r.window_s
    r.unit_s = r.window_s / n
    fields, labels = clip_fields(c), len(t["labels"])
    shape = (t["height"], t["width"], t["saliency_config"])
    r.facts = dict(
        flops_per_unit=counts_multitail.relevancy_image_flops(fields, *shape, labels),
        mha_bound_s_per_unit=counts.relevancy_mha_bound_s(fields, *shape, c["compute_dtype"]),
        cam_bound_s_per_unit=counts_multitail.relevancy_cam_bound_s(
            fields, *shape, c["compute_dtype"], labels),
        peak_flops=counts.PEAK_FLOPS["bfloat16"])
    if r.trace_on:
        units = t["traced_requests"]
        r.profile(lambda: [request(n + k) for k in range(units)], units)
    keep = requests.sample(r.seed, n, t["checked_requests"])
    maps = {i: done[i] for i in keep}
    done.clear()
    del sal, request
    r.free_program()
    check(r, maps)


def reference(r, sd, index: int, precision: str = "float32"):
    """The reference's (L, H, W) maps of request ``index``."""
    t = r.traffic
    img = requests.image(r.seed, index, t["height"], t["width"])
    return ref_clip.relevancy(sd, clip_fields(r.config), img, list(t["labels"]), t["prompt"],
                              t["saliency_config"], requests.jitter_seed(r.seed, index),
                              precision=precision)


def check(r, maps) -> None:
    """Each kept request's maps against the reference's -> the worst gap
    over the requests, as ``maps_rel_l2``."""
    tf32_off()
    t0 = time.perf_counter()
    sd = weights.clip_state_dict(clip_fields(r.config), r.seed, r.device)
    gaps = [gap(m, reference(r, sd, i)) for i, m in maps.items()]
    r.facts["reference_s"] = time.perf_counter() - t0
    r.check("maps_rel_l2", max(gaps) if gaps else float("inf"))


def control(r) -> dict:
    """Readings that no sound run may give, on this run's first requests:
    the reference in float8 in the program's place ("control"), and maps
    altered where they are made, one label's map from the next label's
    ("answer_altered")."""
    tf32_off()
    sd = weights.clip_state_dict(clip_fields(r.config), r.seed, r.device)
    out = {"control": [], "answer_altered": []}
    for i in range(r.traffic["checked_requests"]):
        f32 = reference(r, sd, i)
        out["control"].append(gap(reference(r, sd, i, "fp8"), f32))
        altered = f32.clone()
        altered[0] = f32[1]
        out["answer_altered"].append(gap(altered, f32))
    return {k: {"maps_rel_l2": max(v)} for k, v in out.items()}
