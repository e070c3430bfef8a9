"""The relevancy path: ``generate_relevancy image`` as a closed loop of one
client.

Set-up builds the extractor the CLI builds for a ``--clip-ckpt`` (the
configuration's weights, drawn from the seed in OpenAI's layout, through
``clip.convert.from_openai_state_dict``) and warms it up on one image of
the cell's size. The window then sends request after request: a new image
and jitter seed from (seed, index) through the CLI's ``relevancy``, done
when its float16 maps are on the host. With ``--trace 1`` one more
request is profiled. After the window a sample of the finished requests,
drawn from the seed, is recomputed by the float32 reference from the same
image, labels and jitter seed.
"""
from __future__ import annotations

import argparse
import time

import torch

from benchmark import counts, weights
from benchmark.reference import clip as ref_clip
from benchmark.reference.semabs3d import tf32_off
from benchmark.traffic import requests

WARM_INDEX = 2**40  # the warm-up request, outside the window's indices


def clip_fields(c: dict) -> dict:
    keys = ("embed_dim", "image_resolution", "vision_layers", "vision_width",
            "vision_patch_size", "context_length", "vocab_size", "text_width",
            "text_heads", "text_layers")
    return {k: c[k] for k in keys}


def build(r):
    from semantic_abstraction_tpu_torch.clip import ClipSaliency
    from semantic_abstraction_tpu_torch.clip.convert import from_openai_state_dict

    c, t = r.config, r.traffic
    sd = weights.clip_state_dict(clip_fields(c), r.seed, r.device)
    model, cfg = from_openai_state_dict(sd, device=r.device)
    del sd
    dtype = torch.bfloat16 if c["compute_dtype"] == "bfloat16" else torch.float32
    return ClipSaliency(model, cfg, compute_dtype=dtype, tile_batch_size=t["tile_batch_size"])


def serve(r, sal):
    """-> request(index) -> (float16 maps on the host)."""
    from semantic_abstraction_tpu_torch.cli.generate_relevancy import relevancy

    t = r.traffic
    args = argparse.Namespace(labels=list(t["labels"]), prompt=t["prompt"],
                              saliency_config=t["saliency_config"], seed=0)

    def request(index: int) -> torch.Tensor:
        img = requests.image(r.seed, index, t["height"], t["width"])
        args.seed = requests.jitter_seed(r.seed, index)
        return relevancy(sal, img, args).cpu()

    return request


def run(r):
    t, c = r.traffic, r.config
    sal = build(r)
    request = serve(r, sal)
    request(WARM_INDEX)
    done = {}

    def one(i):
        r.attempted += 1
        done[i] = request(i)

    n = r.loop(one)
    r.e2e["maps_per_s"] = len(t["labels"]) * n / r.window_s
    r.unit_s = r.window_s / n
    r.facts = dict(
        flops_per_unit=counts.relevancy_image_flops(
            clip_fields(c), t["height"], t["width"], t["saliency_config"], len(t["labels"])),
        mha_bound_s_per_unit=counts.relevancy_mha_bound_s(
            clip_fields(c), t["height"], t["width"], t["saliency_config"], c["compute_dtype"]),
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


def reference(r, sd, index: int, precision: str = "float32") -> torch.Tensor:
    """The reference's (L, H, W) maps of request ``index``."""
    t = r.traffic
    img = requests.image(r.seed, index, t["height"], t["width"])
    return ref_clip.relevancy(sd, clip_fields(r.config), img, list(t["labels"]), t["prompt"],
                              t["saliency_config"], requests.jitter_seed(r.seed, index),
                              precision=precision)


def gap(maps: torch.Tensor, ref: torch.Tensor) -> float:
    """The worst label's |maps - ref| / |ref| (L2 over the map)."""
    maps = maps.to(ref.device).float()
    return max(float((maps[k] - ref[k]).norm() / ref[k].norm().clamp_min(1e-30))
               for k in range(len(ref)))


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
