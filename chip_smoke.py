"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):

1. build every CUDA kernel of the port from ``ops/csrc`` (one nvcc each,
   started together) and report the build time;
2. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes, in f32 and bf16, and time kernel, plain version,
   the PyTorch library call (a yardstick only) and the bound;
3. run a small ``ClipSaliency`` on the card and on the CPU with the same
   weights and jitter draws; the maps must agree;
4. run the main path at full width: the ``image`` command's
   ``build_saliency`` + ``relevancy`` (ViT-B/32, random weights, bf16,
   "ours" crops on a seeded 480x640 image, the 9 headline labels), one
   warm-up image, then timed images; the kernels' launch counts are set to
   0 just before and read just after;
5. profile one more image with ``torch.profiler`` (device time by kernel).

Prints a ``{"kernels": [...]}`` line, the card's name and power limit, and
as the last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, dense bf16
# tensor-core and f32 (non-tensor) FLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HEADLINE_LABELS = [
    "basketball jersey", "nintendo switch", "television", "ping pong table",
    "vase", "fireplace", "abstract painting of a vespa", "carpet", "wall",
]
TIMED_IMAGES = 3


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 100) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch

    for _ in range(5):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def mha_bound(b: int, t: int, w: int, heads: int, dtype: str):
    """(least ms, "bytes" or "operations") for fused MHA: q, k, v read once
    and out written once at the HBM rate, or 4*B*H*T*T*hd flops at the
    dtype's peak, whichever is larger."""
    elt = 2 if dtype == "bfloat16" else 4
    bytes_s = 4 * b * t * w * elt / HBM_BYTES_PER_S
    flops_s = 4 * b * heads * t * t * (w // heads) / PEAK_FLOPS[dtype]
    return 1e3 * max(bytes_s, flops_s), ("bytes" if bytes_s >= flops_s else "operations")


def phase_kernel(card: str):
    """fused_mha vs mha_reference at the main path's shapes."""
    import torch
    import torch.nn.functional as F

    from semantic_abstraction_tpu_torch.ops.fused_mha import fused_mha, mha_reference

    t, w, heads = 50, 768, 12
    # tile chunks of the main path at tile_batch_size 32 ("ours" at
    # 480x640: 12, 45, 42, 48 rows) and the batches 32, 64, 90
    batches = (12, 32, 42, 45, 48, 64, 90)
    # f32: sums in another order than cuBLAS; bf16: the output and the probs
    # round to bf16 (1 ulp = 2^-8 relative), so 2 ulp of |out| <= 2
    tols = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 1e-2)}
    rows = []
    g = torch.Generator(device="cuda").manual_seed(0)
    for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        atol, rtol = tols[dname]
        for b in batches:
            qkv = torch.randn(b, t, 3 * w, device="cuda", generator=g).to(dtype)
            q, k, v = qkv.split(w, dim=-1)  # strided views, as on the path
            out = fused_mha(q, k, v, heads)
            ref = mha_reference(q, k, v, heads)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            ok = torch.allclose(out.float(), ref.float(), atol=atol, rtol=rtol)
            if not ok:
                raise AssertionError(f"fused_mha {dname} B={b}: max err {err}")
            qh, kh, vh = (a.reshape(b, t, heads, w // heads).transpose(1, 2)
                          for a in (q, k, v))
            row = dict(dtype=dname, B=b, max_abs_err=err,
                       ms=time_ms(lambda: fused_mha(q, k, v, heads)),
                       plain_ms=time_ms(lambda: mha_reference(q, k, v, heads)),
                       library_ms=time_ms(
                           lambda: F.scaled_dot_product_attention(qh, kh, vh)),
                       )
            row["bound_ms"], row["bound_by"] = mha_bound(b, t, w, heads, dname)
            rows.append(row)
            print(f"[kernel] fused_mha {json.dumps(row)} card={card}", flush=True)
    return rows


def small_config():
    from semantic_abstraction_tpu_torch.clip import ClipConfig

    return ClipConfig(embed_dim=32, image_resolution=224, vision_layers=3,
                      vision_width=128, vision_patch_size=32, context_length=77,
                      vocab_size=49408, text_width=64, text_heads=2, text_layers=1)


def phase_small(card: str):
    """Small ClipSaliency, card vs CPU: same weights, same jitter draws, f32
    at full precision (TF32 off). Single-tail gradcam (num_layers=1 of 3
    blocks), so the head blocks run the fused kernel on the card."""
    import torch

    from semantic_abstraction_tpu_torch.clip import (
        ClipSaliency, CropSpec, SaliencyConfig, init_clip_params)

    cfg = small_config()
    config = SaliencyConfig(crops=(CropSpec(64, 16), CropSpec(32, 8)),
                            horizontal_flipping=True, augmentations=1)
    img = np.random.RandomState(3).randint(0, 255, (64, 96, 3), dtype=np.uint8)
    maps = {}
    for dev in ("cpu", "cuda"):
        sal = ClipSaliency(init_clip_params(0, cfg, device=dev), cfg,
                           tile_batch_size=8, num_layers=1)
        m, _ = sal.get_clip_saliency(img, ["chair", "table", "sofa"],
                                     ["a photo of a {}"], config,
                                     generator=torch.Generator().manual_seed(1))
        maps[dev] = m.float().cpu()
    diff = (maps["cuda"] - maps["cpu"]).abs().max().item()
    scale = maps["cpu"].abs().max().item()
    # f16 maps of f32 pipelines that differ in summation order: allow 4 f16
    # ulp of the largest value
    tol = 2.0**-8 * scale
    print(f"[small] card vs cpu max|diff| {diff} (tol {tol}, max|map| {scale}) "
          f"card={card}", flush=True)
    if not (scale > 0 and diff <= tol and torch.isfinite(maps["cuda"]).all()):
        raise AssertionError(f"small port: card and CPU disagree ({diff} > {tol})")
    return diff


def phase_main(card: str):
    """The image path at full width through the CLI's entry points."""
    import torch

    from semantic_abstraction_tpu_torch.cli import generate_relevancy as cli
    from semantic_abstraction_tpu_torch.ops.fused_mha import fused_mha

    args = cli.parser().parse_args(
        ["image", "--random-weights", "--labels", *HEADLINE_LABELS])
    t0 = time.perf_counter()
    sal = cli.build_saliency(args)
    print(f"[main] weights built in {time.perf_counter() - t0:.1f} s", flush=True)
    rs = np.random.RandomState(args.seed)
    img = rs.randint(0, 255, (480, 640, 3), dtype=np.uint8)

    t0 = time.perf_counter()
    maps = cli.relevancy(sal, img, args)
    torch.cuda.synchronize()
    print(f"[main] warm-up image {time.perf_counter() - t0:.3f} s", flush=True)

    fused_mha.launches = 0
    times = []
    for i in range(TIMED_IMAGES):
        args.seed = i + 1
        t0 = time.perf_counter()
        maps = cli.relevancy(sal, img, args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {"fused_mha": fused_mha.launches}

    if maps.shape != (9, 480, 640) or maps.dtype != torch.float16:
        raise AssertionError(f"maps {tuple(maps.shape)} {maps.dtype}")
    if not torch.isfinite(maps).all() or not (maps != 0).any():
        raise AssertionError("maps are not finite or all zero")
    if launches["fused_mha"] <= 0:
        raise AssertionError("the main path launched no fused_mha kernel")
    maps_per_s = 9 * TIMED_IMAGES / sum(times)
    print(f"[main] image seconds {times} maps/s {maps_per_s} launches "
          f"{launches} per image {launches['fused_mha'] / TIMED_IMAGES} "
          f"peak mem GB {torch.cuda.max_memory_allocated() / 1e9:.2f} "
          f"card={card}", flush=True)
    return sal, img, args, launches, sum(times) / len(times)


def phase_profile(card: str, sal, img, args, image_s: float):
    """Device time by kernel over one image (torch.profiler). The busy
    share is given against the profiled wall and against ``image_s``, the
    mean unprofiled image time of phase 4 (the profiler slows the host)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from semantic_abstraction_tpu_torch.cli import generate_relevancy as cli

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        cli.relevancy(sal, img, args)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    attr = "self_device_time_total"
    total_us = sum(getattr(e, attr) for e in events)
    if total_us <= 0:
        print(f"[profile] device time not measured (no CUDA events) card={card}")
        return
    busy = total_us / 1e6
    print(f"[profile] wall {wall:.3f} s (profiled), device busy {busy:.3f} s = "
          f"{100 * busy / wall:.1f}% of the profiled wall, "
          f"{100 * busy / image_s:.1f}% of the unprofiled image time "
          f"{image_s:.3f} s; {sum(e.count for e in events)} device kernels "
          f"of {len(events)} names card={card}")
    for e in sorted(events, key=lambda e: -getattr(e, attr))[:12]:
        us = getattr(e, attr)
        print(f"[profile]   {100 * us / total_us:5.1f}%  {us / 1e3:9.2f} ms  "
              f"x{e.count:<6d} {e.key[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    # the port's package, from this checkout
    from semantic_abstraction_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} card={card}", flush=True)

    t0 = time.perf_counter()
    _build.build()
    print(f"[build] {list(_build.KERNELS)} built in "
          f"{time.perf_counter() - t0:.1f} s card={card}", flush=True)

    rows = phase_kernel(card)
    phase_small(card)
    sal, img, args, launches, image_s = phase_main(card)
    phase_profile(card, sal, img, args, image_s)

    # the kernels line: bf16 at the main path's dominant chunk (48 rows);
    # max_abs_err over every bf16 main-path shape compared above
    main = next(r for r in rows if r["dtype"] == "bfloat16" and r["B"] == 48)
    err = max(r["max_abs_err"] for r in rows
              if r["dtype"] == "bfloat16" and r["B"] in (12, 42, 45, 48))
    kernels = [{
        "name": "fused_mha", "route": "cuda",
        "source": "semantic_abstraction_tpu_torch/ops/csrc/fused_mha.cu",
        "replaces": "semantic_abstraction_tpu/ops/pallas_kernels.py:103",
        "launches": launches["fused_mha"], "max_abs_err": err,
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
