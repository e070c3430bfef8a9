"""A/B of the GroupNorm moments between another tree of the port and this
checkout, on one card.

    python scripts/torch_ab_channel_moments.py OTHER_TREE [--rounds 1] [--steps 5]

OTHER_TREE is an unpacked tree of the repo (``git archive <commit> | tar
-x -C DIR``). Each round runs the other tree, this one, this one and the
other again, each in a process of its own that imports the port's package
from its tree (and this checkout's ``chip_smoke.py`` for the shapes,
batches and timer). Each process prints one JSON line:

- ``forward_ms``: ``channel_moments`` at the 44 rows of ``chip_smoke.py``
  phase 2 (the 11 UNet GroupNorm shapes at B = 4 and 8, f32 and bf16), as
  device times of CUDA graph replays;
- for the full-width OVSSC and VOOL train steps (phases 7 and 10's
  configs, bf16, random weights from seed 0, their batches from numpy seed
  0): steps/s over ``--steps`` steps after a warm-up step, peak device
  memory over them, and one profiled step: device busy seconds and share of
  the unprofiled step, device kernels, the moments forward's kernels
  (device functions named ``moments_``, but not ``moments_bwd``), and the
  moments backward's device time: every device kernel launched under the
  autograd node ``_ChannelMomentsBackward``.

The card's name and power limit head the output. Exits non-zero when no
card is present.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _device_us(e) -> float:
    return getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)


def _self_device_us(e) -> float:
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)


def profile_step(run, unprofiled_s: float) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    kernels = [e for e in avgs if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(_self_device_us(e) for e in kernels)
    fwd = [e for e in kernels if "moments_" in e.key and "moments_bwd" not in e.key]
    bwd_kernel = [e for e in kernels if "moments_bwd" in e.key]
    # the autograd node (and the engine's evaluate_function around it):
    # the largest is the node with every kernel it launched
    node = [e for e in avgs if e.device_type != torch.autograd.DeviceType.CUDA
            and "ChannelMomentsBackward" in e.key]
    return {
        "device_busy_s": busy_us / 1e6,
        "busy_share_of_unprofiled_step": busy_us / 1e6 / unprofiled_s,
        "device_kernels": sum(e.count for e in kernels),
        "moments_forward_ms": sum(_self_device_us(e) for e in fwd) / 1e3,
        "moments_forward_kernels": sum(e.count for e in fwd),
        "moments_forward_names": sorted({e.key[:60] for e in fwd}),
        "moments_backward_ms": (max(_device_us(e) for e in node) / 1e3) if node else None,
        "moments_backward_node_calls": max((e.count for e in node), default=0),
        "moments_backward_kernel_ms": sum(_self_device_us(e) for e in bwd_kernel) / 1e3,
        "moments_backward_kernels": sum(e.count for e in bwd_kernel),
    }


def run_step(name: str, forward_loss, cfg, batch, steps: int) -> dict:
    import torch

    from semantic_abstraction_tpu_torch.models import init_net
    from semantic_abstraction_tpu_torch.runtime import (
        init_train_state, make_optimizer, make_train_step)

    tx = make_optimizer(num_training_steps=1000)
    state = init_train_state(init_net(0, cfg), tx)
    step = make_train_step(forward_loss, cfg, tx, compute_dtype=torch.bfloat16)
    state, _ = step(state, batch)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, stats = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    out = {"steps_per_s": steps / sum(times), "step_s": times,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "loss": stats["loss"].item(), "grad_norm": stats["grad_norm"].item()}
    out.update(profile_step(lambda: step(state, batch), sum(times) / steps))
    del state, step
    torch.cuda.empty_cache()
    return out


def worker(tree: str, steps: int) -> dict:
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import semantic_abstraction_tpu_torch
    from semantic_abstraction_tpu_torch.models import SemAbs3DConfig, SemAbsVOOLConfig
    from semantic_abstraction_tpu_torch.ops.channel_moments import channel_moments
    from semantic_abstraction_tpu_torch.runtime import ovssc_forward_loss, vool_forward_loss

    if not os.path.abspath(semantic_abstraction_tpu_torch.__file__).startswith(
            os.path.abspath(tree)):
        raise RuntimeError(f"imported the port from {semantic_abstraction_tpu_torch.__file__}")
    cs = _chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"tree": tree, "forward_ms": []}
    g = torch.Generator(device="cuda").manual_seed(0)
    for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for b, c, s in cs.MOMENTS_SHAPES:
            x = (torch.randn(b, c, s, device="cuda", generator=g) * 2 + 0.5).to(dtype)
            out["forward_ms"].append([dname, b, c, s, cs.time_ms(lambda: channel_moments(x))])
            del x
    torch.cuda.empty_cache()
    out["ovssc"] = run_step("ovssc", ovssc_forward_loss, SemAbs3DConfig(),
                            cs.ovssc_batch(np.random.RandomState(0), 1, 4, 80000, 400000,
                                           "cuda"), steps)
    out["vool"] = run_step("vool", vool_forward_loss, SemAbsVOOLConfig(),
                           cs.vool_batch(np.random.RandomState(0), "cuda"), steps)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.other, args.steps)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_ab_channel_moments: no CUDA device", file=sys.stderr)
        return 2
    card = _chip_smoke().card_line()
    print(f"card={card}", flush=True)
    other, this = os.path.abspath(args.other), HERE
    results = []
    for _ in range(args.rounds):
        for tree in (other, this, this, other):
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), tree, "--worker",
                                   "--steps", str(args.steps)], capture_output=True, text=True)
            line = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
            if proc.returncode != 0 or not line.startswith("{"):
                print(f"worker for {tree} failed ({proc.returncode}):\n{proc.stderr[-4000:]}",
                      flush=True)
                return 1
            res = json.loads(line)
            res["which"] = "other" if tree == other else "this"
            results.append(res)
            print(json.dumps(res), flush=True)
    for which in ("other", "this"):
        mine = [r for r in results if r["which"] == which]
        for path in ("ovssc", "vool"):
            keys = ("steps_per_s", "peak_mem_gb", "device_busy_s",
                    "busy_share_of_unprofiled_step", "device_kernels", "moments_forward_ms",
                    "moments_forward_kernels", "moments_backward_ms", "moments_backward_kernels")
            print(f"[{which}] {path} " + " ".join(
                f"{k} {[r[path][k] for r in mine]}" for k in keys) + f" card={card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
