"""Time the port's fused_mha and cam_accumulate in two checkouts on one
card, in turns.

    python scripts/torch_ab_fused_mha.py OTHER_CHECKOUT [--rounds 2]

Runs OTHER_CHECKOUT, this checkout, this checkout, OTHER_CHECKOUT (per
round), each in its own process that builds that checkout's kernels, and
times, in bf16 and f32:

- ``fused_mha`` at the relevancy paths' shapes: q, k, v strided views of one
  (B, T, 3W) projection; get_visual_feature's one image and ViT-B/32's tile
  chunks (T = 50, W = 768, B = 1, 12, 42, 45, 48) and ViT-L/14's chunk at
  224 and 336 px (B = 48, W = 1024, T = 257 and 577);
- ``cam_accumulate`` at the multi-tail gradcam's shapes: L = 9 labels,
  B = 48 tiles, ViT-B/32 (H = 12, T = 50) and ViT-L/14 (H = 16, T = 257),
  a dense R, ReLU on.

Each shape gets two times: "eager", CUDA events over back-to-back calls
from Python (what the path sees, host overhead included), and "device", the
same calls captured in a CUDA graph and replayed (the kernel alone). Prints
one JSON line per measurement and the card's name and power limit. Needs
one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import json, torch
from semantic_abstraction_tpu_torch.ops.cam_accumulate import cam_accumulate
from semantic_abstraction_tpu_torch.ops.fused_mha import fused_mha

def eager_ms(fn, iters):
    for _ in range(5):
        fn()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / iters

def device_ms(fn, iters):
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(5):
        graph.replay()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / (5 * iters)

g = torch.Generator(device="cuda").manual_seed(0)
out = {}
for dname, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
    for b, t, w in ((1, 50, 768), (12, 50, 768), (42, 50, 768), (45, 50, 768),
                    (48, 50, 768), (48, 257, 1024), (48, 577, 1024)):
        q, k, v = torch.randn(b, t, 3 * w, device="cuda", generator=g).to(dtype).split(w, -1)
        fn = lambda: fused_mha(q, k, v, w // 64)
        iters = 200 if t <= 64 else 20
        out[f"fused_mha {dname} B={b} T={t}"] = {
            "eager": eager_ms(fn, iters), "device": device_ms(fn, iters)}
        del q, k, v
    for h, t in ((12, 50), (16, 257)):
        attn = torch.softmax(4 * torch.randn(48, h, t, t, device="cuda", generator=g), -1)
        grad = 0.05 * torch.randn(9, 48, h, t, t, device="cuda", generator=g)
        r = torch.eye(t, device="cuda") + 0.1 * torch.rand(9, 48, t, t, device="cuda", generator=g)
        grad, attn = grad.to(dtype), attn.to(dtype)
        fn = lambda: cam_accumulate(grad, attn, r)
        iters = 100 if t <= 64 else 10
        out[f"cam_accumulate {dname} L=9 B=48 H={h} T={t}"] = {
            "eager": eager_ms(fn, iters), "device": device_ms(fn, iters)}
        del grad, attn, r
        torch.cuda.empty_cache()
print(json.dumps(out))
"""


def measure(tree: str) -> dict:
    env = dict(os.environ, PYTHONPATH=tree)
    res = subprocess.run([sys.executable, "-c", _CHILD], cwd=tree, env=env,
                         capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise RuntimeError(f"measuring {tree} failed:\n{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("other", help="another checkout of the repository")
    p.add_argument("--rounds", type=int, default=2)
    args = p.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    other = os.path.abspath(args.other)
    for r in range(args.rounds):
        for name, tree in (("other", other), ("this", HERE), ("this", HERE),
                           ("other", other)):
            print(json.dumps({"round": r, "tree": name, "ms": measure(tree)}), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
