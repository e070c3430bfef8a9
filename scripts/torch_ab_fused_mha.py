"""Time the port's fused_mha in two checkouts on one card, in turns.

    python scripts/torch_ab_fused_mha.py OTHER_CHECKOUT [--rounds 2]

Runs OTHER_CHECKOUT, this checkout, this checkout, OTHER_CHECKOUT (per
round), each in its own process that builds that checkout's kernel, and
times ``fused_mha`` on the ViT-B/32 path's shapes (q, k, v strided views of
one (B, 50, 2304) projection, 12 heads of 64, bf16 and f32) with CUDA
events over 200 back-to-back calls. Prints one JSON line per measurement
and the card's name and power limit. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCHES = (12, 42, 45, 48)

_CHILD = r"""
import json, sys, torch
from semantic_abstraction_tpu_torch.ops.fused_mha import fused_mha
g = torch.Generator(device="cuda").manual_seed(0)
out = {}
for dname, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
    for b in %(batches)r:
        q, k, v = torch.randn(b, 50, 3 * 768, device="cuda", generator=g).to(dtype).split(768, -1)
        for _ in range(10):
            fused_mha(q, k, v, 12)
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(200):
            fused_mha(q, k, v, 12)
        e.record()
        torch.cuda.synchronize()
        out[f"{dname} B={b}"] = s.elapsed_time(e) / 200
print(json.dumps(out))
"""


def measure(tree: str) -> dict:
    env = dict(os.environ, PYTHONPATH=tree)
    res = subprocess.run([sys.executable, "-c", _CHILD % {"batches": BATCHES}],
                         cwd=tree, env=env, capture_output=True, text=True, check=True,
                         timeout=600)
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
