"""The channel_moments kernels against the size of their long-row launches,
on one card.

    python scripts/torch_moments_sweep.py [--targets 128 256 512] [--min-vecs 4 16 32]

At the UNet GroupNorm shapes with S >= 32^3 (B = 4 and 8, bf16 and f32),
the port's forward and backward kernels launched with the plan that
``ops/channel_moments.py``'s ``plan`` gives for each ``target_blocks`` and
``min_vecs``: device times of CUDA graph replays beside the bounds of
``benchmark/counts.py``, one JSON line each, every launch first checked against
the plain versions. The card's name and power limit close the output.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from benchmark.counts import moments_backward_bound_s, moments_bound_s  # noqa: E402


def launchers(cm, p):
    """(forward, backward) of the port's kernels under the plan ``p``."""
    import torch

    fwd, bwd = cm._kernels()

    def check(err):
        if err:
            raise RuntimeError(f"channel_moments launch failed: cudaError {err}")

    def forward(x):
        b, c, s = x.shape
        s1 = torch.empty((b, c), dtype=torch.float32, device=x.device)
        s2 = torch.empty((b, c), dtype=torch.float32, device=x.device)
        check(fwd(x.data_ptr(), s1.data_ptr(), s2.data_ptr(), b * c, s, p.group, p.splits,
                  p.chunk, cm._DTYPES[x.dtype], torch.cuda.current_stream().cuda_stream))
        return s1, s2

    def backward(x, g1, g2):
        b, c, s = x.shape
        gx = torch.empty_like(x)
        check(bwd(x.data_ptr(), gx.data_ptr(), g1.data_ptr(), g2.data_ptr(), b * c, s,
                  p.group, p.splits, p.chunk, cm._DTYPES[x.dtype],
                  torch.cuda.current_stream().cuda_stream))
        return gx
    return forward, backward


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--targets", type=int, nargs="+", default=[128, 256, 512])
    ap.add_argument("--min-vecs", type=int, nargs="+", default=[4, 16, 32])
    args = ap.parse_args()
    import torch

    from semantic_abstraction_tpu_torch.ops import channel_moments as cm

    if not torch.cuda.is_available():
        print("torch_moments_sweep: no CUDA device", file=sys.stderr)
        return 2
    card = chip_smoke.card_line()
    g = torch.Generator(device="cuda").manual_seed(0)
    for dname, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        for b, c, s in chip_smoke.MOMENTS_SHAPES:
            if s < 32**3:
                continue
            x = (torch.randn(b, c, s, device="cuda", generator=g) * 2 + 0.5).to(dtype)
            g1 = torch.randn(b, c, device="cuda", generator=g)
            g2 = torch.randn(b, c, device="cuda", generator=g)
            r1, r2 = cm.channel_moments_reference(x)
            ref = cm.channel_moments_backward_reference(x, g1, g2)
            its = 20 if b * c * s >= 2**24 else 100
            for target in args.targets:
                for min_vecs in args.min_vecs:
                    p = cm.plan(b * c, s, x.element_size(), target, min_vecs)
                    forward, backward = launchers(cm, p)
                    s1, s2 = forward(x)
                    if not (((s1 - r1).abs() <= 1e-5 * x.float().abs().sum(-1) + 1e-6).all()
                            and ((s2 - r2).abs() <= 1e-5 * r2 + 1e-6).all()
                            and torch.equal(backward(x, g1, g2), ref)):
                        raise AssertionError(f"{dname} B={b} C={c} S={s} plan {p}: "
                                             "disagrees with the plain version")
                    print(json.dumps(dict(
                        target=target, min_vecs=min_vecs, dtype=dname, B=b, C=c, S=s,
                        splits=p.splits, blocks=b * c * p.splits,
                        ms=chip_smoke.time_ms(lambda: forward(x), its),
                        backward_ms=chip_smoke.time_ms(lambda: backward(x, g1, g2), its),
                        bound_ms=1e3 * moments_bound_s(b, c, s, dname),
                        backward_bound_ms=1e3 * moments_backward_bound_s(
                            b, c, s, dname))), flush=True)
            del x, ref
            torch.cuda.empty_cache()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
