"""fused_mha's f32 body under other values of its design constants, on one
card.

    python scripts/torch_fused_mha_sweep.py

Builds ``ops/csrc/fused_mha.cu`` as it is and in variants that change one
choice of its f32 body (``namespace tf``): one m16 row tile a warp with 3
CTAs an SM (``MT = 1``, ``MIN_BLOCKS = 3``), 64-key tiles, three stages of
the K/V ring, and the TF32 split by ``cvt.rna.tf32.f32``; and, for timing
only, one TF32 product in place of three (it computes another function and
is not checked). Each build runs nvcc with the build's own flags plus
``-Xptxas -v``; its registers, spills and SASS instruction counts (all, and
the MMAs, by ``cuobjdump``) are printed. Every other variant is checked
against ``mha_reference`` at the tolerance of ``chip_smoke.py`` (1e-4), and
each is timed by CUDA graph replays at the relevancy paths' f32 shapes
beside SDPA and the bound of ``benchmark/counts.py``, in two rounds. One JSON
line a shape; the card's name and power limit close the output. Needs one
CUDA card.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from benchmark.counts import mha_bound_s  # noqa: E402
from semantic_abstraction_tpu_torch.ops import _build  # noqa: E402

SRC = os.path.join(_build.CSRC_DIR, "fused_mha.cu")
CVT_SPLIT = '''__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(big) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(small) : "f"(x - __uint_as_float(big)));
}'''
# variant -> {constant of the f32 body: value}, or the split replaced
VARIANTS = {
    "as built": {},
    "MT=1, 3 CTAs an SM": {"MT": 1, "MIN_BLOCKS": 3},
    "64-key tiles": {"KEYS": 64},
    "3 stages": {"STAGES": 3},
    "cvt.rna split": "cvt",
    "1 MMA (timing only)": "one",
}
THREE = """  mma_tf32(d[mt], asmall[mt], bb0, bb1);
    mma_tf32(d[mt], abig[mt], bs0, bs1);
    mma_tf32(d[mt], abig[mt], bb0, bb1);"""
SHAPES = [(1, 50, 768), (48, 50, 768), (48, 257, 1024), (48, 577, 1024)]


def variant_source(change) -> str:
    src = open(SRC).read()
    head, tail = src.split("namespace tf {", 1)
    if change == "one":  # the splits stay live; one product of their xor
        assert THREE in tail, "mma_3xtf32 not found"
        tail = tail.replace(THREE, "  mma_tf32(d[mt], abig[mt], bb0 ^ bs0, bb1 ^ bs1);")
    elif change == "cvt":
        tail, n = re.subn(r"__device__ __forceinline__ void split_tf32\(float x.*?\n}",
                          lambda _: CVT_SPLIT, tail, count=1, flags=re.S)
        assert n == 1, "split_tf32 not found"
    else:
        for name, value in change.items():
            tail, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                              tail, count=1)
            assert n == 1, f"constant {name} not found"
    return head + "namespace tf {" + tail


def sass_counts(so: str):
    """(instructions, MMAs) of the f32 kernel in a built library."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", so], capture_output=True, text=True,
                          check=True).stdout
    body = next(p for p in re.split(r"\n\s+Function : ", sass) if "tf32" in p.split("\n")[0])
    ins = re.findall(r"^\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", body, re.M)
    return len(ins), sum(i.startswith("HMMA") for i in ins)


def build_all(tmp: str):
    """{variant: (launch function, ptxas and SASS counts)}, nvcc started for
    all variants together."""
    procs = {}
    for i, (name, change) in enumerate(VARIANTS.items()):
        cu, so = os.path.join(tmp, f"v{i}.cu"), os.path.join(tmp, f"v{i}.so")
        with open(cu, "w") as f:
            f.write(variant_source(change))
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        # ptxas reports the tf32 kernel's frame line before its "Used" line
        lines = log.splitlines()
        at = next(i for i, l in enumerate(lines) if "Compiling entry" in l and "tf32" in l)
        frame = next(l for l in lines[at:] if "spill stores" in l)
        used = next(l for l in lines[at:] if "Used" in l and "registers" in l)
        regs = re.search(r"Used (\d+) registers", used).group(1)
        spill = re.search(r"(\d+) bytes spill stores", frame).group(1)
        fn = ctypes.CDLL(so).fused_mha_launch
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] * 6 + [ctypes.c_int, ctypes.c_void_p])
        n_ins, n_mma = sass_counts(so)
        out[name] = (fn, {"registers": int(regs), "spill_bytes": int(spill),
                          "sass_instructions": n_ins, "sass_mmas": n_mma})
    return out


def main() -> int:
    import torch
    import torch.nn.functional as F

    from semantic_abstraction_tpu_torch.ops.fused_mha import mha_reference

    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        built = build_all(tmp)
        for name, (_, counts) in built.items():
            print(json.dumps({"variant": name, **counts}), flush=True)
        g = torch.Generator(device="cuda").manual_seed(0)
        for b, t, w in SHAPES:
            heads = w // 64
            q, k, v = torch.randn(b, t, 3 * w, device="cuda", generator=g).split(w, -1)
            ref = mha_reference(q, k, v, heads)
            out = torch.empty_like(ref)
            qh, kh, vh = (a.reshape(b, t, heads, 64).transpose(1, 2) for a in (q, k, v))
            iters = 100 if t <= 64 else 20
            row = {"B": b, "T": t, "W": w,
                   "bound_ms": 1e3 * mha_bound_s(b, t, w, heads, "float32"),
                   "sdpa_ms": chip_smoke.time_ms(
                       lambda: F.scaled_dot_product_attention(qh, kh, vh), iters)}

            def launch(fn):
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t, w,
                         heads, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                         v.stride(0), v.stride(1), 0, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed: cudaError {err}")

            for _ in range(2):
                for name, (fn, _) in built.items():
                    launch(fn)
                    torch.cuda.synchronize()
                    if VARIANTS[name] != "one" and not torch.allclose(out, ref, atol=1e-4,
                                                                      rtol=1e-4):
                        raise AssertionError(f"{name} B={b} T={t}: max err "
                                             f"{(out - ref).abs().max().item()}")
                    row.setdefault(name, []).append(chip_smoke.time_ms(lambda: launch(fn), iters))
            print(json.dumps(row), flush=True)
    print(chip_smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
