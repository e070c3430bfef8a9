"""The rate of mma.sync on one card: TF32 m16n8k8 and bf16 m16n8k16.

    python scripts/torch_mma_rate.py

Builds a small kernel (nvcc, the build's flags) in which every warp issues
a run of mma.sync instructions with constant operands into 8 or 2
independent accumulators, launches it over SMs x (1, 2, 4, 8) CTAs of 4
warps (1 to 8 warps on each of an SM's four schedulers), and prints the
rate in TFLOP/s and the scheduler clocks a MMA takes at the card's
maximum SM clock. It is the ceiling of the kernels built on mma.sync
(fused_mha's bodies, cam_accumulate's product). Needs one CUDA card.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from semantic_abstraction_tpu_torch.ops import _build  # noqa: E402

SOURCE = r'''
#include <cuda_runtime.h>
#include <stdint.h>
template <int KIND>
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  if (KIND == 0)
    asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                 "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                 "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <int KIND, int ACC>
__global__ void bench(float* out, int iters) {
  uint32_t a[4];
  for (int i = 0; i < 4; ++i) a[i] = 0x3c003c00u ^ (threadIdx.x & 1);
  float d[ACC][4];
  for (int j = 0; j < ACC; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.f;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < ACC; ++j) mma<KIND>(d[j], a, 0x3c003c00u, 0x3c003c00u);
  }
  float s = 0.f;
  for (int j = 0; j < ACC; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
// ms of the second of two launches
extern "C" float run(int kind, int acc, int blocks, int iters) {
  float* out;
  if (cudaMalloc(&out, sizeof(float) * blocks * 128) != cudaSuccess) return -1.f;
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  for (int rep = 0; rep < 2; ++rep) {
    cudaEventRecord(e0);
    if (kind == 0 && acc == 8) bench<0, 8><<<blocks, 128>>>(out, iters);
    if (kind == 0 && acc == 2) bench<0, 2><<<blocks, 128>>>(out, iters);
    if (kind == 1 && acc == 8) bench<1, 8><<<blocks, 128>>>(out, iters);
    if (kind == 1 && acc == 2) bench<1, 2><<<blocks, 128>>>(out, iters);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
  }
  float ms = -1.f;
  if (cudaGetLastError() == cudaSuccess) cudaEventElapsedTime(&ms, e0, e1);
  cudaFree(out);
  return ms;
}
'''


def main() -> int:
    import torch

    sms, iters = torch.cuda.get_device_properties(0).multi_processor_count, 4096
    max_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    with tempfile.TemporaryDirectory() as tmp:
        cu, so = os.path.join(tmp, "mma_rate.cu"), os.path.join(tmp, "mma_rate.so")
        with open(cu, "w") as f:
            f.write(SOURCE)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu], check=True)
        lib = ctypes.CDLL(so)
        lib.run.restype = ctypes.c_float
        lib.run.argtypes = [ctypes.c_int] * 4
        for kind, name, flops in ((0, "tf32 m16n8k8", 2 * 16 * 8 * 8),
                                  (1, "bf16 m16n8k16", 2 * 16 * 8 * 16)):
            for acc in (8, 2):
                for per_sched in (1, 2, 4, 8):
                    ms = lib.run(kind, acc, sms * per_sched, iters)
                    if ms <= 0:
                        raise RuntimeError(f"{name}: launch failed")
                    mmas = sms * per_sched * 4 * iters * acc
                    print(json.dumps({
                        "mma": name, "accumulators": acc, "warps_per_scheduler": per_sched,
                        "ms": ms, "tflops": mmas * flops / ms / 1e9,
                        "clocks_per_mma_at_max_clock":
                            ms * 1e-3 * max_mhz * 1e6 / (mmas / (sms * 4))}), flush=True)
    print(chip_smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
