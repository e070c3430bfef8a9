// Per-channel moments for GroupNorm, for Hopper (sm_90a).
//
// Replaces the TPU kernel semantic_abstraction_tpu/ops/pallas_kernels.py:
// _moments_kernel (called through channel_moments). For x of shape
// (rows = B*C, S), contiguous, it computes in f32
//
//     s1[r] = sum_s x[r, s],    s2[r] = sum_s x[r, s]^2
//
// for x in f32 or bf16. Unlike the Pallas kernel it takes any C and any S:
// its C % 8 and S-chunk conditions were TPU tiling limits.
//
// What bounds it: one read of x (B*C*S*elt bytes) and 8*B*C bytes written,
// against 2 flops an element: far below the card's ~300 flops a byte, so
// device-memory bandwidth. At the UNet's level 0 (4 x 16 x 128^3 bf16) that
// is 268 MB, 0.080 ms at 3.35 TB/s.
//
// Design: the Pallas grid walked S in order and carried the sums in VMEM;
// here blocks run in parallel in no order, so the work is split instead.
// Pass 1 runs a grid of (row, split of S): each block reads its slice of one
// row with 16-byte vector loads (where the row is 16-byte aligned; scalar
// loads otherwise and for the tail), each thread keeps f32 sums of x and
// x^2, and a warp-shuffle then shared-memory reduction leaves one partial
// per (row, split). The splits are chosen by the caller so that the 64 rows
// of level 0 still fill the 132 SMs. Pass 2 (only when a row has more than
// one split) sums each row's partials in split order. Every sum is taken in
// a fixed order, so the result is deterministic. No tensor cores or TMA:
// a streaming reduction needs neither; making it faster is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Add the values of one 16-byte vector to the running sums.
__device__ __forceinline__ void add_vec(const uint4& u, const float*, float& a1, float& a2) {
  const float v[4] = {__uint_as_float(u.x), __uint_as_float(u.y),
                      __uint_as_float(u.z), __uint_as_float(u.w)};
#pragma unroll
  for (int i = 0; i < 4; ++i) { a1 += v[i]; a2 = fmaf(v[i], v[i], a2); }
}

__device__ __forceinline__ void add_vec(const uint4& u, const __nv_bfloat16*, float& a1, float& a2) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // a bf16 is the high half of an f32: widen both halves of the word
    const float lo = __uint_as_float(w[i] << 16);
    const float hi = __uint_as_float(w[i] & 0xffff0000u);
    a1 += lo; a2 = fmaf(lo, lo, a2);
    a1 += hi; a2 = fmaf(hi, hi, a2);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// grid (rows, splits), blockDim a multiple of 32, at most MAX_THREADS.
// Writes out1/out2[row * splits + split]: the final sums when splits == 1,
// the partials for moments_finish otherwise.
template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
moments_partial(const T* __restrict__ x, float* __restrict__ out1,
                float* __restrict__ out2, long long s, long long chunk) {
  const long long row = blockIdx.x;
  const int split = blockIdx.y;
  const long long start = split * chunk;
  const long long end = start + chunk < s ? start + chunk : s;
  const T* p = x + row * s + start;
  const long long n = end > start ? end - start : 0;

  float a1 = 0.f, a2 = 0.f;
  long long done = 0;
  if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    constexpr int V = 16 / sizeof(T);
    const long long nv = n / V;
    const uint4* pv = reinterpret_cast<const uint4*>(p);
#pragma unroll 4
    for (long long i = threadIdx.x; i < nv; i += blockDim.x) add_vec(__ldg(pv + i), p, a1, a2);
    done = nv * V;
  }
  for (long long i = done + threadIdx.x; i < n; i += blockDim.x) {
    const float v = to_f32(p[i]);
    a1 += v; a2 = fmaf(v, v, a2);
  }

  __shared__ float red1[MAX_THREADS / 32], red2[MAX_THREADS / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  a1 = warp_sum(a1);
  a2 = warp_sum(a2);
  if (lane == 0) { red1[warp] = a1; red2[warp] = a2; }
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x / 32;
    a1 = lane < nwarps ? red1[lane] : 0.f;
    a2 = lane < nwarps ? red2[lane] : 0.f;
    a1 = warp_sum(a1);
    a2 = warp_sum(a2);
    if (lane == 0) {
      const long long o = row * gridDim.y + split;
      out1[o] = a1;
      out2[o] = a2;
    }
  }
}

// One thread per row: the row's partials summed in split order.
__global__ void moments_finish(const float* __restrict__ part1, const float* __restrict__ part2,
                               float* __restrict__ s1, float* __restrict__ s2,
                               long long rows, int splits) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  float a1 = 0.f, a2 = 0.f;
  for (int i = 0; i < splits; ++i) {
    a1 += part1[r * splits + i];
    a2 += part2[r * splits + i];
  }
  s1[r] = a1;
  s2[r] = a2;
}

template <typename T>
int launch(const void* x, float* s1, float* s2, float* partial, long long rows,
           long long s, long long chunk, int splits, int threads, cudaStream_t stream) {
  const dim3 grid((unsigned)rows, (unsigned)splits);
  float* o1 = splits == 1 ? s1 : partial;
  float* o2 = splits == 1 ? s2 : partial + rows * splits;
  moments_partial<T><<<grid, threads, 0, stream>>>(static_cast<const T*>(x), o1, o2, s, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int fin = 256;
  moments_finish<<<(unsigned)((rows + fin - 1) / fin), fin, 0, stream>>>(
      partial, partial + rows * splits, s1, s2, rows, splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int channel_moments_max_threads() { return MAX_THREADS; }

// x: contiguous (rows, s) of dtype 0 = float32, 1 = bfloat16. s1, s2: (rows,)
// float32. partial: 2 * rows * splits float32 scratch, unused when splits is
// 1. The caller picks chunk (elements of one split, a multiple of 8), splits
// = ceil(s / chunk) and threads (a multiple of 32). Returns a cudaError_t
// value (0 = ok).
int channel_moments_launch(const void* x, float* s1, float* s2, float* partial,
                           long long rows, long long s, long long chunk, int splits,
                           int threads, int dtype, void* stream) {
  if (rows < 1 || rows > 0x7fffffffLL || s < 1 || chunk < 1 || chunk % 8 ||
      splits < 1 || splits > 65535 || (splits - 1) * chunk >= s || splits * chunk < s ||
      threads < 32 || threads > MAX_THREADS || threads % 32 ||
      (splits > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, s1, s2, partial, rows, s, chunk, splits, threads, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, s1, s2, partial, rows, s, chunk, splits, threads, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
