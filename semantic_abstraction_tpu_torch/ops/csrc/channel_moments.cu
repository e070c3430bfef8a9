// Per-channel moments for GroupNorm and their gradient, for Hopper (sm_90a).
//
// Replaces the TPU kernel semantic_abstraction_tpu/ops/pallas_kernels.py:
// _moments_kernel (called through channel_moments). For x of shape
// (rows = B*C, S), contiguous, f32 or bf16, the forward computes in f32
//
//     s1[r] = sum_s x[r, s],    s2[r] = sum_s x[r, s]^2
//
// and the backward, from the f32 gradients g1, g2 (rows,) of s1 and s2,
//
//     gx[r, s] = dtype(g1[r] + (2 x[r, s]) g2[r])
//
// in x's dtype, each step rounded as PyTorch's plain expression rounds it
// (__fmul_rn, __fadd_rn: no contracted FMA), so that the two agree bit for
// bit. The Pallas kernel has no backward: JAX differentiates the two f32
// sums and XLA fuses that gradient into one elementwise pass; this is that
// pass.
//
// What bounds it: the forward reads x once (B*C*S*elt bytes) against 3
// flops an element, the backward reads x and writes gx once; both are far
// below the card's ~300 flops a byte, so device-memory bandwidth. At the
// UNet's level 0 in bf16, (4, 16, 128^3) is 268 MB to read, 0.080 ms at
// 3.35 TB/s; the backward of (8, 16, 128^3) moves 1.07 GB, 0.32 ms.
//
// Design. Both directions cut the rows the same way, as the caller's plan
// says (ops/channel_moments.py plan()). The UNet's 22 GroupNorm shapes
// (11 (C, S) at B = 4 and 8) take three paths:
// - short rows, at most 128 16-byte vectors (S = 4^3 and 8^3, 512 to 4,096
//   rows): a group of G lanes per row, G the row's vector count rounded up
//   to a power of two and at most 32 (8 lanes for 64 bf16, 16 for 64 f32,
//   a warp for 512), 256 / G rows to a 256-thread block, and a sub-warp
//   shuffle reduction. No block is spent on one short row (blocks of fewer
//   rows, down to a warp, measured no faster);
// - rows of 16^3 and 32^3 (128 to 1,024 rows): one block of 256 threads a
//   row;
// - long rows, 64^3 and 128^3 (64 to 256 rows): k blocks a row, k <= 8 and
//   rows * k near 256 (4 a row for the 64 rows of level 0 at B = 4, 2 at
//   B = 8, 1 for (8, 32, 64^3)), each on a chunk of at least 128 KB. The
//   forward launches a row's k blocks as one thread-block cluster: each
//   block reduces its chunk into shared memory, and block 0 of the cluster
//   sums the k partials through distributed shared memory in rank order.
// So the forward is one launch everywhere, needs no scratch and no second
// pass, and gives the same bits from call to call. The backward has no
// reduction and runs the same grids without clusters.
// Each thread issues BATCH = 8 independent 16-byte loads before it uses
// any (the last batch of a segment masked): 128 bytes a thread, 32 KB a
// block, 64 KB an SM at 2 blocks an SM, where Little's law asks about
// 3.35 TB/s / 132 SMs x ~1 us = 25 KB. Where a thread has at most 4
// vectors (the lane groups, and a block a row at 16^3) it issues
// SHORT_BATCH = 4: a thread of 8 loads holds 52-64 registers, so 4 blocks
// an SM, and the 1,024 rows of (8, 128, 16^3) took two waves that way; the
// 4-load block kernels fit 32 registers (8 blocks an SM) without spilling
// (scripts/torch_ptxas.py). Measured on the H100 against TMA 1D bulk
// copies into a 5-stage shared-memory ring (40 KB in flight a block) and
// against 4 and 16 loads a thread: the TMA ring was never faster, 4 loads
// no faster overall and slower in the backward, 16 slower.
// A row segment that does not start on 16 bytes (odd S, unaligned views)
// takes a scalar head up to the first 16-byte boundary, then vectors, then
// a scalar tail.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int MAX_GROUP = 32;   // lanes of one short row: at most a warp
constexpr int MAX_SPLITS = 8;   // blocks of one row: the portable cluster size
constexpr int BATCH = 8;        // independent 16-byte loads in flight a thread
constexpr int SHORT_BATCH = 4;  // the same where a thread has at most 4 vectors
                                // (lane groups, 16^3 rows): fewer registers,
                                // so 8 blocks an SM take 1,024 rows at once

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* out) { *out = __float2bfloat16_rn(v); }

// The values of one 16-byte vector, widened to f32 (a bf16 is the high
// half of an f32, and the lower address holds the lower half of a word).
__device__ __forceinline__ void unpack(const uint4& u, float (&v)[4]) {
  v[0] = __uint_as_float(u.x); v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z); v[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&v)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ uint4 pack(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}
__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ uint4 pack(const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = bf16_bits(v[2 * i]) | (bf16_bits(v[2 * i + 1]) << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T>
struct Lanes {
  static constexpr int V = 16 / sizeof(T);  // values in one 16-byte vector
};

__device__ __forceinline__ void add(float v, float& a1, float& a2) {
  a1 += v;
  a2 = fmaf(v, v, a2);
}

template <typename T>
__device__ __forceinline__ void add_vec(const uint4& u, float& a1, float& a2) {
  float v[Lanes<T>::V];
  unpack(u, v);
#pragma unroll
  for (int i = 0; i < Lanes<T>::V; ++i) add(v[i], a1, a2);
}

// Elements before the first 16-byte boundary of p, at most n.
template <typename T>
__device__ __forceinline__ long long head_of(const T* p, long long n) {
  const long long h = (long long)(((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) / sizeof(T));
  return h < n ? h : n;
}

// Adds x[0, n) of one row segment to (a1, a2) over `lanes` threads, of
// which this is `lane`. The vectors go NB at a time, the last batch's loads
// past the end masked, so that a short segment too has all its loads in
// flight at once.
template <int NB, typename T>
__device__ __forceinline__ void sum_segment(const T* __restrict__ p, long long n, int lane,
                                            int lanes, float& a1, float& a2) {
  constexpr int V = Lanes<T>::V;
  const long long head = head_of(p, n);
  const long long nv = (n - head) / V;
  for (long long i = lane; i < head; i += lanes) add(to_f32(p[i]), a1, a2);
  const uint4* pv = reinterpret_cast<const uint4*>(p + head);
  for (long long i = lane; i < nv; i += (long long)NB * lanes) {
    uint4 u[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const long long k = i + (long long)b * lanes;
      u[b] = k < nv ? __ldg(pv + k) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int b = 0; b < NB; ++b)
      if (i + (long long)b * lanes < nv) add_vec<T>(u[b], a1, a2);
  }
  for (long long j = head + nv * V + lane; j < n; j += lanes) add(to_f32(p[j]), a1, a2);
}

__device__ __forceinline__ float grad(float x, float g1, float g2) {
  return __fadd_rn(g1, __fmul_rn(__fmul_rn(2.0f, x), g2));
}

template <typename T>
__device__ __forceinline__ uint4 grad_vec(const uint4& u, float g1, float g2) {
  float v[Lanes<T>::V];
  unpack(u, v);
#pragma unroll
  for (int i = 0; i < Lanes<T>::V; ++i) v[i] = grad(v[i], g1, g2);
  return pack(v);
}

// gx[0, n) of one row segment from x[0, n), over `lanes` threads. `vec`:
// x and gx lie alike against 16 bytes, so the vectors of one are the
// vectors of the other (otherwise every element is scalar).
template <int NB, typename T>
__device__ __forceinline__ void grad_segment(const T* __restrict__ p, T* __restrict__ q,
                                             long long n, int lane, int lanes, float g1,
                                             float g2, bool vec) {
  constexpr int V = Lanes<T>::V;
  const long long head = vec ? head_of(p, n) : n;
  const long long nv = (n - head) / V;
  for (long long i = lane; i < head; i += lanes) from_f32(grad(to_f32(p[i]), g1, g2), q + i);
  const uint4* pv = reinterpret_cast<const uint4*>(p + head);
  uint4* qv = reinterpret_cast<uint4*>(q + head);
  for (long long i = lane; i < nv; i += (long long)NB * lanes) {
    uint4 u[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const long long k = i + (long long)b * lanes;
      u[b] = k < nv ? __ldg(pv + k) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const long long k = i + (long long)b * lanes;
      if (k < nv) qv[k] = grad_vec<T>(u[b], g1, g2);
    }
  }
  for (long long j = head + nv * V + lane; j < n; j += lanes)
    from_f32(grad(to_f32(p[j]), g1, g2), q + j);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Short rows: 256 / group rows a block, `group` lanes (a power of two, at
// most 32) a row, each lane at most SHORT_BATCH vectors, reduced by
// shuffles inside the group.
template <typename T>
__global__ void __launch_bounds__(THREADS)
moments_fwd_groups(const T* __restrict__ x, float* __restrict__ s1, float* __restrict__ s2,
                   long long rows, long long s, int group) {
  const int lane = threadIdx.x % group;
  const long long row = (long long)blockIdx.x * (THREADS / group) + threadIdx.x / group;
  float a1 = 0.f, a2 = 0.f;
  if (row < rows) sum_segment<SHORT_BATCH>(x + row * s, s, lane, group, a1, a2);
  for (int o = group / 2; o > 0; o >>= 1) {
    a1 += __shfl_xor_sync(0xffffffffu, a1, o);
    a2 += __shfl_xor_sync(0xffffffffu, a2, o);
  }
  if (lane == 0 && row < rows) {
    s1[row] = a1;
    s2[row] = a2;
  }
}

// Longer rows: block b sums chunk b % splits of row b / splits, NB loads a
// thread at a time. CLUSTER: the launch makes each row's splits blocks one
// cluster, and the cluster's block 0 adds the blocks' partials in rank
// (= chunk) order; without it splits is 1 (a kernel that holds cluster
// instructions is not launched for one block a row).
template <typename T, int NB, bool CLUSTER>
__global__ void __launch_bounds__(THREADS, NB == BATCH ? 4 : 8)
moments_fwd_blocks(const T* __restrict__ x, float* __restrict__ s1, float* __restrict__ s2,
                   long long s, long long chunk, int splits) {
  const long long row = blockIdx.x / splits;
  const int split = blockIdx.x % splits;
  const long long start = split * chunk;
  const long long n = start >= s ? 0 : (s - start < chunk ? s - start : chunk);
  float a1 = 0.f, a2 = 0.f;
  sum_segment<NB>(x + row * s + start, n, threadIdx.x, THREADS, a1, a2);

  __shared__ float red[2][THREADS / 32];
  __shared__ float part[2];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  a1 = warp_sum(a1);
  a2 = warp_sum(a2);
  if (lane == 0) {
    red[0][warp] = a1;
    red[1][warp] = a2;
  }
  __syncthreads();
  if (warp == 0) {
    a1 = warp_sum(lane < THREADS / 32 ? red[0][lane] : 0.f);
    a2 = warp_sum(lane < THREADS / 32 ? red[1][lane] : 0.f);
    if (lane == 0) {
      part[0] = a1;
      part[1] = a2;
    }
  }
  if constexpr (!CLUSTER) {
    if (threadIdx.x == 0) {
      s1[row] = a1;
      s2[row] = a2;
    }
  } else {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every block's partial is in its shared memory
    if (cluster.block_rank() == 0 && threadIdx.x == 0) {
      float t1 = 0.f, t2 = 0.f;
      for (int r = 0; r < splits; ++r) {
        const float* q = cluster.map_shared_rank(part, r);
        t1 += q[0];
        t2 += q[1];
      }
      s1[row] = t1;
      s2[row] = t2;
    }
    cluster.sync();  // no block leaves while block 0 reads its shared memory
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
moments_bwd_groups(const T* __restrict__ x, T* __restrict__ gx, const float* __restrict__ g1,
                   const float* __restrict__ g2, long long rows, long long s, int group,
                   bool vec) {
  const long long row = (long long)blockIdx.x * (THREADS / group) + threadIdx.x / group;
  if (row >= rows) return;
  grad_segment<SHORT_BATCH>(x + row * s, gx + row * s, s, (int)(threadIdx.x % group), group,
                            g1[row], g2[row], vec);
}

template <typename T, int NB>
__global__ void __launch_bounds__(THREADS, NB == BATCH ? 4 : 8)
moments_bwd_blocks(const T* __restrict__ x, T* __restrict__ gx, const float* __restrict__ g1,
                   const float* __restrict__ g2, long long s, long long chunk, int splits,
                   bool vec) {
  const long long row = blockIdx.x / splits;
  const long long start = (blockIdx.x % splits) * chunk;
  const long long n = start >= s ? 0 : (s - start < chunk ? s - start : chunk);
  const long long o = row * s + start;
  grad_segment<NB>(x + o, gx + o, n, threadIdx.x, THREADS, g1[row], g2[row], vec);
}

// True when a block of the block regime reads at most SHORT_BATCH vectors
// a thread from its chunk.
template <typename T>
bool short_chunk(long long chunk) {
  return (chunk + Lanes<T>::V - 1) / Lanes<T>::V <= (long long)SHORT_BATCH * THREADS;
}

template <typename T, int NB>
int forward_blocks(const T* x, float* s1, float* s2, long long rows, long long s,
                   int splits, long long chunk, cudaStream_t stream) {
  if (splits == 1) {
    moments_fwd_blocks<T, NB, false><<<(unsigned)rows, THREADS, 0, stream>>>(x, s1, s2, s,
                                                                           chunk, 1);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(rows * splits));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err =
      cudaLaunchKernelEx(&cfg, moments_fwd_blocks<T, NB, true>, x, s1, s2, s, chunk, splits);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int forward(const void* xp, float* s1, float* s2, long long rows, long long s, int group,
            int splits, long long chunk, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xp);
  if (group > 0) {
    const long long per = THREADS / group;
    moments_fwd_groups<T><<<(unsigned)((rows + per - 1) / per), THREADS, 0, stream>>>(
        x, s1, s2, rows, s, group);
    return (int)cudaGetLastError();
  }
  return short_chunk<T>(chunk)
      ? forward_blocks<T, SHORT_BATCH>(x, s1, s2, rows, s, splits, chunk, stream)
      : forward_blocks<T, BATCH>(x, s1, s2, rows, s, splits, chunk, stream);
}

template <typename T>
int backward(const void* xp, void* gxp, const float* g1, const float* g2, long long rows,
             long long s, int group, int splits, long long chunk, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xp);
  T* gx = static_cast<T*>(gxp);
  const bool vec = (reinterpret_cast<uintptr_t>(xp) & 15) == (reinterpret_cast<uintptr_t>(gxp) & 15);
  if (group > 0) {
    const long long per = THREADS / group;
    moments_bwd_groups<T><<<(unsigned)((rows + per - 1) / per), THREADS, 0, stream>>>(
        x, gx, g1, g2, rows, s, group, vec);
  } else if (short_chunk<T>(chunk)) {
    moments_bwd_blocks<T, SHORT_BATCH><<<(unsigned)(rows * splits), THREADS, 0, stream>>>(
        x, gx, g1, g2, s, chunk, splits, vec);
  } else {
    moments_bwd_blocks<T, BATCH><<<(unsigned)(rows * splits), THREADS, 0, stream>>>(
        x, gx, g1, g2, s, chunk, splits, vec);
  }
  return (int)cudaGetLastError();
}

// The plan the caller passes: group > 0 (a power of two up to 32) for the
// short-row regime, with splits 1 and chunk s; group 0 for the block
// regime, with 1 <= splits <= 8 blocks a row, chunk a multiple of 8 and
// (splits - 1) * chunk < s <= splits * chunk.
bool plan_ok(long long rows, long long s, int group, int splits, long long chunk) {
  if (rows < 1 || s < 1) return false;
  if (group > 0)
    return group <= MAX_GROUP && (group & (group - 1)) == 0 && splits == 1 && chunk == s &&
           (rows + THREADS / group - 1) / (THREADS / group) <= 0x7fffffffLL;
  return group == 0 && splits >= 1 && splits <= MAX_SPLITS && chunk >= 8 && chunk % 8 == 0 &&
         (splits - 1) * chunk < s && s <= splits * chunk && rows * splits <= 0x7fffffffLL;
}

}  // namespace

extern "C" {

int channel_moments_threads() { return THREADS; }

// x: contiguous (rows, s), dtype 0 = float32, 1 = bfloat16. s1, s2: (rows,)
// float32. (group, splits, chunk): the caller's plan (plan_ok above).
// Returns a cudaError_t value (0 = ok).
int channel_moments_launch(const void* x, float* s1, float* s2, long long rows, long long s,
                           int group, int splits, long long chunk, int dtype, void* stream) {
  if (!plan_ok(rows, s, group, splits, chunk)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return forward<float>(x, s1, s2, rows, s, group, splits, chunk, st);
  if (dtype == 1) return forward<__nv_bfloat16>(x, s1, s2, rows, s, group, splits, chunk, st);
  return (int)cudaErrorInvalidValue;
}

// gx = dtype(g1 + (2 x) g2) for x and gx contiguous (rows, s) of one dtype
// (0 = float32, 1 = bfloat16), g1 and g2 (rows,) float32; the same plan as
// the forward's. Returns a cudaError_t value (0 = ok).
int channel_moments_backward_launch(const void* x, void* gx, const float* g1, const float* g2,
                                    long long rows, long long s, int group, int splits,
                                    long long chunk, int dtype, void* stream) {
  if (!plan_ok(rows, s, group, splits, chunk)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return backward<float>(x, gx, g1, g2, rows, s, group, splits, chunk, st);
  if (dtype == 1)
    return backward<__nv_bfloat16>(x, gx, g1, g2, rows, s, group, splits, chunk, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
