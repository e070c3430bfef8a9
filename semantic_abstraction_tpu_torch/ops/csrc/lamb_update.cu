// Gradient clipping to a global norm and the LAMB update over every leaf of
// a model, in three launches whatever the number of leaves, for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves optax's clip and its
// LAMB (semantic_abstraction_tpu/models/lamb.py) to XLA, which fuses them.
// The port's plain version loops over the leaves in Python, about 28
// launches a leaf, and at SemAbs3D's 121 leaves its train step waited on
// the host there. For float32 leaves p, g (the gradient; none for a leaf
// the forward never reads, taken as zeros), m and v (LAMB's moments):
//
//   norm  = sqrt(sum over every leaf of sum g^2)           (before clipping)
//   g    *= max_norm / norm where norm >= max_norm         (in place)
//   m     = b1 m + (1 - b1) g,  v = b2 v + (1 - b2) g g    (in place)
//   u     = m / (sqrt(v) + eps) + wd p                     (wd p only if wd != 0)
//   trust = min(|p|, clamp) / |u| per leaf, 1 where either norm is 0
//   p    += (-lr trust) u                                  (in place)
//
// each elementwise step rounded as PyTorch's plain expression rounds it
// (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn: no contracted FMA), so
// that only the sums' order differs from the plain version
// (ops/lamb_update.py).
//
// What bounds it: about 12 flops an element against 48 bytes moved, far
// below the card's ~300 flops a byte, so device-memory bandwidth: g read
// once for the norm; g, m, v, p read and m, v written for the moments
// (g written too where the clip engages); m, v, p read and p written for
// the update. 11 (12 with the clip) passes of 4 bytes an element: at
// SemAbs3D's 35,403,969 parameters 1.56 (1.70) GB, 0.465 (0.507) ms at
// 3.35 TB/s.
//
// Design. The leaves are cut into chunks of `chunk` elements (the last
// chunk of a leaf shorter), one block a chunk, from a table on the device
// (int64, built by the wrapper and uploaded with one asynchronous copy):
// LEAF_FIELDS words a leaf (p, g or 0, m, v, numel, first chunk), the
// leaf of each chunk, and one counter word, 0. Three kernels:
// - sumsq: each block sums g^2 over its chunk into partials[c]; the last
//   block to finish (an integer counter, the threadFenceReduction pattern)
//   sums the partials in a fixed order, writes the norm and resets the
//   counter;
// - moments: each block reads the norm, clips its chunk's g, updates m
//   and v where they lie, and writes per-chunk partials of p^2 and u^2;
// - apply: each block sums its leaf's partials in a fixed order to the
//   trust ratio (every block of a leaf gets the same bits), recomputes u
//   from m, v and p through the same device function, and updates p.
// No float atomics and fixed-order reductions: a step is bitwise
// repeatable. Leaves whose four tensors are 16-byte aligned (every leaf
// the caching allocator gives) take 16-byte loads, several in flight a
// thread; others take scalar loads.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int LEAF_FIELDS = 6;
constexpr int NB_SUMSQ = 4;    // 16-byte loads in flight a thread: g
constexpr int NB_MOMENTS = 2;  // of each of g, m, v, p
constexpr int NB_APPLY = 2;    // of each of m, v, p

struct Leaf {
  float* p;
  float* g;  // nullptr: no gradient, taken as zeros
  float* m;
  float* v;
  long long numel;
  long long first;  // its first chunk
};

__device__ __forceinline__ Leaf leaf_of(const long long* table, long long i) {
  const long long* r = table + i * LEAF_FIELDS;
  return Leaf{reinterpret_cast<float*>(r[0]), reinterpret_cast<float*>(r[1]),
              reinterpret_cast<float*>(r[2]), reinterpret_cast<float*>(r[3]), r[4], r[5]};
}

__device__ __forceinline__ bool aligned16(const Leaf& l) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(l.p) | reinterpret_cast<uintptr_t>(l.g) |
                        reinterpret_cast<uintptr_t>(l.m) | reinterpret_cast<uintptr_t>(l.v);
  return (any & 15) == 0;
}

struct Hyper {
  float b1, omb1, b2, omb2, eps, wd;  // omb = 1 - b, rounded from double as PyTorch does
};

// LAMB's moments, in place, from the (clipped) gradient g.
__device__ __forceinline__ void moments(float g, float& m, float& v, const Hyper& h) {
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.omb2, g), g));
}

// The adam step u of the updated moments; the moments and apply kernels
// both compute it here, so they round it alike.
__device__ __forceinline__ float adam_step(float m, float v, float p, const Hyper& h) {
  float u = __fdiv_rn(m, __fadd_rn(__fsqrt_rn(v), h.eps));
  if (h.wd != 0.f) u = __fadd_rn(u, __fmul_rn(h.wd, p));
  return u;
}

// Lane 0 gets the warp's sum, in a fixed order.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  return x;
}

// The block's sums of a and b, in a fixed order, to every thread.
__device__ __forceinline__ float2 block_sum2(float a, float b) {
  __shared__ float2 part[WARPS];
  __shared__ float2 total;
  a = warp_sum(a);
  b = warp_sum(b);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) part[w] = make_float2(a, b);
  __syncthreads();
  if (w == 0) {
    float2 x = lane < WARPS ? part[lane] : make_float2(0.f, 0.f);
    x.x = warp_sum(x.x);
    x.y = warp_sum(x.y);
    if (lane == 0) total = x;
  }
  __syncthreads();
  return total;
}

// This block's chunk: its leaf, its first element in the leaf, its length.
struct Chunk {
  Leaf leaf;
  long long start, n;
};

__device__ __forceinline__ Chunk chunk_of(const long long* table, long long n_leaves, long long c,
                                          long long chunk) {
  const Leaf l = leaf_of(table, table[n_leaves * LEAF_FIELDS + c]);
  const long long start = (c - l.first) * chunk;
  const long long rest = l.numel - start;
  return Chunk{l, start, rest < chunk ? rest : chunk};
}

__device__ __forceinline__ float4 ld4(const float* p, long long j) {
  return reinterpret_cast<const float4*>(p)[j];
}
__device__ __forceinline__ void st4(float* p, long long j, const float4& x) {
  reinterpret_cast<float4*>(p)[j] = x;
}

// sum g^2 a chunk into partials[c]; the last block sums the partials to the norm.
__global__ void __launch_bounds__(THREADS)
sumsq_kernel(long long* table, long long n_leaves, long long n_chunks, long long chunk,
             float* partials, float* norm) {
  const long long c = blockIdx.x;
  const Chunk ch = chunk_of(table, n_leaves, c, chunk);
  float acc = 0.f;
  const float* g = ch.leaf.g;
  if (g != nullptr) {
    g += ch.start;
    long long i0 = 0;
    if (aligned16(ch.leaf)) {
      const long long n4 = ch.n >> 2;
      for (long long j0 = threadIdx.x; j0 < n4; j0 += (long long)NB_SUMSQ * THREADS) {
        float4 r[NB_SUMSQ];
#pragma unroll
        for (int k = 0; k < NB_SUMSQ; ++k) {
          const long long j = j0 + (long long)k * THREADS;
          r[k] = j < n4 ? ld4(g, j) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int k = 0; k < NB_SUMSQ; ++k) {
          acc = fmaf(r[k].x, r[k].x, acc);
          acc = fmaf(r[k].y, r[k].y, acc);
          acc = fmaf(r[k].z, r[k].z, acc);
          acc = fmaf(r[k].w, r[k].w, acc);
        }
      }
      i0 = n4 << 2;
    }
    for (long long i = i0 + threadIdx.x; i < ch.n; i += THREADS) acc = fmaf(g[i], g[i], acc);
  }
  acc = block_sum2(acc, 0.f).x;
  unsigned int* counter = reinterpret_cast<unsigned int*>(table + n_leaves * LEAF_FIELDS + n_chunks);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    partials[c] = acc;
    __threadfence();
    last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  float t = 0.f;
  for (long long k = threadIdx.x; k < n_chunks; k += THREADS) t += __ldcg(partials + k);
  t = block_sum2(t, 0.f).x;
  if (threadIdx.x == 0) {
    *norm = __fsqrt_rn(t);
    *counter = 0u;
  }
}

// Clip, moments, and the partials of p^2 and u^2 a chunk.
__global__ void __launch_bounds__(THREADS)
moments_kernel(const long long* __restrict__ table, long long n_leaves, long long chunk_lo,
               long long chunk, const float* __restrict__ norm, float max_norm, Hyper h,
               float* __restrict__ pp, float* __restrict__ uu) {
  const long long c = chunk_lo + blockIdx.x;
  const Chunk ch = chunk_of(table, n_leaves, c, chunk);
  float scale = 1.f;
  if (norm != nullptr) {
    const float nrm = *norm;
    scale = nrm < max_norm ? 1.f : __fdiv_rn(max_norm, nrm);
  }
  const bool has_g = ch.leaf.g != nullptr;
  const bool write_g = has_g && scale != 1.f;  // g * 1 is g: no write
  float* __restrict__ g = has_g ? ch.leaf.g + ch.start : nullptr;
  float* __restrict__ m = ch.leaf.m + ch.start;
  float* __restrict__ v = ch.leaf.v + ch.start;
  const float* __restrict__ p = ch.leaf.p + ch.start;
  float ap = 0.f, au = 0.f;
  // one element: g clipped in place, m and v updated in place
  auto step = [&](float& gi, float& mi, float& vi, float pi) {
    if (has_g) gi = __fmul_rn(gi, scale);
    moments(gi, mi, vi, h);
    const float u = adam_step(mi, vi, pi, h);
    ap = fmaf(pi, pi, ap);
    au = fmaf(u, u, au);
  };
  long long i0 = 0;
  if (aligned16(ch.leaf)) {
    const long long n4 = ch.n >> 2;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    for (long long j0 = threadIdx.x; j0 < n4; j0 += (long long)NB_MOMENTS * THREADS) {
      float4 G[NB_MOMENTS], M[NB_MOMENTS], V[NB_MOMENTS], P[NB_MOMENTS];
#pragma unroll
      for (int k = 0; k < NB_MOMENTS; ++k) {
        const long long j = j0 + (long long)k * THREADS;
        const bool in = j < n4;
        G[k] = in && has_g ? ld4(g, j) : zero;
        M[k] = in ? ld4(m, j) : zero;
        V[k] = in ? ld4(v, j) : zero;
        P[k] = in ? ld4(p, j) : zero;
      }
#pragma unroll
      for (int k = 0; k < NB_MOMENTS; ++k) {
        const long long j = j0 + (long long)k * THREADS;
        if (j < n4) {
          step(G[k].x, M[k].x, V[k].x, P[k].x);
          step(G[k].y, M[k].y, V[k].y, P[k].y);
          step(G[k].z, M[k].z, V[k].z, P[k].z);
          step(G[k].w, M[k].w, V[k].w, P[k].w);
          st4(m, j, M[k]);
          st4(v, j, V[k]);
          if (write_g) st4(g, j, G[k]);
        }
      }
    }
    i0 = n4 << 2;
  }
  for (long long i = i0 + threadIdx.x; i < ch.n; i += THREADS) {
    float gi = has_g ? g[i] : 0.f, mi = m[i], vi = v[i];
    step(gi, mi, vi, p[i]);
    m[i] = mi;
    v[i] = vi;
    if (write_g) g[i] = gi;
  }
  const float2 s = block_sum2(ap, au);
  if (threadIdx.x == 0) {
    pp[c] = s.x;
    uu[c] = s.y;
  }
}

// The leaf's trust ratio from its chunks' partials, then p += (-lr trust) u.
__global__ void __launch_bounds__(THREADS)
apply_kernel(const long long* __restrict__ table, long long n_leaves, long long chunk_lo,
             long long chunk, Hyper h, float clamp, float neg_lr, const float* __restrict__ pp,
             const float* __restrict__ uu) {
  const long long c = chunk_lo + blockIdx.x;
  const Chunk ch = chunk_of(table, n_leaves, c, chunk);
  const long long n_leaf_chunks = (ch.leaf.numel + chunk - 1) / chunk;
  float sp = 0.f, su = 0.f;
  for (long long k = threadIdx.x; k < n_leaf_chunks; k += THREADS) {
    sp += pp[ch.leaf.first + k];
    su += uu[ch.leaf.first + k];
  }
  const float2 s = block_sum2(sp, su);
  float wn = __fsqrt_rn(s.x);
  if (wn > clamp) wn = clamp;  // clamp(|p|, 0, clamp); NaN stays NaN
  const float an = __fsqrt_rn(s.y);
  const float trust =
      (wn == 0.f || an == 0.f) ? 1.f : __fdiv_rn(wn, an < 1e-30f ? 1e-30f : an);
  const float scale = __fmul_rn(neg_lr, trust);
  const float* __restrict__ m = ch.leaf.m + ch.start;
  const float* __restrict__ v = ch.leaf.v + ch.start;
  float* __restrict__ p = ch.leaf.p + ch.start;
  auto step = [&](float mi, float vi, float& pi) {
    pi = __fadd_rn(pi, __fmul_rn(scale, adam_step(mi, vi, pi, h)));
  };
  long long i0 = 0;
  if (aligned16(ch.leaf)) {
    const long long n4 = ch.n >> 2;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    for (long long j0 = threadIdx.x; j0 < n4; j0 += (long long)NB_APPLY * THREADS) {
      float4 M[NB_APPLY], V[NB_APPLY], P[NB_APPLY];
#pragma unroll
      for (int k = 0; k < NB_APPLY; ++k) {
        const long long j = j0 + (long long)k * THREADS;
        const bool in = j < n4;
        M[k] = in ? ld4(m, j) : zero;
        V[k] = in ? ld4(v, j) : zero;
        P[k] = in ? ld4(p, j) : zero;
      }
#pragma unroll
      for (int k = 0; k < NB_APPLY; ++k) {
        const long long j = j0 + (long long)k * THREADS;
        if (j < n4) {
          step(M[k].x, V[k].x, P[k].x);
          step(M[k].y, V[k].y, P[k].y);
          step(M[k].z, V[k].z, P[k].z);
          step(M[k].w, V[k].w, P[k].w);
          st4(p, j, P[k]);
        }
      }
    }
    i0 = n4 << 2;
  }
  for (long long i = i0 + threadIdx.x; i < ch.n; i += THREADS) {
    float pi = p[i];
    step(m[i], v[i], pi);
    p[i] = pi;
  }
}

bool table_ok(long long n_leaves, long long n_chunks, long long chunk) {
  return n_leaves >= 1 && n_chunks >= 1 && n_chunks <= 0x7fffffffLL && chunk >= 4 &&
         chunk % 4 == 0;
}

}  // namespace

extern "C" {

int lamb_update_threads() { return THREADS; }
int lamb_update_leaf_fields() { return LEAF_FIELDS; }

// table: the device table above (n_leaves leaves, n_chunks chunks of
// `chunk` elements, the counter word 0). partials: n_chunks float32.
// Writes the global norm of every gradient to *norm (float32). Returns a
// cudaError_t value (0 = ok).
int lamb_grad_norm_launch(long long* table, long long n_leaves, long long n_chunks,
                          long long chunk, float* partials, float* norm, void* stream) {
  if (!table_ok(n_leaves, n_chunks, chunk)) return (int)cudaErrorInvalidValue;
  sumsq_kernel<<<(unsigned)n_chunks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      table, n_leaves, n_chunks, chunk, partials, norm);
  return (int)cudaGetLastError();
}

// The moments and apply kernels over chunks [chunk_lo, chunk_hi) (one
// param group's leaves). norm: the global norm to clip to max_norm, or
// nullptr for no clip. partials: 2 * n_chunks float32 (p^2, then u^2).
// neg_lr = -(lr * schedule(step)). Returns a cudaError_t value (0 = ok).
int lamb_update_launch(const long long* table, long long n_leaves, long long n_chunks,
                       long long chunk_lo, long long chunk_hi, long long chunk, const float* norm,
                       float max_norm, float neg_lr, float b1, float omb1, float b2, float omb2,
                       float eps, float weight_decay, float clamp, float* partials,
                       void* stream) {
  if (!table_ok(n_leaves, n_chunks, chunk) || chunk_lo < 0 || chunk_lo >= chunk_hi ||
      chunk_hi > n_chunks)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Hyper h{b1, omb1, b2, omb2, eps, weight_decay};
  const unsigned blocks = (unsigned)(chunk_hi - chunk_lo);
  float* pp = partials;
  float* uu = partials + n_chunks;
  moments_kernel<<<blocks, THREADS, 0, st>>>(table, n_leaves, chunk_lo, chunk, norm, max_norm, h,
                                              pp, uu);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  apply_kernel<<<blocks, THREADS, 0, st>>>(table, n_leaves, chunk_lo, chunk, h, clamp, neg_lr,
                                            pp, uu);
  return (int)cudaGetLastError();
}

}  // extern "C"
