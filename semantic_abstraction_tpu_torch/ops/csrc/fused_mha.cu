// Fused multi-head self-attention for the ViT forward scan, for Hopper (sm_90a).
//
// Replaces the TPU kernel semantic_abstraction_tpu/ops/pallas_kernels.py:
// _fused_mha_kernel (called through fused_mha / _fused_mha_impl). It computes
// the same function as that file's mha_reference, per head:
//
//     out_h = round(softmax(q_h k_h^T * hd^-0.5)) v_h
//
// with f32 logits and softmax, the probabilities rounded to the input type
// (as both JAX forms do) and the value product accumulated in f32. q is
// unscaled. No mask and no probability output.
//
// Scale: the Pallas body scales the f32 logits, while mha_reference scales q
// in the input type before the product. At hd=64 the scale is 2^-3, a power
// of two, so both are exact and agree; this kernel scales the f32 logits.
//
// What bounds it: at the main path's shapes (B=32..90 tile rows, T=50,
// W=768 = 12 heads x 64) in bf16 the work is ~4*B*H*T*T*hd flops
// (0.49 GFLOP at B=64, ~0.5 us at 989 TFLOP/s) against reading q, k, v and
// writing out once (19.7 MB at B=64, ~5.9 us at 3.35 TB/s): memory-bound.
// At ViT-L/14 (T=257, W=1024 = 16 x 64, B=48) the flops are 3.2 GFLOP
// (3.3 us) against 101 MB (30 us): still memory-bound. The design reads
// q/k/v straight from the strided (B, T, 3W) qkv projection (no split
// copy), stages q rows and K/V tiles in shared memory with the
// probabilities, and writes the output once into (B, T, W). The arithmetic
// runs on CUDA cores in f32; tensor cores (wgmma) and TMA staging are left
// for later work.
//
// Layout, for any T up to T_MAX (ViT-B/32 has 50 tokens, ViT-L/14 257 at
// 224 px and 577 at 336 px): staging a whole head's q, k and v as f32
// would take 3 * T * 65 floats, more than a block's 227 KB above T = 256.
// So one block owns QROWS query rows of one (batch row, head) and keeps one
// f32 probability row of T floats for each; K and then V go through shared
// memory in KTILE-key tiles. Pass one over the K tiles writes the scaled
// logits into the rows (lane j of a warp takes keys j, j + 32 of a tile),
// the softmax runs on each row in place (warp max and sum), and pass two
// over the V tiles accumulates the rounded probabilities times V (lane d
// takes output dims d, d + 32). Each warp owns four consecutive query rows
// and q is staged transposed, so one float4 gives a dim of all four rows: a
// loaded key value feeds four FMAs, and a loaded value row eight. Shared
// memory: (64 * QROWS + QROWS * T + KTILE * 65) f32. Tile rows are padded to
// hd + 1 floats so that lanes reading different keys hit different banks.
//
// A row's operations and their order do not depend on the tiling: logit dot
// products over d = 0..63, the max and sum over keys lane-strided by 32,
// value products over keys 0..T-1 in order. So a row's result does not
// depend on T's split into tiles or on which block owns the row.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int HD = 64;          // head dim the kernel takes
constexpr int HDP = HD + 1;     // padded shared-memory row
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int QROWS = 16;       // query rows of one block
constexpr int QPW = QROWS / NWARPS;  // query rows of one warp (one float4)
constexpr int KTILE = 64;       // keys of one staged K or V tile
constexpr int T_MAX = 2048;     // shared-memory bound (152 KB)
static_assert(QPW == 4, "a warp's query rows are one float4 of q transposed");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, like XLA's convert
}

// Round an f32 value to the storage type and back (probabilities are cast to
// the input type before the value product).
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

size_t smem_bytes(int t) {
  // q rows + one probability row of t per query row + one K or V tile
  return sizeof(float) * ((size_t)HD * QROWS + (size_t)QROWS * t + (size_t)KTILE * HDP);
}

// Softmax of one row of logits in place, rounded to T; `m` is this lane's
// max over its keys j = lane, lane + 32, ...
template <typename T>
__device__ __forceinline__ void row_softmax(float* prow, int t_len, float m, int lane) {
  m = warp_max(m);
  float sum = 0.f;
  for (int j = lane; j < t_len; j += 32) {
    const float e = expf(prow[j] - m);
    prow[j] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  const float inv = 1.f / sum;
  for (int j = lane; j < t_len; j += 32) prow[j] = round_to<T>(prow[j] * inv);
  __syncwarp();
}

// Stage keys [j0, j0 + nk) of one head slice (k or v) as f32 rows of HDP.
template <typename T>
__device__ __forceinline__ void stage_tile(const T* src, long long stride, int j0, int nk,
                                           float* dst) {
  for (int i = threadIdx.x; i < nk * HD; i += NTHREADS) {
    const int j = i / HD, d = i % HD;
    dst[j * HDP + d] = to_f32(src[(long long)(j0 + j) * stride + d]);
  }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
fused_mha_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 int t_len, int width, int heads,
                 long long sqb, long long sqt, long long skb, long long skt,
                 long long svb, long long svt, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                  // HD x QROWS: q transposed
  float* ps = qt + HD * QROWS;       // QROWS x t_len
  float* tile = ps + QROWS * t_len;  // KTILE x HDP

  const int groups = (t_len + QROWS - 1) / QROWS;
  const int bh = blockIdx.x / groups;
  const int r0 = (blockIdx.x % groups) * QROWS;
  const int b = bh / heads;
  const int h = bh % heads;
  const int col = h * HD;
  const int nrows = min(QROWS, t_len - r0);
  const T* qb = q + b * sqb + col;
  const T* kb = k + b * skb + col;
  const T* vb = v + b * svb + col;

  // rows past the end are zero (their logits are computed and dropped)
  for (int i = threadIdx.x; i < QROWS * HD; i += NTHREADS) {
    const int r = i / HD, d = i % HD;
    qt[d * QROWS + r] = r < nrows ? to_f32(qb[(long long)(r0 + r) * sqt + d]) : 0.f;
  }

  // warp w owns rows QPW*w .. QPW*w + QPW - 1: one float4 of qt per dim
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rw = warp * QPW;
  float m[QPW];
#pragma unroll
  for (int i = 0; i < QPW; ++i) m[i] = -INFINITY;

  // pass one: logits against each K tile; lane j holds key j of the tile
  for (int j0 = 0; j0 < t_len; j0 += KTILE) {
    const int nk = min(KTILE, t_len - j0);
    __syncthreads();  // q staged; the previous tile read by every warp
    stage_tile(kb, skt, j0, nk, tile);
    __syncthreads();
    for (int j = lane; j < nk; j += 32) {
      const float* kr = tile + j * HDP;
      float s[QPW] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 16
      for (int d = 0; d < HD; ++d) {
        const float kd = kr[d];
        const float4 qv = *reinterpret_cast<const float4*>(qt + d * QROWS + rw);
        s[0] = fmaf(qv.x, kd, s[0]);
        s[1] = fmaf(qv.y, kd, s[1]);
        s[2] = fmaf(qv.z, kd, s[2]);
        s[3] = fmaf(qv.w, kd, s[3]);
      }
#pragma unroll
      for (int i = 0; i < QPW; ++i) {
        const float si = s[i] * scale;
        ps[(rw + i) * t_len + j0 + j] = si;
        m[i] = fmaxf(m[i], si);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < QPW; ++i) row_softmax<T>(ps + (rw + i) * t_len, t_len, m[i], lane);

  // pass two: rounded probabilities times each V tile
  float acc[QPW][2];
#pragma unroll
  for (int i = 0; i < QPW; ++i) acc[i][0] = acc[i][1] = 0.f;
  for (int j0 = 0; j0 < t_len; j0 += KTILE) {
    const int nk = min(KTILE, t_len - j0);
    __syncthreads();
    stage_tile(vb, svt, j0, nk, tile);
    __syncthreads();
    for (int j = 0; j < nk; ++j) {
      const float v0 = tile[j * HDP + lane], v1 = tile[j * HDP + lane + 32];
#pragma unroll
      for (int i = 0; i < QPW; ++i) {
        const float p = ps[(rw + i) * t_len + j0 + j];
        acc[i][0] = fmaf(p, v0, acc[i][0]);
        acc[i][1] = fmaf(p, v1, acc[i][1]);
      }
    }
  }

  T* ob = out + (long long)b * t_len * width + col;
#pragma unroll
  for (int i = 0; i < QPW; ++i) {
    const int r = rw + i;
    if (r >= nrows) continue;
    ob[(long long)(r0 + r) * width + lane] = from_f32<T>(acc[i][0]);
    ob[(long long)(r0 + r) * width + lane + 32] = from_f32<T>(acc[i][1]);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int t_len, int width, int heads, long long sqb, long long sqt,
           long long skb, long long skt, long long svb, long long svt,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(t_len);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mha_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)b * heads * ((t_len + QROWS - 1) / QROWS);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const float scale = 1.0f / sqrtf((float)HD);
  fused_mha_kernel<T><<<(unsigned)blocks, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), t_len, width, heads, sqb, sqt, skb, skt, svb, svt, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int fused_mha_head_dim() { return HD; }
int fused_mha_max_tokens() { return T_MAX; }

// q, k, v: (b, t_len, width) with unit stride on the last axis and the given
// batch / token strides (elements). out: contiguous (b, t_len, width).
// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t value (0 = ok).
int fused_mha_launch(const void* q, const void* k, const void* v, void* out,
                     int b, int t_len, int width, int heads,
                     long long sqb, long long sqt, long long skb, long long skt,
                     long long svb, long long svt, int dtype, void* stream) {
  if (width != heads * HD || t_len < 1 || t_len > T_MAX || b < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, out, b, t_len, width, heads, sqb, sqt, skb, skt, svb, svt, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, b, t_len, width, heads, sqb, sqt, skb, skt, svb, svt, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
