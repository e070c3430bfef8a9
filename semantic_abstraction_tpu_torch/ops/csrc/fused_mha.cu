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
// The design therefore reads each q/k/v element from device memory exactly
// once, straight from the strided (B, T, 3W) qkv projection (no split copy),
// keeps the (T, hd) head slices and the probabilities in shared memory, and
// writes the output once into (B, T, W). The arithmetic runs on CUDA cores
// in f32; tensor cores (wgmma) and TMA staging are left for later work.
//
// Layout: one thread block per (batch row, head); each warp owns query rows
// warp, warp + NWARPS, ... For a row, lane j computes the logits of keys
// j, j + 32, ...; the softmax max and sum are warp reductions; lane d then
// accumulates output dims d, d + 32. Shared rows are padded to hd + 1 floats
// so that lanes reading different key rows hit different banks.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int HD = 64;          // head dim the kernel takes
constexpr int HDP = HD + 1;     // padded shared-memory row
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int T_MAX = 256;      // shared memory bound, see smem_bytes

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
  // q, k, v head slices (t x HDP f32) + one probability row per warp
  return sizeof(float) * (3 * (size_t)t * HDP + (size_t)NWARPS * t);
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
fused_mha_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 int t_len, int width, int heads,
                 long long sqb, long long sqt, long long skb, long long skt,
                 long long svb, long long svt, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + t_len * HDP;
  float* vs = ks + t_len * HDP;
  float* ps = vs + t_len * HDP;

  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int col = h * HD;
  const T* qb = q + b * sqb + col;
  const T* kb = k + b * skb + col;
  const T* vb = v + b * svb + col;

  // stage the head slices: consecutive threads read consecutive head dims
  for (int i = threadIdx.x; i < t_len * HD; i += NTHREADS) {
    const int r = i / HD, d = i % HD;
    qs[r * HDP + d] = to_f32(qb[r * sqt + d]);
    ks[r * HDP + d] = to_f32(kb[r * skt + d]);
    vs[r * HDP + d] = to_f32(vb[r * svt + d]);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* prow = ps + warp * t_len;
  T* ob = out + (long long)b * t_len * width + col;

  for (int r = warp; r < t_len; r += NWARPS) {
    const float* qr = qs + r * HDP;
    float m = -INFINITY;
    for (int j = lane; j < t_len; j += 32) {
      const float* kr = ks + j * HDP;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) s = fmaf(qr[d], kr[d], s);
      s *= scale;
      prow[j] = s;
      m = fmaxf(m, s);
    }
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

    float acc0 = 0.f, acc1 = 0.f;
    for (int j = 0; j < t_len; ++j) {
      const float p = prow[j];
      acc0 = fmaf(p, vs[j * HDP + lane], acc0);
      acc1 = fmaf(p, vs[j * HDP + lane + 32], acc1);
    }
    ob[(long long)r * width + lane] = from_f32<T>(acc0);
    ob[(long long)r * width + lane + 32] = from_f32<T>(acc1);
    __syncwarp();  // prow is rewritten by this warp's next row
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
  const float scale = 1.0f / sqrtf((float)HD);
  fused_mha_kernel<T><<<b * heads, NTHREADS, smem, stream>>>(
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
