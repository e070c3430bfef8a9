// The LayerNorm and quick-GELU backward of the general Chefer tail, for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves both backward passes
// to XLA, which fuses them. Added for the labels' batched backward of the
// general gradcam tail (clip/relevancy.py `_gradcam_general_tail`), where
// autograd differentiated clip/model.py's f32 composite `layer_norm` and
// `quick_gelu` op by op, each op broadcasting a saved (B, T, W) tensor
// against the labels' (L, B, T, W) gradient off PyTorch's vectorised
// elementwise path: about 60 bytes an element a LayerNorm, 24 a GELU.
// Called from custom ops (ops/tail_backward.py), which that batched
// backward runs once a label on the label's (B, T, W) slice. For g and x
// of one dtype (float32 or bfloat16), everything computed in f32 and
// rounded once to that dtype:
//
//   layer_norm_backward: g, x (rows, w); mean, rstd (rows) f32; gamma (w) f32
//     xhat = (x - mean) rstd,  gy = g gamma
//     dx   = rstd (gy - mean_w(gy) - xhat mean_w(gy xhat))
//   quick_gelu_backward: g, x (n)
//     s  = sigmoid(1.702 x)
//     dx = g (s + 1.702 x s (1 - s))
//
// What bounds them: a few flops an element against g and x read and dx
// written once, 6 bytes an element in bf16 (12 in f32), far below the
// card's ~300 flops a byte: device-memory bandwidth.
//
// Design. Both move 16 bytes a load and a store (8 bf16 or 4 f32
// values); the wrappers pass contiguous, 16-byte aligned tensors.
// - LayerNorm: one warp a row, lane l holding vectors l, l + 32, ... of
//   the row (NV of them, a compile-time count, so that the row's xhat and
//   gy stay in registers between its two sums and the output: g and x are
//   read once). The two sums reduce by xor shuffles, which leave the same
//   bits in every lane. A row of up to 32 NV vectors, the last ones
//   masked.
// - quick-GELU: a grid-stride pass over the vectors, then the last n mod
//   VEC elements one a thread.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = THREADS / 32;  // one warp a row
constexpr int MAX_NV = 8;                     // 16-byte vectors a lane: w <= 32 MAX_NV VEC
constexpr int GELU_BLOCKS_PER_SM = 8;
constexpr float GELU_ALPHA = 1.702f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 16 bytes of T to and from VEC floats
template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* in) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  }
};

template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float* in) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

template <typename T, int NV>
__global__ void __launch_bounds__(THREADS)
layer_norm_backward_kernel(const T* __restrict__ g, const T* __restrict__ x,
                           const float* __restrict__ mean, const float* __restrict__ rstd,
                           const float* __restrict__ gamma, T* __restrict__ dx,
                           long long rows, int w) {
  constexpr int V = Vec<T>::N;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= rows) return;  // a whole warp: the shuffles below see full warps
  const long long base = row * (long long)w;
  const float m = mean[row], r = rstd[row];
  float xh[NV][V], gy[NV][V];
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int col = (j * 32 + lane) * V;
    if (col < w) {
      float gv[V], xv[V], gm[V];
      Vec<T>::load(g + base + col, gv);
      Vec<T>::load(x + base + col, xv);
#pragma unroll
      for (int k = 0; k < V; k += 4) Vec<float>::load(gamma + col + k, gm + k);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        xh[j][k] = (xv[k] - m) * r;
        gy[j][k] = gv[k] * gm[k];
        s1 += gy[j][k];
        s2 += gy[j][k] * xh[j][k];
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  }
  const float a = s1 / (float)w, b = s2 / (float)w;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int col = (j * 32 + lane) * V;
    if (col < w) {
      float out[V];
#pragma unroll
      for (int k = 0; k < V; ++k) out[k] = r * (gy[j][k] - a - xh[j][k] * b);
      Vec<T>::store(dx + base + col, out);
    }
  }
}

__device__ __forceinline__ float quick_gelu_grad(float g, float x) {
  const float s = 1.f / (1.f + expf(-GELU_ALPHA * x));
  return g * (s + GELU_ALPHA * x * s * (1.f - s));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
quick_gelu_backward_kernel(const T* __restrict__ g, const T* __restrict__ x,
                           T* __restrict__ dx, long long n) {
  constexpr int V = Vec<T>::N;
  const long long nvec = n / V;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < nvec; i += stride) {
    float gv[V], xv[V], out[V];
    Vec<T>::load(g + i * V, gv);
    Vec<T>::load(x + i * V, xv);
#pragma unroll
    for (int k = 0; k < V; ++k) out[k] = quick_gelu_grad(gv[k], xv[k]);
    Vec<T>::store(dx + i * V, out);
  }
  const long long e = nvec * V + threadIdx.x;
  if (blockIdx.x == 0 && e < n) dx[e] = from_f32<T>(quick_gelu_grad(to_f32(g[e]), to_f32(x[e])));
}

template <typename T>
int launch_layer_norm(const void* g, const void* x, const float* mean, const float* rstd,
                      const float* gamma, void* dx, long long rows, int w, cudaStream_t st) {
  constexpr int V = Vec<T>::N;
  if (w % V) return (int)cudaErrorInvalidValue;
  const int nv = (w / V + 31) / 32;
  const unsigned blocks = (unsigned)((rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
  const T* gt = static_cast<const T*>(g);
  const T* xt = static_cast<const T*>(x);
  T* dt = static_cast<T*>(dx);
#define TB_LN_CASE(NV)                                                                   \
  case NV:                                                                               \
    layer_norm_backward_kernel<T, NV>                                                    \
        <<<blocks, THREADS, 0, st>>>(gt, xt, mean, rstd, gamma, dt, rows, w);            \
    break;
  switch (nv) {
    TB_LN_CASE(1) TB_LN_CASE(2) TB_LN_CASE(3) TB_LN_CASE(4)
    TB_LN_CASE(5) TB_LN_CASE(6) TB_LN_CASE(7) TB_LN_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef TB_LN_CASE
  return (int)cudaGetLastError();
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return sms;
}

template <typename T>
int launch_quick_gelu(const void* g, const void* x, void* dx, long long n, cudaStream_t st) {
  const long long nvec = n / Vec<T>::N;
  long long blocks = (nvec + THREADS - 1) / THREADS;
  const long long cap = (long long)sm_count() * GELU_BLOCKS_PER_SM;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;  // the tail alone
  quick_gelu_backward_kernel<T><<<(unsigned)blocks, THREADS, 0, st>>>(
      static_cast<const T*>(g), static_cast<const T*>(x), static_cast<T*>(dx), n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The largest row a LayerNorm backward takes, in 16-byte vectors.
int tail_backward_max_vectors() { return 32 * MAX_NV; }

// g, x, dx: (rows, w) contiguous of one dtype (0 = float32, 1 = bfloat16),
// 16-byte aligned, w a multiple of 16 bytes and at most 32 * MAX_NV
// vectors; mean, rstd: (rows) float32; gamma: (w) float32. Returns a
// cudaError_t value (0 = ok).
int layer_norm_backward_launch(const void* g, const void* x, const float* mean,
                               const float* rstd, const float* gamma, void* dx, long long rows,
                               int w, int dtype, void* stream) {
  if (rows <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype ? launch_layer_norm<__nv_bfloat16>(g, x, mean, rstd, gamma, dx, rows, w, st)
               : launch_layer_norm<float>(g, x, mean, rstd, gamma, dx, rows, w, st);
}

// g, x, dx: n contiguous elements of one dtype (0 = float32, 1 =
// bfloat16), 16-byte aligned. Returns a cudaError_t value (0 = ok).
int quick_gelu_backward_launch(const void* g, const void* x, void* dx, long long n, int dtype,
                               void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype ? launch_quick_gelu<__nv_bfloat16>(g, x, dx, n, st)
               : launch_quick_gelu<float>(g, x, dx, n, st);
}

}  // extern "C"
