// Chefer relevancy accumulation for the multi-tail gradcam, for Hopper (sm_90a).
//
// Replaces the TPU kernel semantic_abstraction_tpu/ops/pallas_kernels.py:
// _cam_accum_kernel (called through chefer_cam_accumulate). For each label l
// and tile b it computes, as that file's cam_accumulate_reference does,
//
//     out[l, b] = R[l, b] + mean_h(relu?(grad[l, b, h] * attn[b, h])) @ R[l, b]
//
// with grad (L, B, H, T, T) and attn (B, H, T, T) in f32 or bf16, both
// widened to f32, and R (L, B, T, T) in f32; the head mean, the (T, T)
// product and the sum are f32. The ReLU is the positive_attn_only switch.
// attn is not broadcast over the labels (the JAX caller materializes that
// broadcast): every label's block reads the same (B, H, T, T) rows.
//
// What bounds it: grad dominates the bytes. At the ViT-L/14 tile chunk
// (L=9 labels, B=48 tiles, H=16, T=257, bf16) one launch reads grad 913 MB,
// attn 101 MB and R 114 MB and writes out 114 MB: 1.24 GB, 0.37 ms at
// 3.35 TB/s. Its flops are 2*L*B*T^3 = 14.7 GFLOP for the product (0.22 ms
// at the 67 TFLOP/s of f32 on CUDA cores) and 3*L*B*H*T^2 for the cam.
// At ViT-B/32 (T=50, H=12) the bytes bound it further still. So the design
// reads grad and attn once, from device memory, and keeps cam out of it.
//
// Design: one (T, T) cam and one R are 2 x 264 KB in f32 at T=257, more
// than a block's 227 KB, so a block owns ROWS rows of the output of one
// (l, b):
//
// 1. it streams its rows of grad and attn over the H heads and keeps its
//    rows of cam in shared memory, transposed (camT[k][row], rows padded to
//    CSTRIDE so that a float4 reads four rows of one column);
// 2. it multiplies them by R, NCHUNK output columns at a time, staging R in
//    KTILE-row tiles through shared memory; each warp owns four output rows
//    and each lane two columns, so a step of k costs one float4 broadcast
//    of cam, two loads of R and eight FMAs on CUDA cores;
// 3. it writes R's rows plus that product.
//
// The block index runs over l fastest, then the row group, then b: the L
// blocks that read the same rows of attn run together and find them in L2,
// and the row groups of one (l, b) read the same R, which stays in L2 too.
// R is read through its strides (the first R of the gradcam is an identity
// expanded with stride 0 over l and b); every last axis has unit stride.
// Sums run in a fixed order, so the result is deterministic. Tensor cores
// (TF32 or bf16 wgmma would change the numbers) are left for later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int ROWS = 32;               // output rows of one block
constexpr int RPW = ROWS / NWARPS;     // output rows of one warp (one float4)
constexpr int CSTRIDE = ROWS + 4;      // camT row: float4-aligned, 4-way store conflicts
constexpr int NCHUNK = 64;             // output columns of one pass (two a lane)
constexpr int KTILE = 32;              // rows of R in one staged tile
constexpr int T_MAX = 1024;            // shared-memory bound (155 KB)
static_assert(RPW == 4, "a warp's rows are one float4 of camT");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

size_t smem_bytes(int t) {
  return sizeof(float) * ((size_t)t * CSTRIDE + (size_t)KTILE * NCHUNK);
}

template <typename T, bool RELU>
__global__ void __launch_bounds__(NTHREADS)
cam_accumulate_kernel(const T* __restrict__ grad, const T* __restrict__ attn,
                      const float* __restrict__ r, float* __restrict__ out,
                      int labels, int batch, int heads, int t_len,
                      long long sgl, long long sgb, long long sgh, long long sgt,
                      long long sab, long long sah, long long sat,
                      long long srl, long long srb, long long srt) {
  extern __shared__ __align__(16) float smem[];
  float* camT = smem;                     // t_len x CSTRIDE
  float* rs = smem + t_len * CSTRIDE;     // KTILE x NCHUNK

  const int groups = (t_len + ROWS - 1) / ROWS;
  const int l = blockIdx.x % labels;
  const int g = (blockIdx.x / labels) % groups;
  const int b = blockIdx.x / labels / groups;
  const int i0 = g * ROWS;
  const int nrows = min(ROWS, t_len - i0);
  const T* gp = grad + l * sgl + b * sgb + i0 * sgt;
  const T* ap = attn + b * sab + i0 * sat;
  const float* rp = r + l * srl + b * srb;
  float* op = out + ((long long)l * batch + b) * t_len * t_len;

  // 1. cam rows = mean over heads of relu?(grad * attn); rows past the end
  //    of the matrix are zero
  for (int e = threadIdx.x; e < ROWS * t_len; e += NTHREADS) {
    const int row = e / t_len, k = e - row * t_len;
    float s = 0.f;
    if (row < nrows) {
      const T* gq = gp + row * sgt + k;
      const T* aq = ap + row * sat + k;
#pragma unroll 4
      for (int h = 0; h < heads; ++h) {
        float c = to_f32(gq[h * sgh]) * to_f32(aq[h * sah]);
        if (RELU) c = fmaxf(c, 0.f);
        s += c;
      }
      s /= (float)heads;
    }
    camT[k * CSTRIDE + row] = s;
  }
  __syncthreads();

  // 2-3. out rows = R rows + cam rows @ R
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int n0 = 0; n0 < t_len; n0 += NCHUNK) {
    float acc[RPW][2];
#pragma unroll
    for (int i = 0; i < RPW; ++i) acc[i][0] = acc[i][1] = 0.f;
    for (int k0 = 0; k0 < t_len; k0 += KTILE) {
      const int nk = min(KTILE, t_len - k0);
      for (int i = threadIdx.x; i < KTILE * NCHUNK; i += NTHREADS) {
        const int kk = i / NCHUNK, c = i % NCHUNK;
        rs[i] = (kk < nk && n0 + c < t_len) ? rp[(k0 + kk) * srt + n0 + c] : 0.f;
      }
      __syncthreads();
      for (int kk = 0; kk < nk; ++kk) {
        const float4 cv = *reinterpret_cast<const float4*>(camT + (k0 + kk) * CSTRIDE + warp * RPW);
        const float b0 = rs[kk * NCHUNK + lane];
        const float b1 = rs[kk * NCHUNK + lane + 32];
        acc[0][0] = fmaf(cv.x, b0, acc[0][0]); acc[0][1] = fmaf(cv.x, b1, acc[0][1]);
        acc[1][0] = fmaf(cv.y, b0, acc[1][0]); acc[1][1] = fmaf(cv.y, b1, acc[1][1]);
        acc[2][0] = fmaf(cv.z, b0, acc[2][0]); acc[2][1] = fmaf(cv.z, b1, acc[2][1]);
        acc[3][0] = fmaf(cv.w, b0, acc[3][0]); acc[3][1] = fmaf(cv.w, b1, acc[3][1]);
      }
      __syncthreads();  // the tile is restaged next
    }
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int row = warp * RPW + i;
      if (row >= nrows) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = n0 + lane + 32 * j;
        if (c < t_len)
          op[(long long)(i0 + row) * t_len + c] = rp[(i0 + row) * srt + c] + acc[i][j];
      }
    }
  }
}

template <typename T, bool RELU>
int launch(const void* grad, const void* attn, const float* r, float* out, int labels,
           int batch, int heads, int t_len, const long long* s, cudaStream_t stream) {
  const size_t smem = smem_bytes(t_len);
  cudaError_t err = cudaFuncSetAttribute(
      cam_accumulate_kernel<T, RELU>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)labels * batch * ((t_len + ROWS - 1) / ROWS);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cam_accumulate_kernel<T, RELU><<<(unsigned)blocks, NTHREADS, smem, stream>>>(
      static_cast<const T*>(grad), static_cast<const T*>(attn), r, out, labels, batch, heads,
      t_len, s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9]);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int cam_accumulate_max_tokens() { return T_MAX; }

// grad: (labels, batch, heads, t, t), attn: (batch, heads, t, t), both of
// dtype 0 = float32 or 1 = bfloat16; r: (labels, batch, t, t) float32; every
// last axis of unit stride. strides: grad's (l, b, h, row), attn's (b, h,
// row) and r's (l, b, row), in elements. out: contiguous (labels, batch, t,
// t) float32. positive_only: the ReLU. Returns a cudaError_t value (0 = ok).
int cam_accumulate_launch(const void* grad, const void* attn, const float* r, float* out,
                          int labels, int batch, int heads, int t_len,
                          const long long* strides, int positive_only, int dtype,
                          void* stream) {
  if (labels < 1 || batch < 1 || heads < 1 || t_len < 1 || t_len > T_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return positive_only
        ? launch<float, true>(grad, attn, r, out, labels, batch, heads, t_len, strides, st)
        : launch<float, false>(grad, attn, r, out, labels, batch, heads, t_len, strides, st);
  if (dtype == 1)
    return positive_only
        ? launch<__nv_bfloat16, true>(grad, attn, r, out, labels, batch, heads, t_len, strides, st)
        : launch<__nv_bfloat16, false>(grad, attn, r, out, labels, batch, heads, t_len, strides, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
