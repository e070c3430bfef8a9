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
// What bounds it: bytes. At the ViT-L/14 tile chunk (L = 9 labels, B = 48
// tiles, H = 16, T = 257, bf16) one launch reads grad 913 MB, attn 101 MB
// and R 114 MB and writes out 114 MB: 1.24 GB, 0.37 ms at 3.35 TB/s. The
// product is 2*L*B*T^3 = 14.7 GFLOP: 0.22 ms on f32 CUDA cores, more than
// half the byte bound, so it goes to tensor cores as three TF32 products
// (44 GFLOP, 0.09 ms at 495 TFLOP/s). Instructions: 16-byte global loads,
// 4-byte cp.async, ldmatrix and mma.sync m16n8k8 tf32. wgmma and TMA were
// not taken: at T = 257 no row of grad, attn or R is 16-byte aligned (a
// bf16 row is 514 bytes, an f32 row 1028), which TMA's tensor maps refuse,
// and wgmma's tf32 operands must come K-major from shared memory, which R
// (N-major) is not.
//
// A CTA of 8 warps owns ROWS output rows of one (l, b): 64 where two such
// CTAs fit an SM (T <= 312), else 32 (any T <= 1024).
//
// 1. Cam phase. With row strides equal to T (autograd's output), a CTA's
//    rows of one head are one flat run of ROWS*T elements. A thread owns
//    16-byte groups of the run and sums relu?(grad * attn) over the heads in
//    order, in registers, with the loads of HB = 4 heads of grad and attn
//    in flight at once. A head's run starts anywhere within 16 bytes (at
//    T = 257, T*T*2 bytes is 2 mod 16), so each group is read as the one or
//    two aligned 16-byte words that hold it and shifted into place (word
//    select, funnel shift); only words that hold a valid byte are read. The
//    mean goes into the cam strip (ROWS x CS f32 in shared memory,
//    CS = round8(T) + 4, zero past T). Other strides take a scalar loop.
// 2. Product, 3xTF32 on tensor cores: each f32 operand x is split into
//    big = tf32(x) (cvt.rna) and small = tf32(x - big), and
//    small*big + big*small + big*big accumulate in f32 (products of TF32
//    values are exact in f32). The error is about 2^-21 of |cam| @ |R|,
//    inside the 1e-5 tolerance; one TF32 product (2^-11) is not. The
//    tensor core's f32 accumulation truncates, and over T = 1024 that error
//    grew past 1e-5, so each R tile's MMAs go into a fresh accumulator that
//    is added to the running sum in f32. Warps tile the rows by 16 and the
//    columns by 32 (4 mma blocks of 8) over passes of 64 (ROWS 64) or 128
//    (ROWS 32) columns. A fragments: ldmatrix from the cam strip
//    (conflict-free: CS = 4 mod 8), split per use. B fragments: R tiles of
//    32 or 16 rows, staged by 4-byte cp.async (R's rows are not 16-byte
//    aligned at odd T) into a double buffer, the copy of tile s + 1 under
//    the MMAs of tile s, then split once in place into (big, small) pairs,
//    so that one 64-bit load gives both halves (rows padded to 4 mod 16
//    pairs: conflict-free). R is read through its strides (the first R of
//    the gradcam is an identity expanded with stride 0 over l and b); rows
//    and columns past T are zero-filled.
// 3. The thin path: a last pass narrower than one mma block (T = 257 is
//    4 x 64 + 1 columns) and a strip of fewer than 16 rows (257 rows leave
//    one) would cost a whole pass of R tiles for a few outputs; those
//    outputs are f32 FMA chains over k on CUDA cores instead.
// 4. The CTA writes R's rows plus the product; R's values for a pass are
//    loaded together before the stores.
//
// The block index runs over l fastest, then the row group, then b: the L
// CTAs that read the same rows of attn run together and find them in L2,
// and the row groups of one (l, b) read the same R, which stays in L2 too
// (5 reads of R per (l, b) at T = 257). Every sum runs in a fixed order, so
// the result is deterministic.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int NBW = 4;                     // mma column blocks (8 columns) of one warp
constexpr int HB = 4;                      // heads whose loads a thread has in flight
constexpr int T_MAX = 1024;                // shared-memory bound (165 KB at 32 rows)
constexpr size_t SMEM_TWO_PER_SM = 113 * 1024;  // the largest CTA of which two fit an SM

template <int ROWS> struct Tiling {
  static constexpr int WM = ROWS / 16;           // warps along the rows
  static constexpr int WN = NWARPS / WM;         // warps along the columns
  static constexpr int NCHUNK = WN * NBW * 8;    // output columns of one pass: 64 or 128
  static constexpr int KT = 2048 / NCHUNK;       // rows of one R tile: 32 or 16
  static constexpr int RS = NCHUNK + 4;          // R tile row ((big, small) pairs): 4 mod 16
  static constexpr int TILE = KT * RS;           // pairs of one tile
  static constexpr int PER_THREAD = KT * NCHUNK / NTHREADS;  // elements a thread stages
  static_assert(WM * WN == NWARPS, "warps tile the block");
};

__host__ __device__ __forceinline__ int cam_stride(int t) { return ((t + 7) & ~7) + 4; }

// the cam strip, then two stages of R tiles of (big, small) pairs
template <int ROWS> size_t smem_bytes(int t) {
  return sizeof(float) * ROWS * cam_stride(t) + sizeof(float2) * 2 * Tiling<ROWS>::TILE;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 4-byte async copy; src_bytes = 0 writes a zero
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// The 16-byte group of elements that starts at p (p is 16-byte aligned up
// to the strip's own offset, the same for every group of the strip): the
// one or two aligned 16-byte words that hold its n valid elements. Only
// words holding a valid byte are read.
template <typename T>
__device__ __forceinline__ void load_window(const T* p, int n, uint4 (&w)[2]) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p), a0 = a & ~(uintptr_t)15;
  w[0] = *reinterpret_cast<const uint4*>(a0);
  w[1] = ((a + n * sizeof(T) - 1) & ~(uintptr_t)15) != a0
             ? *reinterpret_cast<const uint4*>(a0 + 16) : make_uint4(0u, 0u, 0u, 0u);
}

// The group's elements, widened to f32, from its window; off = the strip's
// offset within 16 bytes.
__device__ __forceinline__ void window_words(const uint4 (&w)[2], int off, uint32_t (&y)[5]) {
  const uint32_t x[8] = {w[0].x, w[0].y, w[0].z, w[0].w, w[1].x, w[1].y, w[1].z, w[1].w};
  const int wo = off >> 2;
#pragma unroll
  for (int i = 0; i < 5; ++i)
    y[i] = wo == 0 ? x[i] : wo == 1 ? x[i + 1] : wo == 2 ? x[i + 2] : x[i + 3];
}
__device__ __forceinline__ void unpack(const uint4 (&w)[2], int off, float (&v)[4]) {
  uint32_t y[5];
  window_words(w, off, y);
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = __uint_as_float(y[i]);
}
__device__ __forceinline__ void unpack(const uint4 (&w)[2], int off, float (&v)[8]) {
  uint32_t y[5];
  window_words(w, off, y);
  const uint32_t sh = (off & 2) * 8;  // a bf16 strip may start 2 bytes into a word
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t z = __funnelshift_r(y[i], y[i + 1], sh);  // elements 2i, 2i + 1
    v[2 * i] = __uint_as_float(z << 16);
    v[2 * i + 1] = __uint_as_float(z & 0xffff0000u);
  }
}

// x = big + small, both TF32 (round to nearest, ties away)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(x - __uint_as_float(big)));
}

// d += a b: m16n8k8, tf32 operands, f32 accumulator
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 1. cam rows = mean over heads of relu?(grad * attn), into a strip.
template <typename T, bool RELU>
__device__ __forceinline__ void cam_rows(const T* gp, const T* ap, int nrows, int t_len, int heads,
                                         long long sgh, long long sgt, long long sah,
                                         long long sat, float* cam, int cs) {
  if (sgt == t_len && sat == t_len) {
    // the strip of one head is a flat run of nrows * T elements; a thread
    // owns 16-byte groups of it and has HB heads' loads in flight at once
    constexpr int G = 16 / sizeof(T);
    const int n_el = nrows * t_len;
    for (int e = G * threadIdx.x; e < n_el; e += G * NTHREADS) {
      const int n = min(G, n_el - e);
      float acc[G];
      for (int h0 = 0; h0 < heads; h0 += HB) {
        uint4 gw[HB][2], aw[HB][2];
#pragma unroll
        for (int j = 0; j < HB; ++j)
          if (h0 + j < heads) {
            load_window(gp + (h0 + j) * sgh + e, n, gw[j]);
            load_window(ap + (h0 + j) * sah + e, n, aw[j]);
          }
#pragma unroll
        for (int j = 0; j < HB; ++j)
          if (h0 + j < heads) {
            float gv[G], av[G];
            unpack(gw[j], (int)(reinterpret_cast<uintptr_t>(gp + (h0 + j) * sgh) & 15), gv);
            unpack(aw[j], (int)(reinterpret_cast<uintptr_t>(ap + (h0 + j) * sah) & 15), av);
#pragma unroll
            for (int i = 0; i < G; ++i) {
              float x = gv[i] * av[i];
              if (RELU) x = fmaxf(x, 0.f);
              acc[i] = h0 + j == 0 ? x : acc[i] + x;
            }
          }
      }
      int row = e / t_len, k = e - row * t_len;
#pragma unroll
      for (int i = 0; i < G; ++i) {
        if (i < n) cam[row * cs + k] = acc[i] / (float)heads;
        if (++k == t_len) k = 0, ++row;
      }
    }
  } else {
    for (int e = threadIdx.x; e < nrows * t_len; e += NTHREADS) {
      const int row = e / t_len, k = e - row * t_len;
      const T* gq = gp + row * sgt + k;
      const T* aq = ap + row * sat + k;
      float s = 0.f;
#pragma unroll 4
      for (int h = 0; h < heads; ++h) {
        float c = to_f32(gq[h * sgh]) * to_f32(aq[h * sah]);
        if (RELU) c = fmaxf(c, 0.f);
        s += c;
      }
      cam[row * cs + k] = s / (float)heads;
    }
  }
}

// 2-3. out rows = R rows + cam rows @ R, 3xTF32 on tensor cores.
template <int ROWS>
__device__ __forceinline__ void product(const float* cam, int cs, float2* rt, const float* rp,
                                        long long srt, float* op, int i0, int nrows, int t_len) {
  using TL = Tiling<ROWS>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int wm = warp % TL::WM, wn = warp / TL::WM;
  const bool active = wm * 16 < nrows;  // warp-uniform
  const int kpad = (t_len + 7) & ~7;
  const int nkt = (t_len + TL::KT - 1) / TL::KT;
  // Tensor cores take the columns up to the last pass that is at least one
  // mma block (8 columns) wide, and not a strip of fewer than 16 rows; the
  // thin path below takes the rest on CUDA cores.
  const int rem = t_len % TL::NCHUNK;
  const int mma_cols = nrows < 16 ? 0 : rem > 0 && rem < 8 ? t_len - rem : t_len;
  const int nsteps = (mma_cols + TL::NCHUNK - 1) / TL::NCHUNK * nkt;  // (column pass, R tile)
  __syncthreads();  // the cam strip is complete
  // a thread copies elements threadIdx.x + i * NTHREADS of a tile into the .x of
  // their pairs, then splits them in place; zero past T
  auto issue_r = [&](int s) {
    const int n0 = (s / nkt) * TL::NCHUNK, k0 = (s % nkt) * TL::KT;
    float2* t = rt + (s & 1) * TL::TILE;
#pragma unroll
    for (int it = 0; it < TL::PER_THREAD; ++it) {
      const int i = threadIdx.x + it * NTHREADS;
      const int kk = i / TL::NCHUNK, c = i % TL::NCHUNK;
      const bool ok = k0 + kk < t_len && n0 + c < t_len;
      cp_async4(smem_u32(&t[kk * TL::RS + c].x),
                rp + (ok ? (long long)(k0 + kk) * srt + n0 + c : 0), ok ? 4 : 0);
    }
  };
  const uint32_t cam_a = smem_u32(cam + (wm * 16 + (lane & 15)) * cs + (lane >> 4) * 4);

  float acc[NBW][4];
  if (nsteps > 0) issue_r(0);
  cp_async_commit();
  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait_all();  // this thread's copies of tile s have landed
    {
      float2* t = rt + (s & 1) * TL::TILE;
#pragma unroll
      for (int it = 0; it < TL::PER_THREAD; ++it) {
        const int i = threadIdx.x + it * NTHREADS;
        float2& e = t[(i / TL::NCHUNK) * TL::RS + i % TL::NCHUNK];
        uint32_t hi, lo;
        split_tf32(e.x, hi, lo);
        e = make_float2(__uint_as_float(hi), __uint_as_float(lo));
      }
    }
    __syncthreads();  // tile s is split; every thread is done with tile s - 1
    if (s + 1 < nsteps) issue_r(s + 1);
    cp_async_commit();
    const int kt = s % nkt, n0 = (s / nkt) * TL::NCHUNK, k0 = kt * TL::KT;
    if (kt == 0) {
#pragma unroll
      for (int nb = 0; nb < NBW; ++nb) acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
    }
    if (!active) continue;
    const float2* rs = rt + (s & 1) * TL::TILE;
    float part[NBW][4];  // this tile's share, added to acc in f32
#pragma unroll
    for (int nb = 0; nb < NBW; ++nb) part[nb][0] = part[nb][1] = part[nb][2] = part[nb][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < TL::KT / 8; ++kk) {
      const int kg = k0 + kk * 8;
      if (kg >= kpad) break;
      uint32_t a[4], abig[4], asmall[4];
      ldsm_x4(cam_a + 4 * kg, a);
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(a[i]), abig[i], asmall[i]);
#pragma unroll
      for (int nb = 0; nb < NBW; ++nb) {
        const int cl = (wn * NBW + nb) * 8;
        if (n0 + cl >= t_len) break;
        const float2 b0 = rs[(kk * 8 + tq) * TL::RS + cl + g];
        const float2 b1 = rs[(kk * 8 + tq + 4) * TL::RS + cl + g];
        mma_tf32(part[nb], asmall, __float_as_uint(b0.x), __float_as_uint(b1.x));
        mma_tf32(part[nb], abig, __float_as_uint(b0.y), __float_as_uint(b1.y));
        mma_tf32(part[nb], abig, __float_as_uint(b0.x), __float_as_uint(b1.x));
      }
    }
#pragma unroll
    for (int nb = 0; nb < NBW; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nb][i] += part[nb][i];
    if (kt == nkt - 1) {
      // all of R's loads first (clamped into the matrix), then the stores
      float rr[NBW][4];
#pragma unroll
      for (int nb = 0; nb < NBW; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = min(wm * 16 + g + 8 * (i / 2), nrows - 1);
          const int c = min(n0 + (wn * NBW + nb) * 8 + 2 * tq + (i % 2), t_len - 1);
          rr[nb][i] = __ldg(rp + (i0 + row) * srt + c);
        }
#pragma unroll
      for (int nb = 0; nb < NBW; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = wm * 16 + g + 8 * (i / 2);
          const int c = n0 + (wn * NBW + nb) * 8 + 2 * tq + (i % 2);
          if (row < nrows && c < t_len)
            op[(long long)(i0 + row) * t_len + c] = rr[nb][i] + acc[nb][i];
        }
    }
  }
  // the thin path: columns [mma_cols, T) of every row, one f32 FMA chain an
  // output over k in order
  const int ncols = t_len - mma_cols;
  for (int e = threadIdx.x; e < nrows * ncols; e += NTHREADS) {
    const int row = e / ncols, c = mma_cols + e % ncols;
    const float* cr = cam + row * cs;
    float sum = 0.f;
    for (int k = 0; k < t_len; ++k) sum = fmaf(cr[k], __ldg(rp + k * srt + c), sum);
    op[(long long)(i0 + row) * t_len + c] = __ldg(rp + (i0 + row) * srt + c) + sum;
  }
}

template <typename T, bool RELU, int ROWS>
__global__ void __launch_bounds__(NTHREADS, 2)
cam_accumulate_kernel(const T* __restrict__ grad, const T* __restrict__ attn,
                      const float* __restrict__ r, float* __restrict__ out,
                      int labels, int batch, int heads, int t_len,
                      long long sgl, long long sgb, long long sgh, long long sgt,
                      long long sab, long long sah, long long sat,
                      long long srl, long long srb, long long srt) {
  extern __shared__ __align__(16) float smem[];
  const int cs = cam_stride(t_len);
  float* cam = smem;                                         // ROWS x cs
  float2* rt = reinterpret_cast<float2*>(smem + ROWS * cs);  // 2 x KT x RS

  // the cam strip starts at zero: rows past nrows and columns past T stay so
  for (int i = threadIdx.x; i < ROWS * cs / 4; i += NTHREADS)
    reinterpret_cast<float4*>(cam)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  // labels fastest: the L CTAs of one (row group, b) share attn in L2
  const int groups = (t_len + ROWS - 1) / ROWS;
  const int l = blockIdx.x % labels;
  const int i0 = (blockIdx.x / labels) % groups * ROWS;
  const int b = blockIdx.x / labels / groups;
  const int nrows = min(ROWS, t_len - i0);
  cam_rows<T, RELU>(grad + l * sgl + b * sgb + i0 * sgt, attn + b * sab + i0 * sat, nrows, t_len,
                    heads, sgh, sgt, sah, sat, cam, cs);
  product<ROWS>(cam, cs, rt, r + l * srl + b * srb, srt,
                out + ((long long)l * batch + b) * t_len * t_len, i0, nrows, t_len);
}

template <typename T, bool RELU, int ROWS>
int launch_rows(const void* grad, const void* attn, const float* r, float* out, int labels,
                int batch, int heads, int t_len, const long long* s, cudaStream_t stream) {
  const size_t smem = smem_bytes<ROWS>(t_len);
  cudaError_t err = cudaFuncSetAttribute(
      cam_accumulate_kernel<T, RELU, ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)labels * batch * ((t_len + ROWS - 1) / ROWS);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cam_accumulate_kernel<T, RELU, ROWS><<<(unsigned)blocks, NTHREADS, smem, stream>>>(
      static_cast<const T*>(grad), static_cast<const T*>(attn), r, out, labels, batch, heads,
      t_len, s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9]);
  return (int)cudaGetLastError();
}

// 64 rows a CTA where two such CTAs fit an SM, else 32
template <typename T, bool RELU>
int launch(const void* grad, const void* attn, const float* r, float* out, int labels,
           int batch, int heads, int t_len, const long long* s, cudaStream_t stream) {
  if (smem_bytes<64>(t_len) <= SMEM_TWO_PER_SM)
    return launch_rows<T, RELU, 64>(grad, attn, r, out, labels, batch, heads, t_len, s, stream);
  return launch_rows<T, RELU, 32>(grad, attn, r, out, labels, batch, heads, t_len, s, stream);
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
