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
// unscaled. No mask and no probability output. The Pallas body scales the
// f32 logits, mha_reference scales q in the input type; at hd = 64 the scale
// is 2^-3, exact either way, and this kernel scales the f32 logits.
//
// What bounds it: reading q, k, v and writing out once, 4*B*T*W*2 bytes in
// bf16 (B = 48 tile rows: 14.7 MB at ViT-B/32's T = 50, W = 768, 4.4 us at
// 3.35 TB/s; 101 MB at ViT-L/14's T = 257, W = 1024, 30 us; 227 MB at
// T = 577, 68 us). The products are 4*B*H*T^2*64 flops: 13 GFLOP at T = 257
// and 65 GFLOP at T = 577, 13 us and 66 us on bf16 tensor cores, but 0.19 ms
// and 0.97 ms on f32 CUDA cores. So bf16 runs its products on tensor cores,
// where they stay under the byte bound even at half rate; f32 keeps a
// CUDA-core body (below the bf16 kernel's notes). Past the bytes, the
// design's own costs are its two passes (S computed twice) and two
// exponentials a logit on the MUFU unit; its measured times, several times
// the byte bound at T >= 257, are in PERF.md.
//
// bf16 design (fused_mha_tc_kernel). One CTA per (batch row, head, tile of
// 64 query rows), 4 warps of 16 rows; the row tiles of one (b, h) are
// adjacent in the grid, so their K and V reads meet in L2. Instructions:
// mma.sync m16n8k16 (bf16 in, f32 accumulate), ldmatrix (.trans for V) and
// 16-byte cp.async. wgmma and TMA were not taken: a warp's 16 query rows
// against 64-key tiles are mma.sync's shape, the kernel is bound by bytes,
// not by the tensor-core rate, and cp.async takes the strided q/k/v views
// (row stride 3W, head offset 128 bytes: every row 16-byte aligned) with no
// tensor map.
// - q: staged once by cp.async, then held by each warp as A fragments in
//   registers for the CTA's life.
// - K and V: bf16 in shared memory, never widened, in 64-key tiles of rows
//   padded to 72 elements (144 bytes: the 8 row addresses of an ldmatrix
//   fall in 8 distinct 16-byte bank groups). A two-stage cp.async ring:
//   the copy of step s + 1 runs under the MMAs of step s.
// - Softmax at JAX's rounding point. Pass one walks the K tiles: S = q k^T
//   by mma.sync in f32; key columns >= T are set to -inf (a zero-filled K
//   row would give logit 0); the row max (quad shuffles: four lanes share a
//   row of the m16n8 accumulator) and an online-rescaled sum in f32, each
//   exp(c s - c max) (c = hd^-0.5) taken as one FMA and one ex2.approx,
//   2^(fma(s, c log2 e, -c log2 e max)). Pass two walks K and V tiles again,
//   recomputes S with the same instructions (same values), forms
//   p = bf16(exp(c s - c max) / sum) (times the sum's inverse), the normalised
//   probability rounded as JAX rounds it, turns the S accumulator fragments
//   into A fragments, and accumulates O += P V by mma.sync with V read
//   through ldmatrix.trans. O is rounded to bf16 once, at the store.
//   Recomputing S spends tensor time that is idle anyway and keeps no
//   T-long row in shared memory. The softmax's ALU work, not the MMAs, held
//   the first tensor-core version (an accurate expf and a division an
//   element, in both passes); 2^x, one reciprocal a row and skipping 8-key
//   blocks wholly past T took most of that away.
// - Ragged edges: K, V and q rows >= T are zero-filled by cp.async (V's
//   zeros meet p = 0); query rows >= T are computed and not stored, and a
//   warp whose 16 rows are all >= T skips the arithmetic.
// Shared memory: 5 tiles of 64 x 72 bf16 = 45 KB (q, and two stages of K
// and V) at any T <= 2048; registers are capped at 128 so that 4 CTAs fit
// an SM. Three or four stages, 3 CTAs an SM, and 128-row query tiles (half
// the L2 reads of K and V) each measured slower at T = 257.
//
// f32 design (fused_mha_kernel, unchanged from the CUDA-core version): one
// block owns QROWS query rows of one (batch row, head) and keeps one f32
// probability row of T floats for each; K and then V go through shared
// memory in KTILE-key tiles. Pass one over the K tiles writes the scaled
// logits into the rows (lane j of a warp takes keys j, j + 32 of a tile),
// the softmax runs on each row in place (warp max and sum), and pass two
// over the V tiles accumulates the rounded probabilities times V (lane d
// takes output dims d, d + 32). Each warp owns four consecutive query rows
// and q is staged transposed, so one float4 gives a dim of all four rows: a
// loaded key value feeds four FMAs, and a loaded value row eight. Shared
// memory: (64 * QROWS + QROWS * T + KTILE * 65) f32. Tile rows are padded to
// hd + 1 floats so that lanes reading different keys hit different banks.
// A row's result does not depend on T's split into tiles or on which block
// owns the row. Moving f32 to 3xTF32 tensor cores is open work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;          // head dim the kernel takes
constexpr int T_MAX = 2048;     // tokens the kernel takes (the f32 body's 152 KB)

// ---------------------------------------------------------------------------
// f32: the CUDA-core body
// ---------------------------------------------------------------------------

constexpr int HDP = HD + 1;     // padded shared-memory row
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int QROWS = 16;       // query rows of one block
constexpr int QPW = QROWS / NWARPS;  // query rows of one warp (one float4)
constexpr int KTILE = 64;       // keys of one staged K or V tile
static_assert(QPW == 4, "a warp's query rows are one float4 of q transposed");

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

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


// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync), bf16 tiles staged by cp.async
// ---------------------------------------------------------------------------
namespace tc {

constexpr int ROWS = 64;              // query rows of one CTA, 16 a warp
constexpr int KEYS = 64;              // keys of one staged K or V tile
constexpr int NTHREADS = 128;         // 4 warps
constexpr int SROW = HD + 8;          // padded tile row (bf16): 144 bytes
constexpr int TILE = KEYS * SROW;     // bf16 elements of one tile
constexpr int NB = KEYS / 8;          // 8-key blocks of a logit tile
constexpr int DB = HD / 8;            // 8-dim blocks of the output
constexpr int KS = HD / 16;           // 16-dim steps of the logit product
constexpr int STAGES = 2;             // stages of the K/V ring
constexpr int MIN_BLOCKS = 4;         // CTAs an SM should hold (caps registers at 128)
constexpr size_t SMEM = sizeof(__nv_bfloat16) * TILE * (1 + 2 * STAGES);
static_assert(ROWS == 16 * (NTHREADS / 32), "a warp owns 16 query rows");
static_assert(KEYS == ROWS, "q and each K or V tile share one tile shape");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy to shared memory; src_bytes = 0 writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// d += a b: m16n8k16, bf16 operands, f32 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 values as one bf16x2 register, lo in the low half (round to
// nearest even)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Copy rows [j0, j0 + KEYS) of one head slice (row stride `stride`
// elements) into a padded tile; rows at or past t_len are zero.
__device__ __forceinline__ void stage(uint32_t dst, const __nv_bfloat16* src, long long stride,
                                      int j0, int t_len) {
#pragma unroll
  for (int it = 0; it < KEYS * (HD / 8) / NTHREADS; ++it) {
    const int i = threadIdx.x + it * NTHREADS;
    const int r = i / (HD / 8), c = i % (HD / 8);
    const bool ok = j0 + r < t_len;
    cp_async16(dst + 2 * (r * SROW + c * 8), src + (ok ? (long long)(j0 + r) * stride : 0) + c * 8,
               ok ? 16 : 0);
  }
}

// 2^x (MUFU.EX2, relative error ~2^-22); exp(x) is taken as 2^(x log2 e)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__global__ void __launch_bounds__(NTHREADS, MIN_BLOCKS)
fused_mha_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                    int t_len, int width, int heads,
                    long long sqb, long long sqt, long long skb, long long skt,
                    long long svb, long long svt, float scale_log2e) {
  // q tile, then STAGES stages of (K tile, V tile)
  extern __shared__ __align__(128) __nv_bfloat16 tc_smem[];

  const int qtiles = (t_len + ROWS - 1) / ROWS;
  const int bh = blockIdx.x / qtiles;
  const int r0 = (blockIdx.x % qtiles) * ROWS;
  const int b = bh / heads, h = bh % heads, col = h * HD;
  const __nv_bfloat16* qb = q + b * sqb + col;
  const __nv_bfloat16* kb = k + b * skb + col;
  const __nv_bfloat16* vb = v + b * svb + col;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;  // accumulator row g (and g + 8), cols 2tq, 2tq + 1
  const bool live = r0 + warp * 16 < t_len;  // warp-uniform: the warp has a row < T
  const int ntiles = (t_len + KEYS - 1) / KEYS;
  const int nsteps = 2 * ntiles;          // pass one: K tiles; pass two: K and V tiles
  const uint32_t qs = smem_u32(tc_smem);
  auto kbuf = [&](int s) { return qs + 2 * TILE * (1 + 2 * (s % STAGES)); };
  auto vbuf = [&](int s) { return qs + 2 * TILE * (2 + 2 * (s % STAGES)); };
  auto issue = [&](int s) {
    const int j0 = (s < ntiles ? s : s - ntiles) * KEYS;
    stage(kbuf(s), kb, skt, j0, t_len);
    if (s >= ntiles) stage(vbuf(s), vb, svt, j0, t_len);
  };

  stage(qs, qb, sqt, r0, t_len);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nsteps) issue(s);
    cp_async_commit();
  }

  // exp(c s - c max) = 2^(fma(s, c', -c' max)), c' = c log2 e, for raw logits s
  uint32_t qa[KS][4];                           // q rows as A fragments
  float m_row[2] = {-INFINITY, -INFINITY};      // rows g, g + 8: running max of s
  float l_row[2] = {0.f, 0.f};                  // this lane's share of the sum
  float o[DB][4];
#pragma unroll
  for (int i = 0; i < DB; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;

  for (int s = 0; s < nsteps; ++s) {
    if (s + STAGES - 1 < nsteps) issue(s + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();  // step s has landed
    __syncthreads();
    const bool second = s >= ntiles;
    const int j0 = (second ? s - ntiles : s) * KEYS;
    if (live) {
      if (s == 0) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          ldsm_x4(qs + 2 * ((warp * 16 + (lane & 15)) * SROW + ks * 16 + (lane >> 4) * 8),
                  qa[ks]);
      }
      // logits of the warp's 16 rows against the tile's 64 keys; 8-key
      // blocks wholly past T are skipped, and in the last tile every key
      // past T is -inf
      float sc[NB][4];
      const uint32_t kt = kbuf(s);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        sc[nb][0] = sc[nb][1] = sc[nb][2] = sc[nb][3] = 0.f;
        if (j0 + nb * 8 < t_len) {
#pragma unroll
          for (int kp = 0; kp < KS; kp += 2) {
            uint32_t bk[4];
            ldsm_x4(kt + 2 * ((nb * 8 + (lane & 7)) * SROW + kp * 16 + (lane >> 3) * 8), bk);
            mma_bf16(sc[nb], qa[kp], bk[0], bk[1]);
            mma_bf16(sc[nb], qa[kp + 1], bk[2], bk[3]);
          }
        }
      }
      if (j0 + KEYS > t_len) {
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (j0 + nb * 8 + 2 * tq + (i & 1) >= t_len) sc[nb][i] = -INFINITY;
      }

      if (!second) {
        // row max over the tile, then the running sum rescaled to it
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = -INFINITY;
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) mx = fmaxf(mx, fmaxf(sc[nb][2 * r], sc[nb][2 * r + 1]));
          const float m_new = fmaxf(m_row[r], quad_max(mx));  // finite: key j0 < t_len
          const float mc = -m_new * scale_log2e;
          float sum = 0.f;
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
            if (j0 + nb * 8 < t_len)
              sum += ex2(fmaf(sc[nb][2 * r], scale_log2e, mc)) +
                     ex2(fmaf(sc[nb][2 * r + 1], scale_log2e, mc));
          l_row[r] = l_row[r] * ex2((m_row[r] - m_new) * scale_log2e) + sum;
          m_row[r] = m_new;
        }
        if (s == ntiles - 1) {  // the sums become their inverses, the maxima -c' max
          l_row[0] = 1.f / quad_sum(l_row[0]);
          l_row[1] = 1.f / quad_sum(l_row[1]);
          m_row[0] *= -scale_log2e;
          m_row[1] *= -scale_log2e;
        }
      } else {
        // p = bf16(exp(s - max) / sum); the accumulators of keys
        // 16kk..16kk+15 are the A fragment of step kk of P V
        const uint32_t vt = vbuf(s);
#pragma unroll
        for (int kk = 0; kk < KEYS / 16; ++kk) {
          if (j0 + kk * 16 >= t_len) break;
          uint32_t pa[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {  // a0..a3: (row g, nb 2kk), (g + 8, 2kk), (g, 2kk + 1), ..
            const int nb = 2 * kk + i / 2, r = i % 2;
            pa[i] = pack_bf16(ex2(fmaf(sc[nb][2 * r], scale_log2e, m_row[r])) * l_row[r],
                              ex2(fmaf(sc[nb][2 * r + 1], scale_log2e, m_row[r])) * l_row[r]);
          }
#pragma unroll
          for (int dp = 0; dp < DB; dp += 2) {
            uint32_t bv[4];
            ldsm_x4_trans(vt + 2 * ((kk * 16 + (lane & 15)) * SROW + dp * 8 + (lane >> 4) * 8),
                          bv);
            mma_bf16(o[dp], pa, bv[0], bv[1]);
            mma_bf16(o[dp + 1], pa, bv[2], bv[3]);
          }
        }
      }
    }
    __syncthreads();  // this stage is refilled by the issue of the next step
  }

  __nv_bfloat16* ob = out + (long long)b * t_len * width + col;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + warp * 16 + g + 8 * r;
    if (row >= t_len) continue;
    uint32_t* orow = reinterpret_cast<uint32_t*>(ob + (long long)row * width);
#pragma unroll
    for (int dn = 0; dn < DB; ++dn) orow[dn * 4 + tq] = pack_bf16(o[dn][2 * r], o[dn][2 * r + 1]);
  }
}

}  // namespace tc

int launch_f32(const void* q, const void* k, const void* v, void* out, int b,
               int t_len, int width, int heads, long long sqb, long long sqt,
               long long skb, long long skt, long long svb, long long svt,
               cudaStream_t stream) {
  const size_t smem = smem_bytes(t_len);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mha_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)b * heads * ((t_len + QROWS - 1) / QROWS);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const float scale = 1.0f / sqrtf((float)HD);
  fused_mha_kernel<float><<<(unsigned)blocks, NTHREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), t_len, width, heads, sqb, sqt, skb, skt, svb, svt, scale);
  return (int)cudaGetLastError();
}

int launch_bf16(const void* q, const void* k, const void* v, void* out, int b,
                int t_len, int width, int heads, long long sqb, long long sqt,
                long long skb, long long skt, long long svb, long long svt,
                cudaStream_t stream) {
  // cp.async moves 16 bytes: every row of q, k, v must start 16-byte aligned
  const uintptr_t ptrs = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out;
  if ((ptrs & 15) || ((sqb | sqt | skb | skt | svb | svt) & 7)) return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)b * heads * ((t_len + tc::ROWS - 1) / tc::ROWS);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      tc::fused_mha_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)tc::SMEM);
  if (err != cudaSuccess) return (int)err;
  const float scale_log2e = 1.4426950408889634f / sqrtf((float)HD);
  tc::fused_mha_tc_kernel<<<(unsigned)blocks, tc::NTHREADS, tc::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), t_len, width, heads,
      sqb, sqt, skb, skt, svb, svt, scale_log2e);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int fused_mha_head_dim() { return HD; }
int fused_mha_max_tokens() { return T_MAX; }

// q, k, v: (b, t_len, width) with unit stride on the last axis and the given
// batch / token strides (elements); bf16 rows 16-byte aligned (pointers and
// strides). out: contiguous (b, t_len, width). dtype: 0 = float32,
// 1 = bfloat16. Returns a cudaError_t value (0 = ok).
int fused_mha_launch(const void* q, const void* k, const void* v, void* out,
                     int b, int t_len, int width, int heads,
                     long long sqb, long long sqt, long long skb, long long skt,
                     long long svb, long long svt, int dtype, void* stream) {
  if (width != heads * HD || t_len < 1 || t_len > T_MAX || b < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32(q, k, v, out, b, t_len, width, heads, sqb, sqt, skb, skt, svb, svt, s);
  if (dtype == 1)
    return launch_bf16(q, k, v, out, b, t_len, width, heads, sqb, sqt, skb, skt, svb, svt, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
