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
// What bounds it: reading q, k, v and writing out once, 4*B*T*W bytes of the
// input type (B = 48 tile rows: in bf16 14.7 MB at ViT-B/32's T = 50,
// W = 768, 4.4 us at 3.35 TB/s; 101 MB at ViT-L/14's T = 257, W = 1024,
// 30 us; 227 MB at T = 577, 68 us; twice that in f32). The products are
// 4*B*H*T^2*64 flops: 13 GFLOP at T = 257 and 65 GFLOP at T = 577, 13 us
// and 66 us on bf16 tensor cores. Both bodies run them on tensor cores: bf16
// directly, f32 as three TF32 products each (79 us and 0.40 ms at the dense
// TF32 rate of 495 TFLOP/s, above the f32 byte bound of 60 us and 0.14 ms;
// on f32 CUDA cores, 67 TFLOP/s, one product would take 0.19 ms and 0.97 ms).
// mma.sync reaches about 315 TFLOP/s in TF32 and 630 in bf16 on the H100
// (scripts/torch_mma_rate.py), which puts the f32 body's floor at 0.62 ms
// at T = 577. Measured times are in PERF.md.
//
// Both bodies: one CTA per (batch row, head, tile of query rows), 4 warps;
// the row tiles of one (b, h) are adjacent in the grid, so their K and V
// reads meet in L2. K and V go through shared memory by 16-byte cp.async in
// a two-stage ring: the copy of tile s + 1 runs under the MMAs of tile s.
// Instructions: mma.sync, cp.async. wgmma and TMA were not taken: a warp's
// 16 or 32 query rows against a key tile are mma.sync's shape; cp.async
// takes the strided q/k/v views (row stride 3W, head offset 128 bytes in
// bf16, 256 in f32: every row 16-byte aligned) with no tensor map; and
// wgmma takes tf32 operands only K-major from shared memory, which V in
// P V (N-major) is not, so the f32 body would also need V transposed and
// split in shared memory.
// Ragged edges: K, V and q rows >= T are zero-filled (V's zeros meet p = 0);
// key columns >= T are set to -inf (a zero-filled K row would give logit 0),
// and 8-key blocks wholly past T are skipped; query rows >= T are computed
// and not stored, and a warp whose rows are all >= T skips the arithmetic.
// Shared memory does not grow with T. A row's result does not depend on
// which CTA owns it, and no sum uses atomics: the kernels are deterministic.
//
// bf16 design (fused_mha_tc_kernel). 64 query rows a CTA, 16 a warp, 64-key
// tiles. Instructions: mma.sync m16n8k16 (bf16 in, f32 accumulate) and
// ldmatrix (.trans for V).
// - q: staged once by cp.async, then held by each warp as A fragments in
//   registers for the CTA's life.
// - K and V: bf16 in shared memory, never widened, in tiles of rows padded
//   to 72 elements (144 bytes: the 8 row addresses of an ldmatrix fall in 8
//   distinct 16-byte bank groups).
// - Softmax at JAX's rounding point. Pass one walks the K tiles: S = q k^T
//   by mma.sync in f32; the row max (quad shuffles: four lanes share a
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
// Shared memory: 5 tiles of 64 x 72 bf16 = 45 KB (q, and two stages of K
// and V); registers are capped at 128 so that 4 CTAs fit an SM. Three or
// four stages, 3 CTAs an SM, and 128-row query tiles (half the L2 reads of
// K and V) each measured slower at T = 257.
//
// f32 design (fused_mha_tf32_kernel). 128 query rows a CTA, 32 a warp (two
// m16 row tiles), 32-key tiles. Instructions: mma.sync m16n8k8 (tf32 in,
// f32 accumulate).
// - 3xTF32: each f32 operand x is split into big = tf32(x) and
//   small = x - big, and small*big + big*small + big*big accumulate in f32
//   (products of TF32 values are exact in f32), as in cam_accumulate.cu.
//   The error is about 2^-21 of the products' magnitude, inside the 1e-4
//   tolerance; one TF32 product (2^-11) is not. The split is three
//   instructions (split_tf32); cvt.rna.tf32.f32 has no instruction of its
//   own on sm_90 and a split by it costs several more, which the body feels
//   (scripts/torch_fused_mha_sweep.py).
// - One pass. At f32 the JAX rounding point (probs.astype(q.dtype)) is a
//   no-op, so no second pass over S is needed: each K and V tile is read
//   once. S = q k^T (3xTF32), keys >= T set to -inf, the running row max
//   and sum rescaled (O too) when the max grows, p = exp(c s - c max) as
//   2^(fma(...)) as in bf16, O += P V (3xTF32), and O times 1/sum once at
//   the store.
// - Fragments without shuffles. A k-step of 8 may take its 8 depth indices
//   in any order, as long as A and B agree. For S, k-slots tq and tq + 4
//   of lane (g, tq) take dims 2tq and 2tq + 1, so q's A fragment is one
//   float2 of each of rows g, g + 8 and K's B fragment one 64-bit shared
//   load. For P V, they take keys 2tq and 2tq + 1: exactly the columns of
//   the S accumulator the lane holds, so S's accumulators are P's A
//   fragments in place, and V's B fragment is V[2tq][g], V[2tq + 1][g].
// - Two row tiles a warp: each split B fragment (of K or of V) feeds six
//   MMAs, not three. The body is bound by instruction issue and latency,
//   not by the tensor pipe (the sweep's variant with one MMA in place of
//   three is far from three times faster), so halving the splits and loads
//   a MMA is what counts.
// - q: read once from global memory (float2 a lane), split, and kept as big
//   and small A fragments in shared memory (64 KB a CTA), where only the
//   lane that wrote them reads them, one 8-dim step at a time. In registers
//   they would take 128 words and push the body past 255 into spills.
// - K and V: f32 rows in shared memory, split at each use in registers (a
//   split copy would double the shared-memory reads). K rows are padded to
//   72 floats (the 64-bit loads of a half-warp cover 32 distinct banks), V
//   rows to 68 (lanes (g, tq) read rows 2tq, 2tq + 1 at column g: 32
//   distinct banks).
// Shared memory: q's fragments and two stages of a K and a V tile, 99 KB at
// any T <= 2048, 2 CTAs an SM; 205 registers, no spills. One row tile a
// warp (3 CTAs an SM) is faster at T <= 257 and slower at T = 577; 64-key
// tiles, three stages, and q in registers (raw or split) were slower
// (scripts/torch_fused_mha_sweep.py, PERF.md).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;          // head dim the kernels take
constexpr int T_MAX = 2048;     // tokens the kernels take (the wrapper's MAX_TOKENS)

// ---------------------------------------------------------------------------
// Shared by both bodies
// ---------------------------------------------------------------------------

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

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// 2^x (MUFU.EX2, relative error ~2^-22); exp(x) is taken as 2^(x log2 e)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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

// ---------------------------------------------------------------------------
// f32: tensor cores as 3xTF32 (mma.sync), f32 tiles staged by cp.async
// ---------------------------------------------------------------------------
namespace tf {

constexpr int NWARPS = 4;
constexpr int NTHREADS = 32 * NWARPS;
constexpr int MT = 2;                 // m16 row tiles of one warp: 32 query rows
constexpr int ROWS = 16 * MT * NWARPS;  // query rows of one CTA
constexpr int KEYS = 32;              // keys of one staged K or V tile
constexpr int KROW = HD + 8;          // padded K tile row (f32): 288 bytes
constexpr int VROW = HD + 4;          // padded V tile row (f32): 272 bytes
constexpr int NB = KEYS / 8;          // 8-key blocks of a logit tile
constexpr int DB = HD / 8;            // 8-dim blocks of the output and of q
constexpr int STAGES = 2;             // stages of the K/V ring
constexpr int MIN_BLOCKS = 2;         // CTAs an SM should hold (caps registers at 255)
constexpr int STAGE = KEYS * (KROW + VROW);                 // floats of one stage
constexpr int QFRAG = NWARPS * MT * DB * 2 * 32 * 4;        // floats of q's split fragments
constexpr size_t SMEM = sizeof(float) * (STAGE * STAGES + QFRAG);

// x = big + small. big is x rounded to TF32, to nearest with ties away
// (half of TF32's ulp added to the bits, the 13 bits TF32 drops cleared);
// small = x - big is exact in f32. The tensor core reads the top 19 bits
// of a .tf32 operand, so small goes in as it is and is cut to TF32 there.
// Three integer or f32 instructions; cvt.rna.tf32.f32 is emulated by
// several (see the header).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// d += a b: m16n8k8, tf32 operands, f32 accumulator
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d[mt] += a[mt] b for the warp's MT row tiles, as three TF32 products
// each: small(a) big(b) + big(a) small(b) + big(a) big(b). The f32 B
// fragment (b0, b1) is split here, once for all MT tiles.
__device__ __forceinline__ void mma_3xtf32(float (&d)[MT][4], const uint32_t (&abig)[MT][4],
                                           const uint32_t (&asmall)[MT][4], float b0, float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  split_tf32(b0, bb0, bs0);
  split_tf32(b1, bb1, bs1);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    mma_tf32(d[mt], asmall[mt], bb0, bb1);
    mma_tf32(d[mt], abig[mt], bs0, bs1);
    mma_tf32(d[mt], abig[mt], bb0, bb1);
  }
}

// Copy rows [j0, j0 + KEYS) of one head slice (row stride `stride`
// elements) into a tile of rows of `row` floats; rows at or past t_len are
// zero.
__device__ __forceinline__ void stage(uint32_t dst, int row, const float* src, long long stride,
                                      int j0, int t_len) {
#pragma unroll
  for (int it = 0; it < KEYS * (HD / 4) / NTHREADS; ++it) {
    const int i = threadIdx.x + it * NTHREADS;
    const int r = i / (HD / 4), c = i % (HD / 4);
    const bool ok = j0 + r < t_len;
    cp_async16(dst + 4 * (r * row + c * 4), src + (ok ? (long long)(j0 + r) * stride : 0) + c * 4,
               ok ? 16 : 0);
  }
}

// One warp's step over one K and V tile (keys j0 .. j0 + KEYS - 1): S, the
// online softmax, O += P V, for its MT row tiles. FULL: every key of the
// tile is < t_len (all tiles but a ragged last one), so no key needs a
// guard.
template <bool FULL>
__device__ __forceinline__ void tile_step(const float* kt, const float* vt, int j0, int t_len,
                                          const uint4* qf, float (&o)[DB][MT][4],
                                          float (&m_row)[MT][2], float (&l_row)[MT][2],
                                          float scale_log2e) {
  const int lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  // in the last tile, 8-key blocks wholly past T are skipped
  auto in = [&](int nb) { return FULL || j0 + nb * 8 < t_len; };
  // logits of the warp's rows against the tile's keys; q's split A
  // fragments come from shared memory, one 8-dim step at a time
  float sc[NB][MT][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      sc[nb][mt][0] = sc[nb][mt][1] = sc[nb][mt][2] = sc[nb][mt][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < DB; ++ks) {
    uint32_t qbig[MT][4], qsmall[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const uint4 bg = qf[((mt * DB + ks) * 2) * 32 + lane];
      const uint4 sm = qf[((mt * DB + ks) * 2 + 1) * 32 + lane];
      qbig[mt][0] = bg.x, qbig[mt][1] = bg.y, qbig[mt][2] = bg.z, qbig[mt][3] = bg.w;
      qsmall[mt][0] = sm.x, qsmall[mt][1] = sm.y, qsmall[mt][2] = sm.z, qsmall[mt][3] = sm.w;
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      if (in(nb)) {
        const float2 kv =
            *reinterpret_cast<const float2*>(kt + (nb * 8 + g) * KROW + ks * 8 + 2 * tq);
        mma_3xtf32(sc[nb], qbig, qsmall, kv.x, kv.y);
      }
  }
  if (!FULL) {  // every key past T is -inf
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (j0 + nb * 8 + 2 * tq + (i & 1) >= t_len) sc[nb][mt][i] = -INFINITY;
  }

  // the running max and sum, O rescaled to the new max; sc becomes p
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        mx = fmaxf(mx, fmaxf(sc[nb][mt][2 * r], sc[nb][mt][2 * r + 1]));
      const float m_new = fmaxf(m_row[mt][r], quad_max(mx));  // finite: key j0 < t_len
      const float alpha = ex2((m_row[mt][r] - m_new) * scale_log2e);  // 0 on the first tile
      const float mc = -m_new * scale_log2e;
      float sum = 0.f;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        float& p0 = sc[nb][mt][2 * r];
        float& p1 = sc[nb][mt][2 * r + 1];
        p0 = in(nb) ? ex2(fmaf(p0, scale_log2e, mc)) : 0.f;
        p1 = in(nb) ? ex2(fmaf(p1, scale_log2e, mc)) : 0.f;
        sum += p0 + p1;
      }
      l_row[mt][r] = l_row[mt][r] * alpha + sum;
      m_row[mt][r] = m_new;
#pragma unroll
      for (int dn = 0; dn < DB; ++dn) {
        o[dn][mt][2 * r] *= alpha;
        o[dn][mt][2 * r + 1] *= alpha;
      }
    }

  // O += P V: the accumulators of keys 8kk..8kk+7 are the A fragment of
  // step kk (k-slots tq, tq + 4 = keys 2tq, 2tq + 1)
#pragma unroll
  for (int kk = 0; kk < NB; ++kk) {
    if (!in(kk)) break;
    uint32_t pbig[MT][4], psmall[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      split_tf32(sc[kk][mt][0], pbig[mt][0], psmall[mt][0]);  // row g, key 2tq
      split_tf32(sc[kk][mt][2], pbig[mt][1], psmall[mt][1]);  // row g + 8, key 2tq
      split_tf32(sc[kk][mt][1], pbig[mt][2], psmall[mt][2]);  // row g, key 2tq + 1
      split_tf32(sc[kk][mt][3], pbig[mt][3], psmall[mt][3]);  // row g + 8, key 2tq + 1
    }
    const float* v0 = vt + (kk * 8 + 2 * tq) * VROW + g;
#pragma unroll
    for (int dn = 0; dn < DB; ++dn) mma_3xtf32(o[dn], pbig, psmall, v0[dn * 8], v0[VROW + dn * 8]);
  }
}

__global__ void __launch_bounds__(NTHREADS, MIN_BLOCKS)
fused_mha_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      int t_len, int width, int heads,
                      long long sqb, long long sqt, long long skb, long long skt,
                      long long svb, long long svt, float scale_log2e) {
  // STAGES stages of (K tile, V tile)
  extern __shared__ __align__(128) float tf_smem[];

  const int qtiles = (t_len + ROWS - 1) / ROWS;
  const int bh = blockIdx.x / qtiles;
  const int r0 = (blockIdx.x % qtiles) * ROWS;
  const int b = bh / heads, h = bh % heads, col = h * HD;
  const float* qb = q + b * sqb + col;
  const float* kb = k + b * skb + col;
  const float* vb = v + b * svb + col;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;  // accumulator row g (and g + 8), cols 2tq, 2tq + 1
  const int w0 = r0 + warp * 16 * MT;     // the warp's first row
  const bool live = w0 < t_len;           // warp-uniform: the warp has a row < T
  const int ntiles = (t_len + KEYS - 1) / KEYS;
  auto issue = [&](int s) {
    const uint32_t kt = smem_u32(tf_smem + STAGE * (s % STAGES));
    stage(kt, KROW, kb, skt, s * KEYS, t_len);
    stage(kt + 4 * KEYS * KROW, VROW, vb, svt, s * KEYS, t_len);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) issue(s);
    cp_async_commit();
  }

  // rows g and g + 8 of each of the warp's row tiles as A fragments, split
  // once into shared memory, where only this lane reads them back: in 8-dim
  // block ks, k-slots tq and tq + 4 are dims 2tq and 2tq + 1 (rows >= T
  // zero)
  uint4* qf = reinterpret_cast<uint4*>(tf_smem + STAGE * STAGES) + warp * MT * DB * 2 * 32;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int ra = w0 + mt * 16 + g, rb = ra + 8;
#pragma unroll
    for (int ks = 0; ks < DB; ++ks) {
      const float2 zero = make_float2(0.f, 0.f);
      const float2 xa = ra < t_len ? *reinterpret_cast<const float2*>(
                                         qb + (long long)ra * sqt + ks * 8 + 2 * tq) : zero;
      const float2 xb = rb < t_len ? *reinterpret_cast<const float2*>(
                                         qb + (long long)rb * sqt + ks * 8 + 2 * tq) : zero;
      uint4 bg, sm;
      split_tf32(xa.x, bg.x, sm.x);
      split_tf32(xb.x, bg.y, sm.y);
      split_tf32(xa.y, bg.z, sm.z);
      split_tf32(xb.y, bg.w, sm.w);
      qf[((mt * DB + ks) * 2) * 32 + lane] = bg;
      qf[((mt * DB + ks) * 2 + 1) * 32 + lane] = sm;
    }
  }

  // exp(c s - c max) = 2^(fma(s, c', -c' max)), c' = c log2 e, for raw logits s
  float m_row[MT][2];  // rows g, g + 8 of each row tile: running max of s
  float l_row[MT][2];  // and this lane's share of the running sum
  float o[DB][MT][4];  // unnormalised O
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m_row[mt][0] = m_row[mt][1] = -INFINITY;
    l_row[mt][0] = l_row[mt][1] = 0.f;
#pragma unroll
    for (int i = 0; i < DB; ++i) o[i][mt][0] = o[i][mt][1] = o[i][mt][2] = o[i][mt][3] = 0.f;
  }

  for (int s = 0; s < ntiles; ++s) {
    if (s + STAGES - 1 < ntiles) issue(s + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();  // tile s has landed
    __syncthreads();
    if (live) {
      const float* kt = tf_smem + STAGE * (s % STAGES);
      const int j0 = s * KEYS;
      if (j0 + KEYS <= t_len)
        tile_step<true>(kt, kt + KEYS * KROW, j0, t_len, qf, o, m_row, l_row, scale_log2e);
      else
        tile_step<false>(kt, kt + KEYS * KROW, j0, t_len, qf, o, m_row, l_row, scale_log2e);
    }
    __syncthreads();  // this stage is refilled by the issue of the next step
  }

  float* ob = out + (long long)b * t_len * width + col;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float inv = 1.f / quad_sum(l_row[mt][r]);
      const int row = w0 + mt * 16 + g + 8 * r;
      if (row >= t_len) continue;
      float2* orow = reinterpret_cast<float2*>(ob + (long long)row * width);
#pragma unroll
      for (int dn = 0; dn < DB; ++dn)
        orow[dn * 4 + tq] = make_float2(o[dn][mt][2 * r] * inv, o[dn][mt][2 * r + 1] * inv);
    }
}

}  // namespace tf

int launch_f32(const void* q, const void* k, const void* v, void* out, int b,
               int t_len, int width, int heads, long long sqb, long long sqt,
               long long skb, long long skt, long long svb, long long svt,
               cudaStream_t stream) {
  const long long blocks = (long long)b * heads * ((t_len + tf::ROWS - 1) / tf::ROWS);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      tf::fused_mha_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)tf::SMEM);
  if (err != cudaSuccess) return (int)err;
  const float scale_log2e = 1.4426950408889634f / sqrtf((float)HD);
  tf::fused_mha_tf32_kernel<<<(unsigned)blocks, tf::NTHREADS, tf::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), t_len, width, heads, sqb, sqt, skb, skt, svb, svt, scale_log2e);
  return (int)cudaGetLastError();
}

int launch_bf16(const void* q, const void* k, const void* v, void* out, int b,
                int t_len, int width, int heads, long long sqb, long long sqt,
                long long skb, long long skt, long long svb, long long svt,
                cudaStream_t stream) {
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
// batch / token strides (elements); rows 16-byte aligned (pointers and
// strides). out: contiguous (b, t_len, width). dtype: 0 = float32,
// 1 = bfloat16. Returns a cudaError_t value (0 = ok).
int fused_mha_launch(const void* q, const void* k, const void* v, void* out,
                     int b, int t_len, int width, int heads,
                     long long sqb, long long sqt, long long skb, long long skt,
                     long long svb, long long svt, int dtype, void* stream) {
  if (width != heads * HD || t_len < 1 || t_len > T_MAX || b < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  // cp.async moves 16 bytes: every row of q, k, v must start 16-byte aligned
  const long long per16 = dtype == 0 ? 4 : 8;  // elements in 16 bytes
  const uintptr_t ptrs = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out;
  if ((ptrs & 15) || ((sqb | sqt | skb | skt | svb | svt) & (per16 - 1)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32(q, k, v, out, b, t_len, width, heads, sqb, sqt, skb, skt, svb, svt, s);
  return launch_bf16(q, k, v, out, b, t_len, width, heads, sqb, sqt, skb, skt, svb, svt, s);
}

}  // extern "C"
