// Native host-side input-pipeline kernels.
//
// The reference feeds 8 GPUs at batch 1 from a python DataLoader doing
// 400k-of-1M weighted subsampling + fancy-indexed gathers per sample
// (reference: dataset.py:106-166, utils.py:506-520) — host-bound work the
// SURVEY flags as the input bottleneck for a TPU pod. These kernels give
// the loader a parallel native path (OpenMP when compiled with -fopenmp):
//
// - weighted sampling without replacement via Efraimidis-Spirakis
//   exponential keys + nth_element (distribution identical to sequential
//   weighted draws; uniforms supplied by the caller so numpy RandomState
//   determinism is preserved)
// - row gathers for float32 / int32 / uint8 matrices
// - axis-1 gathers for (P, N, C) stacked per-patch arrays
//
// Built as a tiny shared library via ctypes (no pybind11 in this image).
#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// keys_i = -log(u_i) / w_i ; returns the k smallest-key indices in out_idx.
// Infeasible draws (fewer than k positive weights) return -1.
int weighted_sample_without_replacement(
    int64_t n, int64_t k, const double* weights, const double* uniforms,
    int64_t* out_idx) {
  if (k > n) return -1;
  int64_t positive = 0;
  std::vector<double> keys(n);
#pragma omp parallel for reduction(+ : positive) schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const double w = weights[i];
    if (w > 0.0) {
      ++positive;
      // u in (0, 1]; -log(u) ~ Exp(1)
      const double u = uniforms[i] > 0.0 ? uniforms[i] : 1e-300;
      keys[i] = -std::log(u) / w;
    } else {
      keys[i] = HUGE_VAL;
    }
  }
  if (positive < k) return -1;
  if (k == n) {
    std::iota(out_idx, out_idx + k, int64_t{0});
    return 0;
  }
  // nth_element over VALUES (no index indirection — ~2x faster at the
  // 400k-of-1M scale), then two sequential passes collect the k smallest;
  // ties at the threshold fill in index order.
  std::vector<double> vals(keys);
  std::nth_element(vals.begin(), vals.begin() + (k - 1), vals.end());
  const double thresh = vals[k - 1];
  int64_t m = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (keys[i] < thresh) out_idx[m++] = i;
  }
  for (int64_t i = 0; i < n && m < k; ++i) {
    if (keys[i] == thresh) out_idx[m++] = i;
  }
  return m == k ? 0 : -1;
}

// inverse-CDF sampling with replacement; cdf is the inclusive prefix sum
// of the weights and draws are uniforms scaled by cdf[n-1] by the caller.
int weighted_sample_with_replacement(
    int64_t n, int64_t k, const double* cdf, const double* draws,
    int64_t* out_idx) {
#pragma omp parallel for schedule(static)
  for (int64_t j = 0; j < k; ++j) {
    const double* hi = std::upper_bound(cdf, cdf + n, draws[j]);
    int64_t idx = static_cast<int64_t>(hi - cdf);
    out_idx[j] = idx < n ? idx : n - 1;
  }
  return 0;
}

// Walker/Vose alias-method sampling with replacement: O(n) table build +
// O(1) per draw, replacing the O(k log n) cache-hostile cdf binary
// searches (the reference regime draws k=400k of n~1M per sample —
// measured 178 -> ~40 ms serial). u is one caller-supplied uniform array
// in [0,1) (numpy RandomState stays the only entropy source); the bucket
// index is floor(u*n) and the accept draw is the fractional part of u*n —
// independent uniforms from a single draw.
int weighted_sample_alias(
    int64_t n, int64_t k, const double* weights, double wsum,
    const double* u, int64_t* out_idx) {
  if (wsum <= 0.0) return -1;
  std::vector<double> prob(n);
  std::vector<int64_t> alias(n);
  // classic two-stack build over scaled weights p_i = w_i * n / wsum
  std::vector<int64_t> small, large;
  small.reserve(n);
  large.reserve(n);
  const double scale = static_cast<double>(n) / wsum;
  for (int64_t i = 0; i < n; ++i) {
    prob[i] = weights[i] > 0.0 ? weights[i] * scale : 0.0;
    alias[i] = i;
    (prob[i] < 1.0 ? small : large).push_back(i);
  }
  while (!small.empty() && !large.empty()) {
    const int64_t s = small.back();
    small.pop_back();
    const int64_t l = large.back();
    alias[s] = l;
    prob[l] = (prob[l] + prob[s]) - 1.0;
    if (prob[l] < 1.0) {
      large.pop_back();
      small.push_back(l);
    }
  }
  // leftovers are 1.0 up to roundoff
  for (int64_t i : small) prob[i] = 1.0;
  for (int64_t i : large) prob[i] = 1.0;
#pragma omp parallel for schedule(static)
  for (int64_t j = 0; j < k; ++j) {
    const double un = u[j] * n;
    int64_t i = static_cast<int64_t>(un);
    if (i >= n) i = n - 1;
    const double frac = un - static_cast<double>(i);
    out_idx[j] = frac < prob[i] ? i : alias[i];
  }
  return 0;
}

// in-bounds mask: lo <= p <= hi on all 3 coords (inclusive both ends,
// matching filter_pts_bounds semantics, reference point_cloud.py:24-31).
int bounds_mask_f32(int64_t n, const float* pts, const double* lo,
                    const double* hi, uint8_t* out) {
  const double l0 = lo[0], l1 = lo[1], l2 = lo[2];
  const double h0 = hi[0], h1 = hi[1], h2 = hi[2];
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const double x = pts[i * 3], y = pts[i * 3 + 1], z = pts[i * 3 + 2];
    out[i] = (x >= l0) & (x <= h0) & (y >= l1) & (y <= h1) & (z >= l2) &
             (z <= h2);
  }
  return 0;
}

// frustum membership of world points: cam = inv_pose @ p; px/py from
// intrinsics; in-frame and z > 0 (reference point_cloud.py:88-110).
// Double arithmetic ordered exactly as the numpy twin
// (check_pts_in_frustum_np) so masks are bit-identical.
int frustum_mask_f32(int64_t n, const float* pts, const double* inv_rt,
                     double fx, double fy, double cx, double cy, int64_t h,
                     int64_t w, uint8_t* out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const double p0 = pts[i * 3], p1 = pts[i * 3 + 1], p2 = pts[i * 3 + 2];
    const double x = p0 * inv_rt[0] + p1 * inv_rt[1] + p2 * inv_rt[2] +
                     inv_rt[3];
    const double y = p0 * inv_rt[4] + p1 * inv_rt[5] + p2 * inv_rt[6] +
                     inv_rt[7];
    const double z = p0 * inv_rt[8] + p1 * inv_rt[9] + p2 * inv_rt[10] +
                     inv_rt[11];
    const double sz = z == 0.0 ? 1e-12 : z;
    const double px = fx / sz * x + cx;
    const double py = fy / sz * y + cy;
    out[i] = (px >= 0.0) & (px < static_cast<double>(w)) & (py >= 0.0) &
             (py < static_cast<double>(h)) & (z > 0.0);
  }
  return 0;
}

#define DEFINE_GATHER_ROWS(suffix, T)                                      \
  int gather_rows_##suffix(int64_t n, int64_t d, int64_t k, const T* src,  \
                           const int64_t* idx, T* dst) {                   \
    _Pragma("omp parallel for schedule(static)")                           \
    for (int64_t j = 0; j < k; ++j) {                                      \
      const int64_t i = idx[j];                                            \
      if (i < 0 || i >= n) return -1;                                      \
      std::memcpy(dst + j * d, src + i * d, sizeof(T) * d);                \
    }                                                                      \
    return 0;                                                              \
  }

DEFINE_GATHER_ROWS(f32, float)
DEFINE_GATHER_ROWS(f64, double)
DEFINE_GATHER_ROWS(i32, int32_t)
DEFINE_GATHER_ROWS(i64, int64_t)
DEFINE_GATHER_ROWS(u8, uint8_t)

// (P, N, C) -> (P, K, C) gather along axis 1 with one shared index list.
int gather_axis1_f32(int64_t p, int64_t n, int64_t c, int64_t k,
                     const float* src, const int64_t* idx, float* dst) {
#pragma omp parallel for collapse(2) schedule(static)
  for (int64_t pi = 0; pi < p; ++pi) {
    for (int64_t j = 0; j < k; ++j) {
      const int64_t i = idx[j];
      if (i >= 0 && i < n) {
        std::memcpy(dst + (pi * k + j) * c, src + (pi * n + i) * c,
                    sizeof(float) * c);
      }
    }
  }
  return 0;
}

int omp_max_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
