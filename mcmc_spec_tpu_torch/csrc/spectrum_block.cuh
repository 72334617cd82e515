// Device helpers and the one-block-per-walker spectrum-statistics body (K2)
// of the experiments S4, S5, S6, S8 and S11; it was also the body of the
// fused posterior K1, the spectrum-chi^2 kernel K3, the fleet spectrum-chi^2
// kernel K4 and the fused fleet posterior K5, which now run one warp per
// walker (spectrum_warp.cuh, sharing SpecStat and the constants below).
//
// Replaces mcmc_spec_tpu/ops/pallas_kernels.py:_spectrum_block (with its
// helpers _row_order_stat_bits/_row_median_nonneg, _fast_recip/_div and
// _dot_f32) and the spectrum part of _spectrum_chi2_fleet_kernel and
// _fleet_posterior_kernel.  The two differ in their statistics (SpecStat):
// K1/K3 take the median of the whole row and the mean chi^2; K4/K5 take the
// median at per-target ranks (r1, r2) of the true points and chi^2 =
// sum * (1/n_true), so a padded target's sentinel points, which sit above
// every real model value and carry inv_err = 0, change nothing.  Design: one
// thread block per walker.  The walker's model row
// (nd floats, 7 KB at nd = 1792) is built in dynamic shared memory; each
// radix-median pass and the renorm/chi^2 passes re-read it from there.  The
// grid projection D [NO, nd] (401 KB at the koi2298 shape) does not fit in a
// block's shared memory: it is read from global memory, where the blocks in
// flight keep it L2-resident.  Only the rows with a non-zero blend weight are
// read (at most 4 per component), which is exact for the finite D of an
// unpadded target, and keeps the 1e30 sentinel columns of a padded D out of
// any zero-weight product.  What bounds a block, as measured on an H100 (PERF.md):
// first the model-row build, whose few D loads per element sit behind a
// data-dependent branch and are issued one after another; then the block-wide
// count passes of the median (a shared-memory sweep plus a two-barrier
// reduction each, 31 exact or 14 at the production dial).
//
// Arithmetic follows the JAX kernel: full f32 FMA for the model product (the
// split-bf16 _dot_f32 was a Mosaic workaround; every MCMC_SPEC_MATMUL_PASSES
// value computes the f32 product here), libm expf/logf and true division
// (no --use_fast_math), the magic-seed reciprocal in uint32 arithmetic.  The
// reductions and the reciprocal are in block_common.cuh, shared with the
// segmented large-nd kernels.
#pragma once

#include "block_common.cuh"

namespace mcmc_spec {

constexpr int32_t kF32InfBits = 0x7F800000;
constexpr float kMagPerLn = (float)(-2.5 / 2.302585092994046);  // -2.5 / ln 10

__device__ __forceinline__ float clip01(float x) { return min_nan(max_nan(x, 0.0f), 1.0f); }
__device__ __forceinline__ float sq(float x) { return x * x; }

// The statistics of the spectrum block: the median's 1-based ranks and the
// chi^2 reduction.  r2 = 0 skips the upper-middle refinement (K1/K3 on an odd
// row return the lower middle itself, as np.median); K4/K5 always refine,
// and for an odd n_true (r2 == r1) return 0.5 * (x1 + x1) as their JAX
// kernels do.
struct SpecStat {
  int r1, r2;
  bool mean;    // chi^2 = sum / nd (K1, K3); otherwise sum * inv_n (K4, K5)
  float inv_n;
};

// K1/K3: np.median of the whole row and the mean chi^2
__device__ __forceinline__ SpecStat whole_row_stat(int nd) {
  const int r1 = (nd + 1) / 2;
  return SpecStat{r1, (nd & 1) ? 0 : r1 + 1, true, 0.0f};
}

// _row_order_stat_bits + the median refinement for one row in shared memory:
// `iters` bisection passes over the int32 bit pattern for rank r1, each a
// block-wide count of bits <= mid.  Below 31 passes the bracket midpoint is
// returned; at 31 the exact order statistic, refined to rank r2 by a count
// and a masked min.  (bisect_bits and refine_upper below are the same two
// steps for the median experiments S7 and S9; row_median keeps them written
// out, because K1-K5 compiled through the helpers to another SASS.)
__device__ inline float row_median(const float* row, int nd, int r1, int r2, int iters,
                                   BlockScratch* s) {
  int32_t lo = 0, hi = kF32InfBits;
  for (int it = 0; it < iters; ++it) {
    const int32_t mid = lo + ((hi - lo) >> 1);
    int c = 0;
    for (int j = threadIdx.x; j < nd; j += blockDim.x) c += (__float_as_int(row[j]) <= mid);
    if (block_sum_int(c, s) >= r1) hi = mid;
    else lo = mid + 1;
  }
  if (iters < 31) return __int_as_float(lo + ((hi - lo) >> 1));
  const float x1 = __int_as_float(hi);
  if (r2 <= 0) return x1;
  int c = 0;
  float m = INFINITY;
  for (int j = threadIdx.x; j < nd; j += blockDim.x) {
    const int32_t bits = __float_as_int(row[j]);
    if (bits <= hi) ++c;
    else m = min_nan(m, row[j]);
  }
  const int cnt1 = block_sum_int(c, s);
  const float upper = block_min(m, s);
  const float x2 = cnt1 >= r2 ? x1 : upper;
  return 0.5f * (x1 + x2);
}

// `passes` bisection passes of row_median from the bracket [lo, hi], updated in
// place: the smallest v in it with count(bits <= v) >= rank.  Block-wide.
__device__ __forceinline__ void bisect_bits(const float* row, int nd, int rank, int passes,
                                            int32_t& lo, int32_t& hi, BlockScratch* s) {
  for (int it = 0; it < passes; ++it) {
    const int32_t mid = lo + ((hi - lo) >> 1);
    int c = 0;
    for (int j = threadIdx.x; j < nd; j += blockDim.x) c += (__float_as_int(row[j]) <= mid);
    if (block_sum_int(c, s) >= rank) hi = mid;
    else lo = mid + 1;
  }
}

// row_median's refinement: the order statistic with bit pattern v1, refined to
// its mean with the order statistic of rank r2 (1-based; r2 <= 0: none).
__device__ __forceinline__ float refine_upper(const float* row, int nd, int32_t v1, int r2,
                                              BlockScratch* s) {
  const float x1 = __int_as_float(v1);
  if (r2 <= 0) return x1;
  int c = 0;
  float m = INFINITY;
  for (int j = threadIdx.x; j < nd; j += blockDim.x) {
    if (__float_as_int(row[j]) <= v1) ++c;
    else m = min_nan(m, row[j]);
  }
  const int cnt1 = block_sum_int(c, s);
  const float upper = block_min(m, s);
  return 0.5f * (x1 + (cnt1 >= r2 ? x1 : upper));
}

// The model row of K2 for one walker: row[j] = (sum_o wc[o] D[o, j]) *
// 10^(-0.4 av kd[j]), reading only the D rows with a non-zero weight.
// Block-wide, no barrier: the caller synchronises before the row is read.
// kNoExp (the experiment S4, spectrum_recip.cu, only) swaps the extinction
// exp for the same-shape linear term 1 + LN10_04*av*kd, evaluated as
// (LN10_04*av)*kd + 1 with _rn intrinsics so that nvcc does not contract it
// into an FMA; K1-K5 take the default.
template <bool kNoExp = false>
__device__ __forceinline__ void build_model_row(const float* wc, float av,
                                                const float* __restrict__ D, int NO, int nd,
                                                const float* __restrict__ kd, float* row) {
  const bool extinct = av > 0.0f;
  const float ak = kLn10x04 * av;
  for (int j = threadIdx.x; j < nd; j += blockDim.x) {
    float acc = 0.0f;
    for (int o = 0; o < NO; ++o) {
      const float w = wc[o];
      if (w != 0.0f) acc = fmaf(w, __ldg(D + (size_t)o * nd + j), acc);
    }
    if constexpr (kNoExp) row[j] = extinct ? acc * __fadd_rn(__fmul_rn(ak, kd[j]), 1.0f) : acc;
    else row[j] = extinct ? acc * expf(ak * kd[j]) : acc;
  }
}

// The rest of K2 on a built row in shared memory: the median match, the
// continuum renorm and the chi^2.  Block-wide; every thread returns the chi^2.
__device__ __forceinline__ float spectrum_tail(const float* row, int nd,
                                               const float* __restrict__ data,
                                               const float* __restrict__ inv_err,
                                               const float* __restrict__ VpinvT,
                                               const float* __restrict__ VT, float med_data,
                                               int iters, bool renorm, int recip,
                                               const SpecStat st, BlockScratch* s) {
  const float alpha = med_data / row_median(row, nd, st.r1, st.r2, iters, s);

  float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
  if (renorm) {
    for (int j = threadIdx.x; j < nd; j += blockDim.x) {
      const float frac = div_dial(data[j], row[j] * alpha, recip);
      c0 += frac * VpinvT[j];
      c1 += frac * VpinvT[nd + j];
      c2 += frac * VpinvT[2 * nd + j];
    }
    block_sum3(c0, c1, c2, s);
  }
  float acc = 0.0f;
  for (int j = threadIdx.x; j < nd; j += blockDim.x) {
    const float model = row[j] * alpha;
    float target = data[j];
    if (renorm) {
      const float fitted = c0 * VT[j] + c1 * VT[nd + j] + c2 * VT[2 * nd + j];
      target = div_dial(data[j], fitted, recip);
    }
    const float r = (model - target) * inv_err[j];  // padded points: * 0 -> 0
    acc += r * r;
  }
  const float tot = block_sum(acc, s);
  return st.mean ? tot / (float)nd : tot * st.inv_n;
}

// K2 (_spectrum_block) for one walker; block-wide, every thread returns the
// chi^2.  wc: the walker's blend weights [NO] in shared memory; row: nd
// floats of dynamic shared memory.  The row build and the tail are split so
// that the program-order experiment S5 (spectrum_overlap.cu) can build
// several rows before their tails.
template <bool kNoExp = false>
__device__ inline float spectrum_block(const float* wc, float av, const float* __restrict__ D,
                                       int NO, int nd, const float* __restrict__ kd,
                                       const float* __restrict__ data,
                                       const float* __restrict__ inv_err,
                                       const float* __restrict__ VpinvT,
                                       const float* __restrict__ VT, float med_data, int iters,
                                       bool renorm, int recip, const SpecStat st, float* row,
                                       BlockScratch* s) {
  build_model_row<kNoExp>(wc, av, D, NO, nd, kd, row);
  __syncthreads();
  return spectrum_tail(row, nd, data, inv_err, VpinvT, VT, med_data, iters, renorm, recip, st,
                       s);
}

}  // namespace mcmc_spec
