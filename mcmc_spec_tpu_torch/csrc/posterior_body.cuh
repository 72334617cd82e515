// The structs and helpers of the log-posterior kernels: the target tables,
// the configuration, tent weights.  K1 and K5 take them from here (their body,
// one warp per walker, is posterior_warp.cuh), and so does the experiment S8.
//
// Replaces the helpers of mcmc_spec_tpu/ops/pallas_kernels.py:_posterior_kernel
// and _fleet_posterior_kernel (with _tent_w).
#pragma once

#include "spectrum_block.cuh"

namespace mcmc_spec {

constexpr int kMaxSpec = 3;    // nspec <= 3
constexpr int kMaxBands = 32;  // nc, npf <= 32: one lane per band
constexpr int kMaxDim = 32;    // ndim <= 32: one lane per parameter

// One target's operand tables (the f32 tables of ops/cuda_kernels.py)
struct PosteriorTables {
  const float* D;          // [NO, nd]
  const float* kd;         // [nd] CCM89 k at the data wavelengths
  const float* data;       // [nd]
  const float* inv_err;    // [nd]
  const float* VpinvT;     // [3, nd]
  const float* VT;         // [3, nd]
  const float* tentT;      // [4, NO] Teff tent constants per grid point
  const float* tentG;      // [4, NO] logg tent constants per grid point
  const float* mist_tent;  // [4, nm]
  const float* mist_vals;  // [2, nm]: logg, lum
  const float* av_tent;    // [4, nav]
  const float* av_vals;    // [2, nav]: mu, sig
  const float* Fc;         // [NO, nc]
  const float* Fp;         // [NO, npf]
  const float* cobs;       // [2, nc]: cmag, cerr
  const float* pobs;       // [4, npf]: pmag, perr, zero flux, k at cwl
  const float* prior;      // [2, ndim]: gaussian mu (0 = off), sig
};

// Shapes and static configuration, the same for every walker of a launch
struct PosteriorConfig {
  int ndim, NO, nd, nm, nav, nc, npf, nspec;
  int fit_plx, dist_fit, rad_prior, iters, recip;
  float spectrum_weight;
  float rad_sigma;
};

// The scalars of the walker's target
struct TargetScalars {
  float tmin, tmax, med_data;
  float spec_scale;  // spectrum_weight * (nc + npf true counts, or nc without parallax)
  SpecStat stat;
};

// Target t's tables within stacked [ntgt, ...] contiguous fleet tables
__device__ __forceinline__ PosteriorTables target_tables(const PosteriorTables& f,
                                                         const PosteriorConfig& a, int t) {
  const size_t T = (size_t)t, NO = a.NO, nd = a.nd;
  PosteriorTables r;
  r.D = f.D + T * NO * nd;
  r.kd = f.kd + T * nd;
  r.data = f.data + T * nd;
  r.inv_err = f.inv_err + T * nd;
  r.VpinvT = f.VpinvT + T * 3 * nd;
  r.VT = f.VT + T * 3 * nd;
  r.tentT = f.tentT + T * 4 * NO;
  r.tentG = f.tentG + T * 4 * NO;
  r.mist_tent = f.mist_tent + T * 4 * a.nm;
  r.mist_vals = f.mist_vals + T * 2 * a.nm;
  r.av_tent = f.av_tent + T * 4 * a.nav;
  r.av_vals = f.av_vals + T * 2 * a.nav;
  r.Fc = f.Fc + T * NO * a.nc;
  r.Fp = f.Fp + T * NO * a.npf;
  r.cobs = f.cobs + T * 2 * a.nc;
  r.pobs = f.pobs + T * 4 * a.npf;
  r.prior = f.prior + T * 2 * a.ndim;
  return r;
}

// _tent_w for node i of an [4, n] constant table (A, invB, C, invD)
__device__ __forceinline__ float tent_w(const float* tc, int i, int n, float q) {
  const float left = (q - tc[i]) * tc[n + i];
  const float right = (tc[2 * n + i] - q) * tc[3 * n + i];
  return clip01(min_nan(left, right));
}

// sum_i tent_w(tc, i, q) * vals[i] over the warp (at most two non-zero terms)
__device__ __forceinline__ float warp_tent_dot(const float* tc, const float* vals, int n, float q) {
  float acc = 0.0f;
  for (int i = threadIdx.x & 31; i < n; i += 32) acc += tent_w(tc, i, n, q) * vals[i];
  return warp_sum(acc);
}

}  // namespace mcmc_spec
