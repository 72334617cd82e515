// The one-block-per-walker log-posterior body of the experiment S12 (S8 takes
// its structs and helpers); it was also the body of the fused posterior K1
// (log_posterior_fused.cu, one unpadded target) and the fused fleet
// posterior K5 (log_posterior_fleet_fused.cu, a stacked, padded fleet),
// which now run one warp per walker over a copy of the scalar part below
// (posterior_warp.cuh).  K1 and K5 still take their structs and tent helpers
// from here.
//
// Replaces the body of mcmc_spec_tpu/ops/pallas_kernels.py:_posterior_kernel
// and _fleet_posterior_kernel (with _tent_w).  The per-walker scalar part
// (unpack, component scales, MIST logg(T), tent weights -> Wcomb, the
// contrast and photometry fluxes, priors and bounds) runs in warp 0: it is a
// few hundred flops over tables of 56-220 entries, so one warp keeps it off
// the barriers the rest of the block waits on.  Wcomb goes to shared memory
// and the whole block then runs the spectrum block, which bounds the kernel.
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

// The log-posterior of the walker pw[ndim] against target tables `t`.
// Block-wide: every thread calls it and gets the value.  dyn: the dynamic
// shared memory, nd + (1 + nspec) * NO floats.
//
// The section flags serve the cost ablation S12 (posterior_sections.cu,
// scripts/ablate_fused_sections.py:variant_kernel), now its only caller, and
// are all on in its `full` variant.  A section switched off yields the JAX
// variant's stub: kPhot off -> chi_c = chi_p = 0; kPriors off -> lp = 0 (no
// priors, no bounds); kSpectrum off -> chi_spec = sum(Wcomb); kW off -> Wk =
// teff * 1e-4 for every grid point (all NO weights non-zero, so the row build
// reads every D row).
template <bool kPhot = true, bool kPriors = true, bool kSpectrum = true, bool kW = true>
__device__ inline float posterior_eval(const PosteriorConfig& a, const PosteriorTables& t,
                                       const TargetScalars& ts, const float* pw, float* dyn) {
  float* row = dyn;        // [nd] model row
  float* wc = dyn + a.nd;  // [NO] Wcomb
  float* swk = wc + a.NO;  // [nspec, NO] scaled per-component weights
  __shared__ BlockScratch scratch;
  __shared__ float s_cmag[kMaxSpec][kMaxBands];
  __shared__ float s_chi_c, s_chi_p, s_lp;

  const int lane = threadIdx.x & 31;
  const int n = a.nspec;
  const float av = pw[n];

  if (threadIdx.x < 32) {
    // --- unpack (batched._unpack_batch); uniform across the warp
    float teff[kMaxSpec], ratio[kMaxSpec], scale[kMaxSpec], lum[kMaxSpec];
    float r1, plx;
    for (int s = 0; s < n; ++s) teff[s] = pw[s];
    if (a.fit_plx) {
      r1 = pw[n + 1];
      for (int s = 1; s < n; ++s) ratio[s] = pw[n + 1 + s];
      plx = pw[2 * n + 1];
    } else {
      r1 = 1.0f;
      for (int s = 1; s < n; ++s) ratio[s] = pw[n + s];
      plx = 0.0f;
    }
    // --- component scales (batched._scales_batch)
    if (a.fit_plx) {
      const float base = sq(r1 * (float)6.957e10 * plx / (float)3.086e18);
      scale[0] = base;
      for (int s = 1; s < n; ++s) scale[s] = base * sq(ratio[s]);
    } else {
      scale[0] = 1.0f;
      for (int s = 1; s < n; ++s) scale[s] = sq(ratio[s]);
    }

    // --- MIST logg(T), grid tent weights, Wcomb
    for (int s = 0; s < n; ++s) {
      float logg = 0.0f;
      if constexpr (kW) {
        logg = warp_tent_dot(t.mist_tent, t.mist_vals, a.nm, teff[s]);
        lum[s] = a.rad_prior ? warp_tent_dot(t.mist_tent, t.mist_vals + a.nm, a.nm, teff[s]) : 0.0f;
      } else {
        lum[s] = 0.0f;
      }
      for (int o = lane; o < a.NO; o += 32) {
        float wk;
        if constexpr (kW) wk = tent_w(t.tentT, o, a.NO, teff[s]) * tent_w(t.tentG, o, a.NO, logg);
        else wk = teff[s] * (float)1e-4;
        const float sw = scale[s] * wk;
        swk[s * a.NO + o] = sw;
        wc[o] = s == 0 ? sw : wc[o] + sw;
      }
    }
    __syncwarp();

    // --- contrast magnitudes, one lane per band
    float chi_c = 0.0f, chi_p = 0.0f;
    if constexpr (kPhot) {
      if (lane < a.nc) {
        for (int s = 0; s < n; ++s) {
          float f = 0.0f;
          for (int o = 0; o < a.NO; ++o) f += swk[s * a.NO + o] * t.Fc[o * a.nc + lane];
          s_cmag[s][lane] = kMagPerLn * logf(max_nan(f, 1.17549435e-38f));
        }
      }
      __syncwarp();
      float term = 0.0f;
      if (lane < a.nc) {
        // the triple split is on the (padded) contrast count, as in the Pallas kernels
        float contrast = 0.0f;
        if (n == 2 || (n == 3 && lane < a.nc / 2)) contrast = s_cmag[1][lane] - s_cmag[0][lane];
        else if (n == 3) contrast = s_cmag[2][lane] - s_cmag[0][lane];
        term = sq((contrast - t.cobs[lane]) / t.cobs[a.nc + lane]);
      }
      chi_c = warp_sum(term);

      // --- unresolved photometry, one lane per band
      term = 0.0f;
      if (lane < a.npf) {
        float f = 0.0f;
        for (int o = 0; o < a.NO; ++o) f += wc[o] * t.Fp[o * a.npf + lane];
        float phot = kMagPerLn * logf(max_nan(f / t.pobs[2 * a.npf + lane], 1.17549435e-38f));
        if (av > 0.0f) phot = phot + av * t.pobs[3 * a.npf + lane];
        term = sq((phot - t.pobs[lane]) / t.pobs[a.npf + lane]);
      }
      chi_p = a.fit_plx ? warp_sum(term) : 0.0f;
    }

    // --- priors (batched.log_prior_batch)
    float lp = 0.0f;
    bool ok = true;
    if constexpr (kPriors) {
      if (a.fit_plx) {
        const float dist_pc = 1.0f / max_nan(plx, (float)1e-12);
        const float logd = logf(max_nan(dist_pc, (float)1e-3));
        const float mu = warp_tent_dot(t.av_tent, t.av_vals, a.nav, logd);
        const float sig = warp_tent_dot(t.av_tent, t.av_vals + a.nav, a.nav, logd);
        lp += -0.5f * sq((av - mu) / sig);
      }
      float term = 0.0f;
      if (lane < a.ndim && t.prior[lane] != 0.0f)
        term = -0.5f * sq((pw[lane] - t.prior[lane]) / t.prior[a.ndim + lane]);
      lp += warp_sum(term);

      if (a.rad_prior) {
        float mrad[kMaxSpec];
        for (int s = 0; s < n; ++s) {
          const float t2 = teff[s] * teff[s];
          mrad[s] = sqrtf(lum[s] * (float)3.839e33 /
                          ((float)(4.0 * 3.141592653589793 * 5.670374e-5) * (t2 * t2))) /
                    (float)6.957e10;
        }
        if (a.fit_plx) lp += -0.5f * sq((r1 - mrad[0]) / (a.rad_sigma * mrad[0]));
        for (int s = 1; s < n; ++s) {
          const float mv = mrad[s] / mrad[0];
          lp += -0.5f * sq((ratio[s] - mv) / (a.rad_sigma * mv));
        }
      }

      // --- bounds (batched._bounds_ok_batch)
      ok = av >= 0.0f;
      for (int s = 0; s < n; ++s) ok = ok && teff[s] <= ts.tmax && teff[s] >= ts.tmin;
      for (int s = 1; s < n; ++s) ok = ok && ratio[s] >= 0.05f;
      if (a.fit_plx) {
        ok = ok && r1 >= 0.05f;
        if (a.dist_fit) {
          const float plx_hi = a.spectrum_weight == 0.0f ? 0.01f : 0.25f;
          const float plx_lo = n <= 2 ? (float)(1.0 / 3000.0) : (float)(1.0 / 1000.0);
          if (n <= 2) ok = ok && r1 <= 1.5f;
          ok = ok && plx >= plx_lo && plx <= plx_hi;
        }
      }
    }
    if (lane == 0) {
      s_chi_c = chi_c;
      s_chi_p = chi_p;
      s_lp = ok ? lp : -INFINITY;
    }
  }
  __syncthreads();

  float chi_spec = 0.0f;
  if constexpr (kSpectrum) {
    if (a.spectrum_weight != 0.0f)
      chi_spec = spectrum_block(wc, av, t.D, a.NO, a.nd, t.kd, t.data, t.inv_err, t.VpinvT,
                                t.VT, ts.med_data, a.iters, true, a.recip, ts.stat, row, &scratch);
  } else {
    float acc = 0.0f;
    for (int o = threadIdx.x; o < a.NO; o += blockDim.x) acc += wc[o];
    chi_spec = block_sum(acc, &scratch);
  }
  const float cs = ts.spec_scale * chi_spec + s_chi_c + s_chi_p;
  const float ll = isnan(cs) ? -INFINITY : -0.5f * cs;
  return isfinite(s_lp) ? s_lp + ll : -INFINITY;
}

// The dynamic shared memory posterior_eval needs, and the attribute a launch
// above 48 KB requires
inline size_t posterior_smem(int nd, int NO, int nspec) {
  return (size_t)(nd + (1 + nspec) * NO) * sizeof(float);
}

}  // namespace mcmc_spec
