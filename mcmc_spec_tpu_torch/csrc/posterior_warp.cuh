// The one-warp-per-walker log-posterior body of the fused posterior K1
// (log_posterior_fused.cu, one unpadded target) and of the fused fleet
// posterior K5 (log_posterior_fleet_fused.cu, a stacked, padded fleet).
//
// Replaces the body of mcmc_spec_tpu/ops/pallas_kernels.py:_posterior_kernel
// and _fleet_posterior_kernel (with _tent_w) for those two kernels.  A warp
// runs its walker alone, with no block barrier: the scalar part (unpack,
// component scales, MIST logg(T), tent weights -> Wcomb, contrast and
// photometry magnitudes, priors, bounds), then the spectrum body of
// spectrum_warp.cuh.  The caller passes the target's tables and scalars:
// K1 the whole-row median and the mean chi^2, K5 its target's median ranks
// over the true points and sum * 1/n_true (SpecStat).
//
// The scalar part is posterior_eval's warp-0 code (posterior_body.cuh),
// copied and not shared: routing the block-per-walker kernels S8 and S12
// through a common inlined function has changed their SASS before, and those
// kernels keep their code.  Here each band's contrast magnitudes stay in the
// lane's registers instead of shared memory, and the chi^2 terms and the
// prior in every lane's registers.
#pragma once

#include "posterior_body.cuh"
#include "spectrum_warp.cuh"

namespace mcmc_spec {

// The log-posterior of the walker pw[ndim]; every lane of the calling warp
// gets it.  dyn: the warp's slice of dynamic shared memory,
// warp_smem_floats(nd, NO, 1 + nspec) floats.
__device__ inline float posterior_warp(const PosteriorConfig& a, const PosteriorTables& t,
                                       const TargetScalars& ts, const float* pw, float* dyn) {
  float* row = dyn;                // [nd] model row
  float* wc = dyn + round4(a.nd);  // [NO] Wcomb
  float* swk = wc + a.NO;          // [nspec, NO] scaled per-component weights
  int* lo = reinterpret_cast<int*>(swk + a.nspec * a.NO);  // [NO] compact list: o
  float* lw = reinterpret_cast<float*>(lo + a.NO);         // [NO] compact list: w

  const int lane = threadIdx.x & 31;
  const int n = a.nspec;
  const float av = pw[n];

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
    const float logg = warp_tent_dot(t.mist_tent, t.mist_vals, a.nm, teff[s]);
    lum[s] = a.rad_prior ? warp_tent_dot(t.mist_tent, t.mist_vals + a.nm, a.nm, teff[s]) : 0.0f;
    for (int o = lane; o < a.NO; o += 32) {
      const float wk = tent_w(t.tentT, o, a.NO, teff[s]) * tent_w(t.tentG, o, a.NO, logg);
      const float sw = scale[s] * wk;
      swk[s * a.NO + o] = sw;
      wc[o] = s == 0 ? sw : wc[o] + sw;
    }
  }
  __syncwarp();

  // --- contrast magnitudes, one lane per band
  float cmag[kMaxSpec] = {0.0f, 0.0f, 0.0f};
  if (lane < a.nc) {
#pragma unroll
    for (int s = 0; s < kMaxSpec; ++s) {
      if (s < n) {
        float f = 0.0f;
        for (int o = 0; o < a.NO; ++o) f += swk[s * a.NO + o] * t.Fc[o * a.nc + lane];
        cmag[s] = kMagPerLn * logf(max_nan(f, 1.17549435e-38f));
      }
    }
  }
  float term = 0.0f;
  if (lane < a.nc) {
    // the triple split is on the (padded) contrast count, as in the Pallas kernels
    float contrast = 0.0f;
    if (n == 2 || (n == 3 && lane < a.nc / 2)) contrast = cmag[1] - cmag[0];
    else if (n == 3) contrast = cmag[2] - cmag[0];
    term = sq((contrast - t.cobs[lane]) / t.cobs[a.nc + lane]);
  }
  const float chi_c = warp_sum(term);

  // --- unresolved photometry, one lane per band
  term = 0.0f;
  if (lane < a.npf) {
    float f = 0.0f;
    for (int o = 0; o < a.NO; ++o) f += wc[o] * t.Fp[o * a.npf + lane];
    float phot = kMagPerLn * logf(max_nan(f / t.pobs[2 * a.npf + lane], 1.17549435e-38f));
    if (av > 0.0f) phot = phot + av * t.pobs[3 * a.npf + lane];
    term = sq((phot - t.pobs[lane]) / t.pobs[a.npf + lane]);
  }
  const float chi_p = a.fit_plx ? warp_sum(term) : 0.0f;

  // --- priors (batched.log_prior_batch)
  float lp = 0.0f;
  if (a.fit_plx) {
    const float dist_pc = 1.0f / max_nan(plx, (float)1e-12);
    const float logd = logf(max_nan(dist_pc, (float)1e-3));
    const float mu = warp_tent_dot(t.av_tent, t.av_vals, a.nav, logd);
    const float sig = warp_tent_dot(t.av_tent, t.av_vals + a.nav, a.nav, logd);
    lp += -0.5f * sq((av - mu) / sig);
  }
  term = 0.0f;
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
  bool ok = av >= 0.0f;
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
  const float lpv = ok ? lp : -INFINITY;

  float chi_spec = 0.0f;
  if (a.spectrum_weight != 0.0f)
    chi_spec = spectrum_warp(wc, av, t.D, a.NO, a.nd, t.kd, t.data, t.inv_err, t.VpinvT, t.VT,
                             ts.med_data, a.iters, true, a.recip, ts.stat, row, lo, lw);
  const float cs = ts.spec_scale * chi_spec + chi_c + chi_p;
  const float ll = isnan(cs) ? -INFINITY : -0.5f * cs;
  return isfinite(lpv) ? lpv + ll : -INFINITY;
}

}  // namespace mcmc_spec
