// K1: the whole batched log-posterior of one unpadded target, one warp per
// walker.
//
// Replaces mcmc_spec_tpu/ops/pallas_kernels.py:log_posterior_fused (body
// _posterior_kernel).  A block of wpb warps (chosen by
// ops/cuda_kernels.py:walkers_per_block, at most 8) takes walkers
// blockIdx.x * wpb ... + wpb - 1, and each warp runs its walker alone, with
// no block barrier: the scalar part (unpack, component scales, MIST logg(T),
// tent weights -> Wcomb, contrast and photometry magnitudes, priors, bounds),
// then the spectrum body of spectrum_warp.cuh, which says what bounds it.
// One warp's scalar part and epilogue thus overlap the other warps' spectrum
// work, where the block-per-walker version (still the body of K5 and S12,
// posterior_body.cuh) ran them in warp 0 while seven warps waited at a
// barrier.  The median is the whole row's and the spectrum chi^2 the mean.
//
// The scalar part is posterior_eval's warp-0 code, copied and not shared:
// routing K5 and S12 through a common inlined function has changed their
// SASS before, and those kernels keep their code.  Here each band's
// contrast magnitudes stay in the lane's registers instead of shared memory,
// and the chi^2 terms and the prior in every lane's registers.
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

__global__ void __launch_bounds__(kWalkersMax * 32)
    log_posterior_fused_kernel(const float* __restrict__ scal, const float* __restrict__ p,
                               const PosteriorTables t, const PosteriorConfig a,
                               float spec_scale, float* __restrict__ out, int B) {
  extern __shared__ __align__(16) float dyn[];
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // the ragged last block: whole warps leave
  // scal: tmin, tmax, med_data
  const TargetScalars ts{scal[0], scal[1], scal[2], spec_scale, whole_row_stat(a.nd)};
  const float v = posterior_warp(a, t, ts, p + (size_t)b * a.ndim,
                                 dyn + (size_t)warp * warp_smem_floats(a.nd, a.NO, 1 + a.nspec));
  if ((threadIdx.x & 31) == 0) out[b] = v;
}

}  // namespace mcmc_spec

extern "C" int log_posterior_fused_launch(
    const void* scal, const void* p, const void* D, const void* kd, const void* data,
    const void* inv_err, const void* VpinvT, const void* VT, const void* tentT,
    const void* tentG, const void* mist_tent, const void* mist_vals, const void* av_tent,
    const void* av_vals, const void* Fc, const void* Fp, const void* cobs, const void* pobs,
    const void* prior, void* out, int B, int ndim, int NO, int nd, int nm, int nav, int nc,
    int npf, int nspec, int fit_plx, int dist_fit, int rad_prior, int iters, int recip,
    float spectrum_weight, float spec_scale, float rad_sigma, int wpb, void* stream) {
  using namespace mcmc_spec;
  if (nspec < 1 || nspec > kMaxSpec || nc > kMaxBands || npf > kMaxBands || ndim > kMaxDim ||
      wpb < 1 || wpb > kWalkersMax)
    return (int)cudaErrorInvalidValue;
  const PosteriorTables t{(const float*)D,        (const float*)kd,        (const float*)data,
                          (const float*)inv_err,  (const float*)VpinvT,    (const float*)VT,
                          (const float*)tentT,    (const float*)tentG,     (const float*)mist_tent,
                          (const float*)mist_vals, (const float*)av_tent,  (const float*)av_vals,
                          (const float*)Fc,       (const float*)Fp,        (const float*)cobs,
                          (const float*)pobs,     (const float*)prior};
  const PosteriorConfig a{ndim,    NO,       nd,        nm,    nav,   nc,
                          npf,     nspec,    fit_plx,   dist_fit, rad_prior, iters,
                          recip,   spectrum_weight, rad_sigma};
  const size_t smem = (size_t)wpb * warp_smem_floats(nd, NO, 1 + nspec) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        log_posterior_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  log_posterior_fused_kernel<<<(B + wpb - 1) / wpb, 32 * wpb, smem, (cudaStream_t)stream>>>(
      (const float*)scal, (const float*)p, t, a, spec_scale, (float*)out, B);
  return (int)cudaGetLastError();
}
