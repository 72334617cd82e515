// S8: the fused posterior K1 with its scalar epilogue run walkers-across-lanes,
// the receipt for K1's per-walker fixed cost
// (mcmc_spec_tpu_torch/scripts/try_transposed_epilogue.py).
//
// Replaces scripts/try_transposed_epilogue.py:log_posterior_fused_T (body
// _posterior_kernel_T, with _tent_w_T).  It computes K1's log-posterior; the
// W path and the spectrum block stay as in K1, and the epilogue (contrast and
// photometry magnitudes, the Av(d) and Gaussian priors, the bounds) runs with
// one walker per lane.  The scope is the JAX body's, which hard-codes one
// branch of the posterior: nspec = 2, a fitted parallax with the distance
// bounds, no radius prior, a non-zero spectrum weight; the launch refuses any
// other target.
//
// Design: one block of 256 threads per tile of kTile = 32 walkers.
//   1. The W path, as K1 runs it in its warp 0 (posterior_body.cuh): each of
//      the 8 warps takes every 8th walker of the tile, lanes over the MIST
//      nodes and grid points, and writes the walker's scaled per-component
//      weights to shared memory.
//   2. The spectrum block (spectrum_block.cuh) for each walker of the tile in
//      turn, the whole block on one row in shared memory, K1's code on K1's
//      Wcomb, so each chi^2 equals K1's.
//   3. The epilogue in warp 0, lane w on walker w: each lane walks the grid
//      points and bands of its own walker where K1 has one warp per walker
//      with lanes over bands (nc = 2 and npf = 6 of 32 lanes busy).
// kTile = 32 fills warp 0's lanes in step 3.  A larger tile leaves fewer
// blocks for the 132 SMs (1,024 at 32,768 walkers; at 22 KB of shared memory
// and 256 threads 8 fit an SM, so they run in one wave) and puts more walkers
// one after another on one block's critical path; a smaller one leaves lanes
// idle.  Each walker's weights take 2 * NO + 1 floats: the odd stride keeps
// step 3's lanes on distinct shared-memory banks.  Sums over bands, nodes and
// parameters run in order in one lane where K1 sums across lanes, so the
// result is K1's to the JAX script's gate (rel 5e-5), not bit for bit.
// What bounds it is K1's: the spectrum block (spectrum_block.cuh).
#include "posterior_body.cuh"

namespace mcmc_spec {

constexpr int kTile = 32;
constexpr int kSpecT = 2;  // the scope's nspec

__global__ void __launch_bounds__(kThreads)
    posterior_transposed_kernel(const float* __restrict__ scal, const float* __restrict__ p,
                                const PosteriorTables t, const PosteriorConfig a,
                                float spec_scale, float* __restrict__ out, int B) {
  extern __shared__ float dyn[];
  const int stride = kSpecT * a.NO + 1;
  float* row = dyn;            // [nd] model row
  float* wc = row + a.nd;      // [NO] the current walker's Wcomb
  float* swk = wc + a.NO;      // [kTile, stride] scaled per-component weights
  __shared__ BlockScratch scratch;
  __shared__ float s_chi[kTile];
  const int w0 = blockIdx.x * kTile;
  const int nw = min(kTile, B - w0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float tmin = scal[0], tmax = scal[1], med_data = scal[2];

  // 1. W path, one warp per walker
  for (int w = warp; w < nw; w += kWarps) {
    const float* pw = p + (size_t)(w0 + w) * a.ndim;
    const float r1 = pw[kSpecT + 1], ratio = pw[kSpecT + 2], plx = pw[2 * kSpecT + 1];
    const float base = sq(r1 * (float)6.957e10 * plx / (float)3.086e18);
    const float scale[kSpecT] = {base, base * sq(ratio)};
    float* sw = swk + w * stride;
    for (int s = 0; s < kSpecT; ++s) {
      const float logg = warp_tent_dot(t.mist_tent, t.mist_vals, a.nm, pw[s]);
      for (int o = lane; o < a.NO; o += 32)
        sw[s * a.NO + o] = scale[s] * (tent_w(t.tentT, o, a.NO, pw[s]) *
                                       tent_w(t.tentG, o, a.NO, logg));
    }
  }
  __syncthreads();

  // 2. the spectrum block of each walker in turn
  const SpecStat st = whole_row_stat(a.nd);
  for (int w = 0; w < nw; ++w) {
    const float* sw = swk + w * stride;
    for (int o = threadIdx.x; o < a.NO; o += blockDim.x) wc[o] = sw[o] + sw[a.NO + o];
    __syncthreads();
    const float chi = spectrum_block(wc, p[(size_t)(w0 + w) * a.ndim + kSpecT], t.D, a.NO, a.nd,
                                     t.kd, t.data, t.inv_err, t.VpinvT, t.VT, med_data, a.iters,
                                     true, a.recip, st, row, &scratch);
    if (threadIdx.x == 0) s_chi[w] = chi;
  }
  __syncthreads();

  // 3. the epilogue, one walker per lane
  if (threadIdx.x >= nw) return;
  const int w = threadIdx.x;
  const float* pw = p + (size_t)(w0 + w) * a.ndim;
  const float* sw = swk + w * stride;
  const float av = pw[kSpecT], r1 = pw[kSpecT + 1], ratio = pw[kSpecT + 2];
  const float plx = pw[2 * kSpecT + 1];
  constexpr float kTiny = 1.17549435e-38f;

  float chi_c = 0.0f;
  for (int c = 0; c < a.nc; ++c) {
    float f0 = 0.0f, f1 = 0.0f;
    for (int o = 0; o < a.NO; ++o) {
      const float fc = t.Fc[o * a.nc + c];
      f0 += sw[o] * fc;
      f1 += sw[a.NO + o] * fc;
    }
    const float cmag0 = kMagPerLn * logf(max_nan(f0, kTiny));
    const float cmag1 = kMagPerLn * logf(max_nan(f1, kTiny));
    const float contrast = cmag1 - cmag0;
    chi_c += sq((contrast - t.cobs[c]) / t.cobs[a.nc + c]);
  }
  float chi_p = 0.0f;
  for (int c = 0; c < a.npf; ++c) {
    float f = 0.0f;
    for (int o = 0; o < a.NO; ++o) f += (sw[o] + sw[a.NO + o]) * t.Fp[o * a.npf + c];
    float phot = kMagPerLn * logf(max_nan(f / t.pobs[2 * a.npf + c], kTiny));
    if (av > 0.0f) phot = phot + av * t.pobs[3 * a.npf + c];
    chi_p += sq((phot - t.pobs[c]) / t.pobs[a.npf + c]);
  }

  const float dist_pc = 1.0f / max_nan(plx, (float)1e-12);
  const float logd = logf(max_nan(dist_pc, (float)1e-3));
  float mu = 0.0f, sig = 0.0f;
  for (int i = 0; i < a.nav; ++i) {
    const float wt = tent_w(t.av_tent, i, a.nav, logd);
    mu += wt * t.av_vals[i];
    sig += wt * t.av_vals[a.nav + i];
  }
  float lp = -0.5f * sq((av - mu) / sig);
  float gauss = 0.0f;
  for (int d = 0; d < a.ndim; ++d)
    if (t.prior[d] != 0.0f) gauss += -0.5f * sq((pw[d] - t.prior[d]) / t.prior[a.ndim + d]);
  lp += gauss;

  bool ok = av >= 0.0f && ratio >= 0.05f && r1 >= 0.05f && r1 <= 1.5f &&
            plx >= (float)(1.0 / 3000.0) && plx <= 0.25f;
  for (int s = 0; s < kSpecT; ++s) ok = ok && pw[s] <= tmax && pw[s] >= tmin;

  const float cs = spec_scale * s_chi[w] + chi_c + chi_p;
  const float ll = isnan(cs) ? -INFINITY : -0.5f * cs;
  const float lpv = ok ? lp : -INFINITY;
  out[w0 + w] = isfinite(lpv) ? lpv + ll : -INFINITY;
}

// the dynamic shared memory of a tile: a row, one Wcomb, kTile walkers' weights
inline size_t transposed_smem(int nd, int NO) {
  return (size_t)(nd + NO + kTile * (kSpecT * NO + 1)) * sizeof(float);
}

}  // namespace mcmc_spec

extern "C" int posterior_transposed_launch(
    const void* scal, const void* p, const void* D, const void* kd, const void* data,
    const void* inv_err, const void* VpinvT, const void* VT, const void* tentT,
    const void* tentG, const void* mist_tent, const void* mist_vals, const void* av_tent,
    const void* av_vals, const void* Fc, const void* Fp, const void* cobs, const void* pobs,
    const void* prior, void* out, int B, int ndim, int NO, int nd, int nm, int nav, int nc,
    int npf, int nspec, int fit_plx, int dist_fit, int rad_prior, int iters, int recip,
    float spectrum_weight, float spec_scale, void* stream) {
  using namespace mcmc_spec;
  if (B < 1 || nspec != kSpecT || !fit_plx || !dist_fit || rad_prior ||
      spectrum_weight == 0.0f || ndim != 2 * kSpecT + 2)
    return (int)cudaErrorInvalidValue;
  const PosteriorTables t{(const float*)D,        (const float*)kd,        (const float*)data,
                          (const float*)inv_err,  (const float*)VpinvT,    (const float*)VT,
                          (const float*)tentT,    (const float*)tentG,     (const float*)mist_tent,
                          (const float*)mist_vals, (const float*)av_tent,  (const float*)av_vals,
                          (const float*)Fc,       (const float*)Fp,        (const float*)cobs,
                          (const float*)pobs,     (const float*)prior};
  const PosteriorConfig a{ndim, NO,       nd,       nm,        nav,   nc,
                          npf,  nspec,    fit_plx,  dist_fit,  0,     iters,
                          recip, spectrum_weight, 0.0f};
  const size_t smem = transposed_smem(nd, NO);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        posterior_transposed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned grid = (unsigned)((B + kTile - 1) / kTile);
  posterior_transposed_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)scal, (const float*)p, t, a, spec_scale, (float*)out, B);
  return (int)cudaGetLastError();
}
