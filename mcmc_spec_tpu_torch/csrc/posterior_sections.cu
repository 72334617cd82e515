// S12: the fused posterior K1 with its sections switched off one by one, the
// per-section cost ablation (mcmc_spec_tpu_torch/scripts/ablate_fused_sections.py).
//
// Replaces scripts/ablate_fused_sections.py:variant_kernel, whose
// bodies the JAX script runs through K1's pallas_call
// (mcmc_spec_tpu/ops/pallas_kernels.py:801).  The kernel is K1's
// (log_posterior_fused.cu) over posterior_eval<kPhot, kPriors, kSpectrum, kW>
// (posterior_body.cuh), one instantiation per variant of the JAX script, in
// its order: full, no_phot, no_priors, no_epilogue, no_spectrum, spec_only,
// empty.  `full` is posterior_eval<> itself, K1's first version; K1 now runs
// one warp per walker and agrees with it to rounding (the sums' order).
// The scope is the JAX variant's, which hard-codes one branch of the
// posterior: nspec = 2, a fitted parallax with the distance bounds, no radius
// prior, a non-zero spectrum weight; the launch refuses any other target.
// Its arguments are K1's up to spec_scale (the wrapper builds both lists with
// ops/cuda_kernels.posterior_launch_args), then the variant id in the place of
// K1's radius-prior sigma, which no variant reads.
// What bounds each variant is K1's (spectrum_block.cuh): the spectrum block
// where it is on.  spec_only stubs W with all NO weights non-zero, so its row
// build reads every D row where production reads at most 8.
#include "posterior_body.cuh"

namespace mcmc_spec {

template <bool kPhot, bool kPriors, bool kSpectrum, bool kW>
__global__ void __launch_bounds__(kThreads)
    posterior_sections_kernel(const float* __restrict__ scal, const float* __restrict__ p,
                              const PosteriorTables t, const PosteriorConfig a,
                              float spec_scale, float* __restrict__ out) {
  extern __shared__ float dyn[];
  const int b = blockIdx.x;
  // scal: tmin, tmax, med_data
  const TargetScalars ts{scal[0], scal[1], scal[2], spec_scale, whole_row_stat(a.nd)};
  const float v = posterior_eval<kPhot, kPriors, kSpectrum, kW>(a, t, ts, p + (size_t)b * a.ndim,
                                                                dyn);
  if (threadIdx.x == 0) out[b] = v;
}

}  // namespace mcmc_spec

extern "C" int posterior_sections_launch(
    const void* scal, const void* p, const void* D, const void* kd, const void* data,
    const void* inv_err, const void* VpinvT, const void* VT, const void* tentT,
    const void* tentG, const void* mist_tent, const void* mist_vals, const void* av_tent,
    const void* av_vals, const void* Fc, const void* Fp, const void* cobs, const void* pobs,
    const void* prior, void* out, int B, int ndim, int NO, int nd, int nm, int nav, int nc,
    int npf, int nspec, int fit_plx, int dist_fit, int rad_prior, int iters, int recip,
    float spectrum_weight, float spec_scale, int variant, void* stream) {
  using namespace mcmc_spec;
  using SectionsKernel = void (*)(const float*, const float*, const PosteriorTables,
                                  const PosteriorConfig, float, float*);
  // the variants of ablate_fused_sections.main, in its order
  static const SectionsKernel kVariants[] = {
      posterior_sections_kernel<true, true, true, true>,     // full
      posterior_sections_kernel<false, true, true, true>,    // no_phot
      posterior_sections_kernel<true, false, true, true>,    // no_priors
      posterior_sections_kernel<false, false, true, true>,   // no_epilogue
      posterior_sections_kernel<true, true, false, true>,    // no_spectrum
      posterior_sections_kernel<false, false, true, false>,  // spec_only
      posterior_sections_kernel<false, false, false, false>, // empty
  };
  constexpr int kNumVariants = sizeof(kVariants) / sizeof(kVariants[0]);
  if (variant < 0 || variant >= kNumVariants || nspec != 2 || !fit_plx || !dist_fit ||
      rad_prior || spectrum_weight == 0.0f || nc > kMaxBands || npf > kMaxBands ||
      ndim > kMaxDim)
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
  const SectionsKernel kernel = kVariants[variant];
  const size_t smem = posterior_smem(nd, NO, nspec);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>((const float*)scal, (const float*)p, t, a,
                                                      spec_scale, (float*)out);
  return (int)cudaGetLastError();
}
