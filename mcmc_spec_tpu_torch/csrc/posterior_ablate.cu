// S13: the fused posterior K1 with its sections switched off, every
// combination of the four gates: the 2^4 section matrix
// (mcmc_spec_tpu_torch/scripts/ablate_matrix.py, ablate_matrix_traced.py).
//
// Replaces scripts/ablate_fused_sections.py:variant_kernel as
// scripts/ablate_matrix.py runs it, through K1's pallas_call
// (mcmc_spec_tpu/ops/pallas_kernels.py:801), for each mask of (do_phot,
// do_priors, do_spectrum, do_w).  The kernel is K1's
// (log_posterior_fused.cu) over posterior_warp<kPhot, kPriors, kSpectrum, kW>
// (posterior_warp.cuh) with K1's staged spectrum body (v4's register row at nd <=
// 1,792, v3 wider), whose gates default to
// the production body: one
// instantiation per mask, variant id = 8 P + 4 R + 2 S + W, so id 15 is K1's
// own code and its output is K1's bit for bit; id 0 is the JAX script's
// `empty` variant (every section stubbed).  Id 16, `empty` here, is the launch
// floor behind K1's signature (the body of scripts/trace_fused_call.py:9-10):
// K1's arguments, grid, block and dynamic shared memory, and a body that only
// copies each walker's first parameter to its output.
// The scope is the JAX variant's branch of the posterior, which hard-codes
// nspec = 2, widened to the triple (nspec 3): a fitted parallax with the
// distance bounds, no radius prior, a non-zero spectrum weight; the launch
// refuses any other target.
// The arguments are K1's (ops/cuda_kernels.posterior_launch_args, then the
// radius-prior sigma, the counter, the stage and the walkers per block), then
// the variant id.
#include "posterior_warp.cuh"
#include "spectrum_warp.cuh"

namespace mcmc_spec {

template <bool kPhot, bool kPriors, bool kSpectrum, bool kW>
__global__ void __launch_bounds__(kStagedWalkersMax * 32, 1)
    posterior_ablate_kernel(const float* __restrict__ scal, const float* __restrict__ p,
                            const PosteriorTables t, const PosteriorConfig a, float spec_scale,
                            float* __restrict__ out, int B, int stage,
                            unsigned long long* rows) {
  extern __shared__ __align__(16) float dyn[];
  const int warp = threadIdx.x >> 5, wpb = blockDim.x >> 5;
  const int b = blockIdx.x * wpb + warp;
  const StageArea sa = stage_area(dyn, a.nd, a.NO, 1 + a.nspec, wpb, stage, rows);
  // scal: tmin, tmax, med_data
  const TargetScalars ts{scal[0], scal[1], scal[2], spec_scale, whole_row_stat(a.nd)};
  // the ragged last block: a warp past the end evaluates the last walker again, for
  // the block's copies and barriers, and writes nothing
  const float v = posterior_warp<kPhot, kPriors, kSpectrum, kW, true>(
      a, t, ts, p + (size_t)min(b, B - 1) * a.ndim,
      dyn + (size_t)warp * stage_warp_floats(a.nd, a.NO, 1 + a.nspec), &sa, b < B);
  if (b < B && (threadIdx.x & 31) == 0) out[b] = v;
}

// The launch floor: K1's launch with no body.
__global__ void __launch_bounds__(kStagedWalkersMax * 32, 1)
    posterior_empty_kernel(const float* __restrict__ scal, const float* __restrict__ p,
                           const PosteriorTables t, const PosteriorConfig a, float spec_scale,
                           float* __restrict__ out, int B, int stage,
                           unsigned long long* rows) {
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b < B && (threadIdx.x & 31) == 0) out[b] = p[(size_t)b * a.ndim];
}

using AblateKernel = void (*)(const float*, const float*, const PosteriorTables,
                              const PosteriorConfig, float, float*, int, int,
                              unsigned long long*);

template <int kMask>
constexpr AblateKernel ablate_variant() {
  return posterior_ablate_kernel<(kMask & 8) != 0, (kMask & 4) != 0, (kMask & 2) != 0,
                                 (kMask & 1) != 0>;
}

}  // namespace mcmc_spec

extern "C" int posterior_ablate_launch(
    const void* scal, const void* p, const void* D, const void* kd, const void* data,
    const void* inv_err, const void* VpinvT, const void* VT, const void* tentT,
    const void* tentG, const void* mist_tent, const void* mist_vals, const void* av_tent,
    const void* av_vals, const void* Fc, const void* Fp, const void* cobs, const void* pobs,
    const void* prior, void* out, int B, int ndim, int NO, int nd, int nm, int nav, int nc,
    int npf, int nspec, int fit_plx, int dist_fit, int rad_prior, int iters, int recip,
    float spectrum_weight, float spec_scale, float rad_sigma, void* rows, int stage, int wpb,
    int variant, void* stream) {
  using namespace mcmc_spec;
  // the masks (phot, priors, spectrum, W) by id, then the launch floor
  static const AblateKernel kVariants[] = {
      ablate_variant<0>(),  ablate_variant<1>(),  ablate_variant<2>(),  ablate_variant<3>(),
      ablate_variant<4>(),  ablate_variant<5>(),  ablate_variant<6>(),  ablate_variant<7>(),
      ablate_variant<8>(),  ablate_variant<9>(),  ablate_variant<10>(), ablate_variant<11>(),
      ablate_variant<12>(), ablate_variant<13>(), ablate_variant<14>(), ablate_variant<15>(),
      posterior_empty_kernel,
  };
  constexpr int kNumVariants = sizeof(kVariants) / sizeof(kVariants[0]);
  if (variant < 0 || variant >= kNumVariants || nspec < 2 || nspec > 3 || !fit_plx ||
      !dist_fit || rad_prior || spectrum_weight == 0.0f || nc > kMaxBands || npf > kMaxBands ||
      ndim > kMaxDim || wpb < 1 || wpb > kStagedWalkersMax || !stage_fits(nd, NO, stage))
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
  const AblateKernel kernel = kVariants[variant];
  const size_t smem = (size_t)staged_smem_floats(nd, NO, 1 + nspec, wpb, stage) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(B + wpb - 1) / wpb, 32 * wpb, smem, (cudaStream_t)stream>>>(
      (const float*)scal, (const float*)p, t, a, spec_scale, (float*)out, B, stage,
      (unsigned long long*)rows);
  return (int)cudaGetLastError();
}
