// K1: the whole batched log-posterior of one unpadded target, one warp per
// walker.
//
// Replaces mcmc_spec_tpu/ops/pallas_kernels.py:log_posterior_fused (body
// _posterior_kernel).  A block of wpb warps (chosen by
// ops/cuda_kernels.py:walkers_per_block, at most 8) takes walkers
// blockIdx.x * wpb ... + wpb - 1, and each warp runs its walker alone, with
// no block barrier, through posterior_warp (posterior_warp.cuh, shared with
// the fleet posterior K5): the scalar part, then the spectrum body of
// spectrum_warp.cuh, which says what bounds it.  One warp's scalar part and
// epilogue thus overlap the other warps' spectrum work, where the
// block-per-walker version (still the body of S8 and S12, posterior_body.cuh)
// ran them in warp 0 while seven warps waited at a barrier.  The median is
// the whole row's and the spectrum chi^2 the mean.
#include "posterior_warp.cuh"
#include "spectrum_warp.cuh"

namespace mcmc_spec {

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
