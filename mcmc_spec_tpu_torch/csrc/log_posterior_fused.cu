// K1: the whole batched log-posterior of one unpadded target, one thread
// block per walker.
//
// Replaces mcmc_spec_tpu/ops/pallas_kernels.py:log_posterior_fused (body
// _posterior_kernel).  The body is posterior_body.cuh, shared with the fleet
// kernel K5; here the tables are the target's own, the median is the whole
// row's and the spectrum chi^2 the mean.  The grid has exactly B blocks: no
// walker padding.
#include "posterior_body.cuh"

namespace mcmc_spec {

__global__ void __launch_bounds__(kThreads)
    log_posterior_fused_kernel(const float* __restrict__ scal, const float* __restrict__ p,
                               const PosteriorTables t, const PosteriorConfig a,
                               float spec_scale, float* __restrict__ out) {
  extern __shared__ float dyn[];
  const int b = blockIdx.x;
  // scal: tmin, tmax, med_data
  const TargetScalars ts{scal[0], scal[1], scal[2], spec_scale, whole_row_stat(a.nd)};
  const float v = posterior_eval(a, t, ts, p + (size_t)b * a.ndim, dyn);
  if (threadIdx.x == 0) out[b] = v;
}

}  // namespace mcmc_spec

extern "C" int log_posterior_fused_launch(
    const void* scal, const void* p, const void* D, const void* kd, const void* data,
    const void* inv_err, const void* VpinvT, const void* VT, const void* tentT,
    const void* tentG, const void* mist_tent, const void* mist_vals, const void* av_tent,
    const void* av_vals, const void* Fc, const void* Fp, const void* cobs, const void* pobs,
    const void* prior, void* out, int B, int ndim, int NO, int nd, int nm, int nav, int nc,
    int npf, int nspec, int fit_plx, int dist_fit, int rad_prior, int iters, int recip,
    float spectrum_weight, float spec_scale, float rad_sigma, void* stream) {
  using namespace mcmc_spec;
  if (nspec < 1 || nspec > kMaxSpec || nc > kMaxBands || npf > kMaxBands || ndim > kMaxDim)
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
  const size_t smem = posterior_smem(nd, NO, nspec);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        log_posterior_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  log_posterior_fused_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)scal, (const float*)p, t, a, spec_scale, (float*)out);
  return (int)cudaGetLastError();
}
