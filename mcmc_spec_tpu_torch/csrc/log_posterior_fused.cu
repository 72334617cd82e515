// K1: the whole batched log-posterior of one unpadded target, one warp per
// walker (v4: the walker's model row in registers up to nd = 1,792; v3 wider).
//
// Replaces mcmc_spec_tpu/ops/pallas_kernels.py:log_posterior_fused (body
// _posterior_kernel).  A block of wpb warps (ops/cuda_kernels.py:staged_block,
// at most 16) takes walkers blockIdx.x * wpb ... + wpb - 1; each warp runs its
// walker's scalar part alone through posterior_warp (posterior_warp.cuh, shared
// with the fleet posterior K5), then the block's warps run the spectrum body of
// spectrum_stage.cuh together: the target's tables and the block's union of D
// rows come from L2 once a block, in shared-memory tiles of `stage` floats, two
// buffers; each warp's row stays in its lanes' registers (v4) or, past 1,792
// points, in shared memory (v3).  The median is the whole row's and the spectrum
// chi^2 the mean.
// `rows`, where not null, counts the D rows staged, the D rows the walkers
// read from them and the blocks (the staging counter of ops/cuda_kernels.py).
#include "posterior_warp.cuh"
#include "spectrum_warp.cuh"

namespace mcmc_spec {

__global__ void __launch_bounds__(kStagedWalkersMax * 32, 1)
    log_posterior_fused_kernel(const float* __restrict__ scal, const float* __restrict__ p,
                               const PosteriorTables t, const PosteriorConfig a,
                               float spec_scale, float* __restrict__ out, int B, int stage,
                               unsigned long long* rows) {
  extern __shared__ __align__(16) float dyn[];
  const int warp = threadIdx.x >> 5, wpb = blockDim.x >> 5;
  const int b = blockIdx.x * wpb + warp;
  const StageArea sa = stage_area(dyn, a.nd, a.NO, 1 + a.nspec, wpb, stage, rows);
  // scal: tmin, tmax, med_data
  const TargetScalars ts{scal[0], scal[1], scal[2], spec_scale, whole_row_stat(a.nd)};
  // the ragged last block: a warp past the end evaluates the last walker again, for
  // the block's copies and barriers, and writes nothing
  const float v = posterior_warp<true, true, true, true, true>(
      a, t, ts, p + (size_t)min(b, B - 1) * a.ndim,
      dyn + (size_t)warp * stage_warp_floats(a.nd, a.NO, 1 + a.nspec), &sa, b < B);
  if (b < B && (threadIdx.x & 31) == 0) out[b] = v;
}

}  // namespace mcmc_spec

extern "C" int log_posterior_fused_launch(
    const void* scal, const void* p, const void* D, const void* kd, const void* data,
    const void* inv_err, const void* VpinvT, const void* VT, const void* tentT,
    const void* tentG, const void* mist_tent, const void* mist_vals, const void* av_tent,
    const void* av_vals, const void* Fc, const void* Fp, const void* cobs, const void* pobs,
    const void* prior, void* out, int B, int ndim, int NO, int nd, int nm, int nav, int nc,
    int npf, int nspec, int fit_plx, int dist_fit, int rad_prior, int iters, int recip,
    float spectrum_weight, float spec_scale, float rad_sigma, void* rows, int stage, int wpb,
    void* stream) {
  using namespace mcmc_spec;
  if (nspec < 1 || nspec > kMaxSpec || nc > kMaxBands || npf > kMaxBands || ndim > kMaxDim ||
      wpb < 1 || wpb > kStagedWalkersMax || !stage_fits(nd, NO, stage))
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
  const size_t smem = (size_t)staged_smem_floats(nd, NO, 1 + nspec, wpb, stage) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        log_posterior_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  log_posterior_fused_kernel<<<(B + wpb - 1) / wpb, 32 * wpb, smem, (cudaStream_t)stream>>>(
      (const float*)scal, (const float*)p, t, a, spec_scale, (float*)out, B, stage,
      (unsigned long long*)rows);
  return (int)cudaGetLastError();
}
