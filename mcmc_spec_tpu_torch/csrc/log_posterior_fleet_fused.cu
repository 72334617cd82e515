// K5: the whole batched log-posterior of every walker of a stacked, padded
// fleet, one warp per walker, all targets in one launch (v4: the walker's model
// row in registers up to a padded nd of 1,792; v3 wider).
//
// Replaces mcmc_spec_tpu/ops/pallas_kernels.py:log_posterior_fleet_fused
// (body _fleet_posterior_kernel).  Each target has its row of blocks
// (blockIdx.y the target): a block of wpb warps (ops/cuda_kernels.py:
// staged_block at the padded nd, at most 16) takes walkers blockIdx.x * wpb ...
// + wpb - 1 of its target, so no block spans two targets, and warp w evaluates
// its walker through posterior_warp (posterior_warp.cuh, K1's body), reading
// the target's rows of the stacked [ntgt, ...] tables by offset and its scalars
// from tscal [ntgt, 5] (tmin, tmax, med_data, 1/n_true, spectrum weight x
// (nc_true + np_true)) and ranks [ntgt, 2] (the median's 1-based ranks over the
// true points).  The block's warps run K1's spectrum body (spectrum_stage.cuh)
// together: the target's tables and the block's union of D rows come from L2 once
// a block, through shared-memory tiles.  v2 flattened
// the fleet's walkers, so a block could span two targets, each warp alone; v1
// ran one block of 256 threads per walker (posterior_body.cuh).
//
// Padded data points are inert: their D columns are 1e30 (above every real
// model value, so the ranks never reach them), their inv_err 0, their Vpinv
// columns 0; padded contrast filters have cerr = inf.  The compact list of
// each walker's non-zero weights keeps the sentinel rows of unweighted grid
// points out of the row build.  spectrum_stage.cuh says what bounds the body.
#include "posterior_warp.cuh"
#include "spectrum_warp.cuh"

namespace mcmc_spec {

__global__ void __launch_bounds__(kStagedWalkersMax * 32, 1)
    log_posterior_fleet_fused_kernel(const float* __restrict__ tscal,
                                     const int* __restrict__ ranks, const float* __restrict__ p,
                                     const PosteriorTables fleet, const PosteriorConfig a, int nw,
                                     float* __restrict__ out, int stage,
                                     unsigned long long* rows) {
  extern __shared__ __align__(16) float dyn[];
  const int warp = threadIdx.x >> 5, wpb = blockDim.x >> 5;
  const int tgt = blockIdx.y;
  const int i = blockIdx.x * wpb + warp;  // the walker of target tgt
  const StageArea sa = stage_area(dyn, a.nd, a.NO, 1 + a.nspec, wpb, stage, rows);
  const float* sc = tscal + (size_t)tgt * 5;
  const SpecStat st{ranks[2 * tgt], ranks[2 * tgt + 1], false, sc[3]};
  const TargetScalars ts{sc[0], sc[1], sc[2], sc[4], st};
  // the target's ragged last block: a warp past its end evaluates the target's last
  // walker again, for the block's copies and barriers, and writes nothing
  const size_t g = (size_t)tgt * nw + min(i, nw - 1);
  const float v = posterior_warp<true, true, true, true, true>(
      a, target_tables(fleet, a, tgt), ts, p + g * a.ndim,
      dyn + (size_t)warp * stage_warp_floats(a.nd, a.NO, 1 + a.nspec), &sa, i < nw);
  if (i < nw && (threadIdx.x & 31) == 0) out[g] = v;
}

}  // namespace mcmc_spec

extern "C" int log_posterior_fleet_fused_launch(
    const void* tscal, const void* ranks, const void* p, const void* D, const void* kd,
    const void* data, const void* inv_err, const void* VpinvT, const void* VT, const void* tentT,
    const void* tentG, const void* mist_tent, const void* mist_vals, const void* av_tent,
    const void* av_vals, const void* Fc, const void* Fp, const void* cobs, const void* pobs,
    const void* prior, void* out, int ntgt, int nw, int ndim, int NO, int nd, int nm, int nav,
    int nc, int npf, int nspec, int fit_plx, int dist_fit, int rad_prior, int iters, int recip,
    float spectrum_weight, float rad_sigma, void* rows, int stage, int wpb, void* stream) {
  using namespace mcmc_spec;
  if (nspec < 1 || nspec > kMaxSpec || nc > kMaxBands || npf > kMaxBands || ndim > kMaxDim ||
      ntgt < 1 || ntgt > 65535 || nw < 1 || wpb < 1 || wpb > kStagedWalkersMax ||
      !stage_fits(nd, NO, stage))
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
        log_posterior_fleet_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((nw + wpb - 1) / wpb, ntgt);  // a row of blocks a target
  log_posterior_fleet_fused_kernel<<<grid, 32 * wpb, smem, (cudaStream_t)stream>>>(
      (const float*)tscal, (const int*)ranks, (const float*)p, t, a, nw, (float*)out, stage,
      (unsigned long long*)rows);
  return (int)cudaGetLastError();
}
