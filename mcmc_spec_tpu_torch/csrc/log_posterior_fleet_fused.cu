// K5: the whole batched log-posterior of every walker of a stacked, padded
// fleet, one warp per walker, all targets in one launch (v2).
//
// Replaces mcmc_spec_tpu/ops/pallas_kernels.py:log_posterior_fleet_fused
// (body _fleet_posterior_kernel).  The walkers of the fleet are flattened to
// [ntgt * nw]; a block of wpb warps (ops/cuda_kernels.py:walkers_per_block
// at the padded nd, at most 8) takes walkers blockIdx.x * wpb ... + wpb - 1,
// so a block may span two targets: warp w evaluates walker g = blockIdx.x *
// wpb + w of target t = g / nw through posterior_warp (posterior_warp.cuh,
// K1's body), reading t's rows of the stacked [ntgt, ...] tables by offset
// and t's scalars from tscal [ntgt, 5] (tmin, tmax, med_data, 1/n_true,
// spectrum weight x (nc_true + np_true)) and ranks [ntgt, 2] (the median's
// 1-based ranks over the true points).  Whole warps leave the ragged last
// block, and no warp waits for another: ptxas reports no barrier.  v1 ran
// one block of 256 threads per walker (posterior_body.cuh): the scalar part
// in warp 0 while seven warps waited, two barriers per median pass, and a
// row build over all NO weights.
//
// Padded data points are inert: their D columns are 1e30 (above every real
// model value, so the ranks never reach them), their inv_err 0, their Vpinv
// columns 0; padded contrast filters have cerr = inf.  The compact list of
// each walker's non-zero weights keeps the sentinel rows of unweighted grid
// points out of the row build.  spectrum_warp.cuh says what bounds the body.
#include "posterior_warp.cuh"
#include "spectrum_warp.cuh"

namespace mcmc_spec {

__global__ void __launch_bounds__(kWalkersMax * 32)
    log_posterior_fleet_fused_kernel(const float* __restrict__ tscal,
                                     const int* __restrict__ ranks, const float* __restrict__ p,
                                     const PosteriorTables fleet, const PosteriorConfig a, int nw,
                                     int B, float* __restrict__ out) {
  extern __shared__ __align__(16) float dyn[];
  const int warp = threadIdx.x >> 5;
  const int g = blockIdx.x * (blockDim.x >> 5) + warp;
  if (g >= B) return;  // the ragged last block: whole warps leave
  const int tgt = g / nw;
  const float* sc = tscal + (size_t)tgt * 5;
  const SpecStat st{ranks[2 * tgt], ranks[2 * tgt + 1], false, sc[3]};
  const TargetScalars ts{sc[0], sc[1], sc[2], sc[4], st};
  const float v = posterior_warp(a, target_tables(fleet, a, tgt), ts, p + (size_t)g * a.ndim,
                                 dyn + (size_t)warp * warp_smem_floats(a.nd, a.NO, 1 + a.nspec));
  if ((threadIdx.x & 31) == 0) out[g] = v;
}

}  // namespace mcmc_spec

extern "C" int log_posterior_fleet_fused_launch(
    const void* tscal, const void* ranks, const void* p, const void* D, const void* kd,
    const void* data, const void* inv_err, const void* VpinvT, const void* VT, const void* tentT,
    const void* tentG, const void* mist_tent, const void* mist_vals, const void* av_tent,
    const void* av_vals, const void* Fc, const void* Fp, const void* cobs, const void* pobs,
    const void* prior, void* out, int ntgt, int nw, int ndim, int NO, int nd, int nm, int nav,
    int nc, int npf, int nspec, int fit_plx, int dist_fit, int rad_prior, int iters, int recip,
    float spectrum_weight, float rad_sigma, int wpb, void* stream) {
  using namespace mcmc_spec;
  if (nspec < 1 || nspec > kMaxSpec || nc > kMaxBands || npf > kMaxBands || ndim > kMaxDim ||
      ntgt < 1 || nw < 1 || wpb < 1 || wpb > kWalkersMax)
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
  const int B = ntgt * nw;
  const size_t smem = (size_t)wpb * warp_smem_floats(nd, NO, 1 + nspec) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        log_posterior_fleet_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  log_posterior_fleet_fused_kernel<<<(B + wpb - 1) / wpb, 32 * wpb, smem, (cudaStream_t)stream>>>(
      (const float*)tscal, (const int*)ranks, (const float*)p, t, a, nw, B, (float*)out);
  return (int)cudaGetLastError();
}
