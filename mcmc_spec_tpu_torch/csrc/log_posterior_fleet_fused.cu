// K5: the whole batched log-posterior of every walker of a stacked, padded
// fleet, one thread block per walker, all targets in one launch.
//
// Replaces mcmc_spec_tpu/ops/pallas_kernels.py:log_posterior_fleet_fused
// (body _fleet_posterior_kernel).  The body is posterior_body.cuh, shared with
// K1.  Block b evaluates walker b % nw of target t = b / nw: it reads target
// t's rows of the stacked [ntgt, ...] tables by offset, and t's scalars from
// tscal [ntgt, 5] (tmin, tmax, med_data, 1/n_true, spectrum weight x
// (nc_true + np_true)) and ranks [ntgt, 2] (the median's 1-based ranks over
// the true points).  Padded data points are inert: their D columns are 1e30
// (above every real model value, so the ranks never reach them), their
// inv_err 0, their Vpinv columns 0; padded contrast filters have cerr = inf.
// The grid has exactly ntgt * nw blocks: no walker padding, any nw.
//
// Bound: operations, not bytes.  Per walker the model row costs the few
// non-zero blend weights x nd FMAs, then a count over nd per median pass and
// the renorm and residual sweeps; the stacked tables (D is 3.6 MB for nine
// koi2298-scale targets) stay L2-resident across the 4096 walkers of each
// target.  This is a simple, correct first version: wgmma, TMA and sharing
// D across the walkers of a target in shared memory are later work.
#include "posterior_body.cuh"

namespace mcmc_spec {

__global__ void __launch_bounds__(kThreads)
    log_posterior_fleet_fused_kernel(const float* __restrict__ tscal,
                                     const int* __restrict__ ranks, const float* __restrict__ p,
                                     const PosteriorTables fleet, const PosteriorConfig a, int nw,
                                     float* __restrict__ out) {
  extern __shared__ float dyn[];
  const int b = blockIdx.x;
  const int tgt = b / nw;
  const float* sc = tscal + (size_t)tgt * 5;
  const SpecStat st{ranks[2 * tgt], ranks[2 * tgt + 1], false, sc[3]};
  const TargetScalars ts{sc[0], sc[1], sc[2], sc[4], st};
  const float v = posterior_eval(a, target_tables(fleet, a, tgt), ts, p + (size_t)b * a.ndim, dyn);
  if (threadIdx.x == 0) out[b] = v;
}

}  // namespace mcmc_spec

extern "C" int log_posterior_fleet_fused_launch(
    const void* tscal, const void* ranks, const void* p, const void* D, const void* kd,
    const void* data, const void* inv_err, const void* VpinvT, const void* VT, const void* tentT,
    const void* tentG, const void* mist_tent, const void* mist_vals, const void* av_tent,
    const void* av_vals, const void* Fc, const void* Fp, const void* cobs, const void* pobs,
    const void* prior, void* out, int ntgt, int nw, int ndim, int NO, int nd, int nm, int nav,
    int nc, int npf, int nspec, int fit_plx, int dist_fit, int rad_prior, int iters, int recip,
    float spectrum_weight, float rad_sigma, void* stream) {
  using namespace mcmc_spec;
  if (nspec < 1 || nspec > kMaxSpec || nc > kMaxBands || npf > kMaxBands || ndim > kMaxDim ||
      ntgt < 1 || nw < 1)
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
        log_posterior_fleet_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  log_posterior_fleet_fused_kernel<<<ntgt * nw, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)tscal, (const int*)ranks, (const float*)p, t, a, nw, (float*)out);
  return (int)cudaGetLastError();
}
