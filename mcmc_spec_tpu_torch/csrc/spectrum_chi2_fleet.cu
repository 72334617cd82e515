// K4: the spectrum chi^2 of every walker of a stacked, padded fleet, one warp
// per walker, all targets in one launch (v2).
//
// Replaces mcmc_spec_tpu/ops/pallas_kernels.py:spectrum_chi2_fleet (body
// _spectrum_chi2_fleet_kernel).  The map is K5 v2's
// (log_posterior_fleet_fused.cu): the walkers of the fleet are flattened to
// B = ntgt * nw, and a block of wpb warps (ops/cuda_kernels.py:
// walkers_per_block at the padded nd with no weight rows, at most 8) takes
// walkers g = blockIdx.x * wpb + warp, so a block may span two targets.  The
// body is K3 v2's: warp g of target t = g / nw runs spectrum_warp
// (spectrum_warp.cuh) on Wcomb[g, :] and av[g], reading t's rows of the
// stacked [ntgt, ...] tables D, kd, data, inv_err, VpinvT and VT by offset,
// with the renorm on, t's median ranks (ranks [ntgt, 2]), t's med_data
// (tscal[t, 2]) and chi^2 = sum * (1/n_true) (tscal[t, 3]).  Whole warps
// leave the ragged last block, and no warp waits for another: ptxas reports
// no barrier.  v1 ran one block of 256 threads per walker
// (spectrum_block.cuh, still the body of the experiment S6): two barriers per
// median pass, and the row build, median and tail in series.
//
// Padded data points are inert: their D columns are 1e30 (above every real
// model value, so the true ranks never reach them), their inv_err 0 and
// their Vpinv columns 0, so they add nothing to the renorm or the chi^2.
// The compact list of each walker's non-zero weights keeps the sentinel rows
// of unweighted grid points out of the row build, so a 1e30 never meets a
// zero weight.  spectrum_warp.cuh says what bounds the body.
#include "spectrum_warp.cuh"

namespace mcmc_spec {

__global__ void __launch_bounds__(kWalkersMax * 32)
    spectrum_chi2_fleet_kernel(const float* __restrict__ Wcomb, const float* __restrict__ av,
                               const float* __restrict__ D, const float* __restrict__ kd,
                               const float* __restrict__ data, const float* __restrict__ inv_err,
                               const float* __restrict__ VpinvT, const float* __restrict__ VT,
                               const float* __restrict__ tscal, const int* __restrict__ ranks,
                               float* __restrict__ out, int nw, int B, int NO, int nd, int iters,
                               int recip) {
  extern __shared__ __align__(16) float dyn[];
  const int warp = threadIdx.x >> 5;
  const int g = blockIdx.x * (blockDim.x >> 5) + warp;
  if (g >= B) return;  // the ragged last block: whole warps leave
  const size_t t = (size_t)(g / nw);
  float* row = dyn + (size_t)warp * warp_smem_floats(nd, NO, 0);
  int* lo = reinterpret_cast<int*>(row + round4(nd));
  float* lw = reinterpret_cast<float*>(lo + NO);
  // tscal[t]: tmin, tmax, med_data, 1/n_true, spectrum scale
  const SpecStat st{ranks[2 * t], ranks[2 * t + 1], false, tscal[t * 5 + 3]};
  const float chi = spectrum_warp(Wcomb + (size_t)g * NO, av[g], D + t * NO * nd, NO, nd,
                                  kd + t * nd, data + t * nd, inv_err + t * nd,
                                  VpinvT + t * 3 * nd, VT + t * 3 * nd, tscal[t * 5 + 2], iters,
                                  true, recip, st, row, lo, lw);
  if ((threadIdx.x & 31) == 0) out[g] = chi;
}

}  // namespace mcmc_spec

extern "C" int spectrum_chi2_fleet_launch(const void* Wcomb, const void* av, const void* D,
                                          const void* kd, const void* data, const void* inv_err,
                                          const void* VpinvT, const void* VT, const void* tscal,
                                          const void* ranks, void* out, int ntgt, int nw, int NO,
                                          int nd, int iters, int recip, int wpb, void* stream) {
  using namespace mcmc_spec;
  if (ntgt < 1 || nw < 1 || wpb < 1 || wpb > kWalkersMax) return (int)cudaErrorInvalidValue;
  const int B = ntgt * nw;
  const size_t smem = (size_t)wpb * warp_smem_floats(nd, NO, 0) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        spectrum_chi2_fleet_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  spectrum_chi2_fleet_kernel<<<(B + wpb - 1) / wpb, 32 * wpb, smem, (cudaStream_t)stream>>>(
      (const float*)Wcomb, (const float*)av, (const float*)D, (const float*)kd,
      (const float*)data, (const float*)inv_err, (const float*)VpinvT, (const float*)VT,
      (const float*)tscal, (const int*)ranks, (float*)out, nw, B, NO, nd, iters, recip);
  return (int)cudaGetLastError();
}
