// K4: the spectrum chi^2 of every walker of a stacked, padded fleet, one
// thread block per walker, all targets in one launch.
//
// Replaces mcmc_spec_tpu/ops/pallas_kernels.py:spectrum_chi2_fleet (body
// _spectrum_chi2_fleet_kernel).  Block b scores walker b % nw of target
// t = b / nw: its blend weights Wcomb[b, :] go to shared memory, target t's
// rows of D, kd, data, inv_err, VpinvT and VT ([ntgt, ...], contiguous) are
// read by offset, and the spectrum block (spectrum_block.cuh) runs with t's
// median ranks (ranks [ntgt, 2]) and chi^2 = sum * (1/n_true) (tscal[t, 3]),
// so padded points are inert.  Only the D rows with a non-zero weight are
// read, so the 1e30 sentinel columns never meet a zero weight.  The grid has
// exactly ntgt * nw blocks: no walker padding, any nw.
//
// Bound: operations, not bytes: the model row (non-zero weights x nd FMAs),
// one count over nd per median pass, the renorm and the residual, against
// under 2 MB of walker input.  This is a simple, correct first version:
// wgmma, TMA and sharing D across the walkers of a target in shared memory
// are later work.
#include "spectrum_block.cuh"

namespace mcmc_spec {

__global__ void __launch_bounds__(kThreads)
    spectrum_chi2_fleet_kernel(const float* __restrict__ Wcomb, const float* __restrict__ av,
                               const float* __restrict__ D, const float* __restrict__ kd,
                               const float* __restrict__ data, const float* __restrict__ inv_err,
                               const float* __restrict__ VpinvT, const float* __restrict__ VT,
                               const float* __restrict__ tscal, const int* __restrict__ ranks,
                               float* __restrict__ out, int nw, int NO, int nd, int iters,
                               int recip) {
  extern __shared__ float dyn[];
  float* row = dyn;      // [nd] model row
  float* wc = dyn + nd;  // [NO] this walker's Wcomb
  __shared__ BlockScratch scratch;
  const int b = blockIdx.x;
  const size_t t = (size_t)(b / nw);
  for (int o = threadIdx.x; o < NO; o += blockDim.x) wc[o] = Wcomb[(size_t)b * NO + o];
  __syncthreads();
  // tscal[t]: tmin, tmax, med_data, 1/n_true, spectrum scale
  const SpecStat st{ranks[2 * t], ranks[2 * t + 1], false, tscal[t * 5 + 3]};
  const float chi = spectrum_block(wc, av[b], D + t * NO * nd, NO, nd, kd + t * nd,
                                   data + t * nd, inv_err + t * nd, VpinvT + t * 3 * nd,
                                   VT + t * 3 * nd, tscal[t * 5 + 2], iters, true, recip, st,
                                   row, &scratch);
  if (threadIdx.x == 0) out[b] = chi;
}

}  // namespace mcmc_spec

extern "C" int spectrum_chi2_fleet_launch(const void* Wcomb, const void* av, const void* D,
                                          const void* kd, const void* data, const void* inv_err,
                                          const void* VpinvT, const void* VT, const void* tscal,
                                          const void* ranks, void* out, int ntgt, int nw, int NO,
                                          int nd, int iters, int recip, void* stream) {
  using namespace mcmc_spec;
  if (ntgt < 1 || nw < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(nd + NO) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        spectrum_chi2_fleet_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  spectrum_chi2_fleet_kernel<<<ntgt * nw, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)Wcomb, (const float*)av, (const float*)D, (const float*)kd,
      (const float*)data, (const float*)inv_err, (const float*)VpinvT, (const float*)VT,
      (const float*)tscal, (const int*)ranks, (float*)out, nw, NO, nd, iters, recip);
  return (int)cudaGetLastError();
}
