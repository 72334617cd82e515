// S6: the fleet spectrum chi^2 (K4's body) under an explicit grid order, the
// receipt for keeping a target's tables hot across its walker blocks
// (mcmc_spec_tpu_torch/scripts/try_fleet_grid_order.py).
//
// Replaces scripts/try_fleet_grid_order.py:spectrum_chi2_fleet_2d, which runs
// the body of pallas_kernels._spectrum_chi2_fleet_kernel on a 2-D grid
// (ntgt, walker blocks) with the per-target tables keyed on the target axis
// alone.  The body here is K4's (spectrum_chi2_fleet.cu), unchanged: one
// thread block scores one walker, through spectrum_block.cuh with the
// target's median ranks and chi^2 = sum * (1/n_true), so the result equals
// K4's bit for bit.  Only the map from block to (target, walker) changes,
// through the launch argument ``order``:
//
//   target_major (0): grid (nw, ntgt), blockIdx.y the target.  The script's
//     2-D grid: a target's walkers are consecutive blocks.  K4's flat grid
//     (t = b / nw) is already target-major, so on this card this order
//     repeats K4's schedule.
//   walker_major (1): a flat grid; block b scores target b % ntgt, walker
//     b / ntgt, so consecutive blocks alternate targets and no target's
//     tables are read by a run of neighbouring blocks.
//
// Bound: operations, as K4's: the model row over the non-zero weights, the
// median's count passes, the renorm and the residual, against under 2 MB of
// walker input; a target's D (56 x 1792 f32, 401 KB) and all nine targets'
// (3.6 MB) fit the 50 MB L2 many times, so neither order should have to go to
// device memory for the tables.  A simple, correct first version, as K4 is.
#include "spectrum_block.cuh"

namespace mcmc_spec {

constexpr int kTargetMajor = 0;
constexpr int kWalkerMajor = 1;

__global__ void __launch_bounds__(kThreads)
    fleet_grid_order_kernel(const float* __restrict__ Wcomb, const float* __restrict__ av,
                            const float* __restrict__ D, const float* __restrict__ kd,
                            const float* __restrict__ data, const float* __restrict__ inv_err,
                            const float* __restrict__ VpinvT, const float* __restrict__ VT,
                            const float* __restrict__ tscal, const int* __restrict__ ranks,
                            float* __restrict__ out, int ntgt, int nw, int NO, int nd,
                            int iters, int recip, int order) {
  extern __shared__ float dyn[];
  float* row = dyn;      // [nd] model row
  float* wc = dyn + nd;  // [NO] this walker's Wcomb
  __shared__ BlockScratch scratch;
  // from here on K4's code, with its integer widths: b the flat walker index
  // (int), t the target (size_t); a first version that kept both in size_t
  // took 34 registers to K4's 32 and ran 5 % slower in either order
  const int tb = order == kTargetMajor ? (int)blockIdx.y : (int)blockIdx.x % ntgt;
  const int b = tb * nw + (order == kTargetMajor ? (int)blockIdx.x : (int)blockIdx.x / ntgt);
  const size_t t = (size_t)tb;
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

extern "C" int fleet_grid_order_launch(const void* Wcomb, const void* av, const void* D,
                                       const void* kd, const void* data, const void* inv_err,
                                       const void* VpinvT, const void* VT, const void* tscal,
                                       const void* ranks, void* out, int ntgt, int nw, int NO,
                                       int nd, int iters, int recip, int order, void* stream) {
  using namespace mcmc_spec;
  if (ntgt < 1 || nw < 1 || (order != kTargetMajor && order != kWalkerMajor) ||
      (order == kTargetMajor && ntgt > 65535))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(nd + NO) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fleet_grid_order_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid = order == kTargetMajor ? dim3(nw, ntgt) : dim3(ntgt * nw);
  fleet_grid_order_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)Wcomb, (const float*)av, (const float*)D, (const float*)kd,
      (const float*)data, (const float*)inv_err, (const float*)VpinvT, (const float*)VT,
      (const float*)tscal, (const int*)ranks, (float*)out, ntgt, nw, NO, nd, iters, recip, order);
  return (int)cudaGetLastError();
}
