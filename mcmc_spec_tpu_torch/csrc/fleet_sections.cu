// S14: the fleet spectrum chi^2 K4 v2 with its sections switched off one at a
// time, and with its median ranks frozen to compile-time constants
// (mcmc_spec_tpu_torch/scripts/trace_fleet_step.py, try_fleet_block.py).
//
// Replaces the variant_kernel of scripts/trace_fleet_step.py:126-165 (run
// through K4's pallas_call, mcmc_spec_tpu/ops/pallas_kernels.py:405) and the
// frozen-rank variant that scripts/try_fleet_block.py:13-17 describes.  The
// kernel is K4's (spectrum_chi2_fleet.cu: the fleet's walkers flattened, one
// warp each) over spectrum_warp<kMatmul, kExtinct, kMedian>
// (spectrum_warp.cuh), whose gates default to the production body, with the
// renorm a run-time flag as in K4.  The modes, by id:
//   0 full         K4's own code: its output is K4's bit for bit
//   1 no_matmul    the row is the walker's first blend weight at every point
//   2 no_extinct   no extinction
//   3 no_median    no median match (the row as built)
//   4 no_renorm    the chi^2 against the data, no continuum fit
//   5 empty        out = Wcomb[g, 0] * 0 + av[g]: the launch floor with K4's
//                  arguments, grid and shared memory
//   6 scalar_rank  full, with every target's median ranks the compile-time
//                  constants of nd_true = 1,792 (the bench target) instead of
//                  the per-target table; the wrapper refuses another fleet, so
//                  the output is K4's bit for bit
// The arguments are K4's (ops/cuda_kernels.fleet_spectrum_launch_args), then
// the mode.
#include "spectrum_warp.cuh"

namespace mcmc_spec {

constexpr int kFrozenNd = 1792;  // scalar_rank: the n_true whose ranks it compiles in

template <bool kMatmul, bool kExtinct, bool kMedian, bool kRenorm, bool kScalarRank>
__global__ void __launch_bounds__(kWalkersMax * 32)
    fleet_sections_kernel(const float* __restrict__ Wcomb, const float* __restrict__ av,
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
  const SpecStat st = kScalarRank
                          ? SpecStat{(kFrozenNd + 1) / 2, kFrozenNd / 2 + 1, false, tscal[t * 5 + 3]}
                          : SpecStat{ranks[2 * t], ranks[2 * t + 1], false, tscal[t * 5 + 3]};
  const float chi = spectrum_warp<kMatmul, kExtinct, kMedian>(
      Wcomb + (size_t)g * NO, av[g], D + t * NO * nd, NO, nd, kd + t * nd, data + t * nd,
      inv_err + t * nd, VpinvT + t * 3 * nd, VT + t * 3 * nd, tscal[t * 5 + 2], iters, kRenorm,
      recip, st, row, lo, lw);
  if ((threadIdx.x & 31) == 0) out[g] = chi;
}

__global__ void __launch_bounds__(kWalkersMax * 32)
    fleet_empty_kernel(const float* __restrict__ Wcomb, const float* __restrict__ av,
                       const float* __restrict__ D, const float* __restrict__ kd,
                       const float* __restrict__ data, const float* __restrict__ inv_err,
                       const float* __restrict__ VpinvT, const float* __restrict__ VT,
                       const float* __restrict__ tscal, const int* __restrict__ ranks,
                       float* __restrict__ out, int nw, int B, int NO, int nd, int iters,
                       int recip) {
  const int g = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (g < B && (threadIdx.x & 31) == 0) out[g] = Wcomb[(size_t)g * NO] * 0.0f + av[g];
}

}  // namespace mcmc_spec

extern "C" int fleet_sections_launch(const void* Wcomb, const void* av, const void* D,
                                     const void* kd, const void* data, const void* inv_err,
                                     const void* VpinvT, const void* VT, const void* tscal,
                                     const void* ranks, void* out, int ntgt, int nw, int NO,
                                     int nd, int iters, int recip, int wpb, int mode,
                                     void* stream) {
  using namespace mcmc_spec;
  using SectionsKernel = void (*)(const float*, const float*, const float*, const float*,
                                  const float*, const float*, const float*, const float*,
                                  const float*, const int*, float*, int, int, int, int, int, int);
  // the modes of trace_fleet_step.py, in its order, then the frozen ranks
  static const SectionsKernel kModes[] = {
      fleet_sections_kernel<true, true, true, true, false>,   // full
      fleet_sections_kernel<false, true, true, true, false>,  // no_matmul
      fleet_sections_kernel<true, false, true, true, false>,  // no_extinct
      fleet_sections_kernel<true, true, false, true, false>,  // no_median
      fleet_sections_kernel<true, true, true, false, false>,  // no_renorm
      fleet_empty_kernel,                                      // empty
      fleet_sections_kernel<true, true, true, true, true>,    // scalar_rank
  };
  constexpr int kNumModes = sizeof(kModes) / sizeof(kModes[0]);
  if (ntgt < 1 || nw < 1 || wpb < 1 || wpb > kWalkersMax || mode < 0 || mode >= kNumModes)
    return (int)cudaErrorInvalidValue;
  const int B = ntgt * nw;
  const SectionsKernel kernel = kModes[mode];
  const size_t smem = (size_t)wpb * warp_smem_floats(nd, NO, 0) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(B + wpb - 1) / wpb, 32 * wpb, smem, (cudaStream_t)stream>>>(
      (const float*)Wcomb, (const float*)av, (const float*)D, (const float*)kd,
      (const float*)data, (const float*)inv_err, (const float*)VpinvT, (const float*)VT,
      (const float*)tscal, (const int*)ranks, (float*)out, nw, B, NO, nd, iters, recip);
  return (int)cudaGetLastError();
}
