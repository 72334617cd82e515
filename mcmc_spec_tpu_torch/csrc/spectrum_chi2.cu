// K3: the spectrum block alone (mean spectrum chi^2 per walker), renorm on
// or off, one warp per walker.
//
// Replaces mcmc_spec_tpu/ops/pallas_kernels.py:spectrum_chi2 (body
// _spectrum_chi2_kernel).  With renorm off it is the stage-1 annealer's
// median-only scoring; with renorm on, the stage-2 composition's spectrum
// term when the fused kernel does not apply.  A block of wpb warps (chosen by
// ops/cuda_kernels.py:walkers_per_block, at most 8) takes walkers
// blockIdx.x * wpb ... + wpb - 1; each warp builds its compact weight list
// straight from its Wcomb row in global memory, then runs the body of
// spectrum_warp.cuh, which says what bounds it.  No block barrier.
#include "spectrum_warp.cuh"

namespace mcmc_spec {

__global__ void __launch_bounds__(kWalkersMax * 32)
    spectrum_chi2_kernel(const float* __restrict__ Wcomb, const float* __restrict__ av,
                         const float* __restrict__ D, const float* __restrict__ kd,
                         const float* __restrict__ data, const float* __restrict__ inv_err,
                         const float* __restrict__ VpinvT, const float* __restrict__ VT,
                         const float* __restrict__ med_data, float* __restrict__ out, int NW,
                         int NO, int nd, int iters, int renorm, int recip) {
  extern __shared__ __align__(16) float dyn[];
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= NW) return;  // the ragged last block: whole warps leave
  float* row = dyn + (size_t)warp * warp_smem_floats(nd, NO, 0);
  int* lo = reinterpret_cast<int*>(row + round4(nd));
  float* lw = reinterpret_cast<float*>(lo + NO);
  const float chi = spectrum_warp(Wcomb + (size_t)b * NO, av[b], D, NO, nd, kd, data, inv_err,
                                  VpinvT, VT, med_data[0], iters, renorm != 0, recip,
                                  whole_row_stat(nd), row, lo, lw);
  if ((threadIdx.x & 31) == 0) out[b] = chi;
}

}  // namespace mcmc_spec

extern "C" int spectrum_chi2_launch(const void* Wcomb, const void* av, const void* D,
                                    const void* kd, const void* data, const void* inv_err,
                                    const void* VpinvT, const void* VT, const void* med_data,
                                    void* out, int NW, int NO, int nd, int iters, int renorm,
                                    int recip, int wpb, void* stream) {
  using namespace mcmc_spec;
  if (wpb < 1 || wpb > kWalkersMax) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)wpb * warp_smem_floats(nd, NO, 0) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        spectrum_chi2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  spectrum_chi2_kernel<<<(NW + wpb - 1) / wpb, 32 * wpb, smem, (cudaStream_t)stream>>>(
      (const float*)Wcomb, (const float*)av, (const float*)D, (const float*)kd,
      (const float*)data, (const float*)inv_err, (const float*)VpinvT, (const float*)VT,
      (const float*)med_data, (float*)out, NW, NO, nd, iters, renorm, recip);
  return (int)cudaGetLastError();
}
