// K3: the spectrum block alone (mean spectrum chi^2 per walker), renorm on
// or off, one thread block per walker.
//
// Replaces mcmc_spec_tpu/ops/pallas_kernels.py:spectrum_chi2 (body
// _spectrum_chi2_kernel).  With renorm off it is the stage-1 annealer's
// median-only scoring; with renorm on, the stage-2 composition's spectrum
// term when the fused kernel does not apply.  The walker's Wcomb row goes to
// shared memory; the rest, and what bounds it, is spectrum_block.cuh.
#include "spectrum_block.cuh"

namespace mcmc_spec {

__global__ void __launch_bounds__(kThreads)
    spectrum_chi2_kernel(const float* __restrict__ Wcomb, const float* __restrict__ av,
                         const float* __restrict__ D, const float* __restrict__ kd,
                         const float* __restrict__ data, const float* __restrict__ inv_err,
                         const float* __restrict__ VpinvT, const float* __restrict__ VT,
                         const float* __restrict__ med_data, float* __restrict__ out, int NO,
                         int nd, int iters, int renorm, int recip) {
  extern __shared__ float dyn[];
  float* row = dyn;        // [nd] model row
  float* wc = dyn + nd;    // [NO] this walker's Wcomb
  __shared__ BlockScratch scratch;
  const int b = blockIdx.x;
  for (int o = threadIdx.x; o < NO; o += blockDim.x) wc[o] = Wcomb[(size_t)b * NO + o];
  __syncthreads();
  const float chi = spectrum_block(wc, av[b], D, NO, nd, kd, data, inv_err, VpinvT, VT,
                                   med_data[0], iters, renorm != 0, recip, whole_row_stat(nd),
                                   row, &scratch);
  if (threadIdx.x == 0) out[b] = chi;
}

}  // namespace mcmc_spec

extern "C" int spectrum_chi2_launch(const void* Wcomb, const void* av, const void* D,
                                    const void* kd, const void* data, const void* inv_err,
                                    const void* VpinvT, const void* VT, const void* med_data,
                                    void* out, int NW, int NO, int nd, int iters, int renorm,
                                    int recip, void* stream) {
  using namespace mcmc_spec;
  const size_t smem = (size_t)(nd + NO) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        spectrum_chi2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  spectrum_chi2_kernel<<<NW, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)Wcomb, (const float*)av, (const float*)D, (const float*)kd,
      (const float*)data, (const float*)inv_err, (const float*)VpinvT, (const float*)VT,
      (const float*)med_data, (float*)out, NO, nd, iters, renorm, recip);
  return (int)cudaGetLastError();
}
