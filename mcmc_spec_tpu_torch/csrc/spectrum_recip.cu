// S4: the spectrum block with the two continuum-renorm divides on a dial, the
// receipt for the recip_newton dial (mcmc_spec_tpu_torch/scripts/try_fast_recip.py).
//
// Replaces scripts/try_fast_recip.py:run (body
// _spectrum_block_recip): K2 with renorm on, the median at `iters` midpoint
// passes (16 in the experiment), and frac = data / model, data_renorm = data /
// fitted either exact (recip = 0) or as data * the magic-seed reciprocal with
// 1 or 2 Newton steps (div_dial, block_common.cuh).  noexp swaps the
// extinction exp for the same-shape linear term (spectrum_block<true>), to
// price the exp in context.  The kernel is K3's (spectrum_chi2.cu), renorm
// included as a launch argument (always 1): with renorm a compile-time
// constant nvcc emitted other code, and 7,219 of 32,768 chi^2 came out an ulp
// or so from K3's (H100 80GB HBM3).  As it is, at recip = 0 without noexp it
// equals K3's first version bit for bit; K3 now runs one warp per walker and
// agrees with it to rounding (the sums' order).  What
// bounds it is what bounds K3 (spectrum_block.cuh): the model-row build, then
// the median's count passes.  The experiment's blend weights are a dense
// Dirichlet, so the row build reads all NO rows of D per point where
// production reads at most 8.
#include "spectrum_block.cuh"

namespace mcmc_spec {

template <bool kNoExp>
__global__ void __launch_bounds__(kThreads)
    spectrum_recip_kernel(const float* __restrict__ Wcomb, const float* __restrict__ av,
                          const float* __restrict__ D, const float* __restrict__ kd,
                          const float* __restrict__ data, const float* __restrict__ inv_err,
                          const float* __restrict__ VpinvT, const float* __restrict__ VT,
                          const float* __restrict__ med_data, float* __restrict__ out, int NO,
                          int nd, int iters, int renorm, int recip) {
  extern __shared__ float dyn[];
  float* row = dyn;      // [nd] model row
  float* wc = dyn + nd;  // [NO] this walker's Wcomb
  __shared__ BlockScratch scratch;
  const int b = blockIdx.x;
  for (int o = threadIdx.x; o < NO; o += blockDim.x) wc[o] = Wcomb[(size_t)b * NO + o];
  __syncthreads();
  const float chi = spectrum_block<kNoExp>(wc, av[b], D, NO, nd, kd, data, inv_err, VpinvT, VT,
                                           med_data[0], iters, renorm != 0, recip,
                                           whole_row_stat(nd), row, &scratch);
  if (threadIdx.x == 0) out[b] = chi;
}

template <bool kNoExp>
static int launch_spectrum_recip(const void* Wcomb, const void* av, const void* D,
                                 const void* kd, const void* data, const void* inv_err,
                                 const void* VpinvT, const void* VT, const void* med_data,
                                 void* out, int NW, int NO, int nd, int iters, int recip,
                                 cudaStream_t stream) {
  const size_t smem = (size_t)(nd + NO) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        spectrum_recip_kernel<kNoExp>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  spectrum_recip_kernel<kNoExp><<<NW, kThreads, smem, stream>>>(
      (const float*)Wcomb, (const float*)av, (const float*)D, (const float*)kd,
      (const float*)data, (const float*)inv_err, (const float*)VpinvT, (const float*)VT,
      (const float*)med_data, (float*)out, NO, nd, iters, 1, recip);
  return (int)cudaGetLastError();
}

}  // namespace mcmc_spec

extern "C" int spectrum_recip_launch(const void* Wcomb, const void* av, const void* D,
                                     const void* kd, const void* data, const void* inv_err,
                                     const void* VpinvT, const void* VT, const void* med_data,
                                     void* out, int NW, int NO, int nd, int iters, int recip,
                                     int noexp, void* stream) {
  using namespace mcmc_spec;
  const auto launch = noexp ? launch_spectrum_recip<true> : launch_spectrum_recip<false>;
  return launch(Wcomb, av, D, kd, data, inv_err, VpinvT, VT, med_data, out, NW, NO, nd, iters,
                recip, (cudaStream_t)stream);
}
