// The two microbenchmark kernels of the cost-attribution experiments
// (mcmc_spec_tpu_torch/scripts/vpu_microbench.py):
//
// S10 fma_chains replaces scripts/vpu_microbench.py:vpu_ceiling
// (body _mulchains_kernel): kChains = 4 independent multiply chains of length
// k per element (the script's call), then their sum in chain order, the
// achievable FP32 issue rate.  One thread per element; the chains live in
// registers (the loop over them unrolls and the constants fold).  The
// constants c_j = (float)(1.0 + 1e-7 (j+1)) are rounded from double, as the
// JAX script's jnp.float32 constants are.  __fmul_rn/__fadd_rn keep nvcc from
// contracting a chain's last multiply into the summing add (-fmad=true is the
// default), so the bits equal the plain version's.  Bound: at k = 24 the
// 470 MB of input and output (0.14 ms at 3.35 TB/s) and the 5.9 G
// multiplies (0.18 ms at one multiply per FP32 lane per clock) are too close
// to read a ceiling; a larger k makes it issue-bound.
//
// S11 median_only replaces vpu_microbench.py:median_only (body _median_kernel
// = pallas_kernels._row_median_nonneg): the row median alone.  One block per
// row; the row goes to dynamic shared memory and through row_median of
// spectrum_block.cuh with whole_row_stat(nd), the code K1/K3 run.  Bound: the
// block-wide count passes, each a shared-memory sweep and the two barriers of
// block_sum_int.
#include "spectrum_block.cuh"

namespace mcmc_spec {

constexpr int kChains = 4;

__global__ void __launch_bounds__(kThreads)
    fma_chains_kernel(const float* __restrict__ x, float* __restrict__ out, size_t n, int k) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float xi = x[i];
  float c[kChains], y[kChains];
#pragma unroll
  for (int j = 0; j < kChains; ++j) {
    c[j] = (float)(1.0 + 1e-7 * (j + 1));
    y[j] = __fmul_rn(xi, c[j]);
  }
  for (int it = 1; it < k; ++it) {
#pragma unroll
    for (int j = 0; j < kChains; ++j) y[j] = __fmul_rn(y[j], c[j]);
  }
  float acc = y[0];
#pragma unroll
  for (int j = 1; j < kChains; ++j) acc = __fadd_rn(acc, y[j]);
  out[i] = acc;
}

__global__ void __launch_bounds__(kThreads)
    median_only_kernel(const float* __restrict__ x, float* __restrict__ out, int nd, int iters) {
  extern __shared__ float row[];
  __shared__ BlockScratch scratch;
  const float* xr = x + (size_t)blockIdx.x * nd;
  for (int j = threadIdx.x; j < nd; j += blockDim.x) row[j] = xr[j];
  __syncthreads();
  const SpecStat st = whole_row_stat(nd);
  const float med = row_median(row, nd, st.r1, st.r2, iters, &scratch);
  if (threadIdx.x == 0) out[blockIdx.x] = med;
}

}  // namespace mcmc_spec

extern "C" int fma_chains_launch(const void* x, void* out, long long n, int k, void* stream) {
  using namespace mcmc_spec;
  if (n <= 0 || k < 1) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
  fma_chains_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>((const float*)x, (float*)out,
                                                                  (size_t)n, k);
  return (int)cudaGetLastError();
}

extern "C" int median_only_launch(const void* x, void* out, int NW, int nd, int iters,
                                  void* stream) {
  using namespace mcmc_spec;
  const size_t smem = (size_t)nd * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        median_only_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  median_only_kernel<<<NW, kThreads, smem, (cudaStream_t)stream>>>((const float*)x, (float*)out,
                                                                    nd, iters);
  return (int)cudaGetLastError();
}
