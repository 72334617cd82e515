// S9: the exact row median with an early exit, the receipt for the median's
// pass count (mcmc_spec_tpu_torch/scripts/try_whileloop_median.py).
//
// Replaces scripts/try_whileloop_median.py:run with the body _median_adaptive
// (the body _median_fixed at 31 passes is row_median of spectrum_block.cuh,
// S11 median_only in microbench.cu).  np.median of each non-negative f32 row,
// exact: a bisection over the int32 bit pattern for rank r1 = (nd + 1) / 2
// that, from pass 14 on and every third pass (k >= 14, k % 3 == 2), checks
// whether the bracket [lo, hi] holds one distinct value (the smallest pattern
// >= lo is >= hi) and stops if so; then one repair count (a bracket exhausted
// at 31 passes), and for an even row the upper-middle count and masked min.
//
// Design: one block per row, the row in dynamic shared memory, so each row
// exits on its own; the TPU block waits for all of its 512 rows
// (jnp.all).  The median is exact either way, so the output is the same.
// The check is a block-wide integer min (three barriers with the branch), a
// count pass two.  What bounds it is what bounds S11: the block-wide passes,
// each a shared-memory sweep and its barriers; the exit saves passes, each
// check costs one.  `passes` gets the number of bisection passes of each row.
#include "spectrum_block.cuh"

namespace mcmc_spec {

constexpr int kFirstCheck = 14;  // the JAX body's break-even point
constexpr int kCheckEvery = 3;

__device__ __forceinline__ int32_t block_min_int(int32_t v, BlockScratch* s) {
  v = __reduce_min_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) s->i[threadIdx.x >> 5] = v;
  __syncthreads();
  int32_t t = s->i[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) t = min(t, s->i[w]);
  __syncthreads();
  return t;
}

// min over the row of the patterns >= lo (kF32InfBits where there is none)
__device__ __forceinline__ int32_t min_at_least(const float* row, int nd, int32_t lo,
                                                BlockScratch* s) {
  int32_t m = kF32InfBits;
  for (int j = threadIdx.x; j < nd; j += blockDim.x) {
    const int32_t b = __float_as_int(row[j]);
    if (b >= lo) m = min(m, b);
  }
  return block_min_int(m, s);
}

__global__ void __launch_bounds__(kThreads)
    median_adaptive_kernel(const float* __restrict__ x, float* __restrict__ out,
                           int* __restrict__ passes, int nd) {
  extern __shared__ float row[];
  __shared__ BlockScratch scratch;
  const float* xr = x + (size_t)blockIdx.x * nd;
  for (int j = threadIdx.x; j < nd; j += blockDim.x) row[j] = xr[j];
  __syncthreads();

  const int r1 = (nd + 1) / 2;
  int32_t lo = 0, hi = kF32InfBits;
  int k = 0;
  bool done = false;
  while (k < 31 && !done) {
    bisect_bits(row, nd, r1, 1, lo, hi, &scratch);
    if (k >= kFirstCheck && k % kCheckEvery == kCheckEvery - 1)
      done = min_at_least(row, nd, lo, &scratch) >= hi;
    ++k;
  }
  // a check exit: the smallest pattern >= lo is the order statistic.  An
  // exhausted bracket: it is that pattern if enough values lie at or below it.
  const int32_t vmin = min_at_least(row, nd, lo, &scratch);
  int c = 0;
  for (int j = threadIdx.x; j < nd; j += blockDim.x) c += (__float_as_int(row[j]) <= vmin);
  const int32_t v1 = block_sum_int(c, &scratch) >= r1 ? vmin : hi;
  const float med = refine_upper(row, nd, v1, whole_row_stat(nd).r2, &scratch);
  if (threadIdx.x == 0) {
    out[blockIdx.x] = med;
    passes[blockIdx.x] = k;
  }
}

}  // namespace mcmc_spec

extern "C" int median_adaptive_launch(const void* x, void* out, void* passes, int NW, int nd,
                                      void* stream) {
  using namespace mcmc_spec;
  if (NW < 1 || nd < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)nd * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        median_adaptive_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  median_adaptive_kernel<<<NW, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, (int*)passes, nd);
  return (int)cudaGetLastError();
}
