// S7: the exact row median with 16-bit coarse passes, the receipt for halving
// the words a median pass reads (mcmc_spec_tpu_torch/scripts/try_packed_median.py).
//
// Replaces scripts/try_packed_median.py:run_kernel with the body
// _row_median_nonneg_16.  np.median of each non-negative f32 row, exact: 16
// coarse bisection passes over the high 16 bits of each value's pattern find
// the smallest high half h with count(high <= h) >= r1, which is
// count(bits <= h << 16 | 0xFFFF) >= r1; 16 fine int32 passes inside that
// bucket then land on the order statistic; an even row is refined to the mean
// with the upper middle by a count and a masked min.
//
// Design: one block per row.  The row goes to dynamic shared memory, then a
// packed copy of the high halves, two per 32-bit word (3.5 KB at nd = 1792;
// an odd row's last word is padded with 0x7FFF, above every key).  A coarse
// pass compares both keys of a word at once: with M = (mid | 0x8000) in each
// half, the top bit of each half of M - word is set exactly when that key is
// <= mid, and no half borrows from the other because a non-negative value's
// high half is at most 0x7F80 (0x7FC0 for a NaN); a popcount of the two top
// bits counts them.  The Mosaic workaround of the JAX body (a bf16
// sign-of-difference count) is not carried over: this is the same count in
// integers.  A coarse pass reads half the words of a fine pass but keeps its
// two barriers (block_sum_int), so S7 against S11 at 31 passes says whether
// a pass is set by its shared-memory sweep or by its barriers.
#include "spectrum_block.cuh"

namespace mcmc_spec {

constexpr int kCoarsePasses = 16;
constexpr int kFinePasses = 16;
constexpr int32_t kHighInf = 0x7F80;  // the high half of +inf
constexpr uint32_t kPackPad = 0x7FFFu;

__global__ void __launch_bounds__(kThreads)
    median_packed_kernel(const float* __restrict__ x, float* __restrict__ out, int nd) {
  extern __shared__ float row[];
  const int nwords = (nd + 1) / 2;
  uint32_t* packed = reinterpret_cast<uint32_t*>(row + nd);
  __shared__ BlockScratch scratch;
  const float* xr = x + (size_t)blockIdx.x * nd;
  for (int j = threadIdx.x; j < nd; j += blockDim.x) row[j] = xr[j];
  __syncthreads();
  for (int w = threadIdx.x; w < nwords; w += blockDim.x) {
    const uint32_t a = __float_as_uint(row[2 * w]) >> 16;
    const uint32_t b = 2 * w + 1 < nd ? __float_as_uint(row[2 * w + 1]) >> 16 : kPackPad;
    packed[w] = a | (b << 16);
  }
  __syncthreads();

  const int r1 = (nd + 1) / 2;
  int32_t lo = 0, hi = kHighInf;
  for (int it = 0; it < kCoarsePasses; ++it) {
    const int32_t mid = lo + ((hi - lo) >> 1);
    const uint32_t m = ((uint32_t)mid | 0x8000u) * 0x10001u;
    int c = 0;
    for (int w = threadIdx.x; w < nwords; w += blockDim.x)
      c += __popc((m - packed[w]) & 0x80008000u);
    if (block_sum_int(c, &scratch) >= r1) hi = mid;
    else lo = mid + 1;
  }
  lo = hi << 16;
  hi = (hi << 16) | 0xFFFF;
  bisect_bits(row, nd, r1, kFinePasses, lo, hi, &scratch);
  const float med = refine_upper(row, nd, hi, whole_row_stat(nd).r2, &scratch);
  if (threadIdx.x == 0) out[blockIdx.x] = med;
}

}  // namespace mcmc_spec

extern "C" int median_packed_launch(const void* x, void* out, int NW, int nd, void* stream) {
  using namespace mcmc_spec;
  if (NW < 1 || nd < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)nd * sizeof(float) + (size_t)((nd + 1) / 2) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        median_packed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  median_packed_kernel<<<NW, kThreads, smem, (cudaStream_t)stream>>>((const float*)x,
                                                                      (float*)out, nd);
  return (int)cudaGetLastError();
}
