// K7: the rank median of each non-negative float32 model row of the segmented
// large-nd lane, by a k-ary count search over the int32 bit pattern.
//
// Replaces mcmc_spec_tpu/ops/spec_segmented.py:median_nonneg_xla with its
// search _kary_order_stat_bits (XLA in the JAX package, not Pallas).  The
// candidate interval [lo, lo + 2^shift) starts at [0, 2^31) and each round
// splits it in four with the thresholds lo + k 2^(shift-2) - 1 (k = 1, 2, 3):
// one pass over the row makes the three counts, one block reduction sums them,
// and lo moves by (number of counts below the rank) quarters.  Exact mode
// (iters >= 31 or 0): 15 rounds, the single-bit count at shift 1, then for an
// even n_true the upper middle by one pass that counts the row at or below v1
// and takes the NaN-propagating min above it.  Fast mode (iters < 31): the
// rounds down to shift 31 - 2 ceil(iters / 2), then the bracket midpoint
// lo + 2^(shift-1), without refinement.  The rank r1 = (n_true + 1) / 2 is
// read per row from n_true (stride 0: one count for all rows), so sentinel
// padding above the true points never counts.  The counts are integers, so
// the result is bit-identical to the plain version; it is not K2's bisection
// (row_median, which starts from [0, 0x7F800000]): the exact results agree,
// the fast midpoints do not.
//
// One block per row, streaming the row from device memory in every round.
// Bound: at 1,024 rows x 65,536 the 268 MB model does not fit the 50 MB L2,
// so each of the 16 exact (7 fast) passes reads it from HBM again: >= 1.3 ms
// exact, where reading it once (0.08 ms) and the ~6.4 G compares and counts
// (0.1 ms at 67 TFLOP/s) would allow far less.  Keeping the row on chip, or
// counting the first rounds in K6's epilogue, is later work.
#include "block_common.cuh"

namespace mcmc_spec {

__global__ void __launch_bounds__(kThreads)
    median_kary_kernel(const float* __restrict__ model, const int* __restrict__ n_true,
                       int n_true_stride, float* __restrict__ out, int nd, int iters) {
  __shared__ BlockScratch scratch;
  const int b = blockIdx.x;
  const int32_t* row = reinterpret_cast<const int32_t*>(model) + (size_t)b * nd;
  const int n = n_true[(size_t)b * n_true_stride];
  const int r1 = (n + 1) / 2;
  const bool exact = iters <= 0 || iters >= 31;
  const int stop = exact ? 0 : 31 - 2 * ((iters + 1) / 2);

  int32_t lo = 0;
  int shift = 31;
  while (shift >= 2 && shift > stop) {
    const int32_t q = (int32_t)1 << (shift - 2);
    const int32_t m1 = lo + q - 1, m2 = lo + 2 * q - 1, m3 = lo + 3 * q - 1;
    int c1 = 0, c2 = 0, c3 = 0;
#pragma unroll 4
    for (int j = threadIdx.x; j < nd; j += kThreads) {
      const int32_t v = __ldg(row + j);
      c1 += v <= m1;
      c2 += v <= m2;
      c3 += v <= m3;
    }
    block_sum_int3(c1, c2, c3, &scratch);
    lo += ((c1 < r1) + (c2 < r1) + (c3 < r1)) * q;
    shift -= 2;
  }
  if (!exact) {
    if (threadIdx.x == 0) out[b] = __int_as_float(lo + ((int32_t)1 << (shift - 1)));
    return;
  }
  if (shift == 1) {  // [lo, lo + 1]: is lo itself enough?
    int c = 0;
    for (int j = threadIdx.x; j < nd; j += kThreads) c += __ldg(row + j) <= lo;
    if (block_sum_int(c, &scratch) < r1) ++lo;
  }
  const float x1 = __int_as_float(lo);
  if (n & 1) {
    if (threadIdx.x == 0) out[b] = x1;
    return;
  }
  // upper middle: x1 again if it repeats past rank r1, else the next larger value
  int c = 0;
  float m = INFINITY;
  for (int j = threadIdx.x; j < nd; j += kThreads) {
    const int32_t v = __ldg(row + j);
    if (v <= lo) ++c;
    else m = min_nan(m, __int_as_float(v));
  }
  const int cnt1 = block_sum_int(c, &scratch);
  const float upper = block_min(m, &scratch);
  const float x2 = cnt1 >= r1 + 1 ? x1 : upper;
  if (threadIdx.x == 0) out[b] = 0.5f * (x1 + x2);
}

}  // namespace mcmc_spec

extern "C" int median_kary_launch(const void* model, const void* n_true, void* out,
                                  int n_true_stride, int NW, int nd, int iters, void* stream) {
  using namespace mcmc_spec;
  if (NW < 1 || nd < 1) return (int)cudaErrorInvalidValue;
  median_kary_kernel<<<NW, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)model, (const int*)n_true, n_true_stride, (float*)out, nd, iters);
  return (int)cudaGetLastError();
}
