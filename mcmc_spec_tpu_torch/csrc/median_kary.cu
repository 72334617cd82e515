// K7: the rank median of each non-negative float32 model row of the segmented
// large-nd lane, by a histogram select over the int32 bit pattern (v2).
//
// Replaces mcmc_spec_tpu/ops/spec_segmented.py:median_nonneg_xla with its
// search _kary_order_stat_bits (XLA in the JAX package, not Pallas).  The JAX
// search keeps a candidate interval [lo, lo + 2^shift), aligned (the low
// shift bits of lo are zero), that starts at [0, 2^31) and holds the order
// statistic v* = the smallest v with count(mi <= v) >= r1 (or 2^31 - 1 when
// no v has it); each round takes the first quarter whose upper end reaches
// the rank, or the last.  After R rounds lo is therefore v* with its low
// 31 - 2R bits cleared, and v*'s top 2R bits are the first bin of a histogram
// over u >> (31 - 2R) at which the running count reaches r1 (the last bin if
// none does).  The counts are integers, so this select gives the k-ary
// result bit for bit:
//   * fast mode (0 < iters < 31, 2R = 2 ceil(iters / 2) bits): one level of
//     2R bits when 2R <= 14 (one pass over the row; the production dial 14
//     is 2^14 bins, 64 KB of shared memory), else two levels of R bits each
//     (two passes), then the bracket midpoint lo + 2^(30 - 2R);
//   * exact mode (iters <= 0 or >= 31): three levels of 11, 10 and 10 bits
//     (three passes; the k-ary search made 17), each histogramming only the
//     elements whose top bits match the bins chosen so far.  For an even
//     n_true the upper middle comes from the last level: count(mi <= v1) is
//     the count below its bin plus the bin's own, and the smallest element
//     above v1 is the next non-empty bin of the last level or, failing that,
//     the NaN-propagating min of the elements whose 21-bit prefix lies above
//     v1's, which the last pass tracks as it goes.
// A negative pattern (-0.0, a negative NaN) counts below every k-ary
// threshold; here it counts in bin 0 at every level (u = max(v, 0)).  A
// positive NaN pattern lies above +inf, as in the k-ary search.  The rank r1
// = (n_true + 1) / 2 is read per row from n_true (stride 0: one count for all
// rows), so sentinel padding above the true points never counts.
//
// One block of 512 threads per row, three blocks an SM (the 64 KB histogram
// of the production dial).  A warp adds to the shared histogram with one
// atomic for all lanes whose bin is the first active lane's (a constant row
// costs one atomic per warp and element slot) and one per lane otherwise.
// The rank's bin is found by per-warp sums of contiguous chunks, then one
// warp's scan of its chunk.  Rows are read as 16-byte loads (a scalar head
// and tail where the row does not start on 16 bytes or its length is not a
// multiple of 4), four loads in flight per thread.
// Bound: reading the model once.  At 1,024 rows x 65,536 the 268 MB model
// does not fit the 50 MB L2, so each pass is a trip to HBM: 0.080 ms a pass
// at 3.35 TB/s, one pass in fast mode at iters <= 14, three in exact mode.
#include "block_common.cuh"

namespace mcmc_spec {

constexpr int kSelThreads = 512;
constexpr int kSelWarps = kSelThreads / 32;
constexpr int kSelBatch = 4;  // 16-byte loads in flight per thread

// The levels of the select for a median dial: their count and bit widths.
struct SelectPlan {
  int levels;
  int bits[3];
  bool exact;
};

__host__ __device__ inline SelectPlan select_plan(int iters) {
  if (iters <= 0 || iters >= 31) return SelectPlan{3, {11, 10, 10}, true};
  const int b = 2 * ((iters + 1) / 2);  // the bits 2R that the k-ary rounds resolve
  if (b <= 14) return SelectPlan{1, {b, 0, 0}, false};
  return SelectPlan{2, {b / 2, b / 2, 0}, false};
}

__host__ __device__ inline int select_max_bits(const SelectPlan& p) {
  int m = p.bits[0];
  for (int l = 1; l < p.levels; ++l) m = p.bits[l] > m ? p.bits[l] : m;
  return m;
}

// One level of the select: the elements whose top `consumed` bits equal
// `prefix` go to bin (u >> shift) & (2^bits - 1); with kTrack the lane also
// takes the NaN-propagating min of the elements whose prefix lies above.
struct Level {
  uint32_t prefix;
  int hi_shift;  // 31 - consumed
  int shift;     // 31 - consumed - bits
  uint32_t mask;
};

// The warp adds the bins of its `in` lanes: one atomic for the lanes that
// share the first active lane's bin, one per lane for the others.  Every lane
// of the warp calls it.
__device__ __forceinline__ void warp_hist_add(int* hist, int bin, bool in) {
  const unsigned act = __ballot_sync(0xffffffffu, in);
  if (act == 0u) return;
  const int first = __ffs(act) - 1;
  const int b0 = __shfl_sync(0xffffffffu, bin, first);
  const unsigned same = __ballot_sync(0xffffffffu, in && bin == b0);
  if (!in) return;
  if (bin != b0) atomicAdd(hist + bin, 1);
  else if ((threadIdx.x & 31) == first) atomicAdd(hist + b0, __popc(same));
}

template <bool kTrack>
__device__ __forceinline__ void consume(int32_t v, bool on, const Level& L, int* hist, float& m) {
  const uint32_t u = v < 0 ? 0u : (uint32_t)v;
  const uint32_t hi = u >> L.hi_shift;  // hi_shift <= 31
  if constexpr (kTrack) {
    if (on && hi > L.prefix) m = min_nan(m, __int_as_float(v));
  }
  warp_hist_add(hist, (int)((u >> L.shift) & L.mask), on && hi == L.prefix);
}

// One pass over the row.  The warp-uniform loops keep every lane in the
// warp-wide votes of warp_hist_add.
template <bool kTrack>
__device__ __forceinline__ float hist_pass(const int32_t* __restrict__ row, int nd, int head,
                                           int n4, const Level& L, int* hist) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float m = INFINITY;
  const int4* body = reinterpret_cast<const int4*>(row + head);
  for (int base = warp * 32; base < n4; base += kSelThreads * kSelBatch) {
    int4 x[kSelBatch];
#pragma unroll
    for (int k = 0; k < kSelBatch; ++k) {
      const int q = base + k * kSelThreads + lane;
      x[k] = q < n4 ? __ldg(body + q) : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int k = 0; k < kSelBatch; ++k) {
      const bool on = base + k * kSelThreads + lane < n4;
      consume<kTrack>(x[k].x, on, L, hist, m);
      consume<kTrack>(x[k].y, on, L, hist, m);
      consume<kTrack>(x[k].z, on, L, hist, m);
      consume<kTrack>(x[k].w, on, L, hist, m);
    }
  }
  if (warp == 0) {  // the scalar head (< 4 elements) and tail (< 4)
    const int tail0 = head + 4 * n4;
    const int j = lane < head ? lane : tail0 + lane - head;
    const bool on = lane < head || (lane - head < 4 && j < nd);
    consume<kTrack>(on ? __ldg(row + j) : 0, on, L, hist, m);
  }
  return m;
}

// The first bin b of hist[0, nb) at which base + (the count of bins 0..b)
// reaches r, or the last bin where none does; .x = b, .y = base + the count
// of bins 0..b-1.  Block-wide: every thread calls it and gets the result.
__device__ int2 select_bin(const int* hist, int nb, int base, int r, int* s_tot, int* s_res) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cs = max(32, ((nb + kSelWarps - 1) / kSelWarps + 31) & ~31);
  const int start = warp * cs, stop = min(start + cs, nb);
  int acc = 0;
  for (int i = start + lane; i < stop; i += 32) acc += hist[i];
  acc = (int)__reduce_add_sync(0xffffffffu, (unsigned)acc);
  if (lane == 0) s_tot[warp] = acc;
  __syncthreads();
  int pre = base, owner = -1;
  for (int w = 0; w < kSelWarps; ++w) {
    if (owner >= 0) break;
    if (pre + s_tot[w] >= r) owner = w;
    else pre += s_tot[w];
  }
  if (owner < 0) {  // the rank lies past every bin: the last one
    const int last = hist[nb - 1];
    __syncthreads();  // s_tot is reused by the next level
    return make_int2(nb - 1, pre - last);
  }
  if (warp == owner) {
    int p = pre;
    for (int g = start; g < stop; g += 32) {
      const int i = g + lane;
      const int v = i < nb ? hist[i] : 0;
      int incl = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
      }
      const unsigned hit = __ballot_sync(0xffffffffu, p + incl >= r);
      if (hit) {
        if (lane == __ffs(hit) - 1) {
          s_res[0] = i;
          s_res[1] = p + incl - v;
        }
        break;
      }
      p += __shfl_sync(0xffffffffu, incl, 31);
    }
  }
  __syncthreads();
  const int2 res = make_int2(s_res[0], s_res[1]);
  __syncthreads();  // s_res and s_tot are reused by the next level
  return res;
}

__global__ void __launch_bounds__(kSelThreads, 3)
    median_kary_kernel(const float* __restrict__ model, const int* __restrict__ n_true,
                         int n_true_stride, float* __restrict__ out, int nd, int iters) {
  extern __shared__ __align__(16) int hist[];
  __shared__ int s_tot[kSelWarps];
  __shared__ int s_res[2];
  __shared__ float s_min[kSelWarps];
  __shared__ int s_next;
  const int b = blockIdx.x;
  const int32_t* row = reinterpret_cast<const int32_t*>(model) + (size_t)b * nd;
  const int n = n_true[(size_t)b * n_true_stride];
  const int r1 = (n + 1) / 2;
  const SelectPlan plan = select_plan(iters);
  const int head = min(nd, (int)(((16u - ((uint32_t)(uintptr_t)row & 15u)) & 15u) >> 2));
  const int n4 = (nd - head) >> 2;

  uint32_t prefix = 0;
  int consumed = 0, below = 0, bin = 0, nb = 1;
  float m = INFINITY;
  for (int lev = 0; lev < plan.levels; ++lev) {
    const int bits = plan.bits[lev];
    nb = 1 << bits;
    for (int i = threadIdx.x; i < nb; i += kSelThreads) hist[i] = 0;
    __syncthreads();
    const Level L{prefix, 31 - consumed, 31 - consumed - bits, (uint32_t)nb - 1u};
    if (plan.exact && lev == plan.levels - 1) m = hist_pass<true>(row, nd, head, n4, L, hist);
    else hist_pass<false>(row, nd, head, n4, L, hist);
    __syncthreads();
    const int2 sel = select_bin(hist, nb, below, r1, s_tot, s_res);
    bin = sel.x;
    below = sel.y;
    prefix = (prefix << bits) | (uint32_t)bin;
    consumed += bits;
  }
  if (!plan.exact) {
    const int shift = 31 - consumed;
    if (threadIdx.x == 0)
      out[b] = __int_as_float((int32_t)((prefix << shift) + (1u << (shift - 1))));
    return;
  }
  const float x1 = __int_as_float((int32_t)prefix);
  if (n & 1) {
    if (threadIdx.x == 0) out[b] = x1;
    return;
  }
  // upper middle: x1 again if it repeats past rank r1, else the next larger value
  m = warp_min(m);
  if ((threadIdx.x & 31) == 0) s_min[threadIdx.x >> 5] = m;
  if (threadIdx.x == 0) s_next = nb;
  __syncthreads();
  for (int i = bin + 1 + threadIdx.x; i < nb; i += kSelThreads)
    if (hist[i] > 0) atomicMin(&s_next, i);
  __syncthreads();
  if (threadIdx.x != 0) return;
  const int cnt1 = below + hist[bin];
  float upper = INFINITY;
  for (int w = 0; w < kSelWarps; ++w) upper = min_nan(upper, s_min[w]);
  if (s_next < nb)
    upper = min_nan(__int_as_float((int32_t)((prefix & ~(uint32_t)(nb - 1)) | (uint32_t)s_next)),
                    upper);
  const float x2 = cnt1 >= r1 + 1 ? x1 : upper;
  out[b] = 0.5f * (x1 + x2);
}

}  // namespace mcmc_spec

extern "C" int median_kary_launch(const void* model, const void* n_true, void* out,
                                  int n_true_stride, int NW, int nd, int iters, void* stream) {
  using namespace mcmc_spec;
  if (NW < 1 || nd < 1) return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(int) << select_max_bits(select_plan(iters));
  static int smem_set = 48 * 1024;  // the most dynamic shared memory opted into so far
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        median_kary_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  median_kary_kernel<<<NW, kSelThreads, smem, (cudaStream_t)stream>>>(
      (const float*)model, (const int*)n_true, n_true_stride, (float*)out, nd, iters);
  return (int)cudaGetLastError();
}
