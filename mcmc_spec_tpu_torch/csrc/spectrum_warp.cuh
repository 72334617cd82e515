// The spectrum-statistics body (K2) v2 of the spectrum-chi^2 kernel K3
// (spectrum_chi2.cu), the fleet spectrum-chi^2 kernel K4 (spectrum_chi2_fleet.cu)
// and the experiments S14 and S15, redesigned for Hopper: one warp per walker.
// The fused posteriors K1 and K5 run v3 (spectrum_stage.cuh), which keeps this
// body's arithmetic and reads its operands from tiles the block stages, and
// takes step 1 and row_median_warp from here.
//
// Replaces mcmc_spec_tpu/ops/pallas_kernels.py:_spectrum_block (with
// _row_order_stat_bits/_row_median_nonneg and _div) for K1, K3, K4 and K5;
// the one-block-per-walker body of spectrum_block.cuh stays in the
// experiments S4, S5, S6 and S8, which keep their code.
//
// What bounded the block-per-walker body on an H100 (PERF.md): every pass
// ended in a block barrier (14 or 31 median passes of two __syncthreads
// each), one walker's row build, median and tail ran in series on 256
// threads, and the row build walked all NO blend weights per point behind a
// data-dependent branch.  Here a block holds up to 8 walkers, one warp each,
// and a warp never waits for another:
//   1. The warp writes its walker's non-zero weights, with their grid index o
//      in ascending order, into a compact list (a ballot and a popcount per
//      32 weights).  A NaN weight is not zero and stays in the list, as in v1.
//   2. The row build: lane l takes the points j = l, l + 32, ...; for each it
//      loads D[o, j] for up to 8 list entries at once (coalesced, independent
//      loads issued before the FMAs) and accumulates with fmaf in list order.
//      v1 skipped the zero weights too and added the others in ascending o,
//      so the model row is bit for bit v1's row, and so is the median at
//      every dial.  Extinction: libm expf, as v1.
//   3. The median: each bisection pass counts over the warp's row (16-byte
//      shared-memory loads) and reduces with __reduce_add_sync; the exact
//      refinement's count and masked min use the same reduction and
//      shuffles.  The passes are v1's (the 14-pass midpoint, the exact 31).
//   4. The renorm's c0..c2 and the chi^2 are per-lane sums then warp sums:
//      another order than v1's block sums, so K1 and K3 agree with v1 to
//      rounding (the kernel gate), not bit for bit.
// The warps synchronise only with __syncwarp; ptxas reports no barrier.
// What bounds it now: the row build's D reads from L2 (8 rows of nd floats
// per walker at the production weights) and the tail's table reads; the
// median passes sweep shared memory at 16 bytes a lane.
//
// The gates kMatmul, kExtinct and kMedian (template arguments of
// spectrum_warp, build_row_warp and spectrum_tail_warp) switch a section off
// at compile time for the fleet ablation S14 (fleet_sections.cu), each
// replaced by the stub of scripts/trace_fleet_step.py:variant_kernel: the row
// the walker's first weight at every point, no extinction, no median match.
// Their defaults, every section on, are the production body of K1, K3, K4 and
// K5.
#pragma once

#include "spectrum_block.cuh"

namespace mcmc_spec {

constexpr int kWalkersMax = 8;   // walkers (warps) a block at most
constexpr int kBuildChunk = 8;   // list entries whose D loads a lane issues together

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// The dynamic shared memory of one walker (one warp), in floats: the model
// row, `weight_rows` rows of NO blend weights (K1: Wcomb and the nspec scaled
// components; K3: none), and the compact list (NO indices, NO weights).  Each
// part starts on 16 bytes.  ops/cuda_kernels.py:warp_smem_bytes mirrors it.
__host__ __device__ inline int warp_smem_floats(int nd, int NO, int weight_rows) {
  return round4(nd) + round4((weight_rows + 2) * NO);
}

// Step 1: the warp's compact list of the non-zero weights of wc[0..NO) (shared
// or global memory), ascending in o; returns their count, the same in every lane.
__device__ __forceinline__ int compact_weights(const float* wc, int NO, int* lo, float* lw) {
  const int lane = threadIdx.x & 31;
  int n = 0;
  for (int base = 0; base < NO; base += 32) {
    const int o = base + lane;
    const float w = o < NO ? wc[o] : 0.0f;
    const bool keep = o < NO && w != 0.0f;
    const unsigned m = __ballot_sync(0xffffffffu, keep);
    if (keep) {
      const int k = n + __popc(m & ((1u << lane) - 1u));
      lo[k] = o;
      lw[k] = w;
    }
    n += __popc(m);
  }
  __syncwarp();
  return n;
}

// Step 2: row[j] = (sum over the list of w D[o, j]) * 10^(-0.4 av kd[j]).  The
// list is taken kBuildChunk entries at a time; a longer list (a dense blend)
// carries each point's partial sum in the row between chunks, which keeps the
// fmaf chain and its rounding.  kExtinct false: no extinction.
template <bool kExtinct = true>
__device__ __forceinline__ void build_row_warp(const int* lo, const float* lw, int L, float av,
                                               const float* __restrict__ D, int nd,
                                               const float* __restrict__ kd, float* row) {
  const int lane = threadIdx.x & 31;
  const bool extinct = kExtinct && av > 0.0f;
  const float ak = kLn10x04 * av;
  const int nchunk = L > 0 ? (L + kBuildChunk - 1) / kBuildChunk : 1;
  for (int c = 0; c < nchunk; ++c) {
    const int k0 = c * kBuildChunk;
    const int n_on = min(kBuildChunk, L - k0);
    const bool first = c == 0, last = c == nchunk - 1;
    const float* dp[kBuildChunk];
    float wk[kBuildChunk];
#pragma unroll
    for (int i = 0; i < kBuildChunk; ++i) {
      const bool on = i < n_on;
      dp[i] = D + (size_t)(on ? lo[k0 + i] : 0) * nd;
      wk[i] = on ? lw[k0 + i] : 0.0f;
    }
    for (int j = lane; j < nd; j += 32) {
      float v[kBuildChunk];
#pragma unroll
      for (int i = 0; i < kBuildChunk; ++i) v[i] = i < n_on ? __ldg(dp[i] + j) : 0.0f;
      float acc = first ? 0.0f : row[j];
#pragma unroll
      for (int i = 0; i < kBuildChunk; ++i)
        if (i < n_on) acc = fmaf(wk[i], v[i], acc);
      if (last && extinct) acc = acc * expf(ak * kd[j]);
      row[j] = acc;
    }
  }
  __syncwarp();
}

// The count of the warp's row elements whose int32 bit pattern is <= v (each
// lane's share; the caller reduces) and, with kMin, the min of the others.
template <bool kMin>
__device__ __forceinline__ unsigned count_le(const float* row, int nd, int32_t v, float& m) {
  const int lane = threadIdx.x & 31;
  const int n4 = nd >> 2;
  const float4* row4 = reinterpret_cast<const float4*>(row);
  unsigned c = 0;
#pragma unroll 4
  for (int q = lane; q < n4; q += 32) {
    const float4 x = row4[q];
    const float e[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (__float_as_int(e[i]) <= v) ++c;
      else if constexpr (kMin) m = min_nan(m, e[i]);
    }
  }
  for (int j = 4 * n4 + lane; j < nd; j += 32) {
    if (__float_as_int(row[j]) <= v) ++c;
    else if constexpr (kMin) m = min_nan(m, row[j]);
  }
  return c;
}

// Step 3, row_median of spectrum_block.cuh for one warp: `iters` bisection
// passes over the int32 bit pattern for rank r1; below 31 the bracket
// midpoint, at 31 the exact order statistic refined to rank r2 (r2 <= 0: none).
__device__ __forceinline__ float row_median_warp(const float* row, int nd, int r1, int r2,
                                                 int iters) {
  int32_t lo = 0, hi = kF32InfBits;
  float unused = 0.0f;
  for (int it = 0; it < iters; ++it) {
    const int32_t mid = lo + ((hi - lo) >> 1);
    const unsigned c = count_le<false>(row, nd, mid, unused);
    if ((int)__reduce_add_sync(0xffffffffu, c) >= r1) hi = mid;
    else lo = mid + 1;
  }
  if (iters < 31) return __int_as_float(lo + ((hi - lo) >> 1));
  const float x1 = __int_as_float(hi);
  if (r2 <= 0) return x1;
  float m = INFINITY;
  const unsigned c = count_le<true>(row, nd, hi, m);
  const int cnt1 = (int)__reduce_add_sync(0xffffffffu, c);
  const float upper = warp_min(m);
  return 0.5f * (x1 + (cnt1 >= r2 ? x1 : upper));
}

// Step 4 on a built row: the median match, the continuum renorm and the chi^2.
// Every lane returns the chi^2.  kMedian false: the row is not median-matched.
template <bool kMedian = true>
__device__ __forceinline__ float spectrum_tail_warp(const float* row, int nd,
                                                    const float* __restrict__ data,
                                                    const float* __restrict__ inv_err,
                                                    const float* __restrict__ VpinvT,
                                                    const float* __restrict__ VT,
                                                    float med_data, int iters, bool renorm,
                                                    int recip, const SpecStat st) {
  const int lane = threadIdx.x & 31;
  const float alpha =
      kMedian ? med_data / row_median_warp(row, nd, st.r1, st.r2, iters) : 1.0f;

  float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
  if (renorm) {
#pragma unroll 4
    for (int j = lane; j < nd; j += 32) {
      const float frac = div_dial(data[j], row[j] * alpha, recip);
      c0 += frac * VpinvT[j];
      c1 += frac * VpinvT[nd + j];
      c2 += frac * VpinvT[2 * nd + j];
    }
    c0 = warp_sum(c0);
    c1 = warp_sum(c1);
    c2 = warp_sum(c2);
  }
  float acc = 0.0f;
#pragma unroll 4
  for (int j = lane; j < nd; j += 32) {
    const float model = row[j] * alpha;
    float target = data[j];
    if (renorm) {
      const float fitted = c0 * VT[j] + c1 * VT[nd + j] + c2 * VT[2 * nd + j];
      target = div_dial(data[j], fitted, recip);
    }
    const float r = (model - target) * inv_err[j];
    acc += r * r;
  }
  const float tot = warp_sum(acc);
  return st.mean ? tot / (float)nd : tot * st.inv_n;
}

// The row of the S14 stub without the product: w0, the walker's first blend
// weight, at every point, then the extinction unless kExtinct is false.
template <bool kExtinct>
__device__ __forceinline__ void broadcast_row_warp(float w0, float av, int nd,
                                                   const float* __restrict__ kd, float* row) {
  const bool extinct = kExtinct && av > 0.0f;
  const float ak = kLn10x04 * av;
  for (int j = threadIdx.x & 31; j < nd; j += 32) row[j] = extinct ? w0 * expf(ak * kd[j]) : w0;
  __syncwarp();
}

// K2 v2 for the calling warp's walker: wc its NO blend weights, row / lo / lw
// its slice of dynamic shared memory (round4(nd) floats, NO ints, NO floats).
// Every lane returns the chi^2.
template <bool kMatmul = true, bool kExtinct = true, bool kMedian = true>
__device__ inline float spectrum_warp(const float* wc, float av, const float* __restrict__ D,
                                      int NO, int nd, const float* __restrict__ kd,
                                      const float* __restrict__ data,
                                      const float* __restrict__ inv_err,
                                      const float* __restrict__ VpinvT,
                                      const float* __restrict__ VT, float med_data, int iters,
                                      bool renorm, int recip, const SpecStat st, float* row,
                                      int* lo, float* lw) {
  if constexpr (kMatmul) {
    const int L = compact_weights(wc, NO, lo, lw);
    build_row_warp<kExtinct>(lo, lw, L, av, D, nd, kd, row);
  } else {
    broadcast_row_warp<kExtinct>(wc[0], av, nd, kd, row);
  }
  return spectrum_tail_warp<kMedian>(row, nd, data, inv_err, VpinvT, VT, med_data, iters, renorm,
                                     recip, st);
}

}  // namespace mcmc_spec
