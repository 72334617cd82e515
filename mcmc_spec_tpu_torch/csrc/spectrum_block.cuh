// Device helpers and the shared spectrum-statistics body (K2) of the fused
// posterior (log_posterior_fused.cu, K1), spectrum-chi^2 (spectrum_chi2.cu,
// K3), fleet spectrum-chi^2 (spectrum_chi2_fleet.cu, K4) and fused fleet
// posterior (log_posterior_fleet_fused.cu, K5) kernels.
//
// Replaces mcmc_spec_tpu/ops/pallas_kernels.py:_spectrum_block (with its
// helpers _row_order_stat_bits/_row_median_nonneg, _fast_recip/_div and
// _dot_f32) and the spectrum part of _spectrum_chi2_fleet_kernel and
// _fleet_posterior_kernel.  The two differ in their statistics (SpecStat):
// K1/K3 take the median of the whole row and the mean chi^2; K4/K5 take the
// median at per-target ranks (r1, r2) of the true points and chi^2 =
// sum * (1/n_true), so a padded target's sentinel points, which sit above
// every real model value and carry inv_err = 0, change nothing.  Design: one
// thread block per walker.  The walker's model row
// (nd floats, 7 KB at nd = 1792) is built in dynamic shared memory; each
// radix-median pass and the renorm/chi^2 passes re-read it from there.  The
// grid projection D [NO, nd] (401 KB at the koi2298 shape) does not fit in a
// block's shared memory: it is read from global memory, where the blocks in
// flight keep it L2-resident.  Only the rows with a non-zero blend weight are
// read (at most 4 per component), which is exact for the finite D of an
// unpadded target, and keeps the 1e30 sentinel columns of a padded D out of
// any zero-weight product.  What bounds a block, as measured on an H100 (PERF.md):
// first the model-row build, whose few D loads per element sit behind a
// data-dependent branch and are issued one after another; then the block-wide
// count passes of the median (a shared-memory sweep plus a two-barrier
// reduction each, 31 exact or 14 at the production dial).
//
// Arithmetic follows the JAX kernel: full f32 FMA for the model product (the
// split-bf16 _dot_f32 was a Mosaic workaround; every MCMC_SPEC_MATMUL_PASSES
// value computes the f32 product here), libm expf/logf and true division
// (no --use_fast_math), the magic-seed reciprocal in uint32 arithmetic.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mcmc_spec {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int32_t kF32InfBits = 0x7F800000;
constexpr unsigned kRecipMagic = 0x7EF311C3u;
// Python constants of the JAX package, rounded from double to float exactly
// as a weakly-typed Python float meets an f32 array
constexpr float kLn10x04 = (float)(-0.4 * 2.302585092994046);  // -0.4 ln 10
constexpr float kMagPerLn = (float)(-2.5 / 2.302585092994046);  // -2.5 / ln 10

struct BlockScratch {
  float f[3 * kWarps];
  int i[kWarps];
};

// NaN-propagating min/max, as jnp.minimum/jnp.maximum and torch.clamp
__device__ __forceinline__ float min_nan(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float max_nan(float a, float b) { return (a > b || a != a) ? a : b; }
__device__ __forceinline__ float clip01(float x) { return min_nan(max_nan(x, 0.0f), 1.0f); }
__device__ __forceinline__ float sq(float x) { return x * x; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min_nan(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide reductions: every thread of the block must call them; every
// thread gets the total.  The trailing barrier lets the scratch be reused.
__device__ __forceinline__ int block_sum_int(int v, BlockScratch* s) {
  v = warp_sum_int(v);
  if ((threadIdx.x & 31) == 0) s->i[threadIdx.x >> 5] = v;
  __syncthreads();
  int t = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += s->i[w];
  __syncthreads();
  return t;
}

__device__ __forceinline__ float block_sum(float v, BlockScratch* s) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) s->f[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += s->f[w];
  __syncthreads();
  return t;
}

__device__ __forceinline__ float block_min(float v, BlockScratch* s) {
  v = warp_min(v);
  if ((threadIdx.x & 31) == 0) s->f[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t = min_nan(t, s->f[w]);
  __syncthreads();
  return t;
}

__device__ __forceinline__ void block_sum3(float& a, float& b, float& c, BlockScratch* s) {
  a = warp_sum(a);
  b = warp_sum(b);
  c = warp_sum(c);
  if ((threadIdx.x & 31) == 0) {
    const int w = threadIdx.x >> 5;
    s->f[w] = a;
    s->f[kWarps + w] = b;
    s->f[2 * kWarps + w] = c;
  }
  __syncthreads();
  a = b = c = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    a += s->f[w];
    b += s->f[kWarps + w];
    c += s->f[2 * kWarps + w];
  }
  __syncthreads();
}

// _fast_recip: integer-magic seed + Newton steps.  The seed is computed in
// uint32 arithmetic (signed overflow is undefined in C++; the JAX version
// relies on the two's-complement wrap, which uint32 gives, so negative x keeps
// its sign).  The _rn intrinsics keep nvcc from contracting the Newton step
// into an FMA, so the bits follow the JAX and torch versions.
__device__ __forceinline__ float fast_recip(float x, int newton) {
  float r = __uint_as_float(kRecipMagic - __float_as_uint(x));
  for (int k = 0; k < newton; ++k) r = __fmul_rn(r, __fsub_rn(2.0f, __fmul_rn(x, r)));
  return r;
}

// _div: exact division (recip = 0) or num * fast_recip(den)
__device__ __forceinline__ float div_dial(float num, float den, int recip) {
  return recip == 0 ? num / den : __fmul_rn(num, fast_recip(den, recip));
}

// The statistics of the spectrum block: the median's 1-based ranks and the
// chi^2 reduction.  r2 = 0 skips the upper-middle refinement (K1/K3 on an odd
// row return the lower middle itself, as np.median); K4/K5 always refine,
// and for an odd n_true (r2 == r1) return 0.5 * (x1 + x1) as their JAX
// kernels do.
struct SpecStat {
  int r1, r2;
  bool mean;    // chi^2 = sum / nd (K1, K3); otherwise sum * inv_n (K4, K5)
  float inv_n;
};

// K1/K3: np.median of the whole row and the mean chi^2
__device__ __forceinline__ SpecStat whole_row_stat(int nd) {
  const int r1 = (nd + 1) / 2;
  return SpecStat{r1, (nd & 1) ? 0 : r1 + 1, true, 0.0f};
}

// _row_order_stat_bits + the median refinement for one row in shared memory:
// `iters` bisection passes over the int32 bit pattern for rank r1, each a
// block-wide count of bits <= mid.  Below 31 passes the bracket midpoint is
// returned; at 31 the exact order statistic, refined to rank r2 by a count
// and a masked min.
__device__ inline float row_median(const float* row, int nd, int r1, int r2, int iters,
                                   BlockScratch* s) {
  int32_t lo = 0, hi = kF32InfBits;
  for (int it = 0; it < iters; ++it) {
    const int32_t mid = lo + ((hi - lo) >> 1);
    int c = 0;
    for (int j = threadIdx.x; j < nd; j += blockDim.x) c += (__float_as_int(row[j]) <= mid);
    if (block_sum_int(c, s) >= r1) hi = mid;
    else lo = mid + 1;
  }
  if (iters < 31) return __int_as_float(lo + ((hi - lo) >> 1));
  const float x1 = __int_as_float(hi);
  if (r2 <= 0) return x1;
  int c = 0;
  float m = INFINITY;
  for (int j = threadIdx.x; j < nd; j += blockDim.x) {
    const int32_t bits = __float_as_int(row[j]);
    if (bits <= hi) ++c;
    else m = min_nan(m, row[j]);
  }
  const int cnt1 = block_sum_int(c, s);
  const float upper = block_min(m, s);
  const float x2 = cnt1 >= r2 ? x1 : upper;
  return 0.5f * (x1 + x2);
}

// K2 (_spectrum_block) for one walker; block-wide, every thread returns the
// chi^2.  wc: the walker's blend weights [NO] in shared memory; row: nd
// floats of dynamic shared memory.
__device__ inline float spectrum_block(const float* wc, float av, const float* __restrict__ D,
                                       int NO, int nd, const float* __restrict__ kd,
                                       const float* __restrict__ data,
                                       const float* __restrict__ inv_err,
                                       const float* __restrict__ VpinvT,
                                       const float* __restrict__ VT, float med_data, int iters,
                                       bool renorm, int recip, const SpecStat st, float* row,
                                       BlockScratch* s) {
  const bool extinct = av > 0.0f;
  const float ak = kLn10x04 * av;
  for (int j = threadIdx.x; j < nd; j += blockDim.x) {
    float acc = 0.0f;
    for (int o = 0; o < NO; ++o) {
      const float w = wc[o];
      if (w != 0.0f) acc = fmaf(w, __ldg(D + (size_t)o * nd + j), acc);
    }
    row[j] = extinct ? acc * expf(ak * kd[j]) : acc;
  }
  __syncthreads();

  const float alpha = med_data / row_median(row, nd, st.r1, st.r2, iters, s);

  float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
  if (renorm) {
    for (int j = threadIdx.x; j < nd; j += blockDim.x) {
      const float frac = div_dial(data[j], row[j] * alpha, recip);
      c0 += frac * VpinvT[j];
      c1 += frac * VpinvT[nd + j];
      c2 += frac * VpinvT[2 * nd + j];
    }
    block_sum3(c0, c1, c2, s);
  }
  float acc = 0.0f;
  for (int j = threadIdx.x; j < nd; j += blockDim.x) {
    const float model = row[j] * alpha;
    float target = data[j];
    if (renorm) {
      const float fitted = c0 * VT[j] + c1 * VT[nd + j] + c2 * VT[2 * nd + j];
      target = div_dial(data[j], fitted, recip);
    }
    const float r = (model - target) * inv_err[j];  // padded points: * 0 -> 0
    acc += r * r;
  }
  const float tot = block_sum(acc, s);
  return st.mean ? tot / (float)nd : tot * st.inv_n;
}

}  // namespace mcmc_spec
