// Device helpers shared by the spectrum bodies (K2: spectrum_block.cuh, one
// block per walker, in the S-kernels; spectrum_warp.cuh, one warp per walker,
// in K1/K3/K4/K5) and the segmented large-nd kernels
// (model_extinct.cu K6, median_kary.cu K7, segmented_stats.cu K8/K9): the
// block size, NaN-propagating min/max, warp and block reductions, and the
// magic-seed reciprocal of the continuum-renorm divides
// (mcmc_spec_tpu/ops/pallas_kernels.py:_fast_recip/_div).
//
// Arithmetic follows the JAX kernels: libm expf and true division (no
// --use_fast_math), the magic-seed reciprocal in uint32 arithmetic.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mcmc_spec {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kRecipMagic = 0x7EF311C3u;
// Python constants of the JAX package, rounded from double to float exactly
// as a weakly-typed Python float meets an f32 array
constexpr float kLn10x04 = (float)(-0.4 * 2.302585092994046);  // -0.4 ln 10

struct BlockScratch {
  float f[3 * kWarps];
  int i[3 * kWarps];
};

// NaN-propagating min/max, as jnp.minimum/jnp.maximum and torch.clamp
__device__ __forceinline__ float min_nan(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float max_nan(float a, float b) { return (a > b || a != a) ? a : b; }

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

__device__ __forceinline__ void block_sum_int3(int& a, int& b, int& c, BlockScratch* s) {
  a = warp_sum_int(a);
  b = warp_sum_int(b);
  c = warp_sum_int(c);
  if ((threadIdx.x & 31) == 0) {
    const int w = threadIdx.x >> 5;
    s->i[w] = a;
    s->i[kWarps + w] = b;
    s->i[2 * kWarps + w] = c;
  }
  __syncthreads();
  a = b = c = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    a += s->i[w];
    b += s->i[kWarps + w];
    c += s->i[2 * kWarps + w];
  }
  __syncthreads();
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

}  // namespace mcmc_spec
