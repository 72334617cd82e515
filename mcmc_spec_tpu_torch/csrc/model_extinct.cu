// K6: the extincted model spectra of the segmented large-nd lane,
//   model[w, j] = (Wcomb[w, :] . D[:, j]) * (av[w] > 0 ? exp(-0.4 ln10 av[w] kd[j]) : 1),
// written once to device memory as [NW, nd] float32 (v2).
//
// Replaces mcmc_spec_tpu/ops/spec_segmented.py:model_extinct (body
// _model_extinct_kernel).  Bound: bytes.  1,024 walkers x nd = 65,536 write a
// 268 MB model (0.08 ms at 3.35 TB/s), while a binary walker has at most 8
// non-zero blend weights of the NO = 56 (a triple 12), so the product needs
// few operations.  The design is tiled around the write, not the product:
//   1. A block owns a tile of kTileP = 256 points and stages D[0:rows, tile]
//      in shared memory once (56 KB at NO = 56, four blocks an SM; zeros past
//      nd), then serves every walker of its chunk of kChunkW = 128 walkers
//      from it.  The grid is (point tiles, walker chunks).  Rows past `rows`
//      (the wrapper's spec_segmented.model_tile_rows: what fits a block) are
//      read from device memory where a weight needs them, so any NO works.
//   2. A warp takes one walker at a time, and loads the next walker's first
//      64 weights while it builds this one.  Its compact list of non-zero
//      weights is a ballot over each 32 weights: the set bits, lowest first,
//      are the non-zero weights in ascending o, each broadcast by a shuffle
//      (a NaN weight is not zero and stays in the list, as in
//      spectrum_warp.cuh's compact_weights).  Lane l accumulates the points
//      4l..4l+3 and 128+4l..128+4l+3 of the tile from two 16-byte shared
//      loads per weight, two list entries at a time (their shuffles and loads
//      issued before the FMAs), with fmaf in list order from +0.
//   3. The extinction epilogue is v1's (libm expf), and the row is written
//      with 16-byte streaming stores (__stcs) where the address allows it:
//      the model is read next by K7-K9, but 268 MB does not fit the 50 MB L2.
// What bounds it on an H100 (PERF.md): the write, and beside it each warp's
// chain of work per walker (the weight loads, the list's shuffles and shared
// loads, eight expf), not the few FMAs.
// Bit for bit v1: v1 ran the same fmaf chain over all NO weights, ascending in
// o from +0.  With D finite, fmaf(0, d, acc) is acc exactly (acc is never -0:
// it starts at +0, and an exact zero sum rounds to +0), so leaving out the
// zero weights changes no bit.  This is K1/K3's rule (spectrum_warp.cuh): it
// differs from a dense product only where D holds a non-finite value under a
// zero weight, where the dense product gives NaN.
// Any nd (the tile's ragged end masked; a row that does not start on 16 bytes,
// as every odd row at an odd nd, stores by scalars), any NW (the last chunk
// ragged), any NO, no walker padding.  One block barrier, after the staging.
#include <cstdint>

#include "block_common.cuh"

namespace mcmc_spec {

constexpr int kTileP = 256;   // points a block stages and serves
constexpr int kChunkW = 128;  // walkers a block serves from its tile
constexpr int kTileQ = kTileP / 4;  // float4 columns of the staged tile

// src[j .. j+3], zero past nd: one 16-byte load where aligned and in range
__device__ __forceinline__ float4 load4(const float* __restrict__ src, int j, int nd) {
  if (j + 3 < nd && (reinterpret_cast<uintptr_t>(src + j) & 15) == 0)
    return __ldg(reinterpret_cast<const float4*>(src + j));
  float4 v;
  v.x = j < nd ? __ldg(src + j) : 0.0f;
  v.y = j + 1 < nd ? __ldg(src + j + 1) : 0.0f;
  v.z = j + 2 < nd ? __ldg(src + j + 2) : 0.0f;
  v.w = j + 3 < nd ? __ldg(src + j + 3) : 0.0f;
  return v;
}

// dst[j .. j+3] = v where in range, streaming: one 16-byte store where aligned
__device__ __forceinline__ void store4(float* dst, int j, int nd, float4 v) {
  if (j + 3 < nd && (reinterpret_cast<uintptr_t>(dst + j) & 15) == 0) {
    __stcs(reinterpret_cast<float4*>(dst + j), v);
    return;
  }
  if (j < nd) __stcs(dst + j, v.x);
  if (j + 1 < nd) __stcs(dst + j + 1, v.y);
  if (j + 2 < nd) __stcs(dst + j + 2, v.z);
  if (j + 3 < nd) __stcs(dst + j + 3, v.w);
}

__device__ __forceinline__ void fma4(float w, float4 d, float* acc) {
  acc[0] = fmaf(w, d.x, acc[0]);
  acc[1] = fmaf(w, d.y, acc[1]);
  acc[2] = fmaf(w, d.z, acc[2]);
  acc[3] = fmaf(w, d.w, acc[3]);
}

// The list entries of one ballot chunk of 32 weights, in ascending o: wv is this
// lane's weight of grid point base + lane.  The staged rows two entries at a time,
// then the rows past them (all above the staged ones) one at a time from D.
__device__ __forceinline__ void add_chunk(float wv, int base, int NO, int rows,
                                          const float4* Ds, const float* __restrict__ D,
                                          int nd, int ja, int jb, float* acc) {
  const int lane = threadIdx.x & 31;
  const int o = base + lane;
  const bool keep = o < NO && wv != 0.0f;
  unsigned ms = __ballot_sync(0xffffffffu, keep && o < rows);
  unsigned mg = __ballot_sync(0xffffffffu, keep && o >= rows);
  while (ms) {
    const int s0 = __ffs(ms) - 1;
    ms &= ms - 1;
    const bool two = ms != 0;
    const int s1 = two ? __ffs(ms) - 1 : s0;
    ms &= ms - 1;
    const float w0 = __shfl_sync(0xffffffffu, wv, s0);
    const float w1 = __shfl_sync(0xffffffffu, wv, s1);
    const float4* r0 = Ds + (base + s0) * kTileQ;
    const float4* r1 = Ds + (base + s1) * kTileQ;
    const float4 a0 = r0[lane], b0 = r0[kTileQ / 2 + lane];
    const float4 a1 = r1[lane], b1 = r1[kTileQ / 2 + lane];
    fma4(w0, a0, acc);
    fma4(w0, b0, acc + 4);
    if (two) {
      fma4(w1, a1, acc);
      fma4(w1, b1, acc + 4);
    }
  }
  while (mg) {
    const int src = __ffs(mg) - 1;
    mg &= mg - 1;
    const float wk = __shfl_sync(0xffffffffu, wv, src);
    const float* Dr = D + (size_t)(base + src) * nd;
    fma4(wk, load4(Dr, ja, nd), acc);
    fma4(wk, load4(Dr, jb, nd), acc + 4);
  }
}

__global__ void __launch_bounds__(kThreads, 4)
    model_extinct_kernel(const float* __restrict__ Wcomb, const float* __restrict__ av,
                         const float* __restrict__ D, const float* __restrict__ kd,
                         float* __restrict__ out, int NW, int NO, int nd, int rows) {
  extern __shared__ float4 Ds[];  // [rows][kTileQ]: D[o, j0 + 4q .. j0 + 4q + 3]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j0 = blockIdx.x * kTileP;
  const int ja = j0 + 4 * lane, jb = ja + kTileP / 2;  // the lane's two runs of 4 points
  for (int i = threadIdx.x; i < rows * kTileQ; i += kThreads)
    Ds[i] = load4(D + (size_t)(i / kTileQ) * nd, j0 + 4 * (i % kTileQ), nd);
  const float4 ka = load4(kd, ja, nd), kb = load4(kd, jb, nd);
  __syncthreads();

  const int w0 = (int)blockIdx.y * kChunkW, w_end = min(NW, w0 + kChunkW);
  // the first 64 weights of the warp's next walker, loaded a walker ahead
  float n0 = 0.0f, n1 = 0.0f;
  if (w0 + warp < w_end) {
    const float* wc = Wcomb + (size_t)(w0 + warp) * NO;
    n0 = lane < NO ? __ldg(wc + lane) : 0.0f;
    n1 = lane + 32 < NO ? __ldg(wc + lane + 32) : 0.0f;
  }
  for (int w = w0 + warp; w < w_end; w += kWarps) {
    const float* wc = Wcomb + (size_t)w * NO;
    const float a = __ldg(av + w);
    const float c0 = n0, c1 = n1;
    if (w + kWarps < w_end) {
      const float* wn = wc + (size_t)kWarps * NO;
      n0 = lane < NO ? __ldg(wn + lane) : 0.0f;
      n1 = lane + 32 < NO ? __ldg(wn + lane + 32) : 0.0f;
    }
    float acc[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    add_chunk(c0, 0, NO, rows, Ds, D, nd, ja, jb, acc);
    add_chunk(c1, 32, NO, rows, Ds, D, nd, ja, jb, acc);
    for (int base = 64; base < NO; base += 32)
      add_chunk(base + lane < NO ? __ldg(wc + base + lane) : 0.0f, base, NO, rows, Ds, D, nd,
                ja, jb, acc);
    if (a > 0.0f) {
      const float ak = kLn10x04 * a;
      const float kdv[8] = {ka.x, ka.y, ka.z, ka.w, kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = acc[i] * expf(ak * kdv[i]);
    }
    float* row = out + (size_t)w * nd;
    store4(row, ja, nd, make_float4(acc[0], acc[1], acc[2], acc[3]));
    store4(row, jb, nd, make_float4(acc[4], acc[5], acc[6], acc[7]));
  }
}

}  // namespace mcmc_spec

extern "C" int model_extinct_launch(const void* Wcomb, const void* av, const void* D,
                                    const void* kd, void* out, int NW, int NO, int nd, int rows,
                                    void* stream) {
  using namespace mcmc_spec;
  if (NW < 1 || NO < 1 || nd < 1 || rows < 0 || rows > NO) return (int)cudaErrorInvalidValue;
  const int chunks = (NW + kChunkW - 1) / kChunkW;
  if (chunks > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)rows * kTileP * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        model_extinct_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(model_extinct_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((nd + kTileP - 1) / kTileP, chunks);
  model_extinct_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)Wcomb, (const float*)av, (const float*)D, (const float*)kd, (float*)out, NW,
      NO, nd, rows);
  return (int)cudaGetLastError();
}
