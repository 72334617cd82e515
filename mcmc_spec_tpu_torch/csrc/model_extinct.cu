// K6: the extincted model spectra of the segmented large-nd lane,
//   model[w, j] = (Wcomb[w, :] . D[:, j]) * (av[w] > 0 ? exp(-0.4 ln10 av[w] kd[j]) : 1),
// written once to device memory as [NW, nd] float32.
//
// Replaces mcmc_spec_tpu/ops/spec_segmented.py:model_extinct (body
// _model_extinct_kernel).  A 2-D grid over (nd tile, walker tile): a block
// computes a [kTileW = 64 walkers, kTileN = 128 points] tile of the output,
// staging [kTileW, kTileK] of the weights and [kTileK, kTileN] of D in shared
// memory, kTileK = 32 rows of the NO = nT * nG contraction at a time.  Each of
// the 256 threads owns 8 walkers x 4 points: walkers ty + 8 r (ty = its warp,
// so the weight reads are one broadcast per warp) and points tx + 32 c (tx =
// its lane, so the D reads and the output writes are 128-byte rows).  Every
// edge is masked: any nd, any NW, any NO, with no walker padding, where the
// JAX version needs a power-of-two tile dividing nd and falls back to XLA
// otherwise (_pick_nd_block).  The product is the f32 FMA chain over o in
// order, whatever the matmul-passes dial (no split-bf16 emulation, no tensor
// cores); the extinction epilogue is the one of spectrum_block.cuh.
//
// Bound: bytes, nearly.  1,024 walkers x nd = 65,536 write a 268 MB model
// (0.08 ms at 3.35 TB/s) for 7.5 GFLOP of FMAs over all 56 weights (0.11 ms at
// 67 TFLOP/s; far fewer counting only the non-zero weights).  This simple
// version issues one shared-memory load per 2.7 FMAs; cp.async/TMA staging and
// counting the first median rounds in this epilogue are later work.
#include "block_common.cuh"

namespace mcmc_spec {

constexpr int kTileW = 64;
constexpr int kTileN = 128;
constexpr int kTileK = 32;
constexpr int kRowsPerThread = kTileW / kWarps;  // 8 walkers
constexpr int kColsPerThread = kTileN / 32;      // 4 points

__global__ void __launch_bounds__(kThreads)
    model_extinct_kernel(const float* __restrict__ Wcomb, const float* __restrict__ av,
                         const float* __restrict__ D, const float* __restrict__ kd,
                         float* __restrict__ out, int NW, int NO, int nd) {
  // Ws is [k][w], padded so that the transposing store is free of bank conflicts
  __shared__ float Ws[kTileK][kTileW + 1];
  __shared__ float Ds[kTileK][kTileN];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int j0 = blockIdx.x * kTileN, w0 = blockIdx.y * kTileW;

  float acc[kRowsPerThread][kColsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) acc[r][c] = 0.0f;

  for (int k0 = 0; k0 < NO; k0 += kTileK) {
    for (int i = threadIdx.x; i < kTileK * kTileW; i += kThreads) {
      const int kk = i % kTileK, ww = i / kTileK;
      const int w = w0 + ww, o = k0 + kk;
      Ws[kk][ww] = (w < NW && o < NO) ? Wcomb[(size_t)w * NO + o] : 0.0f;
    }
    for (int i = threadIdx.x; i < kTileK * kTileN; i += kThreads) {
      const int kk = i / kTileN, jj = i % kTileN;
      const int o = k0 + kk, j = j0 + jj;
      Ds[kk][jj] = (o < NO && j < nd) ? __ldg(D + (size_t)o * nd + j) : 0.0f;
    }
    __syncthreads();
    const int kmax = min(kTileK, NO - k0);
    for (int k = 0; k < kmax; ++k) {
      float a[kRowsPerThread], b[kColsPerThread];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) a[r] = Ws[k][ty + kWarps * r];
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) b[c] = Ds[k][tx + 32 * c];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
    __syncthreads();
  }

  float kdj[kColsPerThread];
#pragma unroll
  for (int c = 0; c < kColsPerThread; ++c) {
    const int j = j0 + tx + 32 * c;
    kdj[c] = j < nd ? kd[j] : 0.0f;
  }
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int w = w0 + ty + kWarps * r;
    if (w >= NW) continue;
    const float a = av[w];
    const bool extinct = a > 0.0f;
    const float ak = kLn10x04 * a;
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      const int j = j0 + tx + 32 * c;
      if (j < nd) out[(size_t)w * nd + j] = extinct ? acc[r][c] * expf(ak * kdj[c]) : acc[r][c];
    }
  }
}

}  // namespace mcmc_spec

extern "C" int model_extinct_launch(const void* Wcomb, const void* av, const void* D,
                                    const void* kd, void* out, int NW, int NO, int nd,
                                    void* stream) {
  using namespace mcmc_spec;
  if (NW < 1 || NO < 1 || nd < 1) return (int)cudaErrorInvalidValue;
  const int tiles_w = (NW + kTileW - 1) / kTileW;
  if (tiles_w > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((nd + kTileN - 1) / kTileN, tiles_w);
  model_extinct_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)Wcomb, (const float*)av, (const float*)D, (const float*)kd, (float*)out, NW,
      NO, nd);
  return (int)cudaGetLastError();
}
