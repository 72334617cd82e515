// S5: the spectrum block in four program orders, the receipt for the model-row
// build's cost in context and for overlapping one walker's row build with
// another's median and tail (mcmc_spec_tpu_torch/scripts/try_mxu_overlap.py).
//
// Replaces scripts/try_mxu_overlap.py:run (body _kernel, _vpu_tail): K2 with
// renorm on, the median at `iters` midpoint passes and the renorm divides on
// the reciprocal dial (16 and 2 in the experiment), in one of four modes:
//
//   baseline  one walker per block: build the row, then the tail
//             (spectrum_block, the code of S4 spectrum_recip.cu; renorm stays
//             a launch argument, as there, so that the two compile alike);
//   nomxu     the row is wc[0] * D[0, :] (wrong numbers on purpose): the
//             tail on a row that costs one multiply per point, which prices
//             the row build in context (baseline - nomxu);
//   stagger2  two walkers per block: both rows built, then both tails;
//   stagger4  four walkers per block: row k+1 built before the tail of row
//             k (software-pipeline order).
//
// The TPU question was whether the MXU's matmul overlaps the VPU's median;
// on Hopper the row build is FP32 FMAs over the non-zero weights with its D
// loads from L2, and the question becomes whether a block with the next row's
// loads in flight hides them better than the other blocks of the SM already
// do.  Rows live in dynamic shared memory, 7 KB each at nd = 1792, 28 KB for
// stagger4; stagger2/4 run two and four times fewer blocks of the same 256
// threads.  The tail is spectrum_tail in every mode, so stagger2/4 must equal
// baseline bit for bit.  Bound: as K3 (spectrum_block.cuh).
#include "spectrum_block.cuh"

namespace mcmc_spec {

enum OverlapMode : int { kBaseline = 0, kNoMxu = 1, kStagger2 = 2, kStagger4 = 3 };

template <int kMode>
__host__ __device__ constexpr int walkers_per_block() {
  return kMode == kStagger2 ? 2 : kMode == kStagger4 ? 4 : 1;
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
    spectrum_overlap_kernel(const float* __restrict__ Wcomb, const float* __restrict__ av,
                            const float* __restrict__ D, const float* __restrict__ kd,
                            const float* __restrict__ data, const float* __restrict__ inv_err,
                            const float* __restrict__ VpinvT, const float* __restrict__ VT,
                            const float* __restrict__ med_data, float* __restrict__ out, int NW,
                            int NO, int nd, int iters, int renorm, int recip) {
  constexpr int G = walkers_per_block<kMode>();
  extern __shared__ float dyn[];
  float* rows = dyn;           // [G, nd] model rows
  float* wc = dyn + G * nd;    // [G, NO] the walkers' Wcomb
  __shared__ BlockScratch scratch;
  const int b0 = blockIdx.x * G;
  const int n = min(G, NW - b0);  // block-uniform
  for (int i = threadIdx.x; i < n * NO; i += blockDim.x) wc[i] = Wcomb[(size_t)b0 * NO + i];
  __syncthreads();
  const SpecStat st = whole_row_stat(nd);
  const float md = med_data[0];
  const auto tail = [&](int g) {
    const float chi = spectrum_tail(rows + g * nd, nd, data, inv_err, VpinvT, VT, md, iters,
                                    renorm != 0, recip, st, &scratch);
    if (threadIdx.x == 0) out[b0 + g] = chi;
  };
  const auto build = [&](int g) {
    build_model_row(wc + g * NO, av[b0 + g], D, NO, nd, kd, rows + g * nd);
  };

  if constexpr (kMode == kBaseline) {
    const float chi = spectrum_block(wc, av[b0], D, NO, nd, kd, data, inv_err, VpinvT, VT, md,
                                     iters, renorm != 0, recip, st, rows, &scratch);
    if (threadIdx.x == 0) out[b0] = chi;
  } else if constexpr (kMode == kNoMxu) {
    const float a = av[b0];
    const bool extinct = a > 0.0f;
    const float ak = kLn10x04 * a;
    const float w0 = wc[0];
    for (int j = threadIdx.x; j < nd; j += blockDim.x) {
      const float m = w0 * __ldg(D + j);
      rows[j] = extinct ? m * expf(ak * kd[j]) : m;
    }
    __syncthreads();
    tail(0);
  } else if constexpr (kMode == kStagger2) {
    for (int g = 0; g < n; ++g) build(g);
    __syncthreads();
    for (int g = 0; g < n; ++g) tail(g);
  } else {
    build(0);
    for (int g = 0; g < n; ++g) {
      if (g + 1 < n) build(g + 1);
      __syncthreads();
      tail(g);
    }
  }
}

template <int kMode>
static int launch_overlap(const void* Wcomb, const void* av, const void* D, const void* kd,
                          const void* data, const void* inv_err, const void* VpinvT,
                          const void* VT, const void* med_data, void* out, int NW, int NO,
                          int nd, int iters, int recip, cudaStream_t stream) {
  constexpr int G = walkers_per_block<kMode>();
  const size_t smem = (size_t)G * (nd + NO) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        spectrum_overlap_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned grid = (unsigned)((NW + G - 1) / G);
  spectrum_overlap_kernel<kMode><<<grid, kThreads, smem, stream>>>(
      (const float*)Wcomb, (const float*)av, (const float*)D, (const float*)kd,
      (const float*)data, (const float*)inv_err, (const float*)VpinvT, (const float*)VT,
      (const float*)med_data, (float*)out, NW, NO, nd, iters, 1, recip);
  return (int)cudaGetLastError();
}

}  // namespace mcmc_spec

extern "C" int spectrum_overlap_launch(const void* Wcomb, const void* av, const void* D,
                                       const void* kd, const void* data, const void* inv_err,
                                       const void* VpinvT, const void* VT,
                                       const void* med_data, void* out, int NW, int NO, int nd,
                                       int iters, int recip, int mode, void* stream) {
  using namespace mcmc_spec;
  using Launch = int (*)(const void*, const void*, const void*, const void*, const void*,
                         const void*, const void*, const void*, const void*, void*, int, int,
                         int, int, int, cudaStream_t);
  static const Launch kModes[] = {launch_overlap<kBaseline>, launch_overlap<kNoMxu>,
                                  launch_overlap<kStagger2>, launch_overlap<kStagger4>};
  if (mode < 0 || mode > kStagger4 || NW < 1 || NO < 1 || nd < 1)
    return (int)cudaErrorInvalidValue;
  return kModes[mode](Wcomb, av, D, kd, data, inv_err, VpinvT, VT, med_data, out, NW, NO, nd,
                      iters, recip, (cudaStream_t)stream);
}
