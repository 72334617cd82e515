// S15: the fused posterior K1 v2 with each warp evaluating two walkers in
// turn (mcmc_spec_tpu_torch/scripts/try_two_blocks.py).
//
// Replaces scripts/try_two_blocks.py:two_half_kernel, the JAX experiment's
// "one program, two halves": one 512-row program running the production body
// on two 256-row halves in turn, through K1's pallas_call
// (mcmc_spec_tpu/ops/pallas_kernels.py:801).  Here a block of wpb warps
// (ops/cuda_kernels.py:walkers_per_block, K1's count) takes 2 wpb walkers:
// warp w runs walker (2 blockIdx.x) wpb + w, then (2 blockIdx.x + 1) wpb + w,
// through K1's body (posterior_warp.cuh) on the same slice of dynamic shared
// memory, so the grid has half of K1's blocks and the same shared memory a
// block.  Each walker's arithmetic is K1's, so the output is K1's bit for bit;
// an odd walker count leaves the last block's second turn partly empty.  The
// arguments are K1's.
#include "posterior_warp.cuh"
#include "spectrum_warp.cuh"

namespace mcmc_spec {

__global__ void __launch_bounds__(kWalkersMax * 32)
    posterior_pair_kernel(const float* __restrict__ scal, const float* __restrict__ p,
                          const PosteriorTables t, const PosteriorConfig a, float spec_scale,
                          float* __restrict__ out, int B) {
  extern __shared__ __align__(16) float dyn[];
  const int warp = threadIdx.x >> 5;
  const int wpb = blockDim.x >> 5;
  // scal: tmin, tmax, med_data
  const TargetScalars ts{scal[0], scal[1], scal[2], spec_scale, whole_row_stat(a.nd)};
  float* mine = dyn + (size_t)warp * warp_smem_floats(a.nd, a.NO, 1 + a.nspec);
  for (int turn = 0; turn < 2; ++turn) {
    const int b = (2 * blockIdx.x + turn) * wpb + warp;
    if (b >= B) return;  // whole warps leave
    const float v = posterior_warp(a, t, ts, p + (size_t)b * a.ndim, mine);
    if ((threadIdx.x & 31) == 0) out[b] = v;
    __syncwarp();  // the next walker reuses the warp's shared memory
  }
}

}  // namespace mcmc_spec

extern "C" int posterior_pair_launch(
    const void* scal, const void* p, const void* D, const void* kd, const void* data,
    const void* inv_err, const void* VpinvT, const void* VT, const void* tentT,
    const void* tentG, const void* mist_tent, const void* mist_vals, const void* av_tent,
    const void* av_vals, const void* Fc, const void* Fp, const void* cobs, const void* pobs,
    const void* prior, void* out, int B, int ndim, int NO, int nd, int nm, int nav, int nc,
    int npf, int nspec, int fit_plx, int dist_fit, int rad_prior, int iters, int recip,
    float spectrum_weight, float spec_scale, float rad_sigma, int wpb, void* stream) {
  using namespace mcmc_spec;
  if (nspec < 1 || nspec > kMaxSpec || nc > kMaxBands || npf > kMaxBands || ndim > kMaxDim ||
      wpb < 1 || wpb > kWalkersMax)
    return (int)cudaErrorInvalidValue;
  const PosteriorTables t{(const float*)D,        (const float*)kd,        (const float*)data,
                          (const float*)inv_err,  (const float*)VpinvT,    (const float*)VT,
                          (const float*)tentT,    (const float*)tentG,     (const float*)mist_tent,
                          (const float*)mist_vals, (const float*)av_tent,  (const float*)av_vals,
                          (const float*)Fc,       (const float*)Fp,        (const float*)cobs,
                          (const float*)pobs,     (const float*)prior};
  const PosteriorConfig a{ndim,    NO,       nd,        nm,    nav,   nc,
                          npf,     nspec,    fit_plx,   dist_fit, rad_prior, iters,
                          recip,   spectrum_weight, rad_sigma};
  const size_t smem = (size_t)wpb * warp_smem_floats(nd, NO, 1 + nspec) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        posterior_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int per_block = 2 * wpb;
  posterior_pair_kernel<<<(B + per_block - 1) / per_block, 32 * wpb, smem,
                          (cudaStream_t)stream>>>((const float*)scal, (const float*)p, t, a,
                                                  spec_scale, (float*)out, B);
  return (int)cudaGetLastError();
}
