// K8 and K9: the two reductions of the segmented large-nd lane over a
// walker's model row in device memory, one thread block per walker.
//
// K8 renorm_partials replaces mcmc_spec_tpu/ops/spec_segmented.py:
// renorm_partials (body _renorm_partial_kernel): the continuum projection
// partials c[w, k] = sum_j div(data[j], scale[w] model[w, j]) Vpinv[k, j].
// K9 resid_chi2 replaces spec_segmented.py:resid_chi2 (body
// _resid_partial_kernel): the chi^2 residual sum
// sum_j ((scale[w] model[w, j] - target[j]) inv_err[j])^2, with target =
// div(data, c[w] . V[j, :]) under renorm and the raw data without.  Both JAX
// kernels go through _nd_tiled_call, which carries a partial sum across the
// sequential nd grid axis; here one block walks the whole row with a stride
// of the block size and reduces once (block_sum3 / block_sum of
// block_common.cuh), so the sum order is fixed and the result deterministic.
// Any nd, any NW: the grid is exactly NW blocks.  div is div_dial, the recip
// dial of the spectrum block.  Non-finite values propagate, as in the Pallas
// kernels and K2 (the JAX XLA fallback zeroes them; the port does not).
//
// Bound: bytes.  Each reads the [NW, nd] model once (268 MB at 1,024 x
// 65,536: 0.08 ms at 3.35 TB/s) for ~10 operations per point; the [nd] and
// [3, nd] data rows are shared by every block and stay in L2.
#include "block_common.cuh"

namespace mcmc_spec {

__global__ void __launch_bounds__(kThreads)
    renorm_partials_kernel(const float* __restrict__ model, const float* __restrict__ scale,
                           const float* __restrict__ data, const float* __restrict__ VpinvT,
                           float* __restrict__ out, int nd, int recip) {
  __shared__ BlockScratch scratch;
  const int b = blockIdx.x;
  const float* row = model + (size_t)b * nd;
  const float sc = scale[b];
  float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
  for (int j = threadIdx.x; j < nd; j += kThreads) {
    const float frac = div_dial(data[j], sc * __ldg(row + j), recip);
    c0 += frac * VpinvT[j];
    c1 += frac * VpinvT[nd + j];
    c2 += frac * VpinvT[2 * nd + j];
  }
  block_sum3(c0, c1, c2, &scratch);
  if (threadIdx.x == 0) {
    out[3 * b] = c0;
    out[3 * b + 1] = c1;
    out[3 * b + 2] = c2;
  }
}

__global__ void __launch_bounds__(kThreads)
    resid_chi2_kernel(const float* __restrict__ model, const float* __restrict__ scale,
                      const float* __restrict__ coeffs, const float* __restrict__ data,
                      const float* __restrict__ inv_err, const float* __restrict__ VT,
                      float* __restrict__ out, int nd, int recip, int renorm) {
  __shared__ BlockScratch scratch;
  const int b = blockIdx.x;
  const float* row = model + (size_t)b * nd;
  const float sc = scale[b];
  float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
  if (renorm) {
    c0 = coeffs[3 * b];
    c1 = coeffs[3 * b + 1];
    c2 = coeffs[3 * b + 2];
  }
  float acc = 0.0f;
  for (int j = threadIdx.x; j < nd; j += kThreads) {
    float target = data[j];
    if (renorm) target = div_dial(target, c0 * VT[j] + c1 * VT[nd + j] + c2 * VT[2 * nd + j], recip);
    const float r = (sc * __ldg(row + j) - target) * inv_err[j];
    acc += r * r;
  }
  const float tot = block_sum(acc, &scratch);
  if (threadIdx.x == 0) out[b] = tot;
}

}  // namespace mcmc_spec

extern "C" int renorm_partials_launch(const void* model, const void* scale, const void* data,
                                      const void* VpinvT, void* out, int NW, int nd, int recip,
                                      void* stream) {
  using namespace mcmc_spec;
  if (NW < 1 || nd < 1) return (int)cudaErrorInvalidValue;
  renorm_partials_kernel<<<NW, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)model, (const float*)scale, (const float*)data, (const float*)VpinvT,
      (float*)out, nd, recip);
  return (int)cudaGetLastError();
}

extern "C" int resid_chi2_launch(const void* model, const void* scale, const void* coeffs,
                                 const void* data, const void* inv_err, const void* VT, void* out,
                                 int NW, int nd, int recip, int renorm, void* stream) {
  using namespace mcmc_spec;
  if (NW < 1 || nd < 1 || (renorm && (coeffs == nullptr || VT == nullptr)))
    return (int)cudaErrorInvalidValue;
  resid_chi2_kernel<<<NW, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)model, (const float*)scale, (const float*)coeffs, (const float*)data,
      (const float*)inv_err, (const float*)VT, (float*)out, nd, recip, renorm);
  return (int)cudaGetLastError();
}
