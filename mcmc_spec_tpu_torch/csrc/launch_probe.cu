// S1-S3: the launch and operand cost of the fused posterior (K1) with no
// compute behind it (mcmc_spec_tpu_torch/scripts/dma_probe.py,
// dma_probe_bisect.py and dma_probe_bisect2.py).
//
// Replaces the trivial Pallas kernels of scripts/dma_probe.py:trivial_call
// (S1), scripts/dma_probe_bisect.py:build (S2) and
// scripts/dma_probe_bisect2.py:run (S3).  Each scores a [nw, pw] f32 walker
// batch, ``walkers_per_cta`` walkers to a thread block, one thread per walker
// (a block of more than 256 walkers loops), with a list of broadcast f32
// tables beside it:
//
//   trivial_probe (S1): out[w] = sum_k p[w, k] + tab0[0, 0] (0 without tables);
//   bisect_probe (S2): the same with K1's signature ingredients: three scalars
//     passed by value (the Pallas SMEM operand), more tables, p of 6 columns,
//     and the empty-section op chain of dma_probe_bisect.py (a [B, 56] stub,
//     a lane sum, the isnan/isfinite selects) in the JAX order;
//   bisect2_probe (S3): every block reads every table, its first element
//     (peek) or all of it (full, a block-wide sum in a fixed order, so the
//     result is deterministic), and adds the total to each walker's row sum.
//
// Every block has 256 threads, as K1's and S8's have, whatever its walker
// count: a block of one walker is K1's shape (32,768 blocks at K1's batch), one
// of 32 S8's tile.  The threads beyond the block's walkers take part only in
// the table reads.  The tables travel as pointers in a struct passed by value:
// CUDA copies no operand a kernel does not read, so S1's and S2's unread
// tables cost nothing here by construction, unlike Pallas's per-step copies.
//
// Bound: the launch.  The bytes (p once, the tables once, the output) take
// about a microsecond at the card's memory rate; the probes measure what a
// launch, the block count, the operand count and the tables' re-reads from L2
// add to that, which is what K1 pays before any compute.
#include "block_common.cuh"

namespace mcmc_spec {

constexpr int kMaxProbeTables = 20;

struct ProbeTables {
  const float* ptr[kMaxProbeTables];
  int size[kMaxProbeTables];  // elements
  int n;
};

// f32 constants of the JAX op chain, rounded from the Python floats
constexpr float kRsunCm = 6.957e10f;
constexpr float kPcCm = 3.086e18f;
constexpr float kStubWeight = 1e-4f;
constexpr int kStubWidth = 56;  // NO: the [B, 56] blend-weight stub

__device__ __forceinline__ float row_sum(const float* __restrict__ p, size_t w, int pw) {
  float s = p[w * pw];
  for (int k = 1; k < pw; ++k) s += p[w * pw + k];
  return s;
}

// the sum of a whole table: a strided sequential sum per thread, then the
// block reduction (fixed order); every thread gets the total
__device__ __forceinline__ float table_sum(const float* __restrict__ tab, int n,
                                           BlockScratch* s) {
  float v = 0.0f;
  for (int j = threadIdx.x; j < n; j += blockDim.x) v += tab[j];
  return block_sum(v, s);
}

__global__ void __launch_bounds__(kThreads)
    trivial_probe_kernel(const float* __restrict__ p, const ProbeTables tabs,
                         float* __restrict__ out, int nw, int walkers_per_cta) {
  const float t = tabs.n > 0 ? tabs.ptr[0][0] : 0.0f;
  const size_t w0 = (size_t)blockIdx.x * walkers_per_cta;
  for (int i = threadIdx.x; i < walkers_per_cta && w0 + i < (size_t)nw; i += blockDim.x)
    out[w0 + i] = row_sum(p, w0 + i, 8) + t;
}

__global__ void __launch_bounds__(kThreads)
    bisect_probe_kernel(const float* __restrict__ p, int pw, const ProbeTables tabs, float s0,
                        float s2, int use_smem, int body, float* __restrict__ out, int nw,
                        int walkers_per_cta) {
  const float t00 = tabs.ptr[0][0];
  const size_t w0 = (size_t)blockIdx.x * walkers_per_cta;
  for (int i = threadIdx.x; i < walkers_per_cta && w0 + i < (size_t)nw; i += blockDim.x) {
    const size_t w = w0 + i;
    if (!body) {
      out[w] = row_sum(p, w, pw) + t00 + (use_smem ? s0 : 0.0f);
      continue;
    }
    // dma_probe_bisect.py:67-80, op by op (the _rn intrinsics keep nvcc from
    // contracting a multiply and an add into an FMA)
    const float* x = p + w * pw;
    const float r1 = x[1];
    const float plx = pw > 2 ? x[2] : r1;
    float base = __fdiv_rn(__fmul_rn(__fmul_rn(r1, kRsunCm), plx), kPcCm);
    base = __fmul_rn(base, base);
    const float wk = __fmul_rn(x[0], kStubWeight);
    const float wc = __fadd_rn(__fmul_rn(base, wk), wk);
    float s = wc;
    for (int o = 1; o < kStubWidth; ++o) s = __fadd_rn(s, wc);
    s = __fadd_rn(s, t00);
    if (use_smem) s = __fadd_rn(s, s2);
    const float ll = s != s ? -INFINITY : __fmul_rn(-0.5f, s);
    out[w] = __fadd_rn(0.0f, ll);  // lp = 0 is finite: lp + ll
  }
}

__global__ void __launch_bounds__(kThreads)
    bisect2_probe_kernel(const float* __restrict__ p, const ProbeTables tabs, int full,
                         float* __restrict__ out, int nw, int walkers_per_cta) {
  __shared__ BlockScratch scratch;
  float acc = 0.0f;
  for (int k = 0; k < tabs.n; ++k)
    acc += full ? table_sum(tabs.ptr[k], tabs.size[k], &scratch) : tabs.ptr[k][0];
  const size_t w0 = (size_t)blockIdx.x * walkers_per_cta;
  for (int i = threadIdx.x; i < walkers_per_cta && w0 + i < (size_t)nw; i += blockDim.x)
    out[w0 + i] = row_sum(p, w0 + i, 8) + acc;
}

// the table list of a launch, checked: a null pointer or a count outside
// [min_n, kMaxProbeTables] is refused
__host__ inline bool probe_tables(const void* const* ptrs, const int* sizes, int n, int min_n,
                                  ProbeTables* t) {
  if (n < min_n || n > kMaxProbeTables) return false;
  t->n = n;
  for (int k = 0; k < kMaxProbeTables; ++k) {
    t->ptr[k] = k < n ? (const float*)ptrs[k] : nullptr;
    t->size[k] = k < n ? sizes[k] : 0;
    if (k < n && (t->ptr[k] == nullptr || t->size[k] < 1)) return false;
  }
  return true;
}

__host__ inline unsigned probe_blocks(int nw, int walkers_per_cta) {
  return (unsigned)((nw + (size_t)walkers_per_cta - 1) / walkers_per_cta);
}

}  // namespace mcmc_spec

extern "C" int trivial_probe_launch(const void* p, const void* const* tabs, const int* sizes,
                                    int ntab, void* out, int nw, int walkers_per_cta,
                                    void* stream) {
  using namespace mcmc_spec;
  ProbeTables t;
  if (nw < 1 || walkers_per_cta < 1 || !probe_tables(tabs, sizes, ntab, 0, &t))
    return (int)cudaErrorInvalidValue;
  trivial_probe_kernel<<<probe_blocks(nw, walkers_per_cta), kThreads, 0,
                         (cudaStream_t)stream>>>((const float*)p, t, (float*)out, nw,
                                                 walkers_per_cta);
  return (int)cudaGetLastError();
}

extern "C" int bisect_probe_launch(const void* p, int pw, const void* const* tabs,
                                   const int* sizes, int ntab, float s0, float s2, int use_smem,
                                   int body, void* out, int nw, int walkers_per_cta,
                                   void* stream) {
  using namespace mcmc_spec;
  ProbeTables t;
  if (nw < 1 || walkers_per_cta < 1 || pw < 2 || !probe_tables(tabs, sizes, ntab, 1, &t))
    return (int)cudaErrorInvalidValue;
  bisect_probe_kernel<<<probe_blocks(nw, walkers_per_cta), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)p, pw, t, s0, s2, use_smem, body, (float*)out, nw, walkers_per_cta);
  return (int)cudaGetLastError();
}

extern "C" int bisect2_probe_launch(const void* p, const void* const* tabs, const int* sizes,
                                    int ntab, int full, void* out, int nw, int walkers_per_cta,
                                    void* stream) {
  using namespace mcmc_spec;
  ProbeTables t;
  if (nw < 1 || walkers_per_cta < 1 || !probe_tables(tabs, sizes, ntab, 0, &t))
    return (int)cudaErrorInvalidValue;
  bisect2_probe_kernel<<<probe_blocks(nw, walkers_per_cta), kThreads, 0,
                         (cudaStream_t)stream>>>((const float*)p, t, full, (float*)out, nw,
                                                 walkers_per_cta);
  return (int)cudaGetLastError();
}
