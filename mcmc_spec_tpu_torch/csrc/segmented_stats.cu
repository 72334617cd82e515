// K8 and K9: the two reductions of the segmented large-nd lane over the walkers'
// model rows in device memory (v2: many walkers a block, over one segment of the
// points).
//
// K8 renorm_partials replaces mcmc_spec_tpu/ops/spec_segmented.py:
// renorm_partials (body _renorm_partial_kernel): the continuum projection
// partials c[w, k] = sum_j div(data[j], scale[w] model[w, j]) Vpinv[k, j].
// K9 resid_chi2 replaces spec_segmented.py:resid_chi2 (body
// _resid_partial_kernel): the chi^2 residual sum
// sum_j ((scale[w] model[w, j] - target[j]) / err[j])^2, with target =
// div(data, c[w] . V[j, :]) under renorm and the raw data without.  div is
// div_dial, the recip dial of the spectrum block.  Non-finite values
// propagate, as in the Pallas kernels and K2 (the JAX XLA fallback zeroes
// them; the port does not).
//
// Bound: bytes.  Each reads the [NW, nd] model once (268 MB at 1,024 x 65,536:
// 0.08 ms at 3.35 TB/s) for ~10-20 operations per point.  v1 ran one block per
// walker and kept one 4-byte load in flight per thread, and every block re-read
// the rows that all walkers share (data, Vpinv or 1/err and V: 8-20 bytes a
// point, 0.5-1.3 GB from L2 at 1,024 walkers).  v2:
//   1. A block of kLaneThreads threads owns a chunk of kLaneW walkers and one
//      segment of the points (the grid is chunks x segments, segments fastest).
//      It walks the segment in steps of 4 kLaneThreads points; thread t takes the
//      points 4t..4t+3 of a step, loads the shared rows there once into
//      registers (data and Vpinv's three rows for K8; data, err and V's three
//      columns for K9, 1/err computed here by IEEE division, the bits of the
//      plain version's 1.0 / data_err) and applies them to all its walkers: the
//      JAX kernel's reuse of a shared tile across its block of walkers.
//   2. Each walker's row is read as 16-byte loads, kLaneW independent loads in
//      flight per thread.  Row w starts at w * nd, so where nd is not a multiple
//      of 4 the rows start at other offsets within 16 bytes: a chunk holds
//      walkers of one class w mod G (G = 4 / gcd(nd, 4): walkers c + G (i kLaneW + u)),
//      whose rows share the offset.  A segment (a multiple of 4 points) then has,
//      per chunk, a scalar head of < 4 points, an aligned body and a scalar tail
//      of < 4; the shared rows are read at the chunk's offset, by scalars where
//      they are not aligned.  No row is read past its end.
//   3. The per-point arithmetic is the plain version's, each product and sum
//      rounded as there (the _rn intrinsics keep nvcc from contracting them);
//      the division is block_common.cuh's div_dial, with the production recip
//      dial (2) fixed at compile time so that its Newton steps unroll (alone
//      on an H100, read at run time K8 took 16-31 % longer and K9 13-20 %,
//      PERF.md §6), any other dial read at run time.
//   4. spec_segmented.lane_stats_layout chooses the segments, so the CPU tests
//      reach the layout.
//   5. A block sums its threads' partials in a fixed order (a butterfly within
//      each warp, then the warps in order) into a scratch buffer [n_seg, NW, K];
//      a second kernel, launched by the same C function, sums the segments in
//      order (none where one segment covers nd).  No float atomics: the same
//      inputs give the same bits.  Only the sums' order differs from the plain
//      version's, and from v1's.
// What bounds them on an H100: the model's read from device memory (their times
// and shares of the bound at 1,024 and 171 walkers x 65,536 points: PERF.md §6).
// Any NW >= 1 and nd >= 1: a chunk past the walkers exits, missing walkers of
// a ragged chunk re-read a valid row and drop their sums.
#include <cstdint>

#include "block_common.cuh"

namespace mcmc_spec {

constexpr int kLaneThreads = 128;            // threads a block of K8 or K9
constexpr int kLaneWarps = kLaneThreads / 32;
constexpr int kLaneW = 4;                    // walkers a block of K8 or K9
constexpr int kSumThreads = 256;             // threads a block of the segment sum

// walkers of a chunk that share a row offset within 16 bytes: 4 / gcd(nd, 4)
__host__ __device__ __forceinline__ int lane_groups(int nd) {
  return (nd & 3) == 0 ? 1 : ((nd & 1) ? 4 : 2);
}

// 16 bytes at p: one load where p is aligned, else four
__device__ __forceinline__ float4 lane_ld4(const float* __restrict__ p) {
  if ((reinterpret_cast<uintptr_t>(p) & 15) == 0)
    return __ldg(reinterpret_cast<const float4*>(p));
  return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

// div_dial at the dial kRecip, or at the run-time dial where kRecip is kRunTimeRecip
constexpr int kRunTimeRecip = -1;
constexpr int kProdRecip = 2;

template <int kRecip>
__device__ __forceinline__ float lane_div(float num, float den, int recip) {
  return div_dial(num, den, kRecip == kRunTimeRecip ? recip : kRecip);
}

// The walkers and points of this block: chunk k = blockIdx.x / n_seg holds the
// walkers first + G u (u < n) of class first mod G, segment s = blockIdx.x % n_seg
// the points [lo, hi): a head [lo, a), a body of nq float4 from a, a tail to hi.
// spec_segmented.lane_stats_block is its Python twin.
struct LaneBlock {
  int first, G, n, s, lo, hi, a, nq, ns;
};

__device__ __forceinline__ LaneBlock lane_block(const float* model, int NW, int nd, int seg_len,
                                                int n_seg) {
  LaneBlock B;
  const int k = blockIdx.x / n_seg;
  B.s = blockIdx.x % n_seg;
  B.G = lane_groups(nd);
  B.first = k % B.G + B.G * kLaneW * (k / B.G);
  B.n = B.first < NW ? min(kLaneW, (NW - 1 - B.first) / B.G + 1) : 0;
  B.lo = B.s * seg_len;
  B.hi = min(nd, B.lo + seg_len);
  // the offset within 16 bytes, in floats, of the chunk's rows at lo (the same for
  // every walker of the class; computed, since the first walker may be past NW)
  const uint32_t off = (uint32_t)(((uint64_t)(uintptr_t)model >> 2) + (uint64_t)B.first * nd
                                  + B.lo) & 3u;
  B.a = min(B.hi, B.lo + (int)((4u - off) & 3u));
  B.nq = (B.hi - B.a) >> 2;
  B.ns = (B.a - B.lo) + (B.hi - B.a - 4 * B.nq);
  return B;
}

// point of scalar index i < ns: the head first, then the tail
__device__ __forceinline__ int lane_scalar_point(const LaneBlock& B, int i) {
  const int h = B.a - B.lo;
  return i < h ? B.lo + i : B.a + 4 * B.nq + (i - h);
}

// The block's sums of every thread's v[0..N), in a fixed order (a butterfly
// within each warp, then the warps in order): thread i < N returns sum i.
template <int N>
__device__ __forceinline__ float lane_block_sum(const float (&v)[N]) {
  __shared__ float red[kLaneWarps][N];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float t = warp_sum(v[i]);
    if (lane == 0) red[warp][i] = t;
  }
  __syncthreads();
  float tot = 0.0f;
  if (threadIdx.x < N) {
    tot = red[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kLaneWarps; ++w) tot += red[w][threadIdx.x];
  }
  return tot;
}

// K8's work at one point for one walker: frac = div(data, scale model) and its three
// products with Vpinv's columns, each rounded and added, as in the plain version
template <int kRecip>
__device__ __forceinline__ void partials_point(float d, float sc, float m, float p0, float p1,
                                               float p2, int recip, float* c) {
  const float f = lane_div<kRecip>(d, __fmul_rn(sc, m), recip);
  c[0] = fmaf(f, p0, c[0]);
  c[1] = fmaf(f, p1, c[1]);
  c[2] = fmaf(f, p2, c[2]);
}

// What a thread of K8 loads for one step: its four points of each walker's row, of
// the data and of Vpinv's three rows
struct PartialsStep {
  float4 m[kLaneW], d, p0, p1, p2;
};

__device__ __forceinline__ void load_step(PartialsStep& t, const float* const* row,
                                          const float* data, const float* Vpinv, int nd, int j) {
#pragma unroll
  for (int u = 0; u < kLaneW; ++u) t.m[u] = __ldg(reinterpret_cast<const float4*>(row[u] + j));
  t.d = lane_ld4(data + j);
  t.p0 = lane_ld4(Vpinv + j);
  t.p1 = lane_ld4(Vpinv + nd + j);
  t.p2 = lane_ld4(Vpinv + 2 * (size_t)nd + j);
}

template <int kRecip>
__global__ void __launch_bounds__(kLaneThreads)
    renorm_partials_kernel(const float* __restrict__ model, const float* __restrict__ scale,
                           const float* __restrict__ data, const float* __restrict__ Vpinv,
                           float* __restrict__ part, int NW, int nd, int recip, int seg_len,
                           int n_seg) {
  const LaneBlock B = lane_block(model, NW, nd, seg_len, n_seg);
  if (B.n == 0) return;
  const float* row[kLaneW];
  float sc[kLaneW], c[3 * kLaneW];
#pragma unroll
  for (int u = 0; u < kLaneW; ++u) {
    const int w = B.first + B.G * min(u, B.n - 1);
    row[u] = model + (size_t)w * nd;
    sc[u] = __ldg(scale + w);
    c[3 * u] = c[3 * u + 1] = c[3 * u + 2] = 0.0f;
  }
  for (int q = threadIdx.x; q < B.nq; q += kLaneThreads) {
    PartialsStep t;
    load_step(t, row, data, Vpinv, nd, B.a + 4 * q);
#pragma unroll
    for (int u = 0; u < kLaneW; ++u) {
      partials_point<kRecip>(t.d.x, sc[u], t.m[u].x, t.p0.x, t.p1.x, t.p2.x, recip, c + 3 * u);
      partials_point<kRecip>(t.d.y, sc[u], t.m[u].y, t.p0.y, t.p1.y, t.p2.y, recip, c + 3 * u);
      partials_point<kRecip>(t.d.z, sc[u], t.m[u].z, t.p0.z, t.p1.z, t.p2.z, recip, c + 3 * u);
      partials_point<kRecip>(t.d.w, sc[u], t.m[u].w, t.p0.w, t.p1.w, t.p2.w, recip, c + 3 * u);
    }
  }
  if (threadIdx.x < B.ns) {
    const int j = lane_scalar_point(B, threadIdx.x);
    const float d = __ldg(data + j), p0 = __ldg(Vpinv + j), p1 = __ldg(Vpinv + nd + j),
                p2 = __ldg(Vpinv + 2 * (size_t)nd + j);
#pragma unroll
    for (int u = 0; u < kLaneW; ++u)
      partials_point<kRecip>(d, sc[u], __ldg(row[u] + j), p0, p1, p2, recip, c + 3 * u);
  }
  const float tot = lane_block_sum<3 * kLaneW>(c);
  const int i = threadIdx.x, u = i / 3;
  if (i < 3 * kLaneW && u < B.n)
    part[((size_t)B.s * NW + B.first + B.G * u) * 3 + i % 3] = tot;
}

// K9's work at one point for one walker (c: the walker's coefficients): the fit, the
// target and the residual each rounded as in the plain version, the square added
template <bool kRenorm, int kRecip>
__device__ __forceinline__ float resid_point(float acc, float d, float ie, float sc, float m,
                                             const float* c, float v0, float v1, float v2,
                                             int recip) {
  float t = d;
  if (kRenorm) {
    const float fit = __fadd_rn(__fadd_rn(__fmul_rn(c[0], v0), __fmul_rn(c[1], v1)),
                                __fmul_rn(c[2], v2));
    t = lane_div<kRecip>(d, fit, recip);
  }
  const float r = __fmul_rn(__fsub_rn(__fmul_rn(sc, m), t), ie);
  return fmaf(r, r, acc);
}

// What a thread of K9 loads for one step: its four points of each walker's row, of the
// data and of err, and (under renorm) V's rows there, 12 floats from 3 j
template <bool kRenorm>
struct ResidStep {
  float4 m[kLaneW], d, e;
  float v[kRenorm ? 12 : 1];
};

template <bool kRenorm>
__device__ __forceinline__ void load_step(ResidStep<kRenorm>& t, const float* const* row,
                                          const float* data, const float* err, const float* V,
                                          int j) {
#pragma unroll
  for (int u = 0; u < kLaneW; ++u) t.m[u] = __ldg(reinterpret_cast<const float4*>(row[u] + j));
  t.d = lane_ld4(data + j);
  t.e = lane_ld4(err + j);
  if (kRenorm) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float4 x = lane_ld4(V + 3 * (size_t)j + 4 * k);
      t.v[4 * k] = x.x;
      t.v[4 * k + 1] = x.y;
      t.v[4 * k + 2] = x.z;
      t.v[4 * k + 3] = x.w;
    }
  }
}

template <bool kRenorm, int kRecip>
__global__ void __launch_bounds__(kLaneThreads)
    resid_chi2_kernel(const float* __restrict__ model, const float* __restrict__ scale,
                      const float* __restrict__ coeffs, const float* __restrict__ data,
                      const float* __restrict__ err, const float* __restrict__ V,
                      float* __restrict__ part, int NW, int nd, int recip, int seg_len,
                      int n_seg) {
  const LaneBlock B = lane_block(model, NW, nd, seg_len, n_seg);
  if (B.n == 0) return;
  const float* row[kLaneW];
  float sc[kLaneW], acc[kLaneW], c[kRenorm ? 3 * kLaneW : 1];
#pragma unroll
  for (int u = 0; u < kLaneW; ++u) {
    const int w = B.first + B.G * min(u, B.n - 1);
    row[u] = model + (size_t)w * nd;
    sc[u] = __ldg(scale + w);
    acc[u] = 0.0f;
    if (kRenorm) {
#pragma unroll
      for (int k = 0; k < 3; ++k) c[3 * u + k] = __ldg(coeffs + 3 * w + k);
    }
  }
  for (int q = threadIdx.x; q < B.nq; q += kLaneThreads) {
    ResidStep<kRenorm> t;
    load_step(t, row, data, err, V, B.a + 4 * q);
    const float ie[4] = {1.0f / t.e.x, 1.0f / t.e.y, 1.0f / t.e.z, 1.0f / t.e.w};
    const float dv[4] = {t.d.x, t.d.y, t.d.z, t.d.w};
#pragma unroll
    for (int u = 0; u < kLaneW; ++u) {
      const float mv[4] = {t.m[u].x, t.m[u].y, t.m[u].z, t.m[u].w};
#pragma unroll
      for (int p = 0; p < 4; ++p)
        acc[u] = resid_point<kRenorm, kRecip>(
            acc[u], dv[p], ie[p], sc[u], mv[p], c + (kRenorm ? 3 * u : 0),
            kRenorm ? t.v[3 * p] : 0.0f, kRenorm ? t.v[3 * p + 1] : 0.0f,
            kRenorm ? t.v[3 * p + 2] : 0.0f, recip);
    }
  }
  if (threadIdx.x < B.ns) {
    const int j = lane_scalar_point(B, threadIdx.x);
    const float d = __ldg(data + j), ie = 1.0f / __ldg(err + j);
    float v0 = 0.0f, v1 = 0.0f, v2 = 0.0f;
    if (kRenorm) {
      v0 = __ldg(V + 3 * (size_t)j);
      v1 = __ldg(V + 3 * (size_t)j + 1);
      v2 = __ldg(V + 3 * (size_t)j + 2);
    }
#pragma unroll
    for (int u = 0; u < kLaneW; ++u)
      acc[u] = resid_point<kRenorm, kRecip>(acc[u], d, ie, sc[u], __ldg(row[u] + j),
                                             c + (kRenorm ? 3 * u : 0), v0, v1, v2, recip);
  }
  const float tot = lane_block_sum<kLaneW>(acc);
  if (threadIdx.x < B.n) part[(size_t)B.s * NW + B.first + B.G * threadIdx.x] = tot;
}

// out[r] = the sum over s of part[s, r], in segment order
__global__ void __launch_bounds__(kSumThreads)
    lane_segments_sum_kernel(const float* __restrict__ part, float* __restrict__ out, int rows,
                             int n_seg) {
  const int r = blockIdx.x * kSumThreads + threadIdx.x;
  if (r >= rows) return;
  float t = part[r];
  for (int s = 1; s < n_seg; ++s) t += part[(size_t)s * rows + r];
  out[r] = t;
}

// The chunks of kLaneW walkers (G classes, ceil(ceil(NW / G) / kLaneW) chunks each); -1
// where the layout is not one lane_stats_layout gives: seg_len a positive multiple of 4,
// n_seg segments covering nd with none empty.
__host__ int lane_chunks(int NW, int nd, int seg_len, int n_seg) {
  if (NW < 1 || nd < 1 || seg_len < 4 || seg_len % 4 || n_seg < 1) return -1;
  if ((long long)(n_seg - 1) * seg_len >= nd || (long long)n_seg * seg_len < nd) return -1;
  const int G = lane_groups(nd);
  const long long chunks = (long long)G * (((NW + G - 1) / G + kLaneW - 1) / kLaneW);
  return chunks * n_seg > 0x7fffffffLL ? -1 : (int)chunks;
}

// the segment sum of `rows` values into out, unless one segment wrote them there
__host__ int lane_segments_sum(const float* part, float* out, int rows, int n_seg,
                               cudaStream_t stream) {
  if (n_seg > 1)
    lane_segments_sum_kernel<<<(rows + kSumThreads - 1) / kSumThreads, kSumThreads, 0, stream>>>(
        part, out, rows, n_seg);
  return (int)cudaGetLastError();
}

}  // namespace mcmc_spec

// part: [n_seg, NW, 3] scratch (unused, may be null, where n_seg is 1); out: [NW, 3]
extern "C" int renorm_partials_launch(const void* model, const void* scale, const void* data,
                                      const void* Vpinv, void* part, void* out, int NW, int nd,
                                      int recip, int seg_len, int n_seg, void* stream) {
  using namespace mcmc_spec;
  const int chunks = lane_chunks(NW, nd, seg_len, n_seg);
  if (chunks < 0 || recip < 0 || (n_seg > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  float* dst = (float*)(n_seg > 1 ? part : out);
  const float *m = (const float*)model, *s = (const float*)scale, *d = (const float*)data,
              *p = (const float*)Vpinv;
  if (recip == kProdRecip)
    renorm_partials_kernel<kProdRecip><<<chunks * n_seg, kLaneThreads, 0, st>>>(
        m, s, d, p, dst, NW, nd, recip, seg_len, n_seg);
  else
    renorm_partials_kernel<kRunTimeRecip><<<chunks * n_seg, kLaneThreads, 0, st>>>(
        m, s, d, p, dst, NW, nd, recip, seg_len, n_seg);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return lane_segments_sum(dst, (float*)out, 3 * NW, n_seg, st);
}

// err is data_err and V the [nd, 3] Vandermonde as the wrapper receives them; coeffs
// and V are read only under renorm.  part: [n_seg, NW] scratch, as for K8; out: [NW]
extern "C" int resid_chi2_launch(const void* model, const void* scale, const void* coeffs,
                                 const void* data, const void* err, const void* V, void* part,
                                 void* out, int NW, int nd, int recip, int renorm, int seg_len,
                                 int n_seg, void* stream) {
  using namespace mcmc_spec;
  const int chunks = lane_chunks(NW, nd, seg_len, n_seg);
  if (chunks < 0 || recip < 0 || (n_seg > 1 && part == nullptr)
      || (renorm && (coeffs == nullptr || V == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  float* dst = (float*)(n_seg > 1 ? part : out);
  const float *m = (const float*)model, *s = (const float*)scale, *c = (const float*)coeffs,
              *d = (const float*)data, *e = (const float*)err, *v = (const float*)V;
  // without renorm K9 does not divide
  if (!renorm)
    resid_chi2_kernel<false, kRunTimeRecip><<<chunks * n_seg, kLaneThreads, 0, st>>>(
        m, s, c, d, e, v, dst, NW, nd, recip, seg_len, n_seg);
  else if (recip == kProdRecip)
    resid_chi2_kernel<true, kProdRecip><<<chunks * n_seg, kLaneThreads, 0, st>>>(
        m, s, c, d, e, v, dst, NW, nd, recip, seg_len, n_seg);
  else
    resid_chi2_kernel<true, kRunTimeRecip><<<chunks * n_seg, kLaneThreads, 0, st>>>(
        m, s, c, d, e, v, dst, NW, nd, recip, seg_len, n_seg);
  const cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  return lane_segments_sum(dst, (float*)out, NW, n_seg, st);
}
