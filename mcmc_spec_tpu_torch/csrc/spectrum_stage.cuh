// The spectrum body of the fused posteriors K1 (log_posterior_fused.cu) and K5
// (log_posterior_fleet_fused.cu): one warp per walker as in v2
// (spectrum_warp.cuh), with the target's tables read once per block through
// shared-memory tiles instead of once per warp (v3), and the walker's model row
// in the lanes' registers wherever it fits (v4).
//
// What bounded v2: every warp read its walker's D rows (8 at the production
// weights), kd, data (twice), inv_err and the 3 + 3 continuum rows from L2 on
// its own: 18 rows of nd floats a walker, though the 10 table rows are the same
// for every walker of a target and a block's walkers, a cloud in the grid,
// share most of their D rows.  v3 reads each of them from L2 once a block:
//   1. Each warp writes its compact list (spectrum_warp.cuh, step 1) and sets
//      the bits of its grid indices in the block's NO-bit mask; the union U of
//      the block's rows is the mask, and a row's slot the popcount below its
//      bit.  Each warp maps its list to slots, which keeps its order (both
//      ascend in o).
//   2. The row build sweeps nd in tiles of a multiple of 32 points: the block
//      copies the tile of the U rows and of kd into shared memory (cp.async,
//      two buffers, so the next tile's copy overlaps this tile's FMAs), then
//      each lane builds the points j = lane (mod 32) of the tile, in ascending
//      order, with fmaf over its list in chunks of kBuildChunk and libm expf:
//      v2's operations on v2's operands, so the row is v2's bit for bit.
//   3. The median: v2's row_median_warp over the warp's own row, no barrier.
//   4. The renorm sums (data, VpinvT) and the chi^2 (data, VT, inv_err) sweep
//      tiles staged the same way; each lane carries its sums across tiles in
//      v2's j order, so c0..c2 and the chi^2 are v2's bit for bit.
// v3 kept each warp's row (7 KB at nd = 1,792) in shared memory: written once,
// read back 14 times by the median's passes and twice by the tail.  v4 keeps it
// in registers where nd <= 32 kRegPoints (1,792): lane l holds the points
// j = l + 32 i, i < kRegPoints, v3's points in v3's order, so the row, the
// median's bracket, c0..c2 and the chi^2 are v3's (and v2's) bit for bit.
// Register indices must be compile-time, so the tiles are too: the build sweeps
// kRegTiles point tiles of kRegTilePoints (each lane's kRegTileSlots slots of
// the tile, unrolled), one list entry at a time, in row groups of as many of the
// U + 1 rows (the D rows, then kd) as a buffer holds (one group at NO = 56),
// each entry's fmaf chain carried in its registers from tile to tile; the
// median's passes compare registers; one tail tile of kRegTailRows full rows
// (data, VpinvT, VT, inv_err) serves the renorm and the chi^2.  Points past nd
// hold a NaN pattern above every bracket bound and stay out of the sums.  The
// union, cp.async, the two buffers and the staging counter are v3's.  A wider
// row keeps v3 (its row in shared memory).
// Block barriers sit at the tile boundaries, so every warp of the block takes
// part in the copies and barriers: the caller gives a warp past the ragged end
// the block's last walker again and drops its result.  The walkers of a block
// are one target's (K5 gives each target its own row of blocks).
// What bounds v4 (PERF.md, an H100 at the koi2298 shapes): registers, not shared
// memory, hold an SM to 16 warps (one block of 16 at up to 128 registers a
// thread); the median's passes still compare every point 14 times and the tail
// divides twice a point.
#pragma once

#include "spectrum_warp.cuh"

namespace mcmc_spec {

constexpr int kStagedWalkersMax = 16;  // walkers (warps) a block of K1/K5 v3 at most
constexpr int kRegPoints = 56;      // a lane's points of a register row: nd <= 32 * kRegPoints
constexpr int kRegTileSlots = 14;   // a build tile's points a lane
constexpr int kRegTiles = kRegPoints / kRegTileSlots;
constexpr int kRegTilePoints = 32 * kRegTileSlots;  // a build tile's width, 448 points
constexpr int kRegRowPoints = 32 * kRegPoints;      // the tail tile's row stride, 1,792
constexpr int kRegTailRows = 8;     // the tail tile: data, VpinvT (3), VT (3), inv_err

// v4, the walker's row in registers, or v3, the row in shared memory.
__host__ __device__ inline bool stage_reg_row(int nd) { return nd <= 32 * kRegPoints; }

// The floats of a warp's row in shared memory: none for a register row.
__host__ __device__ inline int stage_row_floats(int nd) {
  return stage_reg_row(nd) ? 0 : round4(nd);
}

// A warp's slice of a K1/K5 block, in floats: its row (v3) and its weight rows and
// compact list (warp_smem_floats without the row for v4).
__host__ __device__ inline int stage_warp_floats(int nd, int NO, int weight_rows) {
  return stage_row_floats(nd) + round4((weight_rows + 2) * NO);
}

// A tile buffer of `stage` floats takes v4's tail tile, or v3's smallest tiles (a build
// tile of 32 points of every grid row and kd, a tail tile of 5 rows of 32).
__host__ __device__ inline bool stage_fits(int nd, int NO, int stage) {
  if (stage % 32 != 0) return false;
  return stage_reg_row(nd) ? stage >= kRegTailRows * kRegRowPoints
                           : stage >= 32 * (NO + 1) && stage >= 160;
}

// The block's own part of the v3 layout, in 4-byte words after the warps' slices:
// the NO-bit mask, the slot -> grid index map, and the sum of the list lengths.
__host__ __device__ inline int stage_union_words(int NO) {
  return round4((NO + 31) / 32) + round4(NO) + 4;
}

// The dynamic shared memory of a K1/K5 block, in floats: wpb warps' slices
// (stage_warp_floats), the union, and two tile buffers of `stage` floats each
// (a multiple of 32).  ops/cuda_kernels.py:staged_smem_bytes mirrors it.
__host__ __device__ inline int staged_smem_floats(int nd, int NO, int weight_rows, int wpb,
                                                  int stage) {
  return wpb * stage_warp_floats(nd, NO, weight_rows) + stage_union_words(NO) + 2 * stage;
}

// The block's staging area and the target's tables it copies from.
struct StageArea {
  unsigned* mask;  // [ceil(NO / 32)]
  int* urow;       // [NO] slot -> grid index o, the first U used
  int* misc;       // [0] the sum of the active walkers' list lengths
  float* ring;     // [2][stage]
  int stage;
  unsigned long long* rows;  // nullable: += U, sum of L, 1 (the staging counter)
};

__device__ __forceinline__ StageArea stage_area(float* dyn, int nd, int NO, int weight_rows,
                                                int wpb, int stage,
                                                unsigned long long* rows) {
  int* u = reinterpret_cast<int*>(dyn + (size_t)wpb * stage_warp_floats(nd, NO, weight_rows));
  StageArea s;
  s.mask = reinterpret_cast<unsigned*>(u);
  s.urow = u + round4((NO + 31) / 32);
  s.misc = s.urow + round4(NO);
  s.ring = reinterpret_cast<float*>(u + stage_union_words(NO));
  s.stage = stage;
  s.rows = rows;
  return s;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The three sweeps of the tables: the row build (U rows of D, then kd), the
// renorm sums (data, VpinvT) and the chi^2 (data, VT, inv_err).
struct StageSweeps {
  const float* D;
  const float* kd;
  const float* data;
  const float* inv_err;
  const float* VpinvT;
  const float* VT;
  const int* urow;
  int nd, U;
  int wb, nb;  // the build's tile width and tile count
  int wt, nt;  // the tail sweeps' tile width and tile count (each)
  bool vec;    // 16-byte copies: nd and every table 16-byte aligned

  __device__ __forceinline__ const float* src(int sweep, int r) const {
    if (sweep == 0) return r < U ? D + (size_t)urow[r] * nd : kd;
    if (sweep == 1) return r == 0 ? data : VpinvT + (size_t)(r - 1) * nd;
    return r == 0 ? data : (r < 4 ? VT + (size_t)(r - 1) * nd : inv_err);
  }

  // Tile k of the block's sequence (nb build tiles, then nt renorm, then nt chi^2):
  // its sweep, first point, point count and width (the row stride in the buffer).
  __device__ __forceinline__ void tile(int k, int& sweep, int& j0, int& n, int& w) const {
    if (k < nb) {
      sweep = 0;
      w = wb;
      j0 = k * wb;
    } else {
      sweep = k < nb + nt ? 1 : 2;
      w = wt;
      j0 = (k - nb - (sweep - 1) * nt) * wt;
    }
    n = min(w, nd - j0);
  }

  // The whole block copies tile k into buf and commits the copy as one group.
  __device__ __forceinline__ void issue(int k, float* buf) const {
    int sweep, j0, n, w;
    tile(k, sweep, j0, n, w);
    const int rows = sweep == 0 ? U + 1 : (sweep == 1 ? 4 : 5);
    if (vec) {
      const int per = n >> 2;
      for (int c = threadIdx.x; c < rows * per; c += blockDim.x) {
        const int r = c / per, q = 4 * (c - r * per);
        cp_async16(buf + r * w + q, src(sweep, r) + j0 + q);
      }
    } else {
      for (int c = threadIdx.x; c < rows * n; c += blockDim.x) {
        const int r = c / n, x = c - r * n;
        cp_async4(buf + r * w + x, src(sweep, r) + j0 + x);
      }
    }
    cp_async_commit();
  }
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// v4's tiles: kRegTiles build tiles of kRegTilePoints, each in row groups of `rb` of
// the U + 1 rows (the U rows of D, then kd), then the tail tile: kRegTailRows rows of
// kRegRowPoints (data, VpinvT, VT, inv_err).
struct RegSweeps {
  const float* D;
  const float* kd;
  const float* data;
  const float* inv_err;
  const float* VpinvT;
  const float* VT;
  const int* urow;
  int nd, U;
  int rb, ng;  // the rows a build buffer holds, the row groups a build tile
  bool vec;    // 16-byte copies: nd and every table 16-byte aligned

  __device__ __forceinline__ const float* src(bool tail, int r) const {
    if (!tail) return r < U ? D + (size_t)urow[r] * nd : kd;
    if (r == 0) return data;
    if (r < 4) return VpinvT + (size_t)(r - 1) * nd;
    return r < 7 ? VT + (size_t)(r - 4) * nd : inv_err;
  }

  // The whole block copies tile k into buf and commits the copy as one group (an empty
  // one for a build tile past nd).
  __device__ __forceinline__ void issue(int k, float* buf) const {
    const bool tail = k == kRegTiles * ng;
    int r0 = 0, rows = kRegTailRows, j0 = 0, w = kRegRowPoints;
    if (!tail) {
      const int t = k / ng;
      r0 = (k - t * ng) * rb;
      rows = min(rb, U + 1 - r0);
      j0 = t * kRegTilePoints;
      w = kRegTilePoints;
    }
    const int n = min(w, nd - j0);
    if (vec) {
      const int per = max(n, 0) >> 2;
      for (int c = threadIdx.x; c < rows * per; c += blockDim.x) {
        const int r = c / per, q = 4 * (c - r * per);
        cp_async16(buf + r * w + q, src(tail, r0 + r) + j0 + q);
      }
    } else {
      for (int c = threadIdx.x; c < rows * n; c += blockDim.x) {
        const int r = c / n, x = c - r * n;
        cp_async4(buf + r * w + x, src(tail, r0 + r) + j0 + x);
      }
    }
    cp_async_commit();
  }
};

// The count of a register row's points whose int32 bit pattern is <= v (the lane's
// share; the caller reduces) and, with kMin, the min of the others among the lane's nv
// points.  The padding past nd (0x7fffffff) is above every v.
template <bool kMin>
__device__ __forceinline__ unsigned count_le_reg(const float (&r)[kRegPoints], int nv, int32_t v,
                                                 float& m) {
  unsigned c[4] = {0, 0, 0, 0};  // four partial counts: four add chains, not one
#pragma unroll
  for (int i = 0; i < kRegPoints; ++i) {
    if (__float_as_int(r[i]) <= v) ++c[i & 3];
    else if constexpr (kMin) {
      if (i < nv) m = min_nan(m, r[i]);
    }
  }
  return (c[0] + c[1]) + (c[2] + c[3]);
}

// row_median_warp (spectrum_warp.cuh) over a register row: the same passes, counts and
// ranks, so the same bracket and the same result.
__device__ __forceinline__ float row_median_reg(const float (&r)[kRegPoints], int nv, int r1,
                                                int r2, int iters) {
  int32_t lo = 0, hi = kF32InfBits;
  float unused = 0.0f;
  for (int it = 0; it < iters; ++it) {
    const int32_t mid = lo + ((hi - lo) >> 1);
    const unsigned c = count_le_reg<false>(r, nv, mid, unused);
    if ((int)__reduce_add_sync(0xffffffffu, c) >= r1) hi = mid;
    else lo = mid + 1;
  }
  if (iters < 31) return __int_as_float(lo + ((hi - lo) >> 1));
  const float x1 = __int_as_float(hi);
  if (r2 <= 0) return x1;
  float m = INFINITY;
  const unsigned c = count_le_reg<true>(r, nv, hi, m);
  const int cnt1 = (int)__reduce_add_sync(0xffffffffu, c);
  const float upper = warp_min(m);
  return 0.5f * (x1 + (cnt1 >= r2 ? x1 : upper));
}

// Step 4 of v4 on a register row: the renorm sums and the chi^2 over the tail tile tb
// (this lane's column of its kRegTailRows rows), the warp's chi^2 sum in every lane.  The
// lane's slots past its nv points compute on the padding and are left out by selects, so
// the sums take v3's operations in v3's order.  kRecip: the reciprocal dial as a
// compile-time constant (the production 2 or the exact 0), so that no Newton loop runs
// inside the unrolled sweeps.
template <int kRecip>
__device__ __forceinline__ float reg_tail(const float (&r)[kRegPoints], int nv, const float* tb,
                                          float alpha) {
  float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
#pragma unroll
  for (int i = 0; i < kRegPoints; ++i) {
    const float* x = tb + 32 * i;
    const bool on = i < nv;
    const float frac = div_dial(x[0], r[i] * alpha, kRecip);
    const float n0 = c0 + frac * x[kRegRowPoints];
    const float n1 = c1 + frac * x[2 * kRegRowPoints];
    const float n2 = c2 + frac * x[3 * kRegRowPoints];
    c0 = on ? n0 : c0;
    c1 = on ? n1 : c1;
    c2 = on ? n2 : c2;
  }
  c0 = warp_sum(c0);
  c1 = warp_sum(c1);
  c2 = warp_sum(c2);
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < kRegPoints; ++i) {
    const float* x = tb + 32 * i;
    const float fitted =
        c0 * x[4 * kRegRowPoints] + c1 * x[5 * kRegRowPoints] + c2 * x[6 * kRegRowPoints];
    const float target = div_dial(x[0], fitted, kRecip);
    // v3's compiled rounding of model - target, spelt out: one fma behind the Newton
    // reciprocal, the rounded product behind the IEEE division
    const float res = kRecip == 0 ? __fsub_rn(__fmul_rn(r[i], alpha), target)
                                  : __fmaf_rn(r[i], alpha, -target);
    const float d = res * x[7 * kRegRowPoints];
    const float n = acc + d * d;
    acc = i < nv ? n : acc;
  }
  return warp_sum(acc);
}

// reg_tail at a dial that no configuration takes (1 or 3 Newton steps), read at run
// time: the row copied to local memory and both sweeps rolled, so that a kernel holds
// two unrolled tails, not three; model - target one fma, as behind the production dial.
__device__ __forceinline__ float reg_tail_rolled(const float (&r)[kRegPoints], int nv,
                                                 const float* tb, float alpha, int recip) {
  float row[kRegPoints];
#pragma unroll
  for (int i = 0; i < kRegPoints; ++i) row[i] = r[i];
  float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
#pragma unroll 1
  for (int i = 0; i < nv; ++i) {
    const float* x = tb + 32 * i;
    const float frac = div_dial(x[0], row[i] * alpha, recip);
    c0 += frac * x[kRegRowPoints];
    c1 += frac * x[2 * kRegRowPoints];
    c2 += frac * x[3 * kRegRowPoints];
  }
  c0 = warp_sum(c0);
  c1 = warp_sum(c1);
  c2 = warp_sum(c2);
  float acc = 0.0f;
#pragma unroll 1
  for (int i = 0; i < nv; ++i) {
    const float* x = tb + 32 * i;
    const float fitted =
        c0 * x[4 * kRegRowPoints] + c1 * x[5 * kRegRowPoints] + c2 * x[6 * kRegRowPoints];
    const float target = div_dial(x[0], fitted, recip);
    const float d = __fmaf_rn(row[i], alpha, -target) * x[7 * kRegRowPoints];
    acc += d * d;
  }
  return warp_sum(acc);
}

// Step 1 for the block: the union of its walkers' grid rows, each warp's list mapped to
// slots, the slot -> grid index map and the staging counter.  Returns U.
__device__ __forceinline__ int stage_union(const StageArea& sa, bool counted, int NO, int L,
                                           int* lo) {
  const int lane = threadIdx.x & 31;
  const int nwords = (NO + 31) / 32;
  for (int k = lane; k < L; k += 32) atomicOr(&sa.mask[lo[k] >> 5], 1u << (lo[k] & 31));
  if (lane == 0 && counted) atomicAdd(&sa.misc[0], L);
  __syncthreads();
  int U = 0;
  for (int q = 0; q < nwords; ++q) U += __popc(sa.mask[q]);
  for (int k = lane; k < L; k += 32) {  // grid index -> slot, in place
    const int o = lo[k];
    int s = __popc(sa.mask[o >> 5] & ((1u << (o & 31)) - 1u));
    for (int q = 0; q < (o >> 5); ++q) s += __popc(sa.mask[q]);
    lo[k] = s;
  }
  for (int o = threadIdx.x; o < NO; o += blockDim.x) {
    const unsigned m = sa.mask[o >> 5];
    if (m & (1u << (o & 31))) {
      int s = __popc(m & ((1u << (o & 31)) - 1u));
      for (int q = 0; q < (o >> 5); ++q) s += __popc(sa.mask[q]);
      sa.urow[s] = o;
    }
  }
  if (threadIdx.x == 0 && sa.rows != nullptr) {
    atomicAdd(sa.rows, (unsigned long long)U);
    atomicAdd(sa.rows + 1, (unsigned long long)sa.misc[0]);
    atomicAdd(sa.rows + 2, 1ull);
  }
  __syncthreads();  // urow and every warp's slots are written
  return U;
}

// Steps 2-4 of v4 for the calling warp's walker, its list lo (slots) / lw of L entries,
// the row in registers; every warp of the block calls it.  Every lane returns the chi^2.
__device__ inline float spectrum_reg(const StageArea& sa, int U, int L, const int* lo,
                                     const float* lw, float av, const float* __restrict__ D,
                                     int nd, const float* __restrict__ kd,
                                     const float* __restrict__ data,
                                     const float* __restrict__ inv_err,
                                     const float* __restrict__ VpinvT,
                                     const float* __restrict__ VT, float med_data, int iters,
                                     int recip, const SpecStat st) {
  const int lane = threadIdx.x & 31;
  RegSweeps rs;
  rs.D = D;
  rs.kd = kd;
  rs.data = data;
  rs.inv_err = inv_err;
  rs.VpinvT = VpinvT;
  rs.VT = VT;
  rs.urow = sa.urow;
  rs.nd = nd;
  rs.U = U;
  rs.rb = sa.stage / kRegTilePoints;
  rs.ng = (U + rs.rb) / rs.rb;  // ceil((U + 1) / rb)
  rs.vec = (nd & 3) == 0 && aligned16(D) && aligned16(kd) && aligned16(data) &&
           aligned16(inv_err) && aligned16(VpinvT) && aligned16(VT);

  const bool extinct = av > 0.0f;
  const float ak = kLn10x04 * av;
  float r[kRegPoints];  // r[i]: the point lane + 32 i
#pragma unroll
  for (int i = 0; i < kRegPoints; ++i) r[i] = 0.0f;

  // 2. the row build: each point's fmaf chain over the list in list order, then kd
  rs.issue(0, sa.ring);
  int k = 0;
#pragma unroll
  for (int t = 0; t < kRegTiles; ++t) {
    int e = 0;  // the walker's next list entry
    for (int g = 0; g < rs.ng; ++g, ++k) {
      cp_async_wait_all();
      __syncthreads();  // tile k is in; every warp is done with the other buffer
      rs.issue(k + 1, sa.ring + ((k + 1) & 1) * sa.stage);
      if (t * kRegTilePoints < nd) {
        const float* buf = sa.ring + (k & 1) * sa.stage + lane;
        const int s0 = g * rs.rb, s1 = min(U + 1, s0 + rs.rb);  // the group's slots
        for (; e < L && lo[e] < s1; ++e) {
          const float wk = lw[e];
          const float* dp = buf + (lo[e] - s0) * kRegTilePoints;
#pragma unroll
          for (int q = 0; q < kRegTileSlots; ++q)
            r[t * kRegTileSlots + q] = fmaf(wk, dp[32 * q], r[t * kRegTileSlots + q]);
        }
        if (extinct && s1 == U + 1) {  // the group holds kd
          const float* kdt = buf + (U - s0) * kRegTilePoints;
#pragma unroll
          for (int q = 0; q < kRegTileSlots; ++q)
            r[t * kRegTileSlots + q] = r[t * kRegTileSlots + q] * expf(ak * kdt[32 * q]);
        }
      }
    }
  }

  // 3. the median over the lane's nv points, the padding above every bracket bound
  const int nv = (nd - lane + 31) >> 5;
#pragma unroll
  for (int i = 0; i < kRegPoints; ++i)
    if (i >= nv) r[i] = __int_as_float(0x7fffffff);
  const float alpha = med_data / row_median_reg(r, nv, st.r1, st.r2, iters);

  // 4. the renorm sums and the chi^2 over the tail tile, in v3's j order
  cp_async_wait_all();
  __syncthreads();  // the tail tile is in
  const float* tb = sa.ring + (k & 1) * sa.stage + lane;
  const float tot = recip == 2   ? reg_tail<2>(r, nv, tb, alpha)
                    : recip == 0 ? reg_tail<0>(r, nv, tb, alpha)
                                 : reg_tail_rolled(r, nv, tb, alpha, recip);
  return st.mean ? tot / (float)nd : tot * st.inv_n;
}

// K2 for the calling warp's walker; every warp of the block calls it, with
// block-uniform tables.  wc: the walker's NO blend weights; row / lo / lw its
// slice of dynamic shared memory as in spectrum_warp (row unused by v4); `counted`
// false for a warp past the ragged end (its list is the last walker's again: no new
// row, and it stays out of the counter).  The renorm is on (K1 and K5).  nd <=
// 32 kRegPoints takes v4 (spectrum_reg), a wider row v3.  Every lane returns the chi^2.
__device__ inline float spectrum_staged(const StageArea& sa, bool counted, const float* wc,
                                        float av, const float* __restrict__ D, int NO, int nd,
                                        const float* __restrict__ kd,
                                        const float* __restrict__ data,
                                        const float* __restrict__ inv_err,
                                        const float* __restrict__ VpinvT,
                                        const float* __restrict__ VT, float med_data, int iters,
                                        int recip, const SpecStat st, float* row, int* lo,
                                        float* lw) {
  const int lane = threadIdx.x & 31;
  const int nwords = (NO + 31) / 32;
  if (threadIdx.x < nwords) sa.mask[threadIdx.x] = 0u;
  if (threadIdx.x == 0) sa.misc[0] = 0;
  const int L = compact_weights(wc, NO, lo, lw);
  __syncthreads();  // the mask is clear; every warp has its list
  const int U = stage_union(sa, counted, NO, L, lo);
  if (stage_reg_row(nd))
    return spectrum_reg(sa, U, L, lo, lw, av, D, nd, kd, data, inv_err, VpinvT, VT, med_data,
                        iters, recip, st);

  // v3: the tiles, the widest multiple of 32 points whose rows fit a buffer, at most nd
  const int nd32 = (nd + 31) & ~31;
  StageSweeps sw;
  sw.D = D;
  sw.kd = kd;
  sw.data = data;
  sw.inv_err = inv_err;
  sw.VpinvT = VpinvT;
  sw.VT = VT;
  sw.urow = sa.urow;
  sw.nd = nd;
  sw.U = U;
  sw.wb = min(nd32, (sa.stage / (U + 1)) & ~31);
  sw.nb = (nd + sw.wb - 1) / sw.wb;
  sw.wt = min(nd32, (sa.stage / 5) & ~31);
  sw.nt = (nd + sw.wt - 1) / sw.wt;
  sw.vec = (nd & 3) == 0 && aligned16(D) && aligned16(kd) && aligned16(data) &&
           aligned16(inv_err) && aligned16(VpinvT) && aligned16(VT);
  const int ntiles = sw.nb + 2 * sw.nt;
  const bool extinct = av > 0.0f;
  const float ak = kLn10x04 * av;
  const int nchunk = L > 0 ? (L + kBuildChunk - 1) / kBuildChunk : 1;
  float alpha = 1.0f, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, acc = 0.0f;
  sw.issue(0, sa.ring);
  for (int k = 0; k < ntiles; ++k) {
    cp_async_wait_all();
    __syncthreads();  // tile k is in; every warp is done with the other buffer
    if (k + 1 < ntiles) sw.issue(k + 1, sa.ring + ((k + 1) & 1) * sa.stage);
    const float* buf = sa.ring + (k & 1) * sa.stage;
    int sweep, j0, n, w;
    sw.tile(k, sweep, j0, n, w);
    if (sweep == 0) {  // 2. the row build, v2's build_row_warp on the tile
      const float* kdt = buf + U * w;
      for (int c = 0; c < nchunk; ++c) {
        const int k0 = c * kBuildChunk;
        const int n_on = min(kBuildChunk, L - k0);
        const bool first = c == 0, last = c == nchunk - 1;
        int off[kBuildChunk];  // the entries' rows in the tile
        float wk[kBuildChunk];
#pragma unroll
        for (int i = 0; i < kBuildChunk; ++i) {
          const bool on = i < n_on;
          off[i] = (on ? lo[k0 + i] : 0) * w;
          wk[i] = on ? lw[k0 + i] : 0.0f;
        }
        for (int x = lane; x < n; x += 32) {
          float v[kBuildChunk];
#pragma unroll
          for (int i = 0; i < kBuildChunk; ++i) v[i] = i < n_on ? buf[off[i] + x] : 0.0f;
          float a = first ? 0.0f : row[j0 + x];
#pragma unroll
          for (int i = 0; i < kBuildChunk; ++i)
            if (i < n_on) a = fmaf(wk[i], v[i], a);
          if (last && extinct) a = a * expf(ak * kdt[x]);
          row[j0 + x] = a;
        }
      }
      if (k == sw.nb - 1) {  // 3. the row is whole: the median
        __syncwarp();
        alpha = med_data / row_median_warp(row, nd, st.r1, st.r2, iters);
      }
    } else if (sweep == 1) {  // 4a. the renorm sums
      const float* Vp = buf + w;
#pragma unroll 4
      for (int x = lane; x < n; x += 32) {
        const float frac = div_dial(buf[x], row[j0 + x] * alpha, recip);
        c0 += frac * Vp[x];
        c1 += frac * Vp[w + x];
        c2 += frac * Vp[2 * w + x];
      }
      if (k == sw.nb + sw.nt - 1) {
        c0 = warp_sum(c0);
        c1 = warp_sum(c1);
        c2 = warp_sum(c2);
      }
    } else {  // 4b. the chi^2
      const float* V = buf + w;
      const float* ie = buf + 4 * w;
#pragma unroll 4
      for (int x = lane; x < n; x += 32) {
        const float model = row[j0 + x] * alpha;
        const float fitted = c0 * V[x] + c1 * V[w + x] + c2 * V[2 * w + x];
        const float target = div_dial(buf[x], fitted, recip);
        const float r = (model - target) * ie[x];
        acc += r * r;
      }
    }
  }
  const float tot = warp_sum(acc);
  return st.mean ? tot / (float)nd : tot * st.inv_n;
}

}  // namespace mcmc_spec
