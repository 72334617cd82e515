// The spectrum body of the fused posteriors K1 (log_posterior_fused.cu) and K5
// (log_posterior_fleet_fused.cu), v3: one warp per walker as in v2
// (spectrum_warp.cuh), with the target's tables read once per block through
// shared-memory tiles instead of once per warp.
//
// What bounded v2: every warp read its walker's D rows (8 at the production
// weights), kd, data (twice), inv_err and the 3 + 3 continuum rows from L2 on
// its own: 18 rows of nd floats a walker, though the 10 table rows are the same
// for every walker of a target and a block's walkers, a cloud in the grid,
// share most of their D rows.  Here the block reads each of them from L2 once:
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
// Block barriers sit at the tile boundaries, so every warp of the block takes
// part in the copies and barriers: the caller gives a warp past the ragged end
// the block's last walker again and drops its result.  The walkers of a block
// are one target's (K5 gives each target its own row of blocks).
// What bounds it (PERF.md, an H100 at the koi2298 shapes): not L2 any more.  A
// block of 16 walkers stages ~12 D rows (~21 in the fleet) for the ~128 its
// walkers read, and the 10 table rows once, yet the launch fell only ~11 %
// (K1) and ~8 % (K5) against v2: the row build still loads one operand per
// weight per point, now from shared memory, the median sweeps the row 14 times
// from shared memory, the tail divides twice a point, and the block's warps
// wait for each other at the tile barriers, with one block of 16 warps an SM
// (each warp's row is 7 KB of shared memory) where v2 ran 24 warps.
#pragma once

#include "spectrum_warp.cuh"

namespace mcmc_spec {

constexpr int kStagedWalkersMax = 16;  // walkers (warps) a block of K1/K5 v3 at most

// The block's own part of the v3 layout, in 4-byte words after the warps' slices:
// the NO-bit mask, the slot -> grid index map, and the sum of the list lengths.
__host__ __device__ inline int stage_union_words(int NO) {
  return round4((NO + 31) / 32) + round4(NO) + 4;
}

// The dynamic shared memory of a K1/K5 v3 block, in floats: wpb warps' slices
// (warp_smem_floats), the union, and two tile buffers of `stage` floats each
// (a multiple of 32).  ops/cuda_kernels.py:staged_smem_bytes mirrors it.
__host__ __device__ inline int staged_smem_floats(int nd, int NO, int weight_rows, int wpb,
                                                  int stage) {
  return wpb * warp_smem_floats(nd, NO, weight_rows) + stage_union_words(NO) + 2 * stage;
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
  int* u = reinterpret_cast<int*>(dyn + (size_t)wpb * warp_smem_floats(nd, NO, weight_rows));
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

// K2 v3 for the calling warp's walker; every warp of the block calls it, with
// block-uniform tables.  wc: the walker's NO blend weights; row / lo / lw its
// slice of dynamic shared memory as in spectrum_warp; `counted` false for a warp
// past the ragged end (its list is the last walker's again: no new row, and it
// stays out of the counter).  The renorm is on (K1 and K5).  Every lane returns
// the chi^2.
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

  // 1. the union of the block's grid rows
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

  // the tiles: the widest multiple of 32 points whose rows fit a buffer, at most nd
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
