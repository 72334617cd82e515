"""PyTorch port: the tiling of the large-nd model build K6 v2 (CPU).

K6 v2 (``csrc/model_extinct.cu``) writes ``model = (Wcomb @ D) * extinction``
block by block: a block stages the rows of D over ``MODEL_TILE_P`` points
(``model_tile_rows`` of them; the kernel reads any others from device memory)
and serves a chunk of ``MODEL_CHUNK_W`` walkers from them, each walker over
its compact list of non-zero weights, ascending in the grid index o, as an
``fmaf`` chain from +0.  There is no card here, so a numpy rendering of that
tiling stands in for it:

* its chain over the list equals, bit for bit, the same chain over all NO
  weights (v1's dense chain), for finite D: ``fma(0, d, acc)`` is ``acc``.  The
  chain rounds each step to float32 from a float64 ``w * d + acc`` (the
  product is exact in float64; the sum is rounded twice, to float64 and to
  float32, the same on both sides, so the comparison holds what the skip does,
  not the card's single rounding);
* it equals ``model_extinct_reference`` and the JAX ``model_extinct`` in
  interpret mode within ``tests/test_torch_segmented.py``'s K6 tolerance (rtol
  3e-6, atol 1e-9), at nd = 4,096 and 4,095, an odd NW, a binary's 8 weights
  and a triple's 12, with all rows staged and with rows read past the staged
  ones;
* the precondition is pinned: a non-finite D under a zero weight is where the
  skip and a dense product differ.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mcmc_spec_tpu import bench_target as jbench  # noqa: E402
from mcmc_spec_tpu.inference import batched as jb  # noqa: E402
from mcmc_spec_tpu.ops import spec_segmented as jseg  # noqa: E402
from mcmc_spec_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from mcmc_spec_tpu_torch.ops import spec_segmented as seg  # noqa: E402
from mcmc_spec_tpu_torch.runtime import cuda_build  # noqa: E402
from tests.test_torch_fleet_k4 import _c_signature  # noqa: E402

K6_RTOL, K6_ATOL = 3e-6, 1e-9  # tests/test_torch_segmented.py's K6 tolerance
LN10_04 = np.float32(ck.LN10_04)


def fma32(w, d, acc):
    """float32(w * d + acc), the product exact in float64 (the chain's step)."""
    return (np.float64(w) * d.astype(np.float64) + acc.astype(np.float64)).astype(np.float32)


def tiled_model(W, av, D, kd, rows=None, dense=False):
    """K6 v2's tiling in numpy: point tiles x walker chunks, the staged rows (zeros past
    nd) or, past them, D's own row; per walker its non-zero weights (a NaN stays) in
    ascending o, or with ``dense`` all NO weights; the extinction epilogue; the masked
    write.  [NW, nd] float32."""
    NW, NO = W.shape
    nd = D.shape[1]
    rows = seg.model_tile_rows(NO) if rows is None else rows
    TP, CW = seg.MODEL_TILE_P, seg.MODEL_CHUNK_W
    out = np.full((NW, nd), np.nan, np.float32)
    for c0 in range(0, NW, CW):  # walker chunks
        for j0 in range(0, nd, TP):  # point tiles
            tile = np.zeros((NO, TP), np.float32)
            tile[:, :min(TP, nd - j0)] = D[:, j0:j0 + TP]
            staged = tile[:rows]
            for w in range(c0, min(c0 + CW, NW)):
                ws = W[w]
                order = range(NO) if dense else np.flatnonzero(ws != 0)  # NaN != 0
                acc = np.zeros(TP, np.float32)
                for o in order:
                    acc = fma32(ws[o], staged[o] if o < rows else tile[o], acc)
                if av[w] > 0:
                    kdt = np.zeros(TP, np.float32)
                    kdt[:min(TP, nd - j0)] = kd[j0:j0 + TP]
                    acc = acc * np.exp(np.float32(LN10_04 * av[w]) * kdt)
                n = min(TP, nd - j0)
                out[w, j0:j0 + n] = acc[:n]
    return out


def lane_inputs(nd, nw, nspec=2, seed=1):
    """The lane's K6 inputs ([NW, NO] Wcomb, [NW] av, [NO, nd] D, [nd] kd) as numpy
    float32, from the JAX bench target and its seeded walker cloud, handed over as numpy
    arrays."""
    jt, truth = jbench.build_bench_target(jnp.float32, nd=nd, grid_step=8.0, nspec=nspec)
    coords = np.asarray(jbench.init_walker_batch(jt, truth, nw, jnp.float32, seed=seed))
    *_, Wcomb = jb._forward_small(jnp.asarray(coords, jnp.float32), jt)
    nT, nG, _ = jt.D.shape
    f = lambda x: np.asarray(x, np.float32)
    av = f(coords[:, jt.nspec]).copy()
    av[0] = 0.0  # no extinction where av <= 0
    return f(Wcomb), av, f(jt.D).reshape(nT * nG, nd), f(jt.ext_k_data)


@pytest.fixture(scope="module")
def binary4096():
    return lane_inputs(4096, 9)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_tiling_constants_match_the_kernel():
    src = (cuda_build.CSRC / "model_extinct.cu").read_text()
    assert re.search(r"constexpr int kTileP = (\d+);", src).group(1) == str(seg.MODEL_TILE_P)
    assert re.search(r"constexpr int kChunkW = (\d+);", src).group(1) == str(seg.MODEL_CHUNK_W)
    assert ck._SIGNATURES["model_extinct_launch"] == _c_signature("model_extinct_launch")
    # Wcomb, av, D, kd, out; NW, NO, nd, the staged rows; the stream
    assert ck._SIGNATURES["model_extinct_launch"] == [ck._P] * 5 + [ck._I] * 4 + [ck._P]
    assert "__syncthreads" in src and src.count("__syncthreads") == 1


@pytest.mark.parametrize("NO,rows", [(56, 56), (12, 12), (226, 226), (227, 226), (300, 226)])
def test_staged_rows_fit_a_block(NO, rows):
    assert seg.model_tile_rows(NO) == rows
    assert 4 * seg.MODEL_TILE_P * seg.model_tile_rows(NO) <= ck.ROW_SMEM_BYTES


@pytest.mark.parametrize("nd", [4096, 4095])
@pytest.mark.parametrize("rows", [None, 20])
def test_skip_is_bit_for_bit_the_dense_chain(binary4096, nd, rows):
    """The chain over the non-zero weights and the chain over all 56, rounded at every
    step, on the binary's real weights (at most 8 non-zero) and finite D."""
    W, av, D, kd = binary4096
    D, kd = D[:, :nd].copy(), kd[:nd].copy()
    assert 0 < np.count_nonzero(W, axis=1).max() <= 8
    skip = tiled_model(W, av, D, kd, rows)
    dense = tiled_model(W, av, D, kd, rows, dense=True)
    assert np.array_equal(skip.view(np.int32), dense.view(np.int32))
    assert np.isfinite(skip).all()


def test_skip_is_exact_through_cancellation():
    """Signed weights and D on a few values, so partial sums cancel to exact zeros: the
    chain never reaches -0, and fma(0, d, +0) is +0, so the two chains agree bit for
    bit, zeros included."""
    rng = np.random.default_rng(3)
    NW, NO, nd = 7, 40, 300
    W = rng.choice([0.0, 0.0, 0.0, 1.0, -1.0, 2.0], (NW, NO)).astype(np.float32)
    D = rng.choice([-3.0, -1.0, -0.0, 0.0, 1.0, 3.0], (NO, nd)).astype(np.float32)
    kd, av = np.ones(nd, np.float32), np.zeros(NW, np.float32)
    skip = tiled_model(W, av, D, kd, rows=16)
    dense = tiled_model(W, av, D, kd, rows=16, dense=True)
    assert (skip == 0).any()
    assert np.array_equal(skip.view(np.int32), dense.view(np.int32))
    assert not np.signbit(skip[skip == 0]).any()


@pytest.mark.parametrize("nd,nw,nspec", [(4096, 9, 2), (4095, 9, 2), (4096, 5, 3),
                                         (4095, 13, 3)])
def test_tiling_matches_reference_and_pallas(nd, nw, nspec):
    """An odd NW (a ragged walker chunk), nd = 4,096 and 4,095 (a ragged point tile),
    binaries (8 weights) and triples (12)."""
    W, av, D, kd = lane_inputs(nd, nw, nspec=nspec, seed=2)
    assert 0 < np.count_nonzero(W, axis=1).max() <= 4 * nspec
    got = tiled_model(W, av, D, kd)
    ref = seg.model_extinct_reference(_t(W), _t(av), _t(D), _t(kd)).numpy()
    np.testing.assert_allclose(got, ref, rtol=K6_RTOL, atol=K6_ATOL)
    want = np.asarray(jseg.model_extinct(W, av, D, kd, 6, interpret=True))
    np.testing.assert_allclose(got, want, rtol=K6_RTOL, atol=K6_ATOL)
    # rows past the staged ones come from D itself: the same bits
    assert np.array_equal(tiled_model(W, av, D, kd, rows=3).view(np.int32), got.view(np.int32))


def test_a_nan_weight_stays_in_the_list(binary4096):
    W, av, D, kd = (x.copy() for x in binary4096)
    W[3, 50] = np.nan
    got = tiled_model(W, av, D[:, :600], kd[:600])
    ref = seg.model_extinct_reference(_t(W), _t(av), _t(D[:, :600]), _t(kd[:600])).numpy()
    assert np.isnan(got[3]).all() and np.isnan(ref[3]).all()
    np.testing.assert_allclose(np.delete(got, 3, 0), np.delete(ref, 3, 0), rtol=K6_RTOL,
                               atol=K6_ATOL)


@pytest.mark.parametrize("bad", [np.inf, np.nan])
def test_non_finite_d_under_a_zero_weight_is_the_precondition(binary4096, bad):
    """Where D holds inf or NaN under a zero weight, the dense product (v1's chain, the
    plain version, the JAX kernel) gives NaN and the skip does not: K1/K3's rule."""
    W, av, D, kd = binary4096
    D, kd = D[:, :512].copy(), kd[:512]
    o = int(np.flatnonzero(W[0] == 0)[0])
    D[o, 7] = bad
    skip = tiled_model(W, av, D, kd)
    with np.errstate(invalid="ignore"):  # 0 * inf
        dense = tiled_model(W, av, D, kd, dense=True)
    ref = seg.model_extinct_reference(_t(W), _t(av), _t(D), _t(kd)).numpy()
    zero = W[:, o] == 0
    assert np.isfinite(skip[zero, 7]).all()
    assert np.isnan(dense[zero, 7]).all() and np.isnan(ref[zero, 7]).all()
    # everywhere else the two agree bit for bit
    keep = np.ones_like(skip, bool)
    keep[:, 7] = False
    assert np.array_equal(skip[keep].view(np.int32), dense[keep].view(np.int32))
