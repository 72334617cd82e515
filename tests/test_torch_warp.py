"""PyTorch port: the one-warp-per-walker K1 and K3 (CPU).

* ``walkers_per_block``: how many walkers (warps) a block of the
  spectrum-chi^2 kernel K3 (and K1's v2 body in S15) holds, from the shared
  memory one walker needs (``warp_smem_bytes``, the twin of
  ``warp_smem_floats`` in ``csrc/spectrum_warp.cuh``); ``staged_block``, the
  walkers and tile buffers of a block of K1 and K5 (``staged_smem_bytes``,
  the twin of ``staged_smem_floats`` in ``csrc/spectrum_stage.cuh``), v4's
  (each row in registers, nd <= 1,792) and v3's (each row in shared memory).
* The ``matmul_passes`` receipt: the port computes the full f32 ``Wcomb @ D``
  at every dial; K1's plain version at the production dials (14, 3, 2)
  against the JAX kernel in interpret mode at (14, 3, 2), whose split-bf16
  product drops three terms, and at (14, 6, 2).
"""
import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mcmc_spec_tpu.bench_target import build_bench_target as jax_build_bench_target  # noqa: E402
from mcmc_spec_tpu.ops import pallas_kernels as pk  # noqa: E402
from mcmc_spec_tpu_torch.bench_target import build_bench_target  # noqa: E402
from mcmc_spec_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from mcmc_spec_tpu_torch.runtime import cuda_build  # noqa: E402

NO = 14 * 4  # the bench grid: 14 Teff x 4 logg
# K1 holds Wcomb and nspec scaled components per walker; K3 no weight row
WEIGHT_ROWS = {"K1 nspec=2": 3, "K1 nspec=3": 4, "K3": 0}


@pytest.mark.parametrize("kernel", sorted(WEIGHT_ROWS))
@pytest.mark.parametrize("nd", [400, 401, 1791, 1792, 4096, 32768])
def test_walkers_per_block_is_the_most_that_fit(nd, kernel):
    rows = WEIGHT_ROWS[kernel]
    per = ck.warp_smem_bytes(nd, NO, rows)
    wpb = ck.walkers_per_block(nd, NO, rows)
    assert 1 <= wpb <= ck.WALKERS_MAX
    assert wpb * per <= ck.ROW_SMEM_BYTES
    assert wpb == ck.WALKERS_MAX or (wpb + 1) * per > ck.ROW_SMEM_BYTES
    # each part of a walker's slice starts on 16 bytes, so the next walker's row does too
    assert per % 16 == 0 and per >= 4 * (nd + (rows + 2) * NO)


def test_walkers_per_block_at_the_main_path_shapes():
    """8 walkers a block at the bench row and at LARGE_ND; one at nd = 32,768."""
    for nd in (1792, 4096):
        assert ck.walkers_per_block(nd, NO, 3) == ck.walkers_per_block(nd, NO, 0) == 8
    assert ck.warp_smem_bytes(1792, NO, 3) == 8288 and ck.warp_smem_bytes(1792, NO, 0) == 7616
    assert ck.walkers_per_block(32768, NO, 3) == ck.walkers_per_block(32768, NO, 0) == 1


@pytest.mark.parametrize("rows", [0, 3, 4])
def test_walkers_per_block_raises_where_one_walker_does_not_fit(rows):
    largest = (ck.ROW_SMEM_BYTES // 4 - (rows + 2) * NO) // 4 * 4
    assert ck.walkers_per_block(largest, NO, rows) == 1
    with pytest.raises(ValueError, match="shared memory"):
        ck.walkers_per_block(largest + 4, NO, rows)
    with pytest.raises(ValueError, match="shared memory"):
        ck.walkers_per_block(65536, NO, rows)


def test_warp_smem_bytes_mirrors_the_header():
    """The Python size is the header's ``warp_smem_floats`` times 4, and the header
    and the three kernels that size their blocks with it (K1, K3, K5) are part of
    the build."""
    src = (cuda_build.CSRC / "spectrum_warp.cuh").read_text()
    body = re.search(r"warp_smem_floats\(int nd, int NO, int weight_rows\) \{\s*return ([^;]+);",
                     src)
    assert body and body.group(1) == "round4(nd) + round4((weight_rows + 2) * NO)"
    assert "spectrum_warp.cuh" in cuda_build.HEADERS
    for kernel in ("log_posterior_fused.cu", "spectrum_chi2.cu", "log_posterior_fleet_fused.cu"):
        assert kernel in cuda_build.SOURCES
        assert '#include "spectrum_warp.cuh"' in (cuda_build.CSRC / kernel).read_text()
    assert ck._SIGNATURES["log_posterior_fused_launch"][-2] is ck._I
    assert ck._SIGNATURES["spectrum_chi2_launch"][-2] is ck._I
    assert ck._SIGNATURES["log_posterior_fleet_fused_launch"][-2] is ck._I


# ---------------------------------------------------------------------------
# K1 and K5 v3/v4: the block's layout (csrc/spectrum_stage.cuh)


def _stage_bounds(nd, rows):
    """(least, most) ``stage`` of a block: v4's tail tile and its build tile of every grid
    row and kd; v3's build tile of 32 points of every row and kd and its tile of the whole
    row of every row."""
    if ck.staged_reg_row(nd):
        least = ck.REG_TAIL_ROWS * 32 * ck.REG_POINTS
        return least, max(least, (NO + 1) * ck.REG_TILE_POINTS)
    return 32 * (NO + 1), (NO + 1) * ((nd + 31) // 32 * 32)


def test_staged_smem_bytes_mirrors_the_header():
    """``staged_smem_bytes`` is the header's ``staged_smem_floats`` times 4: the warps'
    slices (without the row for v4), the union (mask, slot map, list lengths) and two
    tile buffers; K1, K5 and S13 size their blocks with it and take the counter, the
    tile size and the walkers a block last, before the stream."""
    src = (cuda_build.CSRC / "spectrum_stage.cuh").read_text()
    floats = re.search(r"staged_smem_floats\(int nd, int NO, int weight_rows, int wpb,\s*"
                       r"int stage\) \{\s*return ([^;]+);", src)
    assert floats and " ".join(floats.group(1).split()) == (
        "wpb * stage_warp_floats(nd, NO, weight_rows) + stage_union_words(NO) + 2 * stage")
    union = re.search(r"stage_union_words\(int NO\) \{\s*return ([^;]+);", src)
    assert union and union.group(1) == "round4((NO + 31) / 32) + round4(NO) + 4"
    assert "spectrum_stage.cuh" in cuda_build.HEADERS
    assert re.search(r"kStagedWalkersMax = (\d+);", src).group(1) == str(ck.WALKERS_MAX_STAGED)
    for nd, rows, wpb, stage in ((1792, 3, 16, 12320), (401, 4, 3, 960), (4096, 3, 12, 2624)):
        union_words = (1 + 3) // 4 * 4 + (NO + 3) // 4 * 4 + 4  # NO = 56: two mask words
        row = 0 if ck.staged_reg_row(nd) else (nd + 3) // 4 * 4
        assert ck.staged_warp_bytes(nd, NO, rows) == 4 * (row + ((rows + 2) * NO + 3) // 4 * 4)
        assert ck.staged_smem_bytes(nd, NO, rows, wpb, stage) == (
            wpb * ck.staged_warp_bytes(nd, NO, rows) + 4 * (union_words + 2 * stage))
    for kernel in ("log_posterior_fused.cu", "log_posterior_fleet_fused.cu", "posterior_ablate.cu"):
        assert "staged_smem_floats(nd, NO, 1 + nspec, wpb, stage)" in (
            cuda_build.CSRC / kernel).read_text()
    for name in ("log_posterior_fused_launch", "log_posterior_fleet_fused_launch"):
        assert ck._SIGNATURES[name][-5:] == [ck._F, ck._P, ck._I, ck._I, ck._P]


def test_staged_block_at_the_main_path_shapes():
    """16 walkers a block, one block an SM, at the bench row (the cells' nd, v4: each
    buffer a build tile of all 56 grid rows and kd); 12 at nd = 4,096 (the largest row the
    dispatch gives K1, v3), with the rest of the block's shared memory in its two tile
    buffers."""
    assert ck.staged_block(1792, NO, 3) == (16, 25536)
    assert ck.staged_block(1792, NO, 4) == (16, 25536)
    assert ck.staged_block(4096, NO, 3) == (12, 2624)
    for nd, rows in ((1792, 3), (4096, 3)):
        wpb, stage = ck.staged_block(nd, NO, rows)
        assert ck.staged_smem_bytes(nd, NO, rows, wpb, stage) <= ck.ROW_SMEM_BYTES
        assert ck.stage_floats(nd, NO, rows, wpb)[0] == 1


@pytest.mark.parametrize("rows", [3, 4])
@pytest.mark.parametrize("nd", [96, 400, 401, 1791, 1792, 4096, 8000])
def test_staged_block_is_the_largest_that_fits(nd, rows):
    """The block's tile buffers take its smallest tiles (v4: the tail tile; v3: a build
    tile of 32 points of every grid row and kd and a tail tile of 5 rows); a block of one
    walker more would not fit; the tiles' size is a multiple of 32 floats and at most
    ``_stage_bounds``' most."""
    wpb, stage = ck.staged_block(nd, NO, rows)
    least, most = _stage_bounds(nd, rows)
    assert 1 <= wpb <= ck.WALKERS_MAX_STAGED
    assert stage % 32 == 0 and least <= stage <= most
    assert ck.staged_smem_bytes(nd, NO, rows, wpb, stage) <= ck.ROW_SMEM_BYTES
    if wpb < ck.WALKERS_MAX_STAGED:
        assert ck.staged_smem_bytes(nd, NO, rows, wpb + 1, least) > ck.ROW_SMEM_BYTES
    for w in range(1, ck.WALKERS_MAX_STAGED + 1):  # every block size the sweep may ask for
        per_sm, st = ck.stage_floats(nd, NO, rows, w)
        if per_sm:
            assert ck.staged_block(nd, NO, rows, w) == (w, st)
            block = ck.staged_smem_bytes(nd, NO, rows, w, st) + ck.BLOCK_RESERVED_BYTES
            assert per_sm * block <= ck.SM_SMEM_BYTES and st % 32 == 0
        else:
            with pytest.raises(ValueError, match="walkers a block"):
                ck.staged_block(nd, NO, rows, w)


def test_staged_block_raises_where_no_block_fits():
    nd = ck.warp_max_nd(NO, 3)  # one walker's row fills a block: no room for the tiles
    with pytest.raises(ValueError, match="shared memory"):
        ck.staged_block(nd, NO, 3)
    for bad in (0, 17, 2.5):
        with pytest.raises(ValueError, match="walkers a block"):
            ck.staged_block(1792, NO, 3, bad)


MATMUL_DIAL3_RTOL = 3e-4  # the JAX docstring's figure for dial 3 (pallas_kernels._dot_f32)


def test_matmul_passes_receipt():
    """K1's plain version (full f32 product) at (14, 3, 2) on a bench-shaped target
    (nd = 400, grid_step = 8), 512 numpy-seeded walkers around the truth: within 3e-4
    relative of JAX's split-bf16 dial 3 on every walker, and in the kernel gate (rtol
    5e-5, atol 1e-4 max|ref|) of JAX's dial 6.  The port's dial is inert: 3 and 6 give
    the same bits."""
    jt, truth = jax_build_bench_target(jnp.float32, nd=400, grid_step=8.0)
    tt, _ = build_bench_target(torch.float32, device="cpu", nd=400, grid_step=8.0)
    rng = np.random.RandomState(7)
    scale = np.concatenate([np.full(2, 50.0), [0.02], np.full(2, 0.02), [0.02e-3]])
    P = (np.asarray(truth) + rng.randn(512, 6) * scale).astype(np.float32)
    dials = dict(median_iters=14, recip_newton=2)
    got = ck.log_posterior_fused_reference(
        torch.from_numpy(P), dataclasses.replace(tt, matmul_passes=3, **dials)).numpy()
    same = ck.log_posterior_fused_reference(
        torch.from_numpy(P), dataclasses.replace(tt, matmul_passes=6, **dials)).numpy()
    np.testing.assert_array_equal(got, same)
    rel = {}
    for mm in (3, 6):
        ref = np.asarray(pk.log_posterior_fused(
            jnp.asarray(P), dataclasses.replace(jt, matmul_passes=mm, **dials), interpret=True))
        assert np.isfinite(ref).all() and np.isfinite(got).all()
        rel[mm] = float((np.abs(got - ref) / np.abs(ref)).max())
        if mm == 3:
            np.testing.assert_allclose(got, ref, rtol=MATMUL_DIAL3_RTOL, atol=0)
        else:
            np.testing.assert_allclose(got, ref, rtol=5e-5, atol=1e-4 * np.abs(ref).max())
    print(f"max rel diff against JAX dial 3: {rel[3]:.3e}, dial 6: {rel[6]:.3e}")
