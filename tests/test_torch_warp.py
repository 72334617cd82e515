"""PyTorch port: the one-warp-per-walker K1 and K3 (CPU).

* ``walkers_per_block``: how many walkers (warps) a block of the fused
  posterior K1 or the spectrum-chi^2 kernel K3 holds, from the shared memory
  one walker needs (``warp_smem_bytes``, the twin of ``warp_smem_floats`` in
  ``csrc/spectrum_warp.cuh``).
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
