"""The operation and byte counts and the readers that use them, against hand counts."""
import pytest

from gpubench.harness import counts, readers
from gpubench.harness.bench import Run


def test_spectrum_and_scalar_ops_by_hand():
    # nd = 10, a binary, 3 median bits: per point 2*4*2 + 3 + 2*3 + 19 = 44
    assert counts.spectrum_ops(10, 2, 3) == 440
    # 1 contrast, 2 bands: 2 * (20 + 8*3) + 10*3 + 40 = 158
    assert counts.scalar_ops(1, 2, 2) == 158


def test_cell_counts_by_hand():
    c = counts.Counts([(10, 1, 2)], nspec=2, NO=6, n_mist=5, iters=3)
    assert c.eval_ops() == 598
    # 2 walkers x (6 params + 1 result), the grid 6 x 10, 9 x 10 per point, the band
    # fluxes 6 x 3, MIST 3 x 5, Av 6, the observations 4 x 3: 14 + 201 floats
    assert c.launch_bytes(2, 6) == 4 * 215
    t, by = c.least_seconds(evals=4, launches=2, ndim=6)
    assert by == "bytes" and t == pytest.approx(2 * 860 / counts.PEAK_BYTES_PER_S)


def test_production_counts():
    c = counts.Counts([(1792, 2, 6)], 2, 56, 220, 14)
    assert c.eval_ops() == 1792 * 66 + 288 == 118560
    fleet = counts.Counts([(1792 - 48 * i, 2 - i % 2, 6) for i in range(9)], 2, 56, 220, 14)
    assert fleet.eval_ops() == pytest.approx(sum(
        counts.spectrum_ops(1792 - 48 * i, 2, 14) + counts.scalar_ops(2 - i % 2, 6, 2)
        for i in range(9)) / 9)


def _run(kernels):
    table = {"kernels": kernels, "busy_ms": 3.8, "span_ms": 4.5, "window_ms": 6.0, "gaps": []}
    return Run(trace=table, trace_steps=4, half_batch=16384, ndim=6,
               window={"evals": 32768 * 100, "seconds": 0.1, "steps": 100,
                       "device_seconds": 0.1},
               counts=counts.Counts([(1792, 2, 6)], 2, 56, 220, 14))


def test_readers_on_a_table():
    k1 = {"name": "mcmc_spec::log_posterior_fused_kernel", "launches": 8, "total_ms": 3.52}
    other = {"name": "void at::native::elementwise_kernel", "launches": 120, "total_ms": 0.4}
    run = _run([k1, other])
    ops = 8 * 16384 * 118560
    assert readers.roofline(run, ("log_posterior_fused_kernel",)) == pytest.approx(
        100 * ops / counts.PEAK_F32_PER_S / 3.52e-3)
    assert readers.roofline(run, ("log_posterior_fleet_fused_kernel",)) is None
    assert readers.launches_per_step(run) == 32.0
    # busy 3.8 ms over the 4 traced steps, 0.95 ms a step, against the window's 1 ms a
    # step on the card's clock; the trace's own span, 4.5 ms, is not read
    assert readers.idle(run) == pytest.approx(5.0)
    assert readers.eval_mfu(run) == pytest.approx(100 * 32768e3 * 118560 / counts.PEAK_F32_PER_S)
    assert readers.rate(run) == pytest.approx(32768e3)
    none = Run(trace=None, window=run.window, counts=run.counts)
    assert readers.idle(none) is None and readers.launches_per_step(none) is None
