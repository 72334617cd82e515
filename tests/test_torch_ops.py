"""PyTorch port: device helpers and host ops against the JAX package (CPU).

The radix median, the magic-seed reciprocal and the tent constants must be
bit-equal to the JAX kernels' helpers; the host numpy ops equal the JAX
package's numpy paths.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mcmc_spec_tpu.ops import pallas_kernels as pk  # noqa: E402
from mcmc_spec_tpu.ops.interp import tent_weights as jax_tent_weights  # noqa: E402
from mcmc_spec_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from mcmc_spec_tpu_torch.ops.interp import tent_weights  # noqa: E402


def _median_cases():
    """The rows of tests/test_pallas_kernel.py::TestRadixMedian."""
    rng = np.random.RandomState(0)
    cases = [np.abs(rng.randn(16, 64)) * s for s in (1.0, 1e-15, 1e6)]
    cases.append(np.abs(np.random.RandomState(1).randn(8, 63)))
    cases.append(np.array([[1.0, 2.0, 2.0, 3.0], [5.0, 5.0, 5.0, 5.0]]))
    cases.append(np.array([[0.0, 0.0, 1.0, 2.0]]))
    return [c.astype(np.float32) for c in cases]


MEDIAN_CASES = _median_cases()


@pytest.mark.parametrize("iters", [31, 14])
@pytest.mark.parametrize("case", range(len(MEDIAN_CASES)))
def test_radix_median_bit_equal(case, iters):
    m = MEDIAN_CASES[case]
    want = np.asarray(pk._row_median_nonneg(jnp.asarray(m), iters=iters))
    got = ck._row_median_nonneg(torch.from_numpy(m), iters=iters).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    if iters == 31:
        np.testing.assert_array_equal(got[:, 0], np.median(m, axis=1))


@pytest.mark.parametrize("midpoint", [False, True])
@pytest.mark.parametrize("iters", [31, 20, 14, 8])
def test_order_stat_bits_bit_equal(iters, midpoint):
    m = (np.abs(np.random.RandomState(3).lognormal(0, 2, (32, 257)))).astype(np.float32)
    mi = m.view(np.int32)
    want = np.asarray(pk._row_order_stat_bits(jnp.asarray(mi), 129, iters, midpoint=midpoint))
    got = ck._row_order_stat_bits(torch.from_numpy(mi), 129, iters, midpoint=midpoint).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("newton", [0, 1, 2, 3])
def test_fast_recip_bit_equal(newton):
    mags = np.logspace(-30, 30, 4096) * (1.0 + 0.5 * np.sin(np.arange(4096)))
    x = np.concatenate([mags, -mags, [1.0, -1.0, 3.0e38, -3.0e38]]).astype(np.float32)
    want = np.asarray(pk._fast_recip(jnp.asarray(x), newton))
    got = ck._fast_recip(torch.from_numpy(x), newton).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert np.all(np.sign(got[:-4]) == np.sign(x[:-4]))


@pytest.mark.parametrize("recip", [0, 2])
def test_div_dial_bit_equal(recip):
    rng = np.random.RandomState(4)
    num = rng.randn(64, 33).astype(np.float32)
    den = (rng.randn(64, 33) + 0.1).astype(np.float32)
    want = np.asarray(pk._div(jnp.asarray(num), jnp.asarray(den), recip))
    got = ck._div(torch.from_numpy(num), torch.from_numpy(den), recip).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


NODE_SETS = {
    "temps": np.arange(3000.0, 5601.0, 200.0),
    "loggs": np.array([4.0, 4.5, 5.0, 5.5]),
    "two": np.array([1.0, 30000.0]),
    "irregular": np.sort(np.random.RandomState(5).uniform(0, 10, 37)),
}


@pytest.mark.parametrize("nodes", list(NODE_SETS))
def test_tent_consts_and_weights_bit_equal(nodes):
    x = NODE_SETS[nodes]
    tc_want = np.asarray(pk._tent_consts(jnp.asarray(x)))
    tc_got = ck._tent_consts(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(tc_got, tc_want)
    lo, hi = x.min(), x.max()
    q = np.concatenate([np.linspace(lo - 0.1 * (hi - lo), hi + 0.1 * (hi - lo), 101), x])
    q32 = q.astype(np.float32)[:, None]
    want = np.asarray(jax.jit(pk._tent_w)(jnp.asarray(tc_want), jnp.asarray(q32)))
    got = ck._tent_w(torch.from_numpy(tc_got), torch.from_numpy(q32)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nodes", list(NODE_SETS))
def test_tent_weights_f64(nodes):
    x = NODE_SETS[nodes]
    lo, hi = x.min(), x.max()
    q = np.linspace(lo - 0.2 * (hi - lo), hi + 0.2 * (hi - lo), 257).reshape(257, 1)
    q = np.concatenate([q, np.repeat(x[:, None], 1, axis=1)])
    want = np.asarray(jax.jit(jax_tent_weights)(jnp.asarray(x), jnp.asarray(q)))
    got = tent_weights(torch.from_numpy(x), torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    # and the interpolation identity against np.interp
    ys = np.cos(x)
    np.testing.assert_allclose(got[:, 0, :] @ ys, np.interp(q[:, 0], x, ys), rtol=1e-12,
                               atol=1e-15)


def test_spectrum_block_rows_reference_arithmetic():
    """The plain K2 body at the exact dials equals the sort-based composition
    in f64 arithmetic up to f32 rounding (smoke of the helper wiring)."""
    rng = np.random.RandomState(6)
    NO, nd, B = 8, 96, 5
    W = np.abs(rng.rand(B, NO)).astype(np.float32)
    D = (1.0 + rng.rand(NO, nd)).astype(np.float32)
    kd = rng.rand(nd).astype(np.float32)
    data = (1.0 + 0.1 * rng.randn(nd)).astype(np.float32)
    err = np.full(nd, 0.01, np.float32)
    av = np.array([0.0, 0.1, 0.2, 0.3, -0.1], np.float32)
    x = np.linspace(-1, 1, nd)
    V = np.vander(x, 3, increasing=True)
    Vp = np.linalg.pinv(V)
    got = ck.spectrum_chi2_reference(
        torch.from_numpy(W), torch.from_numpy(av), torch.from_numpy(D), torch.from_numpy(kd),
        torch.from_numpy(data), torch.from_numpy(err), torch.from_numpy(V),
        torch.from_numpy(Vp), float(np.median(data)), iters=31, mm_passes=6, recip=0).numpy()
    model = W.astype(np.float64) @ D
    model = model * np.where(av[:, None] > 0, 10 ** (-0.4 * av[:, None] * kd[None, :]), 1.0)
    model = model * (np.median(data) / np.median(model, axis=1))[:, None]
    frac = data / model
    fitted = (frac @ Vp.T) @ V.T
    want = np.mean(((model - data / fitted) / err) ** 2, axis=1)
    np.testing.assert_allclose(got, want, rtol=2e-4)


def test_host_ops_equal_jax_numpy_paths():
    from mcmc_spec_tpu.ops import continuum as jcont
    from mcmc_spec_tpu.ops import extinction as jext
    from mcmc_spec_tpu.ops import interp as jinterp
    from mcmc_spec_tpu_torch.ops import continuum, extinction, interp

    wl = np.linspace(1000.0, 40000.0, 3001)
    np.testing.assert_array_equal(extinction.ccm89(wl, 1.0), jext.ccm89(wl, 1.0))
    np.testing.assert_array_equal(extinction.ccm89(wl, 0.37, rv=4.0), jext.ccm89(wl, 0.37, rv=4.0))
    src = np.linspace(3000.0, 9000.0, 777)
    dst = np.linspace(3100.0, 8900.0, 333)
    for a, b in zip(interp.interp1d_weights(src, dst), jinterp.interp1d_weights(src, dst)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(continuum.polyfit_renorm_matrix(dst), jcont.polyfit_renorm_matrix(dst)):
        np.testing.assert_array_equal(a, b)


def test_broaden_and_grid_equal_jax():
    from mcmc_spec_tpu.models.synthetic import synthetic_grid as jax_grid
    from mcmc_spec_tpu.ops import broaden as jbroaden
    from mcmc_spec_tpu_torch.models.synthetic import synthetic_grid
    from mcmc_spec_tpu_torch.ops import broaden

    wl = np.arange(6000.0, 7000.0, 0.5)
    flux = 1.0 + np.sin(wl / 7.0)
    for a, b in zip(broaden.instrumental_broaden(wl, flux, 1700),
                    jbroaden.instrumental_broaden(wl, flux, 1700)):
        np.testing.assert_array_equal(a, b)
    kw = dict(specrange=(3000.0, 12000.0), data_window=(6450.0, 8400.0), resolution=1700,
              temps=np.array([3000.0, 3400.0]), loggs=np.array([4.5, 5.0]), step=16.0)
    g, jg = synthetic_grid(**kw), jax_grid(**kw)
    for f in ("temps", "loggs", "wl", "flux"):
        np.testing.assert_array_equal(getattr(g, f), getattr(jg, f))
    np.testing.assert_array_equal(g.interp_spectrum(3210.0, 4.61), jg.interp_spectrum(3210.0, 4.61))


def test_dials_resolve_like_jax(monkeypatch):
    from mcmc_spec_tpu.utils import flags as jflags
    from mcmc_spec_tpu_torch.utils import flags

    for env, values in (("MCMC_SPEC_FAST_MEDIAN", ["", "exact", "1", "14", "25", "31"]),
                        ("MCMC_SPEC_MATMUL_PASSES", ["", "exact", "1", "3", "6"]),
                        ("MCMC_SPEC_FAST_RECIP", ["", "exact", "0", "1", "3"])):
        fn = {"MCMC_SPEC_FAST_MEDIAN": "median_iters", "MCMC_SPEC_MATMUL_PASSES": "matmul_passes",
              "MCMC_SPEC_FAST_RECIP": "recip_newton"}[env]
        for v in values:
            monkeypatch.setenv(env, v)
            assert getattr(flags, fn)() == getattr(jflags, fn)()
        monkeypatch.setenv(env, "99")
        with pytest.raises(ValueError):
            getattr(flags, fn)()
    monkeypatch.delenv("MCMC_SPEC_FAST_MEDIAN")
    monkeypatch.delenv("MCMC_SPEC_MATMUL_PASSES")
    monkeypatch.delenv("MCMC_SPEC_FAST_RECIP")
    assert (flags.median_iters(), flags.matmul_passes(), flags.recip_newton()) == (14, 3, 2)


def test_kernel_dials_validated():
    with pytest.raises(ValueError, match="explicit accuracy dials"):
        ck._require_dials(None, 6, 0)
    for bad in ((0, 3, 2), (14, 4, 2), (14, 3, -1)):
        with pytest.raises(ValueError, match="out of range"):
            ck._require_dials(*bad)
