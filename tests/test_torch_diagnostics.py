"""PyTorch port: the host diagnostics and writers against the JAX package (CPU).

``gelman_rubin``, ``effective_sample_size`` and ``write_samples_streamed`` are
numpy in both packages, so on the same numpy-seeded chains they agree bit for
bit: the same values and the same bytes of ``samples.txt``.
``AvProfile.device_tables`` is compared in float64 on the CPU (rtol 1e-12).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mcmc_spec_tpu.inference import autocorr as jax_autocorr  # noqa: E402
from mcmc_spec_tpu.io import results as jax_results  # noqa: E402
from mcmc_spec_tpu.models.dust import AvProfile as JaxAvProfile  # noqa: E402
from mcmc_spec_tpu_torch.inference import autocorr  # noqa: E402
from mcmc_spec_tpu_torch.io import results  # noqa: E402
from mcmc_spec_tpu_torch.models.dust import AvProfile  # noqa: E402


def _chain(seed, nsteps=400, nw=12, ndim=6, rho=0.9):
    """An AR(1) chain [nsteps, nw, ndim] with a few walkers offset."""
    rng = np.random.RandomState(seed)
    x = np.empty((nsteps, nw, ndim))
    x[0] = rng.randn(nw, ndim)
    for t in range(1, nsteps):
        x[t] = rho * x[t - 1] + np.sqrt(1 - rho ** 2) * rng.randn(nw, ndim)
    x[:, :2] += 0.3
    return x


@pytest.mark.parametrize("seed,nsteps,dtype", [(0, 400, np.float64), (1, 257, np.float32),
                                               (2, 64, np.float64)])
def test_gelman_rubin_and_ess_match_jax_bit_for_bit(seed, nsteps, dtype):
    chain = _chain(seed, nsteps).astype(dtype)
    r_jax, r = jax_autocorr.gelman_rubin(chain), autocorr.gelman_rubin(chain)
    np.testing.assert_array_equal(r, r_jax)
    assert np.all(np.isfinite(r)) and np.all(r > 0.9)
    e_jax, e = jax_autocorr.effective_sample_size(chain), autocorr.effective_sample_size(chain)
    np.testing.assert_array_equal(e, e_jax)
    assert np.all(e > 0) and np.all(e <= chain.shape[0] * chain.shape[1])


def test_gelman_rubin_sees_walkers_that_disagree():
    chain = _chain(3)
    chain[:, :6, 0] += 5.0  # half the walkers elsewhere in the first parameter
    r = autocorr.gelman_rubin(chain)
    np.testing.assert_array_equal(r, jax_autocorr.gelman_rubin(chain))
    assert r[0] > 1.5 and np.all(r[1:] < 1.2)


@pytest.mark.parametrize("block", [1, 7, 64])
def test_write_samples_streamed_bytes_match_jax(tmp_path, block):
    rng = np.random.RandomState(7)
    arr = rng.randn(64, 6)
    arr[13, 2] = np.nan  # a diverged walker's row
    arr = arr.astype(np.float32) if block == 7 else arr
    dirs = {name: tmp_path / name for name in ("port", "jax", "whole")}
    for d in dirs.values():
        os.makedirs(d)
    blocks = lambda: (arr[i:i + block] for i in range(0, len(arr), block))
    assert results.write_samples_streamed(str(dirs["port"]), blocks()) == len(arr)
    assert jax_results.write_samples_streamed(str(dirs["jax"]), blocks()) == len(arr)
    results.write_samples(str(dirs["whole"]), arr)
    port = (dirs["port"] / "samples.txt").read_bytes()
    assert port == (dirs["jax"] / "samples.txt").read_bytes()
    assert port == (dirs["whole"] / "samples.txt").read_bytes()
    assert b"nan" in port
    got = results.read_samples(str(dirs["port"]))
    fin = np.isfinite(arr)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(got[fin].astype(arr.dtype), arr[fin])


def test_write_samples_streamed_without_pandas_matches_jax(tmp_path, monkeypatch):
    """The np.savetxt writer, where pandas does not import, in both packages."""
    monkeypatch.setattr(results, "_pandas_or_none", lambda: None)
    monkeypatch.setattr(jax_results, "_pandas_or_none", lambda: None)
    arr = np.random.RandomState(8).randn(30, 6)
    for name, mod in (("port", results), ("jax", jax_results)):
        os.makedirs(tmp_path / name)
        assert mod.write_samples_streamed(str(tmp_path / name), [arr[:11], arr[11:]]) == 30
    assert (tmp_path / "port" / "samples.txt").read_bytes() == \
        (tmp_path / "jax" / "samples.txt").read_bytes()


def _profiles():
    d = np.geomspace(10, 3000, 40)
    mu = 0.02 + 0.3 * (1 - np.exp(-d / 700.0))
    sig = 0.05 + 0.02 * np.log10(d)
    yield "table", AvProfile(d, mu, sig), JaxAvProfile(d, mu, sig)
    yield "constant", AvProfile.constant(0.2, 0.0), JaxAvProfile.constant(0.2, 0.0)
    yield ("analytic", AvProfile.analytic(288.45, 45.8, 0.106, 482.0, 0.01),
           JaxAvProfile.analytic(288.45, 45.8, 0.106, 482.0, 0.01))


@pytest.mark.parametrize("name", ["table", "constant", "analytic"])
def test_device_tables_match_jax_float64(name):
    import jax.numpy as jnp

    _, port, ref = next(p for p in _profiles() if p[0] == name)
    got = port.device_tables(n=16, dtype=torch.float64, device="cpu")
    want = ref.device_tables(n=16, dtype=jnp.float64)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and g.device.type == "cpu"
        assert tuple(g.shape) == tuple(np.shape(w))
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=0)
    assert tuple(got[2].shape) == (16,)


def test_device_tables_default_dtype_and_device():
    """float32 by default; the device is the caller's (a CUDA default raises here)."""
    prof = next(_profiles())[1]
    lo, step, mu, sig = prof.device_tables(device="cpu")
    assert mu.dtype == torch.float32 and tuple(mu.shape) == (256,)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            prof.device_tables()
