"""PyTorch port: the emcee-style ``EnsembleSampler`` facade and the fit example (CPU).

* The facade's read-out (``get_chain`` with ``flat``/``discard``/``thin``,
  ``get_log_prob``, ``chain``, ``acceptance_fraction``,
  ``get_autocorr_time``, ``get_last_sample``, ``reset``) equals JAX's on the
  same injected chain blocks and state, exactly.
* Its sampling is the port's ``run_ensemble`` from a generator seeded with
  the sampler's seed, bit for bit, over two ``run_mcmc`` blocks and through
  ``sample``; a new initial state starts from the seed again, as JAX's key.
* On a correlated 2-D Gaussian both packages' samplers find the mean within
  0.15 and the variances within 20 % (8,000 steps at thin 4 of 32 walkers,
  the first 500 kept steps dropped; the two draw different random numbers).
* ``examples/fit_synthetic_binary`` runs on the CPU at a small size.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mcmc_spec_tpu.inference import sampler_api as jsa  # noqa: E402
from mcmc_spec_tpu.inference import stretch as jst  # noqa: E402
from mcmc_spec_tpu_torch.inference import sampler_api as tsa  # noqa: E402
from mcmc_spec_tpu_torch.inference import stretch as tst  # noqa: E402

NW, NDIM = 12, 3
COV = np.array([[1.0, 0.6], [0.6, 2.0]])
MEAN = np.array([1.5, -0.5])


def _blocks(seed=0):
    rng = np.random.RandomState(seed)
    chain = [rng.randn(n, NW, NDIM) for n in (40, 25)]
    logp = [rng.randn(n, NW) for n in (40, 25)]
    return chain, logp, rng.randn(NW, NDIM)


def _inject(s, chain, logp, last, n_accept, torch_side):
    s._chain_blocks, s._logp_blocks, s._n_steps = list(chain), list(logp), 30
    if torch_side:
        s._state = tst.EnsembleState(torch.as_tensor(last), torch.zeros(NW, dtype=torch.float64),
                                     torch.Generator(), torch.tensor(n_accept))
    else:
        s._state = jst.EnsembleState(jnp.asarray(last), jnp.zeros(NW), None,
                                     jnp.asarray(n_accept, jnp.int32))


@pytest.fixture
def samplers():
    chain, logp, last = _blocks()
    j = jsa.EnsembleSampler(NW, NDIM, lambda b: b[:, 0])
    t = tsa.EnsembleSampler(NW, NDIM, lambda b: b[:, 0], device="cpu", dtype=torch.float64)
    _inject(j, chain, logp, last, 700, False)
    _inject(t, chain, logp, last, 700, True)
    return j, t


@pytest.mark.parametrize("kw", [{}, {"flat": True}, {"discard": 10}, {"thin": 3},
                                {"flat": True, "discard": 7, "thin": 4}])
def test_get_chain_is_jax(samplers, kw):
    j, t = samplers
    np.testing.assert_array_equal(t.get_chain(**kw), j.get_chain(**kw))


def test_readout_is_jax(samplers):
    j, t = samplers
    for flat in (False, True):
        np.testing.assert_array_equal(t.get_log_prob(flat=flat), j.get_log_prob(flat=flat))
    np.testing.assert_array_equal(t.chain, j.chain)
    np.testing.assert_array_equal(t.acceptance_fraction, j.acceptance_fraction)
    np.testing.assert_array_equal(t.get_autocorr_time(), j.get_autocorr_time())
    np.testing.assert_array_equal(t.get_last_sample(), np.asarray(j.get_last_sample()))
    for s in (j, t):
        with pytest.raises(RuntimeError, match="50 autocorrelation times"):
            s.get_autocorr_time(quiet=False)


def test_reset_is_jax(samplers):
    j, t = samplers
    j.reset()
    t.reset()
    assert t.get_chain().shape == j.get_chain().shape == (0, NW, NDIM)
    assert t.get_log_prob().shape == j.get_log_prob().shape == (0, NW)
    np.testing.assert_array_equal(t.acceptance_fraction, j.acceptance_fraction)
    assert t.acceptance_fraction[0] == 0.0


def _gauss_logp(b):
    prec = torch.as_tensor(np.linalg.inv(COV), dtype=b.dtype)
    d = b - torch.as_tensor(MEAN, dtype=b.dtype)
    return -0.5 * torch.einsum("ni,ij,nj->n", d, prec, d)


def _p0(n=32, seed=0):
    return MEAN + 0.1 * np.random.RandomState(seed).randn(n, 2)


def test_sampling_is_run_ensemble_bit_for_bit():
    s = tsa.EnsembleSampler(32, 2, _gauss_logp, seed=5, device="cpu", dtype=torch.float64)
    s.run_mcmc(_p0(), 30, thin_by=2)
    s.run_mcmc(None, 20, thin_by=2)
    state = tst.init_ensemble(torch.as_tensor(_p0()), _gauss_logp, torch.Generator().manual_seed(5))
    state, c1, l1 = tst.run_ensemble(state, _gauss_logp, 30, thin=2)
    state, c2, l2 = tst.run_ensemble(state, _gauss_logp, 20, thin=2)
    np.testing.assert_array_equal(s.get_chain(), torch.cat([c1, c2]).numpy())
    np.testing.assert_array_equal(s.get_log_prob(), torch.cat([l1, l2]).numpy())
    assert s.acceptance_fraction[0] == int(state.n_accept) / (32 * 50)
    # sample(): the same chain in blocks; a new initial state starts from the seed again
    g = tsa.EnsembleSampler(32, 2, _gauss_logp, seed=5, device="cpu", dtype=torch.float64)
    last = list(g.sample(_p0(), 50, thin_by=2, block=10))
    assert len(last) == 5
    np.testing.assert_array_equal(g.get_chain(), s.get_chain())
    np.testing.assert_array_equal(last[-1], s.get_last_sample())
    g.reset()
    g.run_mcmc(_p0(), 30, thin_by=2)
    np.testing.assert_array_equal(g.get_chain(), c1.numpy())
    with pytest.raises(ValueError, match="initial state must be"):
        g.run_mcmc(np.zeros((4, 2)), 2)
    with pytest.raises(ValueError, match="no initial state"):
        tsa.EnsembleSampler(32, 2, _gauss_logp, device="cpu").run_mcmc(None, 2)


def test_gaussian_moments_match_jax():
    t = tsa.EnsembleSampler(32, 2, _gauss_logp, seed=1, device="cpu", dtype=torch.float64)
    prec = jnp.asarray(np.linalg.inv(COV))
    j = jsa.EnsembleSampler(32, 2, lambda b: -0.5 * jnp.einsum(
        "ni,ij,nj->n", b - MEAN, prec, b - MEAN), seed=1)
    for s in (t, j):
        s.run_mcmc(_p0(), 8000, thin_by=4)
    for s in (t, j):
        x = s.get_chain(flat=True, discard=500)
        np.testing.assert_allclose(x.mean(axis=0), MEAN, atol=0.15)
        np.testing.assert_allclose(np.cov(x.T).diagonal(), COV.diagonal(), rtol=0.2)
        assert 0.2 < s.acceptance_fraction[0] < 0.9


def test_fit_synthetic_binary_example_runs(tmp_path):
    from mcmc_spec_tpu_torch.examples import fit_synthetic_binary

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        s = fit_synthetic_binary.main(str(tmp_path), noplots=True, device="cpu", n_anneal=24,
                                      anneal_steps=2, nwalkers=12, nsteps=30, discard=3)
    finally:
        torch.set_num_threads(n)
    flat = s.get_chain(flat=True)
    assert flat.shape == (10 * 12, 6) and np.isfinite(flat).all()
    assert 0.0 < s.acceptance_fraction[0] < 1.0
    assert list(tmp_path.iterdir()) == []  # --noplots: no corner plot
