"""PyTorch port: the two-stage slice (annealer + stretch sampler) vs the JAX package (CPU, f64).

torch.Generator and JAX keys give different numbers, so the comparison feeds
the port the JAX draws: the port's draw functions are substituted with
functions that regenerate the JAX draws from the same key, split exactly as
``anneal.py`` and ``stretch.py`` split it.
"""
import dataclasses
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mcmc_spec_tpu.bench_target import build_bench_target as jax_build_bench_target  # noqa: E402
from mcmc_spec_tpu.inference import anneal as jax_anneal  # noqa: E402
from mcmc_spec_tpu.inference import batched as jb  # noqa: E402
from mcmc_spec_tpu.inference import stretch as jax_stretch  # noqa: E402
from mcmc_spec_tpu_torch.inference import anneal, batched, stretch  # noqa: E402
from mcmc_spec_tpu_torch.inference.target import target_from_jax  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
_T = lambda a: torch.from_numpy(np.array(a))


class _JaxNoise:
    """anneal._draw_noise from a JAX key: ``key, knoise = split(key)`` per iteration."""

    def __init__(self, key):
        self.key = key

    def __call__(self, gen, shape, dtype, device):
        self.key, k = jax.random.split(self.key)
        return _T(jax.random.normal(k, shape, dtype=jnp.float64))


class _JaxChunk:
    """stretch._draw_chunk from a JAX key: ``key, kz, kp, ka = split(key, 4)`` per chunk."""

    def __init__(self, key):
        self.key = key

    def __call__(self, gen, thin, nh, a, dtype, device):
        self.key, kz, kp, ka = jax.random.split(self.key, 4)
        shape = (thin, 2, nh)
        z = jax_stretch._stretch_z(kz, shape, a).astype(jnp.float64)
        idx = jax.random.randint(kp, shape, 0, nh)
        log_u = jnp.log(jax.random.uniform(ka, shape)).astype(jnp.float64)
        return _T(z), _T(idx).long(), _T(log_u)


class _JaxHalf:
    """stretch._draw_half from a JAX key: ``key, kz, kp, ka = split(key, 4)`` per
    half-step, as JAX's odd-ensemble path (``_half_update``) splits it."""

    def __init__(self, key):
        self.key = key

    def __call__(self, gen, m, n_comp, a, dtype, device):
        self.key, kz, kp, ka = jax.random.split(self.key, 4)
        z = jax_stretch._stretch_z(kz, (m,), a).astype(jnp.float64)
        idx = jax.random.randint(kp, (m,), 0, n_comp)
        log_u = jnp.log(jax.random.uniform(ka, (m,))).astype(jnp.float64)
        return _T(z), _T(idx).long(), _T(log_u)


@pytest.fixture(scope="module")
def targets():
    jt, truth = jax_build_bench_target(jnp.float64, nd=256, grid_step=8.0)
    return jt, target_from_jax(jt, device="cpu", dtype=torch.float64), truth


@pytest.fixture(scope="module")
def annealed(targets):
    """Stage 1 in both packages from the same initial walkers and draws."""
    jt, tt, truth = targets
    k_init, k_run = jax.random.split(jax.random.PRNGKey(3))
    p0 = np.array(jax_anneal.init_walkers(jt, 16, float(truth[-1]), 0.05e-3, k_init))
    jp, jchi, _ = jax_anneal.run_anneal(jt, jnp.asarray(p0), k_run, steps=2)
    saved = anneal._draw_noise
    anneal._draw_noise = _JaxNoise(k_run)
    try:
        tp, tchi, _ = anneal.run_anneal(tt, torch.from_numpy(p0), torch.Generator(), steps=2)
    finally:
        anneal._draw_noise = saved
    return np.array(jp), np.array(jchi), tp.numpy(), tchi.numpy(), p0


def test_anneal_matches_jax(annealed):
    jp, jchi, tp, tchi, p0 = annealed
    assert not np.allclose(jp, p0)  # the annealer moved the walkers
    np.testing.assert_allclose(tp, jp, rtol=1e-9)
    np.testing.assert_allclose(tchi, jchi, rtol=1e-9)


@pytest.mark.parametrize("steps,record_thin,n_iters", [(1, 60, 0), (3, 40, 120)])
def test_anneal_record_thin_matches_jax(monkeypatch, targets, annealed, steps, record_thin,
                                        n_iters):
    """With ``record_thin`` both packages run whole chunks only, ``50*steps //
    record_thin * record_thin`` iterations: none at (1, 60), where the start walkers
    come back with an empty trace, and 120 (not 150) at (3, 40)."""
    jt, tt, _ = targets
    p0 = annealed[4]
    key = jax.random.PRNGKey(21)
    jp, jchi, (jtp, jtc) = jax_anneal.run_anneal(jt, jnp.asarray(p0), key, steps=steps,
                                                 record_thin=record_thin)
    noise = _JaxNoise(key)
    monkeypatch.setattr(anneal, "_draw_noise", noise)
    tp, tchi, (ttp, ttc) = anneal.run_anneal(tt, torch.from_numpy(p0), torch.Generator(),
                                             steps=steps, record_thin=record_thin)
    n_chunks = n_iters // record_thin
    assert ttp.shape == (n_chunks, 16, tt.ndim) == np.shape(jtp)
    assert ttc.shape == (n_chunks, 16) == np.shape(jtc)
    # the port drew one noise batch per iteration it ran
    want_key = key
    for _ in range(n_iters):
        want_key, _ = jax.random.split(want_key)
    np.testing.assert_array_equal(np.asarray(noise.key), np.asarray(want_key))
    if n_iters == 0:
        np.testing.assert_array_equal(tp.numpy(), p0)
        np.testing.assert_array_equal(np.asarray(jp), p0)
        np.testing.assert_allclose(tchi.numpy(), batched.optimizer_chi2_batch(
            torch.from_numpy(p0), tt).numpy(), rtol=0)
    else:
        assert not np.allclose(tp.numpy(), p0)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-9)
    np.testing.assert_allclose(tchi.numpy(), np.asarray(jchi), rtol=1e-9)
    np.testing.assert_allclose(ttp.numpy(), np.asarray(jtp), rtol=1e-9)
    np.testing.assert_allclose(ttc.numpy(), np.asarray(jtc), rtol=1e-9)


def test_run_ensemble_matches_jax(monkeypatch, targets, annealed):
    jt, tt, _ = targets
    start = annealed[0]
    key = jax.random.PRNGKey(11)
    logp_j = lambda b: jb.log_posterior_batch(b, jt)
    js = jax_stretch.init_ensemble(jnp.asarray(start), logp_j, key)
    js, jchain, jlps = jax_stretch.run_ensemble(js, logp_j, n_steps=4, thin=2)

    monkeypatch.setattr(stretch, "_draw_chunk", _JaxChunk(key))
    logp_t = lambda b: batched.log_posterior_batch(b, tt)
    ts = stretch.init_ensemble(torch.from_numpy(start), logp_t, torch.Generator())
    ts, tchain, tlps = stretch.run_ensemble(ts, logp_t, n_steps=4, thin=2)

    assert int(ts.n_accept) == int(js.n_accept) > 0
    np.testing.assert_allclose(ts.coords.numpy(), np.asarray(js.coords), rtol=1e-9)
    np.testing.assert_allclose(ts.log_prob.numpy(), np.asarray(js.log_prob), rtol=1e-9)
    np.testing.assert_allclose(tchain.numpy(), np.asarray(jchain), rtol=1e-9)
    np.testing.assert_allclose(tlps.numpy(), np.asarray(jlps), rtol=1e-9)


def test_run_ensemble_odd_walkers_matches_jax(monkeypatch, targets, annealed):
    """An odd ensemble (15 walkers: halves of 7 and 8) steps as JAX's does."""
    jt, tt, _ = targets
    start = annealed[0][:15]
    key = jax.random.PRNGKey(13)
    logp_j = lambda b: jb.log_posterior_batch(b, jt)
    js = jax_stretch.init_ensemble(jnp.asarray(start), logp_j, key)
    js, jchain, jlps = jax_stretch.run_ensemble(js, logp_j, n_steps=4, thin=2)

    monkeypatch.setattr(stretch, "_draw_half", _JaxHalf(key))
    monkeypatch.setattr(stretch, "_draw_chunk", None)  # the even path draws nothing here
    logp_t = lambda b: batched.log_posterior_batch(b, tt)
    ts = stretch.init_ensemble(torch.from_numpy(start), logp_t, torch.Generator())
    ts, tchain, tlps = stretch.run_ensemble(ts, logp_t, n_steps=4, thin=2)

    assert tchain.shape == (2, 15, tt.ndim)
    assert int(ts.n_accept) == int(js.n_accept) > 0
    np.testing.assert_allclose(ts.coords.numpy(), np.asarray(js.coords), rtol=1e-9)
    np.testing.assert_allclose(ts.log_prob.numpy(), np.asarray(js.log_prob), rtol=1e-9)
    np.testing.assert_allclose(tchain.numpy(), np.asarray(jchain), rtol=1e-9)
    np.testing.assert_allclose(tlps.numpy(), np.asarray(jlps), rtol=1e-9)


@pytest.mark.parametrize("nw", [16, 15])
def test_run_split_invariant(targets, annealed, nw):
    """run(40) == run(20) + run(20) with one generator (resume relies on it)."""
    _, tt, _ = targets
    start = torch.from_numpy(annealed[2][:nw])
    logp = lambda b: batched.log_posterior_batch(b, tt)

    def run(splits):
        st = stretch.init_ensemble(start, logp, torch.Generator().manual_seed(5))
        chains = []
        for n in splits:
            st, chain, _ = stretch.run_ensemble(st, logp, n_steps=n, thin=1)
            chains.append(chain)
        return st, torch.cat(chains)

    one, chain_one = run([40])
    two, chain_two = run([20, 20])
    assert torch.equal(one.coords, two.coords) and torch.equal(one.log_prob, two.log_prob)
    assert int(one.n_accept) == int(two.n_accept) > 0
    assert torch.equal(chain_one, chain_two)
    acc = float(stretch.acceptance_fraction(one, 40))
    assert 0.0 < acc < 1.0


@pytest.mark.parametrize("kw", [dict(nspec=2), dict(nspec=3), dict(nspec=2, fit_plx=False)])
def test_init_walkers_within_bounds(targets, kw):
    _, tt, truth = targets
    fit_plx = kw.get("fit_plx", True)
    ndim = 2 * kw["nspec"] + (2 if fit_plx else 0)
    # the binary target's data, re-read as a triple / a no-parallax fit
    tt = dataclasses.replace(tt, **kw, dist_fit=fit_plx, prior_mu=torch.zeros(ndim),
                             prior_sig=torch.ones(ndim))
    p0 = anneal.init_walkers(tt, 64, float(truth[-1]), 0.05e-3, torch.Generator().manual_seed(0))
    assert p0.shape == (64, tt.ndim)
    assert anneal._in_bounds(tt, p0).float().mean() > 0.9
    assert torch.isfinite(batched.log_posterior_batch(p0, tt)).all()
    for k in range(1, tt.nspec):
        assert torch.all(p0[:, k] <= p0[:, k - 1])  # T_k ~ U(tmin, T_{k-1})


def test_anneal_records_trace(targets, annealed):
    _, tt, _ = targets
    p0 = torch.from_numpy(annealed[4])
    gen = lambda: torch.Generator().manual_seed(9)
    params, chi, trace = anneal.run_anneal(tt, p0, gen(), steps=2, record_thin=25)
    assert trace[0].shape == (4, 16, tt.ndim) and trace[1].shape == (4, 16)
    assert torch.equal(trace[0][-1], params) and torch.equal(trace[1][-1], chi)
    assert torch.all(trace[1][1:] <= trace[1][:-1])  # chi^2 only improves
    same, _, none = anneal.run_anneal(tt, p0, gen(), steps=2)
    assert none is None and torch.equal(same, params)


def _python(code, cwd, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("CUDA_VISIBLE_DEVICES", None)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout, check=False)


def test_port_runs_without_jax():
    """Every port module imports, and the CPU slice runs, with JAX unimportable."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["mcmc_spec_tpu"] = None
        import torch
        import mcmc_spec_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(mcmc_spec_tpu_torch.__path__,
                                                       "mcmc_spec_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        from mcmc_spec_tpu_torch.bench_target import build_bench_target
        from mcmc_spec_tpu_torch.inference.anneal import init_walkers, run_anneal
        from mcmc_spec_tpu_torch.inference.batched import log_posterior_batch
        from mcmc_spec_tpu_torch.inference.stretch import init_ensemble, run_ensemble
        tgt, truth = build_bench_target(torch.float32, device="cpu", nd=128, grid_step=16.0)
        gen = torch.Generator().manual_seed(0)
        p0 = init_walkers(tgt, 12, float(truth[-1]), 0.05e-3, gen)
        params, chi, _ = run_anneal(tgt, p0, gen, steps=2)
        seeds = params[torch.argsort(chi)[:4]]
        logp = lambda b: log_posterior_batch(b, tgt)
        st, chain, _ = run_ensemble(init_ensemble(seeds, logp, gen), logp, 4, thin=2)
        assert torch.isfinite(st.log_prob).all() and chain.shape == (2, 4, 6)
        from mcmc_spec_tpu_torch.inference.fleet import (
            init_fleet_ensemble, run_fleet_ensemble, stack_targets)
        fleet = stack_targets([build_bench_target(torch.float32, device="cpu", nd=128 - 8 * i,
                                                  grid_step=16.0, seed=i, pad_nd=128)[0]
                               for i in range(2)])
        fst = init_fleet_ensemble(torch.stack([seeds, seeds]), fleet, gen)
        fst, fchain, _ = run_fleet_ensemble(fst, fleet, 2, thin=1)
        assert torch.isfinite(fst.log_prob).all() and fchain.shape == (2, 2, 4, 6)
        leaked = [m for m, mod in sys.modules.items() if mod is not None
                  and (m == "jax" or m.startswith(("jax.", "mcmc_spec_tpu.")))]
        assert not leaked, leaked
        print("OK", len(names))
    """)
    proc = _python(code, REPO)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK")


def test_chip_smoke_fails_without_a_card(tmp_path):
    """No CUDA card (or the script alone, without the package): non-zero exit, no result."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    for cwd in (REPO, tmp_path):
        proc = _python("import runpy; runpy.run_path('chip_smoke.py', run_name='__main__')", cwd)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
