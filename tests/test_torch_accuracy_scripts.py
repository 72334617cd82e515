"""PyTorch port: the accuracy scripts against the JAX package's (CPU).

The JAX scripts are loaded from their files (``tests.test_torch_scripts._load``)
and run on numpy-seeded inputs at small sizes; the port's scripts
(``mcmc_spec_tpu_torch/scripts/``) must give:

* ``testing.make_setup``: the JAX suite's ``make_setup`` target field by
  field, float64, rtol 1e-12, and 1e-8 on ``cmag``/``pmag`` (the JAX tests'
  forward-vs-emulator tolerance, ``tests/test_posterior.py:51``);
* ``median_tempering_bound_cpu``: the k-pass medians bit for bit with JAX's
  ``_row_median_nonneg``; the model rows and both chi^2 arrays in the JAX
  kernel gate (identical finiteness, rtol 5e-5, atol 1e-4 max|ref|, float32);
  the table's eps bit for bit, its tempering dL in the gate and its direct and
  annealer dL within the gate carried through their difference;
* ``median_tempering_bound``, ``fast_median_impact``: the log-posterior per
  pass count on the same walkers in the gate of JAX's ``log_posterior_fused``
  in interpret mode, and dL = L_k - L_31 within the sum of the two bounds
  (K1's plain version: ``batched._on_cuda_f32`` patched, so that the dials
  act on the CPU; JAX at ``matmul_passes`` 6 for the port's 3, whose product
  does not read the dial);
* ``segmented_median_bound``: the same on the large-nd lane at nd = 4,352,
  just above ``LARGE_ND``, against the JAX lane's dispatch;
* ``matmul_passes_impact``: the chains at 6 and 3 passes equal bit for bit;
* ``anneal_budget_divergence``: ``reference_oob_burn`` identical to JAX's on
  seeded proposals.

Every ``main()`` runs here at a tiny size, and the card scripts raise without
a card.
"""
import dataclasses
import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mcmc_spec_tpu import bench_target as jbench  # noqa: E402
from mcmc_spec_tpu.inference import batched as jb  # noqa: E402
from mcmc_spec_tpu.ops import pallas_kernels as pk  # noqa: E402
from mcmc_spec_tpu_torch.bench_target import build_bench_target  # noqa: E402
from mcmc_spec_tpu_torch.inference import batched  # noqa: E402
from mcmc_spec_tpu_torch.inference.target import (DATA_FIELDS, META_FIELDS,  # noqa: E402
                                                   target_from_jax)
from mcmc_spec_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from mcmc_spec_tpu_torch.scripts import anneal_budget_divergence as abd  # noqa: E402
from mcmc_spec_tpu_torch.scripts import card_validation as cv  # noqa: E402
from mcmc_spec_tpu_torch.scripts import fast_median_impact as fmi  # noqa: E402
from mcmc_spec_tpu_torch.scripts import matmul_passes_impact as mpi  # noqa: E402
from mcmc_spec_tpu_torch.scripts import median_tempering_bound as mtb  # noqa: E402
from mcmc_spec_tpu_torch.scripts import median_tempering_bound_cpu as mtc  # noqa: E402
from mcmc_spec_tpu_torch.scripts import mist_sensitivity as ms  # noqa: E402
from mcmc_spec_tpu_torch.scripts import segmented_median_bound as smb  # noqa: E402
from mcmc_spec_tpu_torch.testing import make_setup  # noqa: E402
from tests.helpers import make_setup as jax_make_setup  # noqa: E402
from tests.test_torch_scripts import _gate, _load  # noqa: E402

ND, GRID_STEP, NW = 256, 8.0, 24
LANE_ND = 4352  # just above LARGE_ND = 4,096; 17 tiles of 256
EXACT = dict(median_iters=31, matmul_passes=6, recip_newton=0)
RTOL = 5e-5


def _bound(ref):
    """The kernel gate's per-value bound on ``ref`` (finite values)."""
    ref = np.asarray(ref, np.float64)
    fin = np.isfinite(ref)
    return 1e-4 * np.abs(ref[fin]).max() + RTOL * np.abs(np.where(fin, ref, 0.0))


@pytest.fixture(scope="module")
def bench():
    """(JAX f32 bench target at the exact dials, the port's copy of it, numpy f32
    walkers around the truth)."""
    jt, truth = jbench.build_bench_target(jnp.float32, nd=ND, grid_step=GRID_STEP)
    jt = dataclasses.replace(jt, **EXACT)
    rng = np.random.RandomState(5)
    scale = np.concatenate([np.full(2, 50.0), [0.02], np.full(2, 0.02), [0.02e-3]])
    P = (np.asarray(truth) + rng.randn(NW, 6) * scale).astype(np.float32)
    return jt, target_from_jax(jt, device="cpu", dtype=torch.float32), P


@pytest.fixture
def kernel_dials(monkeypatch):
    """CPU float32 walkers take the kernels' dispatch (their plain versions), so that
    the dials act as on the card."""
    monkeypatch.setattr(batched, "_on_cuda_f32", lambda p: p.dtype == torch.float32)


# ---------------------------------------------------------------------------
# testing.make_setup


@pytest.mark.parametrize("rad_prior", [False, True])
def test_make_setup_matches_jax(rad_prior):
    st, tt = make_setup(rad_prior=rad_prior)
    js, jt = jax_make_setup(rad_prior=rad_prior, dtype=jnp.float64)
    for name in DATA_FIELDS:
        got, want = getattr(tt, name).numpy(), np.asarray(getattr(jt, name))
        rtol = 1e-8 if name in ("cmag", "pmag") else 1e-12
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0, err_msg=name)
    for name in META_FIELDS:
        if name != "eval_block":  # the JAX walker-block size; the port has none
            assert getattr(tt, name) == getattr(jt, name), name
    for key in ("data_wl_um", "data_flux", "data_err", "p_truth", "zps", "cerr", "perr"):
        np.testing.assert_allclose(st[key], js[key], rtol=1e-12, atol=0, err_msg=key)
    for key in ("cmag", "pmag"):
        np.testing.assert_allclose(st[key], js[key], rtol=1e-8, atol=0, err_msg=key)


# ---------------------------------------------------------------------------
# median_tempering_bound_cpu


@pytest.fixture(scope="module")
def tempering(bench):
    """(JAX script, JAX model rows [NW, ND] f32, port target, walkers)."""
    jt, tt, P = bench
    jmod = _load("median_tempering_bound_cpu")
    model = np.array(jax.jit(lambda c: jmod.model_and_exact(c, jt))(jnp.asarray(P)))
    return jmod, model, tt, P


@pytest.mark.parametrize("iters", [31, *mtc.PASSES])
def test_row_medians_bit_for_bit(tempering, iters):
    jmod, model, _, _ = tempering
    want = np.asarray(jmod._row_median_nonneg(jnp.asarray(model), iters=iters))
    got = ck._row_median_nonneg(torch.from_numpy(model), iters=iters).numpy()
    np.testing.assert_array_equal(got, want)


def test_model_and_chi2_in_the_gate(bench, tempering):
    jt, _, _ = bench
    jmod, model, tt, P = tempering
    _gate(mtc.model_and_exact(torch.from_numpy(P), tt).numpy(), model)
    med = np.asarray(jmod._row_median_nonneg(jnp.asarray(model), iters=14))[:, 0]
    for jfn, fn in ((jmod.chi_renorm_with_med, mtc.chi_renorm_with_med),
                    (jmod.chi_median_only_with_med, mtc.chi_median_only_with_med)):
        want = np.asarray(jfn(jnp.asarray(model), jnp.asarray(med), jt))
        _gate(fn(torch.from_numpy(model), torch.from_numpy(med), tt).numpy(), want)


def test_tempering_tables_match_jax(bench, tempering, monkeypatch, capsys):
    """The JAX script's main on the same walkers (its sampler replaced by one that
    returns them) against ``tempering_tables`` on the same model rows."""
    jt, _, _ = bench
    jmod, model, tt, P = tempering
    monkeypatch.setattr(jmod, "NWALK", NW)
    monkeypatch.setattr(jmod, "build_bench_target", lambda dtype: (jt, None))
    monkeypatch.setattr(jmod, "init_walker_batch", lambda *a: jnp.asarray(P))
    monkeypatch.setattr(jmod, "init_ensemble", lambda c, *a: types.SimpleNamespace(coords=c))
    monkeypatch.setattr(jmod, "run_ensemble", lambda state, *a, **k: (state, None, None))
    jmod.main()
    want = {int(k): v for k, v in json.loads(capsys.readouterr().out.splitlines()[-1]).items()}

    got, ex = mtc.tempering_tables(torch.from_numpy(model), tt, np.ones(NW, bool))
    chi_bound = max(_bound(ex["chi_ex"]).max(), _bound(ex["chi_med_ex"]).max())
    w = ex["w"]
    assert set(got) == set(want)
    for k, g in got.items():
        r = want[k]
        for key in ("eps_bound", "eps_max", "eps_std"):  # the same medians, bit for bit
            assert g[key] == r[key], (k, key)
        for key in ("dL_std", "dL_max"):  # chi_ex in the gate
            np.testing.assert_allclose(g[key], r[key], rtol=RTOL, atol=1e-4 * r[key],
                                       err_msg=f"k={k} {key}")
        for key, scale in (("dL_direct_std", 0.5 * w), ("dL_direct_max", 0.5 * w),
                           ("anneal_dL_std", 1.5 * w), ("anneal_dL_max", 1.5 * w)):
            # a difference of two chi^2 values, each in the gate
            assert abs(g[key] - r[key]) <= 2 * scale * chi_bound, (k, key, g[key], r[key])


# ---------------------------------------------------------------------------
# median_tempering_bound, fast_median_impact: K1's log-posterior per pass count


CASES = ([("median_tempering_bound", k, 6, 0) for k in (31, *mtb.PASSES)]
         + [("fast_median_impact", k, 3, 2) for k in fmi.PASSES])


@pytest.mark.parametrize("script,iters,mm,recip", CASES)
def test_logpost_per_pass_in_the_gate(bench, kernel_dials, script, iters, mm, recip):
    jt, tt, P = bench
    got = mtb.logp_at(tt, torch.from_numpy(P), median_iters=iters, matmul_passes=mm,
                      recip_newton=recip)
    base = mtb.logp_at(tt, torch.from_numpy(P), median_iters=31, matmul_passes=mm,
                       recip_newton=recip)
    jfn = lambda k: np.asarray(pk.log_posterior_fused(
        jnp.asarray(P), dataclasses.replace(jt, median_iters=k, matmul_passes=6,
                                            recip_newton=recip), interpret=True), np.float64)
    want, want_base = jfn(iters), jfn(31)
    _gate(got, want)
    _gate(base, want_base)
    assert np.all(np.abs((got - base) - (want - want_base))
                  <= _bound(want) + _bound(want_base))


def test_dl_per_pass_table(bench, kernel_dials):
    """``dl_per_pass``'s table is its log-posteriors' differences; 31 passes is 0."""
    _, tt, P = bench
    out, L31, Ls = mtb.dl_per_pass(tt, torch.from_numpy(P), passes=(31, 14))
    assert out[31]["dL_max"] == 0.0
    dL = Ls[14] - L31
    assert out[14]["dL_std"] == float(np.std(dL)) and out[14]["dL_max"] > 0


@pytest.fixture(scope="module")
def lane():
    jt, truth = jbench.build_bench_target(jnp.float32, nd=LANE_ND, grid_step=GRID_STEP)
    P = np.asarray(jbench.init_walker_batch(jt, truth, 8, jnp.float32, seed=3))
    return jt, target_from_jax(jt, device="cpu", dtype=torch.float32), P


@pytest.mark.parametrize("iters", [31, smb.FAST_ITERS])
def test_segmented_logpost_matches_jax_lane(lane, kernel_dials, monkeypatch, iters):
    """On the large-nd lane (K6-K9's plain versions) at the production recip dial, the
    log-posterior at 31 and 14 passes against the JAX package's lane."""
    monkeypatch.setenv("MCMC_SPEC_SPECTRUM_KERNEL", "pallas")
    monkeypatch.setenv("MCMC_SPEC_FUSED_EVAL", "0")
    jt, tt, P = lane
    calls = []
    real = smb.log_posterior_batch
    monkeypatch.setattr(smb, "log_posterior_batch",
                        lambda p, t: calls.append(t.median_iters) or real(p, t))
    dials = dict(matmul_passes=6, recip_newton=2)
    tt = dataclasses.replace(tt, **dials)
    L_fast, L_ex = smb.shift(tt, torch.from_numpy(P), iters=iters)
    assert calls == [iters, 31]
    want = np.asarray(jax.jit(jb.log_posterior_batch)(
        jnp.asarray(P), dataclasses.replace(jt, median_iters=iters, **dials)), np.float64)
    _gate(L_fast, want)


# ---------------------------------------------------------------------------
# matmul_passes_impact: the dial is inert in the port


def test_matmul_passes_chains_bit_for_bit(kernel_dials):
    tt, truth = build_bench_target(torch.float32, device="cpu", nd=ND, grid_step=GRID_STEP)
    chains = [fmi.run_chain(dataclasses.replace(tt, matmul_passes=n), truth, nwalk=16,
                            nburn=8, nsteps=16) for n in mpi.PASSES]
    assert chains[0].shape == (16 // fmi.THIN * 16, 6)
    np.testing.assert_array_equal(chains[0], chains[1])


# ---------------------------------------------------------------------------
# anneal_budget_divergence


def test_reference_oob_burn_matches_jax():
    jmod = _load("anneal_budget_divergence")
    rng = np.random.RandomState(11)
    lo, hi = 3000.0, 5600.0
    for _ in range(400):
        t = rng.uniform(lo - 900, hi + 900, 2)
        av, r1, rr = rng.uniform(-0.6, 0.6), rng.uniform(-0.1, 1.6), rng.uniform(-0.1, 1.1)
        plx = rng.choice([rng.uniform(1e-4, 3e-4), rng.uniform(5e-3, 0.05),
                          rng.uniform(1e-3, 3e-3)])
        args = (t, av, r1, rr, plx, lo, hi)
        assert abd.reference_oob_burn(*args) == jmod.reference_oob_burn(*args), args


# ---------------------------------------------------------------------------
# the mains at tiny sizes on the CPU, and no card


def test_mains_run_on_the_cpu(capsys):
    small = dict(nd=ND, grid_step=GRID_STEP)
    out = mtc.main(nwalk=12, nburn=4, **small)
    assert set(out) == set(mtc.PASSES)
    out = mtb.main(device="cpu", nwalk=12, nburn=4, rate_steps=2, **small)
    assert set(out["rate_Mevals"]) == set(mtb.RATE_PASSES)
    out = smb.main(device="cpu", nwalk=8, nburn=2, nd=LANE_ND)
    assert out["walkers_finite"] == 8 and out["lane"]
    out = fmi.main(device="cpu", nwalk=12, nburn=4, nsteps=8, **small)
    assert set(out["shifts"]) == set(fmi.PASSES[1:])
    assert mpi.main(device="cpu", nwalk=12, nburn=4, nsteps=8, **small)["same"]
    assert len(ms.main(6)) == 2
    res = abd.main(nwalk=6, steps=4, nd=128)
    assert res["tot_ours"].max() <= 50 * 4
    text = capsys.readouterr().out
    assert "k=14:" in text and "iters=14:" in text and "segmented_fast_median" in text


@pytest.mark.parametrize("main", [mtb.main, smb.main, fmi.main, mpi.main,
                                  lambda: cv.main([])])
def test_card_scripts_raise_without_a_card(main):
    with pytest.raises(RuntimeError, match="no CUDA card"):
        main()
