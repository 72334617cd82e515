"""PyTorch port: the fleet path against the JAX package (CPU).

Three ragged targets (nd 240-360, 1-3 contrast filters), padded to common
shapes and stacked, are built by the JAX package's own fleet fixtures
(``tests/test_fleet.py``) and carried across with ``target_from_jax``.

* The composition (``inference.fleet``) equals the JAX fleet in float64
  (rtol 1e-10, the JAX fleet test's own), and each target equals the port's
  single-target posterior on the unpadded target.
* The plain versions of the fleet kernels (K4, K5) equal the Pallas kernels
  run in interpret mode, in float32, under the JAX package's kernel gate:
  identical finiteness, rtol 5e-5 and atol 1e-4 * max|ref|.  The two sides
  sum the model product and the reductions in different orders, and at the
  production dials a one-ulp change in the model row can move the 14-pass
  median by one bracket, which the atol covers.
* The sampler's half-update equals a numpy rendering of the JAX one on the
  same draws, and a run is invariant to how it is split across calls.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mcmc_spec_tpu.inference import batched as jb  # noqa: E402
from mcmc_spec_tpu.inference import fleet as jf  # noqa: E402
from mcmc_spec_tpu.ops import pallas_kernels as pk  # noqa: E402
from mcmc_spec_tpu_torch.inference import batched, fleet  # noqa: E402
from mcmc_spec_tpu_torch.inference.target import (  # noqa: E402
    DATA_FIELDS,
    META_FIELDS,
    target_from_jax,
)
from mcmc_spec_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from tests.test_fleet import _make_target, _walkers  # noqa: E402

SPECS = [(300, 2, 11), (360, 3, 12), (240, 1, 13)]  # (nd, n_contrast, seed)
ND_MAX, NC_MAX = 360, 3
EXACT = dict(median_iters=31, matmul_passes=6, recip_newton=0)
FAST = dict(median_iters=14, matmul_passes=6, recip_newton=2)
CASES = {
    "default": {},
    "rad_prior": dict(rad_prior=True, rad_sigma_frac=0.082),
    "nospec": dict(spectrum_weight=0.0),
}


def _jax_fleet(dtype, **meta):
    """(unpadded singles, stacked padded fleet) of the JAX package."""
    singles = [dataclasses.replace(_make_target(nd, nc, seed, dtype=dtype), **meta)
               for nd, nc, seed in SPECS]
    padded = [dataclasses.replace(
        _make_target(nd, nc, seed, pad_nd=ND_MAX, pad_nc=NC_MAX, dtype=dtype), **meta)
        for nd, nc, seed in SPECS]
    return singles, jf.stack_targets(padded)


@pytest.fixture(scope="module")
def f64_fleets():
    return {case: _jax_fleet(jnp.float64, **meta) for case, meta in CASES.items()}


@pytest.fixture(scope="module")
def f32_fleet():
    return _jax_fleet(jnp.float32)[1]


def _fleet_walkers(nw, seed=0):
    """[3, nw, 6] walkers: a cloud per target plus edge rows (Av = 0, far out
    of bounds, T on the grid edges)."""
    rows = []
    for i in range(len(SPECS)):
        w = np.array(_walkers(nw - 3, seed=seed + i))
        edge = w[0].copy()
        edge[0], edge[1] = 5800.0, 3000.0
        av0 = w[1].copy()
        av0[2] = 0.0
        rows.append(np.concatenate([w, np.stack([av0, np.ones(6), edge])]))
    return np.stack(rows)


def _to_port(jt, dtype):
    return target_from_jax(jt, device="cpu", dtype=dtype)


def _assert_kernel_gate(got, ref, rtol=5e-5):
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    fin = np.isfinite(ref)
    assert fin.sum() >= fin.size // 2
    np.testing.assert_allclose(got[fin], ref[fin], rtol=rtol, atol=1e-4 * np.abs(ref[fin]).max())


# ---------------------------------------------------------------------------
# stacking


def test_stack_targets_matches_jax_fleet(f64_fleets):
    _, jfleet = f64_fleets["default"]
    padded = [_make_target(nd, nc, seed, pad_nd=ND_MAX, pad_nc=NC_MAX) for nd, nc, seed in SPECS]
    got = fleet.stack_targets([_to_port(t, torch.float64) for t in padded])
    want = _to_port(jfleet, torch.float64)
    for name in DATA_FIELDS:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    for name in META_FIELDS:
        assert getattr(got, name) == getattr(want, name) == getattr(jfleet, name), name
    assert got.spectrum_backend == "xla" and got.D.shape == (3, 8, 4, ND_MAX)


def test_stack_targets_raises_on_mixed_members():
    a = _to_port(_make_target(240, 2, 1, pad_nd=300, pad_nc=2), torch.float64)
    b = _to_port(_make_target(240, 2, 1), torch.float64)  # unpadded: nd 240
    with pytest.raises(ValueError, match="mixed fleet configs"):
        fleet.stack_targets([a, dataclasses.replace(a, median_iters=20)])
    with pytest.raises(ValueError, match="mixed fleet configs"):
        fleet.stack_targets([a, dataclasses.replace(a, rad_prior=True)])
    with pytest.raises(ValueError, match="mixed fleet shapes"):
        fleet.stack_targets([a, dataclasses.replace(b, spectrum_backend="xla")])
    with pytest.raises(ValueError, match="mixed fleet shapes"):
        fleet.stack_targets([a, _to_port(_make_target(240, 2, 1, pad_nd=300, pad_nc=2),
                                         torch.float32)])


def test_target_views_are_slices(f64_fleets):
    _, jfleet = f64_fleets["default"]
    tf = _to_port(jfleet, torch.float64)
    views = fleet.target_views(tf)
    assert fleet.target_views(tf) is views and len(views) == 3
    for i, v in enumerate(views):
        assert v.D.data_ptr() == tf.D[i].data_ptr()  # a view, not a copy
        assert int(v.n_data_true) == SPECS[i][0] and v.nspec == tf.nspec


# ---------------------------------------------------------------------------
# composition, float64


@pytest.mark.parametrize("case,nw", [("default", 12), ("rad_prior", 12), ("nospec", 12),
                                     ("default", 13)])
def test_log_posterior_fleet_matches_jax(f64_fleets, case, nw):
    singles, jfleet = f64_fleets[case]
    P = _fleet_walkers(nw)
    want = np.asarray(jax.jit(jf.log_posterior_fleet)(jnp.asarray(P), jfleet))
    tf = _to_port(jfleet, torch.float64)
    got = fleet.log_posterior_fleet(torch.from_numpy(P), tf).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    assert np.isfinite(want).sum() >= 3 * (nw - 2)
    np.testing.assert_allclose(got, want, rtol=1e-10)
    for i, jt in enumerate(singles):
        single = batched.log_posterior_batch(torch.from_numpy(P[i]),
                                             _to_port(jt, torch.float64)).numpy()
        np.testing.assert_allclose(got[i], single, rtol=1e-10, err_msg=f"target {i}")


def test_optimizer_chi2_fleet_matches_jax(f64_fleets):
    _, jfleet = f64_fleets["rad_prior"]
    P = _fleet_walkers(10, seed=3)
    want = np.asarray(jax.jit(jf.optimizer_chi2_fleet)(jnp.asarray(P), jfleet))
    got = fleet.optimizer_chi2_fleet(torch.from_numpy(P), _to_port(jfleet, torch.float64))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)


def test_float64_walkers_on_float32_fleet(f32_fleet):
    """JAX promotes a float32 fleet against float64 walkers; so does the port."""
    P = _fleet_walkers(12, seed=5)
    want = np.asarray(jax.jit(jf.log_posterior_fleet)(jnp.asarray(P), f32_fleet))
    tf = _to_port(f32_fleet, torch.float32)
    got = fleet.log_posterior_fleet(torch.from_numpy(P), tf)
    assert got.dtype == torch.float64 and want.dtype == np.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)
    # the promoted copy is built once and reused
    assert fleet.common_dtype(torch.from_numpy(P), tf)[1] is \
        fleet.common_dtype(torch.from_numpy(P), tf)[1]


# ---------------------------------------------------------------------------
# plain versions of the fleet kernels vs the Pallas kernels (interpret mode), f32


@pytest.mark.parametrize("dials", [EXACT, FAST], ids=["exact", "fast"])
@pytest.mark.parametrize("nw", [12, 13])
def test_spectrum_chi2_fleet_reference_matches_pallas_interpret(f32_fleet, dials, nw):
    jfl = dataclasses.replace(f32_fleet, **dials)
    P = _fleet_walkers(nw, seed=7).astype(np.float32)
    P = np.concatenate([P[:, :-3], P[:, -3:-2]], axis=1)  # in-grid walkers
    Wcomb = jax.vmap(jb._forward_small)(jnp.asarray(P), jfl)[4]
    av = jnp.asarray(P[..., jfl.nspec])
    ntgt, nT, nG, nd = jfl.D.shape
    ref = np.asarray(pk.spectrum_chi2_fleet(
        Wcomb, av, jfl.D.reshape(ntgt, nT * nG, nd), jfl.ext_k_data, jfl.data_flux,
        jfl.data_err, jfl.V, jfl.Vpinv, jfl.med_data, jfl.n_data_true, interpret=True,
        iters=dials["median_iters"], mm_passes=dials["matmul_passes"],
        recip=dials["recip_newton"]))
    tf = _to_port(jfl, torch.float32)
    Wt, avt = torch.from_numpy(np.array(Wcomb)), torch.from_numpy(np.array(av))
    got = ck.spectrum_chi2_fleet_reference(Wt, avt, tf).numpy()
    _assert_kernel_gate(got, ref)
    before = dict(ck.LAUNCHES)
    np.testing.assert_array_equal(ck.spectrum_chi2_fleet(Wt, avt, tf).numpy(), got)
    assert ck.LAUNCHES == before


@pytest.mark.parametrize("case,dials,nw", [
    ("default", EXACT, 12), ("default", FAST, 12), ("default", EXACT, 13),
    ("rad_prior", EXACT, 12), ("rad_prior", FAST, 13), ("nospec", EXACT, 12),
])
def test_fleet_fused_reference_matches_pallas_interpret(case, dials, nw):
    _, jfl = _jax_fleet(jnp.float32, **CASES[case])
    jfl = dataclasses.replace(jfl, **dials)
    P = _fleet_walkers(nw, seed=9).astype(np.float32)
    ref = np.asarray(pk.log_posterior_fleet_fused(jnp.asarray(P), jfl, interpret=True))
    tf = _to_port(jfl, torch.float32)
    got = ck.log_posterior_fleet_fused_reference(torch.from_numpy(P), tf).numpy()
    _assert_kernel_gate(got, ref)
    before = dict(ck.LAUNCHES)
    np.testing.assert_array_equal(ck.log_posterior_fleet_fused(torch.from_numpy(P), tf).numpy(),
                                  got)
    assert ck.LAUNCHES == before


def test_fused_fleet_flag_matches_jax(monkeypatch, f32_fleet):
    """MCMC_SPEC_FUSED_EVAL=1 routes both packages' fleet to their fused kernel."""
    monkeypatch.setenv("MCMC_SPEC_FUSED_EVAL", "1")
    jfl = dataclasses.replace(f32_fleet, **EXACT)
    P = _fleet_walkers(12, seed=11).astype(np.float32)
    ref = np.asarray(jf.log_posterior_fleet(jnp.asarray(P), jfl))
    got = fleet.log_posterior_fleet(torch.from_numpy(P), _to_port(jfl, torch.float32)).numpy()
    _assert_kernel_gate(got, ref)


# ---------------------------------------------------------------------------
# dispatch


class _Recorder:
    def __init__(self, out):
        self.calls, self.out = [], out

    def __call__(self, *args, **kwargs):
        self.calls.append(args)
        return self.out(*args)


def test_fleet_dispatch(monkeypatch, f32_fleet):
    """On (simulated) CUDA f32 walkers the spectrum term takes K4 in one call
    for all targets; MCMC_SPEC_FUSED_EVAL=1 takes K5; nospec and f64 walkers
    take the composition; CPU tensors never reach a kernel wrapper."""
    tf = _to_port(f32_fleet, torch.float32)
    P = torch.from_numpy(_fleet_walkers(12).astype(np.float32))
    k4 = _Recorder(lambda W, av, fl: torch.zeros(W.shape[:2]))
    k5 = _Recorder(lambda p, fl: torch.zeros(p.shape[:2]))
    monkeypatch.setattr(ck, "spectrum_chi2_fleet", k4)
    monkeypatch.setattr(ck, "log_posterior_fleet_fused", k5)

    fleet.log_posterior_fleet(P, tf)
    assert not k4.calls and not k5.calls  # CPU tensors: the composition

    monkeypatch.setattr(batched, "_on_cuda_f32", lambda p: p.dtype == torch.float32)
    out = fleet.log_posterior_fleet(P, tf)
    assert len(k4.calls) == 1 and not k5.calls and out.shape == (3, 12)
    W, av, fl = k4.calls[0]
    assert W.shape == (3, 12, 32) and torch.equal(av, P[..., 2]) and fl is tf

    fleet.log_posterior_fleet(P.double(), tf)
    fleet.log_posterior_fleet(P, dataclasses.replace(tf, spectrum_weight=0.0))
    assert len(k4.calls) == 1

    monkeypatch.setenv("MCMC_SPEC_FUSED_EVAL", "1")
    fleet.log_posterior_fleet(P, tf)
    assert len(k5.calls) == 1 and len(k4.calls) == 1
    no_c = dataclasses.replace(tf, cmag=tf.cmag[:, :0], cerr=tf.cerr[:, :0],
                               Fc=tf.Fc[..., :0].contiguous())
    fleet.log_posterior_fleet(P, no_c)  # no contrast block: not fusable, K4
    assert len(k5.calls) == 1 and len(k4.calls) == 2


def test_fleet_wrappers_refuse_other_devices(f32_fleet):
    tf = _to_port(f32_fleet, torch.float32)
    with pytest.raises(ValueError, match="not supported"):
        ck.log_posterior_fleet_fused(torch.empty((3, 4, 6), device="meta"), tf)
    with pytest.raises(ValueError, match="not supported"):
        ck.spectrum_chi2_fleet(torch.empty((3, 4, 32), device="meta"),
                               torch.empty((3, 4), device="meta"), tf)


def test_fleet_kernel_tables(f32_fleet):
    tf = _to_port(f32_fleet, torch.float32)
    t = ck.fleet_kernel_tables(tf)
    assert ck.fleet_kernel_tables(tf) is t
    n = np.array([s[0] for s in SPECS])
    np.testing.assert_array_equal(t["ranks"].numpy(), np.stack([(n + 1) // 2, n // 2 + 1], 1))
    np.testing.assert_array_equal(t["scal"][:, 3].numpy(), (1.0 / n.astype(np.float32)))
    # spectrum weight x (n_contrast_true + n_phot_true): padded filters don't count
    np.testing.assert_array_equal(t["scal"][:, 4].numpy(), [2 + 3, 3 + 3, 1 + 3])
    assert t["D"].shape == (3, 32, ND_MAX) and t["tentT"].shape == (3, 4, 32)
    for i in range(3):  # each target's slice is the single-target table
        single = ck.kernel_tables(fleet.target_views(tf)[i])
        for name in ("D", "tentT", "tentG", "mist_tent", "Fc", "Fp", "cobs", "pobs", "prior"):
            assert torch.equal(t[name][i], single[name]), name


# ---------------------------------------------------------------------------
# sampler


@pytest.mark.parametrize("half", [0, 1])
def test_fleet_half_update_matches_numpy(f64_fleets, half):
    _, jfleet = f64_fleets["default"]
    tf = _to_port(jfleet, torch.float64)
    coords = _fleet_walkers(12, seed=13)[:, :-2]  # [3, 10, 6], in bounds
    jlogp = jax.jit(jf.log_posterior_fleet)
    logp = np.asarray(jlogp(jnp.asarray(coords), jfleet))
    rng = np.random.RandomState(half)
    nh = 5
    sl, co = (slice(0, nh), slice(nh, 10)) if half == 0 else (slice(nh, 10), slice(0, nh))
    z = ((2.0 - 1.0) * rng.rand(3, nh) + 1.0) ** 2 / 2.0
    idx = rng.randint(0, 5, (3, nh))
    log_u = np.log(rng.rand(3, nh))

    # numpy rendering of mcmc_spec_tpu/inference/fleet.py:_fleet_half_update
    cur = coords[:, sl]
    partners = np.take_along_axis(coords[:, co], idx[..., None], axis=1)
    proposal = partners + z[..., None] * (cur - partners)
    logp_new = np.asarray(jlogp(jnp.asarray(proposal), jfleet))
    accept = log_u < (6 - 1) * np.log(z) + logp_new - logp[:, sl]
    want_c = np.where(accept[..., None], proposal, cur)
    want_lp = np.where(accept, logp_new, logp[:, sl])

    T = torch.from_numpy
    got_c, got_lp, n_acc = fleet._fleet_half_update(
        T(cur.copy()), T(logp[:, sl].copy()), T(coords[:, co].copy()), T(z), T(idx), T(log_u), tf)
    assert 0 < int(n_acc) == int(accept.sum())
    np.testing.assert_allclose(got_c.numpy(), want_c, rtol=1e-12)
    np.testing.assert_allclose(got_lp.numpy(), want_lp, rtol=1e-10)


@pytest.mark.parametrize("nw", [8, 7])
def test_run_fleet_split_invariant(f64_fleets, nw):
    """run(40) == run(20) + run(20) with one generator, and the ensembles move."""
    _, jfleet = f64_fleets["default"]
    tf = _to_port(jfleet, torch.float64)
    start = torch.from_numpy(np.ascontiguousarray(_fleet_walkers(nw + 3, seed=17)[:, :nw]))

    def run(splits):
        st = fleet.init_fleet_ensemble(start, tf, torch.Generator().manual_seed(5))
        chains, lps = [], []
        for n in splits:
            st, chain, lp = fleet.run_fleet_ensemble(st, tf, n_steps=n, thin=5)
            chains.append(chain)
            lps.append(lp)
        return st, torch.cat(chains), torch.cat(lps)

    one, chain_one, lp_one = run([40])
    two, chain_two, lp_two = run([20, 20])
    assert chain_one.shape == (8, 3, nw, 6) and lp_one.shape == (8, 3, nw)
    assert torch.equal(one.coords, two.coords) and torch.equal(one.log_prob, two.log_prob)
    assert torch.equal(chain_one, chain_two) and torch.equal(lp_one, lp_two)
    assert int(one.n_accept) == int(two.n_accept) > 0
    assert torch.isfinite(one.log_prob).all()
    assert not torch.allclose(chain_one[-1], start)
    # the emitted log-probs are those of the emitted coordinates
    np.testing.assert_allclose(fleet.log_posterior_fleet(chain_one[-1], tf).numpy(),
                               lp_one[-1].numpy(), rtol=1e-12)
