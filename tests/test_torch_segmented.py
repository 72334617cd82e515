"""PyTorch port: the segmented large-nd lane against the JAX package (CPU).

* The plain k-ary median (K7) equals the JAX ``median_nonneg_xla`` bit for
  bit, exact and fast, in float32 and in float64 (the JAX dial convention).
* The plain versions of K6 (model with extinction), K8 (renorm partials)
  and K9 (chi^2 residual) equal the Pallas kernels run in interpret mode,
  K8 and K9 on the same model array, under the kernel gate (rtol 5e-5, atol
  1e-4 * max|ref|) or, for K6, the JAX test's own rtol 3e-6 / atol 1e-9.
* The composition (K10) equals the JAX ``spectrum_chi2_segmented`` at the
  exact dials within rtol 2e-5 / atol 1e-6, at a tileable and an untileable
  nd, and within rtol 2e-2 at the production dials (the JAX fast-dial
  bound: the 14-pass midpoint median sits in a bracket of the exact one, and
  JAX's 3-pass split-bf16 product differs from the port's f32 product).
* The dispatch sends a wide CUDA float32 target to the lane, and the fleet
  refuses rows too wide for its kernels' shared memory before any launch.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mcmc_spec_tpu import bench_target as jbench  # noqa: E402
from mcmc_spec_tpu.inference import batched as jb  # noqa: E402
from mcmc_spec_tpu.ops import spec_segmented as jseg  # noqa: E402
from mcmc_spec_tpu_torch.bench_target import build_bench_target  # noqa: E402
from mcmc_spec_tpu_torch.inference import batched, fleet  # noqa: E402
from mcmc_spec_tpu_torch.inference.target import target_from_jax  # noqa: E402
from mcmc_spec_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from mcmc_spec_tpu_torch.ops import spec_segmented as seg  # noqa: E402

EXACT = dict(iters=31, mm_passes=6, recip=0)
PROD = dict(iters=14, mm_passes=3, recip=2)
MEDIAN_CASES = [(240, 240), (239, 240), (200, 240), (201, 240), (2, 240), (1, 240)]


def _assert_kernel_gate(got, ref, rtol=5e-5):
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    fin = np.isfinite(ref)
    assert fin.any()
    np.testing.assert_allclose(got[fin], ref[fin], rtol=rtol, atol=1e-4 * np.abs(ref[fin]).max())


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax_median(model, n_true, iters):
    fn = jax.jit(lambda m, n: jseg.median_nonneg_xla(m, n, iters=iters))
    return np.asarray(fn(jnp.asarray(model), jnp.asarray(n_true, jnp.int32)))


# ---------------------------------------------------------------------------
# K7: the k-ary median, bit for bit


@pytest.mark.parametrize("iters", [None, 14, 15, 20])
@pytest.mark.parametrize("n_true,nd", MEDIAN_CASES)
def test_median_matches_jax_bit_for_bit(n_true, nd, iters):
    """1e30 sentinel padding above n_true, odd and even ranks, exact and fast."""
    rng = np.random.RandomState(7)
    model = rng.uniform(0.05, 8.0, (16, nd)).astype(np.float32)
    model[:, n_true:] = 1e30
    want = _jax_median(model, n_true, iters)
    got = seg.median_nonneg_reference(_t(model), torch.tensor(n_true, dtype=torch.int32), iters)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)
    # the CPU wrapper is the plain version
    assert torch.equal(seg.median_nonneg(_t(model), n_true, iters), got)


@pytest.mark.parametrize("iters", [None, 14])
@pytest.mark.parametrize("n", [64, 63])
def test_median_duplicates_zeros_and_f64(n, iters):
    """Repeated values and zeros in float32; float64 with the JAX dial convention
    (63 bits, iters + 3 resolved for a fast setting)."""
    rng = np.random.RandomState(3)
    model = rng.choice([0.0, 0.25, 1.0, 1.0, 3.5], (8, n)).astype(np.float32)
    assert np.array_equal(seg.median_nonneg_reference(_t(model), n, iters).numpy(),
                          _jax_median(model, n, iters))
    m64 = rng.uniform(0.0, 5.0, (8, n))
    got = seg.median_nonneg_reference(_t(m64), n, iters)
    assert got.dtype == torch.float64
    assert np.array_equal(got.numpy(), _jax_median(m64, n, iters))
    if iters is None:
        assert np.array_equal(got.numpy(), np.median(m64, axis=1))


def test_median_per_row_ranks():
    """One n_true per row (the fleet's ragged targets): each row's sorted-rank median."""
    rng = np.random.RandomState(5)
    model = rng.uniform(0.05, 8.0, (6, 50)).astype(np.float32)
    n_true = np.array([50, 49, 20, 21, 1, 2])
    for i, n in enumerate(n_true):
        model[i, n:] = 1e30
    got = seg.median_nonneg_reference(_t(model), _t(n_true)).numpy()
    want = [np.float32(np.median(model[i, :n])) for i, n in enumerate(n_true)]
    assert np.array_equal(got, np.array(want, dtype=np.float32))


# ---------------------------------------------------------------------------
# K6, K8, K9 against the Pallas kernels (interpret mode)


def _segmented_args(nd, nw, seed=1):
    """(JAX f32 target, [NW, NO] Wcomb, [NW] av, the lane's operands as numpy f32,
    the [NW, ndim] walkers)."""
    jt, truth = jbench.build_bench_target(jnp.float32, nd=nd, grid_step=8.0)
    coords = jbench.init_walker_batch(jt, truth, nw, jnp.float32, seed=seed)
    p = jnp.asarray(coords, jnp.float32)
    *_, Wcomb = jb._forward_small(p, jt)
    nT, nG, _ = jt.D.shape
    f = lambda x: np.asarray(x, np.float32)
    ops = (f(jt.D).reshape(nT * nG, nd), f(jt.ext_k_data), f(jt.data_flux), f(jt.data_err),
           f(jt.V), f(jt.Vpinv), f(jt.med_data), np.int32(jt.n_data_true))
    return jt, f(Wcomb), f(p[:, jt.nspec]), ops, f(p)


@pytest.fixture(scope="module")
def lane1024():
    return _segmented_args(1024, 24)


@pytest.mark.parametrize("nw", [5, 24])
def test_model_extinct_matches_pallas(lane1024, nw):
    _, Wcomb, av, (D, kd, *_), _ = lane1024
    W, a = Wcomb[:nw], av[:nw].copy()
    a[0] = 0.0  # no extinction where av <= 0
    want = np.asarray(jseg.model_extinct(W, a, D, kd, 6, interpret=True))
    got = seg.model_extinct_reference(_t(W), _t(a), _t(D), _t(kd))
    assert got.dtype == torch.float32 and got.shape == (nw, D.shape[1])
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-6, atol=1e-9)
    assert torch.equal(seg.model_extinct(_t(W), _t(a), _t(D), _t(kd)), got)


@pytest.fixture(scope="module")
def lane_model(lane1024):
    """One model array and median-match scale, shared by the JAX and port K8/K9."""
    jt, Wcomb, av, (D, kd, data, err, V, Vpinv, med_data, n_true), _ = lane1024
    model = np.asarray(jseg.model_extinct(Wcomb, av, D, kd, 6, interpret=True))
    med = _jax_median(model, n_true, None)
    scale = (med_data / med).astype(np.float32)
    return model, scale, (data, err, V, Vpinv)


@pytest.mark.parametrize("recip", [0, 2])
@pytest.mark.parametrize("renorm", [True, False])
def test_renorm_partials_and_resid_chi2_match_pallas(lane_model, renorm, recip):
    model, scale, (data, err, V, Vpinv) = lane_model
    want_c = np.asarray(jseg.renorm_partials(model, scale, data, Vpinv, recip, interpret=True))
    got_c = seg.renorm_partials_reference(_t(model), _t(scale), _t(data), _t(Vpinv), recip)
    assert got_c.shape == (model.shape[0], 3)
    _assert_kernel_gate(got_c.numpy(), want_c)
    assert torch.equal(seg.renorm_partials(_t(model), _t(scale), _t(data), _t(Vpinv), recip),
                       got_c)
    coeffs = want_c if renorm else None  # K9 of both sides on the same coefficients
    want = np.asarray(jseg.resid_chi2(model, scale, coeffs, data, err, V, recip,
                                      renorm=renorm, interpret=True))
    args = (_t(model), _t(scale), None if coeffs is None else _t(coeffs), _t(data), _t(err),
            _t(V), recip, renorm)
    got = seg.resid_chi2_reference(*args)
    _assert_kernel_gate(got.numpy(), want)
    assert torch.equal(seg.resid_chi2(*args), got)


# ---------------------------------------------------------------------------
# K10: the composition


def _both_compositions(lane, dials, renorm, nw=None):
    Wcomb, av, ops = lane[1:4]
    W, a = Wcomb[:nw], av[:nw]
    want = np.asarray(jseg.spectrum_chi2_segmented(W, a, *ops, renorm=renorm, interpret=True,
                                                    **dials))
    got = seg.spectrum_chi2_segmented(_t(W), _t(a), *map(_t, ops), renorm=renorm, **dials)
    assert got.dtype == torch.float32
    return got.numpy(), want


@pytest.mark.parametrize("renorm", [True, False])
def test_composition_matches_jax_exact(lane1024, renorm):
    got, want = _both_compositions(lane1024, EXACT, renorm)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("renorm", [True, False])
def test_composition_matches_jax_untileable_nd(renorm):
    """nd = 1000 has no power-of-two tile: the JAX side takes its XLA fallback."""
    got, want = _both_compositions(_segmented_args(1000, 8), EXACT, renorm)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)


def test_composition_matches_jax_production_dials(lane1024):
    got, want = _both_compositions(lane1024, PROD, True)
    np.testing.assert_allclose(got, want, rtol=2e-2)
    exact, _ = _both_compositions(lane1024, EXACT, True)
    assert not np.array_equal(got, exact)  # the fast dial engaged


def test_median_only_scoring_ignores_the_fast_dial(lane1024):
    _, Wcomb, av, ops, _ = lane1024
    args = (_t(Wcomb), _t(av), *map(_t, ops))
    fast = seg.spectrum_chi2_segmented(*args, renorm=False, **PROD)
    exact = seg.spectrum_chi2_segmented(*args, renorm=False, iters=31, mm_passes=3, recip=2)
    assert torch.equal(fast, exact)


def test_composition_requires_dials(lane1024):
    _, Wcomb, av, ops, _ = lane1024
    with pytest.raises(ValueError, match="explicit accuracy dials"):
        seg.spectrum_chi2_segmented(_t(Wcomb), _t(av), *map(_t, ops))


def test_nan_propagates_to_minus_inf(lane1024):
    """K9 keeps non-finite residuals, the convention of the Pallas kernel and of
    K1-K5, not the JAX XLA fallback's zeroing: a walker with no model flux gets
    a NaN chi^2 (median 0, scale inf, inf * 0), as the Pallas lane gives it,
    and the batched likelihood maps it to -inf."""
    jt, Wcomb, av, ops, coords = lane1024
    Wcomb, av, coords = Wcomb[:6].copy(), av[:6], coords[:6]
    Wcomb[2] = 0.0
    got, want = _both_compositions((jt, Wcomb, av, ops), EXACT, True)
    assert np.isnan(want[2]) and np.isnan(got[2])
    fin = np.arange(6) != 2
    np.testing.assert_allclose(got[fin], want[fin], rtol=2e-5, atol=1e-6)

    model = seg.model_extinct_reference(_t(Wcomb), _t(av), _t(ops[0]), _t(ops[1]))
    model[4, 7] = float("nan")
    resid = seg.resid_chi2_reference(model, torch.ones(6), None, *map(_t, ops[2:5]), 0,
                                     renorm=False)
    assert torch.isnan(resid[4]) and torch.isfinite(resid[torch.arange(6) != 4]).all()

    tt = target_from_jax(jt, device="cpu", dtype=torch.float32)
    ll = batched.log_likelihood_batch(_t(coords), tt, chi_spec=torch.from_numpy(got))
    assert ll[2] == -np.inf and torch.isfinite(ll[torch.from_numpy(fin)]).all()


# ---------------------------------------------------------------------------
# dispatch and guards


def test_dispatch_takes_the_segmented_lane(monkeypatch):
    """nd = 8192 on (simulated) CUDA float32 walkers: log_posterior_batch and
    optimizer_chi2_batch route to the lane and match the JAX package's own
    segmented dispatch (rtol 2e-4, atol 2e-3, its test's bound)."""
    monkeypatch.setenv("MCMC_SPEC_SPECTRUM_KERNEL", "pallas")
    monkeypatch.setenv("MCMC_SPEC_FUSED_EVAL", "0")
    jt, truth = jbench.build_bench_target(jnp.float32, nd=8192, grid_step=8.0)
    coords = jbench.init_walker_batch(jt, truth, 8, jnp.float32)
    want = np.asarray(jax.jit(jb.log_posterior_batch)(coords, jt))
    want_opt = np.asarray(jax.jit(jb.optimizer_chi2_batch)(coords, jt))
    assert np.isfinite(want).all()

    tt = target_from_jax(jt, device="cpu", dtype=torch.float32)
    assert tt.D.shape[2] > seg.LARGE_ND and not batched._fusable(tt)
    calls = []
    real = seg.spectrum_chi2_segmented
    monkeypatch.setattr(batched, "_on_cuda_f32", lambda p: p.dtype == torch.float32)
    monkeypatch.setattr(seg, "spectrum_chi2_segmented",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    P = _t(np.asarray(coords, np.float32))
    np.testing.assert_allclose(batched.log_posterior_batch(P, tt).numpy(), want,
                               rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(batched.optimizer_chi2_batch(P, tt).numpy(), want_opt,
                               rtol=2e-4, atol=2e-3)
    assert [(k["renorm"], k["iters"]) for k in calls] == [(True, tt.median_iters), (False, 31)]


def test_one_large_nd_constant():
    assert batched.LARGE_ND is seg.LARGE_ND and fleet.LARGE_ND is seg.LARGE_ND
    assert seg.LARGE_ND == jseg.LARGE_ND


@pytest.mark.parametrize("fused", [False, True])
def test_fleet_guard_raises_before_launch(monkeypatch, fused):
    """A fleet row too wide for K4's or K5's shared memory raises a ValueError
    naming nd, the limit and the escape, before any launch; at the limit the
    kernel is called."""
    members = [build_bench_target(torch.float32, device="cpu", nd=64, grid_step=16.0, seed=i)[0]
               for i in range(2)]
    stacked = fleet.stack_targets(members)
    P = torch.stack([torch.from_numpy(np.array([[4600.0, 3400.0, 0.15, 0.72, 0.45, 2e-3]] * 4,
                                               dtype=np.float32))] * 2)
    calls = []
    fake = lambda *a: calls.append(a) or torch.zeros(P.shape[:2])
    monkeypatch.setattr(ck, "spectrum_chi2_fleet", fake)
    monkeypatch.setattr(ck, "log_posterior_fleet_fused", fake)
    monkeypatch.setattr(batched, "_on_cuda_f32", lambda p: True)
    if fused:
        monkeypatch.setenv("MCMC_SPEC_FUSED_EVAL", "1")
    nT, nG = stacked.D.shape[1:3]
    # K4 and K5 run one warp per walker: the widest row one warp holds, K5's beside its
    # 1 + nspec rows of weights and its block's tile buffers
    rows = 1 + stacked.nspec if fused else 0
    if fused:
        limit = ck.staged_max_nd(nT * nG, rows)
        assert ck.staged_block(limit, nT * nG, rows)[0] == 1
        with pytest.raises(ValueError, match="shared memory"):
            ck.staged_block(limit + 1, nT * nG, rows)
    else:
        limit = ck.warp_max_nd(nT * nG, rows)
        assert ck.walkers_per_block(limit, nT * nG, rows) == 1
        with pytest.raises(ValueError, match="shared memory"):
            ck.walkers_per_block(limit + 1, nT * nG, rows)
    wide = dataclasses.replace(stacked, D=torch.zeros(2, nT, nG, limit + 1))
    with pytest.raises(ValueError, match=rf"nd={limit + 1}.*nd={limit}.*segmented"):
        fleet.log_posterior_fleet(P, wide)
    assert not calls
    fleet.log_posterior_fleet(P, dataclasses.replace(stacked, D=torch.zeros(2, nT, nG, limit)))
    assert len(calls) == 1


def test_wrappers_refuse_other_devices():
    W = torch.empty((4, 56), device="meta")
    m = torch.empty((4, 128), device="meta")
    with pytest.raises(ValueError, match="not supported"):
        seg.model_extinct(W, W[:, 0], W.T, W[0])
    with pytest.raises(ValueError, match="not supported"):
        seg.median_nonneg(m, 128, 31)
    with pytest.raises(ValueError, match="not supported"):
        seg.renorm_partials(m, m[:, 0], m[0], m[:3], 0)
    with pytest.raises(ValueError, match="not supported"):
        seg.resid_chi2(m, m[:, 0], m[:, :3], m[0], m[0], m[:3].T, 0)


def test_lane_kernels_are_built_and_counted():
    from mcmc_spec_tpu_torch.runtime import cuda_build

    for src in ("model_extinct.cu", "median_kary.cu", "segmented_stats.cu", "block_common.cuh"):
        assert src in cuda_build.SOURCES + cuda_build.HEADERS
        assert (cuda_build.CSRC / src).is_file()
    for name in ("model_extinct", "median_nonneg", "renorm_partials", "resid_chi2"):
        assert name in ck.LAUNCHES
    for fn in ("model_extinct_launch", "median_kary_launch", "renorm_partials_launch",
               "resid_chi2_launch"):
        assert fn in ck._SIGNATURES
