"""PyTorch port: the cost-attribution experiments vs the JAX package's scripts (CPU).

The JAX scripts (``scripts/vpu_microbench.py``, ``scripts/try_fast_recip.py``,
``scripts/ablate_fused_sections.py``) are loaded from their files and run
unedited: their shape constants are shrunk and their ``pl`` is replaced by a
shim whose ``pallas_call`` runs in interpret mode.  On the same numpy-seeded
inputs the plain versions of the port's kernels must give

* S10 ``fma_chains`` and S11 ``median_only``: the same bits;
* S4 ``spectrum_recip`` and the section variants ``posterior_sections`` (S13
  masks): the JAX package's kernel gate (identical finiteness, rtol 5e-5,
  atol 1e-4 * max|ref|), at the exact dials (31, 6, 0) and (14, 6, 2).
  ``matmul_passes = 6`` is the f32 product, which the port computes for every
  value of the dial.
"""
import dataclasses
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from mcmc_spec_tpu.inference.target import pack_target as jax_pack_target  # noqa: E402
from mcmc_spec_tpu.ops import pallas_kernels as pk  # noqa: E402
from mcmc_spec_tpu_torch.inference.target import target_from_jax  # noqa: E402
from mcmc_spec_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from mcmc_spec_tpu_torch.scripts import ablate_fused_sections as ab  # noqa: E402
from mcmc_spec_tpu_torch.scripts import try_fast_recip as fr  # noqa: E402
from mcmc_spec_tpu_torch.scripts import vpu_microbench as vb  # noqa: E402
from tests.helpers import make_setup  # noqa: E402

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
NW, ND, BLOCK = 64, 256, 32
EXACT = dict(median_iters=31, matmul_passes=6, recip_newton=0)
FAST = dict(median_iters=14, matmul_passes=6, recip_newton=2)


class _InterpretPallas:
    """``pallas`` with ``pallas_call(..., interpret=True)``."""

    def __getattr__(self, name):
        return getattr(pl, name)

    @staticmethod
    def pallas_call(*args, **kwargs):
        return pl.pallas_call(*args, interpret=True, **kwargs)


def _load(name):
    """A fresh module object of the JAX script ``name`` for each call, so that no test
    sees another's patched constants or state."""
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def jax_script(monkeypatch):
    """A JAX script at the test shapes, its Pallas calls in interpret mode and its
    timer, where it has one, replaced by one call whose outputs are kept in
    ``mod.captured``."""

    def load(name):
        mod = _load(name)
        for const, value in (("NW", NW), ("ND", ND), ("BLOCK", BLOCK)):
            if hasattr(mod, const):
                monkeypatch.setattr(mod, const, value)
        monkeypatch.setattr(mod, "pl", _InterpretPallas())
        captured = []

        def once(fn, *args, **kwargs):
            captured.append(np.asarray(fn(*args)))
            return 1.0

        if hasattr(mod, "_time"):
            monkeypatch.setattr(mod, "_time", once)
        monkeypatch.setattr(mod, "captured", captured, raising=False)
        return mod

    return load


def _gate(got, ref, rtol=5e-5, explain=None):
    """The JAX kernel gate on [walkers] or [walkers, 1] values: identical finiteness and
    |got - ref| <= atol + rtol |ref| with atol = 1e-4 max|ref|.  A failure names the
    worst walker, its two values and its bound, and adds ``explain(walker)``."""
    got, ref = np.asarray(got).reshape(len(got), -1), np.asarray(ref).reshape(len(ref), -1)
    fin = np.isfinite(ref)
    off = np.flatnonzero((np.isfinite(got) != fin).any(axis=1))
    assert off.size == 0, (f"finiteness differs on walkers {off[:10]}: port "
                           f"{got[off[:3], 0]}, JAX {ref[off[:3], 0]}")
    assert fin.any()
    atol = 1e-4 * np.abs(ref[fin]).max()
    with np.errstate(invalid="ignore"):
        diff = np.where(fin, np.abs(got.astype(np.float64) - ref), 0.0)
    bound = atol + rtol * np.abs(np.where(fin, ref, 0.0))
    excess = diff - bound
    w, j = np.unravel_index(np.argmax(excess), excess.shape)
    if excess[w, j] > 0:
        msg = (f"{int((excess > 0).sum())} of {int(fin.sum())} values outside the gate; worst "
               f"walker {w}: port {got[w, j]!r}, JAX {ref[w, j]!r}, |diff| {diff[w, j]:.6g} > "
               f"bound {bound[w, j]:.6g} (rtol {rtol}, atol {atol:.6g})")
        if explain is not None:
            msg += "; " + explain(int(w))
        raise AssertionError(msg)


# ---------------------------------------------------------------------------
# S10, S11 (vpu_microbench)


class _EagerRef:
    """A Pallas ref over a JAX array, so that a kernel body runs op by op."""

    def __init__(self, a=None):
        self.a = a

    def __getitem__(self, idx):
        return self.a[idx]

    def __setitem__(self, idx, value):
        self.a = value


@pytest.mark.parametrize("k", [1, 24, 96])
def test_fma_chains_reference_matches_jax_bits(jax_script, k):
    jmod = jax_script("vpu_microbench")
    # the script's own call, on its input of ones
    jmod.vpu_ceiling(k=k, lanes=4, nd=ND)
    ones = torch.ones((NW, ND), dtype=torch.float32)
    np.testing.assert_array_equal(vb.fma_chains(ones, k).numpy(), jmod.captured[0])
    # the script's kernel body on seeded inputs, with the call's 4 chains.  Op by
    # op: compiled, XLA's CPU backend reassociates the constant multiply chains
    # (an ulp off on 30-80 % of these elements), which the script's arithmetic,
    # the card's and the plain version's do not.
    x = np.random.RandomState(k).uniform(0.25, 4.0, (NW, ND)).astype(np.float32)
    out = _EagerRef()
    jmod._mulchains_kernel(_EagerRef(jnp.asarray(x)), out, k=k, lanes=vb.CHAIN_LANES)
    np.testing.assert_array_equal(vb.fma_chains_reference(torch.from_numpy(x), k).numpy(),
                                  np.asarray(out.a))


@pytest.mark.parametrize("nd", [ND, ND - 1])
@pytest.mark.parametrize("iters", [31, 15])
def test_median_only_reference_matches_jax_bits(jax_script, iters, nd):
    jmod = jax_script("vpu_microbench")
    x = np.abs(np.random.RandomState(nd).standard_normal((NW, nd))).astype(np.float32)
    x[3, : nd // 2] = x[3, 0]  # a row of ties
    jmod.median_only(iters, jnp.asarray(x))
    got = vb.median_only(torch.from_numpy(x), iters).numpy()
    assert got.shape == (NW, 1)
    np.testing.assert_array_equal(got.view(np.int32), jmod.captured[0].view(np.int32))
    if iters == 31:
        np.testing.assert_array_equal(got[:, 0], np.median(x, axis=1).astype(np.float32))


def test_wrappers_reject_bad_arguments():
    x = torch.ones((4, 8))
    with pytest.raises(ValueError):
        vb.fma_chains(x, 0)
    with pytest.raises(ValueError):
        vb.median_only(x, 32)
    with pytest.raises(ValueError):
        fr.spectrum_recip(*fr.synthetic_inputs("cpu", nw=4, nd=16), recip=-1)


# ---------------------------------------------------------------------------
# S4 (try_fast_recip)


def test_synthetic_inputs_are_the_jax_scripts(jax_script, monkeypatch):
    jmod = jax_script("try_fast_recip")
    calls = []
    monkeypatch.setattr(jmod, "NO", 56)

    def run(*args, recip, noexp=False):
        calls.append(args)
        return jnp.ones((NW, 1), jnp.float32)

    monkeypatch.setattr(jmod, "run", run)
    monkeypatch.setattr(jmod, "_time", lambda f, args, **kw: 1.0)
    jmod.main()
    for want, got in zip(calls[0], fr.synthetic_arrays(nw=NW, nd=ND)):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, np.asarray(want))


def _explain_median(arrays, walker, noexp=False, iters=fr.ITERS):
    """The model row and the ``iters``-pass midpoint median of one walker on both sides:
    a median one bracket apart (2^(31 - iters) patterns) moves the chi^2 by ~2^-8 at
    16 passes, far outside the gate, so it says whether the rows or the medians differ."""
    medd, Wc, av, D, kd = arrays[:5]
    w = slice(walker, walker + 1)
    ext = pk.LN10_04 * av[w] * kd
    trans = (1.0 + ext) if noexp else jnp.exp(ext)
    jrow = np.asarray(pk._dot_f32(jnp.asarray(Wc[w]), jnp.asarray(D), 6) *
                      jnp.where(av[w] > 0, trans, 1.0))
    tt = torch.from_numpy
    text = ck.LN10_04 * tt(av[w]) * tt(kd)
    ttrans = torch.where(tt(av[w]) > 0, 1.0 + text if noexp else torch.exp(text),
                         torch.ones(()))
    trow = ((tt(Wc[w]) @ tt(D)) * ttrans).numpy()
    ulps = np.abs(jrow.view(np.int32).astype(np.int64) - trow.view(np.int32)).max()
    jmed = np.asarray(pk._row_median_nonneg(jnp.asarray(jrow), iters=iters))[0, 0]
    tmed = ck._row_median_nonneg(tt(trow), iters=iters).numpy()[0, 0]
    return (f"model rows differ by at most {ulps} ulps; {iters}-pass medians JAX {jmed!r} "
            f"({jmed.view(np.int32)}), port {tmed!r} ({tmed.view(np.int32)})")


@pytest.mark.parametrize("noexp", [False, True])
@pytest.mark.parametrize("recip", [0, 1, 2])
def test_spectrum_recip_reference_matches_jax(jax_script, recip, noexp):
    jmod = jax_script("try_fast_recip")
    arrays = fr.synthetic_arrays(nw=NW, nd=ND)
    medd, Wc, av, D, kd, data, ie, Vp, VT = (jnp.asarray(a) for a in arrays)
    want = np.asarray(jmod._spectrum_block_recip(Wc, av, D, kd, data, ie, Vp, VT, medd[0, 0],
                                                 iters=fr.ITERS, mm_passes=6, recip=recip,
                                                 noexp=noexp))
    targs = [torch.from_numpy(a) for a in arrays]
    got = fr.spectrum_recip_reference(*targs, recip=recip, noexp=noexp).numpy()
    assert got.shape == (NW, 1)
    _gate(got, want, explain=functools.partial(_explain_median, arrays, noexp=noexp))
    before = dict(ck.LAUNCHES)
    np.testing.assert_array_equal(fr.spectrum_recip(*targs, recip=recip, noexp=noexp).numpy(), got)
    assert ck.LAUNCHES == before


# ---------------------------------------------------------------------------
# S12 (ablate_fused_sections)


def _binary_target(dials, **kw):
    st, _ = make_setup(dtype=jnp.float64)
    prior_mu, prior_sig = np.zeros(6), np.ones(6)
    prior_mu[-1], prior_sig[-1] = 2.0e-3, 0.05e-3
    jt = jax_pack_target(
        st["grid"], st["data_wl_um"], st["data_flux"], st["data_err"], st["cfilts"],
        st["cmag"], st["cerr"], st["pfilts"], st["zps"], st["pmag"], st["perr"], st["mist"],
        st["av_profile"], prior_mu=prior_mu, prior_sig=prior_sig, dtype=jnp.float32, nspec=2,
        **kw)
    jt = dataclasses.replace(jt, **dials)
    return jt, target_from_jax(jt, device="cpu", dtype=torch.float32)


def _binary_walkers(tgt, n=20, seed=3):
    """Walkers around a plausible binary, plus Av = 0, Av < 0, T on the grid edges
    and one far out of bounds."""
    base = np.array([4600.0, 3400.0, 0.15, 0.72, 0.45, 2.0e-3])
    rng = np.random.RandomState(seed)
    rows = [base * (1 + 0.03 * rng.randn(base.size)) for _ in range(n)]
    for av in (0.0, -0.05):
        r = base.copy()
        r[2] = av
        rows.append(r)
    edge = base.copy()
    edge[0], edge[1] = float(tgt.tmax), float(tgt.tmin)
    rows += [edge, np.ones_like(base)]
    return np.stack(rows).astype(np.float32)


@pytest.mark.parametrize("dials", [EXACT, FAST], ids=["exact", "fast"])
@pytest.mark.parametrize("variant", list(ab.VARIANTS))
def test_posterior_sections_reference_matches_jax(monkeypatch, variant, dials):
    jmod = _load("ablate_fused_sections")
    jt, tt = _binary_target(dials)
    P = _binary_walkers(jt)
    phot, priors, spectrum, w = ab.VARIANTS[variant]
    monkeypatch.setattr(pk, "_posterior_kernel", jmod.variant_kernel(
        do_phot=phot, do_priors=priors, do_spectrum=spectrum, do_w=w))
    want = np.asarray(pk.log_posterior_fused.__wrapped__(jnp.asarray(P), jt, interpret=True))
    got = ab.posterior_sections_reference(torch.from_numpy(P), tt, variant).numpy()
    _gate(got, want)
    before = dict(ck.LAUNCHES)
    np.testing.assert_array_equal(ab.posterior_sections(torch.from_numpy(P), tt, variant).numpy(),
                                  got)
    assert ck.LAUNCHES == before
    if variant == "full":
        np.testing.assert_array_equal(got, ck.log_posterior_fused_reference(torch.from_numpy(P),
                                                                            tt).numpy())
    else:
        full = ab.posterior_sections_reference(torch.from_numpy(P), tt, "full").numpy()
        assert not np.allclose(got, full, equal_nan=True)


@pytest.mark.parametrize("kw", [dict(nspec=3), dict(rad_prior=True), dict(fit_plx=False),
                                dict(dist_fit=False), dict(spectrum_weight=0.0)],
                         ids=["nspec3", "rad_prior", "no_plx", "no_dist_fit", "nospec"])
def test_posterior_sections_rejects_out_of_scope_targets(kw):
    jt, tt = _binary_target(EXACT)
    tt = dataclasses.replace(tt, **kw)
    P = torch.from_numpy(_binary_walkers(jt, n=2))
    with pytest.raises(ValueError, match="posterior_sections covers"):
        ab.posterior_sections(P, tt, "full")
    with pytest.raises(ValueError, match="posterior_sections covers"):
        ab.posterior_sections_reference(P, tt, "full")


def test_posterior_sections_rejects_unknown_variant():
    jt, tt = _binary_target(EXACT)
    with pytest.raises(ValueError, match="unknown variant"):
        ab.posterior_sections(torch.from_numpy(_binary_walkers(jt, n=2)), tt, "no_median")


# ---------------------------------------------------------------------------
# the port's entry points, end to end on the CPU at a tiny size


def test_mains_run_on_cpu(capsys):
    v = vb.main(device="cpu", nw=16, nd=96, nd_half=48, grid_step=16.0, chain_k=(2, 3))
    assert set(v) >= {("ceiling", 2), ("ceiling", 3), "median31", "fused31", ("fused", 48, 16)}
    r = fr.main(device="cpu", nw=16, nd=96)
    assert 0.0 < r["rel"][2] < r["rel"][1] < 1e-1
    a = ab.main(device="cpu", nwalk=16, nd=96, grid_step=16.0)
    assert list(a) == list(ab.VARIANTS) and all(ms > 0 for ms in a.values())
    out = capsys.readouterr().out
    assert "host-clock times of the plain versions, not device times" in out
    assert "full-variant sanity vs the production kernel: max rel" in out
    assert "attribution (vs full)" in out and "[receipt]" in out


def test_cuda_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (vb.main, fr.main, ab.main):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            main()
