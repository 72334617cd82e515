"""PyTorch port: batched posterior, kernel plain versions and dispatch vs the JAX package (CPU).

* The torch composition (``inference.batched``) on targets bridged from the
  JAX package equals the JAX composition in float64 (rtol 1e-9).
* The plain versions of the CUDA kernels equal the Pallas kernels run in
  interpret mode, in float32, under the JAX package's own kernel gate
  (identical finiteness, rtol 5e-5, atol 1e-4 * max|ref|).
* The dispatch routes by device, dtype and target shape.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mcmc_spec_tpu.inference import batched as jb  # noqa: E402
from mcmc_spec_tpu.inference.target import pack_target as jax_pack_target  # noqa: E402
from mcmc_spec_tpu.ops import pallas_kernels as pk  # noqa: E402
from mcmc_spec_tpu_torch.inference import batched  # noqa: E402
from mcmc_spec_tpu_torch.inference.target import target_from_jax  # noqa: E402
from mcmc_spec_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from tests.helpers import make_setup  # noqa: E402

PLX = 2.0e-3
BASE = {
    1: [4600.0, 0.15, 0.72, PLX],
    2: [4600.0, 3400.0, 0.15, 0.72, 0.45, PLX],
    3: [4600.0, 3800.0, 3300.0, 0.15, 0.72, 0.55, 0.3, PLX],
}
CASES = {
    "binary": dict(nspec=2),
    "single": dict(nspec=1),
    "triple": dict(nspec=3),
    "no_plx": dict(nspec=2, fit_plx=False, dist_fit=False),
    "no_dist_fit": dict(nspec=2, dist_fit=False),
    "rad_prior": dict(nspec=2, rad_prior=True, rad_sigma_frac=0.082),
    "nospec": dict(nspec=2, spectrum_weight=0.0),
    "padded": dict(nspec=2, pad_nd=960, pad_nc=3),
}


def _jax_target(case, dtype):
    st, _ = make_setup(dtype=jnp.float64)
    kw = dict(CASES[case])
    ndim = 2 * kw["nspec"] + (2 if kw.get("fit_plx", True) else 0)
    prior_mu, prior_sig = np.zeros(ndim), np.ones(ndim)
    if kw.get("dist_fit", True):
        prior_mu[-1], prior_sig[-1] = PLX, 0.05e-3
    return jax_pack_target(
        st["grid"], st["data_wl_um"], st["data_flux"], st["data_err"], st["cfilts"],
        st["cmag"], st["cerr"], st["pfilts"], st["zps"], st["pmag"], st["perr"], st["mist"],
        st["av_profile"], prior_mu=prior_mu, prior_sig=prior_sig, dtype=dtype, **kw)


def _walkers(case, tgt, n=24, seed=0):
    """Walkers around a plausible point, plus edge walkers: Av = 0, Av < 0,
    T on the grid edges, and one far out of bounds."""
    nspec = CASES[case]["nspec"]
    base = np.asarray(BASE[nspec], dtype=np.float64)
    if not CASES[case].get("fit_plx", True):
        base = np.concatenate([base[: nspec + 1], base[nspec + 2 : -1]])
    rng = np.random.RandomState(seed)
    rows = [base * (1 + 0.03 * rng.randn(base.size)) for _ in range(n)]
    for av in (0.0, -0.05):
        r = base.copy()
        r[nspec] = av
        rows.append(r)
    edge = base.copy()
    edge[0], edge[nspec - 1] = float(tgt.tmax), float(tgt.tmin)
    rows += [edge, np.ones_like(base)]
    return np.stack(rows)


def _assert_kernel_gate(got, ref, rtol=5e-5):
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    fin = np.isfinite(ref)
    assert fin.any()
    np.testing.assert_allclose(got[fin], ref[fin], rtol=rtol, atol=1e-4 * np.abs(ref[fin]).max())


# ---------------------------------------------------------------------------
# composition, float64


@pytest.mark.parametrize("case", list(CASES))
def test_composition_matches_jax_f64(case):
    jt = _jax_target(case, jnp.float64)
    tt = target_from_jax(jt, device="cpu", dtype=torch.float64)
    P = _walkers(case, jt)
    Pj, Pt = jnp.asarray(P), torch.from_numpy(P)
    want = np.asarray(jax.jit(jb.log_posterior_batch)(Pj, jt))
    got = batched.log_posterior_batch(Pt, tt).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    assert np.isfinite(want).sum() >= 20
    np.testing.assert_allclose(got, want, rtol=1e-9)

    want = np.asarray(jax.jit(jb.optimizer_chi2_batch)(Pj, jt))
    got = batched.optimizer_chi2_batch(Pt, tt).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9)
    if jt.rad_prior:
        rs = 0.05 * np.ones((P.shape[0], jt.nspec), dtype=np.float64)
        want = np.asarray(jax.jit(jb.optimizer_chi2_batch)(Pj, jt, rad_sigma=jnp.asarray(rs)))
        got = batched.optimizer_chi2_batch(Pt, tt, rad_sigma=torch.from_numpy(rs)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-9)


def test_forward_batch_matches_jax_f64():
    jt = _jax_target("triple", jnp.float64)
    tt = target_from_jax(jt, device="cpu", dtype=torch.float64)
    P = _walkers("triple", jt, n=8)
    want = jax.jit(jb.forward_batch)(jnp.asarray(P), jt)
    got = batched.forward_batch(torch.from_numpy(P), tt)
    for a, b in zip(got, want):
        # contrasts of equal components cancel to ~1e-15, hence the atol
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("case", ["single", "binary", "triple", "no_plx", "padded"])
def test_scalar_forward_matches_jax_f64(case):
    from mcmc_spec_tpu.inference.posterior import forward as jax_forward
    from mcmc_spec_tpu_torch.inference.posterior import forward

    jt = _jax_target(case, jnp.float64)
    tt = target_from_jax(jt, device="cpu", dtype=torch.float64)
    for p in _walkers(case, jt, n=4)[:-1]:  # the last walker is far outside the grid
        want = jax_forward(jnp.asarray(p), jt)
        got = forward(torch.from_numpy(p), tt)
        for name, a, b in zip(want._fields, got, want):
            # contrasts of equal components cancel to ~1e-15, hence the atol
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-13,
                                       err_msg=name)


@pytest.mark.parametrize("case", ["binary", "triple", "rad_prior", "padded"])
def test_float64_walkers_on_float32_target(case):
    """JAX evaluates float64 walkers on a float32 target in float64; so does the port,
    through one cached promoted copy of the target."""
    jt = _jax_target(case, jnp.float32)
    tt = target_from_jax(jt, device="cpu", dtype=torch.float32)
    P = _walkers(case, jt, seed=4)
    Pj, Pt = jnp.asarray(P), torch.from_numpy(P)
    for jfn, fn in ((jb.log_posterior_batch, batched.log_posterior_batch),
                    (jb.optimizer_chi2_batch, batched.optimizer_chi2_batch)):
        want = np.asarray(jax.jit(jfn)(Pj, jt))
        got = fn(Pt, tt)
        assert got.dtype == torch.float64 and want.dtype == np.float64
        np.testing.assert_array_equal(np.isfinite(got.numpy()), np.isfinite(want))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)
    promoted = batched.common_dtype(Pt, tt)[1]
    assert promoted is batched.common_dtype(Pt, tt)[1] and promoted.D.dtype == torch.float64
    assert batched.common_dtype(Pt.float(), tt)[1] is tt


# ---------------------------------------------------------------------------
# plain versions of the kernels vs the Pallas kernels (interpret mode), f32

EXACT = dict(median_iters=31, matmul_passes=6, recip_newton=0)
FAST = dict(median_iters=14, matmul_passes=6, recip_newton=2)


@pytest.mark.parametrize("case,dials", [
    ("binary", EXACT), ("single", EXACT), ("triple", EXACT), ("no_plx", EXACT),
    ("rad_prior", EXACT), ("nospec", EXACT),
    ("binary", FAST), ("triple", FAST), ("rad_prior", FAST),
])
def test_fused_reference_matches_pallas_interpret(case, dials):
    jt = dataclasses.replace(_jax_target(case, jnp.float32), **dials)
    tt = target_from_jax(jt, device="cpu", dtype=torch.float32)
    P = _walkers(case, jt, seed=1).astype(np.float32)
    ref = np.asarray(pk.log_posterior_fused(jnp.asarray(P), jt, interpret=True))
    before = dict(ck.LAUNCHES)
    got = ck.log_posterior_fused_reference(torch.from_numpy(P), tt).numpy()
    _assert_kernel_gate(got, ref)
    # the wrapper on CPU tensors is the plain version, and launches nothing
    np.testing.assert_array_equal(ck.log_posterior_fused(torch.from_numpy(P), tt).numpy(), got)
    assert ck.LAUNCHES == before


@pytest.mark.parametrize("dials", [EXACT, FAST])
@pytest.mark.parametrize("renorm", [True, False])
def test_spectrum_chi2_reference_matches_pallas_interpret(renorm, dials):
    jt = _jax_target("binary", jnp.float32)
    P = _walkers("binary", jt, seed=2)[:-1].astype(np.float32)  # in-grid walkers
    _, _, _, _, Wcomb = jb._forward_small(jnp.asarray(P), jt)
    av = jnp.asarray(P[:, 2])
    nT, nG, nd = jt.D.shape
    args = (Wcomb, av, jt.D.reshape(nT * nG, nd), jt.ext_k_data, jt.data_flux, jt.data_err,
            jt.V, jt.Vpinv, jt.med_data)
    kw = dict(iters=dials["median_iters"], mm_passes=dials["matmul_passes"],
              recip=dials["recip_newton"], renorm=renorm)
    ref = np.asarray(pk.spectrum_chi2(*args, interpret=True, **kw))
    targs = [torch.from_numpy(np.array(a)) for a in args]
    got = ck.spectrum_chi2_reference(*targs, **kw).numpy()
    np.testing.assert_allclose(got, ref, rtol=5e-5)
    np.testing.assert_array_equal(ck.spectrum_chi2(*targs, **kw).numpy(), got)


# ---------------------------------------------------------------------------
# dispatch


@pytest.fixture
def f32_target():
    return target_from_jax(_jax_target("binary", jnp.float32), device="cpu", dtype=torch.float32)


class _Recorder:
    def __init__(self, out):
        self.calls, self.out = [], out

    def __call__(self, *args, **kwargs):
        self.calls.append((args, kwargs))
        return self.out(*args)


def test_cpu_tensors_take_the_composition(monkeypatch, f32_target):
    def boom(*a, **k):
        raise AssertionError("a kernel wrapper was called for CPU tensors")

    monkeypatch.setattr(ck, "log_posterior_fused", boom)
    monkeypatch.setattr(ck, "spectrum_chi2", boom)
    P = torch.from_numpy(_walkers("binary", f32_target).astype(np.float32))
    assert batched.log_posterior_batch(P, f32_target).shape == (P.shape[0],)
    assert batched.optimizer_chi2_batch(P, f32_target).shape == (P.shape[0],)


def test_cuda_f32_dispatch(monkeypatch, f32_target):
    """On (simulated) CUDA f32 walkers: fusable -> K1; otherwise the spectrum
    term -> K3, renorm on for the posterior and off, with the exact median,
    for the annealer; nd above the one-block limit takes the segmented lane."""
    monkeypatch.setattr(batched, "_on_cuda_f32", lambda p: p.dtype == torch.float32)
    k1 = _Recorder(lambda p, tgt: torch.zeros(p.shape[0]))
    k3 = _Recorder(lambda Wcomb, *rest: torch.zeros(Wcomb.shape[0]))
    monkeypatch.setattr(ck, "log_posterior_fused", k1)
    monkeypatch.setattr(ck, "spectrum_chi2", k3)
    P = torch.from_numpy(_walkers("binary", f32_target).astype(np.float32))
    prod = dataclasses.replace(f32_target, median_iters=14, recip_newton=2, matmul_passes=3)

    batched.log_posterior_batch(P, prod)
    assert len(k1.calls) == 1 and not k3.calls

    batched.optimizer_chi2_batch(P, prod)
    assert len(k3.calls) == 1 and k3.calls[0][1]["renorm"] is False
    assert k3.calls[0][1]["iters"] == 31 and k3.calls[0][1]["recip"] == 2

    # no contrast block: not fusable, the spectrum term still takes K3
    no_c = dataclasses.replace(prod, cmag=prod.cmag[:0], cerr=prod.cerr[:0],
                               Fc=prod.Fc[..., :0].contiguous())
    assert not batched._fusable(no_c)
    batched.log_posterior_batch(P, no_c)
    assert len(k3.calls) == 2 and len(k1.calls) == 1
    assert k3.calls[-1][1]["renorm"] is True and k3.calls[-1][1]["iters"] == 14

    # padded targets ("xla" backend) and f64 walkers take the composition
    batched.log_posterior_batch(P, dataclasses.replace(prod, spectrum_backend="xla"))
    f64 = target_from_jax(_jax_target("binary", jnp.float64), device="cpu",
                          dtype=torch.float64)
    batched.log_posterior_batch(P.double(), f64)
    batched.optimizer_chi2_batch(P.double(), f64)
    assert len(k1.calls) == 1 and len(k3.calls) == 2

    from mcmc_spec_tpu_torch.ops import spec_segmented

    seg = _Recorder(lambda Wcomb, *rest: torch.zeros(Wcomb.shape[0]))
    monkeypatch.setattr(spec_segmented, "spectrum_chi2_segmented", seg)
    nT, nG, _ = prod.D.shape
    wide = dataclasses.replace(prod, D=torch.zeros(nT, nG, batched.LARGE_ND + 1))
    assert not batched._fusable(wide)
    batched.log_posterior_batch(P, wide)
    batched.optimizer_chi2_batch(P, wide)
    assert len(seg.calls) == 2 and len(k1.calls) == 1 and len(k3.calls) == 2
    assert seg.calls[0][1]["renorm"] is True and seg.calls[0][1]["iters"] == 14
    assert seg.calls[1][1]["renorm"] is False and seg.calls[1][1]["iters"] == 31


def test_wrappers_refuse_other_devices(f32_target):
    P = torch.empty((4, 6), device="meta")
    with pytest.raises(ValueError, match="not supported"):
        ck.log_posterior_fused(P, f32_target)
    W = torch.empty((4, 56), device="meta")
    with pytest.raises(ValueError, match="not supported"):
        ck.spectrum_chi2(W, W[:, 0], W, W[0], W[0], W[0], W, W, 1.0, iters=31, mm_passes=6,
                         recip=0)


def test_unset_dials_raise(f32_target):
    unset = dataclasses.replace(f32_target, median_iters=0, matmul_passes=0, recip_newton=-1)
    P = torch.from_numpy(_walkers("binary", f32_target).astype(np.float32))
    with pytest.raises(ValueError, match="dials unset"):
        ck.log_posterior_fused(P, unset)


def test_cuda_build_finds_no_nvcc_and_keys_on_sources(monkeypatch, tmp_path):
    from mcmc_spec_tpu_torch.runtime import cuda_build

    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_build, "DEFAULT_NVCC", tmp_path / "nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.find_nvcc()

    src = tmp_path / "csrc"
    src.mkdir()
    for name in cuda_build.SOURCES + cuda_build.HEADERS:
        (src / name).write_bytes((cuda_build.CSRC / name).read_bytes())
    monkeypatch.setattr(cuda_build, "CSRC", src)
    first = cuda_build.library_path()
    assert first == cuda_build.library_path()
    (src / cuda_build.HEADERS[0]).write_text("// edited\n")
    assert cuda_build.library_path() != first
