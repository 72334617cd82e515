"""PyTorch port: the K1 redesign experiments vs the JAX package's scripts (CPU).

The JAX scripts (``scripts/try_transposed_epilogue.py``,
``scripts/try_whileloop_median.py``, ``scripts/try_packed_median.py``,
``scripts/try_mxu_overlap.py``) are loaded from their files as
``tests/test_torch_scripts.py`` loads them (shrunken shapes, interpret-mode
Pallas).  On the same numpy-seeded inputs the plain versions of the port's
kernels must give

* S9 ``median_adaptive`` and S7 ``median_packed``: the JAX bodies' bits and
  ``np.median``'s, at an even and an odd row width, with ties and zeros;
* S8 ``posterior_transposed``: the JAX kernel and the port's K1 plain version
  within the JAX kernel gate, at the exact dials (31, 6, 0) and (14, 6, 2);
* S5 ``spectrum_overlap``: every mode within the gate of the JAX ``_kernel``
  mode (``MM = 6``, the f32 product the port computes), and ``stagger2`` /
  ``stagger4`` equal to ``baseline`` bit for bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mcmc_spec_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from mcmc_spec_tpu_torch.scripts import try_fast_recip as fr  # noqa: E402
from mcmc_spec_tpu_torch.scripts import try_mxu_overlap as s5  # noqa: E402
from mcmc_spec_tpu_torch.scripts import try_packed_median as s7  # noqa: E402
from mcmc_spec_tpu_torch.scripts import try_transposed_epilogue as s8  # noqa: E402
from mcmc_spec_tpu_torch.scripts import try_whileloop_median as s9  # noqa: E402
from mcmc_spec_tpu_torch.scripts import vpu_microbench as vb  # noqa: E402
from tests.test_torch_scripts import (EXACT, FAST, ND, NW, _binary_target,  # noqa: E402,F401
                                      _binary_walkers, _explain_median, _gate, _load,
                                      jax_script)

ND_ODD = ND - 1


def _bits(a):
    return np.ascontiguousarray(a, dtype=np.float32).view(np.int32)


def _with_ties_and_zeros(x):
    """Rows with ties, with more than half zeros, with every value equal, and a zero."""
    nd = x.shape[1]
    x[3, : nd // 2] = x[3, 0]
    x[5, : nd // 2 + 1] = 0.0
    x[7, :] = x[7, 0]
    x[9, 0] = 0.0
    return x


# ---------------------------------------------------------------------------
# S8 (try_transposed_epilogue)


@pytest.mark.parametrize("dials", [EXACT, FAST], ids=["exact", "fast"])
def test_posterior_transposed_reference_matches_jax(dials):
    jmod = _load("try_transposed_epilogue")
    jt, tt = _binary_target(dials)
    P = _binary_walkers(jt)  # 24 walkers with Av = 0, Av < 0, T edges, far out of bounds
    want = np.asarray(jmod.log_posterior_fused_T(jnp.asarray(P), jt, block=8, interpret=True))
    tP = torch.from_numpy(P)
    got = s8.posterior_transposed_reference(tP, tt).numpy()
    assert got.shape == (P.shape[0],)
    assert not np.isfinite(got).all() and np.isfinite(got).any()
    _gate(got, want)
    _gate(got, ck.log_posterior_fused_reference(tP, tt).numpy())
    before = dict(ck.LAUNCHES)
    np.testing.assert_array_equal(s8.posterior_transposed(tP, tt).numpy(), got)
    assert ck.LAUNCHES == before


@pytest.mark.parametrize("kw", [dict(nspec=3), dict(fit_plx=False), dict(rad_prior=True),
                                dict(dist_fit=False), dict(spectrum_weight=0.0)],
                         ids=["nspec3", "no_plx", "rad_prior", "no_dist_fit", "nospec"])
def test_posterior_transposed_rejects_out_of_scope_targets(kw):
    jt, tt = _binary_target(EXACT)
    tt = dataclasses.replace(tt, **kw)
    P = torch.from_numpy(_binary_walkers(jt, n=2))
    for fn in (s8.posterior_transposed, s8.posterior_transposed_reference):
        with pytest.raises(ValueError, match="posterior_transposed covers"):
            fn(P, tt)


# ---------------------------------------------------------------------------
# S9 (try_whileloop_median)


@pytest.mark.parametrize("nd", [ND, ND_ODD])
def test_median_adaptive_reference_matches_jax_bits(jax_script, monkeypatch, nd):
    jmod = jax_script("try_whileloop_median")
    monkeypatch.setattr(jmod, "B", 32)
    monkeypatch.setattr(jmod, "ND", nd)
    x = _with_ties_and_zeros(s9.synthetic_rows(NW, nd))
    ref = np.median(x, axis=1).astype(np.float32)
    med, passes = s9.median_adaptive(torch.from_numpy(x))
    assert med.shape == (NW, 1) and passes.dtype == torch.int32
    for kern, got in ((jmod.kernel_adaptive, med.numpy()),
                      (jmod.kernel_fixed, vb.median_only(torch.from_numpy(x), 31).numpy())):
        want = np.asarray(jmod.run(kern, jnp.asarray(x), NW // 32))
        np.testing.assert_array_equal(_bits(got), _bits(want))
        np.testing.assert_array_equal(got[:, 0], ref)
    # a row stops at a check (k >= 14, k % 3 == 2, so after 15, 18, ... passes) or at 31
    p = passes.numpy()
    assert ((p == 31) | ((p >= 15) & (p % 3 == 0))).all()


class _RecordingNumpy:
    """numpy, with ``median`` keeping the arrays it is given."""

    def __init__(self):
        self.seen = []

    def __getattr__(self, name):
        return getattr(np, name)

    def median(self, a, *args, **kwargs):
        self.seen.append(np.array(a))
        return np.median(a, *args, **kwargs)


def test_median_adaptive_rows_are_the_jax_scripts(jax_script, monkeypatch):
    jmod = jax_script("try_whileloop_median")
    monkeypatch.setattr(jmod, "B", 8)
    rec = _RecordingNumpy()
    monkeypatch.setattr(jmod, "np", rec)
    monkeypatch.setattr(jmod, "run", lambda kern, q, nblocks: jnp.ones((q.shape[0], 1), q.dtype))
    jmod.main()
    np.testing.assert_array_equal(rec.seen[0], s9.synthetic_rows(8 * 16, ND))


# ---------------------------------------------------------------------------
# S7 (try_packed_median)


@pytest.mark.parametrize("nd", [ND, ND_ODD])
def test_median_packed_reference_matches_jax_bits(jax_script, nd):
    jmod = jax_script("try_packed_median")
    x = _with_ties_and_zeros(s7.synthetic_rows(NW, nd, seed=nd))
    got = s7.median_packed(torch.from_numpy(x)).numpy()
    assert got.shape == (NW, 1)
    want = np.asarray(jmod.run_kernel(jmod._row_median_nonneg_16, jnp.asarray(x))(jnp.asarray(x)))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(got[:, 0], np.median(x, axis=1))
    np.testing.assert_array_equal(_bits(got), _bits(vb.median_only(torch.from_numpy(x), 31)))


# ---------------------------------------------------------------------------
# S5 (try_mxu_overlap)


@pytest.mark.parametrize("mode", s5.MODES)
def test_spectrum_overlap_reference_matches_jax(jax_script, monkeypatch, mode):
    jmod = jax_script("try_mxu_overlap")
    monkeypatch.setattr(jmod, "MM", 6)
    arrays = fr.synthetic_arrays(nw=NW, nd=ND)
    want = np.asarray(jmod.run(*(jnp.asarray(a) for a in arrays), mode=mode))
    targs = [torch.from_numpy(a) for a in arrays]
    got = s5.spectrum_overlap_reference(*targs, mode=mode).numpy()
    assert got.shape == (NW, 1)
    explained = list(arrays)
    if mode == "nomxu":
        explained[1], explained[3] = arrays[1][:, :1], arrays[3][:1]
    _gate(got, want, explain=lambda w: _explain_median(explained, w, iters=s5.ITERS))
    before = dict(ck.LAUNCHES)
    out = s5.spectrum_overlap(*targs, mode=mode).numpy()
    assert ck.LAUNCHES == before
    np.testing.assert_array_equal(_bits(out), _bits(got))
    base = s5.spectrum_overlap(*targs, mode="baseline").numpy()
    if mode == "nomxu":
        assert not np.allclose(out, base)
    else:
        np.testing.assert_array_equal(_bits(out), _bits(base))
    if mode == "baseline":  # S4 at recip 2
        np.testing.assert_array_equal(_bits(out), _bits(fr.spectrum_recip(*targs, recip=2)))


# ---------------------------------------------------------------------------
# wrappers and entry points


def test_redesign_wrappers_reject_bad_arguments():
    x = torch.ones((4, 8))
    for fn in (s9.median_adaptive, s7.median_packed):
        with pytest.raises(ValueError):
            fn(x.double())
        with pytest.raises(ValueError):
            fn(x[0])
    args = fr.synthetic_inputs("cpu", nw=4, nd=16)
    with pytest.raises(ValueError, match="unknown mode"):
        s5.spectrum_overlap(*args, mode="stagger8")
    with pytest.raises(ValueError):
        s5.spectrum_overlap(*args, mode="baseline", recip=-1)
    with pytest.raises(ValueError):
        s5.spectrum_overlap(*args, mode="baseline", iters=32)


def test_redesign_mains_run_on_cpu(capsys):
    r9 = s9.main(device="cpu", nw=32, nd=64)
    assert set(r9) == {"fixed31", "adaptive", "mean_passes", "sweeps"}
    assert 15 <= r9["mean_passes"] <= 31
    r7 = s7.main(device="cpu", nw=32, nd=64)
    assert r7["base31"] > 0 and r7["packed"] > 0
    r5 = s5.main(device="cpu", nw=16, nd=96, grid_step=16.0)
    assert set(r5) == {"synthetic", "production"}
    assert all(set(t) == set(s5.MODES) for t in r5.values())
    r8 = s8.main(device="cpu", nwalk=16, nd=96, grid_step=16.0)
    assert r8["rel"] < s8.RTOL
    out = capsys.readouterr().out
    assert "host-clock times of the plain versions, not device times" in out
    assert "bit-identical to baseline: True" in out and "row-build marginal" in out
    assert "np.median-identical = True" in out and "transposed epilogue" in out


def test_redesign_mains_need_a_card_for_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (s9.main, s7.main, s5.main, s8.main):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            main()
