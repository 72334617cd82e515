"""PyTorch port: the truth-recovery tools against the JAX package's scripts (CPU).

``scripts/synth_recovery_matrix.py`` and ``scripts/synth_recovery_extra.py``
are loaded from their files and run on the same written filter curves and
wavelength template (``recovery_fixtures.write_reference``, standing in for the
reference's data directory) in the same working directory, so that both share
one grid cache and write the same paths.  Both scripts' fit stages are
replaced by one stub that returns the same numpy samples for the same param
file.  Then:

* the fixture param files and observed spectra are byte for byte JAX's, the
  truth vectors bit for bit, and the noisy magnitudes' forward models in
  float32 within 2e-5 mag of JAX's (the files carry them to 4 decimals);
* the z rows are JAX's and the calibration verdicts and lines identical,
  on the stub fits and on designed z matrices that pass and fail each gate;
* the templates, the matrix's pairs, the lanes' fixtures and
  ``card_validation``'s shape list are the JAX scripts'.

Every ``main()`` runs here with the stub fit, and the card scripts raise
without a card.
"""
import contextlib
import io
import json
import os
import re
import types
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import mcmc_spec_tpu.pipeline as jpipe  # noqa: E402
from mcmc_spec_tpu.models.mist import MistTable as JaxMistTable  # noqa: E402
from mcmc_spec_tpu_torch.scripts import card_validation as cv  # noqa: E402
from mcmc_spec_tpu_torch.scripts import recovery_fixtures as rf  # noqa: E402
from mcmc_spec_tpu_torch.scripts import synth_recovery_extra as sx  # noqa: E402
from mcmc_spec_tpu_torch.scripts import synth_recovery_matrix as sm  # noqa: E402
from tests.test_torch_scripts import _load  # noqa: E402

PAIRS = sm.T_PAIRS[:2]
LANE_CASES = [sx.fixtures()[0], sx.fixtures()[3]]  # the first triple, the first nospec


def stub_samples(cfg, n=400):
    """The same samples for the same param file: a seeded cloud around its truth."""
    truth = np.asarray(cfg.real_values, np.float64)
    rng = np.random.RandomState(zlib.crc32(cfg.fname.encode()))
    return truth * (1.0 + 0.01 * rng.randn(n, len(truth)) + 0.004 * rng.randn(len(truth)))


def port_fit(fx, device):
    """The port's stub fit stage: the context of the fixture, no stage run."""
    cfg = rf.load_config(fx.paramfile, fx.spectrum_weight)
    return types.SimpleNamespace(cfg=cfg, target=rf.pipeline.setup_context(
        cfg, device=device).target), stub_samples(cfg)


def _files(work):
    """{name: bytes} of the param files and observations in ``work``."""
    out = {}
    for name in sorted(os.listdir(work)):
        if name.startswith(("param_", "synth_spec_")):
            with open(os.path.join(work, name), "rb") as f:
                out[name] = f.read()
    return out


@pytest.fixture(scope="module")
def recovery(tmp_path_factory):
    """Both packages' matrix and lane fixtures in one working directory: the JAX
    scripts' outputs, then the port's."""
    work = str(tmp_path_factory.mktemp("recovery"))
    ref = rf.write_reference(os.path.join(work, "reference"))
    mp = pytest.MonkeyPatch()
    cwd = os.getcwd()
    jax_summ = []
    try:
        os.chdir(work)
        jm, jx = _load("synth_recovery_matrix"), _load("synth_recovery_extra")
        for mod in (jm, jx):
            mp.setattr(mod, "REF", ref)
        mp.setattr(jm, "T_PAIRS", PAIRS)
        mp.setattr(jm, "tempfile", types.SimpleNamespace(mkdtemp=lambda prefix: work))
        mp.setattr(jm, "shutil", types.SimpleNamespace(rmtree=lambda *a, **k: None))
        mp.setattr(jpipe, "run_optimize_stage", lambda ctx: None)
        mp.setattr(jpipe, "run_mcmc_stage", lambda ctx, **kw: stub_samples(ctx.cfg))
        import mcmc_spec_tpu.inference.posterior as jpost

        real_summary = jpost.forward_summary

        def recording_summary(p, tgt):
            out = real_summary(p, tgt)
            jax_summ.append({k: np.asarray(out[k]) for k in ("contrasts", "phot_mags")})
            return out

        mp.setattr(jpost, "forward_summary", recording_summary)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            jm.main()
            os.chdir(work)
            jax_lanes = [jx.run_fixture(tag, teffs, nospec=nospec, seed=seed)
                         for tag, teffs, nospec, seed in LANE_CASES]
        jax_out = buf.getvalue()
        jax_files = _files(work)

        port_fx = [sm.matrix_fixture(i, t1, t2, work, ref, "cpu")
                   for i, (t1, t2) in enumerate(PAIRS)]
        port_summ = []
        real_port = rf.forward_summary

        def port_recording(p, tgt):
            out = real_port(p, tgt)
            port_summ.append({k: out[k].numpy() for k in ("contrasts", "phot_mags")})
            return out

        mp.setattr(rf, "forward_summary", port_recording)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            port_rows = sm.run(work, ref, "cpu", PAIRS, fit=port_fit)
            sm.verdict(port_rows)
            port_lanes = [sx.run_fixture(tag, teffs, work, ref, nospec, seed, "cpu",
                                         fit=port_fit)
                          for tag, teffs, nospec, seed in LANE_CASES]
        port_out = buf.getvalue()
        port_files = _files(work)
    finally:
        os.chdir(cwd)
        mp.undo()
    return types.SimpleNamespace(
        work=work, ref=ref, jax_out=jax_out, jax_files=jax_files, jax_lanes=jax_lanes,
        jax_summ=jax_summ, port_out=port_out, port_files=port_files, port_rows=port_rows,
        port_lanes=port_lanes, port_summ=port_summ, port_fx=port_fx)


def _jax_rows(out):
    return next(json.loads(ln) for ln in out.splitlines() if ln.startswith("[{"))


def _verdict_block(out):
    """The lines from ``worst |z|`` to ``calibration:``."""
    lines = out.splitlines()
    start = next(i for i, ln in enumerate(lines) if ln.startswith("worst |z|"))
    end = next(i for i, ln in enumerate(lines) if ln.startswith("calibration:"))
    return lines[start:end + 1]


MAG_LINE = re.compile(r"^(cmag|pmag) \[(.*)\]$")


def test_fixture_files_are_jax_files(recovery):
    """The observations byte for byte; the param files line for line, the noisy
    magnitudes (float32 forward models, written to 4 decimals) within one unit of the
    last decimal, every other line byte for byte."""
    names = sorted(recovery.jax_files)
    assert names == sorted(recovery.port_files)
    assert len([n for n in names if n.startswith("param_")]) == len(PAIRS) + len(LANE_CASES)
    for name in names:
        got, want = recovery.port_files[name], recovery.jax_files[name]
        if name.startswith("synth_spec_"):
            assert got == want, name
            continue
        got, want = got.decode().splitlines(), want.decode().splitlines()
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            mg, mw = MAG_LINE.match(g), MAG_LINE.match(w)
            if mg and mw and mg.group(1) == mw.group(1):
                np.testing.assert_allclose([float(v) for v in mg.group(2).split(",")],
                                           [float(v) for v in mw.group(2).split(",")],
                                           rtol=0, atol=1.01e-4, err_msg=f"{name}: {g} / {w}")
            else:
                assert g == w, name


def test_truth_vectors_are_jax_truths():
    mist = JaxMistTable.builtin()
    for t1, t2 in PAIRS:
        r1, r2 = float(mist.get_radius(t1)), float(mist.get_radius(t2))
        want = np.array([t1, t2, 0.12, r1, r2 / r1, 2.0e-3])
        np.testing.assert_array_equal(rf.truth_of((t1, t2)), want)
    teffs = sx.TRIPLE
    radii = [float(mist.get_radius(t)) for t in teffs]
    want = np.array(list(map(float, teffs)) + [0.12, radii[0]]
                    + [r / radii[0] for r in radii[1:]] + [2.0e-3])
    np.testing.assert_array_equal(rf.truth_of(teffs), want)


def test_forward_magnitudes_match_jax(recovery):
    """The noise-free contrasts and photometry at the truth, float32 on both sides."""
    assert len(recovery.port_summ) == len(recovery.jax_summ) > 0
    for got, want in zip(recovery.port_summ, recovery.jax_summ):
        for key in ("contrasts", "phot_mags"):
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=2e-5, err_msg=key)


def test_noisy_magnitudes_match_jax_files(recovery):
    """The fixtures' noisy magnitudes as the param files carry them (4 decimals)."""
    for fx in recovery.port_fx:
        text = recovery.jax_files[os.path.basename(fx.paramfile)].decode()
        for key, vals in (("cmag", fx.cmag), ("pmag", fx.pmag)):
            line = re.search(rf"^{key} \[(.*)\]$", text, re.M).group(1)
            np.testing.assert_allclose([float(v) for v in line.split(",")], vals, rtol=0,
                                       atol=5.1e-5)


def test_matrix_rows_and_verdict_match_jax(recovery):
    want = _jax_rows(recovery.jax_out)
    got = recovery.port_rows
    assert [(r["t1"], r["t2"], r["shift"], r["sigma"]) for r in got] == \
        [(r["t1"], r["t2"], r["shift"], r["sigma"]) for r in want]
    # the JAX line names 12 fixtures whatever their number
    want = _verdict_block(recovery.jax_out)
    want[0] = want[0].replace("across 12 fixtures", f"across {len(PAIRS)} fixtures")
    assert _verdict_block(recovery.port_out) == want


def test_lane_rows_match_jax(recovery):
    for got, want in zip(recovery.port_lanes, recovery.jax_lanes, strict=True):
        for key in ("tag", "labels", "truth", "median", "sigma", "z"):
            assert got[key] == want[key], key


# ---------------------------------------------------------------------------
# the verdicts on designed z matrices


def _designed_z(case, n, p, seed=4):
    rng = np.random.RandomState(seed)
    Z = np.round(rng.randn(n, p), 3)
    if case == "bias":
        Z[:, 1] += 1.5
    elif case == "wide":
        Z[:, 2] *= 3.0
    elif case == "narrow":
        Z[:, 0] *= 0.2
    return Z


@pytest.mark.parametrize("case", ["pass", "bias", "wide", "narrow"])
def test_matrix_verdict_matches_jax(case, monkeypatch, tmp_path):
    """The JAX matrix's main with every fixture stage stubbed, its samples chosen to
    give the designed z; its verdict against the port's on the z rows it printed."""
    import mcmc_spec_tpu.inference.posterior as jpost

    jm = _load("synth_recovery_matrix")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(jm, "tempfile", types.SimpleNamespace(mkdtemp=lambda prefix: "."))
    monkeypatch.setattr(jm, "shutil", types.SimpleNamespace(rmtree=lambda *a, **k: None))
    ctx = types.SimpleNamespace(cfg=None, target=types.SimpleNamespace(
        data_flux=jnp.zeros(1, jnp.float32)))

    def setup(cfg):
        ctx.cfg = cfg
        return ctx

    z_rows = iter(_designed_z(case, len(sm.T_PAIRS), 6))
    base = np.array([-1.0, 0.0, 1.0]) * np.sqrt(1.5)  # median 0, std 1

    def samples(ctx, **kw):
        truth = np.asarray(ctx.cfg.real_values)
        return truth + 0.01 * np.abs(truth) * (next(z_rows)[None, :] + base[:, None])

    monkeypatch.setattr(jpipe, "setup_context", setup)
    monkeypatch.setattr(jpipe, "make_synthetic_observation", lambda *a, **k: None)
    monkeypatch.setattr(jpipe, "run_optimize_stage", lambda ctx: None)
    monkeypatch.setattr(jpipe, "run_mcmc_stage", samples)
    monkeypatch.setattr(jpost, "forward_summary",
                        lambda p, t: dict(contrasts=np.zeros(2), phot_mags=np.zeros(6)))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jm.main()
    out = buf.getvalue()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ok = sm.verdict(_jax_rows(out))
    assert _verdict_block(buf.getvalue()) == _verdict_block(out)
    assert ok == ("calibration: PASS" in out) == (case in ("pass", "narrow"))
    assert ("[conservative/prior-dominated width]" in out) == (case == "narrow")


@pytest.mark.parametrize("case", ["pass", "bias", "wide"])
def test_lane_verdict_and_fixtures_match_jax(case, monkeypatch, tmp_path):
    """The JAX lanes' main with ``run_fixture`` replaced by one that records its
    fixtures and returns designed rows; its lines against ``calibration_lanes``."""
    jx = _load("synth_recovery_extra")
    monkeypatch.chdir(tmp_path)
    calls, rows = [], []
    Z = {False: _designed_z(case, 3, 8), True: _designed_z(case, 3, 6, seed=5)}

    def run_fixture(tag, teffs, nospec=False, seed=7):
        k = sum(c[2] == nospec for c in calls)
        calls.append((tag, tuple(teffs), nospec, seed))
        rows.append(dict(tag=tag, labels=sx.labels_of(len(teffs)),
                         z=[float(v) for v in Z[nospec][k]]))
        return rows[-1]

    monkeypatch.setattr(jx, "run_fixture", run_fixture)
    monkeypatch.setattr(jx, "tempfile", types.SimpleNamespace(
        mkdtemp=lambda prefix: str(tmp_path)))
    monkeypatch.setattr(jx, "shutil", types.SimpleNamespace(rmtree=lambda *a, **k: None))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jx.main()
    out = buf.getvalue().splitlines()
    assert calls == [(tag, tuple(teffs), nospec, seed)
                     for tag, teffs, nospec, seed in sx.fixtures()]
    ok, lines = rf.calibration_lanes(rows)
    verdict = next(ln for ln in out if ln.startswith("calibration:"))
    want = [ln for ln in out[:out.index(verdict)] if ln and not ln.startswith("devices:")]
    assert [ln for ln in "\n".join(lines).splitlines() if ln] == want
    assert verdict == "calibration: " + ("PASS" if ok else "FAIL")
    assert ok == (case == "pass")
    # one lane alone (a bisection's subset): only its lines
    _, triple = rf.calibration_lanes([r for r in rows if r["tag"].startswith("triple")])
    assert [ln for ln in triple if ln] == lines[:len(triple)]


# ---------------------------------------------------------------------------
# the scripts' constants against JAX's


def test_templates_pairs_and_shapes_are_jax(monkeypatch, capsys):
    import mcmc_spec_tpu.inference.batched as jb
    import mcmc_spec_tpu.ops.pallas_kernels as pk
    from mcmc_spec_tpu import bench_target as jbench

    jm, jx = _load("synth_recovery_matrix"), _load("synth_recovery_extra")
    assert rf.MATRIX_TEMPLATE == jm.PARAM_TEMPLATE
    assert rf.LANE_TEMPLATE == jx.PARAM_TEMPLATE
    assert sm.T_PAIRS == jm.T_PAIRS and sm.LABELS == jm.LABELS
    assert (rf.TRUTH_AV, rf.TRUTH_PLX) == (jm.TRUTH_AV, jm.TRUTH_PLX) == (jx.TRUTH_AV,
                                                                          jx.TRUTH_PLX)
    # the JAX shape sweep's cases: its kernels and references replaced by stubs, its
    # targets on a coarse grid, so that only its labels are real
    jv = _load("tpu_validation")
    stub = lambda *a, **k: np.zeros(1)
    for name in ("spectrum_chi2", "log_posterior_fused", "spectrum_chi2_fleet",
                 "log_posterior_fleet_fused"):
        monkeypatch.setattr(pk, name, stub)
    monkeypatch.setattr(jb, "_spec_chi2_xla", stub)
    monkeypatch.setattr(jb, "log_posterior_batch", stub)
    monkeypatch.setattr(jb, "_forward_small", lambda P, t: (0, 0, 0, 0, 0))
    monkeypatch.setattr(jv, "jax", types.SimpleNamespace(vmap=lambda f: f))
    monkeypatch.setattr(jv, "_walker_cloud", lambda tgt, truth, nw, seed=11: jnp.ones((2, 8)))
    monkeypatch.setattr(jv, "build_bench_target", lambda *a, **k: jbench.build_bench_target(
        *a, **dict(k, grid_step=64.0)))
    jv.kernel_shape_sweep()
    labels = re.findall(r"^  (\S+) (?:nd=(\d+) )?nw=(\d+): ok$", capsys.readouterr().out, re.M)
    assert len(labels) == len(cv.shapes())
    assert [(k, nd or str(cv.FLEET_ND[1]), nw) for k, nd, nw in labels] == \
        [(k, str(nd), str(nw)) for k, nd, nw in cv.shapes()]


# ---------------------------------------------------------------------------
# the mains with the stub fit, and no card


def test_mains_run_on_the_cpu(recovery, monkeypatch, capsys):
    """Each main in a fresh working directory that shares the grid cache built above."""
    cache = os.path.join(recovery.work, ".grid_cache")

    def mkdtemp(prefix):
        d = os.path.join(recovery.work, prefix + str(len(os.listdir(recovery.work))))
        os.makedirs(d)
        os.symlink(cache, os.path.join(d, ".grid_cache"))
        return d

    for mod in (sm, sx):
        monkeypatch.setattr(mod.tempfile, "mkdtemp", mkdtemp)
    out = sm.main(["--cpu"], pairs=PAIRS[:1], fit=port_fit)
    assert len(out["rows"]) == 1 and isinstance(out["ok"], bool)
    out = sx.main(["--cpu"], cases=LANE_CASES, fit=port_fit)
    assert [r["tag"] for r in out["rows"]] == [c[0] for c in LANE_CASES]
    text = capsys.readouterr().out
    assert "calibration:" in text and "[triple] per-parameter z" in text


def test_card_validation_main_on_the_cpu(monkeypatch, capsys):
    """``--shapes-only`` on the kernels' plain versions at a small width; the whole
    main with the fit cut short."""
    monkeypatch.setattr(cv, "SINGLE_ND", (256,))
    monkeypatch.setattr(cv, "SINGLE_NW", (9,))
    monkeypatch.setattr(cv, "FLEET_ND", (200, 256))
    monkeypatch.setattr(cv, "FLEET_NW", (3,))
    assert cv.main(["--shapes-only"], device="cpu") == 0
    assert "SHAPE SWEEP PASSED" in capsys.readouterr().out
    ok = cv.recovery_fit("cpu", nwalk=12, anneal_steps=2, nseed=8, n_steps=8, thin=4, drop=0)
    assert isinstance(ok, bool) and "in95%" in capsys.readouterr().out


@pytest.mark.parametrize("main", [lambda: sm.main([]), lambda: sx.main([])])
def test_recovery_scripts_raise_without_a_card(main):
    with pytest.raises(RuntimeError, match="no CUDA card"):
        main()
