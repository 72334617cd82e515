"""Synthetic-truth recovery fixtures, shared by ``synth_recovery_matrix``,
``synth_recovery_extra`` and ``chip_smoke.py``.

A fixture is built as the JAX package's recovery scripts build it
(``scripts/synth_recovery_matrix.py``, ``scripts/synth_recovery_extra.py``):

1. a context on the wavelength template (``setup_context`` of a param file
   whose data file is the template), and ``pipeline.make_synthetic_observation``
   of the composite at the truth, 1 % noise, written as the fixture's
   observed spectrum; the observed contrasts and photometry are the
   ``forward_summary`` of the truth plus 0.02 mag noise from a second seed;
2. the real param file, on that observation and those magnitudes, which the
   two-stage pipeline then fits (``fit``).

The radii are the builtin MIST track's at each temperature; Av = 0.12 and the
parallax 2 mas are the truths.

The JAX scripts read the wavelength template ``koi2298_HET.txt`` and the
filter curves ``bps/`` from the reference's data directory, which the
repository does not hold.  ``write_reference`` writes both into a directory
of its own: the curves with ``testing.write_filter_curves`` and the template
on ``testing.data_wavelengths(1792)``, the koi2298 widths (the flux is a
placeholder: only the wavelengths reach the fixture).  The param files name
that directory as the JAX ones name the reference's.

``calibration_matrix`` and ``calibration_lanes`` are the two scripts'
verdicts: per parameter, z = (median - truth) / sigma over the fixtures,
``bias_ok`` when |mean z| < 3 max(std z, 0.3) / sqrt(n), and ``width_ok``
when std z < 1.8 (the matrix) or max |z| < 3.5 (the lanes).
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from mcmc_spec_tpu_torch import pipeline
from mcmc_spec_tpu_torch.inference.posterior import forward_summary
from mcmc_spec_tpu_torch.models.mist import MistTable
from mcmc_spec_tpu_torch.testing import data_wavelengths, write_filter_curves
from mcmc_spec_tpu_torch.utils.config import FitConfig

TRUTH_AV, TRUTH_PLX = 0.12, 2.0e-3
TEMPLATE_FILE = "koi2298_HET.txt"
TEMPLATE_ND = 1792
PMAG0 = [14.0, 13.5, 13.2, 12.2, 11.7, 11.6]  # the phase-1 placeholder photometry
NOISE_FRAC = 0.01
MAG_NOISE = 0.02

# scripts/synth_recovery_matrix.py's PARAM_TEMPLATE
MATRIX_TEMPLATE = """### synthetic-truth recovery fixture
models synthetic
dirname {dirname}
fname synth_{t1}_{t2}
res 1700
tmin 3000
tmax 5600
specmin 3000
specmax 30000
mask True
rad_prior False
filename {datafile}
spmin 0.645
spmax 0.84
cmag [{cmag}]
cerr [0.05,0.05]
cfilt ['lp600','Kp']
pmag [{pmag}]
perr [0.05,0.05,0.05,0.05,0.05,0.05]
pfilt ['sdss,r','sdss,i','sdss,z','j','h','k']
plx {plx}
plx_err 0.05e-3
dist_fit True
av {av}
av_err 0.05
ra 290.667
dec 44.5
nwalk 150
nstep 60
nspec 2
ndust 0
nburn 1000
nsteps 10000
real_values [{real}]
bps_dir {bps}
data_dir {ref}
"""

# scripts/synth_recovery_extra.py's PARAM_TEMPLATE
LANE_TEMPLATE = """### synthetic-truth recovery fixture ({tag})
models synthetic
dirname {dirname}
fname synth_{tag}
res 1700
tmin 3000
tmax 5600
specmin 3000
specmax 30000
mask True
rad_prior False
filename {datafile}
spmin 0.645
spmax 0.84
cmag [{cmag}]
cerr [{cerr}]
cfilt ['lp600','Kp']
pmag [{pmag}]
perr [0.05,0.05,0.05,0.05,0.05,0.05]
pfilt ['sdss,r','sdss,i','sdss,z','j','h','k']
plx {plx}
plx_err 0.05e-3
dist_fit True
av {av}
av_err 0.05
ra 290.667
dec 44.5
nwalk 150
nstep 60
nspec {nspec}
ndust 0
nburn 1000
nsteps 10000
real_values [{real}]
bps_dir {bps}
data_dir {ref}
"""


@dataclasses.dataclass
class Fixture:
    truth: np.ndarray
    paramfile: str
    cmag: np.ndarray
    pmag: np.ndarray
    spectrum_weight: float


def write_reference(ref: str) -> str:
    """Write the filter curves (``ref/bps``) and the wavelength template
    (``ref/koi2298_HET.txt``: wavelength, flux 1, error 0.01) into ``ref``; returns it."""
    os.makedirs(ref, exist_ok=True)
    write_filter_curves(os.path.join(ref, "bps"))
    wl = data_wavelengths(TEMPLATE_ND)
    np.savetxt(os.path.join(ref, TEMPLATE_FILE),
               np.column_stack([wl, np.ones_like(wl), np.full_like(wl, 0.01)]))
    return ref


def _fmt(vals) -> str:
    return ",".join(f"{v:.4f}" for v in np.atleast_1d(vals))


def matrix_param(work, ref, t1, t2, datafile, cmag, pmag, truth) -> str:
    """The matrix fixture's param file ``work/param_synth_{t1}_{t2}.txt``; returns its path."""
    path = os.path.join(work, f"param_synth_{t1}_{t2}.txt")
    with open(path, "w") as fh:
        fh.write(MATRIX_TEMPLATE.format(
            dirname=f"fit_{t1}_{t2}", t1=t1, t2=t2, datafile=datafile, cmag=_fmt(cmag),
            pmag=_fmt(pmag), plx=TRUTH_PLX, av=TRUTH_AV,
            real=",".join(f"{v:.6g}" for v in truth), bps=os.path.join(ref, "bps"), ref=ref))
    return path


def lane_param(work, ref, tag, datafile, cmag, pmag, truth, nspec) -> str:
    """The triple or nospec fixture's param file ``work/param_{tag}.txt``; returns its path."""
    path = os.path.join(work, f"param_{tag}.txt")
    cm = np.atleast_1d(cmag)
    with open(path, "w") as fh:
        fh.write(LANE_TEMPLATE.format(
            tag=tag, dirname=f"fit_{tag}", datafile=datafile, cmag=_fmt(cm),
            cerr=",".join("0.05" for _ in cm), pmag=_fmt(pmag), plx=TRUTH_PLX, av=TRUTH_AV,
            nspec=nspec, real=",".join(f"{v:.6g}" for v in truth),
            bps=os.path.join(ref, "bps"), ref=ref))
    return path


def truth_of(teffs) -> np.ndarray:
    """[T..., Av, R1, R2/R1, ..., plx]: the builtin MIST radii at ``teffs``."""
    mist = MistTable.builtin()
    radii = [float(mist.get_radius(t)) for t in teffs]
    return np.array(list(map(float, teffs)) + [TRUTH_AV, radii[0]]
                    + [r / radii[0] for r in radii[1:]] + [TRUTH_PLX])


def load_config(paramfile: str, spectrum_weight: float = 1.0, **overrides) -> FitConfig:
    cfg = FitConfig.from_file(paramfile)
    if spectrum_weight != 1.0:
        cfg.spectrum_weight = spectrum_weight
    for key, value in overrides.items():
        setattr(cfg, key, value)
    return cfg


def make_fixture(ref, teffs, write_param, datafile, obs_seed, mag_seed, cmag0, n_cnoise,
                 spectrum_weight=1.0, device="cuda") -> Fixture:
    """Build one fixture, its observation written to ``datafile``; run it in the working
    directory of the fit (the grid cache lives there).

    ``write_param(datafile, cmag, pmag, truth) -> path`` writes its param file;
    ``obs_seed`` seeds the spectrum's noise, ``mag_seed`` the magnitudes';
    ``cmag0`` are the phase-1 placeholder contrasts; ``n_cnoise`` contrast noise values
    are drawn (the matrix draws one per contrast, the lanes ``nspec - 1``, which a
    binary's two contrasts share) before the photometry's.
    """
    teffs = [int(t) for t in teffs]
    nspec = len(teffs)
    truth = truth_of(teffs)
    # phase 1: a context on the wavelength template, the observation synthesised on it
    p0 = write_param(os.path.join(ref, TEMPLATE_FILE), cmag0, PMAG0, truth)
    ctx = pipeline.setup_context(load_config(p0, spectrum_weight), device=device)
    pipeline.make_synthetic_observation(
        ctx, teffs, rad1=truth[nspec + 1], ratios=list(truth[nspec + 2: 2 * nspec + 1]),
        plx=TRUTH_PLX, out_path=datafile, noise_frac=NOISE_FRAC, seed=obs_seed, av=TRUTH_AV)
    # the observed contrasts and photometry: the forward model at the truth plus noise
    tgt = ctx.target
    summ = forward_summary(torch.as_tensor(truth, dtype=tgt.data_flux.dtype, device=tgt.device),
                           tgt)
    rng = np.random.RandomState(mag_seed)
    cmag = summ["contrasts"].cpu().numpy() + rng.normal(0, MAG_NOISE, n_cnoise)
    pmag = summ["phot_mags"].cpu().numpy() + rng.normal(0, MAG_NOISE, len(PMAG0))
    # phase 2: the real fixture
    paramfile = write_param(datafile, cmag, pmag, truth)
    return Fixture(truth, paramfile, cmag, pmag, spectrum_weight)


def fit(fx: Fixture, device="cuda", **overrides):
    """(context, samples): the two-stage pipeline on ``fx`` at the target's dials
    (``run_optimize_stage``, then ``run_mcmc_stage(nthin=100, check_convergence=True,
    mesh=None)``); ``overrides`` set fields of the param file's config (a depth cut)."""
    ctx = pipeline.setup_context(load_config(fx.paramfile, fx.spectrum_weight, **overrides),
                                 device=device)
    pipeline.run_optimize_stage(ctx)
    samples = pipeline.run_mcmc_stage(ctx, nthin=100, check_convergence=True, mesh=None)
    return ctx, samples


def z_scores(samples, truth):
    """(median, sigma, z = (median - truth) / sigma) of the samples per parameter."""
    med, sig = np.median(samples, axis=0), samples.std(axis=0)
    return med, sig, (med - truth) / sig


def _bias_ok(m, s, n):
    return abs(m) < 3.0 * max(s, 0.3) / np.sqrt(n)


def calibration_matrix(Z, labels):
    """(ok, lines): the matrix's verdict over z ``Z`` [fixtures, params].

    The failure that breaks science is overconfident error bars (std z >> 1);
    std z << 1 (a conservative or prior-dominated width, such as the parallax's
    under its 2.5 % prior) passes, annotated.
    """
    ok, lines = True, []
    for j, lab in enumerate(labels):
        m, s = float(np.mean(Z[:, j])), float(np.std(Z[:, j]))
        bias_ok = _bias_ok(m, s, len(Z))
        width_ok = s < 1.8
        note = " [conservative/prior-dominated width]" if s < 0.4 else ""
        ok &= bias_ok and width_ok
        lines.append(f"  {lab:>6}: mean z {m:+.3f} (bias {'ok' if bias_ok else 'FAIL'}), "
                     f"std z {s:.3f} ({'ok' if width_ok else 'FAIL'}){note}")
    return bool(ok), lines


def calibration_lanes(rows, lanes=("triple", "nospec")):
    """(ok, lines): the triple and nospec lanes' verdict over ``rows`` (each with ``tag``,
    ``labels`` and ``z``), lane by lane over its seeds; a lane without rows is skipped."""
    ok, lines = True, []
    for lane in lanes:
        lrows = [r for r in rows if r["tag"].startswith(lane)]
        if not lrows:
            continue
        Z = np.array([r["z"] for r in lrows])  # [nseed, nparam]
        n = len(lrows)
        lines.append(f"\n[{lane}] per-parameter z over {n} seeds:")
        for j, lab in enumerate(lrows[0]["labels"]):
            m, s = float(np.mean(Z[:, j])), float(np.std(Z[:, j]))
            zmax = float(np.max(np.abs(Z[:, j])))
            bias_ok = _bias_ok(m, s, n)
            width_ok = zmax < 3.5
            ok &= bias_ok and width_ok
            lines.append(f"  {lab:>6}: mean z {m:+.3f} ({'ok' if bias_ok else 'FAIL'}),"
                         f" max |z| {zmax:.3f} ({'ok' if width_ok else 'FAIL'})")
    return bool(ok), lines
