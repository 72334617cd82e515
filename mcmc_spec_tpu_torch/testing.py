"""Self-contained fit directories: filter curves, observed spectra, param files.

``write_fit_dir(root, ...)`` writes everything ``python -m
mcmc_spec_tpu_torch.cli -f <param>`` (or the JAX package's CLI) needs to fit
the ``models synthetic`` grid with no external data and no Vega file:

* ``bps/``: the filter curves of ``cfilt ['lp600','Kp']``, of the six
  photometric bands and of the report's Kepler and Gaia G bands, in the
  formats ``io.filters.load_transmission`` reads: ``lp600.csv`` (nm,
  comma-separated), ``keck_kp.txt`` (micron),
  ``SLOAN_SDSS.{r,i,z}prime_filter.dat``, ``2MASS_2MASS.Ks.dat`` and
  ``Kepler_Kepler.K.dat`` (Angstrom), ``gaia_g_pb.txt`` (nm), and 2MASS J
  and H as ``2mass_{j,h}_001_syn.fits``: minimal FITS files (a primary HDU,
  then a ``BINTABLE`` with big-endian ``WAVELENGTH`` and ``THROUGHPUT``
  ``D`` columns, every header and data unit padded to 2,880 bytes) written
  by :func:`write_fits_bintable`;
* the observed spectrum: ``pipeline.make_synthetic_observation`` at the
  stated truth, or a given ``(flux, err)`` on :func:`data_wavelengths`;
* ``.grid_cache/``: the packed grid, built once, where the fit will find it;
* ``param_synth.txt``: the param file, whose contrasts and photometry are
  the model's at the truth (a numpy integration of the composite through
  the curves; ``synth`` in the name skips the KIC->SDSS recalibration).

``write_fleet_dirs(root, nds, n_contrasts)`` writes a ragged fleet the same
way: one observation and one param file per target, each at its own truth
and data length, over one shared set of curves and one grid cache.
``write_btsettl_dir`` writes a model grid in the BT-Settl directory format
that ``SpectralGrid.from_btsettl_dir`` reads.

``write_result_dir(root, name)`` writes a system's result directory as the
population analysis reads it (``python -m mcmc_spec_tpu_torch.analysis``):
``samples.txt``, the radius-correction factors and the mass and luminosity
posteriors, drawn from a seed.

``make_setup(rad_prior)`` builds the JAX test suite's small synthetic fit
target (``tests/helpers.py`` ``make_setup``): the same grid, data, filters,
priors and random draws, with the observed contrasts and photometry taken
from the port's scalar forward model (``inference.posterior.forward_summary``).

``run_world(fn, nranks, *args)`` runs ``fn`` on every rank of a new
``torch.distributed`` process group of spawned processes (gloo by default) and
returns their results: the sharded paths (``parallel``) checked in one call.

Everything here is host numpy.  Run the fit with ``root`` as the working
directory: the param file's ``dirname`` is relative, and the grid cache is
looked up in ``.grid_cache/`` of the working directory.
"""
from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import types

import numpy as np

from mcmc_spec_tpu_torch.io.filters import FilterBank
from mcmc_spec_tpu_torch.io.spectra import apply_telluric_mask
from mcmc_spec_tpu_torch.models.mist import MistTable
from mcmc_spec_tpu_torch.ops.extinction import ccm89
from mcmc_spec_tpu_torch.ops.photometry import contrast_weights, photon_flux_weights
from mcmc_spec_tpu_torch.utils.config import FitConfig

BLOCK = 2880
# the bench target's truth: [T1, T2, Av, R1, R2/R1, plx]
TRUTH = (4600.0, 3400.0, 0.12, 0.72, 0.45, 2.0e-3)
CFILT = ("lp600", "Kp")
PFILT = ("sdss,r", "sdss,i", "sdss,z", "j", "h", "k")


def _card(key: str, value) -> str:
    if isinstance(value, bool):
        val = f"{'T' if value else 'F':>20}"
    elif isinstance(value, str):
        val = f"'{value:<8}'"
    else:
        val = f"{value:>20}"
    return f"{key:<8}= {val}".ljust(80)


def _header(cards) -> bytes:
    text = "".join(_card(k, v) for k, v in cards) + "END".ljust(80)
    text += " " * (-len(text) % BLOCK)
    return text.encode("ascii")


def write_fits_bintable(path: str, columns: dict) -> None:
    """A primary HDU and one BINTABLE of float64 (``D``) columns, big-endian."""
    names = list(columns)
    data = np.column_stack([np.asarray(columns[n], dtype=">f8") for n in names])
    nrows = data.shape[0]
    primary = _header([("SIMPLE", True), ("BITPIX", 8), ("NAXIS", 0), ("EXTEND", True)])
    cards = [("XTENSION", "BINTABLE"), ("BITPIX", 8), ("NAXIS", 2),
             ("NAXIS1", 8 * len(names)), ("NAXIS2", nrows), ("PCOUNT", 0), ("GCOUNT", 1),
             ("TFIELDS", len(names))]
    for i, name in enumerate(names, 1):
        cards += [(f"TTYPE{i}", name), (f"TFORM{i}", "D")]
    body = np.ascontiguousarray(data, dtype=">f8").tobytes()
    body += b"\0" * (-len(body) % BLOCK)
    with open(path, "wb") as f:
        f.write(primary + _header(cards) + body)


def _passband(lo, hi, edge, n=400):
    """(wl, tr): a flat band from ``lo`` to ``hi`` with smooth edges of width ``edge``."""
    wl = np.linspace(lo - 3 * edge, hi + 3 * edge, n)
    tr = 1.0 / (1.0 + np.exp(-(wl - lo) / edge)) / (1.0 + np.exp((wl - hi) / edge))
    return wl, tr


def write_filter_curves(bps_dir: str) -> None:
    """The curves of ``CFILT``, ``PFILT`` and the report's Kepler and Gaia G bands,
    in the reference's file formats."""
    os.makedirs(bps_dir, exist_ok=True)
    j = lambda name: os.path.join(bps_dir, name)
    wl, tr = _passband(6000.0, 9800.0, 40.0)  # long-pass 600 nm, in nm
    np.savetxt(j("lp600.csv"), np.column_stack([wl / 10.0, tr]), delimiter=",")
    wl, tr = _passband(19500.0, 23000.0, 150.0)  # Keck Kp, in micron
    np.savetxt(j("keck_kp.txt"), np.column_stack([wl / 1e4, tr]))
    for band, (lo, hi) in {"r": (5600.0, 6900.0), "i": (6900.0, 8300.0),
                           "z": (8300.0, 10200.0)}.items():
        np.savetxt(j(f"SLOAN_SDSS.{band}prime_filter.dat"),
                   np.column_stack(_passband(lo, hi, 60.0)))
    for band, (lo, hi) in {"j": (11200.0, 13600.0), "h": (15100.0, 17800.0)}.items():
        wl, tr = _passband(lo, hi, 100.0)
        write_fits_bintable(j(f"2mass_{band}_001_syn.fits"),
                            {"WAVELENGTH": wl, "THROUGHPUT": tr})
    wl, tr = _passband(20000.0, 23000.0, 120.0)
    np.savetxt(j("2MASS_2MASS.Ks.dat"), np.column_stack([wl, 0.8 * tr]))
    # the report's bands: Kepler in Angstrom, Gaia G in nm
    np.savetxt(j("Kepler_Kepler.K.dat"), np.column_stack(_passband(4300.0, 8900.0, 80.0)))
    wl, tr = _passband(3500.0, 10000.0, 100.0)
    np.savetxt(j("gaia_g_pb.txt"), np.column_stack([wl / 10.0, tr]))


def data_wavelengths(nd: int, spmin: float = 0.645, spmax: float = 0.84) -> np.ndarray:
    """``nd`` wavelengths (micron) that ``load_data_spectrum`` keeps whole:
    strictly inside ``(spmin, spmax)`` and outside the telluric bands."""
    cand = np.linspace(spmin, spmax, 4 * nd + 2)[1:-1]
    cand = cand[apply_telluric_mask(cand)]
    return cand[np.round(np.linspace(0, len(cand) - 1, nd)).astype(int)]


def _truth_mags(grid, mist, bank, truth, cfilt, pfilt):
    """(contrasts, photometry) of the composite at ``truth`` (binary, with parallax)."""
    from mcmc_spec_tpu_torch.report.composite import composite_full

    p = np.asarray(truth, dtype=np.float64)
    _, comp, comps = composite_full(grid, mist, p, nspec=2)
    cmag = []
    for curve in bank.contrast_curves(cfilt):
        W = contrast_weights(grid.wl, curve.wl, curve.tr)
        m1, m2 = (-2.5 * np.log10(c @ W) for c in comps)
        cmag.append(m2 - m1)
    curves, zps = bank.phot_passbands(pfilt)
    pmag = []
    for curve, zp in zip(curves, zps):
        W, _ = photon_flux_weights(grid.wl, curve.wl, curve.tr)
        pmag.append(-2.5 * np.log10((comp @ W) / zp) + p[2] * float(ccm89(curve.cwl, 1.0)))
    return np.array(cmag), np.array(pmag)


def _fmt(vals) -> str:
    return "[" + ",".join(repr(float(v)) for v in vals) + "]"


def write_param_file(path: str, datafile: str, bps_dir: str, cmag, pmag, truth=TRUTH,
                     spmin: float = 0.645, spmax: float = 0.84, tmin: int = 3000,
                     tmax: int = 5600, res: int = 1700, nwalk: int = 12, nstep: int = 20,
                     nburn: int = 20, nsteps: int = 60, seed: int = 0, dirname: str = "run",
                     fname: str = "synthfit", cfilt=CFILT) -> None:
    """The reference-format param file of a binary fit of the ``synthetic`` grid,
    with the contrasts ``cmag`` in the bands ``cfilt`` (one or both of ``CFILT``)."""
    t = np.asarray(truth, dtype=np.float64)
    quoted = lambda names: "[" + ",".join(f"'{n}'" for n in names) + "]"
    with open(path, "w") as f:
        f.write(f"""### synthetic fit directory (mcmc_spec_tpu_torch.testing)
models synthetic
dirname {dirname}
fname {fname}
res {res}
tmin {tmin}
tmax {tmax}
specmin 3000
specmax 30000
mask True
rad_prior False
filename {datafile}
spmin {spmin}
spmax {spmax}
cmag {_fmt(cmag)}
cerr {_fmt([0.05] * len(cfilt))}
cfilt {quoted(cfilt)}
pmag {_fmt(pmag)}
perr [0.05,0.05,0.05,0.05,0.05,0.05]
pfilt {quoted(PFILT)}
plx {float(t[5])!r}
plx_err 0.05e-3
dist_fit True
av {float(t[2])!r}
av_err 0.01
ra 288.456118
dec 45.802226
nwalk {nwalk}
nstep {nstep}
nspec 2
ndust 0
nburn {nburn}
nsteps {nsteps}
real_values {_fmt(t)}
bps_dir {bps_dir}
seed {seed}
""")


def _fit_root(root: str, spmin: float, spmax: float, tmin: int, tmax: int, res: int):
    """(root, bps_dir, grid): the filter curves written, the grid built into the cache."""
    from mcmc_spec_tpu_torch.pipeline import build_grid

    root = os.path.abspath(root)
    os.makedirs(root, exist_ok=True)
    bps_dir = os.path.join(root, "bps")
    write_filter_curves(bps_dir)
    cfg = FitConfig(models="synthetic", tmin=tmin, tmax=tmax, res=res,
                    specmin=3000, specmax=30000, spmin=spmin, spmax=spmax)
    cwd = os.getcwd()
    os.chdir(root)
    try:  # the grid cache lives in the fit's working directory
        grid = build_grid(cfg, (spmin * 1e4, spmax * 1e4))
    finally:
        os.chdir(cwd)
    return root, bps_dir, grid


def _write_target(root, bps_dir, grid, datafile, paramfile, truth, spectrum, nd, spmin, spmax,
                  noise_seed, noise_frac, cfilt, **param_kw) -> dict:
    """One target: its observation and its param file; returns their paths and values."""
    from mcmc_spec_tpu_torch.pipeline import make_synthetic_observation

    wl = data_wavelengths(nd, spmin, spmax)
    mist = MistTable.builtin()
    t = np.asarray(truth, dtype=np.float64)
    if spectrum is None:
        obs = types.SimpleNamespace(grid=grid, mist=mist, data_wl_um=wl)
        make_synthetic_observation(obs, t[:2], t[3], t[4], t[5], out_path=datafile,
                                   noise_frac=noise_frac, seed=noise_seed, av=t[2])
    else:
        flux, err = spectrum
        np.savetxt(datafile, np.column_stack([wl, flux, err]))

    cmag, pmag = _truth_mags(grid, mist, FilterBank(bps_dir), t, cfilt, PFILT)
    write_param_file(paramfile, datafile, bps_dir, cmag, pmag, truth=t, spmin=spmin,
                     spmax=spmax, cfilt=cfilt, **param_kw)
    return dict(root=root, paramfile=paramfile, datafile=datafile, bps_dir=bps_dir,
                dirname=os.path.join(root, param_kw.get("dirname", "run")), truth=t,
                cmag=cmag, pmag=pmag, data_wl_um=wl)


def write_fit_dir(root: str, truth=TRUTH, spectrum=None, nd: int = 1792, spmin: float = 0.645,
                  spmax: float = 0.84, tmin: int = 3000, tmax: int = 5600, res: int = 1700,
                  nwalk: int = 12, nstep: int = 20, nburn: int = 20, nsteps: int = 60,
                  seed: int = 0, noise_seed: int = 0, noise_frac: float = 0.01,
                  dirname: str = "run", fname: str = "synthfit") -> dict:
    """Write a fit directory under ``root``; returns its paths and the truth.

    ``spectrum``: ``None`` for ``make_synthetic_observation`` at ``truth``
    (``noise_frac``, ``noise_seed``), or ``(flux, err)`` on
    ``data_wavelengths(nd, spmin, spmax)``.
    """
    root, bps_dir, grid = _fit_root(root, spmin, spmax, tmin, tmax, res)
    return _write_target(
        root, bps_dir, grid, os.path.join(root, "synth_obs.txt"),
        os.path.join(root, "param_synth.txt"), truth, spectrum, nd, spmin, spmax, noise_seed,
        noise_frac, CFILT, tmin=tmin, tmax=tmax, res=res, nwalk=nwalk, nstep=nstep,
        nburn=nburn, nsteps=nsteps, seed=seed, dirname=dirname, fname=fname)


def fleet_truth(i: int) -> np.ndarray:
    """Target ``i``'s truth in a fleet: the bench truth with T1 40 K lower, T2 25 K
    higher and R2/R1 0.01 larger per target."""
    t = np.asarray(TRUTH, dtype=np.float64).copy()
    t[0] -= 40.0 * i
    t[1] += 25.0 * i
    t[4] += 0.01 * i
    return t


def write_fleet_dirs(root: str, nds, n_contrasts, spmin: float = 0.645, spmax: float = 0.84,
                     tmin: int = 3000, tmax: int = 5600, res: int = 1700, nwalk: int = 12,
                     nstep: int = 20, nburn: int = 20, nsteps: int = 60, seed: int = 0,
                     noise_frac: float = 0.01) -> list:
    """A ragged fleet under ``root``: target ``i`` has ``nds[i]`` data points, the first
    ``n_contrasts[i]`` bands of ``CFILT``, the truth ``fleet_truth(i)``, noise seed ``i``,
    ``synth_obs_t{i}.txt``, ``param_synth_t{i}.txt``, ``dirname run{i}`` and ``fname
    t{i}``; every target shares the filter curves and the grid cache.  Returns each
    target's ``write_fit_dir``-style dict."""
    root, bps_dir, grid = _fit_root(root, spmin, spmax, tmin, tmax, res)
    return [
        _write_target(root, bps_dir, grid, os.path.join(root, f"synth_obs_t{i}.txt"),
                      os.path.join(root, f"param_synth_t{i}.txt"), fleet_truth(i), None, nd,
                      spmin, spmax, i, noise_frac, CFILT[:nc], tmin=tmin, tmax=tmax, res=res,
                      nwalk=nwalk, nstep=nstep, nburn=nburn, nsteps=nsteps, seed=seed,
                      dirname=f"run{i}", fname=f"t{i}")
        for i, (nd, nc) in enumerate(zip(nds, n_contrasts))]


def write_btsettl_dir(grid_dir: str, temps, loggs=(4.0, 4.5, 5.0, 5.5),
                      specrange=(3000.0, 30000.0), step: float = 2.0) -> list:
    """A model grid in the BT-Settl directory format: for each (T, logg) the two-column
    ASCII file ``btsettl_path(grid_dir, T, logg)`` of ``synthetic_spectrum`` on a
    ``step`` A grid over ``specrange`` +- 100 A (the window the reader keeps).  Returns
    the paths."""
    from mcmc_spec_tpu_torch.models.grid import btsettl_path
    from mcmc_spec_tpu_torch.models.synthetic import synthetic_spectrum

    os.makedirs(grid_dir, exist_ok=True)
    wl = np.arange(min(specrange) - 100.0, max(specrange) + 100.0 + step, step)
    paths = []
    for t in temps:
        for g in loggs:
            path = btsettl_path(grid_dir, t, g)
            np.savetxt(path, np.column_stack([wl, synthetic_spectrum(wl, t, g)]))
            paths.append(path)
    return paths


def write_result_dir(root: str, name: str, n: int = 400, seed: int = 0) -> str:
    """``root/koi{name}``: a binary's posterior draws (6 columns) and the files the
    population analysis reads beside ``samples.txt``; returns the directory."""
    rng = np.random.RandomState(seed)
    d = os.path.join(root, f"koi{name}")
    os.makedirs(d)
    t1, t2 = rng.normal(4800, 60, n), rng.normal(3500, 80, n)
    av, r1 = np.abs(rng.normal(0.1, 0.02, n)), rng.normal(0.75, 0.03, n)
    ratio, plx = rng.normal(0.45, 0.02, n), rng.normal(2e-3, 0.05e-3, n)
    np.savetxt(os.path.join(d, "samples.txt"), np.column_stack([t1, t2, av, r1, ratio, plx]))
    kc = rng.normal(2.5, 0.1, n)
    np.savetxt(os.path.join(d, "pri_corr.txt"), np.sqrt(1 + 10 ** (-0.4 * kc)))
    np.savetxt(os.path.join(d, "sec_corr.txt"), ratio * np.sqrt(1 + 10 ** (0.4 * kc)))
    for fname, mu, sig in (("primary_mass", 0.78, 0.02), ("secondary_mass", 0.40, 0.02),
                           ("primary_lum", 0.35, 0.02), ("secondary_lum", 0.03, 0.005)):
        np.savetxt(os.path.join(d, f"{fname}_posterior.txt"), rng.normal(mu, sig, n))
    return d


def gaussian_filter_curve(name, center, width, n=300, span=4.0):
    from mcmc_spec_tpu_torch.ops.photometry import FilterCurve

    wl = np.linspace(center - span * width, center + span * width, n)
    return FilterCurve(name=name, wl=wl, tr=np.exp(-0.5 * ((wl - center) / width) ** 2))


def make_setup(rad_prior: bool = False, dtype=None, device="cpu"):
    """(setup dict, PackedTarget): the JAX test suite's small binary fit target.

    The 8x4 synthetic grid over 3,000-12,000 A at 1 A steps, 900 data points
    over 0.652-0.838 um (the composite at the truth plus 1 % noise, from
    ``RandomState(7)``), two contrast and three photometric Gaussian filters,
    a constant Av prior and the parallax prior.  The observed contrasts and
    photometry are ``forward_summary`` at the truth plus 0.02 mag noise, drawn
    after the spectrum noise as in JAX.  ``dtype`` defaults to float64.
    """
    import torch

    from mcmc_spec_tpu_torch.inference.posterior import forward_summary
    from mcmc_spec_tpu_torch.inference.target import PC_CM, RSUN_CM, pack_target
    from mcmc_spec_tpu_torch.models.dust import AvProfile
    from mcmc_spec_tpu_torch.models.synthetic import synthetic_grid
    from mcmc_spec_tpu_torch.ops.interp import bilinear_bracket, bilinear_gather_blend
    from mcmc_spec_tpu_torch.ops.photometry import ab_zero_flux

    dtype = torch.float64 if dtype is None else dtype
    grid = synthetic_grid(specrange=(3000.0, 12000.0), data_window=(6450.0, 8400.0),
                          resolution=1700, temps=np.arange(3000.0, 5801.0, 400.0),
                          loggs=np.array([4.0, 4.5, 5.0, 5.5]), step=1.0)
    rng = np.random.RandomState(7)
    mist = MistTable.builtin()
    truth = dict(t1=4600.0, t2=3400.0, av=0.15, r1=0.72, rr2=0.45, plx=2.0e-3)
    data_wl_um = np.linspace(0.652, 0.838, 900)

    flux64 = torch.as_tensor(grid.flux, dtype=torch.float64)
    axis = lambda v: torch.as_tensor(v, dtype=torch.float64)

    def comp_spec_full(t, g):
        ti, tw = bilinear_bracket(axis(grid.temps), t)
        gi, gw = bilinear_bracket(axis(grid.loggs), g)
        return bilinear_gather_blend(flux64, ti, tw, gi, gw).numpy()

    d_pc = 1.0 / truth["plx"]
    s1 = (truth["r1"] * RSUN_CM / (d_pc * PC_CM)) ** 2
    s2 = (truth["r1"] * truth["rr2"] * RSUN_CM / (d_pc * PC_CM)) ** 2
    comp = (s1 * comp_spec_full(truth["t1"], float(mist.get_logg(truth["t1"])))
            + s2 * comp_spec_full(truth["t2"], float(mist.get_logg(truth["t2"]))))
    data_flux = np.interp(data_wl_um * 1e4, grid.wl, comp)
    data_flux *= 1.0 + 0.01 * rng.randn(len(data_flux))
    data_err = 0.01 * np.abs(data_flux)
    med = np.median(data_flux)
    data_flux, data_err = data_flux / med, data_err / med

    cfilts = [gaussian_filter_curve("c600", 6000.0, 150.0),
              gaussian_filter_curve("cK", 9500.0, 300.0)]
    pfilts = [gaussian_filter_curve("p_r", 6250.0, 300.0),
              gaussian_filter_curve("p_i", 7700.0, 350.0),
              gaussian_filter_curve("p_z", 9100.0, 400.0)]
    zps = [ab_zero_flux(photon_flux_weights(grid.wl, f.wl, f.tr)[1]) for f in pfilts]
    av_profile = AvProfile.constant(truth["av"], 0.05)
    p_truth = np.array([truth["t1"], truth["t2"], truth["av"], truth["r1"], truth["rr2"],
                        truth["plx"]])
    prior_mu, prior_sig = np.zeros(6), np.ones(6)
    prior_mu[-1], prior_sig[-1] = truth["plx"], 0.05e-3
    cerr, perr = np.full(len(cfilts), 0.05), np.full(len(pfilts), 0.05)

    def pack(cmag, pmag, dtype, device):
        return pack_target(grid, data_wl_um, data_flux, data_err, cfilts, cmag, cerr, pfilts,
                           zps, pmag, perr, mist, av_profile, nspec=2, dist_fit=True,
                           rad_prior=rad_prior, prior_mu=prior_mu, prior_sig=prior_sig,
                           dtype=dtype, device=device)

    # truth-adjacent observations, so that the chi^2 values are O(1); the forward model
    # in float64 on the host, as the JAX suite's numpy emulator
    placeholder = pack(np.zeros(len(cfilts)), np.zeros(len(pfilts)), torch.float64, "cpu")
    summ = forward_summary(torch.as_tensor(p_truth, dtype=torch.float64), placeholder)
    cmag = summ["contrasts"].numpy() + rng.normal(0, 0.02, len(cfilts))
    pmag = summ["phot_mags"].numpy() + rng.normal(0, 0.02, len(pfilts))
    setup = dict(grid=grid, mist=mist, truth=truth, p_truth=p_truth, data_wl_um=data_wl_um,
                 data_flux=data_flux, data_err=data_err, cfilts=cfilts, pfilts=pfilts,
                 zps=zps, cmag=cmag, cerr=cerr, pmag=pmag, perr=perr, av_profile=av_profile)
    return setup, pack(cmag, pmag, dtype, device)


def _world_rank(rank, fn, nranks, port, backend, outdir, timeout_s, args):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", world_size=nranks,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(rank, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(outdir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def run_world(fn, nranks: int, *args, backend: str = "gloo", timeout_s: float = 300):
    """``[fn(rank, *args) for rank in range(nranks)]``, each on its rank of a new process
    group of ``nranks`` spawned processes.

    ``fn`` and ``args`` must pickle (``fn`` a module-level function); so must the
    results, which come back through files in a temporary directory.  Each rank
    runs on one CPU thread, in a group at a free ``127.0.0.1`` port with
    ``backend``, whose collectives raise after ``timeout_s``.  A rank that raises
    makes this raise, and the other ranks are ended.
    """
    import torch.multiprocessing as mp

    from mcmc_spec_tpu_torch.parallel.mesh import free_port

    with tempfile.TemporaryDirectory(prefix="run_world_") as d:
        mp.start_processes(_world_rank, args=(fn, nranks, free_port(), backend, d, timeout_s,
                                              args),
                           nprocs=nranks, join=True, start_method="spawn")
        out = []
        for r in range(nranks):
            with open(os.path.join(d, f"{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
