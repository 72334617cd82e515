"""Reference-API compatibility layer (port of ``mcmc_spec_tpu.compat``).

Functions with the names and (host/numpy) signatures reference users know
from ``mft6.py``, backed by this port's implementations.  For the hot
inference path use the native APIs (:mod:`mcmc_spec_tpu_torch.inference`); this
module exists so existing analysis scripts and muscle memory keep working.
Everything here is host numpy, as in JAX.

Covered: ``gauss``, ``bimodal``, ``bccorr``, ``extinct``, ``get_radius``,
``get_logg``, ``find_nearest``, ``chisq``, ``broaden``, ``redres``,
``make_reg``, ``norm_spec``, ``interp_2_spec``, ``make_varied_param``,
``find_model``, ``get_transmission``.  Grid/fit entry points map to:

    spec_interpolator(...)      -> models.grid.SpectralGrid.from_*_dir
    get_spec(T, logg, reg, ...) -> compat.get_spec (below)
    make_composite(...)         -> inference forward / report.composite
    loglikelihood/logposterior  -> inference.posterior / inference.batched
    fit_spec/optimize_fit       -> inference.anneal + pipeline.run_optimize_stage
    run_emcee                   -> inference.sampler_api.EnsembleSampler /
                                   pipeline.run_mcmc_stage
"""
from __future__ import annotations

import numpy as np

from mcmc_spec_tpu_torch.report.corner_stats import bimodal, gauss  # noqa: F401
from mcmc_spec_tpu_torch.ops.broaden import make_reg, redres  # noqa: F401


def bccorr(wl, bcvel, radvel):
    """mft6.py:32-44."""
    return np.array(wl) * (1.0 + (bcvel - radvel) / 3e5)


def extinct(wl, spec, av, rv=3.1, unit="aa"):
    """mft6.py:46-64 (CCM89 reddening of a flux array)."""
    from mcmc_spec_tpu_torch.ops.extinction import extinct as _ext

    wl = np.asarray(wl, dtype=np.float64)
    if unit == "invum":
        wl = 1e4 / wl
    return np.asarray(_ext(wl, np.asarray(spec, dtype=np.float64), av, rv))


def get_radius(teff, matrix):
    """mft6.py:66-85 (MIST 1-Gyr radius via Stefan-Boltzmann)."""
    from mcmc_spec_tpu_torch.models.mist import MistTable

    return MistTable(matrix=np.asarray(matrix)).get_radius(teff)


def get_logg(teff, matrix):
    """mft6.py:87-98."""
    from mcmc_spec_tpu_torch.models.mist import MistTable

    return MistTable(matrix=np.asarray(matrix)).get_logg(teff)


def find_nearest(array, value):
    """mft6.py:100-113."""
    array = np.asarray(array)
    return int(np.abs(array - value).argmin())


def chisq(model, data, var):
    """mft6.py:115-122."""
    return (np.asarray(model) - np.asarray(data)) ** 2 / np.asarray(var) ** 2


def broaden(even_wl, modelspec_interp, res, vsini=0, limb=0, plot=False):
    """mft6.py:124-152 (instrumental + optional rotational broadening)."""
    from mcmc_spec_tpu_torch.ops.broaden import instrumental_broaden, rotational_broaden

    wl, brd = instrumental_broaden(np.asarray(even_wl), np.asarray(modelspec_interp), res)
    if vsini != 0 and limb != 0:
        brd = rotational_broaden(wl, brd, vsini, epsilon=limb)
    return np.asarray(wl), np.asarray(brd)


def norm_spec(wl, model, data):
    """mft6.py:193-196 (deg-2 polynomial renormalisation of the data)."""
    frac = np.asarray(data) / np.asarray(model)
    p = np.polynomial.Polynomial.fit(np.asarray(wl), frac, deg=2)
    return np.asarray(data) / p(np.asarray(wl))


def interp_2_spec(spec1, spec2, ep1, ep2, val):
    """mft6.py:198-209 (per-pixel linear blend between two spectra)."""
    spec1, spec2 = np.asarray(spec1), np.asarray(spec2)
    if len(spec1) != len(spec2):
        return "the spectra must have the same length"
    return (spec2 - spec1) / (ep2 - ep1) * (val - ep1) + spec1


def make_varied_param(init, sig):
    """mft6.py:211-228 (Gaussian perturbation of a parameter structure)."""
    rng = np.random
    out = []
    for n in range(len(init)):
        try:
            out.append(rng.normal(init[n], sig[n]))
        except (TypeError, ValueError):
            out.append(list(rng.normal(np.asarray(init[n]), np.asarray(sig[n]))))
    return out


def find_model(temp, logg, metal=0, models="btsettl", grid_dir=None):
    """mft6.py:230-253 (grid-point filename)."""
    from mcmc_spec_tpu_torch.models.grid import btsettl_path, hires_path

    if models == "btsettl":
        return btsettl_path(grid_dir or "BT-Settl_M-0.0a+0.0", temp, logg)
    return hires_path(grid_dir or "SPECTRA", temp, logg, metal)


def get_transmission(f, res, bps_dir="bps"):
    """mft6.py:565-649 — returns (t_wl, t_cv, n_resel, cwl) like the reference."""
    from mcmc_spec_tpu_torch.io.filters import load_transmission

    c = load_transmission(f, bps_dir)
    return c.wl, c.tr, c.n_resel(res), c.cwl


def get_spec(temp, log_g, reg, specdict_or_grid, normalize=False, wlunit="aa", **_):
    """mft6.py:387-563 — bilinearly interpolated spectrum over a region.

    Accepts a :class:`~mcmc_spec_tpu_torch.models.grid.SpectralGrid` (preferred) or
    a reference-style dict keyed ``'{teff}, {logg}'`` plus ``'wl'``.
    """
    from mcmc_spec_tpu_torch.models.grid import SpectralGrid

    if isinstance(specdict_or_grid, SpectralGrid):
        grid = specdict_or_grid
    else:
        d = specdict_or_grid
        keys = [k for k in d if k != "wl"]
        temps = sorted({float(k.split(",")[0]) for k in keys})
        loggs = sorted({float(k.split(",")[1]) for k in keys})
        wl = np.asarray(d["wl"])
        flux = np.zeros((len(temps), len(loggs), len(wl)))
        for i, t in enumerate(temps):
            for jj, g in enumerate(loggs):
                key = f"{int(t) if float(t).is_integer() else t}, {g}"
                flux[i, jj] = d[key]
        grid = SpectralGrid(temps=np.asarray(temps), loggs=np.asarray(loggs),
                            wl=wl, flux=flux)

    spflux = grid.interp_spectrum(float(temp), float(log_g))
    reg_aa = np.asarray(reg, dtype=np.float64) * 1e4
    sel = (grid.wl >= reg_aa.min()) & (grid.wl <= reg_aa.max())
    spwave, spflux = grid.wl[sel], spflux[sel]
    if normalize:
        spflux = spflux / spflux.max()
    if wlunit == "um":
        spwave = spwave * 1e-4
    return np.asarray(spwave), np.asarray(spflux)
