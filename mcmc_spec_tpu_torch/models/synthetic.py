"""Analytic synthetic model spectra for tests, benchmarks, and self-contained runs.

The reference depends on external BT-Settl / PHOENIX grids that are not
bundled (SURVEY.md section 0).  For CI, benchmarks, and the end-to-end test
slice we generate a deterministic, physically-shaped stand-in grid: a Planck
continuum with temperature- and gravity-dependent absorption features (TiO-like
band heads at cool temperatures, a gravity-sensitive alkali doublet, and a
Balmer-jump-ish blue rolloff).  The generator is smooth in (Teff, logg), so
bilinear grid interpolation behaves like it does on real model grids.

Units mirror the reference's grids: surface flux density (erg/s/cm^2/AA per
unit surface area) vs wavelength in Angstroms.
"""
from __future__ import annotations

import numpy as np

_H = 6.62607015e-27  # erg s
_C = 2.99792458e10  # cm/s
_KB = 1.380649e-16  # erg/K

# Deterministic pseudo-line list: (center AA, width AA, strength scale, logg sens)
_RNG = np.random.RandomState(20241220)
_LINES = np.stack(
    [
        _RNG.uniform(3200.0, 29000.0, 160),  # centers
        _RNG.uniform(1.5, 12.0, 160),  # gaussian widths (AA)
        _RNG.uniform(0.05, 0.65, 160),  # base strengths
        _RNG.uniform(-0.25, 0.4, 160),  # logg sensitivity
    ],
    axis=1,
)


def planck_flambda(wl_aa, teff):
    """Planck surface flux density pi*B_lambda in erg/s/cm^2/AA."""
    lam_cm = np.asarray(wl_aa, dtype=np.float64) * 1e-8
    x = _H * _C / (lam_cm * _KB * teff)
    B = 2.0 * _H * _C**2 / lam_cm**5 / np.expm1(np.clip(x, 1e-9, 500.0))
    return np.pi * B * 1e-8  # per cm -> per AA


def synthetic_spectrum(wl_aa, teff, logg):
    """Deterministic model spectrum, smooth in (teff, logg)."""
    wl = np.asarray(wl_aa, dtype=np.float64)
    flux = planck_flambda(wl, teff)

    # molecular band depression growing toward cool temps (TiO-like, 4500-8500 A)
    coolness = np.clip((4800.0 - teff) / 1800.0, 0.0, 1.2)
    band = 1.0 - 0.35 * coolness * (0.5 + 0.5 * np.sin(wl / 350.0)) * np.exp(
        -0.5 * ((wl - 6500.0) / 2600.0) ** 2
    )

    # pseudo-line absorption: strengths scale with coolness and logg
    depth = np.ones_like(wl)
    tfac = np.clip((7000.0 - teff) / 4000.0, 0.05, 1.2)
    for c, w, s, gs in _LINES:
        strength = s * tfac * (1.0 + gs * (logg - 4.5))
        strength = np.clip(strength, 0.0, 0.92)
        depth *= 1.0 - strength * np.exp(-0.5 * ((wl - c) / w) ** 2)

    # gravity-sensitive alkali doublet (KI 7665/7699-like)
    for c in (7665.0, 7699.0):
        s = np.clip(0.25 + 0.3 * (logg - 4.0), 0.0, 0.9) * np.clip(tfac, 0.0, 1.0)
        depth *= 1.0 - s * np.exp(-0.5 * ((wl - c) / 6.0) ** 2)

    # blue rolloff for cool stars
    blue = 1.0 - 0.5 * coolness * np.exp(-0.5 * ((wl - 3600.0) / 900.0) ** 2)
    return flux * band * depth * blue


def synthetic_grid(
    specrange=(3000.0, 30000.0),
    data_window=(6450.0, 8400.0),
    resolution=1700,
    temps=None,
    loggs=None,
    step=0.2,
):
    """A packed :class:`SpectralGrid` of synthetic spectra (btsettl-like axes)."""
    from mcmc_spec_tpu_torch.models.grid import SpectralGrid

    if temps is None:
        temps = np.arange(3000.0, 5600.0, 200.0)  # BT-Settl-like 100K/200K spacing
    if loggs is None:
        loggs = np.array([4.0, 4.5, 5.0, 5.5])
    wl = np.arange(min(specrange), max(specrange), step)

    def entries():
        for t in temps:
            for g in loggs:
                yield t, g, wl, synthetic_spectrum(wl, t, g)

    return SpectralGrid.from_spectra(entries(), specrange, data_window, resolution, step=step)
