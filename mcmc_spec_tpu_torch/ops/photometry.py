"""Synthetic photometry as precomputed linear weights over the model grid.

The reference computes filter fluxes per evaluation with per-filter
``interp1d`` + ``np.trapz`` (contrasts, ``mft6.py:713-741``) and with
``pyphot``'s ``Filter.get_flux`` (unresolved photometry, ``mft6.py:771-783``).
Both are *linear functionals* of the spectrum evaluated on a fixed wavelength
grid, so each filter reduces to a single precomputed weight vector ``W`` with
``flux = W @ spec`` — and because the forward model is linear in the grid
spectra, ``W`` can be pushed all the way onto the packed grid tensor, turning
per-walker filter photometry into a bilinear blend of scalars.

Two weighting conventions are reproduced exactly:

* ``contrast_weights``: plain trapezoid integration of ``spec * T`` over the
  model grid points inside the filter support, with the transmission linearly
  interpolated onto the model grid — the reference's "instrumental flux" used
  for contrasts (``mft6.py:717-733``) and for the Kepler/Gaia component mags
  in the plot path (``mft6.py:798-802``).
* ``photon_flux_weights``: pyphot's photon-detector convention
  ``f = trapz(lam*T*s) / trapz(lam*T)`` with ``T`` interpolated onto the
  spectrum grid and integration restricted to ``T > 0``.

Zero points: AB zero flux uses the pivot wavelength
(``f_AB = 3631 Jy * c / lpivot^2``); Vega zero flux pipes a Vega spectrum
through the same photon weights (``mft6.py:778-782``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

C_AA_PER_S = 2.99792458e18  # speed of light in Angstrom/s
AB_ZERO_FNU = 3.631e-20  # erg/s/cm^2/Hz (3631 Jy)


def _trapz_weights(x):
    """w such that ``w @ f == np.trapz(f, x)``."""
    x = np.asarray(x, dtype=np.float64)
    w = np.zeros_like(x)
    w[1:] += 0.5 * (x[1:] - x[:-1])
    w[:-1] += 0.5 * (x[1:] - x[:-1])
    return w


def contrast_weights(model_wl, filt_wl, filt_tr):
    """Full-grid weight vector for the reference's contrast integral.

    ``W @ spec == np.trapz(spec[mask] * interp(T)(wl[mask]), wl[mask])`` where
    ``mask`` selects model points within ``[min(filt_wl), max(filt_wl)]``.
    """
    model_wl = np.asarray(model_wl, dtype=np.float64)
    filt_wl = np.asarray(filt_wl, dtype=np.float64)
    filt_tr = np.asarray(filt_tr, dtype=np.float64)
    order = np.argsort(filt_wl)
    filt_wl, filt_tr = filt_wl[order], filt_tr[order]

    mask = (model_wl >= filt_wl.min()) & (model_wl <= filt_wl.max())
    sub_wl = model_wl[mask]
    if sub_wl.size < 2:
        raise ValueError("filter support covers <2 model grid points")
    tr = np.interp(sub_wl, filt_wl, filt_tr)
    w_sub = _trapz_weights(sub_wl) * tr
    W = np.zeros_like(model_wl)
    W[mask] = w_sub
    return W


def photon_flux_weights(model_wl, filt_wl, filt_tr):
    """(W, lpivot) reproducing pyphot's photon-detector ``get_flux``.

    ``W @ spec == trapz(lam*T*spec, lam) / trapz(lam*T, lam)`` over the model
    points where the interpolated transmission is > 0 (pyphot masks ``T > 0``
    and integrates on the masked subgrid).
    """
    model_wl = np.asarray(model_wl, dtype=np.float64)
    filt_wl = np.asarray(filt_wl, dtype=np.float64)
    filt_tr = np.asarray(filt_tr, dtype=np.float64)
    order = np.argsort(filt_wl)
    filt_wl, filt_tr = filt_wl[order], filt_tr[order]

    tr_on_model = np.interp(model_wl, filt_wl, filt_tr, left=0.0, right=0.0)
    mask = tr_on_model > 0.0
    sub_wl = model_wl[mask]
    if sub_wl.size < 2:
        raise ValueError("filter support covers <2 model grid points")
    sub_tr = tr_on_model[mask]
    w_sub = _trapz_weights(sub_wl) * sub_wl * sub_tr
    denom = float(np.trapezoid(sub_wl * sub_tr, sub_wl))
    W = np.zeros_like(model_wl)
    W[mask] = w_sub / denom

    # pivot wavelength on the filter's own grid: lp^2 = int(T lam) / int(T/lam)
    num = np.trapezoid(filt_tr * filt_wl, filt_wl)
    den = np.trapezoid(filt_tr / filt_wl, filt_wl)
    lpivot = float(np.sqrt(num / den))
    return W, lpivot


def ab_zero_flux(lpivot_aa):
    """AB zero flux in erg/s/cm^2/AA at the pivot wavelength."""
    return AB_ZERO_FNU * C_AA_PER_S / lpivot_aa**2


@dataclasses.dataclass
class FilterCurve:
    """A single transmission curve plus its integration metadata."""

    name: str
    wl: np.ndarray  # Angstroms
    tr: np.ndarray
    detector: str = "photon"  # 'photon' or 'energy'

    @property
    def cwl(self):
        """Mean wavelength, the reference's 'central wavelength' (mft6.py:649)."""
        return float(np.mean(self.wl))

    def n_resel(self, res):
        """Number of resolution elements across the bandpass (mft6.py:643-648)."""
        res_element = np.mean(self.wl) / res
        return float((np.max(self.wl) - np.min(self.wl)) / res_element)

    def vega_zero_flux(self, vega_wl, vega_flux):
        """Vega flux through this filter with photon weighting."""
        W, _ = photon_flux_weights(np.asarray(vega_wl, dtype=np.float64), self.wl, self.tr)
        return float(W @ np.asarray(vega_flux, dtype=np.float64))
