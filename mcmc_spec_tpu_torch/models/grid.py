"""Rectangular (Teff, logg) model-spectrum grid (port of ``mcmc_spec_tpu.models.grid``).

The hybrid-resolution contract is preserved: every spectrum is resampled
onto a uniform grid over ``specrange``, instrumentally broadened to the data
resolution only inside the data window, with native-resolution flanks
spliced back so broadband photometry integrates the unsmoothed spectrum.
The BT-Settl / PHOENIX directory readers are not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from mcmc_spec_tpu_torch.ops.broaden import instrumental_broaden


@dataclasses.dataclass
class SpectralGrid:
    """A rectangular (Teff, logg) grid of model spectra on a shared wl axis."""

    temps: np.ndarray  # [nT] K, sorted
    loggs: np.ndarray  # [nG] dex, sorted
    wl: np.ndarray  # [nwl] Angstroms
    flux: np.ndarray  # [nT, nG, nwl]

    def __post_init__(self):
        self.temps = np.asarray(self.temps, dtype=np.float64)
        self.loggs = np.asarray(self.loggs, dtype=np.float64)
        self.wl = np.asarray(self.wl, dtype=np.float64)
        self.flux = np.asarray(self.flux, dtype=np.float64)
        if self.flux.shape != (len(self.temps), len(self.loggs), len(self.wl)):
            raise ValueError(f"flux shape {self.flux.shape} does not match the axes")

    @staticmethod
    def _hybrid_broaden(wl, flux, data_window, resolution):
        """Broaden inside the data window only, splice native flanks back."""
        wmin, wmax = min(data_window), max(data_window)
        mask = (wl >= wmin) & (wl <= wmax)
        if mask.sum() < 32:
            return flux
        _, brd = instrumental_broaden(wl[mask], flux[mask], resolution)
        out = flux.copy()
        out[mask] = brd
        return out

    @classmethod
    def from_spectra(cls, entries, specrange, data_window, resolution, step=0.2) -> "SpectralGrid":
        """Pack ``(teff, logg, wl, flux)`` native spectra onto the hybrid-res grid."""
        wl = np.arange(min(specrange), max(specrange), step)
        by_key = {}
        temps, loggs = set(), set()
        for teff, logg, swl, sflux in entries:
            swl = np.asarray(swl, dtype=np.float64)
            sflux = np.asarray(sflux, dtype=np.float64)
            order = np.argsort(swl)
            f = np.interp(wl, swl[order], sflux[order])
            f = cls._hybrid_broaden(wl, f, data_window, resolution)
            by_key[(float(teff), float(logg))] = f
            temps.add(float(teff))
            loggs.add(float(logg))
        temps = np.array(sorted(temps))
        loggs = np.array(sorted(loggs))
        flux = np.zeros((len(temps), len(loggs), len(wl)))
        for i, t in enumerate(temps):
            for j, g in enumerate(loggs):
                if (t, g) not in by_key:
                    raise ValueError(f"grid is not rectangular: missing (T={t}, logg={g})")
                flux[i, j] = by_key[(t, g)]
        return cls(temps=temps, loggs=loggs, wl=wl, flux=flux)

    def interp_spectrum(self, teff: float, logg: float) -> np.ndarray:
        """Host-side bilinear spectrum at (teff, logg), clamped bracket at the edges."""
        def bracket(axis_vals, q):
            i = int(np.clip(np.searchsorted(axis_vals, q, side="right") - 1,
                            0, axis_vals.shape[0] - 2))
            lo, hi = axis_vals[i], axis_vals[i + 1]
            return i, (q - lo) / (hi - lo)

        ti, tw = bracket(self.temps, teff)
        gi, gw = bracket(self.loggs, logg)
        f0 = self.flux[ti, gi] * (1.0 - gw) + self.flux[ti, gi + 1] * gw
        f1 = self.flux[ti + 1, gi] * (1.0 - gw) + self.flux[ti + 1, gi + 1] * gw
        return f0 * (1.0 - tw) + f1 * tw
