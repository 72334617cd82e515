"""MIST 1-Gyr isochrone lookups (port of ``mcmc_spec_tpu.models.mist``).

Only the builtin main-sequence track is ported: 33 dwarf-star calibration
anchors densified by monotone cubics in log Teff, laid out like the reference
``mist_2mass_old.cmd`` matrix (col 1 = log age, 3 = mass, 4 = Teff, 5 = logg,
6 = L), with the reference's 220-row truncation of the age-9.0 block.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

SIGMA_SB = 5.670374e-5  # erg/s/cm^2/K^4
LSUN = 3.839e33  # erg/s
RSUN = 6.957e10  # cm
GM_SUN_OVER_RSUN2 = 27420.0  # cm/s^2 -> logg_sun = 4.438

# (Teff K, R/Rsun, M/Msun, M_H, M_Ks): ~1-Gyr main-sequence anchors.
_ANCHORS = np.array(
    [
        [2560.0, 0.102, 0.075, 10.77, 10.30],
        [2710.0, 0.124, 0.090, 10.22, 9.78],
        [2850.0, 0.137, 0.102, 9.77, 9.33],
        [2960.0, 0.155, 0.123, 9.31, 8.90],
        [3060.0, 0.196, 0.162, 8.72, 8.44],
        [3190.0, 0.258, 0.231, 8.05, 7.83],
        [3340.0, 0.301, 0.290, 7.51, 7.28],
        [3410.0, 0.336, 0.360, 7.04, 6.82],
        [3550.0, 0.430, 0.440, 6.39, 6.19],
        [3660.0, 0.496, 0.490, 6.01, 5.84],
        [3770.0, 0.540, 0.530, 5.71, 5.55],
        [3850.0, 0.588, 0.570, 5.47, 5.31],
        [4015.0, 0.612, 0.590, 5.26, 5.10],
        [4140.0, 0.640, 0.630, 5.05, 4.91],
        [4410.0, 0.703, 0.680, 4.65, 4.53],
        [4600.0, 0.735, 0.720, 4.43, 4.32],
        [4830.0, 0.760, 0.750, 4.21, 4.11],
        [5040.0, 0.786, 0.780, 4.01, 3.93],
        [5280.0, 0.815, 0.830, 3.80, 3.73],
        [5490.0, 0.880, 0.930, 3.58, 3.52],
        [5660.0, 0.950, 0.970, 3.40, 3.35],
        [5770.0, 1.000, 1.000, 3.28, 3.24],
        [5930.0, 1.060, 1.060, 3.13, 3.09],
        [6120.0, 1.146, 1.180, 2.95, 2.92],
        [6340.0, 1.220, 1.250, 2.77, 2.74],
        [6510.0, 1.290, 1.330, 2.63, 2.60],
        [6720.0, 1.360, 1.440, 2.47, 2.45],
        [7030.0, 1.450, 1.540, 2.27, 2.25],
        [7220.0, 1.510, 1.610, 2.15, 2.13],
        [7500.0, 1.600, 1.700, 1.99, 1.97],
        [8000.0, 1.690, 1.850, 1.76, 1.74],
        [8750.0, 1.970, 2.000, 1.44, 1.42],
        [9700.0, 2.190, 2.180, 1.11, 1.08],
    ]
)


def _builtin_track(n_rows: int = 240) -> np.ndarray:
    """Reference-layout matrix of the densified 1-Gyr track (log Teff, log L)."""
    from scipy.interpolate import PchipInterpolator

    teff, rad, mass, mh, mks = _ANCHORS.T
    lt = np.log10(teff)
    # dense grid INCLUDING the anchor nodes, so anchors reproduce exactly
    ltg = np.unique(np.concatenate([np.linspace(lt[0], lt[-1], n_rows), lt]))
    radg = 10.0 ** PchipInterpolator(lt, np.log10(rad))(ltg)
    massg = 10.0 ** PchipInterpolator(lt, np.log10(mass))(ltg)
    mhg = PchipInterpolator(lt, mh)(ltg)
    mksg = PchipInterpolator(lt, mks)(ltg)
    teffg = 10.0**ltg
    logl = 2.0 * np.log10(radg) + 4.0 * np.log10(teffg / 5772.0)
    logg = np.log10(GM_SUN_OVER_RSUN2 * massg / radg**2)
    mat = np.zeros((len(ltg), 17))
    mat[:, 0] = np.arange(len(ltg))
    mat[:, 1] = 9.0  # log age = 1 Gyr
    mat[:, 3] = massg
    mat[:, 4] = ltg
    mat[:, 5] = logg
    mat[:, 6] = logl
    mat[:, 15] = mhg
    mat[:, 16] = mksg
    return mat


@dataclasses.dataclass
class MistTable:
    """De-logged isochrone matrix and its sorted interpolation nodes."""

    matrix: np.ndarray  # de-logged Teff (col 4) and L (col 6)
    age_log: float = 9.0
    max_rows: int = 220  # reference truncation

    @classmethod
    def builtin(cls) -> "MistTable":
        matrix = _builtin_track()
        matrix[:, 4] = 10.0 ** matrix[:, 4]
        matrix[:, 6] = 10.0 ** matrix[:, 6]
        return cls(matrix=matrix)

    def __post_init__(self):
        sel = np.where(self.matrix[:, 1] == self.age_log)[0][: self.max_rows]
        teff = self.matrix[sel, 4]
        order = np.argsort(teff)
        self._teff_nodes = teff[order]
        self._logg_nodes = self.matrix[sel, 5][order]
        self._lum_nodes = self.matrix[sel, 6][order]

    def get_logg(self, teff):
        """logg(Teff) by linear interpolation (reference ``get_logg``)."""
        return np.interp(teff, self._teff_nodes, self._logg_nodes)

    def device_nodes(self, dtype=torch.float32, device="cuda"):
        """(teff_nodes, logg_nodes, lum_nodes) tensors for tent interpolation."""
        as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        return as_t(self._teff_nodes), as_t(self._logg_nodes), as_t(self._lum_nodes)
