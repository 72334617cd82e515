"""What a fit needs before its first evaluation, worked out from the benchmark's inputs
(host numpy, float64).

The equations are the reference pipeline's (github.com/kendallsullivan/mcmc_spec,
``mft6.py``): the model grid linearly interpolated onto the data wavelengths; a
contrast filter's flux the trapezoid integral of spectrum times transmission over the
grid points inside the filter; a photometric band's flux pyphot's photon-counting mean
``trapz(lam T s) / trapz(lam T)`` over the points where the transmission is positive,
with the AB zero flux at the pivot wavelength; CCM89 extinction with R_V = 3.1; the
continuum a degree-2 polynomial fit of data/model on the wavelengths mapped onto
[-1, 1]; MIST 1-Gyr logg and luminosity interpolated linearly in Teff over the first 220
rows of the age-9.0 block; the Av prior a Gaussian whose mean and width are interpolated
linearly in log distance.
"""
from __future__ import annotations

import numpy as np

C_AA_PER_S = 2.99792458e18
AB_ZERO_FNU = 3.631e-20
MIST_AGE_LOG, MIST_MAX_ROWS = 9.0, 220
RV = 3.1

_OPT_A = (1.0, 0.17699, -0.50447, -0.02427, 0.72085, 0.01979, -0.77530, 0.32999)
_OPT_B = (0.0, 1.41338, 2.28305, 1.07233, -5.38434, -0.62251, 5.30260, -2.09002)


def linear_weights(src, dst):
    """(i, w): ``f(dst) = (1 - w) f[i] + w f[i + 1]`` on the sorted axis ``src``."""
    src, dst = np.asarray(src, np.float64), np.asarray(dst, np.float64)
    i = np.clip(np.searchsorted(src, dst, side="right") - 1, 0, len(src) - 2)
    return i, (dst - src[i]) / (src[i + 1] - src[i])


def trapz_weights(x):
    """w with ``w @ f == trapz(f, x)``."""
    x = np.asarray(x, np.float64)
    w = np.zeros_like(x)
    dx = 0.5 * np.diff(x)
    w[1:] += dx
    w[:-1] += dx
    return w


def contrast_weights(wl, fwl, ftr):
    order = np.argsort(fwl)
    fwl, ftr = np.asarray(fwl, np.float64)[order], np.asarray(ftr, np.float64)[order]
    inside = (wl >= fwl.min()) & (wl <= fwl.max())
    W = np.zeros_like(wl)
    W[inside] = trapz_weights(wl[inside]) * np.interp(wl[inside], fwl, ftr)
    return W


def photon_weights(wl, fwl, ftr):
    """(W, pivot wavelength) of pyphot's photon-counting band flux."""
    order = np.argsort(fwl)
    fwl, ftr = np.asarray(fwl, np.float64)[order], np.asarray(ftr, np.float64)[order]
    tr = np.interp(wl, fwl, ftr, left=0.0, right=0.0)
    pos = tr > 0.0
    sub, t = wl[pos], tr[pos]
    W = np.zeros_like(wl)
    W[pos] = trapz_weights(sub) * sub * t / float(trapz_weights(sub) @ (sub * t))
    pivot = np.sqrt((trapz_weights(fwl) @ (ftr * fwl)) / (trapz_weights(fwl) @ (ftr / fwl)))
    return W, float(pivot)


def ab_zero_flux(pivot_aa):
    return AB_ZERO_FNU * C_AA_PER_S / pivot_aa**2


def ccm89_k(wl_aa):
    """A(lambda) / A_V of Cardelli, Clayton & Mathis (1989), R_V = 3.1, in the infrared
    (x < 1.1 per micron) and optical (1.1 <= x < 3.3) branches that the bands and the
    data of this benchmark fall in; other wavelengths raise."""
    x = 1e4 / np.asarray(wl_aa, np.float64)
    if np.any(x >= 3.3):
        raise ValueError("ccm89_k: ultraviolet wavelengths are outside this reference")
    y = x - 1.82
    a_opt = np.polynomial.polynomial.polyval(y, _OPT_A)
    b_opt = np.polynomial.polynomial.polyval(y, _OPT_B)
    a = np.where(x < 1.1, 0.574 * x**1.61, a_opt)
    b = np.where(x < 1.1, -0.527 * x**1.61, b_opt)
    return a + b / RV


def continuum_matrices(wl):
    """(V [nd, 3], pinv(V) [3, nd]) of the degree-2 fit on ``wl`` mapped onto [-1, 1]."""
    wl = np.asarray(wl, np.float64)
    x = 2.0 * (wl - wl.min()) / (wl.max() - wl.min()) - 1.0
    V = np.stack([np.ones_like(x), x, x * x], axis=1)
    return V, np.linalg.pinv(V)


def mist_nodes(matrix):
    """(Teff, logg, L) nodes of the de-logged isochrone matrix (columns 1 age, 4 Teff,
    5 logg, 6 L), sorted by Teff."""
    rows = np.where(matrix[:, 1] == MIST_AGE_LOG)[0][:MIST_MAX_ROWS]
    order = np.argsort(matrix[rows, 4])
    return tuple(matrix[rows, c][order] for c in (4, 5, 6))


def pack(inp):
    """Everything the posterior reads, from one target's inputs (``harness.inputs``)."""
    wl = inp["grid_wl"]
    nT, nG, _ = inp["grid_flux"].shape
    flat = inp["grid_flux"].reshape(nT * nG, -1)
    data_aa = np.asarray(inp["data_wl_um"], np.float64) * 1e4
    i, w = linear_weights(wl, data_aa)
    D = flat[:, i] * (1.0 - w) + flat[:, i + 1] * w
    Fc = np.stack([flat @ contrast_weights(wl, f["wl"], f["tr"])
                   for f in inp["contrast_filters"]], axis=1)
    bands = [photon_weights(wl, f["wl"], f["tr"]) for f in inp["phot_filters"]]
    Fp = np.stack([flat @ W for W, _ in bands], axis=1)
    cwl = np.array([np.mean(f["wl"]) for f in inp["phot_filters"]])
    V, Vpinv = continuum_matrices(data_aa)
    teff_n, logg_n, lum_n = mist_nodes(inp["mist_matrix"])
    return {
        "nspec": int(inp["nspec"]),
        "temps": np.asarray(inp["grid_temps"], np.float64),
        "loggs": np.asarray(inp["grid_loggs"], np.float64),
        "D": D, "Fc": Fc, "Fp": Fp,
        "data": np.asarray(inp["data_flux"], np.float64),
        "err": np.asarray(inp["data_err"], np.float64),
        "kd": ccm89_k(data_aa), "V": V, "Vpinv": Vpinv,
        "med_data": float(np.median(inp["data_flux"])),
        "cmag": np.asarray(inp["cmag"], np.float64), "cerr": np.asarray(inp["cerr"], np.float64),
        "pmag": np.asarray(inp["pmag"], np.float64), "perr": np.asarray(inp["perr"], np.float64),
        "zp": np.asarray(inp["phot_zp"], np.float64), "k_cwl": ccm89_k(cwl),
        "mist_teff": teff_n, "mist_logg": logg_n, "mist_lum": lum_n,
        "av_logd": np.log(np.asarray(inp["av_dist_pc"], np.float64)),
        "av_mu": np.asarray(inp["av_mu"], np.float64),
        "av_sig": np.asarray(inp["av_sig"], np.float64),
        "prior_mu": np.asarray(inp["prior_mu"], np.float64),
        "prior_sig": np.asarray(inp["prior_sig"], np.float64),
    }
