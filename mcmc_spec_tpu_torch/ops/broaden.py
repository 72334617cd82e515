"""Host-side Gaussian instrumental broadening (port of part of ``mcmc_spec_tpu.ops.broaden``).

Equivalent to ``pyasl.instrBroadGaussFast(wl, flux, res, maxsig=5)``: FWHM
``mean(wl)/R``, kernel sampled on the grid spacing out to ``maxsig`` sigma,
unit-sum normalised, same-length convolution, then the reference's edge
clamp of the first 5 and last 10 pixels.  Runs once, at grid-build time.
"""
from __future__ import annotations

import math

import numpy as np

_FWHM_TO_SIGMA = 1.0 / (2.0 * math.sqrt(2.0 * math.log(2.0)))


def gaussian_instrumental_kernel(wl, resolution, maxsig=5.0):
    """Normalised Gaussian kernel on the grid spacing of ``wl``."""
    wl = np.asarray(wl)
    dx = float(wl[1] - wl[0])
    sigma = float(np.mean(wl)) / float(resolution) * _FWHM_TO_SIGMA
    half = max(1, int(maxsig * sigma / dx))
    offsets = np.arange(-half, half + 1) * dx
    kern = np.exp(-0.5 * (offsets / sigma) ** 2)
    return kern / kern.sum()


def edge_clamp(flux, n_lo=5, n_hi=10):
    """Clamp convolution edge artefacts like the reference."""
    flux = np.asarray(flux).copy()
    flux[:n_lo] = flux[n_lo]
    flux[len(flux) - n_hi:] = flux[len(flux) - n_hi - 1]
    return flux


def instrumental_broaden(wl, flux, resolution, maxsig=5.0, clamp_edges=True):
    """Gaussian instrumental broadening by FFT convolution; returns (wl, flux)."""
    from scipy.signal import fftconvolve

    kern = gaussian_instrumental_kernel(wl, resolution, maxsig)
    out = fftconvolve(np.asarray(flux, dtype=np.float64), kern, mode="same")
    if clamp_edges:
        out = edge_clamp(out)
    return np.asarray(wl), out
