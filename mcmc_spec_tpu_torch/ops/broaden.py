"""Instrumental and rotational broadening and resampling (port of ``mcmc_spec_tpu.ops.broaden``).

The reference's broadening stack (``mft6.py:124-191``) without PyAstronomy:

* ``instrumental_broaden``: host Gaussian broadening, equivalent to
  ``pyasl.instrBroadGaussFast(wl, flux, res, maxsig=5)``: FWHM
  ``mean(wl)/R``, kernel sampled on the grid spacing out to ``maxsig`` sigma,
  unit-sum normalised, same-length convolution, then the reference's edge
  clamp of the first 5 and last 10 pixels.  Runs once, at grid-build time.
* ``instrumental_broaden_fft``: the same convolution with ``torch.fft`` on
  the flux's device (the JAX version's jit-safe variant).
* ``rotational_broaden``: vsini broadening with linear limb darkening (Gray's
  kernel), host numpy, as in JAX.
* ``redres`` (the PHOENIX-HiRes reader's decimation) and ``make_reg``:
  resampling helpers.
"""
from __future__ import annotations

import math

import numpy as np
import torch

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


def instrumental_broaden_fft(wl, flux, resolution, maxsig=5.0, clamp_edges=True):
    """Gaussian instrumental broadening by FFT convolution with ``torch.fft``.

    ``wl`` must be evenly spaced (the kernel is built from it on the host);
    ``flux`` is a tensor (or array) and the result a tensor on its device, in its
    float dtype.
    """
    wl_np = np.asarray(wl)
    flux = torch.as_tensor(flux)
    kern = torch.as_tensor(gaussian_instrumental_kernel(wl_np, resolution, maxsig),
                           dtype=flux.dtype, device=flux.device)
    n, k = wl_np.shape[0], kern.shape[0]
    fft_n = int(2 ** math.ceil(math.log2(n + k)))
    full = torch.fft.irfft(torch.fft.rfft(flux, fft_n) * torch.fft.rfft(kern, fft_n), fft_n)
    start = (k - 1) // 2  # the 'same' slice of the full convolution
    out = full[start:start + n].clone()
    if clamp_edges:
        out[:5] = out[5]
        out[n - 10:] = out[n - 11]
    return out


def rotational_broaden(wl, flux, vsini_kms, epsilon=0.6):
    """Rotational broadening with a linear limb-darkening law (host numpy).

    Convolves with Gray's rotational profile
    ``G(dl) = (2(1-eps)sqrt(1-(dl/dlmax)^2) + pi eps/2 (1-(dl/dlmax)^2)) /
    (pi dlmax (1-eps/3))`` where ``dlmax = lambda0 * vsini / c``: the analogue
    of ``pyasl.rotBroad`` (``mft6.py:133-137``; the reference pipeline never
    enables it, ``vsini=0`` throughout).
    """
    from scipy.signal import fftconvolve

    wl = np.asarray(wl)
    flux = np.asarray(flux, dtype=np.float64)
    c_kms = 299792.458
    dlmax = float(np.mean(wl)) * vsini_kms / c_kms
    dx = float(wl[1] - wl[0])
    half = max(1, int(math.ceil(dlmax / dx)))
    dl = np.arange(-half, half + 1) * dx
    u = np.clip(1.0 - (dl / dlmax) ** 2, 0.0, None)
    kern = (2.0 * (1.0 - epsilon) * np.sqrt(u) + math.pi * epsilon / 2.0 * u) / (
        math.pi * dlmax * (1.0 - epsilon / 3.0))
    s = kern.sum()
    if s <= 0:
        return flux
    return fftconvolve(flux, kern / s, mode="same")


def redres(wl, spec, factor):
    """Resample to a coarser even grid by ``factor`` (the reference's ``redres``)."""
    wl = np.asarray(wl)
    spec = np.asarray(spec)
    new_step = float(np.median(wl[1:] - wl[:-1])) * factor
    wl_new = np.arange(wl.min(), wl.max(), new_step)
    return wl_new, np.interp(wl_new, wl, spec)


def make_reg(wl, flux, waverange):
    """Evenly-resampled slice of a spectrum within ``waverange`` (``mft6.py:172-191``)."""
    wl = np.asarray(wl)
    step = float(wl[1] - wl[0])
    wl_slice = np.arange(min(waverange), max(waverange), step)
    return wl_slice, np.interp(wl_slice, wl, np.asarray(flux))
