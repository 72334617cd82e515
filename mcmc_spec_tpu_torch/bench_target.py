"""Self-contained koi2298-scale target: no external data (port of ``mcmc_spec_tpu.bench_target``).

A binary fit with 1792 data wavelengths (HET/LRS2-like), 2 contrast filters,
6 photometric filters and a 14x4 (Teff, logg) grid: the tensor shapes of the
real koi2298 fit, built from the synthetic model family.  The observed
contrasts and photometry are the scalar forward model at truth
(``inference.posterior.forward``) plus seeded noise, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from mcmc_spec_tpu_torch.inference.posterior import forward
from mcmc_spec_tpu_torch.inference.target import PC_CM, RSUN_CM, pack_target
from mcmc_spec_tpu_torch.models.dust import AvProfile
from mcmc_spec_tpu_torch.models.mist import MistTable
from mcmc_spec_tpu_torch.models.synthetic import synthetic_grid
from mcmc_spec_tpu_torch.ops.photometry import FilterCurve, ab_zero_flux, photon_flux_weights

TRUTH = np.array([4600.0, 3400.0, 0.12, 0.72, 0.45, 2.0e-3])


def _gaussian_filter(name, center, width, n=256):
    wl = np.linspace(center - 4 * width, center + 4 * width, n)
    return FilterCurve(name=name, wl=wl, tr=np.exp(-0.5 * ((wl - center) / width) ** 2))


@functools.lru_cache(maxsize=2)
def _bench_grid(grid_step):
    """The synthetic model grid, built once per step: a fleet's members share it."""
    return synthetic_grid(
        specrange=(3000.0, 26000.0),
        data_window=(6450.0, 8400.0),
        resolution=1700,
        temps=np.arange(3000.0, 5601.0, 200.0),
        loggs=np.array([4.0, 4.5, 5.0, 5.5]),
        step=grid_step,
    )


def build_bench_target(dtype=torch.float32, device="cuda", nd=1792, grid_step=1.0, nspec=2,
                       seed=0, pad_nd=None, pad_nc=None, n_contrast=2):
    """(PackedTarget, truth params). Deterministic.

    ``pad_nd``/``pad_nc`` pad the target with inert fleet padding
    (``pack_target``).  ``n_contrast`` keeps the first 1 or 2 contrast
    filters, for fleets of targets with ragged contrast counts.
    """
    rng = np.random.RandomState(seed)
    grid = _bench_grid(grid_step)
    mist = MistTable.builtin()

    data_wl_um = np.linspace(0.652, 0.838, nd)
    p = TRUTH.copy()
    if nspec == 3:
        p = np.array([4600.0, 3800.0, 3300.0, 0.12, 0.72, 0.55, 0.3, 2.0e-3])

    # composite at truth on the data grid
    d_pc = 1.0 / p[-1]
    r1 = p[nspec + 1]
    ratios = np.concatenate([[1.0], p[nspec + 2 : 2 * nspec + 1]])
    comp = np.zeros(len(grid.wl))
    for k in range(nspec):
        scale = (r1 * ratios[k] * RSUN_CM / (d_pc * PC_CM)) ** 2
        comp += scale * grid.interp_spectrum(p[k], float(mist.get_logg(p[k])))
    flux = np.interp(data_wl_um * 1e4, grid.wl, comp)
    err = 0.01 * np.abs(flux)
    flux = flux + rng.normal(0, err)
    med = np.median(flux)
    flux, err = flux / med, err / med

    cfilts = [_gaussian_filter("lp600ish", 6000.0, 150.0),
              _gaussian_filter("Kpish", 21000.0, 400.0)][:n_contrast]
    pfilts = [
        _gaussian_filter("r", 6250.0, 300.0), _gaussian_filter("i", 7700.0, 350.0),
        _gaussian_filter("z", 9100.0, 400.0), _gaussian_filter("J", 12350.0, 500.0),
        _gaussian_filter("H", 16620.0, 600.0), _gaussian_filter("K", 21590.0, 700.0),
    ]
    zps = [ab_zero_flux(photon_flux_weights(f.wl, f.wl, f.tr)[1]) for f in pfilts]

    ndim = 2 * nspec + 2
    prior_mu = np.zeros(ndim)
    prior_sig = np.ones(ndim)
    prior_mu[-1] = p[-1]
    prior_sig[-1] = 0.05e-3

    tgt = pack_target(
        grid, data_wl_um, flux, err,
        cfilts, np.array([2.0, 1.3][: len(cfilts)]), np.full(len(cfilts), 0.05),
        pfilts, zps,
        # placeholder observations; replaced below with model-at-truth + noise
        pmag=np.zeros(len(pfilts)), perr=np.full(len(pfilts), 0.05),
        mist=mist, av_profile=AvProfile.constant(0.12, 0.05),
        nspec=nspec, dist_fit=True, rad_prior=False,
        prior_mu=prior_mu, prior_sig=prior_sig, dtype=dtype, device=device,
        pad_nd=pad_nd, pad_nc=pad_nc,
    )
    out = forward(torch.as_tensor(p, dtype=dtype, device=device), tgt)
    as_t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    # noise draws are sized by the true filter counts, so a padded build
    # consumes the same RNG stream as its unpadded twin
    cnoise = np.zeros(out.contrasts.shape[-1])
    cnoise[: len(cfilts)] = rng.normal(0, 0.02, len(cfilts))
    cmag = out.contrasts + as_t(cnoise)
    pmag = out.phot_mags + as_t(rng.normal(0, 0.02, len(pfilts)))
    return dataclasses.replace(tgt, cmag=cmag, pmag=pmag), p


def init_walker_batch(tgt, truth, nwalk, dtype=torch.float32, seed=1):
    """Truth-centred walker cloud for benchmarking and sampling."""
    gen = torch.Generator(device=tgt.device).manual_seed(seed)
    scale = torch.as_tensor(
        np.concatenate([np.full(tgt.nspec, 50.0), [0.02], np.full(tgt.nspec, 0.02), [0.02e-3]]),
        dtype=dtype, device=tgt.device)
    noise = torch.randn((nwalk, len(truth)), generator=gen, dtype=dtype, device=tgt.device)
    return torch.as_tensor(truth, dtype=dtype, device=tgt.device) + noise * scale
