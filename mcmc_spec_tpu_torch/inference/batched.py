"""Explicitly-batched posterior over a walker batch ``[nw, ndim]``.

Port of ``mcmc_spec_tpu.inference.batched``.  The composition below is the
JAX module's arithmetic in torch ops, for any dtype and device: tent-basis
interpolation (no gathers), the (Teff, logg) blend as a ``[nw, nT*nG]``
weight row, the model spectra as one ``Wcomb @ D`` product, then extinction,
the sort-based exact median match, continuum renorm and chi^2.

Dispatch, decided by device, dtype and target shape only:

* a CUDA float32 target eligible for fusion (``_fusable``) evaluates the
  whole log-posterior in the fused kernel (``ops.cuda_kernels``, K1);
* otherwise a CUDA float32 spectrum term runs the spectrum-chi^2 kernel (K3)
  up to ``LARGE_ND`` data points, and the segmented large-nd lane
  (``ops.spec_segmented``, K6-K9) above;
* everything else runs the torch composition.

Walkers of another dtype than the target are evaluated, as in JAX, in
``torch.promote_types`` of the two (``target.common_dtype``, through a cached
promoted copy of the target).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from mcmc_spec_tpu_torch.inference.target import PC_CM, RSUN_CM, PackedTarget, common_dtype
from mcmc_spec_tpu_torch.models.mist import LSUN, RSUN, SIGMA_SB
from mcmc_spec_tpu_torch.ops import cuda_kernels, spec_segmented
from mcmc_spec_tpu_torch.ops.interp import tent_weights
from mcmc_spec_tpu_torch.ops.spec_segmented import LARGE_ND


def _on_cuda_f32(p: torch.Tensor) -> bool:
    return p.device.type == "cuda" and p.dtype == torch.float32


def _unpack_batch(p, tgt: PackedTarget):
    n = tgt.nspec
    teffs = p[:, :n]
    av = p[:, n]
    if tgt.fit_plx:
        r1 = p[:, n + 1]
        ratios = p[:, n + 2 : 2 * n + 1]
        plx = p[:, 2 * n + 1]
    else:
        r1 = torch.ones_like(av)
        ratios = p[:, n + 1 : 2 * n]
        plx = torch.zeros_like(av)
    return teffs, av, r1, ratios, plx


def _scales_batch(tgt, r1, ratios, plx):
    if tgt.fit_plx:
        base = (r1 * RSUN_CM * plx / PC_CM) ** 2
        return torch.cat([base[:, None], base[:, None] * ratios**2], dim=1)
    return torch.cat([torch.ones_like(r1)[:, None], ratios**2], dim=1)


def mist_logg_batch(tgt, teffs):
    return tent_weights(tgt.mist_teff_nodes, teffs) @ tgt.mist_logg_nodes


def mist_radius_batch(tgt, teffs):
    lum = tent_weights(tgt.mist_teff_nodes, teffs) @ tgt.mist_lum_nodes
    return torch.sqrt(lum * LSUN / (4.0 * math.pi * SIGMA_SB * teffs**4)) / RSUN


def _forward_small(p, tgt: PackedTarget):
    """Everything except the model-spectrum product: weights + band fluxes."""
    n = tgt.nspec
    teffs, av, r1, ratios, plx = _unpack_batch(p, tgt)
    scales = _scales_batch(tgt, r1, ratios, plx)  # [nw, nspec]
    loggs = mist_logg_batch(tgt, teffs)  # [nw, nspec]

    Wt = tent_weights(tgt.temps, teffs)  # [nw, nspec, nT]
    Wg = tent_weights(tgt.loggs, loggs)  # [nw, nspec, nG]
    nw = p.shape[0]
    nT, nG, nd = tgt.D.shape
    NO = nT * nG
    Wk = (Wt[..., :, None] * Wg[..., None, :]).reshape(nw, n, NO)
    Wcomb = torch.einsum("ws,wso->wo", scales, Wk)  # [nw, NO]

    tiny = torch.finfo(p.dtype).tiny
    cflux = torch.einsum("wso,oc->wsc", Wk, tgt.Fc.reshape(NO, tgt.Fc.shape[-1]))
    cflux = cflux * scales[..., None]
    mags = -2.5 * torch.log10(torch.clamp(cflux, min=tiny))  # [nw, nspec, nc]
    if n == 1:
        contrasts = torch.zeros((nw, tgt.n_contrast), dtype=p.dtype, device=p.device)
    elif n == 2:
        contrasts = mags[:, 1, :] - mags[:, 0, :]
    else:
        nc = tgt.n_contrast
        first = torch.arange(nc, device=p.device)[None, :] < nc // 2
        contrasts = torch.where(first, mags[:, 1, :] - mags[:, 0, :],
                                mags[:, 2, :] - mags[:, 0, :])

    pflux = Wcomb @ tgt.Fp.reshape(NO, tgt.Fp.shape[-1])  # [nw, npf]
    phot = -2.5 * torch.log10(torch.clamp(pflux / tgt.phot_zp, min=tiny))
    return contrasts, phot, scales, Wk, Wcomb


def forward_batch(p, tgt: PackedTarget):
    """(model [nw,nd], contrasts [nw,nc], phot [nw,npf], scales, Wk)."""
    contrasts, phot, scales, Wk, Wcomb = _forward_small(p, tgt)
    nT, nG, nd = tgt.D.shape
    model = Wcomb @ tgt.D.reshape(nT * nG, nd)
    return model, contrasts, phot, scales, Wk


def _median_matched_model(Wcomb, av, tgt: PackedTarget):
    """Extincted model scaled to the data median (sorted-rank median, so
    padded sentinel points are ignored)."""
    nT, nG, nd = tgt.D.shape
    model_raw = Wcomb @ tgt.D.reshape(nT * nG, nd)
    trans = torch.where(
        (av > 0)[:, None],
        torch.exp((-0.4 * math.log(10.0)) * av[:, None] * tgt.ext_k_data[None, :]),
        torch.ones((), dtype=model_raw.dtype, device=model_raw.device),
    )
    model = model_raw * trans
    n_true = int(tgt.n_data_true)
    srt = torch.sort(model, dim=1).values
    med = 0.5 * (srt[:, (n_true - 1) // 2] + srt[:, n_true // 2])
    return model * (tgt.med_data / med)[:, None], n_true


def _spec_chi2_xla(Wcomb, av, tgt: PackedTarget):
    """Composition spectrum chi^2 (mean over data points), with continuum renorm."""
    model, n_true = _median_matched_model(Wcomb, av, tgt)
    frac = tgt.data_flux[None, :] / model
    coeffs = frac @ tgt.Vpinv.T  # [nw, 3]
    data_renorm = tgt.data_flux[None, :] / (coeffs @ tgt.V.T)
    resid2 = ((model - data_renorm) / tgt.data_err) ** 2
    # padded points have err=inf -> exact zero contribution
    resid2 = torch.where(torch.isfinite(resid2), resid2, torch.zeros_like(resid2))
    return resid2.sum(dim=1) / n_true


def _spec_chi2_xla_median_only(Wcomb, av, tgt: PackedTarget):
    """Annealer spectrum chi^2: median match, no continuum renorm."""
    model, n_true = _median_matched_model(Wcomb, av, tgt)
    resid2 = ((model - tgt.data_flux[None, :]) / tgt.data_err) ** 2
    resid2 = torch.where(torch.isfinite(resid2), resid2, torch.zeros_like(resid2))
    return resid2.sum(dim=1) / n_true


def _chi2_terms_batch(p, tgt: PackedTarget, spec_mult, chi_spec=None, renorm=True):
    n = tgt.nspec
    av = p[:, n]
    contrasts, phot_raw, _, _, Wcomb = _forward_small(p, tgt)

    if chi_spec is not None:
        pass  # precomputed by the caller
    elif tgt.spectrum_weight == 0.0:
        # nospec mode: the spectrum term is dropped entirely
        chi_spec = torch.zeros(p.shape[0], dtype=p.dtype, device=p.device)
    elif tgt.spectrum_backend != "xla" and _on_cuda_f32(p):
        nT, nG, nd = tgt.D.shape
        it, mm, rn = cuda_kernels.resolve_dials(tgt)
        args = (Wcomb, av, tgt.D.reshape(nT * nG, nd), tgt.ext_k_data, tgt.data_flux,
                tgt.data_err, tgt.V, tgt.Vpinv, tgt.med_data)
        if nd > LARGE_ND:
            # native-resolution regime: a row no longer fits a block's shared
            # memory; the segmented lane streams the model through device memory
            chi_spec = spec_segmented.spectrum_chi2_segmented(
                *args, tgt.n_data_true, iters=it, mm_passes=mm, recip=rn, renorm=renorm)
        else:
            chi_spec = cuda_kernels.spectrum_chi2(
                *args, iters=it, mm_passes=mm, recip=rn, renorm=renorm)
    elif renorm:
        chi_spec = _spec_chi2_xla(Wcomb, av, tgt)
    else:
        chi_spec = _spec_chi2_xla_median_only(Wcomb, av, tgt)

    phot = torch.where((av > 0)[:, None], phot_raw + av[:, None] * tgt.ext_k_cwl[None, :],
                       phot_raw)
    chi_c = (((contrasts - tgt.cmag) / tgt.cerr) ** 2).sum(dim=1)
    chi_p = (((phot - tgt.pmag) / tgt.perr) ** 2).sum(dim=1)

    nc_t = tgt.n_contrast_true.to(chi_c.dtype)
    np_t = tgt.n_phot_true.to(chi_c.dtype)
    if tgt.fit_plx:
        weight = spec_mult * (nc_t + np_t)
    else:
        weight = spec_mult * nc_t
        chi_p = torch.zeros_like(chi_p)
    return tgt.spectrum_weight * weight * chi_spec, chi_c, chi_p


def chi2_total_batch(p, tgt: PackedTarget, spec_mult=1.0, chi_spec=None, renorm=True):
    a, b, c = _chi2_terms_batch(p, tgt, spec_mult, chi_spec=chi_spec, renorm=renorm)
    return a + b + c


def _neg_inf_like(x):
    return torch.full_like(x, -math.inf)


def log_likelihood_batch(p, tgt: PackedTarget, chi_spec=None):
    cs = chi2_total_batch(p, tgt, spec_mult=1.0, chi_spec=chi_spec)
    return torch.where(torch.isnan(cs), _neg_inf_like(cs), -0.5 * cs)


def _bounds_ok_batch(p, tgt: PackedTarget):
    n = tgt.nspec
    teffs, av, r1, ratios, plx = _unpack_batch(p, tgt)
    ok = (teffs <= tgt.tmax).all(dim=1) & (teffs >= tgt.tmin).all(dim=1) & (av >= 0)
    ok &= (ratios >= 0.05).all(dim=1)
    if tgt.fit_plx:
        ok &= r1 >= 0.05
        if tgt.dist_fit:
            # nospec mode tightens the parallax upper bound to 1/100
            plx_hi = 0.01 if tgt.spectrum_weight == 0.0 else 0.25
            if n <= 2:
                ok &= (r1 <= 1.5) & (plx >= 1.0 / 3000.0) & (plx <= plx_hi)
            else:
                ok &= (plx >= 1.0 / 1000.0) & (plx <= plx_hi)
    return ok


def _av_prior_mu_sig(tgt: PackedTarget, plx):
    dist_pc = 1.0 / torch.clamp(plx, min=1e-12)
    logd = torch.log(torch.clamp(dist_pc, min=1e-3))
    w = tent_weights(tgt.av_logd_nodes, logd)
    return w @ tgt.av_mu_nodes, w @ tgt.av_sig_nodes


def _radius_prior_terms(tgt: PackedTarget, teffs, r1, ratios):
    """(radius values, MIST model values) the radius prior compares."""
    mrad = mist_radius_batch(tgt, teffs)  # [nw, nspec]
    m1 = mrad[:, 0]
    model_vals = torch.cat([m1[:, None], mrad[:, 1:] / m1[:, None]], dim=1)
    if tgt.fit_plx:
        return torch.cat([r1[:, None], ratios], dim=1), model_vals
    return ratios, model_vals[:, 1:]


def log_prior_batch(p, tgt: PackedTarget):
    teffs, av, r1, ratios, plx = _unpack_batch(p, tgt)
    lp = torch.zeros(p.shape[0], dtype=p.dtype, device=p.device)

    if tgt.fit_plx:
        mu, sig = _av_prior_mu_sig(tgt, plx)
        lp = lp + -0.5 * ((av - mu) / sig) ** 2

    active = (tgt.prior_mu != 0)[None, :]
    gauss = -0.5 * ((p - tgt.prior_mu[None, :]) / tgt.prior_sig[None, :]) ** 2
    lp = lp + torch.where(active, gauss, torch.zeros_like(gauss)).sum(dim=1)

    if tgt.rad_prior:
        rvals, model_vals = _radius_prior_terms(tgt, teffs, r1, ratios)
        lp = lp + (-0.5 * ((rvals - model_vals) / (tgt.rad_sigma_frac * model_vals)) ** 2
                   ).sum(dim=1)

    return torch.where(_bounds_ok_batch(p, tgt), lp, _neg_inf_like(lp))


def _fusable(tgt: PackedTarget) -> bool:
    """Eligible for the one-kernel-per-eval fused path: unpadded target with
    non-empty contrast and photometry blocks and a data axis the
    one-block-per-walker kernel takes."""
    return (
        tgt.spectrum_backend != "xla"
        and tgt.n_contrast > 0
        and tgt.n_phot > 0
        and tgt.D.shape[2] <= LARGE_ND
    )


def log_posterior_batch(p, tgt: PackedTarget, chi_spec=None):
    """Batched log-posterior: the sampler hot path (see module docstring)."""
    p, tgt = common_dtype(p, tgt)
    if chi_spec is None and _fusable(tgt) and _on_cuda_f32(p):
        return cuda_kernels.log_posterior_fused(p, tgt)
    lp = log_prior_batch(p, tgt)
    ll = log_likelihood_batch(p, tgt, chi_spec=chi_spec)
    return torch.where(torch.isfinite(lp), lp + ll, _neg_inf_like(lp))


def optimizer_chi2_batch(p, tgt: PackedTarget, rad_sigma=None, chi_spec=None):
    """Batched stage-1 chi^2 (x3 spectrum weight + chi^2-convention priors).

    ``rad_sigma``: [nw, n_rad] step-size sigmas from the annealer.
    The annealer's median-only scoring has no alpha^2 protection against a
    median error, so stage 1 always uses the exact median whatever the
    target's production dial.
    """
    p, tgt = common_dtype(p, tgt)
    teffs, av, r1, ratios, plx = _unpack_batch(p, tgt)
    if chi_spec is None and tgt.median_iters not in (0, 31):
        tgt = dataclasses.replace(tgt, median_iters=31)
    cs = chi2_total_batch(p, tgt, spec_mult=3.0, chi_spec=chi_spec, renorm=False)

    if tgt.fit_plx:
        mu, sig = _av_prior_mu_sig(tgt, plx)
        cs = cs + ((av - mu) / sig) ** 2
        if tgt.dist_fit:
            plx_term = ((plx - tgt.prior_mu[-1]) / tgt.prior_sig[-1]) ** 2
            cs = cs + torch.where(tgt.prior_mu[-1] != 0, plx_term, torch.zeros_like(plx_term))

    if tgt.rad_prior:
        rvals, model_vals = _radius_prior_terms(tgt, teffs, r1, ratios)
        if rad_sigma is None:
            rad_sigma = 0.05 * rvals
        cs = cs + (((rvals - model_vals) / rad_sigma) ** 2).sum(dim=1)
    return cs
