"""Per-walker forward model (port of ``mcmc_spec_tpu.inference.posterior.forward``).

The scalar counterpart of the batched posterior: one parameter vector
``p [ndim]`` is blended from the four bracketing grid points of each
component by a bracket search and a gather, not by tent weights.  The bench
target (``bench_target.build_bench_target``) fills its observed contrasts
and photometry from it, as the JAX package's does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from mcmc_spec_tpu_torch.inference.target import PC_CM, RSUN_CM, PackedTarget
from mcmc_spec_tpu_torch.ops.interp import bilinear_bracket, bilinear_gather_blend, pwl_interp


def mist_logg(tgt: PackedTarget, teff):
    """MIST 1-Gyr logg(Teff) lookup."""
    return pwl_interp(tgt.mist_teff_nodes, tgt.mist_logg_nodes, teff)


class ForwardOut(NamedTuple):
    model_data: torch.Tensor  # [nd] composite on the data grid, unextincted
    contrasts: torch.Tensor  # [nc]
    phot_mags: torch.Tensor  # [npf] unextincted
    scales: torch.Tensor  # [nspec]
    loggs: torch.Tensor  # [nspec]


def _unpack(p, tgt: PackedTarget):
    n = tgt.nspec
    teffs = p[:n]
    av = p[n]
    if tgt.fit_plx:
        r1 = p[n + 1]
        ratios = p[n + 2 : 2 * n + 1]  # [n-1] radius ratios R_k/R_1
        plx = p[2 * n + 1]
    else:
        r1 = torch.ones((), dtype=p.dtype, device=p.device)
        ratios = p[n + 1 : 2 * n]
        plx = torch.zeros((), dtype=p.dtype, device=p.device)
    return teffs, av, r1, ratios, plx


def _component_scales(tgt: PackedTarget, r1, ratios, plx):
    """Flux scale per component: ``(R_k * RSUN / (d * PC))^2`` with ``d = 1/plx``;
    without a parallax the primary is unscaled and companions get ``(R_k/R_1)^2``."""
    if tgt.fit_plx:
        base = (r1 * RSUN_CM * plx / PC_CM) ** 2
        comps = [base] + [base * ratios[k] ** 2 for k in range(tgt.nspec - 1)]
    else:
        comps = [torch.ones((), dtype=ratios.dtype, device=ratios.device)]
        comps += [ratios[k] ** 2 for k in range(tgt.nspec - 1)]
    return torch.stack(comps)


def forward(p, tgt: PackedTarget) -> ForwardOut:
    """Composite spectrum on the data grid, contrasts and photometry of one walker."""
    teffs, av, r1, ratios, plx = _unpack(p, tgt)
    scales = _component_scales(tgt, r1, ratios, plx)
    loggs = mist_logg(tgt, teffs)  # [nspec]

    ds, fcs, fps = [], [], []
    for k in range(tgt.nspec):
        ti, tw = bilinear_bracket(tgt.temps, teffs[k])
        gi, gw = bilinear_bracket(tgt.loggs, loggs[k])
        ds.append(bilinear_gather_blend(tgt.D, ti, tw, gi, gw))
        fcs.append(bilinear_gather_blend(tgt.Fc, ti, tw, gi, gw))
        fps.append(bilinear_gather_blend(tgt.Fp, ti, tw, gi, gw))
    ds, fcs, fps = torch.stack(ds), torch.stack(fcs), torch.stack(fps)

    model_data = torch.einsum("k,kd->d", scales, ds)

    # contrast magnitudes: binary c = mag_2 - mag_1; triple: the first half of
    # the filters against component 2, the rest against component 3
    cflux = fcs * scales[:, None]  # [nspec, nc]
    mags = -2.5 * torch.log10(torch.clamp(cflux, min=1e-300))
    if tgt.nspec == 1:
        contrasts = torch.zeros((tgt.n_contrast,), dtype=p.dtype, device=p.device)
    elif tgt.nspec == 2:
        contrasts = mags[1] - mags[0]
    else:
        nc = tgt.n_contrast
        idx = torch.arange(nc, device=p.device)
        contrasts = torch.where(idx < nc // 2, mags[1] - mags[0], mags[2] - mags[0])

    # unresolved photometry: composite flux through each filter over its zero flux
    pflux = torch.einsum("k,kf->f", scales, fps)
    phot_mags = -2.5 * torch.log10(torch.clamp(pflux / tgt.phot_zp, min=1e-300))
    return ForwardOut(model_data, contrasts, phot_mags, scales, loggs)
