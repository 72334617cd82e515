"""The log-posterior of a binary- or triple-star fit over a batch of walkers, in plain
PyTorch.

A walker of a binary (``nspec`` 2) is (T1, T2, Av, R1, R2/R1, parallax); of a triple
(``nspec`` 3) (T1, T2, T3, Av, R1, R2/R1, R3/R1, parallax).  Each component's spectrum
is the bilinear blend of the four model-grid rows around (Teff, logg(Teff)), scaled by
(R RSUN parallax / PC)^2; the composite is reddened by CCM89 (Av > 0), matched to the
data's median, divided into the data for a degree-2 continuum fit, and compared by
chi^2, the mean over the data points weighted by the number of bands.  Contrasts are
magnitude differences of the components' filter fluxes: a binary's each companion
minus primary; a triple's split on the contrast count nc as the reference pipeline
splits its contrast list (``mft6.py``), contrast j < nc // 2 component 2 minus the
primary, the rest component 3 minus the primary.  Photometry is the composite's AB
magnitudes plus Av k(band).  Priors: the Av prior at the walker's distance, Gaussian
priors where the configuration sets a mean, and the bounds of the pipeline's
``logprior``, which follow ``nspec``: Teff inside the grid, Av >= 0, every radius ratio
>= 0.05, parallax <= 0.25, R1 in [0.05, 1.5] and parallax >= 1/3000 for a binary, R1
>= 0.05 and parallax >= 1/1000 for a triple.  Other values of ``nspec`` raise.

Two of the configuration's dials change the arithmetic, as the configuration states
them: the data median is found by halving [0, +inf's pattern] over the float32 bit
patterns, stopping after ``iters`` bits and returning the middle of the bracket left
(the search of the fused kernels), and the continuum fit's two divisions take a
reciprocal from the integer seed 0x7EF311C3 refined by ``recip`` Newton steps (0: true
division).

Everything is computed in float32 with TF32 off, in blocks of walkers whose size
follows from the data length (``block_rows``); ``tf32=True`` lets the products run in
TF32, the precision below the configuration's (the control).
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

RSUN_CM = 6.957e10
PC_CM = 3.086e18
LN10 = math.log(10.0)
F32_INF_BITS = 0x7F800000
RECIP_MAGIC = 0x7EF311C3
# nspec: (R1's ceiling, parallax's floor) of the reference pipeline's logprior
BOUNDS = {2: (1.5, 1.0 / 3000.0), 3: (math.inf, 1.0 / 1000.0)}


def companions(nspec: int, nc: int) -> list:
    """The component that each of ``nc`` contrasts sets against the primary (0)."""
    if nspec not in BOUNDS:
        raise ValueError(f"the reference covers nspec 2 and 3, not {nspec}")
    return [1 if nspec == 2 or j < nc // 2 else 2 for j in range(nc)]


def tables(ref: dict, device, dtype=torch.float32) -> dict:
    """The packed reference (``pack.pack``) as tensors on ``device``."""
    out = {}
    for k, v in ref.items():
        out[k] = torch.as_tensor(v, dtype=dtype, device=device) if isinstance(v, np.ndarray) else v
    out["tmin"], out["tmax"] = float(ref["temps"].min()), float(ref["temps"].max())
    out["n_bands"] = len(ref["cmag"]) + len(ref["pmag"])
    return out


def interp_weights(nodes, q):
    """[B, n] weights of ``np.interp(q, nodes, .)`` (clamped at the ends) for q [B]."""
    n = nodes.shape[0]
    i = torch.clamp(torch.searchsorted(nodes, q.contiguous(), right=True) - 1, 0, n - 2)
    w = torch.clamp((q - nodes[i]) / (nodes[i + 1] - nodes[i]), 0.0, 1.0)
    out = torch.zeros((q.shape[0], n), dtype=q.dtype, device=q.device)
    out.scatter_(1, i[:, None], (1.0 - w)[:, None])
    out.scatter_add_(1, (i + 1)[:, None], w[:, None])
    return out


def reciprocal(x, newton: int):
    """1/x from the integer seed and ``newton`` Newton steps (float32)."""
    xi = x.contiguous().view(torch.int32).to(torch.int64)
    r = RECIP_MAGIC - xi
    r = torch.where(r >= 2**31, r - 2**32, r).to(torch.int32).view(torch.float32)
    for _ in range(newton):
        r = r * (2.0 - x * r)
    return r


def divide(num, den, recip: int):
    return num / den if recip == 0 else num * reciprocal(den, recip)


def median_bits(model, iters: int):
    """The dial's median of each row of non-negative float32 ``model`` ([B, 1])."""
    n = model.shape[1]
    rank = (n + 1) // 2
    mi = model.contiguous().view(torch.int32)
    B = model.shape[0]
    lo = torch.zeros((B, 1), dtype=torch.int32, device=model.device)
    hi = torch.full((B, 1), F32_INF_BITS, dtype=torch.int32, device=model.device)
    for _ in range(iters):
        mid = lo + ((hi - lo) >> 1)
        ge = (mi <= mid).sum(dim=1, keepdim=True) >= rank
        lo, hi = torch.where(ge, lo, mid + 1), torch.where(ge, mid, hi)
    return (lo + ((hi - lo) >> 1)).view(torch.float32)


def _block(p, t, iters, recip):
    n = t["nspec"]
    comp = companions(n, t["Fc"].shape[1])
    nT, nG = t["temps"].shape[0], t["loggs"].shape[0]
    tiny = torch.finfo(p.dtype).tiny
    teffs, av = p[:, :n], p[:, n]
    r1, ratios, plx = p[:, n + 1], p[:, n + 2:2 * n + 1], p[:, 2 * n + 1]
    base = (r1 * RSUN_CM * plx / PC_CM) ** 2
    scales = torch.cat([base[:, None], base[:, None] * ratios**2], dim=1)

    Wcomb, cmags = 0.0, []
    for s in range(n):
        logg = interp_weights(t["mist_teff"], teffs[:, s]) @ t["mist_logg"]
        Wk = (interp_weights(t["temps"], teffs[:, s])[:, :, None]
              * interp_weights(t["loggs"], logg)[:, None, :]).reshape(-1, nT * nG)
        sWk = scales[:, s:s + 1] * Wk
        Wcomb = Wcomb + sWk
        cmags.append(-2.5 / LN10 * torch.log(torch.clamp(sWk @ t["Fc"], min=tiny)))
    rows, cols = torch.as_tensor(comp, device=p.device), torch.arange(len(comp), device=p.device)
    contrasts = torch.stack(cmags, dim=1)[:, rows, cols] - cmags[0]
    phot = -2.5 / LN10 * torch.log(torch.clamp((Wcomb @ t["Fp"]) / t["zp"], min=tiny))
    reddened = (av > 0)[:, None]
    phot = torch.where(reddened, phot + av[:, None] * t["k_cwl"], phot)
    chi_c = (((contrasts - t["cmag"]) / t["cerr"]) ** 2).sum(dim=1)
    chi_p = (((phot - t["pmag"]) / t["perr"]) ** 2).sum(dim=1)

    model = Wcomb @ t["D"]
    model = model * torch.where(reddened, torch.exp(-0.4 * LN10 * av[:, None] * t["kd"]),
                                torch.ones((), dtype=p.dtype, device=p.device))
    model = model * (t["med_data"] / median_bits(model, iters))
    frac = divide(t["data"], model, recip)
    coeffs = torch.stack([(frac * t["Vpinv"][k]).sum(dim=1) for k in range(3)], dim=1)
    fitted = sum(coeffs[:, k:k + 1] * t["V"][:, k] for k in range(3))
    resid = (model - divide(t["data"], fitted, recip)) / t["err"]
    chi_spec = (resid * resid).mean(dim=1)

    cs = t["n_bands"] * chi_spec + chi_c + chi_p
    ll = torch.where(torch.isnan(cs), torch.full_like(cs, -math.inf), -0.5 * cs)

    logd = torch.log(torch.clamp(1.0 / torch.clamp(plx, min=1e-12), min=1e-3))
    wav = interp_weights(t["av_logd"], logd)
    mu, sig = wav @ t["av_mu"], wav @ t["av_sig"]
    lp = -0.5 * ((av - mu) / sig) ** 2
    active = t["prior_mu"] != 0
    gauss = -0.5 * ((p - t["prior_mu"]) / t["prior_sig"]) ** 2
    lp = lp + torch.where(active, gauss, torch.zeros_like(gauss)).sum(dim=1)
    ok = ((teffs >= t["tmin"]) & (teffs <= t["tmax"])).all(dim=1) & (av >= 0)
    r1_max, plx_min = BOUNDS[n]
    ok &= (ratios >= 0.05).all(dim=1) & (r1 >= 0.05) & (r1 <= r1_max)
    ok &= (plx >= plx_min) & (plx <= 0.25)
    lp = torch.where(ok, lp, torch.full_like(lp, -math.inf))
    return torch.where(torch.isfinite(lp), lp + ll, torch.full_like(lp, -math.inf))


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """Products in float32 (TF32 off), or in TF32 for the control."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def block_rows(nd: int) -> int:
    """Walkers a block: the largest power of two whose [block, nd] float32 rows take at
    most 32 MiB (4,096 at nd = 1,792)."""
    return 1 << max(0, ((1 << 23) // nd).bit_length() - 1)


def log_posterior(P, t, iters: int, recip: int, tf32: bool = False):
    """[B] float32 log-posteriors of the walkers ``P`` [B, 2 nspec + 2] on the tables
    ``t``."""
    P = P.to(device=t["D"].device, dtype=torch.float32)
    block = block_rows(t["D"].shape[1])
    with torch.no_grad(), matmul_precision(tf32):
        return torch.cat([_block(P[i:i + block], t, iters, recip)
                          for i in range(0, P.shape[0], block)])


def _host_weights(nodes, q):
    """[n] weights of ``np.interp(q, nodes, .)`` at one query."""
    i = int(np.clip(np.searchsorted(nodes, q, side="right") - 1, 0, len(nodes) - 2))
    w = float(np.clip((q - nodes[i]) / (nodes[i + 1] - nodes[i]), 0.0, 1.0))
    out = np.zeros(len(nodes))
    out[i], out[i + 1] = 1.0 - w, w
    return out


def forward_bands(p, ref: dict):
    """(contrasts, unreddened AB magnitudes) of one walker ``p`` [2 nspec + 2] at float64
    on the host: the scalar forward model the observations are made from."""
    n = ref["nspec"]
    comp = companions(n, ref["Fc"].shape[1])
    teffs, r1, ratios, plx = p[:n], p[n + 1], np.asarray(p[n + 2:2 * n + 1]), p[2 * n + 1]
    base = (r1 * RSUN_CM * plx / PC_CM) ** 2
    scales = np.concatenate([[base], base * ratios**2])
    cflux, pflux = [], 0.0
    for s in range(n):
        logg = np.interp(teffs[s], ref["mist_teff"], ref["mist_logg"])
        w = scales[s] * np.outer(_host_weights(ref["temps"], teffs[s]),
                                 _host_weights(ref["loggs"], logg)).ravel()
        cflux.append(w @ ref["Fc"])
        pflux = pflux + w @ ref["Fp"]
    mags = -2.5 * np.log10(np.stack(cflux))
    return mags[comp, np.arange(len(comp))] - mags[0], -2.5 * np.log10(pflux / ref["zp"])
