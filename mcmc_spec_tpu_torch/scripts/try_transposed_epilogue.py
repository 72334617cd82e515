"""K1 with its scalar epilogue run walkers-across-lanes, on the card
(counterpart of ``scripts/try_transposed_epilogue.py``).

The block-per-walker posterior body (``csrc/posterior_body.cuh``, K1's
first version, still K5's) runs the walker's scalar part (MIST logg, grid
weights, contrast and photometry magnitudes, priors, bounds) in one warp with
lanes over grid points and bands while the other seven warps wait; K1 now
runs one warp per walker.  ``posterior_transposed`` (S8,
``csrc/posterior_transposed.cu``) runs one block per tile of 32 walkers: the
W path as K1 does, the spectrum block of each walker in turn, then the
epilogue of the whole tile in one warp, one walker per lane.  It computes K1's
log-posterior: identical -inf support and rel <= 5e-5 against K1 (the JAX
script's gate).  The scope is the JAX script's: a binary with a fitted
parallax, the distance bounds, no radius prior and a spectrum (the bench
target).

The script checks the gate on 512 walkers, then times K1 ("row-major") and S8
("transposed") at 32,768 walkers on the bench target at the production dials
(14, 3, 2).

    python -m mcmc_spec_tpu_torch.scripts.try_transposed_epilogue
"""
from __future__ import annotations

import dataclasses
import math

import torch

from mcmc_spec_tpu_torch.bench_target import build_bench_target, init_walker_batch
from mcmc_spec_tpu_torch.ops import cuda_kernels as ck
from mcmc_spec_tpu_torch.scripts import ablate_fused_sections as ab
from mcmc_spec_tpu_torch.scripts.timing import describe, resolve_device, timer

NWALK = 32768
ND = 1792
NCHECK = 512
DIALS = dict(median_iters=14, matmul_passes=3, recip_newton=2)
RTOL = 5e-5
_F32 = torch.float32


def _tent_w_T(tc, q):
    """Tent weights [n, B] for queries ``q`` [1, B] given [4, n] constants: ``_tent_w``
    with the broadcast flipped, walkers along the last axis."""
    left = (q - tc[0][:, None]) * tc[1][:, None]
    right = (tc[2][:, None] - q) * tc[3][:, None]
    return torch.clamp(torch.minimum(left, right), 0.0, 1.0)


def posterior_transposed_reference(p, tgt):
    """Plain PyTorch version of ``posterior_transposed``: [B] f32, the arithmetic of the
    JAX body ``_posterior_kernel_T``: K1's W path and spectrum block with walkers
    along rows, then the epilogue with walkers along columns."""
    ab.check_scope(tgt, "posterior_transposed")
    iters, _, recip = ck.resolve_dials(tgt)
    t = ck.kernel_tables(tgt)
    tmin, tmax, med_data = t["scal"][0], t["scal"][1], t["scal"][2]
    p = p.to(device=tgt.device, dtype=_F32)
    n = tgt.nspec
    tiny = torch.finfo(_F32).tiny

    # the row-major W path, feeding the [B, nd] spectrum block
    r1, plx = p[:, n + 1 : n + 2], p[:, 2 * n + 1 : 2 * n + 2]
    base = (r1 * ck._RSUN_CM * plx / ck._PC_CM) ** 2
    scales = [base] + [base * p[:, n + 1 + s : n + 2 + s] ** 2 for s in range(1, n)]
    Wcomb = None
    for s in range(n):
        teff = p[:, s : s + 1]
        logg = (ck._tent_w(t["mist_tent"], teff) * t["mist_vals"][0][None, :]).sum(
            dim=1, keepdim=True)
        sWk = scales[s] * (ck._tent_w(t["tentT"], teff) * ck._tent_w(t["tentG"], logg))
        Wcomb = sWk if Wcomb is None else Wcomb + sWk
    chi_specT = ck._spectrum_block(Wcomb, p[:, n : n + 1], t["D"], t["kd"], t["data"],
                                   t["inv_err"], t["VpinvT"], t["VT"], med_data, iters,
                                   recip=recip).T  # [1, B]

    # the transposed epilogue: walkers across columns
    pT = p.T
    teffsT = [pT[s : s + 1] for s in range(n)]
    avT, r1T, plxT = pT[n : n + 1], pT[n + 1 : n + 2], pT[2 * n + 1 : 2 * n + 2]
    ratiosT = [pT[n + 1 + s : n + 2 + s] for s in range(1, n)]
    baseT = (r1T * ck._RSUN_CM * plxT / ck._PC_CM) ** 2
    scalesT = [baseT] + [baseT * r**2 for r in ratiosT]
    FcT, FpT = t["Fc"].T, t["Fp"].T
    cmagsT, WcombT = [], None
    for s in range(n):
        loggT = (_tent_w_T(t["mist_tent"], teffsT[s]) * t["mist_vals"][0][:, None]).sum(
            dim=0, keepdim=True)
        sWkT = scalesT[s] * (_tent_w_T(t["tentT"], teffsT[s]) * _tent_w_T(t["tentG"], loggT))
        WcombT = sWkT if WcombT is None else WcombT + sWkT
        cmagsT.append(-2.5 / ck.LN10 * torch.log(torch.clamp(FcT @ sWkT, min=tiny)))
    contrastsT = cmagsT[1] - cmagsT[0]  # [nc, B]
    cobs, pobs = t["cobs"], t["pobs"]
    photT = -2.5 / ck.LN10 * torch.log(torch.clamp((FpT @ WcombT) / pobs[2][:, None], min=tiny))
    photT = torch.where(avT > 0, photT + avT * pobs[3][:, None], photT)
    chi_cT = (((contrastsT - cobs[0][:, None]) / cobs[1][:, None]) ** 2).sum(dim=0, keepdim=True)
    chi_pT = (((photT - pobs[0][:, None]) / pobs[1][:, None]) ** 2).sum(dim=0, keepdim=True)
    csT = tgt.spectrum_weight * ck._chi2_weight(tgt) * chi_specT + chi_cT + chi_pT
    neg_inf = torch.tensor(-math.inf, dtype=_F32, device=p.device)
    llT = torch.where(torch.isnan(csT), neg_inf, -0.5 * csT)

    logdT = torch.log(torch.clamp(1.0 / torch.clamp(plxT, min=1e-12), min=1e-3))
    wavT = _tent_w_T(t["av_tent"], logdT)  # [nav, B]
    muT = (wavT * t["av_vals"][0][:, None]).sum(dim=0, keepdim=True)
    sigT = (wavT * t["av_vals"][1][:, None]).sum(dim=0, keepdim=True)
    lpT = -0.5 * ((avT - muT) / sigT) ** 2
    pmuT, psigT = t["prior"][0][:, None], t["prior"][1][:, None]
    gaussT = -0.5 * ((pT - pmuT) / psigT) ** 2
    lpT = lpT + torch.where(pmuT != 0, gaussT, torch.zeros_like(gaussT)).sum(dim=0, keepdim=True)
    ok = avT >= 0
    for te in teffsT:
        ok = ok & (te <= tmax) & (te >= tmin)
    for r in ratiosT:
        ok = ok & (r >= 0.05)
    ok = ok & (r1T >= 0.05) & (r1T <= 1.5) & (plxT >= 1.0 / 3000.0) & (plxT <= 0.25)
    lpT = torch.where(ok, lpT, neg_inf)
    return torch.where(torch.isfinite(lpT), lpT + llT, neg_inf)[0]


def posterior_transposed(p, tgt):
    """S8: K1's log-posterior of walkers ``p`` [B, ndim] with the walkers-across-lanes
    epilogue ([B] f32)."""
    ab.check_scope(tgt, "posterior_transposed")
    ck.resolve_dials(tgt)
    if p.device.type == "cpu":
        return posterior_transposed_reference(p, tgt)
    ck._require_cuda(p, "posterior_transposed")
    out, args = ck.posterior_launch_args(p, tgt, "posterior_transposed")
    if args:
        ck._launch("posterior_transposed_launch", "posterior_transposed", *args,
                   ck._stream(p.device))
    return out


def max_rel_on_support(got, ref) -> tuple:
    """(identical -inf support, max relative difference on the finite values): the JAX
    script's comparison."""
    fin = torch.isfinite(ref)
    same = bool(torch.equal(fin, torch.isfinite(got)))
    if not bool(fin.any()):
        return same, 0.0
    g, r = got[fin].double(), ref[fin].double()
    return same, float(((g - r).abs() / r.abs().clamp(min=1e-9)).max())


def main(device="cuda", nwalk=NWALK, nd=ND, grid_step=1.0):
    dev = resolve_device(device)
    time_fn = timer(dev)
    print(f"[env] {describe(dev)}", flush=True)
    tgt, truth = build_bench_target(_F32, device=dev, nd=nd, grid_step=grid_step)
    tgt = dataclasses.replace(tgt, **DIALS)
    coords = init_walker_batch(tgt, truth, nwalk)
    check = coords[:NCHECK]
    real = ck.log_posterior_fused(check, tgt)
    same, rel = max_rel_on_support(posterior_transposed(check, tgt), real)
    nfin = int(torch.isfinite(real).sum())
    print(f"parity vs the production kernel (K1): max rel {rel:.2e} ({nfin}/{check.shape[0]} "
          f"finite, support {'identical' if same else 'DIFFERS'})", flush=True)
    if not same or rel >= RTOL:
        raise RuntimeError(f"posterior_transposed: support identical {same}, max rel {rel:.2e}")
    t_row = time_fn(lambda: ck.log_posterior_fused(coords, tgt))
    t_tra = time_fn(lambda: posterior_transposed(coords, tgt))
    print(f"row-major epilogue:   {t_row * 1e3:.4f} ms/call ({nwalk / t_row / 1e6:.2f}M evals/s)")
    print(f"transposed epilogue:  {t_tra * 1e3:.4f} ms/call ({nwalk / t_tra / 1e6:.2f}M evals/s)")
    print(f"delta: {(t_row - t_tra) * 1e3:+.4f} ms ({100 * (t_row - t_tra) / t_row:+.1f}%)",
          flush=True)
    return {"row_major": t_row, "transposed": t_tra, "rel": rel}


if __name__ == "__main__":
    main()
