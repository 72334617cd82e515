"""Which ops of the composed fleet route round a walker otherwise in another batch, on the card.

The fleet's composed route (K4, ``inference.fleet.log_posterior_fleet``)
forms each target's blend weights and the posterior's other terms with torch
ops on the walkers it is given.  On a fleet mesh a rank evaluates a share of
the one device's batch, so where an op's library kernel (cuBLAS, a reduction)
rounds a row otherwise at another row count, the sharded chain leaves the
one-device chain.  This script evaluates each op of the route on target 0 of
the fleet cell (nd = 1,792, padded as the fleet pads it) for the walkers of
the one device's batches (all 4,096 at the first evaluation, a half of 2,048
at a half-step) and for their 2 and 4 shares, and counts the rows that differ
from the whole batch's::

    python -m mcmc_spec_tpu_torch.scripts.batch_rows

Each op takes the whole batch's inputs, so a count is that op's own, not one
inherited from an op before it.  ``main(device="cpu")`` runs the same on the
CPU (its BLAS rounds by the shape too).
"""
from __future__ import annotations

import torch

from mcmc_spec_tpu_torch.scripts.timing import describe, resolve_device

NW = 4096  # the fleet cell's walkers a target
SHARES = (2, 4)


def composed_ops(p, tgt):
    """The composed route's ops on walkers ``p`` [m, ndim] of the target ``tgt``, each
    fed the whole batch's inputs (computed here from ``p``): {name: (fn, inputs)}."""
    from mcmc_spec_tpu_torch.inference import batched
    from mcmc_spec_tpu_torch.ops.interp import tent_weights

    n = tgt.nspec
    nT, nG, nd = tgt.D.shape
    NO = nT * nG
    teffs, _, r1, ratios, plx = batched._unpack_batch(p, tgt)
    scales = batched._scales_batch(tgt, r1, ratios, plx)
    loggs = batched.mist_logg_batch(tgt, teffs)
    Wt, Wg = tent_weights(tgt.temps, teffs), tent_weights(tgt.loggs, loggs)
    Wk = (Wt[..., :, None] * Wg[..., None, :]).reshape(p.shape[0], n, NO)
    Wcomb = torch.einsum("ws,wso->wo", scales, Wk)
    dist_pc = 1.0 / torch.clamp(plx, min=1e-12)
    logd = torch.log(torch.clamp(dist_pc, min=1e-3))
    w_av = tent_weights(tgt.av_logd_nodes, logd)
    Fc, Fp = tgt.Fc.reshape(NO, -1), tgt.Fp.reshape(NO, -1)
    zeros = torch.zeros(p.shape[0], dtype=p.dtype, device=p.device)
    return {
        "mist_logg_batch (tent weights @ log g nodes)":
            (lambda t: batched.mist_logg_batch(tgt, t), teffs),
        "mist_radius_batch (tent weights @ lum nodes)":
            (lambda t: batched.mist_radius_batch(tgt, t), teffs),
        "einsum ws,wso->wo (Wcomb)": (lambda s, w: torch.einsum("ws,wso->wo", s, w),
                                      (scales, Wk)),
        "einsum wso,oc->wsc (contrast fluxes)": (lambda w: torch.einsum("wso,oc->wsc", w, Fc),
                                                 Wk),
        "Wcomb @ Fp (band fluxes)": (lambda w: w @ Fp, Wcomb),
        "tent weights @ Av nodes (the Av prior)": (lambda w: w @ tgt.av_mu_nodes, w_av),
        "log_prior_batch": (lambda q: batched.log_prior_batch(q, tgt), p),
        "log_posterior_batch, chi_spec given": (
            lambda q, c: batched.log_posterior_batch(q, tgt, chi_spec=c), (p, zeros)),
    }


def differing_rows(fn, inputs, shares: int) -> int:
    """Rows of ``fn`` over ``shares`` contiguous shares of its inputs' rows that differ
    from ``fn`` over all of them (NaN where both are NaN counts as the same)."""
    inputs = inputs if isinstance(inputs, tuple) else (inputs,)
    m = inputs[0].shape[0] // shares
    whole = fn(*inputs)
    parts = torch.cat([fn(*(x[i * m:(i + 1) * m] for x in inputs)) for i in range(shares)])
    same = (parts == whole) | (torch.isnan(parts) & torch.isnan(whole))
    return int((~same).reshape(whole.shape[0], -1).any(dim=1).sum())


def batch_rows(tgt, P, shares=SHARES) -> dict:
    """{op: {(batch, shares): rows}} for the first evaluation's batch (all of ``P``) and a
    half-step's (its first half)."""
    out = {}
    for batch in (P.shape[0], P.shape[0] // 2):
        for name, (fn, inputs) in composed_ops(P[:batch], tgt).items():
            for s in shares:
                out.setdefault(name, {})[(batch, s)] = differing_rows(fn, inputs, s)
    return out


def fleet_target(device, dtype=torch.float32):
    """Target 0 of the fleet cell, padded as the fleet pads it, and its walkers."""
    from mcmc_spec_tpu_torch.bench_target import build_bench_target, init_walker_batch

    tgt, truth = build_bench_target(dtype, device=device, pad_nd=1792, pad_nc=2, seed=0,
                                    n_contrast=2)
    return tgt, init_walker_batch(tgt, truth, NW, dtype, seed=1)


def main(device="cuda", nw: int = NW) -> dict:
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    tgt, P = fleet_target(dev)
    rows = batch_rows(tgt, P[:nw])
    print(f"[batch_rows] {describe(dev)}: target 0 of the fleet cell, rows that differ from "
          f"the whole batch's in 2 and 4 shares, batches of {nw} and {nw // 2} walkers")
    for name, counts in rows.items():
        print(f"  {name}: " + ", ".join(f"{b} in {s}: {r}" for (b, s), r in counts.items()))
    return rows


if __name__ == "__main__":
    main()
