"""Stage-1 optimizer: random-restart annealing on chi^2 over all walkers at once.

Port of ``mcmc_spec_tpu.inference.anneal`` (the reference's per-walker
modified Gibbs sampler, ``fit_spec``):

* every walker perturbs all parameters with Gaussian steps, coarse for the
  first half of its schedule and fine afterwards;
* a proposal is accepted iff it is in bounds and its chi^2
  (``optimizer_chi2_batch``) improves; an accept in the first half restarts
  the step counter, one in the second half pins it just past the midpoint;
* a walker stops after ``steps`` consecutive non-improving in-bounds
  proposals or ``50*steps`` attempts; finished walkers idle under a mask.

The JAX version is one ``lax.scan`` of ``50*steps`` iterations; here it is a
Python loop, with the noise of each iteration drawn by ``_draw_noise``.
"""
from __future__ import annotations

import torch

from mcmc_spec_tpu_torch.inference.batched import optimizer_chi2_batch
from mcmc_spec_tpu_torch.inference.target import PackedTarget


def _draw_noise(gen, shape, dtype, device):
    """Standard-normal proposal noise for one annealing iteration."""
    return torch.randn(shape, generator=gen, dtype=dtype, device=device)


def _step_sigmas(tgt: PackedTarget, p0: torch.Tensor, fine: bool):
    """Per-walker step sizes: coarse [250 K, 0.05 mag, 10% R, 2% plx],
    fine [20 K, 0.01, 5%, 0.5%] (triple: 5% / 1% plx), as fractions of the
    walker's initial radii and parallax."""
    n = tgt.nspec
    nw = p0.shape[0]
    t_sig = torch.full((nw, n), 20.0 if fine else 250.0, dtype=p0.dtype, device=p0.device)
    av_sig = torch.full((nw, 1), 0.01 if fine else 0.05, dtype=p0.dtype, device=p0.device)
    rfrac = 0.05 if fine else 0.1
    if tgt.fit_plx:
        rad = p0[:, n + 1 : 2 * n + 1]
        plx = p0[:, 2 * n + 1 : 2 * n + 2]
        if n == 2:
            dfrac = 0.005 if fine else 0.02
        else:
            dfrac = 0.01 if fine else 0.05
        return torch.cat([t_sig, av_sig, rfrac * rad, dfrac * plx], dim=1)
    return torch.cat([t_sig, av_sig, rfrac * p0[:, n + 1 :]], dim=1)


def _in_bounds(tgt: PackedTarget, p: torch.Tensor):
    """The annealer's proposal gate: plx in (1/3000, 1/10), R1 in [0.05, 1.5],
    ratios in (0.05, 1), T strictly inside the grid, Av >= 0."""
    n = tgt.nspec
    teffs = p[:, :n]
    ok = (teffs > tgt.tmin).all(dim=1) & (teffs < tgt.tmax).all(dim=1) & (p[:, n] >= 0)
    if tgt.fit_plx:
        r1 = p[:, n + 1]
        ratios = p[:, n + 2 : 2 * n + 1]
        plx = p[:, 2 * n + 1]
        ok &= (r1 >= 0.05) & (r1 <= 1.5)
        ok &= ((ratios > 0.05) & (ratios < 1.0)).all(dim=1)
        ok &= (plx > 1.0 / 3000.0) & (plx < 0.1)
    else:
        ok &= (p[:, n + 1 :] >= 0.05).all(dim=1)
    return ok


def _fix_triple_ratio(tgt: PackedTarget, p: torch.Tensor):
    """r3 >= r2 or r3 < 0 -> r3 = 0.9*r2 (triples with parallax)."""
    if tgt.nspec != 3 or not tgt.fit_plx:
        return p
    r2, r3 = p[:, 5], p[:, 6]
    p = p.clone()
    p[:, 6] = torch.where((r3 >= r2) | (r3 < 0), 0.9 * r2, r3)
    return p


def run_anneal(tgt: PackedTarget, p0: torch.Tensor, generator: torch.Generator,
               steps: int = 200, record_thin: int = 0):
    """Anneal all walkers; returns (params [nw, ndim], chi [nw], trace or None).

    ``record_thin > 0`` also returns every ``record_thin``-th (params, chi)
    snapshot, stacked, for the optimizer-diagnostic plots.  As in JAX, the
    iterations then run in whole chunks of ``record_thin``: ``50*steps //
    record_thin`` chunks, and with none the start walkers and an empty trace.
    """
    p0 = torch.as_tensor(p0)
    nw, ndim = p0.shape
    max_iters = 50 * steps
    n_iters = max_iters // record_thin * record_thin if record_thin else max_iters
    sig_coarse = _step_sigmas(tgt, p0, fine=False)
    sig_fine = _step_sigmas(tgt, p0, fine=True)
    n = tgt.nspec
    rad_slice = slice(n + 1, 2 * n + 1) if tgt.fit_plx else slice(n + 1, None)

    # initial chi^2 uses the 5%-of-guess radius-prior sigma; in-loop
    # proposals use the current step sigmas
    params = p0
    chi = optimizer_chi2_batch(p0, tgt)
    cnt = torch.zeros(nw, dtype=torch.int32, device=p0.device)
    total_n = torch.zeros(nw, dtype=torch.int32, device=p0.device)
    trace_p, trace_c = [], []
    for it in range(n_iters):
        active = (cnt < steps) & (total_n < max_iters)
        fine = cnt > steps // 2
        sig = torch.where(fine[:, None], sig_fine, sig_coarse)
        noise = _draw_noise(generator, (nw, ndim), p0.dtype, p0.device)
        proposal = _fix_triple_ratio(tgt, params + noise * sig)
        ok = _in_bounds(tgt, proposal)
        chi_new = optimizer_chi2_batch(proposal, tgt, rad_sigma=sig[:, rad_slice])
        better = ok & (chi_new < chi) & active

        params = torch.where(better[:, None], proposal, params)
        chi = torch.where(better, chi_new, chi)
        n_after = torch.where(ok, cnt + 1, cnt)
        restart = torch.where(fine, torch.full_like(cnt, steps // 2 + 1), torch.zeros_like(cnt))
        n_after = torch.where(better, restart, n_after)
        cnt = torch.where(active, n_after, cnt)
        total_n = torch.where(active, total_n + 1, total_n)
        if record_thin and (it + 1) % record_thin == 0:
            trace_p.append(params)
            trace_c.append(chi)
    if not record_thin:
        return params, chi, None
    if not trace_p:
        return params, chi, (p0.new_empty((0, nw, ndim)), chi.new_empty((0, nw)))
    return params, chi, (torch.stack(trace_p), torch.stack(trace_c))


def init_walkers(tgt: PackedTarget, nwalk: int, plx: float, plx_err: float,
                 generator: torch.Generator):
    """Random walker initialisation (the reference's ``optimize_fit``).

    T1 ~ U(tmin, tmax); T2 ~ U(tmin, T1) (T3 ~ U(tmin, T2)); Av ~ U(0.1, 0.5);
    R1 ~ U(0.05, 1); ratio_k = U(0.05, prev)/prev; plx ~ |N(plx, plx_err)|.
    """
    n = tgt.nspec
    dtype, dev = tgt.D.dtype, tgt.device
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(nwalk, generator=generator, dtype=dtype,
                                                     device=dev)
    tmin, tmax = tgt.tmin.to(dtype), tgt.tmax.to(dtype)
    t1 = u(tmin, tmax)
    cols = [t1]
    if n >= 2:
        t2 = u(tmin, t1)
        cols.append(t2)
    if n == 3:
        cols.append(u(tmin, t2))
    cols.append(u(0.1, 0.5))
    if tgt.fit_plx:
        r1 = u(0.05, 1.0)
        cols.append(r1)
        if n >= 2:
            r2 = u(0.05, r1)
            cols.append(r2 / r1)
        if n == 3:
            rr2 = r2 / r1
            cols.append(u(0.05, rr2) / rr2)
        d = torch.abs(plx + plx_err * torch.randn(nwalk, generator=generator, dtype=dtype,
                                                   device=dev))
        cols.append(d)
    else:
        cols.extend(u(0.05, 1.0) for _ in range(n - 1))
    return torch.stack(cols, dim=1)
