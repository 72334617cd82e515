"""The fast median's posterior perturbation, measured through K1 on the card
(counterpart of ``scripts/median_tempering_bound.py``).

A relative median error ``eps`` rescales the spectrum chi^2 by ``(1 + eps)^-2``
on the renorm path: a tempering of the spectrum term, so the log-posterior
moves by ``dL ~ w * chi_spec * eps``, and first-order perturbation theory
bounds any posterior-mean shift by ``sigma_g * std(dL)``: the shift in sigma
is at most ``std(dL)``.

The script equilibrates 4,096 walkers on the bench target for 4,000 steps at
the exact dials (31, 6, 0), then scores those coordinates with K1 at each pass
count k, the other dials exact so that the median is the only dial that moves,
and reports dL = L_k - L_31 over the walkers.  Then the stage-2 evaluations
per second at each pass count at the production dials (k, 3, 2): 512 warm-up
and 512 timed steps of the stretch sampler on K1.

    python -m mcmc_spec_tpu_torch.scripts.median_tempering_bound

``main(device="cpu", ...)`` runs the plain versions at the sizes given, with
host-clock rates.
"""
from __future__ import annotations

import dataclasses
import json
import time

import numpy as np
import torch

from mcmc_spec_tpu_torch.bench_target import build_bench_target
from mcmc_spec_tpu_torch.inference.batched import log_posterior_batch
from mcmc_spec_tpu_torch.inference.stretch import init_ensemble, run_ensemble
from mcmc_spec_tpu_torch.ops import cuda_kernels as ck
from mcmc_spec_tpu_torch.scripts.median_tempering_bound_cpu import equilibrate
from mcmc_spec_tpu_torch.scripts.timing import describe, resolve_device

NWALK = 4096
NBURN = 4000
PASSES = (20, 16, 14, 12, 10)
RATE_PASSES = (31, 20, 16, 14, 12)
RATE_STEPS = 512
EXACT = dict(median_iters=31, matmul_passes=6, recip_newton=0)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def logp_at(tgt, coords, **dials):
    """[nw] float64 log-posterior of ``coords`` on ``tgt`` at the given dials."""
    t = dataclasses.replace(tgt, **dials)
    return log_posterior_batch(coords, t).double().cpu().numpy()


def dl_per_pass(tgt, eq, passes=PASSES):
    """Per pass count k, dL = L_k - L_31 over the walkers ``eq`` finite at 31 passes, the
    median dial isolated (matmul 6, recip 0); returns (table, L_31, {k: L_k})."""
    L31 = logp_at(tgt, eq, **EXACT)
    fin = np.isfinite(L31)
    out, Ls = {}, {}
    for k in passes:
        Ls[k] = logp_at(tgt, eq, median_iters=k, matmul_passes=6, recip_newton=0)
        dL = Ls[k][fin] - L31[fin]
        out[k] = dict(eps_bound=float(np.log(2) * 2.0 ** (7 - k)),
                      dL_max=float(np.max(np.abs(dL))), dL_std=float(np.std(dL)),
                      dL_mean=float(np.mean(dL)))
    return out, L31, Ls


def rates_per_pass(tgt, eq, dev, passes=RATE_PASSES, steps=RATE_STEPS):
    """Stage-2 evaluations per second at each pass count at the production dials (k, 3,
    2): ``steps`` warm-up and ``steps`` timed stretch steps from ``eq``."""
    rates = {}
    nw = eq.shape[0]
    for k in passes:
        t = dataclasses.replace(tgt, median_iters=k, matmul_passes=3, recip_newton=2)
        logp = lambda b: log_posterior_batch(b, t)
        st = init_ensemble(eq, logp, torch.Generator(device=dev).manual_seed(11))
        st, _, _ = run_ensemble(st, logp, n_steps=steps, thin=steps)
        _sync(dev)
        t0 = time.perf_counter()
        st, _, _ = run_ensemble(st, logp, n_steps=steps, thin=steps)
        _sync(dev)
        rates[k] = nw * steps / (time.perf_counter() - t0) / 1e6
        print(f"  iters={k}: {rates[k]:.2f}M evals/s", flush=True)
    return rates


def main(device="cuda", nwalk=NWALK, nburn=NBURN, nd=1792, grid_step=1.0,
         rate_steps=RATE_STEPS):
    dev = resolve_device(device)
    print(f"[env] {describe(dev)}", flush=True)
    t_start = time.perf_counter()
    tgt, truth = build_bench_target(torch.float32, device=dev, nd=nd, grid_step=grid_step)
    ck.reset_launches()
    # equilibrate at the exact dials
    eq = equilibrate(dataclasses.replace(tgt, **EXACT), truth, nwalk, nburn)
    out, L31, _ = dl_per_pass(tgt, eq)
    print(f"equilibrated: {int(np.isfinite(L31).sum())}/{nwalk} finite logp", flush=True)
    for k, r in out.items():
        print(f"iters={k}: |dL|max={r['dL_max']:.4g} std={r['dL_std']:.4g} "
              f"mean={r['dL_mean']:+.4g} (shift bound = std = {r['dL_std']:.4g} sigma)",
              flush=True)
    print("\nthroughput (production mm=3/recip=2):", flush=True)
    rates = rates_per_pass(tgt, eq, dev, steps=rate_steps)
    launches = {k: v for k, v in ck.LAUNCHES.items() if v}
    wall = time.perf_counter() - t_start
    print(f"[launches] {launches}; wall {wall:.1f} s", flush=True)
    print("\n" + json.dumps(dict(dL=out, rate_Mevals=rates)))
    return dict(dL=out, rate_Mevals=rates, launches=launches, wall_s=wall)


if __name__ == "__main__":
    main()
