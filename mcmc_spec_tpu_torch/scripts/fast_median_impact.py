"""The fast median's end-to-end posterior impact, on the card (counterpart of
``scripts/fast_median_impact.py``).

The median's pass count (``MCMC_SPEC_FAST_MEDIAN``, ``PackedTarget.median_iters``)
trades the accuracy of the spectrum's scale for evaluation time.  What matters
is the posterior: chains of 2,048 walkers on the bench target, 3,000 burn-in
and 6,000 steps kept at thin 8, at 31, 14 and 12 passes (the other dials as
packed: 3 and 2 in production), each from the same walkers and the same
generator, on K1.  It prints each marginal's median shift in units of the
exact chain's sigma and the ratio of the sigmas.

    python -m mcmc_spec_tpu_torch.scripts.fast_median_impact

``main(device="cpu", ...)`` runs the plain versions at the sizes given (on the
CPU ``log_posterior_batch`` takes the composition, whose median is exact).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from mcmc_spec_tpu_torch.bench_target import build_bench_target, init_walker_batch
from mcmc_spec_tpu_torch.inference.batched import log_posterior_batch
from mcmc_spec_tpu_torch.inference.stretch import init_ensemble, run_ensemble
from mcmc_spec_tpu_torch.ops import cuda_kernels as ck
from mcmc_spec_tpu_torch.scripts.timing import describe, resolve_device

NWALK = 2048
NBURN = 3000
NSTEPS = 6000
THIN = 8
PASSES = (31, 14, 12)
LABELS = ["T1", "T2", "Av", "R1", "R2/R1", "plx"]


def run_chain(tgt, truth, nwalk=NWALK, nburn=NBURN, nsteps=NSTEPS, label=""):
    """[nsteps // THIN * nwalk, ndim] samples of a chain on ``tgt`` after ``nburn`` steps,
    from ``init_walker_batch`` and a generator seeded 7."""
    logp = lambda b: log_posterior_batch(b, tgt)
    dev = tgt.device
    coords = init_walker_batch(tgt, truth, nwalk, torch.float32)
    state = init_ensemble(coords, logp, torch.Generator(device=dev).manual_seed(7))
    t0 = time.perf_counter()
    state, _, _ = run_ensemble(state, logp, n_steps=nburn, thin=nburn)
    _, chain, _ = run_ensemble(state, logp, n_steps=nsteps, thin=THIN)
    chain = chain.cpu().numpy().reshape(-1, len(truth))
    print(f"  {label}: {nwalk * (nburn + nsteps) / (time.perf_counter() - t0) / 1e6:.2f}M "
          "evals/s", flush=True)
    return chain


def shifts(chain, base):
    """(median shift in units of ``base``'s sigma, sigma ratio) per parameter."""
    med0, sig0 = np.median(base, axis=0), base.std(axis=0)
    return (np.median(chain, axis=0) - med0) / sig0, chain.std(axis=0) / sig0


def print_shifts(title, chain, base):
    shift, sratio = shifts(chain, base)
    print(f"\n{title}:")
    for i, lab in enumerate(LABELS[:len(shift)]):
        print(f"  {lab:>6}: median shift {shift[i]:+.3f} sigma, sigma ratio {sratio[i]:.3f}")
    print(f"  max |shift| = {np.max(np.abs(shift)):.3f} sigma", flush=True)
    return shift, sratio


def main(device="cuda", nwalk=NWALK, nburn=NBURN, nsteps=NSTEPS, nd=1792, grid_step=1.0):
    dev = resolve_device(device)
    print(f"[env] {describe(dev)}", flush=True)
    t_start = time.perf_counter()
    tgt, truth = build_bench_target(torch.float32, device=dev, nd=nd, grid_step=grid_step)
    ck.reset_launches()
    chains = {it: run_chain(dataclasses.replace(tgt, median_iters=it), truth, nwalk, nburn,
                            nsteps, label=f"iters={it}")
              for it in PASSES}
    base = chains[31]
    print(f"\ntruth:          {np.array2string(np.asarray(truth), precision=4)}")
    print(f"exact medians:  {np.array2string(np.median(base, axis=0), precision=4)}")
    print(f"exact sigmas:   {np.array2string(base.std(axis=0), precision=4)}")
    out = {it: print_shifts(f"iters={it}", chains[it], base) for it in PASSES[1:]}
    launches = {k: v for k, v in ck.LAUNCHES.items() if v}
    wall = time.perf_counter() - t_start
    print(f"[launches] {launches}; wall {wall:.1f} s", flush=True)
    return dict(shifts=out, launches=launches, wall_s=wall)


if __name__ == "__main__":
    main()
