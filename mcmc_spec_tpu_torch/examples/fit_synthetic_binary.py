"""End-to-end example: synthesise a binary observation and fit it (port of ``examples/fit_synthetic_binary.py``).

Self-contained (no external model grids or filter files needed): builds the
analytic model grid, synthesises a noisy composite observation at known truth
parameters, anneals (the spectrum-chi^2 kernel, K3, on the card), samples
with :class:`~mcmc_spec_tpu_torch.inference.sampler_api.EnsembleSampler`
(the fused-posterior kernel, K1, on the card) and renders a posterior
summary::

    python -m mcmc_spec_tpu_torch.examples.fit_synthetic_binary [outdir] [--noplots] [--device cpu]

It runs on the card unless ``--device cpu`` is given (float32 on the card,
float64 on the CPU, as the JAX example picks by backend).  ``--noplots``
skips the corner plot, which needs matplotlib.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from mcmc_spec_tpu_torch.bench_target import build_bench_target
from mcmc_spec_tpu_torch.inference.anneal import init_walkers, run_anneal
from mcmc_spec_tpu_torch.inference.batched import log_posterior_batch
from mcmc_spec_tpu_torch.inference.sampler_api import EnsembleSampler

NAMES = ["T1", "T2", "Av", "R1", "R2/R1", "plx"]


def main(outdir="example_out", noplots=False, device="cuda", n_anneal=150, anneal_steps=200,
         nwalkers=50, nsteps=3000, discard=200):
    """Fit the synthetic binary; returns the sampler."""
    dev = torch.device(device)
    os.makedirs(outdir, exist_ok=True)
    dtype = torch.float32 if dev.type == "cuda" else torch.float64
    print(f"building synthetic target (device={dev}, {dtype})...")
    tgt, truth = build_bench_target(dtype, device=dev, grid_step=4.0)

    print(f"stage 1: annealing {n_anneal} walkers...")
    p0 = init_walkers(tgt, n_anneal, truth[-1], 0.05e-3,
                      torch.Generator(device=dev).manual_seed(0))
    params, chi, _ = run_anneal(tgt, p0, torch.Generator(device=dev).manual_seed(1),
                                steps=anneal_steps)
    chi = chi.cpu().numpy()
    print(f"  best chi2: {chi.min():.2f}")

    print(f"stage 2: stretch-move MCMC, {nwalkers} walkers x {nsteps} steps...")
    seeds = params.cpu().numpy()[np.argsort(chi)[:nwalkers]]
    seeds = seeds * (1 + 1e-5 * np.random.RandomState(0).randn(*seeds.shape))
    sampler = EnsembleSampler(nwalkers, 6, lambda b: log_posterior_batch(b, tgt), seed=2,
                              device=dev, dtype=dtype)
    sampler.run_mcmc(seeds, nsteps, thin_by=3)
    samples = sampler.get_chain(flat=True, discard=discard)
    print(f"  acceptance: {sampler.acceptance_fraction[0]:.3f}")
    print(f"  autocorr times: {np.round(sampler.get_autocorr_time(), 1)}")

    print(f"{'param':7s} {'truth':>10s} {'median':>10s} {'68% interval':>24s}")
    for i, n in enumerate(NAMES):
        q16, q50, q84 = np.percentile(samples[:, i], [16, 50, 84])
        print(f"{n:7s} {truth[i]:10.4g} {q50:10.4g}      [{q16:9.4g},{q84:9.4g}]")

    if not noplots:
        from mcmc_spec_tpu_torch.report.corner_plot import corner_plot

        corner_plot(samples, labels=NAMES, title_fmts=[".0f", ".0f", ".3f", ".3f", ".3f", ".5f"],
                    truths=truth, out_path=os.path.join(outdir, "corner.pdf"))
        print(f"wrote {outdir}/corner.pdf")
    return sampler


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("outdir", nargs="?", default="example_out")
    ap.add_argument("--noplots", action="store_true")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.outdir, noplots=a.noplots, device=a.device)
