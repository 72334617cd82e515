"""On-card validation of the production path (counterpart of ``scripts/tpu_validation.py``).

(a) ``kernel_shape_sweep``: the four one-warp-per-walker kernels at the
exact dials on shapes that stress their launch arithmetic, each against the
torch composition of the same function (the JAX kernel gate: identical
finiteness, rtol 5e-5, atol 1e-4 max|ref|):

* K3 ``spectrum_chi2`` and K1 ``log_posterior_fused`` on the bench target at
  600 (not a multiple of a block's walkers), 520 and 256 walkers, for nd =
  1,792 and 3,584 (rows that leave room for fewer walkers a block);
* K4 ``spectrum_chi2_fleet`` and K5 ``log_posterior_fleet_fused`` on a fleet
  of two targets, one padded (nd 1,700 to 1,792, one contrast to two), at 12
  and 520 walkers a target.

(b) The truth-recovery fit on the bench target: ``init_walkers`` with 150
walkers and ``run_anneal(steps=400)`` (K3), the best 50 seed 4,000 stretch
steps at thin 4 (K1), the first 250 kept samples dropped;
``check_ensemble_health``, and every truth inside the central 95 % interval.

    python -m mcmc_spec_tpu_torch.scripts.card_validation [--shapes-only]

``--shapes-only`` runs (a) alone; it stands in for the JAX package's on-chip
shape sweep.  The exit code is 1 on any mismatch or truth outside.
``main(device="cpu")`` runs the kernels' plain versions.
"""
from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from mcmc_spec_tpu_torch.bench_target import TRUTH, build_bench_target
from mcmc_spec_tpu_torch.inference import batched
from mcmc_spec_tpu_torch.inference.anneal import init_walkers, run_anneal
from mcmc_spec_tpu_torch.inference.fleet import stack_targets
from mcmc_spec_tpu_torch.inference.stretch import (acceptance_fraction, init_ensemble,
                                                   run_ensemble)
from mcmc_spec_tpu_torch.inference.target import target_views
from mcmc_spec_tpu_torch.ops import cuda_kernels as ck
from mcmc_spec_tpu_torch.scripts.timing import describe, resolve_device
from mcmc_spec_tpu_torch.utils.health import check_ensemble_health

EXACT = dict(median_iters=31, matmul_passes=6, recip_newton=0)
SINGLE_ND = (1792, 3584)
SINGLE_NW = (600, 520, 256)
FLEET_ND = (1700, 1792)  # the first target padded to the second's nd
FLEET_NW = (12, 520)
NAMES = ["T1", "T2", "Av", "R1", "R2/R1", "plx"]
RTOL = 5e-5


def shapes():
    """The sweep's (kernel, nd, walkers) cases, in the order they run."""
    single = [(k, nd, nw) for nd in SINGLE_ND for nw in SINGLE_NW
              for k in ("spectrum_chi2", "log_posterior_fused")]
    fleet = [(k, FLEET_ND[1], nw) for nw in FLEET_NW
             for k in ("spectrum_chi2_fleet", "log_posterior_fleet_fused")]
    return single + fleet


def walker_cloud(truth, nw, seed=11, device="cpu"):
    """[nw, ndim] float32 walkers 2 % around ``truth`` from ``RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    cloud = np.asarray(truth)[None, :] * (1 + 0.02 * rng.randn(nw, len(truth)))
    return torch.as_tensor(cloud, dtype=torch.float32, device=device)


def gate(got, ref, rtol=RTOL):
    """The JAX kernel gate: identical finiteness, some finite value, and |got - ref| <=
    1e-4 max|ref| + rtol |ref| on the finite values."""
    got, ref = got.double().cpu().numpy().ravel(), ref.double().cpu().numpy().ravel()
    fin = np.isfinite(ref)
    return bool(np.array_equal(np.isfinite(got), fin) and fin.any()
                and np.allclose(got[fin], ref[fin], rtol=rtol,
                                atol=1e-4 * np.abs(ref[fin]).max()))


def kernel_shape_sweep(device="cuda"):
    """Run (a) on ``device``; returns the labels of the cases that failed the gate."""
    dev = torch.device(device)
    failures = []

    def check(label, got, ref):
        ok = gate(got, ref)
        print(f"  {label}: {'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            failures.append(label)

    for nd in SINGLE_ND:
        tgt, truth = build_bench_target(torch.float32, device=dev, nd=nd)
        exact = dataclasses.replace(tgt, **EXACT)
        composed = dataclasses.replace(exact, spectrum_backend="xla")
        it, mm, rn = ck.resolve_dials(exact)
        nT, nG, _ = exact.D.shape
        for nw in SINGLE_NW:
            P = walker_cloud(truth, nw, device=dev)
            av = P[:, exact.nspec].contiguous()
            *_, Wcomb = batched._forward_small(P, exact)
            got = ck.spectrum_chi2(Wcomb, av, exact.D.reshape(nT * nG, nd), exact.ext_k_data,
                                   exact.data_flux, exact.data_err, exact.V, exact.Vpinv,
                                   exact.med_data, iters=it, mm_passes=mm, recip=rn)
            check(f"spectrum_chi2 nd={nd} nw={nw}", got, batched._spec_chi2_xla(Wcomb, av, exact))
            check(f"log_posterior_fused nd={nd} nw={nw}", ck.log_posterior_fused(P, exact),
                  batched.log_posterior_batch(P, composed))

    # the fleet: one target padded from nd 1,700 and one contrast to (1,792, 2)
    singles = [build_bench_target(torch.float32, device=dev, nd=FLEET_ND[0], seed=1,
                                  pad_nd=FLEET_ND[1], pad_nc=2, n_contrast=1)[0],
               build_bench_target(torch.float32, device=dev, nd=FLEET_ND[1], seed=2)[0]]
    fleet = stack_targets([dataclasses.replace(s, **EXACT) for s in singles])
    views = target_views(fleet)
    for nw in FLEET_NW:
        P = torch.stack([walker_cloud(TRUTH, nw, seed=s, device=dev) for s in (3, 4)])
        av = P[..., fleet.nspec].contiguous()
        Wcomb = torch.stack([batched._forward_small(p, v)[4] for p, v in zip(P, views)])
        ref = torch.stack([batched._spec_chi2_xla(w, a, v) for w, a, v in zip(Wcomb, av, views)])
        check(f"spectrum_chi2_fleet nw={nw}", ck.spectrum_chi2_fleet(Wcomb, av, fleet), ref)
        ref = torch.stack([batched.log_posterior_batch(
            p, dataclasses.replace(v, spectrum_backend="xla")) for p, v in zip(P, views)])
        check(f"log_posterior_fleet_fused nw={nw}", ck.log_posterior_fleet_fused(P, fleet), ref)

    print(f"SHAPE SWEEP FAILED: {failures}" if failures else "SHAPE SWEEP PASSED", flush=True)
    return failures


def recovery_fit(device="cuda", nwalk=150, anneal_steps=400, nseed=50, n_steps=4000, thin=4,
                 drop=250):
    """(b) on ``device``; returns whether every truth lies inside the central 95 %."""
    dev = torch.device(device)
    tgt, truth = build_bench_target(torch.float32, device=dev)
    t0 = time.perf_counter()
    p0 = init_walkers(tgt, nwalk, float(truth[-1]), 0.05e-3,
                      torch.Generator(device=dev).manual_seed(0))
    params, chi, _ = run_anneal(tgt, p0, torch.Generator(device=dev).manual_seed(1),
                                steps=anneal_steps)
    chi = chi.cpu().numpy()
    print(f"anneal: {time.perf_counter() - t0:.1f}s best chi2 {chi.min():.2f}", flush=True)

    seeds = params.cpu().numpy()[np.argsort(chi)[:nseed]]
    seeds = seeds * (1 + 1e-5 * np.random.RandomState(0).randn(*seeds.shape))
    logp = lambda b: batched.log_posterior_batch(b, tgt)
    state = init_ensemble(torch.as_tensor(seeds, dtype=torch.float32, device=dev), logp,
                          torch.Generator(device=dev).manual_seed(2))
    t0 = time.perf_counter()
    state, chain, logps = run_ensemble(state, logp, n_steps=n_steps, thin=thin)
    chain = chain.cpu().numpy()
    acc = float(acceptance_fraction(state, n_steps))
    print(f"mcmc: {time.perf_counter() - t0:.1f}s accept={acc:.3f}", flush=True)

    samples = chain[drop:].reshape(-1, len(truth))
    health = check_ensemble_health(chain, logps.cpu().numpy(), acc)
    print("health:", "OK" if health["ok"] else health["warnings"], flush=True)
    ok = True
    for i, name in enumerate(NAMES):
        q2, q16, q50, q84, q98 = np.percentile(samples[:, i], [2.5, 16, 50, 84, 97.5])
        inside = bool(q2 <= truth[i] <= q98)
        ok &= inside
        print(f"{name:6s} truth={truth[i]:.5g} median={q50:.5g} "
              f"68%=[{q16:.5g},{q84:.5g}] in95%={inside}")
    return ok


def main(argv=None, device="cuda"):
    argv = sys.argv[1:] if argv is None else argv
    dev = resolve_device(device)
    print(f"[env] {describe(dev)}", flush=True)
    ck.reset_launches()
    print("--- kernel shape sweep (the one-warp-per-walker kernels at stressing shapes) ---")
    shapes_ok = not kernel_shape_sweep(dev)
    ok = shapes_ok
    if "--shapes-only" not in argv:
        ok = recovery_fit(dev) and shapes_ok
    print(f"[launches] {({k: v for k, v in ck.LAUNCHES.items() if v})}")
    print("VALIDATION", "PASSED" if ok else "FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
