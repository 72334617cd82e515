"""The fused posterior K1 at each block size and against nd (counterpart of
``scripts/try_block_size.py``).

JAX swept the Pallas ``eval_block`` (128, 256, 512 walkers).  A block of K1 holds
one walker a warp, so the port sweeps the walkers a block from 1 to
``WALKERS_MAX_STAGED`` (each that its shared memory admits with its tile buffers,
``staged_block``, which also sizes the buffers; the production choice is
``staged_block``'s own), at the production dials:

[A] the stage-2 sampler's rate at each block size: 32,768 walkers on the bench
    target, ``run_ensemble`` of 512 steps once to warm up, then the best of three
    timed runs (the card synchronised), K1 called with the block size; and K1 alone
    on half of them (a half-step's batch) with ``device_loop_time``;
[B] the direct call against nd (896, 1,792, 3,584) at the production block,
    timed with ``utils.profiling.device_loop_time`` (no dispatch), with what a
    time proportional to nd would give.

    python -m mcmc_spec_tpu_torch.scripts.try_block_size
"""
from __future__ import annotations

import time

import torch

from mcmc_spec_tpu_torch.inference.stretch import init_ensemble, run_ensemble
from mcmc_spec_tpu_torch.ops import cuda_kernels as ck
from mcmc_spec_tpu_torch.scripts import ablate_matrix as am
from mcmc_spec_tpu_torch.scripts.timing import describe, resolve_device
from mcmc_spec_tpu_torch.utils.profiling import device_loop_time

NWALK = 32768
NSTEPS = 512
NDS = (896, 1792, 3584)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def sampler_rate(tgt, coords, wpb, n_steps=NSTEPS):
    """Best evaluations per second of three ``run_ensemble`` runs of ``n_steps``."""
    dev = coords.device
    logp = lambda batch: ck.log_posterior_fused(batch, tgt, walkers_per_block=wpb)
    st = init_ensemble(coords, logp, torch.Generator(device=dev).manual_seed(0))
    st = run_ensemble(st, logp, n_steps=n_steps, thin=n_steps)[0]
    best = 0.0
    for _ in range(3):
        _sync(dev)
        t0 = time.perf_counter()
        st = run_ensemble(st, logp, n_steps=n_steps, thin=n_steps)[0]
        _sync(dev)
        best = max(best, n_steps * coords.shape[0] / (time.perf_counter() - t0))
    return best


def fitting_blocks(nd: int, NO: int, weight_rows: int) -> list:
    """The walkers-per-block counts of K1 whose shared memory a block admits."""
    return [w for w in range(1, ck.WALKERS_MAX_STAGED + 1)
            if ck.stage_floats(nd, NO, weight_rows, w)[0] > 0]


def main(device="cuda", nwalk=NWALK, nds=NDS, grid_step=1.0, n_steps=NSTEPS):
    dev = resolve_device(device)
    print(f"[env] {describe(dev)}", flush=True)
    tgt, coords = am.prepare(dev, nwalk, 1792 if 1792 in nds else nds[0], grid_step)
    nT, nG, nd = tgt.D.shape
    default = ck.staged_block(nd, nT * nG, 1 + tgt.nspec)[0]
    print(f"[A] sampler rate against walkers a block, {nwalk} walkers, nd={nd} (production "
          f"dials; the production block holds {default}):", flush=True)
    rates, alone = {}, {}
    half = coords[: max(coords.shape[0] // 2, 1)]
    for w in fitting_blocks(nd, nT * nG, 1 + tgt.nspec):
        rates[w] = sampler_rate(tgt, coords, w, n_steps)
        alone[w] = device_loop_time(
            lambda q, w=w: ck.log_posterior_fused(q, tgt, walkers_per_block=w), half) * 1e3
        per_sm, stage = ck.stage_floats(nd, nT * nG, 1 + tgt.nspec, w)
        print(f"    walkers_per_block={w} ({per_sm} blocks an SM, tiles of {stage} floats): "
              f"{rates[w] / 1e6:.2f}M evals/s; K1 alone on {half.shape[0]} walkers "
              f"{alone[w]:.4f} ms", flush=True)
    print("[B] direct call against nd (production block, device_loop_time):", flush=True)
    calls = {}
    for n in nds:
        t, c = am.prepare(dev, nwalk, n, grid_step)
        calls[n] = device_loop_time(lambda q, t=t: ck.log_posterior_fused(q, t), c) * 1e3
        print(f"    nd={n}: {calls[n]:.4f} ms/call ({nwalk / calls[n] * 1e-3:.1f}M evals/s)",
              flush=True)
    if nd in calls:
        print(f"    (time proportional to nd from {nd} would give "
              + ", ".join(f"{calls[nd] * n / nd:.4f} ms at {n}" for n in nds if n != nd) + ")",
              flush=True)
    return {"rates": rates, "alone": alone, "default": default, "calls": calls}


if __name__ == "__main__":
    main()
