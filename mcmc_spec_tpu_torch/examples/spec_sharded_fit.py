"""Spectral-axis sharding: fit a target whose data axis shards over ranks (port of ``examples/spec_sharded_fit.py``).

Demonstrates ``mcmc_spec_tpu_torch.parallel.spec_shard``: the packed
target's data-wavelength axis shards over the ``spec`` axis of a ``W x S``
mesh of ranks (the grid projection ``D [nT, nG, nd]`` dominates device
memory), the walkers over its ``walkers`` axis, and the log-posterior stays
exact: each rank builds its slice of the model (K6), the median's counts are
summed over the spec group after every round (K7d), and the renorm partials
(K8) and chi^2 sums (K9) are all-reduced.  On a CUDA float32 target those are
the card's kernels::

    python -m mcmc_spec_tpu_torch.examples.spec_sharded_fit [W] [S] [--real]
        [--device cpu] [--anneal-steps N] [--steps N]

By default the example spawns a gloo process group of ``W * S`` ranks that
all compute on one device (``testing.run_world``), as the JAX example's
default is a virtual CPU mesh, so it runs on a machine with one card.  With
``--real`` it is one rank of a ``torchrun --nproc-per-node W*S`` launch with
NCCL, one card a rank.  ``--anneal-steps`` (100) and ``--steps`` (500) are
the JAX example's depths.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.distributed as dist


def run(rank, W, S, device="cuda", anneal_steps=100, n_steps=500, nwalk=64):
    """The example on this rank of a ``W x S`` mesh over the initialised process group;
    returns the max |sharded - single-device| log-posterior, the posterior medians, the
    acceptance, the best chi^2 and this rank's kernel launches, and prints on rank 0."""
    from mcmc_spec_tpu_torch.bench_target import build_bench_target
    from mcmc_spec_tpu_torch.inference.anneal import init_walkers
    from mcmc_spec_tpu_torch.inference.batched import log_posterior_batch
    from mcmc_spec_tpu_torch.ops import cuda_kernels
    from mcmc_spec_tpu_torch.parallel import sharding
    from mcmc_spec_tpu_torch.parallel.mesh import make_mesh
    from mcmc_spec_tpu_torch.parallel.spec_shard import (
        pad_packed_target_nd,
        run_anneal_spec_sharded,
        run_ensemble_spec_sharded,
        shard_spec_ensemble_state,
        shard_target_over_spec,
    )

    say = print if rank == 0 else (lambda *a, **k: None)
    mesh = make_mesh(W, S, device=device)
    dev = mesh.device
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    say(f"mesh: {mesh.shape} on {dev} ({dist.get_backend()})")

    dtype = torch.float32
    # packed on the host: each rank moves only its slice of the data axis to its device
    tgt, truth = build_bench_target(dtype, device="cpu", nd=1792, grid_step=2.0)
    tgt_sp = shard_target_over_spec(
        pad_packed_target_nd(tgt, -(-tgt.n_data // S) * S), mesh)
    say(f"grid projection D{tuple(tgt.D.shape)}: each rank holds "
        f"{tgt_sp.D.shape[2]}/{tgt_sp.n_data * S} wavelength columns")

    say(f"stage 1: spectral-sharded annealing, {nwalk} walkers...")
    p0 = init_walkers(tgt_sp, nwalk, truth[-1], 0.05e-3,
                      torch.Generator(device=dev).manual_seed(0))
    params, chi, _ = run_anneal_spec_sharded(
        tgt_sp, p0, torch.Generator(device=dev).manual_seed(1), mesh, steps=anneal_steps)
    chi = chi.cpu().numpy()
    say(f"  best chi2: {chi.min():.2f}")

    say(f"stage 2: spectral-sharded stretch MCMC, {nwalk} walkers x {n_steps} steps...")
    seeds = params.cpu().numpy()[np.argsort(chi)[:nwalk]]
    seeds = seeds * (1 + 1e-5 * np.random.RandomState(0).randn(*seeds.shape))
    state = shard_spec_ensemble_state(torch.as_tensor(seeds, dtype=dtype, device=dev), tgt_sp,
                                      torch.Generator(device=dev).manual_seed(2), mesh)
    state, chain, _ = run_ensemble_spec_sharded(state, tgt_sp, mesh, n_steps=n_steps,
                                                thin=10)
    chain = sharding.gather_walkers(chain, mesh, dim=2).cpu().numpy().reshape(-1, 6)
    acc = float(state.n_accept) / (n_steps * nwalk)
    say(f"  kept {chain.shape[0]} samples; acceptance {acc:.2f}")

    launches = dict(cuda_kernels.LAUNCHES)
    # exactness spot-check against the single-device evaluation of the whole target
    flat = sharding.gather_walkers(state.coords, mesh).reshape(-1, 6)
    single = log_posterior_batch(flat, _on_device(tgt, dev)).cpu().numpy()
    sharded = sharding.gather_walkers(state.log_prob, mesh).reshape(-1).cpu().numpy()
    err = float(np.abs(sharded - single).max())
    say(f"  max |sharded - single-device| log-posterior: {err:.2e}")
    med = np.median(chain, axis=0)
    say(f"  posterior medians: {np.round(med, 4)}")
    say(f"  truth:             {np.round(truth, 4)}")
    return {"max_logp_err": err, "medians": med, "acceptance": acc, "chi2": float(chi.min()),
            "launches": launches}


def _on_device(tgt, dev):
    """The whole target on ``dev`` (the single-device evaluation's)."""
    import dataclasses

    from mcmc_spec_tpu_torch.inference.target import DATA_FIELDS

    return dataclasses.replace(tgt, **{k: getattr(tgt, k).to(dev) for k in DATA_FIELDS})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("W", nargs="?", type=int, default=2)
    ap.add_argument("S", nargs="?", type=int, default=4)
    ap.add_argument("--real", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--anneal-steps", type=int, default=100)
    ap.add_argument("--steps", type=int, default=500)
    a = ap.parse_args(argv)
    cuda = torch.device(a.device).type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available; pass --device cpu to run on the CPU")
    args = (a.W, a.S, a.device, a.anneal_steps, a.steps)
    if a.real:
        # one rank of torchrun: NCCL with one card a rank (gloo on the CPU)
        dist.init_process_group("nccl" if cuda else "gloo")
        try:
            return run(dist.get_rank(), *args)
        finally:
            dist.destroy_process_group()
    from mcmc_spec_tpu_torch.testing import run_world

    device = "cuda:0" if cuda else "cpu"  # every rank on the one device
    return run_world(run, a.W * a.S, a.W, a.S, device, a.anneal_steps, a.steps)[0]


if __name__ == "__main__":
    main()
