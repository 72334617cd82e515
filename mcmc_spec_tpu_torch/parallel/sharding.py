"""Walker-sharded ensemble sampling (counterpart of ``mcmc_spec_tpu/parallel/sharding.py``).

Layout: as in JAX, the ensemble is ``[2, nh, ndim]`` (red/black halves) and
each half is split over the mesh's W walker shards, so a rank holds its
``[2, nh/W, ndim]`` share: walkers ``h nh + w nh/W ... h nh + (w+1) nh/W - 1``
of the flat ensemble for half ``h``.  A half-update needs the whole
complement half, since each walker draws a random partner from it: one
``all_gather`` of its ``[nh/W, ndim]`` shares over the walker group a
half-step, after which everything is local.  The accept count is summed over
the walker group once a call.

The random draws: every rank holds the same ``torch.Generator``, seeded the
same, draws each chunk's ``(z, partner_idx, log_u)`` for the whole ensemble
(``inference.stretch._draw_chunk``) and takes its walkers' share.  So the
sharded chain is ``run_ensemble``'s from the same generator, on any mesh: a
checkpoint written on one device resumes on any mesh and the other way
round.  (JAX folds the shard index into its key instead, so its sharded
stream differs from its single-device one.)  The spec ranks of one walker
shard draw the same proposals.

A spectral-sharded chain (``parallel.spec_shard.run_ensemble_spec_sharded``)
runs this loop with its per-rank log-posterior as ``log_prob_fn``: without
``shard_map`` there is no sharded input to thread through, which is what
JAX's ``extra`` / ``logp_factory`` hook does.

The fleet over a ``targets x walkers`` mesh (``parallel.mesh.FleetMesh``,
``run_fleet_ensemble_sharded``): a rank holds ``[2, ntgt/T, nh/W, ndim]``, its
block of targets and, in each half, its walkers' share as above.  It evaluates
its block on its own slice of the padded stacked fleet (``fleet_block``: the
fleet's padded widths, so the fleet kernels K4/K5 see the one-device run's
``nd``, ranks and ``1/n_true``).  Each chunk's draws are made at the full
``[thin, 2, ntgt, nh]`` size from the same generator on every rank, in the
one-device order (``inference.fleet._draw_fleet_chunk``), and sliced, so the
sharded fleet chain is ``run_fleet_ensemble``'s on any mesh.  The collectives:
one ``all_gather`` of the complement half over the walker group a half-step,
and one ``all_reduce`` of the accept count over the whole mesh a call, as JAX's
global ``jnp.sum(accept)``.  ``gather_fleet`` brings a sharded array to every
rank in two more: over the walker group, then over the target group.
"""
from __future__ import annotations

from typing import Callable

import torch

import dataclasses

from mcmc_spec_tpu_torch.inference.stretch import EnsembleState, _draw_chunk, _propose_accept
from mcmc_spec_tpu_torch.parallel.mesh import FleetMesh, Mesh, all_gather, all_reduce


def walker_share(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's ``[2, nh/W, ...]`` share of a flat ``[nw, ...]`` ensemble (a view)."""
    nw, W = x.shape[0], mesh.walkers
    if nw % (2 * W):
        raise ValueError(f"nw={nw} must divide by 2*{W}")
    return x.reshape(2, W, nw // (2 * W), *x.shape[1:])[:, mesh.w_index]


def gather_walkers(x: torch.Tensor, mesh: Mesh, dim: int = 1) -> torch.Tensor:
    """The ranks' shares ``x`` (walker axis ``dim`` of a ``[..., 2, nh/W, ...]`` layout)
    gathered over the walker group into ``[..., 2, nh, ...]``, on every rank."""
    return all_gather(x, mesh.walker_group, dim=dim)


def local_state(coords, log_prob, generator: torch.Generator, n_accept, mesh: Mesh):
    """The sharded state of a flat ensemble whose log-probs are known (a checkpoint's):
    this rank's share of ``coords`` [nw, ndim] and ``log_prob`` [nw]."""
    return EnsembleState(walker_share(coords, mesh).contiguous(),
                         walker_share(log_prob, mesh).contiguous(), generator,
                         torch.as_tensor(n_accept, dtype=torch.int64, device=coords.device))


def shard_ensemble_state(coords, log_prob_fn: Callable, generator: torch.Generator,
                         mesh: Mesh) -> EnsembleState:
    """The ``[2, nh/W, ndim]`` sharded state of the flat ``[nw, ndim]`` ensemble
    ``coords`` (on every rank; nw must divide by ``2 W``): each rank evaluates its
    share's log-probs."""
    coords = torch.as_tensor(coords)
    share = walker_share(coords, mesh).contiguous()
    logp = log_prob_fn(share.reshape(-1, coords.shape[1])).reshape(2, -1)
    return EnsembleState(share, logp, generator,
                         torch.zeros((), dtype=torch.int64, device=coords.device))


def sharded_log_prob(log_prob_fn: Callable, mesh: Mesh):
    """``fn(coords [nw, ndim]) -> [nw]`` on every rank, each rank evaluating its
    contiguous ``nw/W`` rows and the results gathered over the walker group."""

    def batched(coords):
        nw, W = coords.shape[0], mesh.walkers
        if nw % W:
            raise ValueError(f"nw={nw} must divide by {W}")
        n = nw // W
        return all_gather(log_prob_fn(coords[mesh.w_index * n:(mesh.w_index + 1) * n]),
                          mesh.walker_group)

    return batched


def sharded_stretch_step(state: EnsembleState, log_prob_fn: Callable, mesh: Mesh,
                         a: float = 2.0) -> EnsembleState:
    """One distributed full ensemble update (for step-at-a-time drivers)."""
    return _sharded_steps(state, log_prob_fn, mesh, 1, 1, a)[0]


def run_ensemble_sharded(state: EnsembleState, log_prob_fn: Callable, mesh: Mesh,
                         n_steps: int, thin: int = 1, a: float = 2.0):
    """Distributed ``run_ensemble``: returns ``(final_state, chain [n_keep, 2, nh/W,
    ndim], logps [n_keep, 2, nh/W])``, this rank's shares, with ``n_keep =
    max(n_steps // thin, 1)`` as in JAX."""
    return _sharded_steps(state, log_prob_fn, mesh, n_steps, thin, a)


def _sharded_steps(state: EnsembleState, log_prob_fn: Callable, mesh: Mesh, n_steps: int,
                   thin: int, a: float):
    """The stretch chain on this rank's share: each chunk's draws for the whole
    ensemble, sliced; the complement half gathered over the walker group a half-step;
    the accept count summed over it at the end."""
    c = [state.coords[0], state.coords[1]]
    lp = [state.log_prob[0], state.log_prob[1]]
    nhl = c[0].shape[0]
    nh = nhl * mesh.walkers
    mine = slice(mesh.w_index * nhl, (mesh.w_index + 1) * nhl)
    gen, dev = state.generator, c[0].device
    n_acc = torch.zeros((), dtype=torch.int64, device=dev)
    chain, logps = [], []
    for _ in range(max(n_steps // thin, 1)):
        z, idx, log_u = _draw_chunk(gen, thin, nh, a, c[0].dtype, dev)
        for s in range(thin):
            for h in (0, 1):
                comp = all_gather(c[1 - h], mesh.walker_group)
                c[h], lp[h], k = _propose_accept(c[h], lp[h], comp, z[s, h, mine],
                                                 idx[s, h, mine], log_u[s, h, mine],
                                                 log_prob_fn)
                n_acc = n_acc + k
        chain.append(torch.stack(c))
        logps.append(torch.stack(lp))
    n_acc = state.n_accept + all_reduce(n_acc, mesh.walker_group)
    return (EnsembleState(torch.stack(c), torch.stack(lp), gen, n_acc), torch.stack(chain),
            torch.stack(logps))


# ---------------------------------------------------------------------------
# the fleet over a targets x walkers mesh (inference.fleet is imported where it is used:
# it imports the kernels' modules, which import parallel.mesh and so this package)


def _target_block(ntgt: int, mesh: FleetMesh) -> slice:
    if ntgt % mesh.targets:
        raise ValueError(f"ntgt={ntgt} must divide by {mesh.targets}")
    n = ntgt // mesh.targets
    return slice(mesh.t_index * n, (mesh.t_index + 1) * n)


def fleet_block(fleet, mesh: FleetMesh):
    """This rank's targets of the padded stacked ``fleet``: every field sliced along the
    target axis, the padded widths kept.  On the card the fleet kernels' tables are
    built here, once, for the slice."""
    from mcmc_spec_tpu_torch.inference.target import DATA_FIELDS
    from mcmc_spec_tpu_torch.ops import cuda_kernels

    tb = _target_block(fleet.D.shape[0], mesh)
    block = dataclasses.replace(fleet, **{k: getattr(fleet, k)[tb] for k in DATA_FIELDS})
    if block.device.type == "cuda":
        cuda_kernels.fleet_kernel_tables(block)
    return block


def fleet_share(x: torch.Tensor, mesh: FleetMesh) -> torch.Tensor:
    """This rank's ``[2, ntgt/T, nh/W, ...]`` share of a ``[ntgt, nw, ...]`` fleet array."""
    tb = _target_block(x.shape[0], mesh)
    share = walker_share(x[tb].movedim(1, 0), mesh)  # [2, nh/W, ntgt/T, ...]
    return share.movedim(2, 1).contiguous()


def gather_fleet(x: torch.Tensor, mesh: FleetMesh, dim: int = 1) -> torch.Tensor:
    """The ranks' shares ``x`` (``[..., 2, ntgt/T, nh/W, ...]``, the target axis at
    ``dim``) gathered into the flat ``[..., ntgt, nw, ...]`` on every rank: over the
    walker group, then over the target group."""
    x = all_gather(x, mesh.walker_group, dim=dim + 1)
    x = all_gather(x, mesh.target_group, dim=dim)  # [..., 2, ntgt, nh, ...]
    x = x.movedim(dim - 1, dim)
    return x.reshape(*x.shape[:dim], -1, *x.shape[dim + 2:])


def shard_fleet_state(coords, block, generator: torch.Generator,
                      mesh: FleetMesh) -> EnsembleState:
    """The sharded twin of ``init_fleet_ensemble``: this rank's share of the
    ``[ntgt, nw, ndim]`` ``coords`` (on every rank), its log-posteriors evaluated on its
    block (``fleet_block``)."""
    from mcmc_spec_tpu_torch.inference.fleet import log_posterior_fleet

    coords = torch.as_tensor(coords)
    share = fleet_share(coords, mesh)  # [2, ntl, nhl, ndim]
    _, ntl, nhl, ndim = share.shape
    logp = log_posterior_fleet(share.movedim(0, 1).reshape(ntl, 2 * nhl, ndim), block)
    return EnsembleState(share, logp.reshape(ntl, 2, nhl).movedim(1, 0).contiguous(),
                         generator, torch.zeros((), dtype=torch.int64, device=coords.device))


def local_fleet_state(coords, log_prob, generator: torch.Generator, n_accept,
                      mesh: FleetMesh) -> EnsembleState:
    """The sharded state of a fleet whose log-probs are known (a checkpoint's): this
    rank's share of ``coords`` [ntgt, nw, ndim] and ``log_prob`` [ntgt, nw]."""
    return EnsembleState(fleet_share(coords, mesh), fleet_share(log_prob, mesh), generator,
                         torch.as_tensor(n_accept, dtype=torch.int64, device=coords.device))


def run_fleet_ensemble_sharded(state: EnsembleState, block, mesh: FleetMesh, n_steps: int,
                               thin: int = 1, a: float = 2.0):
    """Distributed ``run_fleet_ensemble`` on this rank's ``block`` (``fleet_block``):
    returns ``(state, chain [n_keep, 2, ntgt/T, nh/W, ndim], logps [n_keep, 2, ntgt/T,
    nh/W])``, this rank's shares, with ``n_keep = max(n_steps // thin, 1)`` as in JAX."""
    from mcmc_spec_tpu_torch.inference.fleet import _draw_fleet_chunk, log_posterior_fleet

    c = [state.coords[0], state.coords[1]]  # [ntl, nhl, ndim]
    lp = [state.log_prob[0], state.log_prob[1]]
    ntl, nhl = c[0].shape[:2]
    ntgt, nh = ntl * mesh.targets, nhl * mesh.walkers
    tb = slice(mesh.t_index * ntl, (mesh.t_index + 1) * ntl)
    mine = slice(mesh.w_index * nhl, (mesh.w_index + 1) * nhl)
    gen, dev = state.generator, c[0].device
    logp = lambda proposal: log_posterior_fleet(proposal, block)
    n_acc = torch.zeros((), dtype=torch.int64, device=dev)
    chain, logps = [], []
    for _ in range(max(n_steps // thin, 1)):
        z, idx, log_u = _draw_fleet_chunk(gen, thin, ntgt, 2 * nh, a, c[0].dtype, dev)
        for s in range(thin):
            for h in (0, 1):
                comp = all_gather(c[1 - h], mesh.walker_group, dim=1)
                c[h], lp[h], k = _propose_accept(c[h], lp[h], comp, z[s, h, tb, mine],
                                                 idx[h][s, tb, mine], log_u[s, h, tb, mine],
                                                 logp)
                n_acc = n_acc + k
        chain.append(torch.stack(c))
        logps.append(torch.stack(lp))
    n_acc = state.n_accept + all_reduce(n_acc, None)
    return (EnsembleState(torch.stack(c), torch.stack(lp), gen, n_acc), torch.stack(chain),
            torch.stack(logps))
