"""Fleet pipeline: fit many targets as one stacked fleet, end to end.

Port of ``mcmc_spec_tpu.fleet_pipeline``.  N param files
become one stacked :class:`PackedTarget` (ragged data and contrast axes
padded to the fleet maxima with inert padding), the whole fleet samples in
one stretch-move loop (``inference.fleet.run_fleet_ensemble``, BASELINE.md
config 5), and each target still gets the reference's artifact set
(``samples.txt``, dumps, autocorrelation trace, reports) under its own
``dirname``.

Stage 1 anneals each target on its unpadded context, the one the reports
use: a padded target takes the torch composition for its spectrum term
(``pack_target``), an unpadded one on a CUDA float32 card the
``spectrum_chi2`` kernel.  The unpadded target is packed again from the
padded context's grid, filters and tables (``pipeline.pack_context``), so
each target is built once.  Padding is inert and the annealer's draws do not
depend on the data length, so the optimize results are those of the padded
targets up to rounding, and each target's ``optimize_res.txt`` is the
single-target stage's.  Stage 2 runs on the padded fleet, where the fleet
kernels take each target's true lengths.

The stage-2 draws come from one ``torch.Generator`` on the fleet's device,
seeded with the first target's ``seed + 1``.

Under a ``torch.distributed`` process group of several ranks stage 2 runs on
a ``targets x walkers`` mesh of the ranks (``resolve_fleet_mesh``, JAX's
factorisation: the target axis is pure data parallel, the walker axis needs
only within-target partner gathers).  Each rank evaluates its block of the
padded stacked fleet (``parallel.sharding.fleet_block``) with the fleet
kernels and draws every chunk's numbers for the whole fleet, so the sharded
chain is the one-device chain, and a checkpoint written on one device resumes
on any fleet mesh and the other way round (the tag does not name the mesh).
Stage 1 runs on rank 0 while the others wait at a barrier, and every rank
then seeds from what rank 0 wrote.  Only rank 0 writes files: dumps, the
chain store, the checkpoint, the autocorrelation trace and ``samples.txt``.
Every rank holds the whole chain, so the autocorrelation gate decides alike
on every rank.  A ``WxS`` (walkers x spec) mesh is single-target only, as in
JAX.

The census on a fleet mesh (``parallel.mesh.COLLECTIVES``), whatever its
size: one ``all_gather`` a half-step (the complement half, over the walker
group); one ``all_reduce_sum`` a call of the sampler (the accept count, over
the whole mesh), that is one a burn-in or sampling chunk; two ``all_gather``
a chunk (its chain and last log-probs to every rank: over the walker group,
then the target group).  A run of ``b`` burn-in and ``c`` sampling chunks of
``nthin`` steps makes ``(b + c)(2 nthin + 2)`` gathers and ``b + c`` sums,
and 2 barriers (before the seeds and before the first append) besides stage
1's, one a target.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch

from mcmc_spec_tpu_torch.inference.autocorr import converged, integrated_time
from mcmc_spec_tpu_torch.inference.fleet import (
    init_fleet_ensemble,
    run_fleet_ensemble,
    stack_targets,
)
from mcmc_spec_tpu_torch.inference.stretch import EnsembleState
from mcmc_spec_tpu_torch.io import results as results_io
from mcmc_spec_tpu_torch.io.spectra import load_data_spectrum
from mcmc_spec_tpu_torch.parallel import sharding
from mcmc_spec_tpu_torch.parallel.mesh import (
    FleetMesh,
    barrier,
    make_fleet_mesh,
    parse_wxs,
    world,
)
from mcmc_spec_tpu_torch.pipeline import (
    ACL_MAX_WALKERS,
    FitContext,
    _host,
    _resolve,
    next_acl_gate,
    pack_context,
    run_optimize_stage,
    seed_from_optimize,
    setup_context,
)
from mcmc_spec_tpu_torch.utils.config import FitConfig


def setup_fleet(parfiles: Sequence, dtype=torch.float32, device="cuda") -> list:
    """Build FitContexts padded to common fleet shapes.

    ``parfiles`` are param-file paths or :class:`FitConfig` objects.  A first
    pass measures each target's masked data length and contrast count so every
    target packs to the fleet maxima (padding is inert by construction, see
    ``pack_target``); a second pass builds the full contexts.
    """
    cfgs = [p if isinstance(p, FitConfig) else FitConfig.from_file(p) for p in parfiles]
    nds, ncs = [], []
    for cfg in cfgs:
        wl, _, _ = load_data_spectrum(
            _resolve(cfg.filename, cfg), cfg.spmin, cfg.spmax, cfg.mask
        )
        nds.append(len(wl))
        ncs.append(len(cfg.cfilt))
    pad_nd, pad_nc = max(nds), max(ncs)
    ctxs = [setup_context(cfg, dtype=dtype, device=device, pad_nd=pad_nd, pad_nc=pad_nc)
            for cfg in cfgs]

    t0 = ctxs[0].target
    for ctx, cfg in zip(ctxs[1:], cfgs[1:]):
        t = ctx.target
        for field, a, b in [
            ("grid (nT, nG)", tuple(t.D.shape[:2]), tuple(t0.D.shape[:2])),
            ("photometry filters", t.Fp.shape[-1], t0.Fp.shape[-1]),
            ("nspec", t.nspec, t0.nspec),
            ("dist_fit", t.dist_fit, t0.dist_fit),
            ("Av profile nodes", tuple(t.av_mu_nodes.shape), tuple(t0.av_mu_nodes.shape)),
        ]:
            if a != b:
                raise ValueError(
                    f"fleet targets must match in {field}: {cfg.fname!r} has {a}, "
                    f"{cfgs[0].fname!r} has {b} (use identical model/temp ranges "
                    "and filter sets, or fit mismatched targets separately)"
                )
    return ctxs


def unpadded_context(ctx: FitContext) -> FitContext:
    """``ctx`` without fleet padding: ``ctx`` itself when its target holds none, else
    ``ctx`` with its target packed again, unpadded, on the same device and dtype."""
    t = ctx.target
    if int(t.n_data_true) == t.n_data and int(t.n_contrast_true) == t.n_contrast:
        return ctx
    return dataclasses.replace(ctx, target=pack_context(ctx, dtype=t.D.dtype, device=t.device))


def fleet_mesh_shape(size: int, ntgt: int, nw: int) -> Optional[tuple]:
    """``(t_ax, w_ax)`` of JAX's fleet mesh over ``size`` devices: the factorisation with
    the most target parallelism whose ``t_ax`` divides ``ntgt`` and whose ``w_ax``
    shards each half of ``nw`` walkers evenly (or is 1); None with one device or none
    that fits."""
    if size <= 1:
        return None
    for t_ax in range(size, 0, -1):
        if size % t_ax != 0 or ntgt % t_ax != 0:
            continue
        w_ax = size // t_ax
        if nw % (2 * w_ax) == 0 or w_ax == 1:
            return t_ax, w_ax
    return None


def resolve_fleet_mesh(mesh, ntgt: int, nw: int, device=None) -> Optional[FleetMesh]:
    """The ``(targets, walkers)`` mesh over the process group's ranks, or None.

    A :class:`~mcmc_spec_tpu_torch.parallel.mesh.FleetMesh` is used as it is; a falsy
    ``mesh`` or a world of one rank gives None (one device); a ``"WxS"`` string raises
    JAX's ``ValueError``; anything else (``"auto"``) picks ``fleet_mesh_shape`` over the
    world size, falling back to None.  Every rank must call it at the same point: a new
    mesh creates its subgroups on every rank.  ``device``: where this rank computes.
    """
    if isinstance(mesh, FleetMesh):
        return mesh
    if not mesh:
        return None
    # parse_wxs also raises on malformed WxS-shaped strings ("0x2", "4x")
    if parse_wxs(mesh) is not None:
        raise ValueError(
            "an explicit WxS (walkers, spec) mesh is single-target only; "
            "fleet mode shards (targets, walkers) — use --mesh auto, or fit "
            "the spec-sharded target alone"
        )
    shape = fleet_mesh_shape(world()[1], ntgt, nw)
    return None if shape is None else make_fleet_mesh(*shape, device=device)


def run_fleet_optimize(ctxs: Sequence[FitContext]) -> list:
    """Stage 1 for every target, each annealed on its unpadded context; returns those
    contexts.  Under a process group of several ranks rank 0 anneals while the others
    wait at a barrier a target (``run_optimize_stage``)."""
    solo = [unpadded_context(ctx) for ctx in ctxs]
    for ctx in solo:
        run_optimize_stage(ctx)
    return solo


def _warn_fleet_schedule_mismatch(cfgs) -> None:
    """Loud warning when fleeted configs disagree on nsteps/nburn.

    The fleet runs ONE schedule (the minimum across targets, so no target
    samples past its own budget); a silent ``min()`` would quietly cut a
    long-schedule target's requested chain.
    """
    for field in ("nsteps", "nburn"):
        vals = {cfg.fname: getattr(cfg, field) for cfg in cfgs}
        if len(set(vals.values())) > 1:
            lo = min(vals.values())
            print(
                f"[fleet] WARNING: targets disagree on {field} ({vals}); "
                f"the fleet runs the SHORTEST schedule ({field}={lo}) for "
                "every target.  Fit long-schedule targets separately (or "
                "align the configs) if they need their full budget."
            )


def stream_fleet_samples(store, dirnames: Sequence[str], n_chunks: int,
                         ndim: int, return_samples: bool = True):
    """Per-target ``samples.txt`` files streamed from the ChainStore.

    ONE pass over the chunks (each ``[nthin, ntgt, nw, ndim]``): peak host
    memory is one chunk whatever the schedule's length.  With
    ``return_samples=True`` the per-target flat arrays are also accumulated
    and returned; ``False`` returns None (read ``samples.txt`` back per
    target, as the reference does, mft6.py:1531).

    The bytes written are those of ``results_io.write_samples`` on the
    concatenated chain (both go through ``results_io.write_sample_block``).
    """
    ntgt = len(dirnames)
    parts = [[] for _ in dirnames] if return_samples else None
    handles = [open(os.path.join(d, "samples.txt"), "w") for d in dirnames]
    pd = results_io._pandas_or_none()
    try:
        for c in store.iter_chunks(n_chunks):
            for t in range(ntgt):
                block = np.ascontiguousarray(c[:, t]).reshape(-1, ndim)
                results_io.write_sample_block(handles[t], block, pd)
                if return_samples:
                    parts[t].append(block)
    finally:
        for h in handles:
            h.close()
    if return_samples:
        return [np.concatenate(p, axis=0) for p in parts]
    return None


class _FleetRunner:
    """Runs stage 2 on one device or a fleet mesh, with flat host views: the chain
    ``[n, ntgt, nw, ndim]`` and the final log-probs ``[ntgt, nw]`` on every rank, so a
    checkpoint written in one layout resumes in any other."""

    def __init__(self, fleet, mesh: Optional[FleetMesh]):
        self.fleet, self.mesh = fleet, mesh
        # the rank's slice of the padded fleet, sliced once: its kernel tables are cached
        self.block = None if mesh is None else sharding.fleet_block(fleet, mesh)

    def init(self, coords, generator):
        if self.mesh is None:
            return init_fleet_ensemble(coords, self.fleet, generator)
        return sharding.shard_fleet_state(coords, self.block, generator, self.mesh)

    def restore(self, coords, log_prob, generator, n_accept):
        """A checkpoint's state: its log-probs are carried, not evaluated again."""
        if self.mesh is None:
            return EnsembleState(coords, log_prob, generator,
                                 torch.tensor(n_accept, dtype=torch.int64, device=coords.device))
        return sharding.local_fleet_state(coords, log_prob, generator, n_accept, self.mesh)

    def run(self, state, n_steps: int, thin: int):
        """Advance; returns (state, host chain [n_steps // thin or 1, ntgt, nw, ndim], host
        log-probs [ntgt, nw] of the final state, whose coordinates are the chain's last)."""
        if self.mesh is None:
            state, chain, _ = run_fleet_ensemble(state, self.fleet, n_steps=n_steps, thin=thin)
            return state, _host(chain), _host(state.log_prob)
        state, chain, logps = sharding.run_fleet_ensemble_sharded(
            state, self.block, self.mesh, n_steps=n_steps, thin=thin)
        # the chain and its log-probs in one pair of gathers
        full = _host(sharding.gather_fleet(torch.cat([chain, logps[..., None]], dim=-1),
                                           self.mesh, dim=2))
        return state, np.ascontiguousarray(full[..., :-1]), full[-1, ..., -1]


def run_fleet_mcmc(
    ctxs: Sequence[FitContext],
    p0s: Optional[Sequence[np.ndarray]] = None,
    nthin: int = 100,
    check_convergence: bool = True,
    mesh="auto",
    resume: bool = True,
    return_samples: bool = True,
) -> Optional[list]:
    """Stage 2 for the whole fleet at once.

    Seeds each target from its optimize stage (top third by chi^2) unless
    ``p0s`` is given, trims every ensemble to a common even walker count, and
    runs burn-in and autocorrelation-gated sampling for all targets together.
    Per-target ``samples.txt``, coordinate dumps and autocorrelation traces
    land in each target's ``dirname``.  Returns the per-target flat sample
    arrays, or ``None`` with ``return_samples=False`` (the chain streams
    through the ChainStore to the ``samples.txt`` files; peak host memory is
    one chunk).

    ``mesh``: ``"auto"`` (the default) runs on a ``targets x walkers`` mesh of the
    process group's ranks where one fits (``resolve_fleet_mesh``), else on one device;
    None forces one device; a ``FleetMesh`` is used as it is.  Every rank runs the loop
    and holds the whole chain; only rank 0 writes files and returns the samples (the
    others return None).

    Checkpoint and resume are the single-target stage's (``run_mcmc_stage``):
    after every chunk the stacked sampler state (coordinates, log-probs,
    generator state, step) goes to ``fleet_chain_checkpoint.npz`` under the
    FIRST target's dirname and the chunk to its append-only
    ``fleet_chain_chunks/`` store.  A resumed state carries the checkpoint's
    log-probs rather than re-evaluating them, so an interrupted run resumes
    bit for bit.  The checkpoint's tag starts ``torch:fleet:``, so neither
    this package nor the JAX one resumes the other's file.
    """
    cfgs = [ctx.cfg for ctx in ctxs]
    barrier()  # the optimizer results rank 0 wrote
    rank0 = world()[0] == 0
    if rank0:
        _warn_fleet_schedule_mismatch(cfgs)
    if p0s is None:
        p0s = [seed_from_optimize(ctx) for ctx in ctxs]
    nw = min(p.shape[0] for p in p0s)
    nw -= nw % 2
    if nw < 4:
        raise ValueError(f"fleet needs >=4 walkers per target, got {nw}")
    p0 = np.stack([np.asarray(p[:nw], dtype=np.float64) for p in p0s])  # [ntgt, nw, ndim]
    ntgt = p0.shape[0]

    fleet = stack_targets([ctx.target for ctx in ctxs])
    dev = fleet.device
    use_mesh = resolve_fleet_mesh(mesh, ntgt, nw, device=dev)
    if use_mesh is not None and rank0:
        print(f"[fleet] {ntgt} targets x {nw} walkers over mesh {use_mesh.shape}")
    runner = _FleetRunner(fleet, use_mesh)
    as_walkers = lambda x: torch.as_tensor(x, dtype=fleet.D.dtype, device=dev)
    gen = torch.Generator(device=dev).manual_seed(cfgs[0].seed + 1)

    nburn = min(cfg.nburn for cfg in cfgs)
    nsteps = min(cfg.nsteps for cfg in cfgs)
    ckpt_path = os.path.join(cfgs[0].dirname, "fleet_chain_checkpoint.npz")
    store = results_io.ChainStore(cfgs[0].dirname, name="fleet_chain_chunks")
    config_tag = ("torch:fleet:" + ",".join(cfg.fname for cfg in cfgs)
                  + f":{ntgt}x{nw}x{p0.shape[2]}:{nsteps}:{nburn}"
                  + f":{cfgs[0].seed}:{cfgs[0].spectrum_weight}:{nthin}")
    start_chunk = 0

    ckpt = results_io.maybe_load_checkpoint(ckpt_path) if resume else None
    if ckpt is not None and ckpt.config_tag and ckpt.config_tag != config_tag:
        if rank0:
            print("[fleet resume] checkpoint belongs to a different run config; ignoring")
        ckpt = None
    if (ckpt is not None and ckpt.coords.shape == p0.shape and ckpt.step > 0
            and not store.has_chunks(ckpt.step // nthin)):
        # a checkpoint without its chunk store would drop the pre-crash history
        if rank0:
            print("[fleet resume] checkpoint found but fleet_chain_chunks/ "
                  "is missing; restarting from scratch")
        ckpt = None
    if ckpt is not None and ckpt.coords.shape == p0.shape:
        gen.set_state(torch.as_tensor(ckpt.key, dtype=torch.uint8))
        state = runner.restore(as_walkers(ckpt.coords), as_walkers(ckpt.log_prob), gen,
                               ckpt.n_accept)
        start_chunk = ckpt.step // nthin
    else:
        if not resume and rank0:
            store.clear()
        state = runner.init(as_walkers(p0), gen)

        # burn-in (the shortest target schedule governs, warned above)
        for n in range(max(nburn // nthin, 1)):
            state, chain, _ = runner.run(state, n_steps=nthin, thin=nthin)
            if rank0:
                for t, cfg in enumerate(cfgs):
                    results_io.dump_coords(cfg.dirname, cfg.fname, n * nthin, chain[-1, t],
                                           stage="burnin")
        state.n_accept = torch.zeros_like(state.n_accept)

    # the autocorrelation gate on a bounded walker subset and a growing check
    # interval (see run_mcmc_stage); the full fleet chain is never held in RAM.
    # Every rank holds the whole chain, so every rank's gate decides alike.
    acl_kept = ([c[:, :, :ACL_MAX_WALKERS] for c in store.iter_chunks(start_chunk)]
                if check_convergence else [])
    barrier()  # every rank has read the checkpoint and the store before rank 0 writes
    old_taus = None
    n_done = start_chunk * nthin
    n_chunks_done = start_chunk
    next_gate = start_chunk + 1
    for n in range(start_chunk, max(nsteps // nthin, 1)):
        state, chain, log_prob = runner.run(state, n_steps=nthin, thin=1)  # [nthin, ntgt, ...]
        if check_convergence:
            acl_kept.append(chain[:, :, :ACL_MAX_WALKERS])
        n_done += nthin
        n_chunks_done = n + 1
        if rank0:
            for t, cfg in enumerate(cfgs):
                results_io.dump_coords(cfg.dirname, cfg.fname, n * nthin, chain[-1, t],
                                       stage="results")
            store.append(n, chain)
            results_io.save_checkpoint(results_io.Checkpoint(
                chain[-1], log_prob, state.generator.get_state().numpy(), n_done,
                int(state.n_accept), config_tag=config_tag,
            ), ckpt_path)
        if check_convergence and n + 1 >= next_gate:
            acl_full = np.concatenate(acl_kept, axis=0)
            taus_t = [integrated_time(acl_full[:, t]) for t in range(ntgt)]
            del acl_full
            if rank0:
                for t, cfg in enumerate(cfgs):
                    results_io.append_autocorr(cfg.dirname, cfg.fname,
                                               float(np.mean(taus_t[t])))
            all_conv = all(
                converged(taus_t[t], n_done, old_taus[t] if old_taus is not None else None)
                for t in range(ntgt)
            )
            if all_conv:
                break
            old_taus = taus_t
            next_gate = next_acl_gate(n + 1)

    af = float(state.n_accept) / (ntgt * nw * max(n_done, 1))
    if not rank0:
        return None
    print(f"Mean acceptance fraction: {af:.3f}")

    out = stream_fleet_samples(store, [cfg.dirname for cfg in cfgs], n_chunks_done,
                               p0.shape[2], return_samples=return_samples)
    # a completed run's checkpoint would otherwise short-circuit the next one
    results_io.remove_checkpoint(ckpt_path)
    store.clear()
    return out


def run_fleet(
    parfiles: Sequence,
    optimize: bool = True,
    emcee: bool = True,
    noplots: bool = False,
    dtype=torch.float32,
    device="cuda",
    mesh="auto",
) -> list:
    """Full fleet run: N param files -> per-target reference artifact sets.

    The chain streams to the per-target ``samples.txt`` files (peak host
    memory is one chunk), and the report stage reads each target's file back
    and frees it before the next.  Stage 1 and the reports use each target's
    unpadded context (``unpadded_context``).  ``mesh``: stage 2's, as
    ``run_fleet_mcmc`` takes it.  Only rank 0 plots.  Returns the padded contexts.
    """
    ctxs = setup_fleet(parfiles, dtype=dtype, device=device)
    rank0 = world()[0] == 0
    solo = None
    if optimize:
        solo = run_fleet_optimize(ctxs)
        if not noplots and rank0:
            from mcmc_spec_tpu_torch.report.plots import plot_fit

            for ctx in solo:
                plot_fit(ctx)
    if not emcee:
        return ctxs
    run_fleet_mcmc(ctxs, mesh=mesh, return_samples=False)
    if not noplots and rank0:
        from mcmc_spec_tpu_torch.report.plots import plot_corner, plot_results

        for ctx in solo or [unpadded_context(ctx) for ctx in ctxs]:
            # one target's chain in RAM at a time
            s = results_io.read_samples(ctx.cfg.dirname)
            plot_corner(ctx, s)
            plot_results(ctx, s)
            del s
    return ctxs
