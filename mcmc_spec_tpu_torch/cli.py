"""Command-line entry point: ``python -m mcmc_spec_tpu_torch.cli -f paramfile -o True -e True``.

Port of ``mcmc_spec_tpu.cli`` with the same options: ``-f`` parameter file,
``-o`` run the optimize stage, ``-e`` run the MCMC stage, ``--nospec``
(spectrum chi^2 weight -> 0), ``--noplots`` (skip the report stage),
``--dtype``, ``--mesh auto|off|WxS``, ``--data-dir``, ``--grid-dir`` and
``--bps-dir``.  ``--device`` (default ``cuda``) picks the device; ``--device
cpu`` runs the whole fit on the CPU.  Repeating ``-f`` fits all the named
targets as one fleet (``fleet_pipeline.run_fleet``).

Sharding runs one process per rank under ``torchrun`` (``python -m
torch.distributed.run``), which sets ``WORLD_SIZE``, ``RANK`` and
``LOCAL_RANK``; the CLI then initialises the process group itself: NCCL with
one card per rank (``cuda:LOCAL_RANK``), or gloo with ``--device cpu``.
``--mesh WxS`` (``W * S`` ranks) shards the walkers W ways and the data axis
S ways in both stages; ``--mesh auto`` (the default) shards stage 2's walkers
over all the ranks.  A fleet under ``torchrun`` with ``--mesh auto`` runs its
stage 2 on a ``targets x walkers`` mesh of the ranks
(``fleet_pipeline.resolve_fleet_mesh``: ``torchrun --nproc-per-node N -m
mcmc_spec_tpu_torch.cli -f a -f b ...``) and its stage 1 on rank 0; a ``WxS``
mesh is single-target only, as in JAX.  A ``WxS`` mesh of several ranks outside
``torchrun``, ``--mesh off`` under several ranks, or more ranks than cards,
exits before any compute with the command to use; a ``1x1`` mesh outside
``torchrun`` runs in a process group of one.

The report stage needs matplotlib: without it a run that asks for plots
exits before any compute.  Only rank 0 writes files and plots.
"""
from __future__ import annotations

import datetime
import getopt
import os
import sys

import torch
import torch.distributed as dist

from mcmc_spec_tpu_torch.parallel.mesh import free_port, parse_wxs, rank_device
from mcmc_spec_tpu_torch.pipeline import (
    check_wxs_stage_counts,
    resolve_mesh,
    run_mcmc_stage,
    run_optimize_stage,
    setup_context,
)
from mcmc_spec_tpu_torch.utils.config import FitConfig
from mcmc_spec_tpu_torch.utils.flags import enable_persistent_compile_cache

USAGE = ("usage: -f paramfile [-f paramfile2 ...] [-o True|False] [-e True|False] "
         "[--noplots] [--nospec] "
         "[--dtype float32|float64] [--mesh auto|off|WxS] [--device cuda|cpu] "
         "[--data-dir DIR] [--grid-dir DIR] [--bps-dir DIR]")
# the ranks other than 0 wait at a barrier while rank 0 runs a walker mesh's stage 1,
# which may take far longer than the backends' default timeouts
PG_TIMEOUT = datetime.timedelta(hours=2)


def _launch_line(argv, nranks: int) -> str:
    return (f"torchrun --nproc-per-node {nranks} -m mcmc_spec_tpu_torch.cli "
            + " ".join(argv[1:]))


def _init_process_group(device: str, under_torchrun: bool) -> None:
    """The process group of this run: torchrun's ranks, or a group of one for a ``1x1``
    mesh; NCCL on the cards, gloo on the CPU."""
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(rank_device(device))
    backend = "nccl" if cuda else "gloo"
    if under_torchrun:
        dist.init_process_group(backend, timeout=PG_TIMEOUT)
    else:
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{free_port()}",
                                world_size=1, rank=0, timeout=PG_TIMEOUT)


def main(argv=None):
    argv = sys.argv if argv is None else argv
    opts, _ = getopt.getopt(
        argv[1:], "f:o:e:",
        ["file=", "optimize=", "emcee=", "nospec", "noplots", "dtype=", "mesh=",
         "data-dir=", "grid-dir=", "bps-dir=", "device="],
    )
    parfiles, do_opt, do_emcee = [], "False", "False"
    nospec, noplots, dtype, device, mesh = False, False, torch.float32, "cuda", "auto"
    overrides = {}
    for key, val in opts:
        if key in ("-f", "--file"):
            parfiles.append(val)
        elif key in ("-o", "--optimize"):
            do_opt = val
        elif key in ("-e", "--emcee"):
            do_emcee = val
        elif key == "--nospec":
            nospec = True
        elif key == "--noplots":
            noplots = True
        elif key == "--data-dir":
            overrides["data_dir"] = val  # base dir for relative data paths
        elif key == "--grid-dir":
            overrides["grid_dir"] = val  # BT-Settl / PHOENIX model directory
        elif key == "--bps-dir":
            overrides["bps_dir"] = val  # filter transmission curves
        elif key == "--dtype":
            dtype = {"float32": torch.float32, "float64": torch.float64}[val]
        elif key == "--device":
            device = val
        elif key == "--mesh":
            # auto (walker mesh over the ranks), off, or WxS (walkers x spec mesh)
            low = val.lower()
            if low in ("auto", "off", "none"):
                mesh = "auto" if low == "auto" else None
            else:
                try:
                    wxs = parse_wxs(low)
                except ValueError as e:
                    raise SystemExit(f"--mesh: {e}")
                if wxs is None:
                    raise SystemExit(
                        f"--mesh must be 'auto', 'off', or WxS (e.g. 4x2), got {val!r}")
                mesh = low
    wxs = parse_wxs(mesh)
    if wxs is not None and len(parfiles) > 1:
        # JAX's words (mcmc_spec_tpu/cli.py): a fleet shards (targets, walkers)
        raise SystemExit(
            f"--mesh: {mesh!r} (walkers x spec) is single-target only; "
            "fleet mode shards (targets, walkers) — run WxS fits one "
            "target at a time (see PARITY.md, fleet x spec scope note)"
        )
    under_torchrun = "WORLD_SIZE" in os.environ
    nranks = int(os.environ.get("WORLD_SIZE", "1"))
    if wxs is not None and wxs[0] * wxs[1] > 1 and not under_torchrun:
        raise SystemExit(
            f"--mesh {mesh} (walker and spectral sharding) runs one process on each of its "
            f"{wxs[0] * wxs[1]} ranks: {_launch_line(argv, wxs[0] * wxs[1])}")
    if not parfiles:
        raise SystemExit(USAGE)
    if nranks > 1 and mesh is None:
        raise SystemExit(
            f"{nranks} ranks: the fits of --mesh off run on one device; run them without "
            "torchrun")
    run_opt, run_emcee = do_opt == "True", do_emcee == "True"
    if (run_opt or run_emcee) and not noplots:
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            raise SystemExit("the report stage needs matplotlib, which cannot be imported "
                             "here; pass --noplots to fit without it") from None
    cuda = torch.device(device).type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available; pass --device cpu to fit on the CPU")
    local_ranks = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    if cuda and under_torchrun and local_ranks > torch.cuda.device_count():
        raise SystemExit(
            f"{local_ranks} ranks on this host, {torch.cuda.device_count()} CUDA devices: "
            "NCCL runs one rank on each card; "
            f"{_launch_line(argv, torch.cuda.device_count())} with a mesh of that many ranks")

    # before the first dispatch: a run whose kernels were built before (by this or another
    # process, into the same directory) loads them without nvcc (MCMC_SPEC_COMPILE_CACHE=0
    # opts out)
    enable_persistent_compile_cache()

    cfgs = [FitConfig.from_file(p) for p in parfiles]
    if nospec:
        for cfg in cfgs:
            cfg.spectrum_weight = 0.0
    for attr, val in overrides.items():
        for cfg in cfgs:
            setattr(cfg, attr, val)

    # a WxS mesh (single-target only) with bad walker counts must fail now, not after the
    # optimize stage
    try:
        check_wxs_stage_counts(cfgs[0].nwalk, mesh, run_opt, run_emcee)
    except ValueError as e:
        raise SystemExit(f"--mesh: {e}")

    distributed = under_torchrun or wxs is not None
    if distributed:
        _init_process_group(device, under_torchrun)
        device = str(rank_device(device))
    try:
        if len(cfgs) > 1:
            from mcmc_spec_tpu_torch.fleet_pipeline import run_fleet

            # the chain streams to samples.txt and the reports re-read it per target
            run_fleet(cfgs, optimize=run_opt, emcee=run_emcee, noplots=noplots, dtype=dtype,
                      device=device, mesh=mesh)
        else:
            _fit(cfgs[0], run_opt, run_emcee, noplots, dtype, device, mesh)
    finally:
        if distributed:
            dist.destroy_process_group()


def _fit(cfg, run_opt, run_emcee, noplots, dtype, device, mesh):
    # the mesh, made once on every rank; each stage checks its walker count against it
    mesh = resolve_mesh(mesh, None, device=device)
    # WxS: pack the target on the host, so that the full grid projection never lies on
    # one device: each rank moves only its slice of the data axis to the mesh's device
    spec = mesh is not None and "spec" in mesh.axis_names
    ctx = setup_context(cfg, dtype=dtype, device="cpu" if spec else device)
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    if run_opt:
        run_optimize_stage(ctx, mesh=mesh)
        if not noplots and rank0:
            from mcmc_spec_tpu_torch.report.plots import plot_fit

            plot_fit(ctx)
    if run_emcee:
        samples = run_mcmc_stage(ctx, mesh=mesh)
        if not noplots and rank0:
            from mcmc_spec_tpu_torch.report.plots import plot_corner, plot_results

            plot_corner(ctx, samples)
            plot_results(ctx, samples)


if __name__ == "__main__":
    main()
