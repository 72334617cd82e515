"""Fleet-step attribution (counterpart of ``scripts/trace_fleet_step.py``).

The fleet of config 5: nine copies of the bench target stacked, 4,096 walkers
each.  On both routes, the composed default (K4 ``spectrum_chi2_fleet`` and the
torch composition around it) and ``MCMC_SPEC_FUSED_EVAL=1`` (K5
``log_posterior_fleet_fused``):

1. a ``torch.profiler`` trace of 20 back-to-back ``log_posterior_fleet`` calls
   on the whole fleet (the JAX script's) and on a half-step's walkers (what a
   step evaluates twice), and one of 20 steps of ``run_fleet_ensemble``, each
   printed as its op table; a step is split into the fleet kernel, the
   composition's ops (the half-step evaluation's other device ops, twice) and
   the sampler's mechanics (the rest of the step);
2. the section ablation of K4, S14 ``fleet_sections`` (``csrc/fleet_sections.cu``):
   ``full``, ``no_matmul``, ``no_extinct``, ``no_median``, ``no_renorm``,
   ``empty``, each checked (``full`` bit for bit K4, every other mode different
   from it) and timed with CUDA events and alone on the device, against ``full``.
   ``no_matmul``'s stub row is each walker's weight of grid point 0, which is
   zero for most walkers (a zero median, no finite chi^2); it runs on
   ``finite_stub``'s weights, whose grid point 0 holds each walker's largest.

    python -m mcmc_spec_tpu_torch.scripts.trace_fleet_step
"""
from __future__ import annotations

import contextlib
import json
import os

import torch

from mcmc_spec_tpu_torch.bench_target import build_bench_target, init_walker_batch
from mcmc_spec_tpu_torch.inference import batched
from mcmc_spec_tpu_torch.inference.fleet import (init_fleet_ensemble, log_posterior_fleet,
                                                 run_fleet_ensemble, stack_targets,
                                                 target_views)
from mcmc_spec_tpu_torch.ops import cuda_kernels as ck
from mcmc_spec_tpu_torch.scripts import op_table
from mcmc_spec_tpu_torch.scripts.timing import describe, resolve_device, timer

NTGT, NWALK = 9, 4096
N_CALLS = 20
ROUTES = (("composed (K4)", "0", "spectrum_chi2_fleet_kernel"),
          ("fused (K5)", "1", "log_posterior_fleet_fused_kernel"))
MODES = ("full", "no_matmul", "no_extinct", "no_median", "no_renorm", "empty")


@contextlib.contextmanager
def fused_eval(value: str):
    """``MCMC_SPEC_FUSED_EVAL`` set to ``value`` inside the block (read per call)."""
    old = os.environ.get("MCMC_SPEC_FUSED_EVAL")
    os.environ["MCMC_SPEC_FUSED_EVAL"] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("MCMC_SPEC_FUSED_EVAL", None)
        else:
            os.environ["MCMC_SPEC_FUSED_EVAL"] = old


def build_fleet(dev, ntgt=NTGT, nwalk=NWALK, nd=1792, grid_step=1.0):
    """(fleet of ``ntgt`` bench targets, walkers [ntgt, nwalk, ndim], one target)."""
    tgt, truth = build_bench_target(torch.float32, device=dev, nd=nd, grid_step=grid_step)
    fleet = stack_targets([tgt] * ntgt)
    coords = torch.stack([init_walker_batch(tgt, truth, nwalk, seed=i) for i in range(ntgt)])
    return fleet, coords, tgt


def fleet_wcomb(coords, fleet):
    """K4's inputs: the blend weights [ntgt, nw, NO] and the extinctions [ntgt, nw]."""
    W = torch.stack([batched._forward_small(p, t)[4] for p, t in zip(coords, target_views(fleet))])
    return W.contiguous(), coords[..., fleet.nspec].contiguous()


def finite_stub(W):
    """``W`` [..., NO] with each walker's largest weight at grid point 0, so that
    ``no_matmul``'s stub row (grid point 0's weight) is non-zero where the walker
    has a weight at all."""
    W = W.clone()
    W[..., 0] = W.amax(dim=-1)
    return W


def eval_ms(tab, kernel, n_calls):
    """Device ms an evaluation: the fleet kernel's mean over the launches the trace holds
    (the profiler can miss a few) and the other ops' time over the calls."""
    n = op_table.launches(tab, kernel)
    k = op_table.device_ms(tab, kernel)
    return (k / n if n else 0.0) + (tab["device_ms"] - k) / n_calls


def split_step(tab_half, tab_step, kernel, n_calls, n_steps):
    """(fleet kernel, composition, sampler) device ms a step: the composition is a
    half-step evaluation's other device ops, two evaluations a step; the sampler the
    rest."""
    k_step = op_table.device_ms(tab_step, kernel) / n_steps
    comp = 2 * (tab_half["device_ms"] - op_table.device_ms(tab_half, kernel)) / n_calls
    return k_step, comp, tab_step["device_ms"] / n_steps - k_step - comp


def trace_routes(fleet, coords, dev, n_calls=N_CALLS, n_steps=N_CALLS):
    out = {}
    for label, flag, kernel in ROUTES:
        with fused_eval(flag):
            tab_eval = op_table.trace_calls(lambda: log_posterior_fleet(coords, fleet), n=n_calls)
            op_table.print_table(tab_eval, f"{label}: log_posterior_fleet x{n_calls}",
                                 per=n_calls)
            nev = coords.shape[0] * coords.shape[1]
            if tab_eval["kernels"]:
                ms = eval_ms(tab_eval, kernel, n_calls)
                print(f"    => {ms:.4f} ms an evaluation batch device ({nev / (ms * 1e-3):,.0f} "
                      f"evals/s in-eval; {op_table.launches(tab_eval, kernel)} of {n_calls} "
                      f"{kernel} launches in the trace)", flush=True)
            else:
                print("    => device time not measured (no device op in the trace)", flush=True)
            half = coords[:, :coords.shape[1] // 2].contiguous()
            tab_half = op_table.trace_calls(lambda: log_posterior_fleet(half, fleet), n=n_calls)
            op_table.print_table(tab_half, f"{label}: log_posterior_fleet x{n_calls} on a "
                                 f"half-step's {half.shape[0]} x {half.shape[1]} walkers",
                                 top=4, per=n_calls)
            state = [init_fleet_ensemble(coords, fleet,
                                         torch.Generator(device=dev).manual_seed(0))]

            def steps():
                state[0] = run_fleet_ensemble(state[0], fleet, n_steps=n_steps,
                                              thin=n_steps)[0]

            tab_step = op_table.trace_calls(steps, n=1)
            op_table.print_table(tab_step, f"{label}: run_fleet_ensemble {n_steps} steps",
                                 per=n_steps)
            k, comp, samp = split_step(tab_half, tab_step, kernel, n_calls, n_steps)
            ops = op_table.launches(tab_step, "") / n_steps
            print(f"    => a step: fleet kernel {k:.4f} ms, composition {comp:.4f} ms, sampler "
                  f"{samp:.4f} ms device; window {tab_step['window_ms'] / n_steps:.4f} ms, busy "
                  f"{100 * tab_step['busy_share']:.1f} %, {ops:.1f} device ops a step",
                  flush=True)
            out[label] = {"eval": tab_eval, "half": tab_half, "step": tab_step,
                          "split_ms": (k, comp, samp)}
    return out


def ablate_k4(fleet, coords, dev, modes=MODES):
    """S14's modes against ``full``: checked, then CUDA events and alone on the device."""
    time_fn = timer(dev)
    W, av = fleet_wcomb(coords, fleet)
    real = ck.spectrum_chi2_fleet(W, av, fleet)
    results = {}
    Ws = {mode: finite_stub(W) if mode == "no_matmul" else W for mode in modes}
    for mode in modes:
        got = ck.fleet_sections(Ws[mode], av, fleet, mode)
        if mode == "full":
            if not torch.equal(got.view(torch.int32), real.view(torch.int32)):
                raise RuntimeError("S14 full differs from spectrum_chi2_fleet")
        elif torch.allclose(got, real):
            raise RuntimeError(f"S14 {mode}: output identical to full")
        ms = time_fn(lambda mode=mode: ck.fleet_sections(Ws[mode], av, fleet, mode)) * 1e3
        tab = op_table.trace_calls(lambda mode=mode: ck.fleet_sections(Ws[mode], av, fleet, mode),
                                   n=N_CALLS)
        alone = tab["device_ms"] / N_CALLS if op_table.launches(tab, "fleet_") else None
        results[mode] = (ms, alone)
        full = results["full"]
        print(json.dumps({"variant": mode, "ms_per_call": round(ms, 4),
                          "delta_vs_full_ms": round(full[0] - ms, 4),
                          "ms_alone": None if alone is None else round(alone, 4),
                          "delta_alone_vs_full_ms":
                          None if alone is None else round(full[1] - alone, 4)}), flush=True)
    return results


def main(device="cuda", ntgt=NTGT, nwalk=NWALK, nd=1792, grid_step=1.0, n_calls=N_CALLS):
    dev = resolve_device(device)
    print(f"[env] {describe(dev)}; {ntgt} targets x {nwalk} walkers, nd={nd}", flush=True)
    fleet, coords, _ = build_fleet(dev, ntgt, nwalk, nd, grid_step)
    routes = trace_routes(fleet, coords, dev, n_calls, n_calls)
    return {"routes": routes, "modes": ablate_k4(fleet, coords, dev)}


if __name__ == "__main__":
    main()
