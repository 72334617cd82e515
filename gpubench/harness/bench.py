"""One run of one cell of ``BENCHMARK.json`` (the command in ``gpubench/README.md``).

Set-up, timed as ``setup_s`` from the process's start: CUDA's start, the kernel
library (built into ``gpubench/.cache/kernels`` on a checkout's first run, loaded from
there after; the build's seconds are also reported apart, as ``build_s``), the inputs
from ``--seed``, the program's target or fleet, and ``WARMUP_CHUNKS`` chunks of the
window's own call.  The window then repeats that call, a chunk of ``chunk`` stretch
steps, until ``--seconds`` have passed, and synchronises the card: a closed loop as fast
as the card goes.  With ``--trace 1`` a traced segment follows the window
(``harness/trace.py``).  Once the window has closed the peak memory is read, the
program's state is freed and the reference judges the final ensemble
(``harness.check``).  The result is the last line of standard output; the numbers
compared, beside their limits, are the last lines of standard error.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "gpubench"
CACHE = BENCH / ".cache"
PROGRAM = "mcmc_spec_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "mcmc_spec_tpu")
# the program's settings the harness fixes: the configuration's dials, the cell's route
DIAL_ENV = {"median_iters": "MCMC_SPEC_FAST_MEDIAN", "recip_newton": "MCMC_SPEC_FAST_RECIP",
            "matmul_passes": "MCMC_SPEC_MATMUL_PASSES"}
ROUTE_ENV = ("MCMC_SPEC_FUSED_EVAL", "MCMC_SPEC_RAD_SIGMA_FRAC")
WARMUP_CHUNKS = 1
CARD_FIELDS = "name,power.limit,clocks.max.sm"
CLOCK_FIELDS = "clocks.sm,temperature.gpu,power.draw,clocks_throttle_reasons.active"


class BenchError(RuntimeError):
    pass


def parse(argv):
    ap = argparse.ArgumentParser(prog="gpubench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def resolve(spec: dict, workload: str) -> dict:
    """The cell's entry, its configuration entry, both files and its metrics."""
    entry = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise BenchError(f"no workload {workload!r} in BENCHMARK.json")
    config = next(c for c in spec["configs"] if c["name"] == entry["config"])
    lists = lambda m: "workloads" not in m or workload in m["workloads"]
    return {"entry": entry, "config": config,
            "cfg": load_json(ROOT / config["file"]),
            "cell": load_json(BENCH / "workloads" / f"{workload}.json"),
            "end_to_end": [m for m in spec["end_to_end"] if lists(m)],
            "per_layer": [m for m in spec["per_layer"] if lists(m)]}


def set_env(cfg: dict, cell: dict) -> None:
    """Fixed cache directories inside the checkout, the dials, the route."""
    for var, sub in (("MCMC_SPEC_COMPILE_CACHE", "kernels"), ("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    for dial, var in DIAL_ENV.items():
        os.environ[var] = str(cfg["dials"][dial])
    for var in ROUTE_ENV:
        os.environ.pop(var, None)
    os.environ.update(cell.get("env", {}))


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def card_query(fields: str) -> str:
    """``nvidia-smi``'s first line for the comma-separated ``fields``, or "unknown"."""
    out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "unknown"


class Run:
    """What the metric readers (``gpubench/metrics/<name>.py``) read."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def execute(args, res: dict, device, t_start: float, log=print) -> dict:
    """Set-up, window, trace and check of one run; returns the result's parts."""
    import torch

    from gpubench.harness import counts, inputs, trace

    cfg, cell = res["cfg"], res["cell"]
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    program = __import__(PROGRAM)
    if not Path(program.__file__).resolve().is_relative_to(ROOT):
        raise BenchError(f"{PROGRAM} was imported from {program.__file__}, outside {ROOT}")
    from mcmc_spec_tpu_torch.ops import cuda_kernels
    from mcmc_spec_tpu_torch.runtime import cuda_build

    build_s = 0.0
    if cuda:
        t0 = time.perf_counter()
        built = not cuda_build.library_path().exists()
        cuda_build.load()
        if built:
            build_s = time.perf_counter() - t0
        log(f"[setup] kernel library {'built' if built else 'loaded'} in "
            f"{time.perf_counter() - t0:.3f} s from {cuda_build.build_dir()}")
    t0 = time.perf_counter()
    made = inputs.make_inputs(cfg, cell, args.seed, device)
    log(f"[setup] inputs in {time.perf_counter() - t0:.3f} s")
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    driver = load_module(BENCH / "drivers" / f"{cell['driver']}.py",
                         f"gpubench_driver_{cell['driver']}").build(cell, cfg, made, device)
    for _ in range(WARMUP_CHUNKS):
        driver.chunk()
    sync()
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    events = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if cuda else []
    if cuda:
        events[0].record()
    marks = [t_window]
    while marks[-1] - t_window < args.seconds:
        driver.chunk()
        marks.append(time.perf_counter())
    if cuda:
        events[1].record()
    sync()
    seconds = time.perf_counter() - t_window
    chunks = len(marks) - 1
    window = {"chunks": chunks, "steps": chunks * driver.steps_per_chunk,
              "evals": chunks * driver.evals_per_chunk, "seconds": seconds,
              "device_seconds": events[0].elapsed_time(events[1]) * 1e-3 if cuda else None}
    gaps = sorted(b - a for a, b in zip(marks, marks[1:]))
    log(f"[window] {chunks} chunks of {driver.steps_per_chunk} steps, {window['evals']} "
        f"evaluations in {seconds:.6f} s; the host's time a chunk min {gaps[0]:.4f} median "
        f"{gaps[len(gaps) // 2]:.4f} max {gaps[-1]:.4f} s; on the card's clock "
        f"{window['device_seconds']!r} s")
    if cuda:
        log(f"[window] after it: {card_query(CLOCK_FIELDS)} ({CLOCK_FIELDS})")

    table = host_table = None
    trace_steps = trace.TRACE_CHUNKS * driver.steps_per_chunk
    if args.trace:
        cuda_kernels.reset_launches()
        table, host_table = trace.trace_chunks(driver.chunk)
        busy_step = table["busy_ms"] * 1e-3 / trace_steps
        log(f"[trace] {trace.TRACE_CHUNKS} chunks with the card's activity alone, then one "
            f"with the host's ops (each after a warm-up chunk): the program's launch counter "
            f"{dict((k, v) for k, v in cuda_kernels.LAUNCHES.items() if v)}; the card's "
            f"trace: {sum(k['launches'] for k in table['kernels'])} device ops, busy "
            f"{table['busy_ms']:.4f} of the ops' span {table['span_ms']:.4f} ms; the trace "
            f"with host ops: busy {host_table['busy_ms']:.4f} of {host_table['span_ms']:.4f} "
            f"ms; cross-check, the busy time a step against the window's host-clock time a "
            f"step: idle {100.0 * (1.0 - busy_step * window['steps'] / seconds):.3f} %")
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    ndim = driver.final()[0].shape[-1]
    outputs = chain_outputs(driver, device, cfg["stretch_a"])
    half_batch = driver.half_batch
    del driver
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    numbers = judge(outputs, made, cfg, device)
    log(f"[check] {numbers['_judged']} log-posteriors judged in {time.perf_counter() - t0:.3f} s"
        f": largest gap {numbers['_gap_max']!r}, {numbers['_updates_wrong']} updates decided "
        f"otherwise, {numbers['_unmoved']} walkers unmoved in the last chunk")

    ref0 = made["targets"][0][1]
    run = Run(setup_s=setup_s, build_s=build_s, window=window, trace=table,
              host_trace=host_table, ndim=ndim, half_batch=half_batch, trace_steps=trace_steps,
              counts=counts.Counts([(len(ref["data"]), len(ref["cmag"]), len(ref["pmag"]))
                                    for _, ref in made["targets"]],
                                   cfg["nspec"], ref0["D"].shape[0], len(ref0["mist_teff"]),
                                   cfg["dials"]["median_iters"]))
    return {"run": run, "numbers": numbers, "peak": peak, "attempted": numbers["_judged"],
            "failed": numbers["nonfinite_mismatch"]}


def chain_outputs(driver, device, a) -> dict:
    """What the check judges of a driver's chain once its window has closed (copies)."""
    coords, log_prob = (x.detach().clone() for x in driver.final())
    last_eval = driver.last_eval()
    ntgt, nw, _ = coords.shape
    return {"coords": coords, "log_prob": log_prob,
            "start": driver.chunk_start.detach().reshape(coords.shape).clone(),
            "draws": last_draws(driver.chunk_state, device, driver.layout,
                                driver.steps_per_chunk, ntgt, nw, a),
            "last_eval": None if last_eval is None else tuple(x.detach().clone()
                                                              for x in last_eval)}


def judge(outputs: dict, made: dict, cfg: dict, device) -> dict:
    """The check's numbers for ``outputs`` on the reference's tables of ``made``."""
    from gpubench.harness import check
    from gpubench.reference import posterior

    tables = [posterior.tables(ref, device) for _, ref in made["targets"]]
    return check.judge(outputs, tables, cfg["dials"])


def last_draws(state, device, layout, thin, ntgt, nw, a):
    """The draws of the second half's update in the last step of the chunk that began
    with the generator in ``state``: z, partner, log_u, each [ntgt, nw - nw//2]."""
    from gpubench.reference import sampler

    gen = sampler.generator_at(state, device)
    if layout == "single":
        z, idx, log_u = sampler.draws(gen, thin, nw // 2, a)
        return z[-1, 1][None], idx[-1, 1][None], log_u[-1, 1][None]
    z, (_, idx1), log_u = sampler.fleet_draws(gen, thin, ntgt, nw, a)
    return z[-1, 1], idx1[-1], log_u[-1, 1]


def read_metrics(run, metrics: list) -> dict:
    out = {}
    for m in metrics:
        value = load_module(BENCH / "metrics" / f"{m['name']}.py",
                            "gpubench_metric_" + m["name"].replace(".", "_")).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv, t_start: float) -> int:
    args = parse(argv)
    res = resolve(load_json(ROOT / "BENCHMARK.json"), args.workload)
    set_env(res["cfg"], res["cell"])
    import torch

    chips = res["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gpubench: the cell needs {chips} CUDA card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count() {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    log = lambda msg: print(msg, file=sys.stderr, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    from gpubench.harness.counts import PEAK_BYTES_PER_S, PEAK_F32_PER_S

    log(f"[device] {card_query(CARD_FIELDS)} ({CARD_FIELDS}); torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; peaks {PEAK_F32_PER_S:.3g} FLOP/s float32, "
        f"{PEAK_BYTES_PER_S:.3g} B/s (H100 SXM)")
    out = execute(args, res, device, t_start, log)
    metrics = read_metrics(out["run"], res["per_layer"] if args.trace else res["end_to_end"])
    limits = res["cell"]["limits"]
    from gpubench.harness.check import NAMES, verdict

    numbers = out["numbers"]
    correct = verdict(numbers, limits)
    found = forbidden_modules()
    if found:
        print(f"gpubench: modules that must not load in this process: {found}", file=sys.stderr)
        return 3
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics,
              "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                         "count": chips, "memory_peak_bytes": out["peak"]}}
    run = out["run"]
    if args.trace:
        from gpubench.harness.trace import breakdown

        result["device"]["busy_s"] = run.trace["busy_ms"] * 1e-3
        result["device"]["window_s"] = run.trace["span_ms"] * 1e-3
        result["breakdown"] = breakdown(run.trace, run.host_trace)
    result["build_s"] = run.build_s
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]} for k in NAMES}
    for k in NAMES:
        print(f"check {k} {numbers[k]!r} limit {limits[k]!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0

