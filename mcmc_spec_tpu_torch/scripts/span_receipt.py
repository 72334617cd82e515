"""What the span recorder of ``utils/profiling`` costs and reads, on the benchmark's two
stage-2 workloads and a host-bound one.

The cells: ``bench_target``'s stage 2 (32,768 walkers at nd = 1,792, K1), the fused
fleet of nine ragged targets (``chip_smoke.build_fleet``'s: nd = 1,792 - 48 i, 2
contrasts for even i and 1 for odd i, padded to (1,792, 2); 9 x 4,096 walkers on K5
under ``MCMC_SPEC_FUSED_EVAL=1``) and stage 2 at 4,096 walkers, where the host sets the
pace; each a closed loop of chunks of 64 steps (``thin = 64``) after a warm-up chunk,
as the benchmark's window runs them.  First the recorder's primitives (``costs``: host
microseconds a call, and the card's microseconds an event adds after a small kernel).
Then in each cell the chains with recording off and on from the same state, compared
bit for bit over two chunks, and ``windows`` rounds of a window of ``seconds`` an arm,
in turns (the 4,096-walker cell without the profiler's arms):

* ``off``: recording off (the production path: one flag read a span site);
* ``recording``: inside ``profiling.recording()``, no profiler;
* ``profiler_alone``: under ``torch.profiler`` with the card's activity alone, the
  chunks kept from seeing it, so that nothing records;
* ``profiler``: the same profiler with the recorder recording too, as it does in the
  benchmark's traced segment.

A recording window's session holds a pool of events sized from the round's ``off``
window, and its first chunk runs before the timing starts.  Each window prints its
evaluations a second by the host's clock (the card synchronised at its end) and, where
it records, its ``span_table`` a step: the kernels' and the chunks' time between their
events on the card, the sampler's (the difference), the ``eval`` spans' host self time
(the dispatch and the wrapper), the starved half-steps and how many fall at a chunk's
start, the two clocks' rate (``clock_scale``) and the events made after the pool ran
dry, and the staging counter of K1 and K5 (``rows_staged / rows_read``: the D rows
their blocks copied to shared memory over the D rows their walkers read, and
``rows_staged / blocks_staged``: the D rows a block staged); in the
profiler's windows, the profiler's own device time a step of the cell's kernel.  Each cell then prints what each arm costs against ``off``, the recorder's own
host time a step under the profiler (``profiler`` against ``profiler_alone``), the
``recording`` windows' kernel time against the profiler's (within 3 %), and the last
recording window's ``span_table``; with ``--out`` a JSON record of every window.  The
benchmark's own numbers (``gpubench/harness/spans.py``) are its ``--trace 1`` run's.

    python -m mcmc_spec_tpu_torch.scripts.span_receipt [--seconds 30] [--windows 3] [--out F]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import time
import types
from unittest import mock

import torch

from mcmc_spec_tpu_torch.bench_target import build_bench_target, init_walker_batch
from mcmc_spec_tpu_torch.inference import fleet as fleet_mod
from mcmc_spec_tpu_torch.inference.batched import log_posterior_batch
from mcmc_spec_tpu_torch.inference.stretch import EnsembleState, init_ensemble, run_ensemble
from mcmc_spec_tpu_torch.scripts.timing import describe, resolve_device
from mcmc_spec_tpu_torch.utils import profiling

ARMS = ("off", "recording", "profiler_alone", "profiler")
CHUNK = 64
NWALK = 32768
NTGT, NW_FLEET = 9, 4096
NWALK_SMALL = 4096  # the host sets the pace: the recorder's host cost shows in evals/s
KERNELS = {"stage2": "log_posterior_fused_kernel", "fleet": "log_posterior_fleet_fused_kernel",
           "stage2_small": "log_posterior_fused_kernel"}
TOLERANCE = 0.03  # the spans' kernel time against the profiler's


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def stage2_cell(dev, nwalk=NWALK, nd=1792, grid_step=1.0):
    """(the window's chunk, the state holder, evaluations a chunk) of stage 2."""
    tgt, truth = build_bench_target(torch.float32, device=dev, nd=nd, grid_step=grid_step)
    lp = lambda b: log_posterior_batch(b, tgt)
    holder = [init_ensemble(init_walker_batch(tgt, truth, nwalk), lp,
                            torch.Generator(device=dev).manual_seed(0))]

    def chunk():
        holder[0] = run_ensemble(holder[0], lp, CHUNK, thin=CHUNK)[0]

    return chunk, holder, CHUNK * nwalk


def fleet_cell(dev, ntgt=NTGT, nw=NW_FLEET, nd=1792, grid_step=1.0):
    """The same for the fused fleet (``chip_smoke.build_fleet``'s targets)."""
    members, singles = [], []
    for i in range(ntgt):
        kw = dict(nd=nd - 48 * i, seed=i, n_contrast=2 if i % 2 == 0 else 1,
                  grid_step=grid_step)
        members.append(build_bench_target(torch.float32, device=dev, pad_nd=nd, pad_nc=2,
                                          **kw)[0])
        single, truth = build_bench_target(torch.float32, device=dev, **kw)
        singles.append(single)
    fl = fleet_mod.stack_targets(members)
    coords = torch.stack([init_walker_batch(t, truth, nw, seed=1 + i)
                          for i, t in enumerate(singles)])
    holder = [fleet_mod.init_fleet_ensemble(coords, fl, torch.Generator(device=dev).manual_seed(0))]

    def chunk():
        holder[0] = fleet_mod.run_fleet_ensemble(holder[0], fl, CHUNK, thin=CHUNK)[0]

    return chunk, holder, CHUNK * ntgt * nw


def readings(session) -> dict:
    """A session's ``span_table`` a step: the ``launch`` spans' and the ``chunk`` spans'
    time between their events on the card (``kernel_ms``, ``chunk_ms``; ``sampler_ms``
    the difference), the ``eval`` spans' host self time (``eval_host_ms``), the starved
    half-steps (of those the card timed, the first left out) and how many of them are
    their chunk's first, the two clocks' rate and the events made after the pool ran dry."""
    cols = session.columns()
    table = profiling.span_table(cols)
    steps = cols["name"].count("half_step") / 2
    timed = sum(n == "half_step" and t is not None
                for n, t in zip(cols["name"], cols["device_open_ns"]))

    def per_step(ms):
        return None if ms is None or not steps else ms / steps

    launch = [r["device_ms"] for n, r in table.items() if n.startswith("launch:")]
    kernel = per_step(sum(launch)) if launch and None not in launch else None
    chunk = per_step(table["chunk"]["device_ms"]) if "chunk" in table else None
    half = table.get("half_step", {})
    return {"steps": steps, "kernel_ms": kernel, "chunk_ms": chunk,
            "sampler_ms": None if kernel is None or chunk is None else chunk - kernel,
            "eval_host_ms": per_step(table["eval"]["host_self_ms"]) if "eval" in table else None,
            "starved": half.get("starved", 0), "timed_half_steps": timed,
            "starved_pct": 100.0 * half.get("starved", 0) / (timed - 1) if timed > 1 else None,
            "starved_at_chunk_start": half.get("starved_at_chunk_start", 0),
            "clock_scale": cols["clock_scale"], "late_events": cols["late_events"],
            "rows_staged": cols["rows_staged"], "rows_read": cols["rows_read"],
            "blocks_staged": cols["blocks_staged"],
            "_table": table}


def _ratio(r) -> str:
    """``rows_staged / rows_read`` and ``rows_staged / blocks_staged`` of a window, each
    "none" where no block counted."""
    read = f"{r['rows_staged'] / r['rows_read']:.4f}" if r["rows_read"] else "none"
    block = f"{r['rows_staged'] / r['blocks_staged']:.4f}" if r["blocks_staged"] else "none"
    return f"{read}; {block} a block"


def events_a_chunk(session) -> float:
    """The device events a chunk of ``session`` recorded."""
    cols = session.columns()
    n = sum(t is not None for t in cols["device_open_ns"] + cols["device_close_ns"])
    return n / max(cols["chunks"], 1)


def _clone(state: EnsembleState) -> EnsembleState:
    gen = torch.Generator(device=state.coords.device).set_state(state.generator.get_state())
    return EnsembleState(state.coords.clone(), state.log_prob.clone(), gen,
                         state.n_accept.clone())


def same_chains(chunk, holder):
    """Two chunks with recording off and two with it on, from one state: (bit for bit?,
    the recording's session)."""
    start, ends = holder[0], []
    for arm in ("off", "recording"):
        holder[0] = _clone(start)
        with profiling.recording() if arm == "recording" else contextlib.nullcontext() as s:
            chunk()
            chunk()
        ends.append(holder[0])
    a, b = ends
    return (torch.equal(a.coords, b.coords) and torch.equal(a.log_prob, b.log_prob)
            and torch.equal(a.n_accept, b.n_accept)
            and torch.equal(a.generator.get_state(), b.generator.get_state())), s


def profiler_kernel_ms(prof, kernel: str) -> float | None:
    """The profiler's device time of the kernels named ``kernel``, in ms, from its raw
    records (``key_averages`` would build an object for each of a window's ~10^6)."""
    ns = [e.duration_ns() for e in prof.profiler.kineto_results.events() if kernel in e.name()]
    return sum(ns) * 1e-6 if ns else None


def window(chunk, dev, seconds: float, arm: str, kernel: str, events: int) -> dict:
    """One window of ``arm``: chunks for ``seconds``, the card synchronised at the end.
    Where the arm records, a session with a pool of ``events`` and one chunk before the
    timing starts (the pool and the anchor are made at the session's first chunk, as in
    the benchmark's traced segment)."""
    from torch.profiler import ProfilerActivity, profile

    activity = ProfilerActivity.CUDA if dev.type == "cuda" else ProfilerActivity.CPU
    with contextlib.ExitStack() as stack:
        prof = (stack.enter_context(profile(activities=[activity]))
                if arm.startswith("profiler") else None)
        if arm == "profiler_alone":  # the chunks do not see the profiler: no spans
            stack.enter_context(mock.patch.object(
                profiling, "_autograd_profiler", types.SimpleNamespace(_is_profiler_enabled=False)))
        session = (stack.enter_context(profiling.recording(events))
                   if arm in ("recording", "profiler") else None)
        if session is not None:
            chunk()
        _sync(dev)
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < seconds:
            chunk()
            n += 1
        _sync(dev)
        dt = time.perf_counter() - t0
    out = {"arm": arm, "chunks": n, "seconds": dt}
    if session is not None:
        t1 = time.perf_counter()
        out.update(readings(session))
        out["read_s"] = time.perf_counter() - t1
    if prof is not None:
        t1 = time.perf_counter()
        ms = profiler_kernel_ms(prof, kernel)
        steps = (n + (session is not None)) * CHUNK
        out["profiler_kernel_ms"] = None if ms is None else ms / steps
        out["profiler_read_s"] = time.perf_counter() - t1
    return out


def _fmt(v, spec=".4f"):
    return "None" if v is None else format(v, spec)


def print_table(table: dict, top: int = 8) -> None:
    rows = sorted(table.items(), key=lambda kv: -kv[1]["host_self_ms"])[:top]
    print(f"  {'span':32s} {'count':>8s} {'host self ms':>13s} {'device ms':>11s} "
          f"{'starved':>8s} {'at start':>9s} {'blamed':>7s} {'blamed ms':>10s}")
    for name, r in rows:
        print(f"  {name:32s} {r['count']:8d} {r['host_self_ms']:13.3f} "
              f"{_fmt(r['device_ms'], '11.3f'):>11s} {r['starved']:8d} "
              f"{r['starved_at_chunk_start']:9d} {r['blamed']:7d} {r['blamed_ms']:10.3f}")


def costs(dev, n=20000, k=400) -> dict:
    """The recorder's primitives on the card: host microseconds a call (``n`` calls), and
    the card's microseconds a small kernel takes alone and with a timing event after it
    (``k`` of each, queued behind a long sleep so that the host's pace does not enter)."""
    if dev.type != "cuda":
        return {}

    def per_call(fn, m=n):
        t0 = time.perf_counter_ns()
        for _ in range(m):
            fn()
        return (time.perf_counter_ns() - t0) / m * 1e-3

    stream = torch.cuda.current_stream(dev)
    pool = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    for ev in pool:
        ev.record()
    torch.cuda.synchronize(dev)
    out = {"clock_us": per_call(profiling._now),
           "current_stream_us": per_call(lambda: torch.cuda.current_stream(dev))}
    it = iter(pool)
    out["record_us"] = per_call(lambda: next(it).record())
    it = iter(pool)
    out["record_stream_us"] = per_call(lambda: next(it).record(stream))
    torch.cuda.synchronize(dev)
    it = iter(pool)
    out["query_us"] = per_call(lambda: next(it).query())
    it = iter(pool)
    out["elapsed_time_us"] = per_call(lambda: pool[0].elapsed_time(next(it)))
    with profiling.recording():
        out["span_host_us"] = per_call(lambda: profiling.close_span(profiling.open_span("x")))
        with profiling.chunk(dev):
            both = profiling.OPEN | profiling.CLOSE
            out["span_card_us"] = per_call(
                lambda: profiling.close_span(profiling.open_span("x", both)), 1000)
    x = torch.zeros(1024, device=dev)

    def device_us(events):
        torch.cuda.synchronize(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)
        start.record(stream)
        for i in range(k):
            x.add_(1.0)
            if events:
                pool[i].record(stream)
        end.record(stream)
        end.synchronize()
        return start.elapsed_time(end) * 1e3 / k

    device_us(True)
    out["card_kernel_us"], out["card_kernel_and_event_us"] = device_us(False), device_us(True)
    return out


def _median(runs, arm, key):
    vals = [r[key] for r in runs if r["arm"] == arm and r.get(key) is not None]
    return statistics.median(vals) if vals else None


def run_cell(name, build, dev, seconds, windows, arms=ARMS) -> dict:
    t0 = time.perf_counter()
    chunk, holder, evals = build(dev)
    chunk()  # warm-up
    _sync(dev)
    print(f"[{name}] built and warmed up in {time.perf_counter() - t0:.1f} s; "
          f"{evals} evaluations a chunk", flush=True)
    same, session = same_chains(chunk, holder)
    per_chunk = events_a_chunk(session)
    print(f"[{name}] two chunks with recording off and on from one state: "
          f"{'bit for bit' if same else 'DIFFER'}; {per_chunk:.0f} device events a chunk",
          flush=True)
    runs, events, last = [], profiling.POOL, None
    for w in range(windows):
        for arm in arms:
            r = window(chunk, dev, seconds, arm, KERNELS[name], events)
            r["evals_per_s"] = r["chunks"] * evals / r["seconds"]
            r["step_ms"] = 1e3 * r["seconds"] / (r["chunks"] * CHUNK)
            if arm == "off":  # the next recording windows' pool: a quarter more chunks
                events = int(per_chunk * (r["chunks"] * 5 // 4 + 4))
            line = (f"[{name} {arm} {w}] {r['chunks']} chunks in {r['seconds']:.3f} s: "
                    f"{r['evals_per_s']:.1f} evals/s, {r['step_ms']:.4f} ms a step")
            if "steps" in r:
                line += (f"; a step: kernels {_fmt(r['kernel_ms'])} chunk "
                         f"{_fmt(r['chunk_ms'])} sampler {_fmt(r['sampler_ms'])} eval host "
                         f"{_fmt(r['eval_host_ms'])} ms; starved {r['starved']} of "
                         f"{r['timed_half_steps']} half-steps ({_fmt(r['starved_pct'], '.3f')} "
                         f"%), {r['starved_at_chunk_start']} at a chunk's start; clock scale "
                         f"{r['clock_scale']!r}; {r['late_events']} late events (read in "
                         f"{r['read_s']:.2f} s); D rows staged / read, blocks "
                         f"{r['rows_staged']} / {r['rows_read']}, {r['blocks_staged']} "
                         f"({_ratio(r)})")
                table = r.pop("_table")
                if arm == "recording":
                    last = table
            if "profiler_kernel_ms" in r:
                line += (f"; the profiler's kernel {_fmt(r['profiler_kernel_ms'])} ms a step "
                         f"(read in {r['profiler_read_s']:.1f} s)")
            print(line, flush=True)
            runs.append(r)
    if last is not None:
        print(f"[{name}] span_table of the last recording window:")
        print_table(last)
    off = _median(runs, "off", "evals_per_s")
    for arm in arms:
        rate = _median(runs, arm, "evals_per_s")
        print(f"[{name} {arm}] median {rate:.1f} evals/s over {windows} windows "
              f"({100 * (rate / off - 1):+.2f} % against off), "
              f"{_median(runs, arm, 'step_ms'):.4f} ms a step", flush=True)
    result = {"same_chains": same, "events_a_chunk": per_chunk, "runs": runs}
    if "profiler" in arms:
        alone, both = _median(runs, "profiler_alone", "step_ms"), _median(runs, "profiler", "step_ms")
        spans, prof = _median(runs, "recording", "kernel_ms"), _median(runs, "profiler", "profiler_kernel_ms")
        ratio = None if spans is None or prof is None else spans / prof - 1.0
        within = ratio is not None and abs(ratio) <= TOLERANCE
        result.update(recorder_ms_under_profiler=both - alone, kernel_vs_profiler=ratio)
        print(f"[{name}] under the profiler the recorder adds {both - alone:.4f} ms a step "
              f"({alone:.4f} -> {both:.4f}); the recording windows' kernels "
              f"{_fmt(spans)} ms a step against the profiler's {_fmt(prof)}: "
              f"{_fmt(None if ratio is None else 100 * ratio, '+.3f')} % "
              f"({'within' if within else 'OUTSIDE'} {100 * TOLERANCE:.0f} %)", flush=True)
    return result


def main(device="cuda", seconds=30.0, windows=3, cells=("stage2", "fleet", "stage2_small"),
         out=None, arms=ARMS, **sizes):
    dev = resolve_device(device)
    print(f"[env] {describe(dev)}; torch {torch.__version__}", flush=True)
    result = {"costs": costs(dev)}
    print(f"[costs] {result['costs']}", flush=True)
    builders = {"stage2": lambda d: stage2_cell(d, **sizes.get("stage2", {})),
                "fleet": lambda d: fleet_cell(d, **sizes.get("fleet", {})),
                "stage2_small": lambda d: stage2_cell(
                    d, **{"nwalk": NWALK_SMALL, **sizes.get("stage2_small", {})})}
    saved = os.environ.get("MCMC_SPEC_FUSED_EVAL")
    try:
        for name in cells:
            if name == "fleet":
                os.environ["MCMC_SPEC_FUSED_EVAL"] = "1"
            else:
                os.environ.pop("MCMC_SPEC_FUSED_EVAL", None)
            result[name] = run_cell(name, builders[name], dev, seconds, windows,
                                    arms if name != "stage2_small" else arms[:2])
    finally:
        if saved is None:
            os.environ.pop("MCMC_SPEC_FUSED_EVAL", None)
        else:
            os.environ["MCMC_SPEC_FUSED_EVAL"] = saved
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump({"device": describe(dev), **result}, f, indent=1)
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--cells", default="stage2,fleet,stage2_small")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    main(seconds=args.seconds, windows=args.windows, cells=tuple(args.cells.split(",")),
         out=args.out)
