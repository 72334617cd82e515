"""The device op table of a ``torch.profiler`` run: the reader that the attribution
scripts share (counterpart of the xprof readers of ``scripts/trace_fused_call.py:33``,
``scripts/trace_fleet_step.py:48`` and ``scripts/ablate_matrix_traced.py:39``).

``op_table(source)`` reads a profiler run (a ``torch.profiler.profile`` that has
stopped, a Chrome trace file as ``utils.profiling.trace`` writes it, or the trace's
parsed JSON) and returns

* ``kernels``: each device op (kernel, memcpy, memset) by name, with its launches, its
  total and mean device milliseconds and its share of the device time, the largest
  first;
* ``device_ms`` (the ops' summed time), ``window_ms`` (the trace's span, host events
  included), ``busy_ms`` (the union of the device ops' intervals) and ``busy_share``
  (busy over window);
* ``gaps``: the longest idle gaps between device ops, each with its start (ms from
  the window's start), its length and the host op (``cpu_op``) that overlaps it
  most, the innermost on a tie.

``print_table`` prints it as the JAX scripts print theirs; ``trace_calls`` profiles
``n`` calls of a function and returns their table.
"""
from __future__ import annotations

import json
import os
import tempfile

import torch
from torch.profiler import ProfilerActivity, profile, schedule

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CAT = "cpu_op"


def trace_events(source) -> list:
    """The complete ("X") events of a profiler run, a Chrome trace path or its JSON."""
    if hasattr(source, "export_chrome_trace"):
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            source.export_chrome_trace(path)
            with open(path) as f:
                source = json.load(f)
        finally:
            os.unlink(path)
    elif isinstance(source, (str, os.PathLike)):
        with open(source) as f:
            source = json.load(f)
    events = source.get("traceEvents", []) if isinstance(source, dict) else source
    return [e for e in events if e.get("ph") == "X" and "ts" in e]


def _union(intervals):
    """Merged [start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def op_table(source, n_gaps: int = 5) -> dict:
    """The device op table of ``source`` (module docstring); times in milliseconds."""
    events = trace_events(source)
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    host = [e for e in events if e.get("cat") == HOST_CAT]
    ends = [float(e["ts"]) + float(e.get("dur", 0.0)) for e in events]
    t0 = min((float(e["ts"]) for e in events), default=0.0)
    window_us = max(ends, default=0.0) - t0
    totals, counts = {}, {}
    for e in dev:
        totals[e["name"]] = totals.get(e["name"], 0.0) + float(e.get("dur", 0.0))
        counts[e["name"]] = counts.get(e["name"], 0) + 1
    device_us = sum(totals.values())
    kernels = [{"name": name, "launches": counts[name], "total_ms": us * 1e-3,
                "mean_ms": us * 1e-3 / counts[name],
                "share": us / device_us if device_us > 0 else 0.0}
               for name, us in sorted(totals.items(), key=lambda kv: -kv[1])]
    busy = _union((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in dev)
    busy_us = sum(e - s for s, e in busy)
    gaps = sorted(((busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)),
                  key=lambda g: g[0] - g[1])[:n_gaps]
    table_gaps = []
    for s, e in gaps:
        best, best_key = None, None
        for h in host:
            hs, he = float(h["ts"]), float(h["ts"]) + float(h.get("dur", 0.0))
            overlap = min(e, he) - max(s, hs)
            key = (overlap, -(he - hs))
            if overlap > 0 and (best_key is None or key > best_key):
                best, best_key = h, key
        table_gaps.append({"start_ms": (s - t0) * 1e-3, "ms": (e - s) * 1e-3,
                           "host_op": None if best is None else best["name"]})
    return {"kernels": kernels, "device_ms": device_us * 1e-3, "window_ms": window_us * 1e-3,
            "busy_ms": busy_us * 1e-3,
            "busy_share": busy_us / window_us if window_us > 0 else 0.0, "gaps": table_gaps}


def launches(table: dict, name: str) -> int:
    """The launches of the device ops whose name holds ``name``."""
    return sum(k["launches"] for k in table["kernels"] if name in k["name"])


def device_ms(table: dict, name: str) -> float:
    """The summed device milliseconds of the ops whose name holds ``name``."""
    return sum(k["total_ms"] for k in table["kernels"] if name in k["name"])


def short_name(name: str, width: int = 90) -> str:
    """A kernel's name without its argument list, cut to ``width``."""
    return name.split("(")[0][:width] if "(" in name else name[:width]


def print_table(table: dict, title: str, top: int = 15, per: int = 1) -> None:
    """Print ``table`` (``op_table``), the ``top`` largest ops; ``per`` divides the totals
    into per-call times (the calls the trace holds)."""
    print(f"[{title}] device op time {table['device_ms']:.4f} ms ({table['device_ms'] / per:.4f} "
          f"ms a call over {per}), busy {table['busy_ms']:.4f} of {table['window_ms']:.4f} ms "
          f"({100 * table['busy_share']:.1f} %)", flush=True)
    for k in table["kernels"][:top]:
        print(f"    {k['total_ms']:9.4f} ms  x{k['launches']:<5d} {k['mean_ms']:8.4f} ms each "
              f"{100 * k['share']:5.1f} %  {short_name(k['name'])}", flush=True)
    for g in table["gaps"]:
        print(f"    idle {g['ms']:.4f} ms at {g['start_ms']:.3f} ms: host op {g['host_op']}",
              flush=True)


def trace_calls(fn, n: int = 20, warmup: int = 1) -> dict:
    """``op_table`` of ``n`` back-to-back calls of ``fn()`` under ``torch.profiler`` (the
    card synchronised before and after), after ``warmup`` calls.  The profiler runs a
    warm-up cycle of one call before the recorded one: without it the first launches of
    a window can be missing from the trace.  On the CPU the table holds no device op."""
    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    for _ in range(warmup):
        fn()
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    tables = []
    with profile(activities=activities, schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: tables.append(op_table(p))) as prof:
        fn()
        sync()
        prof.step()  # the warm-up cycle ends; the recorded one begins
        for _ in range(n):
            fn()
        sync()
        prof.step()  # the recorded cycle ends: on_trace_ready reads it
    return tables[0]
