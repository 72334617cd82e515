"""The device op table of a ``torch.profiler`` trace: a frozen copy of the readers of
``mcmc_spec_tpu_torch/scripts/op_table.py``.

``op_table(source)`` reads a profiler run that has stopped, a Chrome trace file or its
parsed JSON and returns each device op (kernel, memcpy, memset) by name with its
launches and device milliseconds, the ops' summed time, the trace's span, the device
ops' own span (the first op's start to the last op's end), the busy time (the union of
the device ops' intervals, so overlapping ops count once) and the longest idle gaps
between device ops, each with the host op that overlaps it most.  Beyond the copy:
the device ops' span.
"""
from __future__ import annotations


import json
import os
import tempfile


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
    span_us = busy[-1][1] - busy[0][0] if busy else 0.0
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
            "span_ms": span_us * 1e-3, "busy_ms": busy_us * 1e-3,
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
