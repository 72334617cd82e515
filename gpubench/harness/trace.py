"""The traced segment of a ``--trace 1`` run, after the window: ``torch.profiler`` over
``TRACE_CHUNKS`` of the window's own chunks with the card's activity alone, so that the
profiler's host-side recording of every op does not stretch the card's timeline (the
metrics, ``busy_s`` and ``window_s`` read this table), then over one more chunk with the
host's ops too (the breakdown's idle gaps, each named by the host op under it).  Each
profile starts with a warm-up cycle of one chunk: without it the first launches of a
trace can be missing.  Eight chunks make the busy time a chunk a mean over ~0.5 s,
which a record the profiler drops (a few in 16,500, seen) moves by well under 1 %."""
from __future__ import annotations

import torch
from torch.profiler import ProfilerActivity, profile, schedule

from gpubench.harness.op_table import op_table, short_name

N_GAPS = 10
TRACE_CHUNKS = 8


def _profile(chunk, n: int, activities) -> dict:
    """The op table of ``n`` back-to-back calls of ``chunk()``, the card synchronised
    before and after."""
    tables = []
    with profile(activities=activities, schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: tables.append(op_table(p, n_gaps=N_GAPS))) as prof:
        chunk()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(n):
            chunk()
        torch.cuda.synchronize()
        prof.step()
    return tables[0]


def trace_chunks(chunk) -> tuple:
    """(the card's table over ``TRACE_CHUNKS`` chunks, the table with host ops over one)."""
    device = _profile(chunk, TRACE_CHUNKS, [ProfilerActivity.CUDA])
    host = _profile(chunk, 1, [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    return device, host


def breakdown(device: dict, host: dict) -> dict:
    """The ten device ops that took most time (the card's table) and the ten longest idle
    gaps by the host op under each (the table with host ops), in seconds."""
    return {
        "device_ops": [[short_name(k["name"]), k["total_ms"] * 1e-3]
                       for k in device["kernels"][:N_GAPS]],
        "idle_gaps": [[g["host_op"] or "none", g["ms"] * 1e-3] for g in host["gaps"]],
    }
