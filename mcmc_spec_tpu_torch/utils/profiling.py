"""Tracing and profiling helpers (port of ``mcmc_spec_tpu.utils.profiling``).

* :class:`StageTimer`: wall-clock stage accounting, the first call of each
  stage (which holds the kernels' build and load) kept apart from the rest.
* :func:`trace`: a context manager around ``torch.profiler`` that exports a
  Chrome trace (``chrome://tracing`` or Perfetto) of the CPU and, where there
  is one, the CUDA activity into ``log_dir``.

JAX's ``device_loop_time`` has no counterpart: the port times kernels with
CUDA events and ``torch.profiler`` (``chip_smoke.py``).
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch


class StageTimer:
    """Accumulates wall-clock per named stage; the first hit is counted apart."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.first: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if name not in self.first:
                self.first[name] = dt  # includes the build and first launch
            else:
                self.totals[name] += dt
                self.counts[name] += 1

    def report(self) -> str:
        lines = ["stage                     first(s)   steady(ms/call)   calls"]
        for name in self.first:
            n = self.counts[name]
            steady = self.totals[name] / n * 1e3 if n else float("nan")
            lines.append(f"{name:24s} {self.first[name]:9.2f} {steady:17.3f} {n:7d}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str, name: str = "trace.json"):
    """Profile the block with ``torch.profiler`` and write ``log_dir/name``, a Chrome
    trace; yields the profiler (``key_averages()`` and the like)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, name))
