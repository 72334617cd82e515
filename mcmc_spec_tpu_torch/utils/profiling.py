"""Tracing and profiling helpers (port of ``mcmc_spec_tpu.utils.profiling``).

* :class:`StageTimer`: wall-clock stage accounting, the first call of each
  stage (which holds the kernels' build and load) kept apart from the rest.
* :func:`trace`: a context manager around ``torch.profiler`` that exports a
  Chrome trace (``chrome://tracing`` or Perfetto) of the CPU and, where there
  is one, the CUDA activity into ``log_dir``.
* :func:`device_loop_time`: the time of a call without its dispatch: on the
  card ``rep`` calls captured in one CUDA graph and replayed, where JAX runs
  them in one ``lax.fori_loop`` on the device.
"""
from __future__ import annotations

import contextlib
import os
import time
import traceback
from collections import defaultdict
from typing import Callable, Dict

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


class CaptureError(RuntimeError):
    """``fn`` cannot run inside a CUDA graph: an op in it synchronises with the host or
    is otherwise refused during stream capture.  The message names the op."""


def _loop(fn: Callable, a0: torch.Tensor, rest: tuple, rep: int) -> torch.Tensor:
    """``sum_i sum(fn(a0 + 1e-9 i, *rest))`` in float32, JAX's loop body."""
    acc = torch.zeros((), dtype=torch.float32, device=a0.device)
    for i in range(rep):
        acc = acc + fn(a0 + 1e-9 * i, *rest).sum().to(torch.float32)
    return acc


def _blocking_op(exc: BaseException) -> str:
    """Where the capture failed: the innermost frame of the first exception in ``exc``'s
    chain outside torch and this module, as ``file:line: source``, and its message."""
    chain = []
    while exc is not None and exc not in chain:
        chain.append(exc)
        exc = exc.__cause__ or exc.__context__
    first = chain[-1]
    here = os.path.abspath(__file__)
    torch_dir = os.path.dirname(os.path.abspath(torch.__file__))
    frames = [f for f in traceback.extract_tb(first.__traceback__)
              if os.path.abspath(f.filename) != here
              and not os.path.abspath(f.filename).startswith(torch_dir)]
    where = (f"{frames[-1].filename}:{frames[-1].lineno}: {frames[-1].line}" if frames
             else "an op inside torch")
    msg = str(first).strip().splitlines()[0] if str(first).strip() else type(first).__name__
    return f"{where} ({type(first).__name__}: {msg})"


def device_loop_time(fn: Callable, *args, rep: int = 50) -> float:
    """Seconds per call of ``fn(*args)`` without its dispatch cost.

    The counterpart of JAX's ``device_loop_time``: every call sees its first
    argument perturbed, ``a0 + 1e-9 i``, so that no call can be hoisted, and the
    ``rep`` results are summed.  On the card the ``rep`` calls (each with its
    perturbation and sum, a few small launches) are captured in one CUDA graph
    after a warm-up call on a side stream; the graph is replayed once, then
    timed over one replay with CUDA events.  On the CPU: a host loop of the same
    calls, timed by the host clock.

    ``fn`` must return a tensor and must not synchronise with the host: an op
    that does (``int(tensor)``, ``.item()``, a copy to the host) or that draws
    from a generator the graph does not know makes the capture fail, and then
    :class:`CaptureError` names that op.  There is no eager fallback.  Put
    first an argument whose perturbation leaves the work as it is: a blend
    weight perturbed from zero would make the kernels' row build dense.
    """
    a0, rest = args[0], args[1:]
    if a0.device.type != "cuda":
        _loop(fn, a0, rest, 1)  # warm-up
        t0 = time.perf_counter()
        _loop(fn, a0, rest, rep)
        return (time.perf_counter() - t0) / rep
    dev = a0.device
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        _loop(fn, a0, rest, 1)  # warm-up: builds what the calls cache (kernel tables)
    torch.cuda.current_stream(dev).wait_stream(side)
    torch.cuda.synchronize(dev)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            _loop(fn, a0, rest, rep)
    except Exception as exc:  # the capture is invalidated: report the op, time nothing
        torch.cuda.synchronize(dev)
        raise CaptureError(f"device_loop_time: {getattr(fn, '__name__', fn)!s} cannot be "
                           f"captured in a CUDA graph: {_blocking_op(exc)}") from exc
    graph.replay()
    torch.cuda.synchronize(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e-3 / rep
