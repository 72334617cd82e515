"""Timing and device labels shared by the experiment scripts."""
from __future__ import annotations

import math
import os
import subprocess
import time

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a torch device; a CUDA device without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: torch.cuda.is_available() is false (pass device='cpu' "
                           "to run the plain versions)")
    return dev


def nvidia_smi(query: str) -> str:
    """``nvidia-smi --query-gpu=<query>`` of the first card, as it prints it."""
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0].strip()


def describe(dev: torch.device) -> str:
    """What the times were taken on: the card's name and power limit, or the host."""
    if dev.type == "cuda":
        return nvidia_smi("name,power.limit")
    return "cpu: host-clock times of the plain versions, not device times"


def describe_host() -> str:
    """The host's CPU (vendor and model name, as ``/proc/cpuinfo`` gives them) and core
    counts, for the receipts that time the host alone."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for ln in f:
                key, _, value = ln.partition(":")
                info.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    vendor, model = info.get("vendor_id", "unknown vendor"), info.get("model name", "unknown")
    cpu = f"{vendor}, model name {model}"
    return (f"host: {cpu}, {os.cpu_count()} cores ({len(os.sched_getaffinity(0))} usable); "
            "no card takes part")


def timer(dev: torch.device):
    """``time_fn(fn, n=20, warmup=3, reps=3)``: seconds per call of ``fn()``, the least of
    ``reps`` means over ``n`` calls after ``warmup`` calls.  CUDA events on the card,
    the host clock on the CPU."""

    def time_fn(fn, n=20, warmup=3, reps=3):
        for _ in range(warmup):
            fn()
        best = math.inf
        for _ in range(reps):
            if dev.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(n):
                    fn()
                end.record()
                end.synchronize()
                dt = start.elapsed_time(end) * 1e-3
            else:
                t0 = time.perf_counter()
                for _ in range(n):
                    fn()
                dt = time.perf_counter() - t0
            best = min(best, dt / n)
        return best

    return time_fn


GRAPH_LAUNCHES = 50  # the JAX probes' lax.scan of 50 calls


def graph_timer(dev, n=GRAPH_LAUNCHES):
    """``time_fn(fn, reps=5)``: seconds per call of ``fn()`` with the host out of the way.

    On the card ``fn`` is captured ``n`` times into one CUDA graph, after three
    warm-up calls on a side stream, and the graph is replayed ``reps`` times, each
    replay timed with CUDA events; the least replay over ``n``.  ``fn`` must launch on
    the current stream and must not synchronise.  A wrapper counts its launches at
    capture (``n``) and in the warm-up (3); the ``(reps + 1) * n`` launches of the
    replays pass no wrapper, and ``time_fn.replayed`` sums them.  On the
    CPU the host clock over ``n`` calls of the plain version, as ``timer``.
    """

    def time_fn(fn, reps=5):
        if dev.type != "cuda":
            return timer(dev)(fn, n=n, warmup=1, reps=reps)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(n):
                fn()
        graph.replay()
        torch.cuda.synchronize(dev)
        best = math.inf
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) * 1e-3 / n)
        time_fn.replayed += (reps + 1) * n
        return best

    time_fn.replayed = 0
    return time_fn
