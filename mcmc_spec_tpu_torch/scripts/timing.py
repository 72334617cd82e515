"""Timing and device labels shared by the experiment scripts."""
from __future__ import annotations

import math
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
