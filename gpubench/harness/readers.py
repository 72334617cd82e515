"""What the metric readers of ``gpubench/metrics/`` share.  A reader returns None where
its run has nothing to read (no trace, or no launch of its kernels in the trace): the
harness then leaves the metric out of the line.  ``run.trace`` is the op table of the
traced chunks with the card's activity alone (``harness/trace.py``), ``run.window`` the
window's chunks, steps, evaluations and seconds by the host's clock and by the card's."""
from __future__ import annotations

from gpubench.harness.counts import PEAK_F32_PER_S


def rate(run):
    """Every evaluation of the window over the window's whole time."""
    return run.window["evals"] / run.window["seconds"]


def roofline(run, names):
    """The least time the card needs for the evaluations that the traced launches of the
    kernels ``names`` carry, over those kernels' device time, in %.  ``names[0]`` is the
    kernel launched once per evaluation launch (a half-step's batch)."""
    if not _traced(run):
        return None
    ops = [k for k in run.trace["kernels"] if any(n in k["name"] for n in names)]
    launches = sum(k["launches"] for k in ops if names[0] in k["name"])
    device_s = sum(k["total_ms"] for k in ops) * 1e-3
    if launches == 0 or device_s <= 0:
        return None
    least, _ = run.counts.least_seconds(launches * run.half_batch, launches, run.ndim)
    return 100.0 * least / device_s


def eval_mfu(run):
    """The operations the window's evaluations need over its time at the float32 peak."""
    return 100.0 * rate(run) * run.counts.eval_ops() / PEAK_F32_PER_S


def _traced(run):
    """True where the run has a trace with device ops in it."""
    return run.trace is not None and bool(run.trace["kernels"]) and run.trace["span_ms"] > 0


def idle(run):
    """The card's idle share of the window, on the card's clock: 1 - the busy time a step
    in the trace (the union of the device ops' intervals; the traced chunks launch the
    window's ops) times the window's steps, over the window's time between two CUDA
    events recorded around it.  The trace's own span is not used: the profiler's host
    time per launch stretches it, and the window's host is near its limit."""
    if not _traced(run):
        return None
    busy_s = run.trace["busy_ms"] * 1e-3 / run.trace_steps * run.window["steps"]
    return 100.0 * (1.0 - busy_s / run.window["device_seconds"])


def launches_per_step(run):
    if not _traced(run):
        return None
    return sum(k["launches"] for k in run.trace["kernels"]) / run.trace_steps
