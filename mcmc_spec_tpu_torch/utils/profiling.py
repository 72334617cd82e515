"""Tracing and profiling helpers (port of ``mcmc_spec_tpu.utils.profiling``).

* :class:`StageTimer`: wall-clock stage accounting, the first call of each
  stage (which holds the kernels' build and load) kept apart from the rest.
* :func:`trace`: a context manager around ``torch.profiler`` that exports a
  Chrome trace (``chrome://tracing`` or Perfetto) of the CPU and, where there
  is one, the CUDA activity into ``log_dir``.
* :func:`device_loop_time`: the time of a call without its dispatch: on the
  card ``rep`` calls captured in one CUDA graph and replayed, where JAX runs
  them in one ``lax.fori_loop`` on the device.
* The span recorder (the end of this module): spans at the program's layer
  boundaries, each with its host times and, on the card, CUDA events placed on
  the host's clock; :func:`recording`, :func:`sessions` and :func:`span_table`.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import os
import time
import traceback
from collections import defaultdict
from typing import Callable, Dict

import torch
import torch.autograd.profiler as _autograd_profiler


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


# ---------------------------------------------------------------------------
# Spans at the program's layer boundaries
#
# A span site reads ``ON`` and, while it is false, does nothing more: no object, no
# clock read, no event.
#
#     i = profiling.open_span("eval") if profiling.ON else -1
#     ...
#     if i >= 0:
#         profiling.close_span(i)
#
# The sites: ``chunk``, one per emitted chunk of a sampler (``with chunk(device):`` in
# ``inference/stretch.py`` and ``inference/fleet.py``, the one site that reads the
# profiler's state); ``draws``, a chunk's or a half-step's draws; ``half_step``
# (``stretch._propose_accept``); ``eval``, its log-posterior call, the dispatch and the
# wrapper; ``launch:<counter>``, the ctypes call in ``ops.cuda_kernels._launch``, beside
# ``LAUNCHES``.  Spans record in two cases: inside :func:`recording`, and in a chunk
# that found a ``torch.profiler`` profile recording, whose spans then also enter
# ``record_function("mcmc_spec::<name>")`` and stand in its trace over the device ops.

ON = False  # read at every span site: true while spans record
OPEN, CLOSE = 1, 2  # the device events a span records: at its open, at its close
STARVED_NS = 50_000  # a half-step the card began this soon after its issue found it waiting
KEEP = 4  # the sessions kept
POOL = 4096  # the events a session's first chunk on the card makes ready: ten chunks of 64 steps

_now = time.perf_counter_ns
_sessions: collections.deque = collections.deque(maxlen=KEEP)
_session = None  # the session spans record into
_forced = 0  # the depth of recording() blocks
_annotate = False  # the chunk found a profiler recording
_card = False  # the chunk's work is on the card: spans may record device events
_NULL = contextlib.nullcontext()
_pools: dict = collections.defaultdict(list)  # device -> timing events, each recorded once


def reserve(device, events: int = POOL) -> None:
    """Make ready ``events`` timing events for the spans on ``device`` (a process's pool,
    kept across sessions: a session's events return to it once :meth:`Session.columns`
    has read them).  Each new event is recorded once, so that CUDA creates it now, and
    the card is synchronised.  A session's first chunk on the card calls it; a caller
    that times a profiled chunk from outside calls it first, so that its timing holds
    none of it."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    pool = _pools[device]
    with torch.cuda.device(device):
        for _ in range(events - len(pool)):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            pool.append(ev)
        torch.cuda.synchronize()


def _launch_counts() -> dict:
    from mcmc_spec_tpu_torch.ops import cuda_kernels

    return dict(cuda_kernels.LAUNCHES)


class Session:
    """The spans of one stretch of recording: from a :func:`recording` block's start,
    or from the first chunk that found a profiler recording, to the block's end, the
    first chunk that finds the profiler stopped, or the next session's start.

    One entry a span in each column, in the order the spans opened: ``names``,
    ``parents`` (the enclosing span's index, -1 at the top), ``chunks`` (the sequence
    number of the chunk the span belongs to, -1 outside a chunk), ``host_open`` and
    ``host_close`` (``time.perf_counter_ns``).  Device events come from the process's
    pool, filled to ``events`` at the session's first chunk on the card (:func:`reserve`),
    and stay on the card until :meth:`columns` reads them: nothing of the recorder runs
    between two chunks.  An event recorded after the pool ran dry is made then, on the
    host's path, and counted in ``late_events``.  ``launches``: ``ops.cuda_kernels.LAUNCHES``'s growth over the
    session, once it has ended.  ``rows``: the staging counter of K1's and K5's launches
    in the session, per device (:func:`rows_counter`).
    """

    def __init__(self, profiled: bool, events: int = POOL):
        self.profiled = profiled
        self.pool_size = events
        self.late_events = 0
        self.names, self.parents, self.chunks = [], [], []
        self.host_open, self.host_close = [], []
        self.flags, self.ev_open, self.ev_close = [], [], []
        self.n_chunks = 0
        self.launches: dict = {}
        self.rows: dict = {}  # device -> int64 [3]: D rows staged, D rows read, blocks
        self.closed = False
        self.device = None
        self._launches0 = _launch_counts()
        self._stack, self._chunk, self._rf = [], -1, {}
        self._events, self._ms = [], []  # events in record order; ms after the anchor
        self._done = 0  # the events before this index are read
        self._anchor = None  # (event, host ns)
        self._pool = []  # the process's pool of the session's device
        self._stream = None  # the current stream of the chunk on the card
        self._columns = None

    def _start_card(self, device) -> None:
        """The session's one synchronisation: fill the pool (:func:`reserve`, which
        drains the card), record the anchor and read the host's clock."""
        reserve(device, self.pool_size)
        self._pool = _pools[device]
        with torch.cuda.device(device):
            anchor = torch.cuda.Event(enable_timing=True)
            anchor.record()
            self._anchor = (anchor, _now())
        self.device = device

    def _record(self) -> int:
        if self._pool:
            ev = self._pool.pop()
        else:
            ev = torch.cuda.Event(enable_timing=True)
            self.late_events += 1
        ev.record(self._stream)
        self._events.append(ev)
        self._ms.append(None)
        return len(self._events) - 1

    def _read(self, upto: int) -> None:
        anchor = self._anchor[0]
        for k in range(self._done, upto):
            ev, self._events[k] = self._events[k], None
            self._ms[k] = anchor.elapsed_time(ev)
            self._pool.append(ev)
        self._done = upto

    def _scale(self) -> float:
        """Host ns per device ns: a second anchor on the drained card, now.  The card's
        clock and the host's run at rates that may differ by parts in a million, which
        over a long session would move a late event by tens of microseconds."""
        torch.cuda.synchronize(self.device)
        with torch.cuda.device(self.device):
            end = torch.cuda.Event(enable_timing=True)
            end.record()
        t_end = _now()
        end.synchronize()
        device_ms = self._anchor[0].elapsed_time(end)
        return (t_end - self._anchor[1]) / (device_ms * 1e6) if device_ms > 0 else 1.0

    def columns(self) -> dict:
        """The session as plain columns: ``name``, ``parent``, ``chunk``,
        ``host_open_ns``, ``host_close_ns`` (None while open), ``device_open_ns`` and
        ``device_close_ns`` (the span's events placed on the host's clock: the anchor's
        host time plus the anchor's ``elapsed_time`` to the event, scaled by the rate of
        the two clocks; None where the span recorded none), and ``launches``,
        ``chunks``, ``profiled``, ``clock_scale``, ``late_events``, and ``rows_staged``,
        ``rows_read`` and ``blocks_staged``: the D rows K1's and K5's blocks copied to
        shared memory, the D rows their walkers read from them and the blocks that staged
        (:func:`rows_counter`).  Reading waits for the card to pass the session's events;
        an ended session is read once and its events released."""
        if self._columns is not None:
            return self._columns
        scale = 1.0
        if self._anchor is not None:
            if self._done < len(self._events):
                self._events[-1].synchronize()
                self._read(len(self._events))
            scale = self._scale()
        t0 = self._anchor[1] if self._anchor is not None else 0

        def place(ks):
            return [None if k < 0 else t0 + self._ms[k] * 1e6 * scale for k in ks]

        cols = {"name": list(self.names), "parent": list(self.parents),
                "chunk": list(self.chunks), "host_open_ns": list(self.host_open),
                "host_close_ns": list(self.host_close),
                "device_open_ns": place(self.ev_open), "device_close_ns": place(self.ev_close),
                "launches": dict(self.launches), "chunks": self.n_chunks,
                "profiled": self.profiled, "clock_scale": scale,
                "late_events": self.late_events}
        counts = [t.tolist() for t in self.rows.values()]
        cols["rows_staged"] = sum(c[0] for c in counts)
        cols["rows_read"] = sum(c[1] for c in counts)
        cols["blocks_staged"] = sum(c[2] for c in counts)
        if self.closed:
            self._columns, self._anchor = cols, None
        return cols


def _start(profiled: bool, events: int = POOL) -> Session:
    global _session
    _end()
    _session = Session(profiled, events)
    _sessions.append(_session)
    return _session


def _end() -> None:
    global _session
    s = _session
    if s is None:
        return
    if s._stack:
        close_span(s._stack[0])
    now = _launch_counts()
    s.launches = {k: v - s._launches0.get(k, 0) for k, v in now.items()
                  if v != s._launches0.get(k, 0)}
    s.closed = True
    _session = None


def rows_counter(device):
    """The staging counter of the session that records, on ``device``: an int64 [3] on
    the card that K1 and K5 add to, a block at a time, the D rows it copied to shared
    memory (its union U), the D rows its walkers read from them (the sum of their
    lists) and 1, made at the session's first launch that asks.  None outside a session,
    off the card or while a stream captures a graph."""
    s = _session
    device = torch.device(device)
    if s is None or device.type != "cuda" or torch.cuda.is_current_stream_capturing():
        return None
    rows = s.rows.get(device)
    if rows is None:
        rows = s.rows[device] = torch.zeros(3, dtype=torch.int64, device=device)
    return rows


def open_span(name: str, events: int = 0) -> int:
    """Open a span in the session that records (call only while ``ON``); returns its
    index for :func:`close_span`.  ``events``: ``OPEN`` and/or ``CLOSE``, the device
    events it records in a chunk on the card (elsewhere it records none)."""
    s = _session
    i = len(s.names)
    if _annotate:
        rf = torch.profiler.record_function("mcmc_spec::" + name)
        rf.__enter__()
        s._rf[i] = rf
    s.names.append(name)
    s.parents.append(s._stack[-1] if s._stack else -1)
    s.chunks.append(s._chunk)
    events = events if _card else 0
    s.flags.append(events)
    s.ev_close.append(-1)
    s.host_close.append(None)
    s._stack.append(i)
    s.host_open.append(_now())
    s.ev_open.append(s._record() if events & OPEN else -1)
    return i


def close_span(i: int) -> None:
    """Close span ``i``, and any span opened inside it and left open by an exception."""
    s = _session
    if s is None or i not in s._stack:
        return
    while True:
        j = s._stack.pop()
        if s.flags[j] & CLOSE:
            s.ev_close[j] = s._record()
        s.host_close[j] = _now()
        rf = s._rf.pop(j, None)
        if rf is not None:
            rf.__exit__(None, None, None)
        if j == i:
            return


def chunk(device):
    """The span of one emitted chunk of a sampler: ``with profiling.chunk(device):``.

    Reads whether a ``torch.profiler`` profile records (``torch.autograd.profiler.
    _is_profiler_enabled``, so that with a ``schedule`` only the active steps' chunks
    record).  Where neither it nor a :func:`recording` block records, it returns a
    shared null context, having ended a session that an earlier profile started.  In a
    chunk on the card, the session's first chunk synchronises the card once and records
    the anchor event (:meth:`Session._start_card`)."""
    profiled = _autograd_profiler._is_profiler_enabled
    if not (_forced or profiled):
        if _session is not None:
            _end()
        return _NULL
    return _chunk_span(torch.device(device), profiled)


@contextlib.contextmanager
def _chunk_span(device, profiled: bool):
    global ON, _annotate, _card
    s = _session if _session is not None else _start(profiled=True)
    card = device.type == "cuda" and not torch.cuda.is_current_stream_capturing()
    if card:
        if s._anchor is None:
            s._start_card(device)
        s._stream = torch.cuda.current_stream(device)
    s._chunk, s.n_chunks = s.n_chunks, s.n_chunks + 1
    _annotate, _card, ON = profiled, card, True
    i = open_span("chunk", OPEN | CLOSE)
    try:
        yield
    finally:
        close_span(i)
        s._chunk = -1
        _annotate = _card = False
        ON = bool(_forced)


@contextlib.contextmanager
def recording(events: int = POOL):
    """Record spans inside the block, with or without a profiler: yields the block's
    :class:`Session` (nested blocks share their outermost block's).  ``events``: the
    device events to make at its first chunk on the card, enough for the block's spans
    (a chunk of ``thin`` steps records 6 ``thin`` + 2), so that none is made between
    launches."""
    global _forced, ON
    s = _session if _forced else _start(profiled=False, events=events)
    _forced += 1
    ON = True
    try:
        yield s
    finally:
        _forced -= 1
        if not _forced:
            _end()
            ON = False


def sessions() -> list:
    """The last ``KEEP`` sessions, oldest first (the one that records, if any, last)."""
    return list(_sessions)


def span_table(session) -> dict:
    """Per span name of ``session`` (a :class:`Session` or its :meth:`~Session.columns`):

    * ``count``;
    * ``host_self_ms``: the spans' host time less the part their children cover;
    * ``device_ms``: the time between each span's open and close events on the card, or
      None where no span of the name records both;
    * ``starved`` (``half_step`` only): the half-steps the card began within
      ``STARVED_NS`` of their issue, the session's first left out: the card had run dry;
      ``starved_at_chunk_start``, those of them that are their chunk's first;
    * ``blamed`` and ``blamed_ms``: the starved half-steps whose wait is put down to a
      span of this name, the one with the most self time on the host between the card's
      previous event and the half-step's issue, and that interval's length.  Host time
      inside no span is put down to ``(none)``.
    """
    cols = session.columns() if isinstance(session, Session) else session
    names, parents = cols["name"], cols["parent"]
    t_open, t_close = cols["host_open_ns"], cols["host_close_ns"]
    d_open, d_close = cols["device_open_ns"], cols["device_close_ns"]
    last = max((t for t in t_close if t is not None), default=0)
    t_close = [last if t is None else t for t in t_close]
    rows: dict = {}

    def row(name):
        return rows.setdefault(name, {"count": 0, "host_self_ms": 0.0, "device_ms": None,
                                      "starved": 0, "starved_at_chunk_start": 0,
                                      "blamed": 0, "blamed_ms": 0.0})

    child_ns = [0] * len(names)
    for i, p in enumerate(parents):
        if p >= 0:
            child_ns[p] += t_close[i] - t_open[i]
    for i, name in enumerate(names):
        r = row(name)
        r["count"] += 1
        r["host_self_ms"] += (t_close[i] - t_open[i] - child_ns[i]) * 1e-6
        if d_open[i] is not None and d_close[i] is not None:
            r["device_ms"] = (r["device_ms"] or 0.0) + (d_close[i] - d_open[i]) * 1e-6
    device_events = sorted(t for t in d_open + d_close if t is not None)
    halves = [i for i, n in enumerate(names) if n == "half_step" and d_open[i] is not None]
    first = {}
    for i in halves:
        first.setdefault(cols["chunk"][i], i)
    for i in halves[1:]:
        if d_open[i] - t_open[i] >= STARVED_NS:
            continue
        row("half_step")["starved"] += 1
        row("half_step")["starved_at_chunk_start"] += first[cols["chunk"][i]] == i
        k = bisect.bisect_left(device_events, d_open[i])
        a, b = (device_events[k - 1] if k else t_open[i]), t_open[i]
        culprit = _most_self_time(names, parents, t_open, t_close, a, b)
        r = row(culprit if culprit is not None else "(none)")
        r["blamed"] += 1
        r["blamed_ms"] += max(b - a, 0) * 1e-6
    return rows


def _most_self_time(names, parents, t_open, t_close, a, b):
    """The name of the span with the most self time inside [a, b] on the host's clock,
    or None where the host spent more of it inside no span (or the interval is empty,
    the card having passed its previous event after the issue)."""
    if b <= a:
        return None
    last = bisect.bisect_right(t_open, a) - 1
    cands = []
    j = last
    while j >= 0:  # the spans open at a: the last opened by then and its open ancestors
        if t_close[j] > a:
            cands.append(j)
        j = parents[j]
    cands.extend(range(last + 1, bisect.bisect_left(t_open, b)))
    overlap = {j: max(0, min(t_close[j], b) - max(t_open[j], a)) for j in cands}
    own = dict(overlap)
    outside = b - a
    for j in cands:
        if parents[j] in own:
            own[parents[j]] -= overlap[j]
        else:
            outside -= overlap[j]
    best = max(own, key=own.get, default=None)
    if best is None or own[best] < outside:
        return None
    return names[best]
