"""PyTorch port: the span recorder of ``utils/profiling`` at the samplers' layer
boundaries (CPU; one test on the card).

Tiny stage-2 and fleet chains of the JAX suite's small binary target
(``testing.make_setup``): recording is off by default and then costs no clock read,
no session and no event; the chains are bit for bit the same with it on; one chunk's
span tree; ``run(8) == run(4) + run(4)`` while recording; under ``torch.profiler``
with the benchmark's ``schedule(wait=0, warmup=1, active=1)`` only the active step's
chunks record, and the Chrome trace holds the spans as ``user_annotation`` ranges;
``span_table``'s arithmetic on a hand-made session.  The ``card`` test (skipped
without a CUDA card; on the card ``python -m pytest --noconftest
tests/test_torch_tracing.py -m card``, as this file imports no JAX) holds the
``launch`` spans' device times.
"""
import collections
import json

import pytest

torch = pytest.importorskip("torch")

from mcmc_spec_tpu_torch import testing  # noqa: E402
from mcmc_spec_tpu_torch.inference import fleet, stretch  # noqa: E402
from mcmc_spec_tpu_torch.inference.batched import log_posterior_batch  # noqa: E402
from mcmc_spec_tpu_torch.utils import profiling  # noqa: E402

NW = 8
US = 1000  # ns


@pytest.fixture(scope="module")
def target():
    setup, tgt = testing.make_setup()
    return torch.as_tensor(setup["p_truth"], dtype=torch.float64), tgt


def _walkers(p, shape, seed):
    g = torch.Generator().manual_seed(seed)
    return p + 1e-3 * p.abs() * torch.randn(*shape, p.shape[0], generator=g, dtype=p.dtype)


def _stage2(target, nw=NW):
    p, tgt = target
    lp = lambda b: log_posterior_batch(b, tgt)
    state = stretch.init_ensemble(_walkers(p, (nw,), 0), lp, torch.Generator().manual_seed(1))
    return lambda n, thin, st=None: stretch.run_ensemble(st or state, lp, n, thin=thin), state


def _fleet(target):
    p, tgt = target
    fl = fleet.stack_targets([tgt, tgt])
    state = fleet.init_fleet_ensemble(_walkers(p, (2, NW), 2), fl, torch.Generator().manual_seed(3))
    return lambda n, thin, st=None: fleet.run_fleet_ensemble(st or state, fl, n, thin=thin), state


def _fresh(state):
    """A copy of ``state`` with its own generator at the same point."""
    gen = torch.Generator(device=state.coords.device).set_state(state.generator.get_state())
    return stretch.EnsembleState(state.coords.clone(), state.log_prob.clone(), gen,
                                 state.n_accept.clone())


CHAINS = {"stage2": _stage2, "stage2_odd": lambda t: _stage2(t, NW + 1), "fleet": _fleet}


def _same(a, b):
    (sa, ca, la), (sb, cb, lb) = a, b
    assert torch.equal(sa.coords, sb.coords) and torch.equal(sa.log_prob, sb.log_prob)
    assert torch.equal(ca, cb) and torch.equal(la, lb)
    assert torch.equal(sa.n_accept, sb.n_accept)
    assert torch.equal(sa.generator.get_state(), sb.generator.get_state())


@pytest.mark.parametrize("chain", CHAINS)
def test_off_by_default_records_nothing(target, chain, monkeypatch):
    run, state = CHAINS[chain](target)
    clock_reads = []
    monkeypatch.setattr(profiling, "_now", lambda: clock_reads.append(1) or 0)
    monkeypatch.setattr(profiling, "Session", None)  # a session would raise
    before = profiling.sessions()
    assert not profiling.ON and profiling.chunk("cpu") is profiling.chunk("cpu")
    run(4, 2, _fresh(state))
    assert profiling.sessions() == before and not clock_reads and not profiling.ON


@pytest.mark.parametrize("chain", CHAINS)
def test_chains_are_bit_for_bit_with_recording_on(target, chain):
    run, state = CHAINS[chain](target)
    off = run(6, 3, _fresh(state))
    with profiling.recording() as session:
        on = run(6, 3, _fresh(state))
    _same(off, on)
    assert session.closed and session.n_chunks == 2 and not profiling.ON


@pytest.mark.parametrize("chain", ["stage2", "fleet"])
def test_span_tree_of_a_chunk(target, chain):
    run, state = CHAINS[chain](target)
    thin = 3
    with profiling.recording() as s:
        run(2 * thin, thin, _fresh(state))
    counts = collections.Counter(zip(s.names, s.chunks))
    for c in (0, 1):
        assert counts[("chunk", c)] == 1 and counts[("draws", c)] == 1
        assert counts[("half_step", c)] == counts[("eval", c)] == 2 * thin
    for i, (name, parent) in enumerate(zip(s.names, s.parents)):
        want = {"chunk": -1, "draws": "chunk", "half_step": "chunk", "eval": "half_step"}[name]
        assert (parent == -1) if want == -1 else s.names[parent] == want
        if parent >= 0:
            assert s.chunks[parent] == s.chunks[i]
            assert s.host_open[parent] <= s.host_open[i] <= s.host_close[i] <= s.host_close[parent]
    evals = [i for i, n in enumerate(s.names) if n == "eval"]
    assert all(s.names[s.parents[i]] == "half_step" for i in evals)
    assert len({s.parents[i] for i in evals}) == len(evals)  # one eval a half-step
    cols = s.columns()
    assert cols["device_open_ns"] == [None] * len(s.names) and cols["chunks"] == 2


@pytest.mark.parametrize("chain", ["stage2", "fleet"])
def test_split_run_equals_whole_while_recording(target, chain):
    run, state = CHAINS[chain](target)
    with profiling.recording():
        whole = run(8, 4, _fresh(state))
        st, c1, l1 = run(4, 4, _fresh(state))
        st, c2, l2 = run(4, 4, st)
    _same(whole, (st, torch.cat([c1, c2]), torch.cat([l1, l2])))


def test_the_profilers_state_is_the_flag_chunk_reads():
    """``chunk`` reads ``torch.autograd.profiler._is_profiler_enabled``: true only while
    a profile records (torch 2.11 on the card, 2.13 here)."""
    from torch.profiler import ProfilerActivity, profile

    assert torch.autograd.profiler._is_profiler_enabled is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert torch.autograd.profiler._is_profiler_enabled is True
    assert torch.autograd.profiler._is_profiler_enabled is False


def test_profiler_schedule_records_only_the_active_step(target, tmp_path):
    from torch.profiler import ProfilerActivity, profile, schedule

    run, state = _stage2(target)
    holder = [_fresh(state)]

    def chunk():
        holder[0] = run(2, 2, holder[0])[0]

    before = profiling.sessions()
    path = tmp_path / "trace.json"
    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(str(path))) as prof:
        chunk()  # the warm-up step: the profiler does not record
        prof.step()
        chunk()
        chunk()
        prof.step()
    chunk()  # finds the profiler stopped: ends the session
    new = [s for s in profiling.sessions() if s not in before]
    assert len(new) == 1 and new[0].profiled and new[0].closed and new[0].n_chunks == 2
    assert not profiling.ON
    events = json.loads(path.read_text())["traceEvents"]
    notes = collections.Counter(e["name"] for e in events if e.get("cat") == "user_annotation")
    assert notes["mcmc_spec::chunk"] == 2 and notes["mcmc_spec::half_step"] == 8
    assert notes["mcmc_spec::eval"] == 8 and notes["mcmc_spec::draws"] == 2


def test_chrome_trace_of_utils_trace_holds_the_spans(target, tmp_path):
    run, state = _fleet(target)
    with profiling.trace(str(tmp_path)):
        run(2, 2, _fresh(state))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"mcmc_spec::chunk", "mcmc_spec::draws", "mcmc_spec::half_step",
            "mcmc_spec::eval"} <= names


def test_a_span_left_open_by_an_exception_is_closed_with_its_parent(target):
    p, tgt = target
    calls = []

    def lp(b):
        calls.append(1)
        if len(calls) > 1:
            raise RuntimeError("planted")
        return log_posterior_batch(b, tgt)

    state = stretch.init_ensemble(_walkers(p, (NW,), 0), lambda b: log_posterior_batch(b, tgt),
                                  torch.Generator().manual_seed(1))
    with profiling.recording() as s:
        with pytest.raises(RuntimeError, match="planted"):
            stretch.run_ensemble(state, lp, 2, thin=2)
        assert profiling.ON and not s._stack
    assert None not in s.host_close and not profiling.ON
    assert s.names.count("eval") == 2 and s.names.count("chunk") == 1


def test_nested_blocks_share_a_session_and_sessions_are_kept():
    with profiling.recording() as outer:
        with profiling.recording() as inner:
            i = profiling.open_span("x")
            profiling.close_span(i)
        assert inner is outer and profiling.ON
    assert outer.closed and outer.names == ["x"] and outer.launches == {}
    for _ in range(profiling.KEEP):
        with profiling.recording():
            pass
    assert outer not in profiling.sessions() and len(profiling.sessions()) == profiling.KEEP


def _columns(spans):
    """Hand-made columns: (name, parent, host open, host close, device open, device
    close), times in microseconds."""
    cols = {k: [] for k in ("name", "parent", "chunk", "host_open_ns", "host_close_ns",
                            "device_open_ns", "device_close_ns")}
    for name, parent, ho, hc, do, dc in spans:
        for k, v in zip(cols, (name, parent, 0, ho * US, hc * US,
                               None if do is None else do * US,
                               None if dc is None else dc * US)):
            cols[k].append(v)
    return cols


# One chunk of two steps: the card keeps pace in the first, runs dry in the second
# (its previous event at 620 us, the host issuing half-step 3 at 900 us after 250 us
# in the draws-free gap of the chunk and 20 us in eval).
SESSION = _columns([
    ("chunk", -1, 0, 1000, 5, 1100),                 # 0
    ("half_step", 0, 10, 100, 300, None),            # 1: the first, left out
    ("eval", 1, 20, 90, None, None),                 # 2
    ("launch:k", 2, 30, 80, 310, 500),               # 3
    ("half_step", 0, 110, 200, 520, None),           # 4: waits 410 us: kept pace
    ("eval", 4, 120, 190, None, None),               # 5
    ("launch:k", 5, 130, 180, 530, 600),             # 6
    ("half_step", 0, 210, 300, 605, None),           # 7: 395 us
    ("eval", 7, 220, 290, None, None),               # 8
    ("launch:k", 8, 230, 280, 610, 620),             # 9
    ("half_step", 0, 900, 990, 930, None),           # 10: 30 us: starved
    ("eval", 10, 910, 930, None, None),              # 11
    ("launch:k", 11, 915, 925, 940, 1000),           # 12
])


def test_span_table_self_time_device_time_and_starved():
    table = profiling.span_table(SESSION)
    assert {n: r["count"] for n, r in table.items()} == {
        "chunk": 1, "half_step": 4, "eval": 4, "launch:k": 4}
    assert table["chunk"]["host_self_ms"] == pytest.approx((1000 - 4 * 90) * 1e-3)
    assert table["eval"]["host_self_ms"] == pytest.approx((3 * (70 - 50) + (20 - 10)) * 1e-3)
    assert table["launch:k"]["device_ms"] == pytest.approx((190 + 70 + 10 + 60) * 1e-3)
    assert table["chunk"]["device_ms"] == pytest.approx(1.095)
    assert table["half_step"]["device_ms"] is None
    assert table["half_step"]["starved"] == 1
    # [620, 900] us on the host: inside the chunk alone, outside every child
    assert table["chunk"]["blamed"] == 1 and table["chunk"]["blamed_ms"] == pytest.approx(0.28)
    assert sum(r["blamed"] for r in table.values()) == 1
    assert table["half_step"]["starved_at_chunk_start"] == 0


def test_span_table_counts_the_starved_half_steps_at_a_chunks_start():
    """Half-step 10 made the first of a second chunk: its wait falls at a chunk's start."""
    cols = {k: list(v) for k, v in SESSION.items()}
    cols["chunk"] = [0] * 10 + [1] * 3
    table = profiling.span_table(cols)
    assert table["half_step"]["starved"] == table["half_step"]["starved_at_chunk_start"] == 1


def test_span_table_puts_the_wait_on_the_span_with_most_self_time():
    spans = [list(s) for s in zip(*(SESSION[k] for k in (
        "name", "parent", "host_open_ns", "host_close_ns", "device_open_ns",
        "device_close_ns")))]
    # a draws span inside [620, 900] us that covers 200 of its 280 us
    spans.insert(10, ["draws", 0, 650 * US, 850 * US, None, None])
    spans = [(n, p + (p >= 10), a / US, b / US, None if c is None else c / US,
              None if d is None else d / US) for n, p, a, b, c, d in spans]
    table = profiling.span_table(_columns(spans))
    assert table["draws"]["blamed"] == 1 and table["draws"]["blamed_ms"] == pytest.approx(0.28)
    assert table["chunk"]["blamed"] == 0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the H100 "
                    "(python -m pytest --noconftest tests/test_torch_tracing.py -m card)")
    return torch.device("cuda", 0)


@pytest.mark.card
def test_launch_spans_carry_device_times_after_the_anchor(card, tmp_path):
    from mcmc_spec_tpu_torch.bench_target import build_bench_target, init_walker_batch

    tgt, truth = build_bench_target(torch.float32, device=card, nd=256, grid_step=8.0)
    lp = lambda b: log_posterior_batch(b, tgt)
    state = stretch.init_ensemble(init_walker_batch(tgt, truth, 1024), lp,
                                  torch.Generator(device=card).manual_seed(0))
    off = stretch.run_ensemble(_fresh(state), lp, 8, thin=4)
    with profiling.recording() as s:
        t0 = profiling._now()
        on = stretch.run_ensemble(_fresh(state), lp, 8, thin=4)
    _same(off, on)
    cols = s.columns()
    assert cols["late_events"] == 0  # 8 x 6 + 2 x 2 events from the pool
    assert len(profiling._pools[card]) >= profiling.POOL  # read, they went back to it
    launches = [i for i, n in enumerate(cols["name"]) if n == "launch:log_posterior_fused"]
    assert len(launches) == 16 == s.launches["log_posterior_fused"]
    for i in launches:
        a, b = cols["device_open_ns"][i], cols["device_close_ns"][i]
        assert t0 < a < b and b - a < 50e6
    halves = [i for i, n in enumerate(cols["name"]) if n == "half_step"]
    assert all(cols["device_open_ns"][i] is not None for i in halves)
    assert all(cols["device_close_ns"][i] is None for i in halves)
    table = profiling.span_table(s)
    assert table["launch:log_posterior_fused"]["device_ms"] > 0
    assert table["chunk"]["device_ms"] > table["launch:log_posterior_fused"]["device_ms"]
    with profiling.trace(str(tmp_path)):  # the spans over the device ops in a Chrome trace
        stretch.run_ensemble(on[0], lp, 4, thin=4)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    notes = collections.Counter(e["name"] for e in events if e.get("cat") == "user_annotation")
    assert notes["mcmc_spec::chunk"] == 1 and notes["mcmc_spec::half_step"] == 8
    assert notes["mcmc_spec::eval"] == notes["mcmc_spec::launch:log_posterior_fused"] == 8
    assert sum("log_posterior_fused" in e["name"] for e in events if e.get("cat") == "kernel") == 8


def test_span_receipt_runs_on_the_cpu(tmp_path):
    """The receipt's arms and its JSON record at a tiny size (host-clock times of the
    plain versions: no device numbers)."""
    from mcmc_spec_tpu_torch.scripts import span_receipt

    out = tmp_path / "receipt.json"
    res = span_receipt.main(device="cpu", seconds=0.01, windows=1, cells=("stage2",),
                            out=str(out), stage2=dict(nwalk=8, nd=128, grid_step=16.0))
    runs = res["stage2"]["runs"]
    assert res["stage2"]["same_chains"] and [r["arm"] for r in runs] == list(span_receipt.ARMS)
    recorded = {r["arm"]: r for r in runs if "steps" in r}
    assert set(recorded) == {"recording", "profiler"}  # profiler_alone records nothing
    for r in recorded.values():
        assert r["kernel_ms"] is None and r["eval_host_ms"] > 0 and r["late_events"] == 0
        assert r["steps"] == span_receipt.CHUNK * (r["chunks"] + 1)  # and the untimed first
        assert r["rows_staged"] == r["rows_read"] == r["blocks_staged"] == 0  # no counter
    assert res["stage2"]["kernel_vs_profiler"] is None  # no device time on the CPU
    assert res["costs"] == {} and json.loads(out.read_text())["stage2"]["same_chains"]
