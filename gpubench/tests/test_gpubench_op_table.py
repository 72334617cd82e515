"""The benchmark's frozen op table against the program's ``scripts/op_table.py`` on a
recorded trace."""
import json

import pytest

from gpubench.harness import op_table, trace
from mcmc_spec_tpu_torch.scripts import op_table as program_table


def recorded_trace():
    ev = lambda name, cat, ts, dur: {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    return {"traceEvents": [
        ev("aten::empty", "cpu_op", 0.0, 5.0),
        ev("aten::take_along_dim", "cpu_op", 40.0, 30.0),
        ev("log_posterior_fused_kernel", "kernel", 10.0, 20.0),
        ev("log_posterior_fused_kernel", "kernel", 25.0, 10.0),
        ev("Memcpy DtoD", "gpu_memcpy", 50.0, 4.0),
        ev("elementwise_kernel(float)", "kernel", 80.0, 6.0),
        {"ph": "i", "name": "marker", "ts": 3.0},
    ]}


def test_the_copy_reads_as_the_program(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(recorded_trace()))
    ours = op_table.op_table(str(path), n_gaps=10)
    program = program_table.op_table(str(path), n_gaps=10)
    assert {k: v for k, v in ours.items() if k != "span_ms"} == program
    # overlapping launches count once in the busy time: [10, 35) + [50, 54) + [80, 86);
    # the device ops' own span runs from 10 to 86, the trace's from 0
    assert (ours["busy_ms"], ours["device_ms"], ours["window_ms"], ours["span_ms"]) == \
        pytest.approx((35e-3, 40e-3, 86e-3, 76e-3))
    assert [g["host_op"] for g in ours["gaps"]] == ["aten::take_along_dim", "aten::take_along_dim"]


def test_breakdown_lists_ops_and_gaps_in_seconds():
    table = op_table.op_table(recorded_trace(), n_gaps=10)
    b = trace.breakdown(table, table)
    assert b["device_ops"][0] == ["log_posterior_fused_kernel", pytest.approx(30e-6)]
    assert b["idle_gaps"][0] == ["aten::take_along_dim", pytest.approx(26e-6)]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
