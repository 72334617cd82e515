"""The command exits with another code than 0 and prints no result where it cannot
measure: without a card (this is how it runs on a machine without one), and in a
directory that holds only BENCHMARK.json and the benchmark's files."""
import shutil
import subprocess
import sys

import pytest

from gpubench.harness import bench

ARGS = ["--workload", "koi2298.stage2", "--seed", "2147483661", "--seconds", "1", "--trace", "0"]


def _run(cwd):
    return subprocess.run([sys.executable, "gpubench/run.py", *ARGS], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run(bench.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_the_benchmark_alone_does_not_run(tmp_path):
    shutil.copy(bench.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(bench.BENCH, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.card
def test_each_cell_runs_correct_on_the_card(card):
    for cell in [w["name"] for w in bench.load_json(bench.ROOT / "BENCHMARK.json")["workloads"]]:
        out = subprocess.run([sys.executable, "gpubench/run.py", "--workload", cell, "--seed",
                              "2147483663", "--seconds", "2", "--trace", "0"], cwd=bench.ROOT,
                             capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-2000:]
        assert '"correct": true' in out.stdout.strip().splitlines()[-1]
