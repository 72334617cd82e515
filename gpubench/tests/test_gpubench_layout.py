"""BENCHMARK.json against its contract, and every name in it against its files."""
import json
import re
import shutil

import pytest

from gpubench.harness import bench

SPEC = bench.load_json(bench.ROOT / "BENCHMARK.json")
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]
CELLS = [w["name"] for w in SPEC["workloads"]]


def _text_ok(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert 1 <= len(SPEC["paths"]) <= 16 and 1 <= len(SPEC["command"]) <= 32
    for p in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and (bench.ROOT / p).is_dir()
    for word in SPEC["command"]:
        assert _text_ok(word) and not word.startswith("/") and ".." not in word
    assert len((bench.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert all(w["chips"] in (1, 4) for w in SPEC["workloads"]) and four <= max(1, len(CELLS) // 4)


def test_entries_have_just_their_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16 and all(NAME.fullmatch(k) for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


@pytest.mark.parametrize("name", [x["name"] for x in SPEC["configs"] + SPEC["workloads"] + METRICS]
                         + [w["config"] for w in SPEC["workloads"]]
                         + [w["traffic"] for w in SPEC["workloads"]])
def test_names_use_the_allowed_characters(name):
    assert NAME.fullmatch(name)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_units_and_texts(metric):
    assert UNIT.fullmatch(metric["unit"]) and metric["better"] in ("lower", "higher")
    if "layer" in metric:
        assert _text_ok(metric["layer"])


def test_texts_are_one_short_line():
    for x in SPEC["configs"] + SPEC["workloads"]:
        assert _text_ok(x["why"])
    for c in SPEC["configs"]:
        assert _text_ok(c["source"])


def test_names_are_unique():
    for group in (SPEC["configs"], SPEC["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    assert len({(w["config"], w["traffic"]) for w in SPEC["workloads"]}) == len(CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_to_its_files(cell):
    res = bench.resolve(SPEC, cell)
    assert res["cell"]["config"] == res["entry"]["config"]
    assert (bench.BENCH / "drivers" / f"{res['cell']['driver']}.py").is_file()
    assert set(res["cell"]["limits"]) == {"lp_gap_median", "outside_share", "nonfinite_mismatch"}
    assert res["cell"]["limits"]["nonfinite_mismatch"] == 0
    reported = {m["name"] for m in res["end_to_end"]}
    assert "setup_s" in reported and len(reported) >= 2 and res["per_layer"]
    for m in res["per_layer"]:
        assert m["moves"] in reported


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_every_config_has_its_file(config):
    assert config["file"].startswith("gpubench/")
    cfg = bench.load_json(bench.ROOT / config["file"])
    assert cfg["name"] == config["name"] and cfg["source"] == config["source"]
    assert cfg["reduced"] == config["reduced"] and cfg["assumed"]
    assert sum(c["file"] == config["file"] for c in SPEC["configs"]) == 1
    assert any(w["config"] == config["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_every_metric_has_its_reader(metric):
    mod = bench.load_module(bench.BENCH / "metrics" / f"{metric['name']}.py", "reader")
    assert callable(mod.read)
    if "moves" in metric:
        assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}
        moved = next(m for m in SPEC["end_to_end"] if m["name"] == metric["moves"])
        for cell in metric.get("workloads", CELLS):
            assert cell in CELLS and cell in moved.get("workloads", CELLS)


def test_a_new_cell_file_is_picked_up(tmp_path):
    """A later PR adds a cell as a file and an entry; no existing file changes."""
    shutil.copytree(bench.BENCH, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    spec = json.loads((bench.ROOT / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "koi2298.small_ensemble", "config": "koi2298",
                              "traffic": "small_ensemble", "chips": 1, "why": "4,096 walkers"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = json.loads((bench.BENCH / "workloads" / "koi2298.stage2.json").read_text())
    cell["walkers"] = 4096
    (tmp_path / "gpubench" / "workloads" / "koi2298.small_ensemble.json").write_text(
        json.dumps(cell))
    copy = bench.load_module(tmp_path / "gpubench" / "harness" / "bench.py", "bench_copy")
    assert copy.ROOT == tmp_path
    res = copy.resolve(copy.load_json(tmp_path / "BENCHMARK.json"), "koi2298.small_ensemble")
    assert res["cell"]["walkers"] == 4096 and res["cfg"]["name"] == "koi2298"
    assert [m["name"] for m in res["end_to_end"]] == ["setup_s"]
