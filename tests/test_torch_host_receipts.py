"""PyTorch port: the host receipts of ``mcmc_spec_tpu_torch/scripts`` against the JAX scripts (CPU).

* ``acl_gate_cost``: the JAX script (``scripts/acl_gate_cost.py``, loaded from
  its file) and the port's on the same chunks give the same gates at both
  cadences and the same ``integrated_time`` values.
* ``fleet_memory_receipt``: the new (streamed) and old (hold and concatenate)
  writer runs on a store of 2 chunks x 8 walkers write the bytes of the JAX
  package's ``stream_fleet_samples`` on the same store; the new run in its own
  process (as the receipt runs it, and without JAX), the old one's program
  in this process.
* ``compile_cache_receipt`` and ``compile_cache_micro``: their child programs
  render, and their parsers read what the children print; one micro arm's
  program runs here on the CPU, where K1's wrapper takes its plain version.
"""
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from mcmc_spec_tpu.fleet_pipeline import stream_fleet_samples as jax_stream  # noqa: E402
from mcmc_spec_tpu.io.results import ChainStore as JaxChainStore  # noqa: E402
from mcmc_spec_tpu_torch.scripts import acl_gate_cost  # noqa: E402
from mcmc_spec_tpu_torch.scripts import compile_cache_micro as micro  # noqa: E402
from mcmc_spec_tpu_torch.scripts import compile_cache_receipt as receipt  # noqa: E402
from mcmc_spec_tpu_torch.scripts import fleet_memory_receipt as fmr  # noqa: E402

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
RECORD_KEYS = {"mode", "n_chunks", "nw", "peak_rss_gb", "import_rss_gb", "writer_rss_gb",
               "wall_s", "writer", "text_gb", "jax_imported"}


def _load(name):
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _recording(fn, log):
    def wrapped(chain, *args, **kwargs):
        out = fn(chain, *args, **kwargs)
        log.append((chain.shape, out.copy()))
        return out
    return wrapped


def test_acl_gate_cost_matches_the_jax_script(monkeypatch):
    jax_script = _load("acl_gate_cost")
    rng = np.random.RandomState(0)
    chunks = [rng.randn(10, 16, 6).astype(np.float32) for _ in range(12)]
    for gated in (True, False):
        logs = {"jax": [], "port": []}
        monkeypatch.setattr(jax_script, "integrated_time",
                            _recording(jax_script.integrated_time, logs["jax"]))
        monkeypatch.setattr(acl_gate_cost, "integrated_time",
                            _recording(acl_gate_cost.integrated_time, logs["port"]))
        _, gates_jax = jax_script.run(chunks, gated)
        _, gates = acl_gate_cost.run(chunks, gated)
        assert gates == gates_jax == (8 if gated else 12)  # gates at 1-6, 8, 10 of 12
        assert [s for s, _ in logs["port"]] == [s for s, _ in logs["jax"]]
        for (_, got), (_, want) in zip(logs["port"], logs["jax"]):
            np.testing.assert_array_equal(got, want)


def test_acl_gate_cost_main_prints_both_cadences(capsys):
    (t_geo, g_geo), (t_every, g_every) = acl_gate_cost.main(12, (10, 16, 6))
    out = capsys.readouterr().out
    assert (g_geo, g_every) == (8, 12) and t_geo > 0 and t_every > 0
    assert "no card takes part" in out and "geometric gating:  8 gates" in out


@pytest.fixture
def store(tmp_path):
    """A store of 2 chunks x 8 walkers, the port's; the JAX script's store is the same."""
    fmr.build_store(tmp_path, 2, 8)
    jax_root = tmp_path / "jax_script"
    _load("fleet_memory_receipt")._build_store(str(jax_root), 2, 8)
    for i in range(2):
        name = f"chunks_8/chunk_{i:05d}.npy"
        np.testing.assert_array_equal(np.load(tmp_path / name), np.load(jax_root / name))
    return tmp_path


def _jax_samples(root, tmp_path):
    """Each target's ``samples.txt`` bytes from the JAX package's writer on the store."""
    dirs = [tmp_path / "jax_out" / f"tgt{t}" for t in range(fmr.NTGT)]
    for d in dirs:
        d.mkdir(parents=True)
    jax_stream(JaxChainStore(str(root), name="chunks_8"), [str(d) for d in dirs], 2, fmr.NDIM,
               return_samples=False)
    return [(d / "samples.txt").read_bytes() for d in dirs]


def _port_samples(root, mode):
    out = fmr.out_dir(root, mode, 2, 8)
    return [(out / f"tgt{t}" / "samples.txt").read_bytes() for t in range(fmr.NTGT)]


def test_fleet_memory_new_path_in_its_own_process(store, tmp_path):
    rec = fmr.run_child("new", store, 2, 8)
    assert set(rec) == RECORD_KEYS
    assert (rec["mode"], rec["n_chunks"], rec["nw"]) == ("new", 2, 8)
    assert rec["writer"] in ("pandas to_csv", "np.savetxt") and rec["jax_imported"] is False
    assert rec["text_gb"] > 0 and rec["peak_rss_gb"] >= rec["import_rss_gb"] > 0
    assert rec["writer_rss_gb"] == pytest.approx(rec["peak_rss_gb"] - rec["import_rss_gb"])
    assert _port_samples(store, "new") == _jax_samples(store, tmp_path)


def test_fleet_memory_old_path_program(store, tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(sys, "path", list(sys.path))
    exec(compile(fmr.child_source("old", store, 2, 8), "<old writer>", "exec"),
         {"__name__": "old_writer"})
    rec = fmr.parse_record(capsys.readouterr().out)
    assert set(rec) == RECORD_KEYS and (rec["mode"], rec["n_chunks"]) == ("old", 2)
    jax = _jax_samples(store, tmp_path)
    assert _port_samples(store, "old") == jax
    assert all(len(b.splitlines()) == 2 * fmr.NTHIN * 8 for b in jax)


def test_compile_cache_receipt_child_renders_and_parses(tmp_path):
    src = receipt.child_source(str(tmp_path / "param_synth.txt"), "cpu")
    compile(src, "<receipt child>", "exec")
    assert "__" + "REPO__" not in src and repr(str(tmp_path / "param_synth.txt")) in src
    assert repr(str(receipt.REPO)) in src and "'--device', 'cpu'" in src.replace('"', "'")
    # the child's own last two lines, as it prints them
    out = (f"[stage 2] ...\n{receipt.LIBRARY}found libmcmc_spec_kernels_0123.so\n"
           f"{receipt.WALL}{12.5!r}\n")
    assert receipt.parse_child(out) == {"library": "found libmcmc_spec_kernels_0123.so",
                                        "child_wall_s": 12.5}
    with pytest.raises(ValueError):
        receipt.parse_child("no result")
    assert receipt.DEPTHS["production"] == dict(nstep=400, nburn=301, nsteps=15001)


def test_compile_cache_micro_arm_on_the_cpu(capsys, monkeypatch):
    """One arm's program here: the plain K1 on 16 bench walkers, in its own gate."""
    src = micro.child_source("cpu", nd=128, nw=16, forbid_nvcc=True, grid_step=16.0)
    assert "__" + "ND__" not in src and "dataclasses.replace(tgt, **{'median_iters': 14" in src
    monkeypatch.setattr(sys, "path", list(sys.path))
    exec(compile(src, "<micro arm>", "exec"), {"__name__": "micro_arm"})
    rec = micro.parse_result(capsys.readouterr().out)
    assert rec["device"] == "cpu" and rec["lib"] is None and rec["built"] is None
    assert rec["walkers"] == 16 and rec["outside"] == 0 and micro.in_gate(rec)
    assert rec["max_rel_err"] == 0.0  # the wrapper is the plain version on the CPU
    for key in ("import_s", "library_s", "first_launch_s"):
        assert rec[key] >= 0
    line = micro.RESULT + json.dumps(dict(rec, outside=1, walkers=1024))
    assert micro.in_gate(micro.parse_result("noise\n" + line))
    assert not micro.in_gate(dict(rec, outside=2, walkers=1024))
