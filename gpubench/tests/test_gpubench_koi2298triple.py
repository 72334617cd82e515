"""The configuration ``koi2298triple`` and its cell as committed, on the CPU at a small
size (nd 400, the grid at 8 A, 48 walkers; the cut is this test's, not the files'):
koi2298's configuration with a third star, its inputs, the port's plain K1 against the
reference, a short chain judged through the harness, and the reader of
``union_rows_per_block`` on hand-made columns of the program's staging counter."""
import numpy as np
import pytest
import torch

from gpubench.drivers.packing import pack
from gpubench.harness import bench, inputs, spans
from gpubench.reference import posterior
from gpubench.tests.test_gpubench_faults import run_resolved
from mcmc_spec_tpu_torch.ops import cuda_kernels as ck

CPU = torch.device("cpu")
SPEC = bench.load_json(bench.ROOT / "BENCHMARK.json")
CELL = "koi2298triple.stage2"
SMALL = dict(walkers=48, nd=400, grid_step=8.0)
# the keys in which the triple differs from koi2298's configuration
THIRD_STAR = {"name", "source", "deployment", "assumed", "nspec", "truth", "walker_cloud",
              "contrast_filters", "targets"}


@pytest.fixture(scope="module")
def triple():
    cfg = bench.resolve(SPEC, CELL)["cfg"]
    return cfg, inputs.make_inputs(cfg, SMALL, 7, CPU)


def test_the_configuration_is_koi2298s_with_a_third_star():
    cfg = bench.resolve(SPEC, CELL)["cfg"]
    binary = bench.load_json(bench.BENCH / "configs" / "koi2298.json")
    assert cfg["nspec"] == 3 and cfg["reduced"] == []
    assert len(cfg["truth"]) == len(cfg["walker_cloud"]) == 2 * cfg["nspec"] + 2
    filters = cfg["contrast_filters"]
    assert len(filters) == 4 and filters[:2] == filters[2:] == binary["contrast_filters"]
    assert cfg["targets"] == [{"nd": 1792, "n_contrast": 4}]
    assert set(binary["assumed"]) < set(cfg["assumed"])
    assert {k for k in set(cfg) | set(binary) if cfg.get(k) != binary.get(k)} == THIRD_STAR


def test_the_inputs_are_made_by_make_target(triple):
    cfg, m = triple
    (inp, ref), = m["targets"]
    assert ref["nspec"] == inp["nspec"] == 3 and len(ref["data"]) == SMALL["nd"]
    assert len(ref["cmag"]) == 4 and len(ref["pmag"]) == len(cfg["phot_filters"])
    assert tuple(m["walkers"].shape) == (1, SMALL["walkers"], 8)
    # the observed contrasts are the reference's forward model at truth plus noise: the
    # two companions, one in each half of the list, differ by more than the noise
    c, _ = posterior.forward_bands(np.asarray(cfg["truth"]), ref)
    assert not np.allclose(c[:2], c[2:], atol=0.1)
    assert np.abs(ref["cmag"] - c).max() < 5 * cfg["contrast_noise"]


def test_k1s_plain_version_agrees_with_the_reference(triple, clean_env):
    cfg, m = triple
    bench.set_env(cfg, {})
    (inp, ref), = m["targets"]
    P = m["walkers"][0]
    dials = cfg["dials"]
    lp_prog = ck.log_posterior_fused_reference(P, pack(inp, CPU))
    lp_ref = posterior.log_posterior(P, posterior.tables(ref, CPU), dials["median_iters"],
                                     dials["recip_newton"])
    fin = torch.isfinite(lp_ref)
    assert torch.equal(fin, torch.isfinite(lp_prog)) and int(fin.sum()) >= 40
    gap = (lp_prog.double() - lp_ref.double())[fin].abs()
    assert float(gap.median()) < 1e-4 and float(gap.max()) < 1e-3


def test_a_short_chain_is_judged_correct(monkeypatch, clean_env, plain_dials):
    res = bench.resolve(SPEC, CELL)
    res["cell"] = {**res["cell"], **SMALL, "chunk": 16}
    numbers, correct = run_resolved(res, "sound", CPU, monkeypatch)
    assert correct and numbers["_judged"] == SMALL["walkers"] + SMALL["walkers"] // 2, numbers


def _reader():
    return bench.load_module(bench.BENCH / "metrics" / "union_rows_per_block.py",
                             "reader_union_rows_per_block")


@pytest.mark.parametrize("counter,want", [
    ({"rows_staged": 0, "rows_read": 0}, None),  # a program without the blocks' slot
    ({"rows_staged": 720, "rows_read": 5000}, None),
    ({"rows_staged": 0, "rows_read": 0, "blocks_staged": 0}, None),  # nothing staged
    ({"rows_staged": 720, "rows_read": 5000, "blocks_staged": 48}, 15.0),
    ({"rows_staged": 1000, "rows_read": 12288, "blocks_staged": 64}, 15.625)])
def test_the_reader_is_rows_staged_over_blocks_staged(counter, want, monkeypatch):
    reader = _reader()
    assert reader.per_block(counter) == want
    monkeypatch.setattr(spans, "session", lambda: {"name": [], **counter})
    assert reader.read(None) == want
    monkeypatch.setattr(spans, "session", lambda: None)
    assert reader.read(None) is None
