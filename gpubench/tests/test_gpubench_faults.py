"""A run of each cell of ``BENCHMARK.json`` past the harness's look for a card, with the
timed path broken underneath: sound, it comes out correct; broken, not correct.  On the
CPU at a small size that follows from the cell's driver, and on the card at the cell's
own size.  The faults a sampler cell can have: a
step that returns its state unchanged; half of the batch left out (the first half's
answers stand in for the rest); an answer altered where it is produced; and every
proposal accepted, whatever the accept test says.  (One card: no exchange between
cards to leave out.)"""
import pytest
import torch

from gpubench.harness import bench, check
from mcmc_spec_tpu_torch.inference import batched, fleet, stretch

SPEC = bench.load_json(bench.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in SPEC["workloads"]]
# the CPU's sizes of a cell, by the driver its file names
CPU_SIZES = {"stage2": dict(walkers=96, chunk=16, nd=300, grid_step=8.0),
             "fleet": dict(walkers=48, chunk=16, grid_step=8.0)}


def cpu_sizes(cell: str) -> dict:
    return CPU_SIZES[bench.resolve(SPEC, cell)["cell"]["driver"]]


def _unchanged(state, *args, **kwargs):
    return state, None, None


def _half_batch(fn):
    def evaluate(p, *args, **kwargs):
        m = p.shape[-2]
        first = fn(p[..., : (m + 1) // 2, :], *args, **kwargs)
        return torch.cat([first, first[..., : m // 2]], dim=-1)
    return evaluate


def _altered(fn):
    def evaluate(p, *args, **kwargs):
        out = fn(p, *args, **kwargs).clone()
        out[..., ::8] += 1.0
        return out
    return evaluate


def _always_accept(fn):
    def update(cur, lp_cur, other, z, idx, log_u, log_prob_fn):
        return fn(cur, lp_cur, other, z, idx, torch.full_like(log_u, -float("inf")),
                  log_prob_fn)
    return update


FAULTS = {
    "sound": {},
    "state_unchanged": {(stretch, "run_ensemble"): lambda f: _unchanged,
                        (fleet, "run_fleet_ensemble"): lambda f: _unchanged},
    "half_batch": {(batched, "log_posterior_batch"): _half_batch,
                   (fleet, "log_posterior_fleet"): _half_batch},
    "answer_altered": {(batched, "log_posterior_batch"): _altered,
                       (fleet, "log_posterior_fleet"): _altered},
    "always_accept": {(stretch, "_propose_accept"): _always_accept,
                      (fleet, "_propose_accept"): _always_accept},
}


def run_resolved(res, fault, device, monkeypatch):
    """(the check's numbers, correct) of a run of the resolved cell ``res`` (``bench.resolve``
    or its like) with the timed path broken by ``fault``."""
    # the fleet's driver puts its recorder in the program's module: restore it after
    monkeypatch.setattr(fleet, "log_posterior_fleet", fleet.log_posterior_fleet)
    for (module, name), wrap in FAULTS[fault].items():
        monkeypatch.setattr(module, name, wrap(getattr(module, name)))
    bench.set_env(res["cfg"], res["cell"])
    args = bench.parse(["--workload", res["entry"]["name"], "--seed", "2147483659",
                        "--seconds", "0.1"])
    out = bench.execute(args, res, device, 0.0, log=lambda msg: None)
    return out["numbers"], check.verdict(out["numbers"], res["cell"]["limits"])


def run_cell(cell, fault, device, sizes, monkeypatch):
    res = bench.resolve(SPEC, cell)
    res["cell"] = {**res["cell"], **sizes}
    return run_resolved(res, fault, device, monkeypatch)


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch, clean_env, plain_dials):
    numbers, correct = run_cell(cell, fault, torch.device("cpu"), cpu_sizes(cell), monkeypatch)
    assert correct == (fault == "sound"), numbers


@pytest.mark.card
@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct_at_the_cells_size(card, cell, fault, monkeypatch,
                                                              clean_env):
    numbers, correct = run_cell(cell, fault, card, {}, monkeypatch)
    print(cell, fault, numbers)
    assert correct == (fault == "sound"), numbers
