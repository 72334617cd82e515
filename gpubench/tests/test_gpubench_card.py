"""On the card, at a size that a test run holds: the control (the reference in the
program's place, in TF32) comes out not correct and the program correct, by the cell's
own limits.  ``python3 -m gpubench.harness.control`` takes the same readings at the
cells' own sizes."""
import pytest

from gpubench.harness import bench, check, control

SPEC = bench.load_json(bench.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in SPEC["workloads"]]
# the card test's sizes of a cell, by the driver its file names
SIZES = {"stage2": dict(walkers=4096), "fleet": dict(walkers=1024)}


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(card, cell, clean_env):
    own = bench.resolve(SPEC, cell)["cell"]
    program, ctl = control.readings(cell, 2147483671, 2, 1, card, lambda line: None,
                                    SIZES[own["driver"]])
    limits = own["limits"]
    assert check.verdict(program, limits), program
    assert not check.verdict(ctl, limits), ctl
