"""On the card, at a size that a test run holds: the control (the reference in the
program's place, in TF32) comes out not correct and the program correct, by the cell's
own limits.  ``python3 -m gpubench.harness.control`` takes the same readings at the
cells' own sizes."""
import pytest

from gpubench.harness import bench, check, control

SIZES = {"koi2298.stage2": dict(walkers=4096), "fleet9.fused": dict(walkers=1024)}


@pytest.mark.card
@pytest.mark.parametrize("cell", SIZES)
def test_the_control_is_not_correct(card, cell, clean_env):
    limits = bench.resolve(bench.load_json(bench.ROOT / "BENCHMARK.json"), cell)["cell"]["limits"]
    program, ctl = control.readings(cell, 2147483671, 2, 1, card, lambda line: None,
                                    SIZES[cell])
    assert check.verdict(program, limits), program
    assert not check.verdict(ctl, limits), ctl
