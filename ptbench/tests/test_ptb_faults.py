"""`correct` comes out false when the timed path is broken underneath: the
harness's look for a card skipped (device "cpu", the cell shrunk), the
rest of a run driven as it is."""
import pytest

from ptbench import faults
from ptbench.run import run_cell
from ptbench.tests.conftest import tiny

CELLS = ("hero.progressive", "terrain1m.progressive")


def _run(workload, seed):
    return run_cell(workload, seed, 1.0, False, device="cpu",
                    overrides=tiny(workload), log=lambda *a: None)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    out = _run(workload, 2 ** 31 + 17)
    assert out["correct"], out["checks"]
    assert all(v["value"] == 0.0 for v in out["checks"].values())


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("workload", CELLS)
def test_fault_is_not_correct(workload, fault):
    undo = faults.plant(fault)
    try:
        out = _run(workload, 4242)
    finally:
        undo()
    assert not out["correct"], out["checks"]
