"""`correct` comes out false when the timed path is broken underneath: the
harness's look for a card skipped (device "cpu", the cell shrunk), the
rest of a run driven as it is. Every cell of BENCHMARK.json, at its CPU
size; a fault of the geometry wherever the cell's scene has the primitive
it breaks."""
import pytest

from ptbench import bench, faults
from ptbench.run import run_cell
from ptbench.tests.conftest import WORKLOADS, tiny


def _run(workload, seed, overrides=None):
    return run_cell(workload, seed, 1.0, False, device="cpu",
                    overrides=overrides or tiny(workload),
                    log=lambda *a: None)


def _planted(fault, workload, seed, overrides=None):
    undo = faults.plant(fault)
    try:
        return _run(workload, seed, overrides)
    finally:
        undo()


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct(workload):
    out = _run(workload, 2 ** 31 + 17)
    assert out["correct"], out["checks"]
    assert all(v["value"] == 0.0 for v in out["checks"].values())


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("workload", WORKLOADS)
def test_fault_is_not_correct(workload, fault):
    out = _planted(fault, workload, 4242)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", faults.GEOMETRY_FAULTS)
@pytest.mark.parametrize("workload", WORKLOADS)
def test_geometry_fault(workload, fault):
    """Not correct where the cell's scene has the primitive the fault
    breaks (its CPU size has to keep it in view); where it has none, the
    run is as exact as a sound one."""
    out = _planted(fault, workload, 4242)
    if faults.applies(fault, bench.cell(workload).config):
        assert not out["correct"], out["checks"]
    else:
        assert all(v["value"] == 0.0 for v in out["checks"].values())
