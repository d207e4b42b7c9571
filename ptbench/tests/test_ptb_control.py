"""The control, the reference computed in bfloat16 (the precision below
the configurations' float32) in the program's place, is not correct. On
the CPU at tiny sizes; at each cell's own size on the card
(`python -m ptbench.control`, PERF.md)."""
import pytest
import torch

from ptbench import check
from ptbench.run import Bench
from ptbench.tests.conftest import WORKLOADS, tiny


def _readings(workload, device, overrides, seeds, seconds):
    b = Bench(workload, device=device, overrides=overrides)
    out = []
    for seed in seeds:
        sess = b.session(seed)
        rec = sess.run(seconds=seconds)
        ref = b.reference(rec.images)
        low = b.reference(rec.images, dtype=torch.bfloat16)
        sound, _ = check.numbers(rec.images,
                                 [im.values for im in rec.images], ref)
        control, per = check.numbers(rec.images, low, ref)
        out.append((sound, check.judge(control, b.cell.limits, per)[0]))
    return out


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_tiny(workload):
    for sound, correct in _readings(workload, "cpu", tiny(workload), [11],
                                    0.3):
        assert all(v == 0.0 for v in sound.values())
        assert not correct


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_on_the_card(card, workload):
    for _, correct in _readings(workload, card, None, [21, 22, 23], 2.0):
        assert not correct
