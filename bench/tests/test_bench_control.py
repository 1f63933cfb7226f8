"""The control on the card: the reference in TF32 in the program's place
fails the cell's limits (one seed at the cell's own size; the readings
that set the limits are in PERF.md)."""
import pytest

import control

CELLS = ["bksdm-small.backlog8", "dit-s2.backlog32", "dit-s2.bursty32",
         "bksdm-small.tiers8"]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("workload", CELLS)
def test_tf32_control_is_not_correct(workload, cuda):
    out = control.readings(workload, 20261019)
    assert out["fails"], out
