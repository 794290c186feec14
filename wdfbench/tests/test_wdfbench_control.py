"""The check refuses what it must, at a small size on the CPU: the control
(the reference in the program's place, in TF32) and each planted fault of
the timed path a cell can have, with the cell's own limits; the program
passes the same check (test_wdfbench_reference.py)."""

import pytest

from wdfbench import faults, harness

from .conftest import cells


@pytest.mark.parametrize("standin", sorted(faults.STANDINS))
@pytest.mark.parametrize("workload", cells())
def test_standin_comes_out_not_correct(small, workload, standin):
    r = harness.run_cell(small, workload, 2**31 + 5, 0.2, False, "cpu",
                         system=faults.STANDINS[standin])
    assert not r["correct"], r["checks"]
