"""The control of each cell's comparison -- the reference with one of the
configuration's guarantees broken, in the program's place -- comes out
as not correct, at a tiny size on the CPU.  On the card it is read at the
cells' own size by ``portbench/control.py``."""

from __future__ import annotations

import pytest

from portbench.control import control_readings
from portbench.tests.tiny import WORKLOADS, tiny_cell


@pytest.mark.parametrize("seed", [7, 2**31 + 99])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct(workload, seed):
    readings = control_readings(tiny_cell(workload), seed, "cpu", "torch", 2)
    assert readings and max(readings.values()) > 0, readings
