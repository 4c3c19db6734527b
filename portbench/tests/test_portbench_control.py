"""The control at a test's size: the reference one precision below the configuration's
fails the cell's comparison, the same solver in the stated precision passes.

icosphere(6) (40,962 V) at unit area, float32 against float64. On a
unit-area mesh the float32 floor of ||M U - A Z||_F grows with the square
root of the vertex count, so the test scales the cell's tolerance and
limit by that root, sqrt(40,962 / 2,621,442) = 1/8, which keeps the
floor's ratio to them as it is at the cell's size. On the chip the same
code runs unscaled at the cell's own size (``python3 -m portbench.control``).
"""

from __future__ import annotations

import torch
from conftest import small_cell

from portbench import control

SCALE = 1.0 / 8.0


def test_solve_control_fails_and_witness_passes():
    _, w, c = small_cell("ico9_poisson.c3", order=6)
    c["tolerance"] *= SCALE
    limit = w["limits"]["resid"] * SCALE
    rec = control.solve_readings(c, w, 2**31 + 31, 1, torch.device("cpu"))
    print(rec["control"]["resid"], rec["witness"]["resid"], limit)
    assert rec["control"]["resid"] > limit
    assert rec["witness"]["resid"] <= limit
