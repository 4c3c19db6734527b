"""With the timed path broken underneath, a run's ``correct`` comes out false.

Each fault a cell can have, planted in the program's entry that the window
drives (``solve_loop``), on the CPU at a test's size: a step that returns
its state unchanged; half of the batch left out, the mean of the rest in
its place; an answer altered where it is produced. (The exchange between chips has no
counterpart: every cell runs on one card.)
"""

from __future__ import annotations

import pytest
import torch
from conftest import SOLVE, small_cell

import surface_multigrid_code_torch.solver.vcycle as vcycle
from portbench import run

REAL_SOLVE = vcycle.solve_loop


def unchanged_solve(hier, rhs, z0, tol, max_iter, cfg):
    r = torch.zeros(max_iter, dtype=rhs.dtype)
    return z0, r, 1


def half_solve(hier, rhs, z0, tol, max_iter, cfg):
    z, r, k = REAL_SOLVE(hier, rhs, z0, tol, max_iter, cfg)
    half = z.shape[1] // 2
    z = z.clone()
    z[:, half:] = z[:, :half].mean(dim=1, keepdim=True)
    return z, r, k


def altered_solve(hier, rhs, z0, tol, max_iter, cfg):
    z, r, k = REAL_SOLVE(hier, rhs, z0, tol, max_iter, cfg)
    z = z.clone()
    z[0, 0] += z.abs().max()
    return z, r, k


@pytest.mark.parametrize("fault", [unchanged_solve, half_solve, altered_solve],
                         ids=lambda f: f.__name__)
def test_solve_fault_is_caught(fault, monkeypatch):
    monkeypatch.setattr(vcycle, "solve_loop", fault)
    bench, w, c = small_cell("ico9_poisson.c3", **SOLVE)
    out = run.run_cell(bench, "ico9_poisson.c3", w, c, 2**31 + 21, 0.5, False,
                       torch.device("cpu"))
    assert out is not None and out["correct"] is False
