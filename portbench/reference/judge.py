"""The comparison that decides ``correct``: each kept answer held to the plain reference.

The reference rebuilds the mass, the Laplacian and the system from the
mesh itself (``reference/laplacian.py``, float64) and reads the program's
answers only to judge them.

A solve (traffic ``solve``) is judged by its residual ||M U - A Z||_F,
absolute as the configuration's tolerance is, with M, A and the
right-hand side's coordinates U of the benchmark's own making (M and A
built by ``reference/laplacian.py`` from the mesh; the program received
the same A as its input). The compared number ``resid`` is the largest
over the kept answers; a number that is not finite fails.
"""

from __future__ import annotations

import numpy as np


def _check(name, value, limit) -> dict:
    return {"name": name, "value": float(value), "limit": float(limit),
            "ok": bool(np.isfinite(value) and value <= limit)}


def solve_residuals(mass, A, collected) -> list[float]:
    """||M U - A Z||_F of each kept answer, M = diag(mass)."""
    return [float(np.linalg.norm(mass[:, None] * collected["fields"][j] - A @ Z))
            for _i, j, Z in collected["answers"]]


def judge_solve(mass, A, collected, limits) -> list[dict]:
    res = solve_residuals(mass, A, collected)
    worst = max(res) if res and all(np.isfinite(res)) else float("nan")
    return [_check("resid", worst, limits["resid"])]
