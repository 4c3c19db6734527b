"""Host f64 mirror of the REFERENCE solver trajectory, for parity runs (ports ``surface_multigrid_code_tpu/solver/host_reference.py``).

The reference smoother is sequential in-place forward Gauss-Seidel
(src/mg_VCycle.cpp:146-177: for each row in order, u[i] = (b[i] -
sum_offdiag)/diag[i]), which is inherently serial and therefore not the
device smoother (the port uses multicolor-GS / Chebyshev / Jacobi, as the
JAX package does, DESIGN.md "Smoothers").  SURVEY.md §7 hard part 3 requires the divergence to be
*adjudicated*: this module reproduces the reference V-cycle bit-for-bit
in semantics (2 pre + 2 post sequential-GS sweeps, src/
min_quad_with_fixed_mg.cpp:324-325; additive prefactorized coarse solve,
src/mg_VCycle.cpp:181-201; residual recorded before each cycle with
break on tol, src/min_quad_with_fixed_mg.cpp:330-347) on the SAME
hierarchy the device solver uses, so their r_his trajectories can be
compared directly (tests/test_smoother_trajectory.py for the JAX package;
tests/test_torch_host_utils.py holds this copy to it).

One sequential forward-GS sweep over all rows equals the triangular
solve u' = (D+L)^{-1} (b - U u), which scipy evaluates with the same
sequential recurrence the reference's loop performs.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.sparse.linalg import splu, spsolve_triangular


class SequentialGSReference:
    """Reference-trajectory multigrid solve on host (f64).

    As: per-level host CSR operators (e.g. `[lvl.A for lvl in mg]` after
    `min_quad_with_fixed_mg_precompute`, coarsest already diag-shifted).
    Ps: prolongations, Ps[l]: level l+1 -> l.
    """

    def __init__(self, As: list[sp.spmatrix], Ps: list[sp.spmatrix]):
        self.As = [A.tocsr().astype(np.float64) for A in As]
        self.Ps = [P.tocsr().astype(np.float64) for P in Ps]
        self.DLs = [sp.tril(A, 0).tocsr() for A in self.As]
        self.Us = [sp.triu(A, 1).tocsr() for A in self.As]
        # reference prefactorizes the (shifted) coarsest with SimplicialLDLT
        # (src/min_quad_with_fixed_mg.cpp:236-256); splu plays that role
        self._coarse = splu(self.As[-1].tocsc())

    def _sweep(self, lv: int, b, u, n_iter: int):
        for _ in range(n_iter):
            u = spsolve_triangular(
                self.DLs[lv], b - self.Us[lv] @ u, lower=True
            )
        return u

    def _vcycle(self, lv: int, b, u):
        if lv == len(self.As) - 1:
            return u + self._coarse.solve(b)
        u = self._sweep(lv, b, u, 2)
        r = b - self.As[lv] @ u
        rc = self.Ps[lv].T @ r
        uc = self._vcycle(lv + 1, rc, np.zeros_like(rc))
        u = u + self.Ps[lv] @ uc
        u = self._sweep(lv, b, u, 2)
        return u

    def solve(self, rhs, z0=None, tolerance: float = 1e-3,
              max_iter: int = 20):
        """Returns (z, r_his, converged) with reference loop semantics."""
        z = np.zeros_like(rhs) if z0 is None else np.asarray(
            z0, dtype=np.float64
        ).copy()
        rhs = np.asarray(rhs, dtype=np.float64)
        r_his = []
        for _ in range(max_iter):
            res = float(np.linalg.norm(rhs - self.As[0] @ z))
            r_his.append(res)
            if res < tolerance:
                break
            z = self._vcycle(0, rhs, z)
        return z, r_his, bool(r_his and r_his[-1] <= tolerance)
