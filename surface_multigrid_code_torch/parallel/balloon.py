"""The balloon's Newton solves, row-partitioned (ports ``surface_multigrid_code_tpu/parallel/balloon.py``).

Reference semantics (implicit_euler_mg_balloon.h:40-120): per implicit
Euler step, Newton iterations that each solve H dx = -g with
H = M + dt^2 K(x), then a backtracking line search. The per-face Hessian
assembly is ``models/balloon.BalloonNewtonSolver``'s (K4 in the PSD
projection), built without its single-device solver; the solve is ``solve_values`` of
the row-partitioned hierarchy on the 3-expanded scalar hierarchy
(``mg_precompute_block``): ``backend="well"`` (the default, as in the JAX
package) ``parallel/wellhalo.py``, ``"halo"`` ``parallel/halo.py``; every
level refreshed, then V-cycles on each rank's rows (K1 for every SpMV).

Every rank runs the same host loop. Its one decision that rounding could
split, the line search's step, is rank 0's, broadcast to the others.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from surface_multigrid_code_torch.config import SmootherType, SolveConfig
from surface_multigrid_code_torch.models.balloon import BalloonNewtonSolver
from surface_multigrid_code_torch.models.shell import ShellEnergy
from surface_multigrid_code_torch.parallel.wellhalo import galerkin_hierarchy


class ShardedBalloonNewton:
    """Newton-direction solver whose refreshed V-cycles run row-partitioned.

    ``mg``: the block hierarchy of ``mg_precompute_block`` (3 #V DOFs);
    ``group``: the process group (None: the default). The hierarchy lives
    on the shell's device. dtype: float32 on a card, float64 on the CPU
    unless given. cfg: Chebyshev unless given (the JAX class's default).
    backend: ``"well"`` or ``"halo"``; ``reorder=False`` (the levels in the
    order given) only with ``"halo"`` (``wellhalo.galerkin_hierarchy``).
    """

    def __init__(self, shell: ShellEnergy, M: sp.csr_matrix, mg, dt: float,
                 cfg: SolveConfig | None = None, dtype: torch.dtype | None = None,
                 group=None, reorder: bool = True, backend: str = "well"):
        cfg = cfg or SolveConfig(smoother=SmootherType.CHEBYSHEV)
        self.asm = BalloonNewtonSolver(shell, M, mg, cfg=cfg, dtype=dtype, build_solver=False)
        # the chain of the rest-state values on the full symbolic pattern;
        # later Newton iterations only swap values through solve_values
        x0 = np.asarray(mg[0].V, dtype=np.float64).reshape(-1)
        vals0 = self.asm.hessian_values(x0, dt).cpu().to(torch.float64).numpy()
        pat = self.asm.pattern
        A0 = sp.csr_matrix((vals0, pat.indices.copy(), pat.indptr.copy()), pat.shape)
        Ps = [mg[lv].P_full.tocsr() for lv in range(1, len(mg))]
        self.halo = galerkin_hierarchy(A0, Ps, cfg, self.asm.dtype, shell.device, group,
                                       backend, reorder)

    def hessian_values(self, x_flat, dt: float) -> torch.Tensor:
        return self.asm.hessian_values(x_flat, dt)

    def solve(self, vals, g, tolerance: float = 2e-1, max_iter: int = 20):
        return self.halo.solve_values(vals, g, tolerance=tolerance, max_iter=max_iter)


def implicit_euler_mg_balloon_sharded(
    shell: ShellEnergy,
    M: sp.csr_matrix,
    curPos: np.ndarray,
    qdot: np.ndarray,
    fExt: np.ndarray,
    dt: float,
    mg,
    group=None,
    mg_tolerance: float = 2e-1,
    n_newton: int = 10,
    cfg: SolveConfig | None = None,
    newton_solver: ShardedBalloonNewton | None = None,
    verbose: bool = True,
    backend: str = "well",
):
    """One implicit Euler step with row-partitioned Newton solves, run by
    every rank of ``group`` together; mutates nothing, returns (curPos,
    qdot, newton_solver), the same on every rank. ``newton_solver.
    last_newton`` holds one record per iteration (residuals recorded,
    converged, alpha, found), as ``models/balloon.implicit_euler_mg_balloon``
    (reference implicit_euler_mg_balloon.h:40-120). ``backend`` is that of
    the solver built when none is given."""
    if newton_solver is None:
        newton_solver = ShardedBalloonNewton(shell, M, mg, dt, cfg=cfg, group=group,
                                             backend=backend)
    comm = newton_solver.halo.comm
    dev = newton_solver.halo.device
    qdot0 = qdot.copy()
    curPos0 = curPos.copy()
    qdot = qdot.copy()
    curPos = curPos.copy()

    def total_energy(tmp_qdot):
        Ek = 0.5 * (tmp_qdot - qdot0) @ (M @ (tmp_qdot - qdot0))
        newPos = curPos0 + dt * tmp_qdot.reshape(-1, 3)
        return float(newPos.reshape(-1) @ fExt) + Ek + shell.energy(newPos.reshape(-1))

    newton_solver.last_newton = []
    for it in range(n_newton):
        G = shell.gradient(curPos.reshape(-1))
        vals = newton_solver.hessian_values(curPos.reshape(-1), dt)
        g = -(M @ (qdot - qdot0) + dt * G + dt * fExt)
        dx, r_his, ok = newton_solver.solve(vals, g, tolerance=mg_tolerance, max_iter=20)
        if verbose and comm.rank == 0:
            print(f"  newton {it}: g.dx = {g @ dx:.6e}, cycles {len(r_his)}")
        # backtracking line search (reference :80-114)
        alpha, p, c = 1.0, 0.5, 1e-8
        s = total_energy(qdot) + c * (g @ dx)
        found = False
        while alpha > 1e-8:
            if total_energy(qdot + alpha * dx) <= s:
                found = True
                break
            alpha *= p
        agreed = comm.broadcast(torch.tensor([alpha, float(found)], dtype=torch.float64,
                                             device=dev)).tolist()
        alpha, found = agreed[0], bool(agreed[1])
        if found:
            qdot = qdot + alpha * dx
        if verbose and comm.rank == 0:
            print(f"  alpha: {alpha}")
        newton_solver.last_newton.append(
            {"residuals": len(r_his), "converged": ok, "alpha": alpha, "found": found})
        curPos = curPos0 + dt * qdot.reshape(-1, 3)
    return curPos, qdot, newton_solver
