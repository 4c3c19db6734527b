"""Mean-curvature flow with a device-resident step (ports ``surface_multigrid_code_tpu/models/mcf.py``).

Reference example (05_example_mean_curvature_flow/main.cpp:53-80): per step
solve (M - delta * L) U = M U_pre with L fixed (cotan Laplacian of the
ORIGINAL mesh), M the barycentric mass of the CURRENT mesh, mg tol 5e-7,
then re-normalize the surface area, re-running the full multigrid
precompute each step.

Here one step runs on the device, the host only driving it:

    U -> barycentric mass diagonal (``massmatrix_barycentric_diag``)
      -> finest values -delta L, with the mass added on the diagonal slots
      -> Galerkin value refresh of every level (``RefreshableMGSolver``)
      -> V-cycles on the [n, 3] right-hand side to tolerance (every SpMV
         one K2 launch, GS colors in place)
      -> area renormalization (reference src/normalize_unit_area.cpp:9-23)

PyTorch runs eagerly: the solve loop syncs once per cycle to test the
residual, as the port's other solve loops do.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from surface_multigrid_code_torch.config import SmootherType, SolveConfig
from surface_multigrid_code_torch.ops.laplacian import cotmatrix, massmatrix_barycentric_diag
from surface_multigrid_code_torch.solver.refresh import RefreshableMGSolver, csr_slot_map
from surface_multigrid_code_torch.solver.vcycle import solve_loop
from surface_multigrid_code_torch.utils.device import resolve_device

PHASES = ("refresh", "vcycles", "normalize")


class MCFStepper:
    """Device-resident MCF (Kazhdan et al. 2012 flow) on a fixed hierarchy.

    With ``timed = True``, ``step_device`` records in ``last_phases`` the
    host seconds of each of ``PHASES`` (mass + refresh, V-cycles,
    renormalization), each closed by a device sync.
    """

    def __init__(
        self,
        V: np.ndarray,
        F: np.ndarray,
        mg,
        delta: float = 0.01,
        mg_tol: float = 5e-7,
        max_iter: int = 20,
        cfg: SolveConfig | None = None,
        dtype: torch.dtype = torch.float32,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.delta = float(delta)
        self.mg_tol = float(mg_tol)
        self.max_iter = int(max_iter)
        self.cfg = cfg or SolveConfig(smoother=SmootherType.MULTICOLOR_GS)
        self.timed = False
        self.last_phases: dict[str, float] = {}
        L = cotmatrix(V, F).tocsr()
        L.sum_duplicates()
        self.solver = RefreshableMGSolver(mg, L, cfg=self.cfg, dtype=dtype, device=self.device)
        n = L.shape[0]
        t = (lambda a, dt: torch.as_tensor(np.asarray(a)).to(device=self.device, dtype=dt))
        self.L_vals = t(-self.delta * L.data, dtype)
        self.F = t(F, torch.int64)
        self.diag_slots = t(csr_slot_map(L, np.arange(n), np.arange(n)), torch.int64)

    def _clock(self, name=None, t0=None):
        """Host clock after a device sync when timed; with ``name``, close
        that phase (started at t0)."""
        if not self.timed:
            return None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        if name is not None:
            self.last_phases[name] = t1 - t0
        return t1

    def values(self, U: torch.Tensor):
        """(finest values of M(U) - delta L in the canonical CSR order of L,
        the barycentric mass diagonal of U)."""
        mass = massmatrix_barycentric_diag(U, self.F)
        return self.L_vals.index_add(0, self.diag_slots, mass), mass

    def step_device(self, U: torch.Tensor):
        """One flow step on device tensors: U [n, 3] -> (U_next [n, 3],
        r_his [max_iter] padded with -1, k residuals recorded)."""
        U = U.to(device=self.device, dtype=self.dtype)
        t0 = self._clock()
        vals, mass = self.values(U)
        hier = self.solver.refresh(vals)
        t0 = self._clock("refresh", t0)
        Unew, r_his, k = solve_loop(hier, mass[:, None] * U, U, self.mg_tol, self.max_iter,
                                    self.cfg)
        t0 = self._clock("vcycles", t0)
        # unit area, zero-mean x/y, floor z (reference src/normalize_unit_area.cpp:9-23)
        F = self.F
        P0, P1, P2 = Unew[F[:, 0]], Unew[F[:, 1]], Unew[F[:, 2]]
        area = 0.5 * torch.linalg.norm(torch.cross(P1 - P0, P2 - P0, dim=1), dim=1).sum()
        Unew = Unew / torch.sqrt(area)
        center = Unew.mean(dim=0)
        Unew = Unew - torch.stack([center[0], center[1], Unew[:, 2].min()])
        self._clock("normalize", t0)
        return Unew, r_his, k

    def step(self, U: np.ndarray):
        """One flow step; returns (U_next f64 numpy, r_his list, converged)."""
        Unew, r_his, k = self.step_device(torch.as_tensor(np.asarray(U, dtype=np.float64)))
        r_list = [float(r) for r in r_his[:k].cpu()]
        return (Unew.cpu().to(torch.float64).numpy(), r_list,
                bool(r_list and r_list[-1] <= self.mg_tol))
