"""Mean-curvature flow with a row-partitioned solve (ports ``surface_multigrid_code_tpu/parallel/mcf.py``).

The reference step (05_example_mean_curvature_flow/main.cpp:53-80): solve
(M - delta L) U = M U_pre with L fixed, then renormalize the area. Here
every rank holds its rows of the hierarchy: ``backend="well"`` (the
default, as in the JAX package) ``parallel/wellhalo.py``, band-segment
halos and the sharded value refresh; ``"halo"`` ``parallel/halo.py``.
Per step the host assembles the finest values (the barycentric mass added
on the fixed cotan values' diagonal slots) and ``solve_values`` refreshes
every level and runs the V-cycles on the [n, 3] right-hand side (K2 for
every SpMV). Every rank runs the step together and returns the same
result.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from surface_multigrid_code_torch.config import SmootherType, SolveConfig
from surface_multigrid_code_torch.ops.laplacian import cotmatrix
from surface_multigrid_code_torch.parallel.wellhalo import galerkin_hierarchy
from surface_multigrid_code_torch.solver.refresh import csr_slot_map


def _barycentric_mass(U: np.ndarray, F: np.ndarray) -> np.ndarray:
    """Lumped barycentric vertex mass (1/3 of incident face areas)."""
    P0, P1, P2 = U[F[:, 0]], U[F[:, 1]], U[F[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(P1 - P0, P2 - P0), axis=1)
    third = np.repeat(areas / 3.0, 3)
    return np.bincount(F.ravel(), weights=third, minlength=U.shape[0])


class ShardedMCFStepper:
    """MCF stepper whose per-step solve is row-partitioned over a process
    group. Parameters as ``models/mcf.MCFStepper``'s (Jacobi by default,
    as the JAX class); ``mg`` is the SSP hierarchy of ``mg_precompute``,
    ``group`` the process group (None: the default), ``device`` this
    rank's device (``comm.rank_device``). ``backend``: ``"well"`` or
    ``"halo"``; ``reorder=False`` (the levels in the order given) only
    with ``"halo"`` (``wellhalo.galerkin_hierarchy``)."""

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
        group=None,
        reorder: bool = True,
        backend: str = "well",
    ):
        self.F = np.asarray(F, dtype=np.int64)
        self.delta = float(delta)
        self.mg_tol = float(mg_tol)
        self.max_iter = int(max_iter)
        cfg = cfg or SolveConfig(smoother=SmootherType.JACOBI)
        L = cotmatrix(V, F).tocsr()
        L.sum_duplicates()
        n = V.shape[0]
        self._diag_slots = csr_slot_map(L, np.arange(n), np.arange(n))
        self._L_vals = -self.delta * L.data
        # the pattern (L's, diagonal included) is what the partition and
        # the Galerkin plan key on; later steps only swap values
        vals0 = self._L_vals.copy()
        vals0[self._diag_slots] += _barycentric_mass(np.asarray(V, dtype=np.float64), self.F)
        A0 = sp.csr_matrix((vals0, L.indices.copy(), L.indptr.copy()), L.shape)
        Ps = [mg[lv].P_full.tocsr() for lv in range(1, len(mg))]
        # the symbolic chain: SSP prolongations carry exact-zero weights
        # whose products scipy's numeric PᵀAP would drop
        self.halo = galerkin_hierarchy(A0, Ps, cfg, dtype, device, group, backend, reorder)

    def step(self, U: np.ndarray):
        """One flow step; returns (U_next, the residual list, converged)."""
        U = np.asarray(U, dtype=np.float64)
        mass = _barycentric_mass(U, self.F)
        vals = self._L_vals.copy()
        vals[self._diag_slots] += mass
        Unew, r_his, ok = self.halo.solve_values(
            vals, mass[:, None] * U, z0=U, tolerance=self.mg_tol, max_iter=self.max_iter)
        # unit area, zero-mean x/y, floor z (reference src/normalize_unit_area.cpp:9-23)
        P0, P1, P2 = Unew[self.F[:, 0]], Unew[self.F[:, 1]], Unew[self.F[:, 2]]
        area = 0.5 * np.linalg.norm(np.cross(P1 - P0, P2 - P0), axis=1).sum()
        Unew = Unew / np.sqrt(area)
        center = Unew.mean(axis=0)
        Unew = Unew - np.array([center[0], center[1], Unew[:, 2].min()])
        return Unew, r_his, ok
