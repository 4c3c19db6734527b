"""Refreshable multigrid solver: value-only rebuilds on a fixed hierarchy (ports ``surface_multigrid_code_tpu/solver/refresh.py``).

The applications re-run the multigrid precompute with a fresh matrix on a
FIXED hierarchy in their hot loops: MCF once per time step (reference
05_example_mean_curvature_flow/main.cpp:74), the balloon's scalar
cross-check once per Newton iteration (implicit_euler_mg_balloon.h:75).
The reference pays a full SpGEMM chain and an LDLT factorization each time.

Here the symbolic work (sparsity, plans, colorings, the constrained
split) is done once, on the host; each refresh runs on the device:

    finest nnz values -> Galerkin chain (``galerkin.refresh_values``)
      -> one CSR per level on the level's fixed pattern
      -> Chebyshev bounds by power iteration (K1), when Chebyshev smooths
      -> dense coarsest + diagonal shift -> Cholesky inverse

and the solve reuses ``vcycle.solve_loop``. Refreshed systems must be SPD
(MCF's M - delta L and the balloon's M + dt^2 K are), since the coarsest
level is Cholesky-inverted; the one-shot singular Poisson path keeps the
host eigh pseudo-inverse of ``vcycle.build_device_hierarchy``.

``csr_slot_map`` says which nnz slot of a fixed pattern each (row, col)
entry lands in; the steppers assemble values straight into that order.

The JAX package's TPU layout (the windowed kernels, their RCM
permutation and refresh chain, padded GS groups with per-row scales) has
no counterpart: the port's levels are CSR on exact sizes.
"""

from __future__ import annotations

import math

import numpy as np
import scipy.sparse as sp
import torch

from surface_multigrid_code_torch.config import SmootherType, SolveConfig
from surface_multigrid_code_torch.ops.smoothers import color_groups, greedy_coloring
from surface_multigrid_code_torch.ops.sparse import CSRMatrix, csr_from_scipy, row_ids
from surface_multigrid_code_torch.ops.spmv import fused_spmv
from surface_multigrid_code_torch.solver.galerkin import (
    GalerkinPlan,
    build_galerkin_plan,
    cholesky_inverse_or_nan,
    device_plan,
    plan_pattern,
    refresh_values,
)
from surface_multigrid_code_torch.solver.vcycle import DeviceHierarchy, DeviceLevel, solve_loop
from surface_multigrid_code_torch.utils.device import resolve_device
from surface_multigrid_code_torch.utils.profiler import profile_region

__all__ = ["RefreshableMGSolver", "csr_slot_map"]


class RefreshableMGSolver:
    """Fixed hierarchy + fixed finest sparsity; per-solve value refresh.

    mg: MGLevel list from ``mg_precompute`` (or ``mg_precompute_block``);
    A0_pattern: the finest CSR whose sparsity every refreshed matrix shares
    (its values are not used). With ``known``, those rows and columns are
    eliminated (reference src/min_quad_with_fixed_mg.cpp:137-257): P is
    row-sliced to the unknowns and its columns pruned by value, once, and
    every solve gathers A_uu / A_uk out of the full finest values and folds
    the known values into the right-hand side.
    """

    def __init__(
        self,
        mg,
        A0_pattern: sp.spmatrix,
        known: np.ndarray | None = None,
        cfg: SolveConfig | None = None,
        dtype: torch.dtype = torch.float32,
        coarsest_shift: float = 1e-12,
        prune_threshold: float = 1e-15,
        device="cuda",
    ):
        self.cfg = cfg or SolveConfig(smoother=SmootherType.JACOBI)
        self.dtype = dtype
        self.device = resolve_device(device)
        self.coarsest_shift = float(coarsest_shift)
        A0 = A0_pattern.tocsr().copy()
        A0.sum_duplicates()
        Ps = [mg[lv].P_full.tocsr() for lv in range(1, len(mg))]
        t = (lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64), device=self.device))

        self.known = (
            np.zeros(0, dtype=np.int64)
            if known is None or len(known) == 0
            else np.asarray(known, dtype=np.int64).ravel()
        )
        self.unknown = np.setdiff1d(np.arange(A0.shape[0]), self.known)
        if self.known.size:
            # the split, P's row slice and its value-based column pruning
            # depend only on the static pattern and P (reference :137-257)
            rows_keep = self.unknown
            Ps_sliced = []
            for P in Ps:
                P = P.tocsr()[rows_keep].tocsc()
                keep_cols = np.flatnonzero(
                    np.asarray((P > prune_threshold).sum(axis=0)).ravel() > 0)
                Ps_sliced.append(P[:, keep_cols].tocsr())
                rows_keep = keep_cols
            Ps = Ps_sliced
            Auu = A0[self.unknown][:, self.unknown].tocsr()
            Auu.sum_duplicates()
            Auk = A0[self.unknown][:, self.known].tocsr()
            Auk.sum_duplicates()
            # A_uu / A_uk nnz -> full-pattern nnz ids, and A_uk's CSR layout
            self._uu_map = t(_submatrix_nnz_map(A0, self.unknown, self.unknown, Auu))
            self._uk_map = t(_submatrix_nnz_map(A0, self.unknown, self.known, Auk))
            self._uk_indptr = torch.as_tensor(Auk.indptr.astype(np.int32), device=self.device)
            self._uk_indices = torch.as_tensor(Auk.indices.astype(np.int32), device=self.device)
            A0 = Auu
        self.A0_pattern = A0
        self.plan: GalerkinPlan = build_galerkin_plan(A0, Ps)
        self.plans = device_plan(self.plan, A0, self.device, dtype)
        self.P = [csr_from_scipy(P, self.device, dtype) for P in Ps]
        self.PT = [csr_from_scipy(P.T.tocsr(), self.device, dtype) for P in Ps]
        # GS colors of every smoothed level, on the plan's pattern of REAL
        # nnz (reference refresh.py:255-266), so the trajectory matches
        self.groups: list[tuple[torch.Tensor, ...]] = []
        if self.cfg.smoother == SmootherType.MULTICOLOR_GS:
            for pl_ in [self.plan.lvl0, *self.plan.levels][:-1]:
                color = greedy_coloring(plan_pattern(pl_))
                self.groups.append(tuple(
                    torch.as_tensor(g, device=self.device) for g in color_groups(color)))

    def _coarse_inverse(self, pl_, vals: torch.Tensor) -> torch.Tensor:
        """Dense coarsest operator (+ the diagonal shift), then its inverse
        through the Cholesky factor (refreshed operators are SPD; where
        rounding leaves one that is not, the inverse is NaN, see
        ``cholesky_inverse_or_nan``)."""
        n = pl_.n
        dense = torch.zeros((n, n), dtype=vals.dtype, device=vals.device)
        dense.index_put_((row_ids(pl_.indptr, pl_.nnz_out), pl_.indices.long()), vals,
                         accumulate=True)
        dense += self.coarsest_shift * torch.eye(n, dtype=vals.dtype, device=vals.device)
        return cholesky_inverse_or_nan(dense)

    def refresh(self, A0_vals: torch.Tensor) -> DeviceHierarchy:
        """The hierarchy for finest values A0_vals (canonical CSR order of
        ``A0_pattern``, the reduced pattern on the constrained path): the
        Galerkin refresh, one CSR per level on its fixed pattern, Chebyshev
        bounds by power iteration on every level but the coarsest (one host
        sync for all of them) and the coarse inverse."""
        vals = refresh_values(self.plans, A0_vals.to(device=self.device, dtype=self.dtype))
        L = len(vals)
        mats = [CSRMatrix(pl_.indptr, pl_.indices, v, pl_.n)
                for pl_, (v, _) in zip(self.plans, vals)]
        lams: list[float | None] = [None] * L
        if self.cfg.smoother == SmootherType.CHEBYSHEV and L > 1:
            est = [_device_lam_max(A, d, iters=self.cfg.lam_power_iters)
                   for A, (_, d) in zip(mats[:-1], vals[:-1])]
            lams[:-1] = torch.stack(est).tolist()
        levels = [
            DeviceLevel(A, d, None if lv == 0 else self.P[lv - 1],
                        None if lv == 0 else self.PT[lv - 1],
                        self.groups[lv] if lv < len(self.groups) else (), lams[lv])
            for lv, (A, (_, d)) in enumerate(zip(mats, vals))
        ]
        return DeviceHierarchy(levels, self._coarse_inverse(self.plans[-1], vals[-1][0]))

    def _fold_known(self, A0_vals: torch.Tensor, rhs_u: torch.Tensor, kv: torch.Tensor):
        """Constrained path: (A_uu values, rhs_u - A_uk kv), both gathered
        out of the FULL finest values (reference :310-318); kv is [nk] or
        [nk, C] like rhs_u."""
        Auk = CSRMatrix(self._uk_indptr, self._uk_indices, A0_vals[self._uk_map],
                        self.known.size)
        return A0_vals[self._uu_map], fused_spmv(Auk, kv, epi="resid", b=rhs_u)

    def solve(
        self,
        A0_vals,
        rhs: np.ndarray,
        known_val: np.ndarray | None = None,
        z0: np.ndarray | None = None,
        tolerance: float = 1e-3,
        max_iter: int = 20,
    ):
        """Refresh + V-cycle iterate. A0_vals: nnz values of the FULL
        finest pattern (CSR order), numpy or a tensor; rhs [n] or [n, C].
        With ``known`` the unknown/known split, the right-hand-side fold and
        the back-scatter happen here. Returns (z f64 numpy, r_his list,
        converged) like ``min_quad_with_fixed_mg_solve``."""
        dev, dt = self.device, self.dtype
        t = (lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64)).to(device=dev, dtype=dt))
        vals = torch.as_tensor(A0_vals).to(device=dev, dtype=dt)
        rhs = np.asarray(rhs, dtype=np.float64)
        if self.known.size:
            if known_val is None:
                raise ValueError("the solver was built with known rows: pass known_val")
            kv = np.asarray(known_val, dtype=np.float64)
            rhs_u = t(rhs[self.unknown])
            z0_u = (torch.zeros_like(rhs_u) if z0 is None
                    else t(np.asarray(z0, dtype=np.float64)[self.unknown]))
            vals, rhs_u = self._fold_known(vals, rhs_u, t(kv))
        else:
            rhs_u = t(rhs)
            z0_u = torch.zeros_like(rhs_u) if z0 is None else t(z0)
        with profile_region("MG: refresh+solve", trace=True):
            z_u, r_his, k = solve_loop(self.refresh(vals), rhs_u, z0_u, float(tolerance),
                                       int(max_iter), self.cfg)
            z_u = z_u.cpu().to(torch.float64).numpy()
        if self.known.size:
            z = np.empty_like(rhs)
            z[self.unknown] = z_u
            z[self.known] = kv
        else:
            z = z_u
        r_list = [float(r) for r in r_his[:k].cpu()]
        return z, r_list, bool(r_list and r_list[-1] <= tolerance)


def _submatrix_nnz_map(
    A: sp.csr_matrix, rows: np.ndarray, cols: np.ndarray, Asub: sp.csr_matrix
) -> np.ndarray:
    """For each nnz of Asub = A[rows][:, cols] (canonical CSR order), the
    nnz id within A, so submatrix values can be gathered from the full
    value vector on the device."""
    col_of = -np.ones(A.shape[1], dtype=np.int64)
    col_of[cols] = np.arange(cols.shape[0])
    out = np.empty(Asub.nnz, dtype=np.int64)
    for si, gi in enumerate(rows):
        lo, hi = A.indptr[gi], A.indptr[gi + 1]
        sub_cols = col_of[A.indices[lo:hi]]
        keep = sub_cols >= 0
        slo, shi = Asub.indptr[si], Asub.indptr[si + 1]
        # A's kept columns appear in the same relative (sorted) order as
        # Asub's canonical column order
        order = np.argsort(sub_cols[keep], kind="stable")
        out[slo:shi] = (lo + np.flatnonzero(keep))[order]
    return out


def _device_lam_max(A: CSRMatrix, diag: torch.Tensor, iters: int = 12) -> torch.Tensor:
    """Power iteration for lam_max(D^-1 A) from the uniform start, one K1
    launch per iteration; 1.1x safety margin. Returns a 0-d device tensor."""
    x = torch.full((A.n_rows,), 1.0 / math.sqrt(A.n_rows), dtype=diag.dtype,
                   device=diag.device)
    lam = torch.ones((), dtype=diag.dtype, device=diag.device)
    for _ in range(iters):
        y = fused_spmv(A, x) / diag
        lam = torch.sqrt((y * y).sum())
        x = y / lam
    return 1.1 * lam


def csr_slot_map(
    pattern: sp.csr_matrix, rows: np.ndarray, cols: np.ndarray
) -> np.ndarray:
    """nnz slot of every (row, col) pair in the pattern (fully vectorized).

    Canonical CSR keys (row * ncols + col) are globally sorted, so ONE
    np.searchsorted resolves every query."""
    pattern = pattern.tocsr()
    pattern.sort_indices()  # no-op when already canonical
    ncols = pattern.shape[1]
    prows = np.repeat(
        np.arange(pattern.shape[0], dtype=np.int64), np.diff(pattern.indptr)
    )
    pkeys = prows * ncols + pattern.indices
    qkeys = np.asarray(rows, dtype=np.int64) * ncols + np.asarray(
        cols, dtype=np.int64
    )
    slots = np.searchsorted(pkeys, qkeys)
    if slots.max(initial=-1) >= pkeys.shape[0] or not np.array_equal(
        pkeys[np.minimum(slots, pkeys.shape[0] - 1)], qkeys
    ):
        raise ValueError("entry outside pattern")
    return slots
