"""min_quad_with_fixed-style multigrid solver, the user-facing API (ports ``surface_multigrid_code_tpu/solver/mqwf_mg.py``).

Reproduces the semantics of reference src/min_quad_with_fixed_mg.{h,cpp}:

- `min_quad_with_fixed_mg_precompute(A, None, mg)` (unconstrained overload,
  :3-51): sets mg[0].A = A, Galerkin-coarsens A_l = P_l^T A_{l-1} P_l,
  shifts the coarsest diagonal by +1e-12, caches diagonals.
- `min_quad_with_fixed_mg_precompute(A, known, mg)` (constrained overload,
  :137-257): splits indices into known/unknown, slices A_uu / A_uk,
  row-slices P_full to unknown rows, prunes all-near-zero columns of P
  level by level (keep column iff some entry > 1e-15), propagating the
  kept columns as the next level's row set, then Galerkin as above.
- `min_quad_with_fixed_mg_solve(...)` (:80-135 / :288-361): folds the
  constraints into the right-hand side, iterates up to maxIter V-cycles
  recording the residual 2-norm before each cycle, stops when below
  tolerance, scatters unknowns + knowns back, returns convergence.

The host does the sparse slicing and Galerkin products with SciPy; the
iteration runs on the device given at precompute.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from surface_multigrid_code_torch.config import SmootherType, SolveConfig
from surface_multigrid_code_torch.ops.smoothers import greedy_coloring
from surface_multigrid_code_torch.ops.sparse import CSRMatrix, csr_from_scipy
from surface_multigrid_code_torch.solver.hierarchy import MGLevel
from surface_multigrid_code_torch.solver.vcycle import (
    DeviceHierarchy,
    build_device_hierarchy,
    solve_loop,
    solve_loop_ir,
)
from surface_multigrid_code_torch.utils.device import resolve_device
from surface_multigrid_code_torch.utils.profiler import profile_region


@dataclass
class MQWFData:
    """Analog of reference min_quad_with_fixed_mg_data
    (src/min_quad_with_fixed_mg.h:22-29) plus the device hierarchy."""

    n: int
    known: np.ndarray
    unknown: np.ndarray
    LHS: sp.csr_matrix
    Auk: sp.csr_matrix | None
    hier: DeviceHierarchy
    cfg: SolveConfig
    dtype: torch.dtype
    device: torch.device
    colorings: list[np.ndarray] | None = None
    # finest operator in f64 for mixed-precision iterative refinement
    # (built when the hierarchy dtype is not f64)
    A64: CSRMatrix | None = None
    # the JAX package's RCM row ordering for its windowed TPU kernel; the
    # port has no such layout, so this is always None
    perm: np.ndarray | None = None


def min_quad_with_fixed_mg_precompute(
    A: sp.spmatrix,
    known: np.ndarray | None,
    mg: list[MGLevel],
    cfg: SolveConfig = SolveConfig(),
    *,
    device="cuda",
    dtype: torch.dtype = torch.float32,
    colorings: list[np.ndarray] | None = None,
) -> MQWFData:
    """Precompute solver data on ``device`` (the card unless the caller
    passes ``device="cpu"``). `known=None` or empty = unconstrained overload."""
    device = resolve_device(device)
    with profile_region("smg.precompute", trace=True):
        return _precompute(A, known, mg, cfg, device, dtype, colorings)


def _precompute(A, known, mg, cfg, device, dtype, colorings) -> MQWFData:
    """The precompute's phases, each a region of ``utils.profiler`` under
    ``smg.precompute``: ``.symmetry``, ``.galerkin``, ``.coloring`` (multicolor
    GS only), and in ``build_device_hierarchy`` ``.device_build`` and
    ``.coarse_inverse``."""
    A = A.tocsr().astype(np.float64)
    n = A.shape[0]
    with profile_region("smg.precompute.symmetry", trace=True):
        if (abs(A - A.T) > 1e-10 * max(1.0, abs(A).max())).nnz != 0:
            raise ValueError("input matrix must be symmetric")

    with profile_region("smg.precompute.galerkin", trace=True):
        known, unknown, LHS, Auk = _galerkin(A, known, mg, cfg)

    # Row colorings depend only on each level's sparsity, which is static
    # across value refreshes: computed once, callers may pass them back in.
    if colorings is None and cfg.smoother == SmootherType.MULTICOLOR_GS:
        with profile_region("smg.precompute.coloring", trace=True):
            colorings = [greedy_coloring(mg[lv].A) for lv in range(len(mg) - 1)]

    hier = build_device_hierarchy(
        [lvl.A for lvl in mg],
        [mg[lv].P for lv in range(1, len(mg))],
        cfg=cfg,
        device=device,
        dtype=dtype,
        colorings=colorings,
    )
    A64 = None
    if dtype != torch.float64:
        A64 = csr_from_scipy(mg[0].A, device, torch.float64)

    return MQWFData(
        n=n, known=known, unknown=unknown, LHS=LHS, Auk=Auk, hier=hier,
        cfg=cfg, dtype=dtype, device=device,
        colorings=colorings, A64=A64,
    )


def _galerkin(A, known, mg, cfg):
    """Sets P, PT and the Galerkin A of every level on ``mg`` (the
    coarsest diagonal shifted) and their diagonals; returns (known,
    unknown, LHS, Auk)."""
    n = A.shape[0]
    if known is None or len(known) == 0:
        known = np.zeros(0, dtype=np.int64)
        unknown = np.arange(n, dtype=np.int64)
        Auk = None
        mg[0].A = A
        for lv in range(1, len(mg)):
            mg[lv].P = mg[lv].P_full.tocsr()
            mg[lv].PT = mg[lv].P.T.tocsr()
            mg[lv].A = (mg[lv].PT @ mg[lv - 1].A @ mg[lv].P).tocsr()
        LHS = A
    else:
        known = np.asarray(known, dtype=np.int64).ravel()
        unknown = np.setdiff1d(np.arange(n, dtype=np.int64), known)
        LHS = A[unknown][:, unknown].tocsr()
        Auk = A[unknown][:, known].tocsr()

        # Row-slice P_full to unknown rows; prune near-zero columns level by
        # level, propagating kept columns downward
        # (reference src/min_quad_with_fixed_mg.cpp:181-220).
        mg[1].P = mg[1].P_full.tocsr()[unknown]
        for lv in range(1, len(mg)):
            P = mg[lv].P.tocsc()
            above = sp.csc_matrix(
                (P.data > cfg.prune_threshold, P.indices, P.indptr),
                shape=P.shape,
            )
            keep = np.flatnonzero(
                np.asarray(above.sum(axis=0)).ravel() > 0
            ).astype(np.int64)
            if keep.shape[0] < P.shape[1]:
                mg[lv].P = P[:, keep].tocsr()
                if lv < len(mg) - 1:
                    mg[lv + 1].P = mg[lv + 1].P_full.tocsr()[keep]
            else:
                # nothing pruned at this level: deeper levels keep P_full
                for l2 in range(lv + 1, len(mg)):
                    mg[l2].P = mg[l2].P_full.tocsr()
                break

        mg[0].A = LHS
        for lv in range(1, len(mg)):
            mg[lv].PT = mg[lv].P.T.tocsr()
            mg[lv].A = (mg[lv].PT @ mg[lv - 1].A @ mg[lv].P).tocsr()

    # coarsest diagonal shift (reference :31-36, :236-240)
    Ac = mg[-1].A.tolil()
    Ac.setdiag(Ac.diagonal() + cfg.coarsest_diag_shift)
    mg[-1].A = Ac.tocsr()
    for lv in range(len(mg)):
        mg[lv].A_diag = mg[lv].A.diagonal()
    return known, unknown, LHS, Auk


def min_quad_with_fixed_mg_solve(
    data: MQWFData,
    RHS: np.ndarray,
    known_val: np.ndarray | None = None,
    z0: np.ndarray | None = None,
    tolerance: float = 1e-3,
    max_iter: int = 20,
    refine: bool | None = None,
) -> tuple[np.ndarray, list[float], bool]:
    """Solve; returns (z, r_his, converged) as host numpy / Python values.

    Matches reference loop semantics: residual recorded before each cycle;
    converged iff the last recorded residual <= tolerance
    (src/min_quad_with_fixed_mg.cpp:330-360).

    refine: mixed-precision iterative refinement (V-cycles in the hierarchy
    dtype inside an f64 defect-correction loop, solver/vcycle.py
    solve_loop_ir). None = auto: engage when an f64 finest operator was
    built at precompute (the hierarchy is not f64) and the tolerance is
    below 1e-6 x the initial residual scale, the f32 residual floor.
    """
    RHS = np.asarray(RHS, dtype=np.float64)
    vector_input = RHS.ndim == 1
    if z0 is None:
        z0 = np.zeros_like(RHS)
    z0 = np.asarray(z0, dtype=np.float64)
    if z0.shape != RHS.shape:
        raise ValueError(f"z0 shape {z0.shape} != RHS shape {RHS.shape}")

    if data.known.size:
        if known_val is None:
            raise ValueError("a constrained system needs known_val")
        known_val = np.asarray(known_val, dtype=np.float64)
        if vector_input:
            known_val = known_val.reshape(-1)
        rhs_u = RHS[data.unknown] - (data.Auk @ known_val)
        z_u = z0[data.unknown]
    else:
        rhs_u = RHS
        z_u = z0

    if refine is None:
        init_scale = float(np.linalg.norm(rhs_u)) or 1.0
        refine = data.A64 is not None and tolerance < 1e-6 * init_scale
    if refine and data.A64 is None:
        raise ValueError(
            "refine=True but no f64 finest operator was built at precompute"
            " (the hierarchy is f64 already)"
        )

    dt = torch.float64 if refine else data.dtype
    rhs_d = torch.as_tensor(np.ascontiguousarray(rhs_u)).to(data.device, dt)
    z_d = torch.as_tensor(np.ascontiguousarray(z_u)).to(data.device, dt)
    with profile_region("MG: total VCycle", trace=True):
        if refine:
            z_d, r_his_d, k = solve_loop_ir(
                data.hier, data.A64, rhs_d, z_d, float(tolerance), int(max_iter), data.cfg
            )
        else:
            z_d, r_his_d, k = solve_loop(
                data.hier, rhs_d, z_d, float(tolerance), int(max_iter), data.cfg
            )
        # the copy to the host waits for the last cycle
        z_u = z_d.to("cpu", torch.float64).numpy()
    r_his = [float(r) for r in r_his_d[:k].cpu().numpy()]
    converged = bool(r_his and r_his[-1] <= tolerance)

    if data.known.size:
        z = np.empty_like(z0)
        z[data.unknown] = z_u
        z[data.known] = known_val
    else:
        z = z_u
    return z, r_his, converged
