"""Block-sparse (BSR, 3x3 blocks) multigrid for vertex-vector systems (ports ``surface_multigrid_code_tpu/solver/bsr.py``).

The balloon solves H dx = -g with H = M + dt^2 K on 3 #V unknowns
(reference implicit_euler_mg_balloon.h:67-78). H is kept as 3x3 blocks on
the VERTEX graph and the V-cycle runs on [nv, 3] states:

  - every block smoother update, residual and power-iteration product is
    one launch of K3 (``ops/bsr_spmv.fused_bsr_spmv``) with its epilogue;
  - restriction and prolongation use the SCALAR SSP hierarchy on [nv, 3]
    (the reference's 3-expanded block P, src/get_prolong.cpp:59-115, is
    the same scalar weight on each of a vertex's 3 unknowns), one launch
    of K2 (``ops/spmv.fused_spmv`` with C = 3) each;
  - the coarsest level applies a dense 3nc x 3nc Cholesky inverse.

``BsrRefreshableSolver`` keeps the hierarchy and the vertex pattern fixed
and refreshes the block values every solve through the cached symbolic
Galerkin plan (``solver/galerkin.py``). Each level's operator is a BSR-CSR
on the level pattern (``plan_pattern``) whose values are the plan's nnz
vector as it stands: the plan's output order is the canonical CSR order
of the level pattern.

PyTorch runs eagerly, so the V-cycle is a Python loop of launches and the
solve loop checks ``res < tol`` on the host once per cycle (one device
sync per cycle). The JAX package's TPU layout work (windowed block
kernels in planes layout, the RCM-permuted hierarchy, the windowed
refresh chain) has no counterpart here.
"""

from __future__ import annotations

import math

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from surface_multigrid_code_torch.config import SmootherType, SolveConfig
from surface_multigrid_code_torch.ops.bsr_spmv import fused_bsr_spmv
from surface_multigrid_code_torch.ops.sparse import (
    BSRMatrix,
    CSRMatrix,
    csr_from_scipy,
    row_ids,
)
from surface_multigrid_code_torch.ops.spmv import fused_spmv
from surface_multigrid_code_torch.solver.galerkin import (
    DevicePlanLevel,
    GalerkinPlan,
    build_galerkin_plan,
    device_plan,
    refresh_values,
)
from surface_multigrid_code_torch.utils.device import resolve_device

# The coarse correction coarse_inv @ b is a plain dense matmul; TF32 would
# round its inputs to a 10-bit mantissa. Keep full-precision f32 products.
torch.backends.cuda.matmul.allow_tf32 = False

__all__ = [
    "BSRMatrix",
    "BsrHierarchy",
    "BsrLevel",
    "BsrRefreshableSolver",
    "bsr_solve_loop",
    "bsr_vcycle",
    "refresh_block_values",
]


class BsrLevel(nn.Module):
    """One level: the block operator, its block diagonal's scalar entries
    ``diag`` [nv, 3] (and their inverse ``dinv``), the scalar P/PT to the
    next-finer level (None at level 0), and the Chebyshev bound lam_max on
    lam_max(D^-1 A) (None where Chebyshev does not run)."""

    def __init__(self, A: BSRMatrix, diag: torch.Tensor,
                 P: CSRMatrix | None = None, PT: CSRMatrix | None = None,
                 lam_max: float | None = None):
        super().__init__()
        self.A = A
        self.P = P
        self.PT = PT
        self.register_buffer("diag", diag)
        self.register_buffer("dinv", 1.0 / diag)
        self.lam_max = lam_max


class BsrHierarchy(nn.Module):
    """The levels, finest first, and the dense inverse of the 3nc x 3nc coarsest."""

    def __init__(self, levels: list[BsrLevel], coarse_inv: torch.Tensor):
        super().__init__()
        self.levels = nn.ModuleList(levels)
        self.register_buffer("coarse_inv", coarse_inv)

    @property
    def n_levels(self) -> int:
        return len(self.levels)


def _bsr_relax(level: BsrLevel, b, u, cfg: SolveConfig, n_iter: int):
    """n_iter Chebyshev or damped-Jacobi steps; each residual is one K3
    launch with the D^-1 scaling in its epilogue."""
    if cfg.smoother == SmootherType.CHEBYSHEV and level.lam_max is not None:
        lam_max = level.lam_max
        lam_min = lam_max / 4.0
        theta = 0.5 * (lam_max + lam_min)
        delta = 0.5 * (lam_max - lam_min)
        r = fused_bsr_spmv(level.A, u, "resid_scaled", b=b, s=level.dinv)
        d = r / theta
        u = u + d
        sigma = theta / delta
        rho = 1.0 / sigma
        for _ in range(n_iter - 1):
            rho_new = 1.0 / (2.0 * sigma - rho)
            r = fused_bsr_spmv(level.A, u, "resid_scaled", b=b, s=level.dinv)
            d = rho_new * rho * d + (2.0 * rho_new / delta) * r
            u = u + d
            rho = rho_new
        return u
    for _ in range(n_iter):
        u = fused_bsr_spmv(level.A, u, "axpby", u=u, b=b, s=level.dinv,
                           escale=cfg.jacobi_weight)
    return u


def bsr_vcycle(hier: BsrHierarchy, b, u, cfg: SolveConfig):
    """One V-cycle on [nv, 3] states (reference schedule, pre + post
    relaxation); returns a new tensor."""

    def go(lv, B, U):
        level = hier.levels[lv]
        if lv == hier.n_levels - 1:
            nc = level.A.n_rows
            corr = (hier.coarse_inv @ B.reshape(3 * nc)).reshape(nc, 3)
            return U + corr
        U = _bsr_relax(level, B, U, cfg, cfg.pre_relax_iter)
        r = fused_bsr_spmv(level.A, U, "resid", b=B)
        nxt = hier.levels[lv + 1]
        rc = fused_spmv(nxt.PT, r)  # [nvc, 3]: scalar weights on 3-vectors
        uc = go(lv + 1, rc, torch.zeros_like(rc))
        U = fused_spmv(nxt.P, uc, epi="add", u=U)
        return _bsr_relax(level, B, U, cfg, cfg.post_relax_iter)

    return go(0, b, u)


def bsr_solve_loop(hier: BsrHierarchy, rhs, z0, tol: float, max_iter: int,
                   cfg: SolveConfig):
    """V-cycle iteration with residual history (reference
    src/min_quad_with_fixed_mg.cpp:324-339 semantics: absolute 2-norm over
    all 3nv entries, recorded BEFORE each cycle; the loop stops before
    cycling once it is below tol). Returns (z, r_his, k): r_his is
    [max_iter], zero past the k recorded residuals."""
    A0 = hier.levels[0].A
    tol_t = torch.tensor(tol, dtype=rhs.dtype, device=rhs.device)
    r_his = torch.zeros((max_iter,), dtype=rhs.dtype, device=rhs.device)
    z = z0
    k = 0
    while k < max_iter:
        r = fused_bsr_spmv(A0, z, "resid", b=rhs)
        res = torch.sqrt((r * r).sum())
        r_his[k] = res
        k += 1
        if bool(res < tol_t):  # the one host sync of the cycle
            break
        z = bsr_vcycle(hier, rhs, z, cfg)
    return z, r_his, k


def _bsr_gershgorin_lam(A: BSRMatrix, diag):
    """Gershgorin UPPER bound on lam_max(D^-1 A): max_i sum_j |a_ij| / d_i
    over the 3nv scalar rows. Guaranteed safe but loose on shell Hessians
    (the JAX package measured the tol-2e-1 balloon solve failing to
    converge in 20 cycles with it); power iteration is the default, and
    this bound is kept for callers that want the certified window."""
    rowsum = torch.zeros_like(diag).index_add_(
        0, row_ids(A.indptr, A.nnz), A.blocks.abs().sum(dim=-1))
    return (rowsum / diag.abs()).max()


def _bsr_device_lam_max(A: BSRMatrix, diag, iters: int = 12):
    """Power iteration for lam_max(D^-1 A) on [nv, 3] states from the
    uniform start; 1.1x safety margin. Returns a 0-d device tensor."""
    x = torch.full((A.n_rows, 3), 1.0 / math.sqrt(3.0 * A.n_rows),
                   dtype=diag.dtype, device=diag.device)
    lam = torch.ones((), dtype=diag.dtype, device=diag.device)
    for _ in range(iters):
        y = fused_bsr_spmv(A, x) / diag
        lam = torch.sqrt((y * y).sum())
        x = y / lam
    return 1.1 * lam


def refresh_block_values(plans: list[DevicePlanLevel], B0_vals: torch.Tensor):
    """``refresh_values`` over [nnz, 3, 3] blocks on the VERTEX pattern
    (scalar P weights: vals_out[k] = sum w_a w_c B_in[b]). Returns per
    level (blocks [nnz, 3, 3] in the level's canonical CSR order, diag3
    [n, 3]: the scalar diagonal of each diagonal block), finest first."""
    return [(v, torch.diagonal(d, dim1=1, dim2=2)) for v, d in refresh_values(plans, B0_vals)]


class BsrRefreshableSolver:
    """Fixed SCALAR hierarchy + fixed vertex sparsity; per-solve 3x3-block
    value refresh. ``mg`` is from ``mg_precompute`` (vertex level);
    ``pattern_v`` is the vertex-graph CSR every refreshed block matrix
    shares (diagonal required). Pointwise smoothers only (Chebyshev, the
    default, or Jacobi)."""

    def __init__(self, mg, pattern_v: sp.spmatrix,
                 cfg: SolveConfig | None = None, dtype=torch.float32,
                 coarsest_shift: float = 1e-12, device="cuda"):
        self.cfg = cfg or SolveConfig(smoother=SmootherType.CHEBYSHEV)
        if self.cfg.smoother not in (SmootherType.CHEBYSHEV, SmootherType.JACOBI):
            raise ValueError("the BSR path takes pointwise smoothers (Chebyshev, Jacobi)")
        self.dtype = dtype
        self.device = resolve_device(device)
        self.coarsest_shift = float(coarsest_shift)
        Av = pattern_v.tocsr().copy()
        Av.sum_duplicates()
        self.pattern_v = Av
        Ps = [mg[lv].P_full.tocsr() for lv in range(1, len(mg))]
        self.plan: GalerkinPlan = build_galerkin_plan(Av, Ps)
        self.plans = device_plan(self.plan, Av, self.device, dtype)
        self.P = [csr_from_scipy(P, self.device, dtype) for P in Ps]
        self.PT = [csr_from_scipy(P.T.tocsr(), self.device, dtype) for P in Ps]

    def _coarse_inverse(self, pl_: DevicePlanLevel, blocks: torch.Tensor):
        """Dense 3nc x 3nc coarsest operator (+ the diagonal shift), then
        its Cholesky inverse (refreshed operators are SPD)."""
        nc = pl_.n
        rows = row_ids(pl_.indptr, pl_.nnz_out)
        k3 = torch.arange(3, device=blocks.device)
        r3 = (3 * rows[:, None, None] + k3[None, :, None]).expand(-1, 3, 3)
        c3 = (3 * pl_.indices.long()[:, None, None] + k3[None, None, :]).expand(-1, 3, 3)
        dense = torch.zeros((3 * nc, 3 * nc), dtype=blocks.dtype, device=blocks.device)
        dense.index_put_((r3, c3), blocks, accumulate=True)
        dense += self.coarsest_shift * torch.eye(3 * nc, dtype=blocks.dtype,
                                                 device=blocks.device)
        return torch.cholesky_inverse(torch.linalg.cholesky(dense))

    def refresh(self, B0_vals: torch.Tensor) -> BsrHierarchy:
        """The block hierarchy for finest-level values B0_vals [nnz_v, 3, 3]
        (canonical order of ``pattern_v``): Galerkin refresh, Chebyshev
        bounds by power iteration on every level but the coarsest (one host
        sync for all of them), and the coarse inverse."""
        vals = refresh_block_values(
            self.plans, B0_vals.to(device=self.device, dtype=self.dtype))
        L = len(vals)
        mats = [BSRMatrix(pl_.indptr, pl_.indices, blocks.contiguous(), pl_.n)
                for pl_, (blocks, _) in zip(self.plans, vals)]
        lams: list[float | None] = [None] * L
        if self.cfg.smoother == SmootherType.CHEBYSHEV and L > 1:
            est = [_bsr_device_lam_max(A, d3, iters=self.cfg.lam_power_iters)
                   for A, (_, d3) in zip(mats[:-1], vals[:-1])]
            lams[:-1] = torch.stack(est).tolist()
        levels = [
            BsrLevel(A, d3, None if lv == 0 else self.P[lv - 1],
                     None if lv == 0 else self.PT[lv - 1], lams[lv])
            for lv, (A, (_, d3)) in enumerate(zip(mats, vals))
        ]
        inv = self._coarse_inverse(self.plans[-1], vals[-1][0])
        return BsrHierarchy(levels, inv)

    def solve(self, B0_vals, rhs, z0=None, tolerance: float = 1e-3,
              max_iter: int = 20):
        """Refresh + iterate. B0_vals [nnz_v, 3, 3]; rhs flat [3nv] or
        [nv, 3]. Returns (z flat [3nv] f64 numpy, r_his list, converged)."""
        nv = self.pattern_v.shape[0]
        t = (lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64).reshape(nv, 3))
             .to(device=self.device, dtype=self.dtype))
        rhs_t = t(rhs)
        z0_t = torch.zeros_like(rhs_t) if z0 is None else t(z0)
        hier = self.refresh(torch.as_tensor(B0_vals))
        z, r_his, k = bsr_solve_loop(hier, rhs_t, z0_t, float(tolerance), max_iter, self.cfg)
        r_list = [float(r) for r in r_his[:k].cpu()]
        z = z.cpu().to(torch.float64).numpy().reshape(3 * nv)
        return z, r_list, bool(r_list and r_list[-1] <= tolerance)
