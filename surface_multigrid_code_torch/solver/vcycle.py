"""Galerkin multigrid V-cycle on a CUDA device (ports ``surface_multigrid_code_tpu/solver/vcycle.py``).

Mirrors the reference recursion (src/mg_VCycle.cpp:3-59): pre-relax,
residual, restrict (PT @ r), recurse with zero initial guess, prolong and
add (P @ uc), post-relax; the coarsest level applies a dense
nullspace-deflated pseudo-inverse built on the host in f64.

Every smoother update, residual, restriction and prolong-and-add is ONE
``fused_spmv`` call (the fusion of the JAX package's ``_vcycle_tiled``),
on exact level sizes: the TPU's zero-tail padding to 1024-row blocks has
no counterpart here. ``b``/``u`` are ``[n]`` or ``[n, C]`` (C right-hand
sides, which run the multi-column kernel).

PyTorch runs eagerly, so the recursion is a Python loop of kernel
launches, and the solve loops check ``res < tol`` on the host once per
cycle (one device sync per cycle).

While a ``torch.profiler`` session records, the loops open the spans of
``utils.profiler.span``: ``smg.solve`` (the call), ``smg.test`` (the host
read of the residual test), ``smg.cycle`` (each ``vcycle``) and, nested,
``smg.level.<l>`` (each level of the recursion, the coarsest level's dense
correction included). Without a session each costs a flag check.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from surface_multigrid_code_torch.config import SmootherType, SolveConfig
from surface_multigrid_code_torch.ops.smoothers import (
    chebyshev_smooth,
    color_groups,
    greedy_coloring,
    jacobi_sweep,
    multicolor_gs_sweep,
)
from surface_multigrid_code_torch.ops.sparse import CSRMatrix, csr_from_scipy
from surface_multigrid_code_torch.ops.spmv import fused_spmv
from surface_multigrid_code_torch.utils.profiler import profile_region, span

# The coarse correction coarse_inv @ b is a plain dense matmul. TF32 would
# round its inputs to a 10-bit mantissa (about three digits) and cap every
# f32 solve near 1e-3 relative residual; keep full-precision f32 products.
torch.backends.cuda.matmul.allow_tf32 = False


class DeviceLevel(nn.Module):
    """Per-level device data; P/PT map this level to the next-finer level
    (as in reference mg_data: mg[lv].P is n_{lv-1} x n_lv), None at level 0.

    diag / dinv: diag(A) and 1 / diag(A). groups: int32 row ids of each GS
    color (empty when the smoother is not multicolor GS, and at the
    coarsest level). lam_max: bound on the largest eigenvalue of D^-1 A
    (Chebyshev smoothing only).
    """

    def __init__(self, A: CSRMatrix, diag: torch.Tensor,
                 P: CSRMatrix | None = None, PT: CSRMatrix | None = None,
                 groups: tuple[torch.Tensor, ...] = (),
                 lam_max: float | None = None):
        super().__init__()
        self.A = A
        self.P = P
        self.PT = PT
        self.register_buffer("diag", diag)
        self.register_buffer("dinv", 1.0 / diag)
        self.n_groups = len(groups)
        for i, g in enumerate(groups):
            self.register_buffer(f"group_{i}", g)
        self.lam_max = lam_max

    @property
    def groups(self) -> tuple[torch.Tensor, ...]:
        return tuple(getattr(self, f"group_{i}") for i in range(self.n_groups))


class DeviceHierarchy(nn.Module):
    """The levels, finest first, and the dense (pseudo-)inverse of the coarsest A."""

    def __init__(self, levels: list[DeviceLevel], coarse_inv: torch.Tensor):
        super().__init__()
        self.levels = nn.ModuleList(levels)
        self.register_buffer("coarse_inv", coarse_inv)

    @property
    def n_levels(self) -> int:
        return len(self.levels)


def coarse_pseudo_inverse(Ac: sp.spmatrix) -> np.ndarray:
    """Nullspace-deflated pseudo-inverse of the coarsest operator (host f64).

    The reference prefactorizes with SimplicialLDLT after a +1e-12 diagonal
    shift (src/min_quad_with_fixed_mg.cpp:31-48). The 1e-12 shift is below
    f32 epsilon, so a factorization of the singular unconstrained Laplacian
    would blow up in f32; eigenvalues below 1e-10 |lambda|max are deflated
    instead, and the result is applied as one dense matmul.
    """
    Ac = np.asarray(Ac.todense(), dtype=np.float64)
    Ac = 0.5 * (Ac + Ac.T)
    w, U = np.linalg.eigh(Ac)
    cutoff = max(1e-10 * float(np.abs(w).max()), 1e-300)
    inv_w = np.where(np.abs(w) > cutoff, 1.0 / np.where(w == 0, 1.0, w), 0.0)
    return (U * inv_w) @ U.T


def build_device_hierarchy(
    As: list[sp.spmatrix],
    Ps: list[sp.spmatrix],
    cfg: SolveConfig = SolveConfig(),
    *,
    device,
    dtype: torch.dtype = torch.float32,
    colorings: list[np.ndarray] | None = None,
) -> DeviceHierarchy:
    """Host -> device hierarchy build.

    As: per-level Galerkin matrices (len L), coarsest already diag-shifted.
    Ps: prolongations, Ps[l] maps level l+1 -> level l (len L-1).
    colorings: optional cached row colorings (sparsity is static across
    value refreshes).

    Its two phases record as ``smg.precompute.device_build`` and
    ``smg.precompute.coarse_inverse`` on every call, inside a precompute
    or not.
    """
    L = len(As)
    levels = []
    with profile_region("smg.precompute.device_build", trace=True):
        for lv in range(L):
            A = sp.csr_matrix(As[lv])
            diag = torch.as_tensor(A.diagonal(), dtype=torch.float64).to(device, dtype)
            groups = ()
            if cfg.smoother == SmootherType.MULTICOLOR_GS and lv < L - 1:
                color = colorings[lv] if colorings is not None else greedy_coloring(A)
                groups = tuple(
                    torch.as_tensor(g, device=device) for g in color_groups(color)
                )
            P = PT = None
            if lv > 0:
                P = csr_from_scipy(Ps[lv - 1], device, dtype)
                PT = csr_from_scipy(sp.csr_matrix(Ps[lv - 1]).T.tocsr(), device, dtype)
            lam_max = None
            if cfg.smoother == SmootherType.CHEBYSHEV:
                lam_max = _power_iteration_lam_max(A)
            levels.append(DeviceLevel(
                csr_from_scipy(A, device, dtype), diag, P, PT, groups, lam_max,
            ))
    with profile_region("smg.precompute.coarse_inverse", trace=True):
        Cinv = torch.as_tensor(coarse_pseudo_inverse(As[-1])).to(device=device, dtype=dtype)
    return DeviceHierarchy(levels, Cinv)


def _power_iteration_lam_max(A: sp.spmatrix, iters: int = 20) -> float:
    """Largest eigenvalue of D^-1 A via host power iteration (Chebyshev
    smoothing bound); 10% safety margin as is conventional."""
    dinv = 1.0 / A.diagonal()
    rng = np.random.default_rng(0)
    x = rng.normal(size=A.shape[0])
    lam = 1.0
    for _ in range(iters):
        x = dinv * (A @ x)
        lam = np.linalg.norm(x)
        x /= lam
    return 1.1 * float(lam)


def _relax(level: DeviceLevel, b, u, cfg: SolveConfig, n_iter: int):
    """n_iter relaxation steps (the reference's `relax` x N,
    src/mg_VCycle.cpp:36,57,113-178). Multicolor GS updates u in place."""
    if cfg.smoother == SmootherType.CHEBYSHEV and level.lam_max is not None:
        return chebyshev_smooth(level.A, level.dinv, level.lam_max, b, u,
                                degree=n_iter)
    groups = level.groups if cfg.smoother == SmootherType.MULTICOLOR_GS else ()
    for _ in range(n_iter):
        if groups:
            u = multicolor_gs_sweep(level.A, level.dinv, groups, b, u)
        else:
            u = jacobi_sweep(level.A, level.dinv, b, u, weight=cfg.jacobi_weight)
    return u


def vcycle(
    hier: DeviceHierarchy,
    b: torch.Tensor,
    u: torch.Tensor,
    cfg: SolveConfig = SolveConfig(),
) -> torch.Tensor:
    """One V-cycle on the finest level; returns a new tensor (u is not modified).

    b/u: flat [n] or multi-column [n, C].
    """
    L = hier.n_levels

    def go(lv: int, B, U):
        level = hier.levels[lv]
        if lv == L - 1:
            # additive coarse correction (reference src/mg_VCycle.cpp:181-201)
            return U + hier.coarse_inv @ B
        U = _relax(level, B, U, cfg, cfg.pre_relax_iter)
        r = fused_spmv(level.A, U, epi="resid", b=B)
        nxt = hier.levels[lv + 1]
        rc = fused_spmv(nxt.PT, r)
        with span(f"smg.level.{lv + 1}"):
            uc = go(lv + 1, rc, torch.zeros_like(rc))
        U = fused_spmv(nxt.P, uc, epi="add", u=U)
        return _relax(level, B, U, cfg, cfg.post_relax_iter)

    # the in-place GS sweeps must not write into the caller's u
    with span("smg.cycle"), span("smg.level.0"):
        return go(0, b, u.clone())


def _residual_norm(A: CSRMatrix, z, rhs) -> torch.Tensor:
    r = fused_spmv(A, z, epi="resid", b=rhs)
    return torch.sqrt((r * r).sum())


def solve_loop(
    hier: DeviceHierarchy,
    rhs: torch.Tensor,
    z0: torch.Tensor,
    tol: float,
    max_iter: int,
    cfg: SolveConfig,
) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Reference solve loop (src/min_quad_with_fixed_mg.cpp:330-347):
    each iteration records ||rhs - A z|| (Frobenius norm for multi-RHS),
    stops *before* cycling when below tol. Returns (z, r_his, n_recorded);
    r_his is padded to max_iter with -1.
    """
    A0 = hier.levels[0].A
    tol_t = torch.tensor(tol, dtype=rhs.dtype, device=rhs.device)
    r_his = torch.full((max_iter,), -1.0, dtype=rhs.dtype, device=rhs.device)
    z = z0
    k = 0
    with span("smg.solve"):
        while k < max_iter:
            res = _residual_norm(A0, z, rhs)
            r_his[k] = res
            k += 1
            with span("smg.test"):
                done = bool(res < tol_t)
            if done:
                break
            z = vcycle(hier, rhs, z, cfg)
    return z, r_his, k


def solve_loop_ir(
    hier: DeviceHierarchy,
    A64: CSRMatrix,
    rhs: torch.Tensor,
    z0: torch.Tensor,
    tol: float,
    max_iter: int,
    cfg: SolveConfig,
) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Mixed-precision iterative refinement: f32 V-cycles inside an f64
    defect-correction loop (DESIGN.md "Precision policy").

        r_k = b - A z_k          (f64, A64 = finest operator in f64)
        e_k = Vcycle(r_k, 0)     (hierarchy dtype)
        z_{k+1} = z_k + e_k      (f64 accumulate)

    A V-cycle is an affine iteration u + B(b - A u) with linear B, so in
    exact arithmetic these iterates equal solve_loop's; r_his has the same
    semantics, but the attainable floor is f64's instead of f32's.
    """
    cycle_dtype = hier.levels[0].diag.dtype
    rhs = rhs.to(torch.float64)
    tol_t = torch.tensor(tol, dtype=torch.float64, device=rhs.device)
    r_his = torch.full((max_iter,), -1.0, dtype=torch.float64, device=rhs.device)
    z = z0.to(torch.float64)
    k = 0
    with span("smg.solve"):
        while k < max_iter:
            r = fused_spmv(A64, z, epi="resid", b=rhs)
            res = torch.sqrt((r * r).sum())
            r_his[k] = res
            k += 1
            with span("smg.test"):
                done = bool(res < tol_t)
            if done:
                break
            rl = r.to(cycle_dtype)
            e = vcycle(hier, rl, torch.zeros_like(rl), cfg)
            z = z + e.to(torch.float64)
    return z, r_his, k
