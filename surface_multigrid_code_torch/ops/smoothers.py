"""V-cycle smoothers (ports ``surface_multigrid_code_tpu/ops/smoothers.py``).

The reference relaxes with sequential in-place Gauss-Seidel
(src/mg_VCycle.cpp:146-177). Its parallel equivalent is multi-color
Gauss-Seidel: a host greedy coloring partitions rows into independent sets,
and within a color every update reads only other-color entries. Damped
Jacobi (w = 2/3) and Chebyshev-accelerated Jacobi are also provided.

Every smoother update is one ``fused_spmv`` call with the epilogue doing
the vector arithmetic; ``dinv`` is the precomputed ``1 / diag(A)``.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from surface_multigrid_code_torch.ops.sparse import CSRMatrix
from surface_multigrid_code_torch.ops.spmv import fused_spmv


def greedy_coloring(A: sp.spmatrix) -> np.ndarray:
    """Greedy graph coloring of A's sparsity (host, once per hierarchy).

    Returns int array color[n]. Rows sharing a structural nonzero (off the
    diagonal) never share a color. Runs in the native engine; the NumPy
    loop serves where the engine cannot be built.
    """
    A = A.tocsr()
    try:
        from surface_multigrid_code_torch.ssp._native import greedy_coloring_csr

        return greedy_coloring_csr(A.indptr, A.indices)
    except (RuntimeError, OSError):
        pass
    n = A.shape[0]
    color = np.full(n, -1, dtype=np.int32)
    indptr, indices = A.indptr, A.indices
    for i in range(n):
        nb = indices[indptr[i]:indptr[i + 1]]
        used = set(color[j] for j in nb if j != i and color[j] >= 0)
        c = 0
        while c in used:
            c += 1
        color[i] = c
    return color


def color_groups(color: np.ndarray) -> list[np.ndarray]:
    """Sorted int32 row ids of each color (no padding, no duplicates)."""
    return [
        np.flatnonzero(color == c).astype(np.int32)
        for c in range(int(color.max(initial=-1)) + 1)
    ]


def multicolor_gs_sweep(
    A: CSRMatrix,
    dinv: torch.Tensor,
    groups: tuple[torch.Tensor, ...],
    b: torch.Tensor,
    u: torch.Tensor,
) -> torch.Tensor:
    """One multi-color GS sweep: per color, u[c] += (b - A u)[c] / d[c].

    Updates ``u`` in place and returns it. One kernel call per color reads
    and writes ``u``; that is race-free because no two rows of one color
    share a structural nonzero, so no row of the color reads an entry that
    another row of the color writes.
    """
    for rows in groups:
        fused_spmv(A, u, epi="axpby", u=u, b=b, s=dinv, rows=rows, out=u)
    return u


def chebyshev_smooth(
    A: CSRMatrix,
    dinv: torch.Tensor,
    lam_max: float,
    b: torch.Tensor,
    u: torch.Tensor,
    degree: int = 2,
    lam_ratio: float = 4.0,
    x_of=None,
) -> torch.Tensor:
    """Chebyshev-accelerated Jacobi smoothing of the given polynomial degree.

    Damps the error on the D^-1 A spectrum interval
    [lam_max / lam_ratio, lam_max] (Adams et al.). Per step: one fused
    scaled residual D^-1 (b - A u) plus axpys. ``x_of(u)`` is the vector A
    reads (the row-partitioned hierarchy's halo exchange); u by default.
    """
    x_of = x_of or (lambda v: v)
    lam_min = lam_max / lam_ratio
    theta = 0.5 * (lam_max + lam_min)
    delta = 0.5 * (lam_max - lam_min)

    r = fused_spmv(A, x_of(u), epi="resid_scaled", b=b, s=dinv)
    d = r / theta
    u = u + d
    sigma = theta / delta
    rho = 1.0 / sigma
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        r = fused_spmv(A, x_of(u), epi="resid_scaled", b=b, s=dinv)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * r
        u = u + d
        rho = rho_new
    return u


def jacobi_sweep(
    A: CSRMatrix,
    dinv: torch.Tensor,
    b: torch.Tensor,
    u: torch.Tensor,
    weight: float = 2.0 / 3.0,
    x_of=None,
) -> torch.Tensor:
    """One damped-Jacobi sweep: u + w * D^-1 (b - A u), as one fused call;
    ``x_of`` as for ``chebyshev_smooth``."""
    x = u if x_of is None else x_of(u)
    return fused_spmv(A, x, epi="axpby", u=u, b=b, s=dinv, escale=weight)
