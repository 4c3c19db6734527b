"""Row-sharded multigrid with a whole-vector gather per SpMV (ports ``surface_multigrid_code_tpu/parallel/spmd.py``).

The JAX module shards every level's rows over a 1-D device mesh and lets
GSPMD insert the collectives of the single-device V-cycle: for a
row-sharded SpMV that is an all-gather of the vector it reads. Here the
same layout runs SPMD over a torch.distributed process group, on
``WellHaloHierarchy``'s replicated mode: the levels in the order given
(no reordering), each padded to D equal blocks of rows (the JAX
``_pad_matrix``, ``spmd.py:47-59``: its identity pad rows, here rows with
no entries and diagonal 1; either keeps the pad at zero), every rank
holding its rows of A, P and Pᵀ with GLOBAL columns and gathering the
whole vector (``Comm.gather_rows``) before each SpMV, then one launch of
K1 (one column) or K2 (C columns). The coarsest level is the host's dense
pseudo-inverse, each rank holding its rows.

``make_row_mesh`` has no counterpart: the process group is the mesh.

The JAX path runs damped Jacobi whatever the smoother asked for (its
levels carry neither Chebyshev bounds nor colors); this one runs Jacobi
or Chebyshev as asked, and raises for multicolor Gauss-Seidel.
"""

from __future__ import annotations

import numpy as np
import torch

from surface_multigrid_code_torch.config import SmootherType, SolveConfig
from surface_multigrid_code_torch.parallel.wellhalo import WellHaloHierarchy


def build_sharded_hierarchy(As, Ps, cfg: SolveConfig | None = None,
                            dtype: torch.dtype = torch.float32, device="cuda",
                            group=None) -> tuple[WellHaloHierarchy, list[int]]:
    """Shard a Galerkin hierarchy (As finest first, Ps[l]: level l+1 ->
    l) over the ranks of ``group``; every rank calls it together. Returns
    (this rank's hierarchy, every level's padded size). cfg: Jacobi unless
    given."""
    hier = WellHaloHierarchy(As, Ps, cfg or SolveConfig(smoother=SmootherType.JACOBI),
                             dtype, device, group, reorder=False, replicate=True)
    return hier, [R * hier.D for R in hier.Rs]


def sharded_solve(hier: WellHaloHierarchy, sizes: list[int], rhs: np.ndarray,
                  z0: np.ndarray | None = None, tolerance: float = 1e-3,
                  max_iter: int = 20):
    """The V-cycle iteration on a row-sharded hierarchy, every rank
    together: rhs [n] or [n, C] (numpy, the same on every rank), padded to
    sizes[0]. Returns (z cropped to n rows, the residual list, the number
    of residuals recorded), as the JAX ``sharded_solve``. The smoother and
    dtype are the hierarchy's."""
    if sizes[0] != hier.Rs[0] * hier.D:
        raise ValueError(f"sizes {sizes} are not this hierarchy's")
    z, r_his, _ = hier.solve(rhs, z0=z0, tolerance=tolerance, max_iter=max_iter)
    return z, r_his, len(r_his)
