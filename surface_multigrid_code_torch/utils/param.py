"""Disk parameterization (ports ``surface_multigrid_code_tpu/utils/param.py``; reference
`06_example_balloon_sim/sim_utils/project_to_disk.cpp:8-24`).

Given a disk-topology mesh, map the (longest) boundary loop to the unit
circle by cumulative arc length (igl::map_vertices_to_circle semantics)
and place interior vertices by a k=1 harmonic solve on the uniform graph
Laplacian (the reference's `igl::harmonic(F, b, bc, 1, UV)` overload —
no V, so uniform weights), then emit U = [u, 0, -v] exactly as the
reference does (it flips UV's second column before assembling).

The reference never calls this outside its own file; provided for
completeness.  Tutte's theorem guarantees a flip-free embedding for a
convex boundary, which the circle is.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

# the guarded walk (non-manifold pinch + unclosed-loop ValueErrors) lives
# in utils.mesh; re-exported here because project_to_disk callers need it
from surface_multigrid_code_torch.utils.mesh import boundary_loops  # noqa: F401


def map_vertices_to_circle(V: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Unit-circle positions for the ordered boundary loop `b`,
    spaced by cumulative 3D arc length (igl::map_vertices_to_circle)."""
    V = np.asarray(V, dtype=np.float64)
    P = V[b]
    seg = np.linalg.norm(np.roll(P, -1, axis=0) - P, axis=1)
    total = seg.sum()
    theta = 2.0 * np.pi * np.concatenate([[0.0], np.cumsum(seg[:-1])]) / total
    return np.stack([np.cos(theta), np.sin(theta)], axis=1)


def project_to_disk(V: np.ndarray, F: np.ndarray) -> np.ndarray:
    """U [n,3] = [u, 0, -v] Tutte embedding in the unit disk."""
    V = np.asarray(V, dtype=np.float64)
    F = np.asarray(F, dtype=np.int64)
    loops = boundary_loops(F)
    if not loops:
        raise ValueError("project_to_disk requires a boundary (disk topology)")
    b = loops[0]
    bc = map_vertices_to_circle(V, b)

    n = V.shape[0]
    # uniform graph Laplacian on the mesh edges
    E = np.unique(
        np.sort(F[:, [0, 1, 1, 2, 2, 0]].reshape(-1, 2), axis=1), axis=0
    )
    W = sp.coo_matrix(
        (np.ones(2 * E.shape[0]),
         (np.concatenate([E[:, 0], E[:, 1]]),
          np.concatenate([E[:, 1], E[:, 0]]))),
        shape=(n, n),
    ).tocsr()
    L = sp.diags(np.asarray(W.sum(axis=1)).ravel()) - W

    interior = np.setdiff1d(np.arange(n), b)
    UV = np.zeros((n, 2))
    UV[b] = bc
    Lii = L[interior][:, interior].tocsc()
    rhs = -L[interior][:, b] @ bc
    UV[interior] = spla.spsolve(Lii, rhs)

    U = np.zeros((n, 3))
    U[:, 0] = UV[:, 0]
    U[:, 2] = -UV[:, 1]
    return U
