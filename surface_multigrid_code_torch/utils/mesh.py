"""Mesh helpers the solve path calls (ports part of ``surface_multigrid_code_tpu/utils/mesh.py``).

Only ``boundary_vertices``, ``boundary_loops`` and ``normalize_unit_area``
(with the helpers they need) are carried; the adjacency and quality utilities of the JAX
package serve the decimator and LSCM code, which run in the shared native
engine.
"""

from __future__ import annotations

import numpy as np


def boundary_facets(F: np.ndarray) -> np.ndarray:
    """Boundary edges of a triangle mesh, oriented as they appear in F.

    Analog of igl::boundary_facets: int32 [nb, 2] directed edges that occur
    exactly once among the mesh's directed halfedges.
    """
    F = np.asarray(F, dtype=np.int64)
    src = np.concatenate([F[:, 2], F[:, 0], F[:, 1]])
    dst = np.concatenate([F[:, 1], F[:, 2], F[:, 0]])
    lo = np.minimum(src, dst)
    hi = np.maximum(src, dst)
    key = lo * (F.max() + 1) + hi
    uniq, inv, counts = np.unique(key, return_inverse=True, return_counts=True)
    single = counts[inv] == 1
    return np.stack([src[single], dst[single]], axis=1).astype(np.int32)


def boundary_vertices(F: np.ndarray) -> np.ndarray:
    """Sorted unique vertex ids on the mesh boundary."""
    return np.unique(boundary_facets(F))


def boundary_loops(F: np.ndarray) -> list[np.ndarray]:
    """Ordered boundary loops (longest first).

    Analog of igl::boundary_loop; example 03 and the CLI's ``solve``
    constrain the LONGEST loop only (reference 03_mg_solver/main.cpp:49-51)."""
    bf = boundary_facets(F)
    nxt: dict[int, int] = {}
    for s, d in bf:
        s, d = int(s), int(d)
        if s in nxt:
            # a boundary vertex with two outgoing boundary edges means two
            # loops pinch at it: the walk below would be ill-defined
            raise ValueError(
                f"non-manifold boundary: vertex {s} lies on multiple"
                " boundary loops"
            )
        nxt[s] = d
    seen: set[int] = set()
    loops: list[np.ndarray] = []
    n_edges = len(bf)
    for start in list(nxt):
        if start in seen:
            continue
        loop = [start]
        seen.add(start)
        v = nxt[start]
        while v != start:
            loop.append(v)
            seen.add(v)
            if len(loop) > n_edges:
                raise ValueError("boundary walk did not close: bad input mesh")
            v = nxt[v]
        loops.append(np.asarray(loop, dtype=np.int64))
    loops.sort(key=len, reverse=True)
    return loops


def doublearea(V: np.ndarray, F: np.ndarray) -> np.ndarray:
    """Twice the area of each face (3D positions)."""
    V = np.asarray(V, dtype=np.float64)
    F = np.asarray(F, dtype=np.int64)
    e1 = V[F[:, 1]] - V[F[:, 0]]
    e2 = V[F[:, 2]] - V[F[:, 0]]
    return np.linalg.norm(np.cross(e1, e2), axis=1)


def normalize_unit_area(V: np.ndarray, F: np.ndarray) -> np.ndarray:
    """Rescale to unit surface area; center x/y means, floor z minimum.

    Semantics of reference src/normalize_unit_area.cpp:9-23.
    """
    V = np.asarray(V, dtype=np.float64).copy()
    total = doublearea(V, F).sum() / 2.0
    V /= np.sqrt(total)
    V[:, 0] -= V[:, 0].mean()
    V[:, 1] -= V[:, 1].mean()
    V[:, 2] -= V[:, 2].min()
    return V
