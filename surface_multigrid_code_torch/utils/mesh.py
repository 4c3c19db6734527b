"""Triangle-mesh adjacency and normalization utilities, host-side NumPy (ports ``surface_multigrid_code_tpu/utils/mesh.py``).

These mirror the libigl helpers the reference leans on (edge_flaps,
is_edge_manifold, connect_boundary_to_infinity, remove_unreferenced,
boundary_facets) with our own array conventions, vectorized over NumPy.

Conventions:
- F is int32 [m, 3], counter-clockwise orientation.
- Undirected edges E are int32 [ne, 2] with E[:, 0] < E[:, 1].
- EMAP is int32 [m, 3]: EMAP[f, c] is the edge opposite corner c of face f,
  i.e. the undirected edge {F[f, (c+1)%3], F[f, (c+2)%3]}.
- EF is int32 [ne, 2]: the (up to two) faces incident on each edge, -1 when
  absent (boundary). EI [ne, 2] holds the corner index opposite the edge in
  the corresponding face (-1 when absent).
"""

from __future__ import annotations

import numpy as np


def edges_and_flaps(
    F: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Unique edge list + flap adjacency; analog of igl::edge_flaps.

    Returns (E, EMAP, EF, EI) per module conventions. Requires an
    edge-manifold mesh (each edge in <= 2 faces); raises ValueError
    otherwise.
    """
    F = np.asarray(F, dtype=np.int64)
    m = F.shape[0]
    # Directed edge opposite corner c: (F[:, (c+1)%3], F[:, (c+2)%3]).
    src = np.concatenate([F[:, 1], F[:, 2], F[:, 0]])
    dst = np.concatenate([F[:, 2], F[:, 0], F[:, 1]])
    lo = np.minimum(src, dst)
    hi = np.maximum(src, dst)
    key = lo * (F.max() + 1) + hi
    uniq, EMAP_flat, counts = np.unique(key, return_inverse=True, return_counts=True)
    if counts.max(initial=0) > 2:
        raise ValueError("mesh is not edge-manifold")
    ne = uniq.shape[0]
    # first occurrence index of each unique edge among directed halfedges
    order = np.argsort(EMAP_flat, kind="stable")
    starts = np.searchsorted(EMAP_flat[order], np.arange(ne))
    first = order[starts]
    E = np.stack([lo[first], hi[first]], axis=1).astype(np.int32)

    EMAP = EMAP_flat.reshape(3, m).T.astype(np.int32)  # [m,3], col c = corner c

    EF = np.full((ne, 2), -1, dtype=np.int32)
    EI = np.full((ne, 2), -1, dtype=np.int32)
    face_of = np.tile(np.arange(m), 3)
    corner_of = np.repeat(np.arange(3), m)
    # Vectorized two-slot fill: within each edge group (sorted stable by
    # EMAP_flat), rank 0 -> slot 0, rank 1 -> slot 1.
    ranks = np.arange(len(order)) - starts[EMAP_flat[order]]
    EF[EMAP_flat[order], ranks] = face_of[order]
    EI[EMAP_flat[order], ranks] = corner_of[order]
    return E, EMAP, EF, EI


def is_edge_manifold(F: np.ndarray) -> bool:
    """True iff every undirected edge has at most two incident faces.

    Analog of igl::is_edge_manifold used as the decimator input gate
    (reference src/SSP_decimate.cpp:20-23).
    """
    F = np.asarray(F, dtype=np.int64)
    src = np.concatenate([F[:, 1], F[:, 2], F[:, 0]])
    dst = np.concatenate([F[:, 2], F[:, 0], F[:, 1]])
    lo = np.minimum(src, dst)
    hi = np.maximum(src, dst)
    key = lo * (F.max() + 1) + hi
    _, counts = np.unique(key, return_counts=True)
    return bool(counts.max(initial=0) <= 2)


def boundary_facets(F: np.ndarray) -> np.ndarray:
    """Boundary edges of a triangle mesh, oriented as they appear in F.

    Analog of igl::boundary_facets: returns int32 [nb, 2] directed edges that
    occur exactly once among the mesh's directed halfedges. Orientation
    follows igl (the returned edge is opposite its corner, i.e. reversed
    relative to the face loop) — consistent with use in the vector-area
    matrix (reference src/vector_area_matrix_size.cpp:35-45).
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
    bf = boundary_facets(F)
    return np.unique(bf)


def boundary_loops(F: np.ndarray) -> list[np.ndarray]:
    """Ordered boundary loops (longest first).

    Analog of igl::boundary_loop; example 03 constrains the LONGEST loop
    only (reference 03_mg_solver/main.cpp:49-51 uses igl::boundary_loop's
    single-loop overload, which returns the longest)."""
    bf = boundary_facets(F)
    nxt: dict[int, int] = {}
    for s, d in bf:
        s, d = int(s), int(d)
        if s in nxt:
            # a boundary vertex with two outgoing boundary edges means two
            # loops pinch at it — the walk below would be ill-defined
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


def connect_boundary_to_infinity(
    V: np.ndarray, F: np.ndarray
) -> tuple[np.ndarray, np.ndarray, int]:
    """Close all boundary loops with a single 'infinity' vertex.

    Analog of igl::connect_boundary_to_infinity, used so the greedy
    decimator can treat every mesh as closed (reference
    src/SSP_midpoint.cpp:31). Returns (V_ext, F_ext, inf_vid) where
    V_ext has one extra row of +inf and F_ext appends one face per
    boundary edge, oriented to keep the surface consistent.
    """
    V = np.asarray(V, dtype=np.float64)
    F = np.asarray(F, dtype=np.int32)
    inf_vid = V.shape[0]
    bf = boundary_facets(F)
    V_ext = np.vstack([V, np.full((1, V.shape[1]), np.inf)])
    if bf.shape[0] == 0:
        return V_ext, F.copy(), inf_vid
    # boundary_facets returns edges reversed w.r.t. face orientation, so the
    # closing face (src, dst, inf) keeps consistent winding.
    extra = np.column_stack(
        [bf[:, 0], bf[:, 1], np.full(bf.shape[0], inf_vid, dtype=np.int32)]
    )
    F_ext = np.vstack([F, extra]).astype(np.int32)
    return V_ext, F_ext, inf_vid


def remove_unreferenced(
    V: np.ndarray, F: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Drop vertices not used by F; analog of igl::remove_unreferenced.

    Returns (V2, F2, IM, J) where IM maps old->new vertex ids (-1 if
    dropped) and J maps new->old.
    """
    V = np.asarray(V)
    F = np.asarray(F, dtype=np.int64)
    used = np.zeros(V.shape[0], dtype=bool)
    if F.size:
        used[F.ravel()] = True
    J = np.nonzero(used)[0]
    IM = np.full(V.shape[0], -1, dtype=np.int64)
    IM[J] = np.arange(J.shape[0])
    F2 = IM[F] if F.size else F.copy()
    return V[J], F2.astype(np.int32), IM.astype(np.int32), J.astype(np.int32)


def doublearea(V: np.ndarray, F: np.ndarray) -> np.ndarray:
    """Twice the area of each face (3D positions)."""
    V = np.asarray(V, dtype=np.float64)
    F = np.asarray(F, dtype=np.int64)
    e1 = V[F[:, 1]] - V[F[:, 0]]
    e2 = V[F[:, 2]] - V[F[:, 0]]
    return np.linalg.norm(np.cross(e1, e2), axis=1)


def normalize_unit_area(V: np.ndarray, F: np.ndarray) -> np.ndarray:
    """Rescale to unit surface area; center x/y means, floor z minimum.

    Semantics of reference src/normalize_unit_area.cpp:9-23 (scale by
    sqrt(total area), subtract x/y column means, subtract z column min).
    """
    V = np.asarray(V, dtype=np.float64).copy()
    total = doublearea(V, F).sum() / 2.0
    V /= np.sqrt(total)
    V[:, 0] -= V[:, 0].mean()
    V[:, 1] -= V[:, 1].mean()
    V[:, 2] -= V[:, 2].min()
    return V


def internal_angles(V: np.ndarray, F: np.ndarray) -> np.ndarray:
    """Per-corner interior angles [m, 3]; angle at corner c (2D or 3D V)."""
    V = np.asarray(V, dtype=np.float64)
    F = np.asarray(F, dtype=np.int64)
    P0, P1, P2 = V[F[:, 0]], V[F[:, 1]], V[F[:, 2]]
    def ang(a, b, c):
        u = b - a
        w = c - a
        nu = np.linalg.norm(u, axis=1)
        nw = np.linalg.norm(w, axis=1)
        denom = np.maximum(nu * nw, 1e-300)
        cosang = np.clip((u * w).sum(axis=1) / denom, -1.0, 1.0)
        return np.arccos(cosang)
    return np.stack([ang(P0, P1, P2), ang(P1, P2, P0), ang(P2, P0, P1)], axis=1)


def triangle_quality(V: np.ndarray, F: np.ndarray) -> np.ndarray:
    """Radius-ratio style quality in [0, 1] per face: 4*sqrt(3)*A / (sum l^2).

    Equilateral triangles score 1, degenerate ones 0. This is the gate used
    by the reference's LSCM boundary cases (quality thresholds 0.3 / 0.01,
    reference src/joint_lscm.cpp:91-117,420).
    """
    V = np.asarray(V, dtype=np.float64)
    F = np.asarray(F, dtype=np.int64)
    if V.shape[1] == 2:
        V = np.column_stack([V, np.zeros(V.shape[0])])
    P0, P1, P2 = V[F[:, 0]], V[F[:, 1]], V[F[:, 2]]
    a2 = ((P1 - P2) ** 2).sum(axis=1)
    b2 = ((P2 - P0) ** 2).sum(axis=1)
    c2 = ((P0 - P1) ** 2).sum(axis=1)
    area = 0.5 * np.linalg.norm(np.cross(P1 - P0, P2 - P0), axis=1)
    denom = np.maximum(a2 + b2 + c2, 1e-300)
    return 4.0 * np.sqrt(3.0) * area / denom
