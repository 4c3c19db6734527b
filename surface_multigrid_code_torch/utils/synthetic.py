"""Synthetic meshes + subdivision hierarchies (ports ``surface_multigrid_code_tpu/utils/synthetic.py``).

Provides an icosphere generator and midpoint-subdivision prolongation
operators, giving a ground-truth multigrid hierarchy independent of the
SSP decimation pipeline.
"""


from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def icosahedron() -> tuple[np.ndarray, np.ndarray]:
    t = (1.0 + np.sqrt(5.0)) / 2.0
    V = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=np.float64,
    )
    V /= np.linalg.norm(V, axis=1, keepdims=True)
    F = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )
    return V, F


def midpoint_subdivide(
    V: np.ndarray, F: np.ndarray
) -> tuple[np.ndarray, np.ndarray, sp.csr_matrix]:
    """One midpoint (4:1) subdivision; returns (V2, F2, P) where
    P is the #V2 x #V linear prolongation (identity on old vertices,
    1/2-1/2 on edge midpoints)."""
    V = np.asarray(V, dtype=np.float64)
    F = np.asarray(F, dtype=np.int64)
    n = V.shape[0]
    # unique undirected edges
    e = np.concatenate([F[:, [0, 1]], F[:, [1, 2]], F[:, [2, 0]]])
    e = np.sort(e, axis=1)
    E, inv = np.unique(e[:, 0] * (n + 1) + e[:, 1], return_inverse=True)
    ne = E.shape[0]
    edges = np.stack([E // (n + 1), E % (n + 1)], axis=1)
    mids = 0.5 * (V[edges[:, 0]] + V[edges[:, 1]])
    V2 = np.vstack([V, mids])
    m = F.shape[0]
    e01 = n + inv[:m]
    e12 = n + inv[m : 2 * m]
    e20 = n + inv[2 * m :]
    # 4 face blocks; ordering matches the reference's neuralSubdiv-compatible
    # connectivity (09_random_subdiv_remesh/main.cpp:84-106): corner faces
    # then center faces (e12, e20, e01)
    F2 = np.concatenate(
        [
            np.stack([F[:, 0], e01, e20], axis=1),
            np.stack([F[:, 1], e12, e01], axis=1),
            np.stack([F[:, 2], e20, e12], axis=1),
            np.stack([e12, e20, e01], axis=1),
        ]
    )
    rows = np.concatenate([np.arange(n), np.arange(n, n + ne), np.arange(n, n + ne)])
    cols = np.concatenate([np.arange(n), edges[:, 0], edges[:, 1]])
    vals = np.concatenate([np.ones(n), np.full(ne, 0.5), np.full(ne, 0.5)])
    P = sp.coo_matrix((vals, (rows, cols)), shape=(n + ne, n)).tocsr()
    return V2, F2.astype(np.int64), P


def icosphere(n_subdiv: int, project: bool = True):
    """Icosphere after n_subdiv midpoint subdivisions (projected to unit
    sphere); returns (V, F)."""
    V, F = icosahedron()
    for _ in range(n_subdiv):
        V, F, _ = midpoint_subdivide(V, F)
        if project:
            V = V / np.linalg.norm(V, axis=1, keepdims=True)
    return V, F


def subdivision_hierarchy(n_subdiv: int, project: bool = True):
    """Hierarchy of (V_l, F_l) + prolongations for the V-cycle unit tests.

    Level 0 is the finest (n_subdiv subdivisions); Ps[l] maps level l+1
    (coarser) to level l (finer), matching mg_data's P orientation.
    """
    meshes = [icosahedron()]
    Ps_up = []  # P for each subdivision step: maps coarse -> fine
    V, F = meshes[0]
    for _ in range(n_subdiv):
        V2, F2, P = midpoint_subdivide(V, F)
        if project:
            V2 = V2 / np.linalg.norm(V2, axis=1, keepdims=True)
        meshes.append((V2, F2))
        Ps_up.append(P)
        V, F = V2, F2
    meshes = meshes[::-1]  # finest first
    Ps = Ps_up[::-1]
    return meshes, Ps


def drum(n: int, height: float = 1.0):
    """A closed drum: two rings of n vertices on the unit circle at z =
    ±height/2, each capped by a fan around a centre vertex of valence n,
    joined by a band of 2n side faces (2n + 2 vertices, 4n faces).
    Decimated, its fans collapse into records of ~n vertices, larger than
    any record of the icosphere logs; returns (V, F)."""
    t = 2.0 * np.pi * np.arange(n) / n
    ring = np.stack([np.cos(t), np.sin(t)], axis=1)
    z = np.full((n, 1), height / 2.0)
    V = np.vstack([np.hstack([ring, z]), np.hstack([ring, -z]),
                   [[0.0, 0.0, height / 2.0], [0.0, 0.0, -height / 2.0]]])
    i = np.arange(n)
    j = (i + 1) % n
    top, bottom = np.full(n, 2 * n), np.full(n, 2 * n + 1)
    F = np.vstack([np.stack([top, i, j], 1), np.stack([bottom, n + j, n + i], 1),
                   np.stack([i, n + i, n + j], 1), np.stack([i, n + j, j], 1)])
    return V, F.astype(np.int64)
