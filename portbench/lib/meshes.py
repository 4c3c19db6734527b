"""The benchmark's own mesh makers: the icosphere and the unit-area normalisation.

Frozen copies, so that the inputs of a cell stay the same whatever later
changes the program makes to its own versions:

- ``icosahedron``, ``midpoint_subdivide`` and ``icosphere`` from
  ``surface_multigrid_code_torch/utils/synthetic.py`` at commit 261c938
  (``midpoint_subdivide`` without its prolongation, which the benchmark
  does not use);
- ``normalize_unit_area`` from ``surface_multigrid_code_torch/utils/mesh.py``
  at commit 261c938 (reference src/normalize_unit_area.cpp:9-23).

Plain numpy; nothing here imports the program.
"""

from __future__ import annotations

import numpy as np


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


def midpoint_subdivide(V: np.ndarray, F: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """One midpoint (4:1) subdivision: the old vertices, then one vertex
    per unique edge at its midpoint; corner faces, then centre faces."""
    V = np.asarray(V, dtype=np.float64)
    F = np.asarray(F, dtype=np.int64)
    n = V.shape[0]
    e = np.concatenate([F[:, [0, 1]], F[:, [1, 2]], F[:, [2, 0]]])
    e = np.sort(e, axis=1)
    E, inv = np.unique(e[:, 0] * (n + 1) + e[:, 1], return_inverse=True)
    edges = np.stack([E // (n + 1), E % (n + 1)], axis=1)
    V2 = np.vstack([V, 0.5 * (V[edges[:, 0]] + V[edges[:, 1]])])
    m = F.shape[0]
    e01 = n + inv[:m]
    e12 = n + inv[m : 2 * m]
    e20 = n + inv[2 * m :]
    F2 = np.concatenate(
        [
            np.stack([F[:, 0], e01, e20], axis=1),
            np.stack([F[:, 1], e12, e01], axis=1),
            np.stack([F[:, 2], e20, e12], axis=1),
            np.stack([e12, e20, e01], axis=1),
        ]
    )
    return V2, F2.astype(np.int64)


def icosphere(n_subdiv: int) -> tuple[np.ndarray, np.ndarray]:
    """The icosahedron after n_subdiv midpoint subdivisions, each projected
    to the unit sphere."""
    V, F = icosahedron()
    for _ in range(n_subdiv):
        V, F = midpoint_subdivide(V, F)
        V = V / np.linalg.norm(V, axis=1, keepdims=True)
    return V, F


def double_areas(V: np.ndarray, F: np.ndarray) -> np.ndarray:
    return np.linalg.norm(np.cross(V[F[:, 1]] - V[F[:, 0]], V[F[:, 2]] - V[F[:, 0]]), axis=1)


def normalize_unit_area(V: np.ndarray, F: np.ndarray) -> np.ndarray:
    """Scale to unit surface area, then zero mean x and y and the lowest z at 0."""
    V = V / np.sqrt(double_areas(V, F).sum() / 2.0)
    center = V.mean(axis=0)
    return V - np.array([center[0], center[1], V[:, 2].min()])


def make_mesh(recipe: dict) -> tuple[np.ndarray, np.ndarray]:
    """The mesh a configuration's ``mesh`` recipe names:
    {"kind": "icosphere", "order": k, "unit_area": bool}."""
    if recipe["kind"] != "icosphere":
        raise ValueError(f"unknown mesh kind {recipe['kind']!r}")
    V, F = icosphere(int(recipe["order"]))
    if recipe.get("unit_area", False):
        V = normalize_unit_area(V, F)
    return V, F
