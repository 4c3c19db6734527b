"""Plain cotangent Laplacian and barycentric mass, in float64 numpy and scipy.

Written for the benchmark from the formulas, not taken from the program:
the Laplacian is libigl's ``cotmatrix`` (negative semi-definite, L[i, j] =
(cot a + cot b) / 2 over the two angles facing edge ij), the mass is
libigl's barycentric lumping (a third of each face's area to each of its
corners), as the upstream's example 05 uses them
(05_example_mean_curvature_flow/main.cpp:55-60).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def face_double_areas(V: np.ndarray, F: np.ndarray) -> np.ndarray:
    """Twice the area of each face."""
    return np.linalg.norm(np.cross(V[F[:, 1]] - V[F[:, 0]], V[F[:, 2]] - V[F[:, 0]]), axis=1)


def barycentric_mass(V: np.ndarray, F: np.ndarray) -> np.ndarray:
    """The diagonal of the barycentric mass matrix: [n]."""
    third = face_double_areas(V, F) / 6.0
    return np.bincount(F.ravel(), weights=np.repeat(third, 3), minlength=V.shape[0])


def cotmatrix(V: np.ndarray, F: np.ndarray) -> sp.csr_matrix:
    """The cotangent Laplacian L [n, n] (CSR, duplicates summed)."""
    n = V.shape[0]
    rows, cols, vals = [], [], []
    for c in range(3):
        # the angle at corner c faces the edge (c + 1, c + 2)
        i, j, k = F[:, c], F[:, (c + 1) % 3], F[:, (c + 2) % 3]
        a, b = V[j] - V[i], V[k] - V[i]
        half_cot = 0.5 * (a * b).sum(axis=1) / np.linalg.norm(np.cross(a, b), axis=1)
        rows += [j, k, j, k]
        cols += [k, j, j, k]
        vals += [half_cot, half_cot, -half_cot, -half_cot]
    L = sp.csr_matrix((np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
                      shape=(n, n))
    L.sum_duplicates()
    return L


def screened_operator(mass: np.ndarray, L: sp.csr_matrix, delta: float) -> sp.csr_matrix:
    """A = M - delta L with M = diag(mass)."""
    return (sp.diags(mass) - delta * L).tocsr()
