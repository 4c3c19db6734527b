"""Cotangent Laplacian and mass-matrix assembly (ports ``surface_multigrid_code_tpu/ops/laplacian.py``).

Host code returning scipy.sparse CSR, used by precompute, ``cotmatrix_dense``
for LSCM's tiny patches, and two functions on tensors, on the tensors'
device: ``massmatrix_barycentric_diag``, the mass of MCF's device step,
and ``cotmatrix_entries_tensor`` (the JAX package's
``massmatrix_barycentric_diag_jax`` and ``cotmatrix_entries_jax``).

Conventions follow libigl as used by the reference examples:
- `cotmatrix` is negative semi-definite (diagonal negative); the Poisson
  examples use A = -L (reference 03_mg_solver/main.cpp:45-46).
- `massmatrix` default is the 'voronoi' hybrid (safe/obtuse-aware) diagonal
  lumping, matching igl::MASSMATRIX_TYPE_VORONOI used by example 03.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch


def _squared_edge_lengths(V: np.ndarray, F: np.ndarray) -> np.ndarray:
    """l2[m, 3]: squared length of the edge opposite each corner."""
    P0, P1, P2 = V[F[:, 0]], V[F[:, 1]], V[F[:, 2]]
    l0 = ((P1 - P2) ** 2).sum(axis=1)
    l1 = ((P2 - P0) ** 2).sum(axis=1)
    l2 = ((P0 - P1) ** 2).sum(axis=1)
    return np.stack([l0, l1, l2], axis=1)


def _double_areas(V: np.ndarray, F: np.ndarray) -> np.ndarray:
    e1 = V[F[:, 1]] - V[F[:, 0]]
    e2 = V[F[:, 2]] - V[F[:, 0]]
    if V.shape[1] == 2:
        return np.abs(e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0])
    return np.linalg.norm(np.cross(e1, e2), axis=1)


def cotmatrix_entries(V: np.ndarray, F: np.ndarray) -> np.ndarray:
    """Half-cotangents C[m, 3]; C[:, c] = cot(angle at corner c) / 2.

    Matches igl::cotmatrix_entries (used by reference
    src/cotmatrix_dense.cpp:12).
    """
    V = np.asarray(V, dtype=np.float64)
    F = np.asarray(F, dtype=np.int64)
    l2 = _squared_edge_lengths(V, F)
    dblA = _double_areas(V, F)
    quad = 4.0 * dblA
    C0 = (l2[:, 1] + l2[:, 2] - l2[:, 0]) / quad
    C1 = (l2[:, 2] + l2[:, 0] - l2[:, 1]) / quad
    C2 = (l2[:, 0] + l2[:, 1] - l2[:, 2]) / quad
    return np.stack([C0, C1, C2], axis=1)


def cotmatrix(V: np.ndarray, F: np.ndarray) -> sp.csr_matrix:
    """Sparse cotan Laplacian (negative semi-definite, igl convention)."""
    V = np.asarray(V, dtype=np.float64)
    F = np.asarray(F, dtype=np.int64)
    n = V.shape[0]
    C = cotmatrix_entries(V, F)
    # edge opposite corner c connects corners (c+1)%3, (c+2)%3
    I, J, X = [], [], []
    for c in range(3):
        i = F[:, (c + 1) % 3]
        j = F[:, (c + 2) % 3]
        w = C[:, c]
        I += [i, j, i, j]
        J += [j, i, i, j]
        X += [w, w, -w, -w]
    I = np.concatenate(I)
    J = np.concatenate(J)
    X = np.concatenate(X)
    L = sp.coo_matrix((X, (I, J)), shape=(n, n)).tocsr()
    L.sum_duplicates()
    return L


def cotmatrix_dense(V: np.ndarray, F: np.ndarray) -> np.ndarray:
    """Dense cotan Laplacian for tiny LSCM patches.

    Analog of reference src/cotmatrix_dense.cpp:26-41.
    """
    V = np.asarray(V, dtype=np.float64)
    F = np.asarray(F, dtype=np.int64)
    n = V.shape[0]
    C = cotmatrix_entries(V, F)
    A = np.zeros((n, n))
    for c in range(3):
        i = F[:, (c + 1) % 3]
        j = F[:, (c + 2) % 3]
        w = C[:, c]
        np.add.at(A, (i, j), w)
        np.add.at(A, (j, i), w)
        np.add.at(A, (i, i), -w)
        np.add.at(A, (j, j), -w)
    return A


def cotmatrix_entries_tensor(V: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
    """``cotmatrix_entries`` on tensors, on V's device (differentiable):
    half-cotangents C [m, 3] of 3D positions V [n, 3], faces F [m, 3]."""
    P0, P1, P2 = V[F[:, 0]], V[F[:, 1]], V[F[:, 2]]
    l0 = ((P1 - P2) ** 2).sum(dim=1)
    l1 = ((P2 - P0) ** 2).sum(dim=1)
    l2 = ((P0 - P1) ** 2).sum(dim=1)
    quad = 4.0 * torch.linalg.norm(torch.cross(P1 - P0, P2 - P0, dim=1), dim=1)
    return torch.stack([(l1 + l2 - l0) / quad, (l2 + l0 - l1) / quad,
                        (l0 + l1 - l2) / quad], dim=1)


def massmatrix_barycentric(V: np.ndarray, F: np.ndarray) -> sp.csr_matrix:
    """Diagonal barycentric mass matrix: each corner gets area/3."""
    V = np.asarray(V, dtype=np.float64)
    F = np.asarray(F, dtype=np.int64)
    n = V.shape[0]
    dblA = _double_areas(V, F)
    diag = np.zeros(n)
    for c in range(3):
        np.add.at(diag, F[:, c], dblA / 6.0)
    return sp.diags(diag).tocsr()


def massmatrix_barycentric_diag(V: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
    """Diagonal of the barycentric mass matrix on V's device: each corner
    gets dblA / 6 (half its face's area / 3), one ``index_add_`` per corner."""
    P0, P1, P2 = V[F[:, 0]], V[F[:, 1]], V[F[:, 2]]
    dblA = torch.linalg.norm(torch.cross(P1 - P0, P2 - P0, dim=1), dim=1)
    diag = V.new_zeros(V.shape[0])
    for c in range(3):
        diag.index_add_(0, F[:, c], dblA / 6.0)
    return diag


def massmatrix(V: np.ndarray, F: np.ndarray, kind: str = "voronoi") -> sp.csr_matrix:
    """Diagonal lumped mass matrix.

    kind='voronoi' reproduces igl::MASSMATRIX_TYPE_VORONOI's hybrid rule
    (Meyer et al. mixed areas: true Voronoi quads for non-obtuse triangles,
    1/2-1/4-1/4 splits at obtuse corners), used by reference example 03.
    kind='barycentric' gives area/3 per corner.
    """
    if kind == "barycentric":
        return massmatrix_barycentric(V, F)
    V = np.asarray(V, dtype=np.float64)
    F = np.asarray(F, dtype=np.int64)
    n = V.shape[0]
    l2 = _squared_edge_lengths(V, F)
    l = np.sqrt(l2)
    dblA = _double_areas(V, F)
    cos0 = (l2[:, 2] + l2[:, 1] - l2[:, 0]) / (2.0 * l[:, 1] * l[:, 2])
    cos1 = (l2[:, 0] + l2[:, 2] - l2[:, 1]) / (2.0 * l[:, 2] * l[:, 0])
    cos2 = (l2[:, 1] + l2[:, 0] - l2[:, 2]) / (2.0 * l[:, 0] * l[:, 1])
    cosines = np.stack([cos0, cos1, cos2], axis=1)
    bary = cosines * l2
    bary = bary / np.maximum(bary.sum(axis=1, keepdims=True), 1e-300)
    partial = bary * (0.5 * dblA)[:, None]
    quads = np.stack(
        [
            0.5 * (partial[:, 1] + partial[:, 2]),
            0.5 * (partial[:, 2] + partial[:, 0]),
            0.5 * (partial[:, 0] + partial[:, 1]),
        ],
        axis=1,
    )
    for c in range(3):
        obtuse = cosines[:, c] < 0
        for cc in range(3):
            share = 0.25 if cc == c else 0.125
            quads[obtuse, cc] = share * dblA[obtuse]
    diag = np.zeros(n)
    for c in range(3):
        np.add.at(diag, F[:, c], quads[:, c])
    return sp.diags(diag).tocsr()
