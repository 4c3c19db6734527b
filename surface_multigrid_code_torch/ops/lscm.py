"""LSCM building blocks as public Python utilities (ports ``surface_multigrid_code_tpu/ops/lscm.py``).

The native SSP engine carries its own C++ versions of these for the
per-collapse joint flattening (native/lscm.hpp); the Python versions here
mirror the reference's standalone components for analysis / tooling:

- `vector_area_matrix(F, n)` — dense antisymmetric vector-area matrix on 2n
  stacked coordinates (reference src/vector_area_matrix_size.cpp:33-45).
- `quasi_conformal_error(V, F, UV)` — per-face sigma/gamma distortion from
  "Texture Mapping Progressive Meshes" (reference
  src/quasi_conformal_error.cpp:13-40).
- `mqwf_dense_precompute/solve` — dense known/unknown quadratic solver,
  minimize 1/2 x'Qx + rhs'x s.t. x[known] = known_val (reference
  src/mqwf_dense.cpp; the -0.5 (Auk + Aku') reduction at :99-104).
- `lscm_flatten` — joint-free single-patch LSCM flatten, Q = -L2 + 2A
  under pinned UVs (the single-mesh specialization of reference
  src/joint_lscm.cpp:483-543).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from surface_multigrid_code_torch.ops.laplacian import cotmatrix_dense
from surface_multigrid_code_torch.utils.mesh import boundary_facets


def vector_area_matrix(F: np.ndarray, n: int) -> np.ndarray:
    # boundary_facets returns edges reversed w.r.t. the face loop; the area
    # form needs face-loop (CCW) orientation so that x'Ax = +enclosed area
    # for a positively oriented patch (same convention as the native engine,
    # native/lscm.hpp boundary_edges).
    A = np.zeros((2 * n, 2 * n))
    for j, i in boundary_facets(F):
        A[i + n, j] -= 0.25
        A[j, i + n] -= 0.25
        A[i, j + n] += 0.25
        A[j + n, i] += 0.25
    return A


def quasi_conformal_error(V: np.ndarray, F: np.ndarray, UV: np.ndarray) -> np.ndarray:
    """Per-face quasi-conformal distortion sigma/gamma (>= 1, 1 = conformal)."""
    V = np.asarray(V, dtype=np.float64)
    F = np.asarray(F, dtype=np.int64)
    UV = np.asarray(UV, dtype=np.float64)
    s = UV[F, 0]  # [m, 3]
    t = UV[F, 1]
    q = V[F]      # [m, 3, 3]
    A2 = ((s[:, 1] - s[:, 0]) * (t[:, 2] - t[:, 0])
          - (s[:, 2] - s[:, 0]) * (t[:, 1] - t[:, 0])) / 2.0
    dt = np.stack([t[:, 1] - t[:, 2], t[:, 2] - t[:, 0], t[:, 0] - t[:, 1]], 1)
    ds = np.stack([s[:, 2] - s[:, 1], s[:, 0] - s[:, 2], s[:, 1] - s[:, 0]], 1)
    Ss = (q * dt[:, :, None]).sum(axis=1) / (2 * A2[:, None])
    St = (q * ds[:, :, None]).sum(axis=1) / (2 * A2[:, None])
    a = (Ss * Ss).sum(1)
    b = (Ss * St).sum(1)
    c = (St * St).sum(1)
    disc = np.sqrt((a - c) ** 2 + 4 * b * b)
    sigma = np.sqrt((a + c + disc) / 2)
    gamma = np.sqrt((a + c - disc) / 2)
    return sigma / gamma


@dataclass
class MQWFDenseData:
    n: int
    known: np.ndarray
    unknown: np.ndarray
    Auu: np.ndarray          # prefactor substitute: stored for np.linalg.solve
    Auk_plus_AkuT: np.ndarray


def mqwf_dense_precompute(Q: np.ndarray, known: np.ndarray) -> MQWFDenseData:
    Q = np.asarray(Q, dtype=np.float64)
    n = Q.shape[0]
    known = np.asarray(known, dtype=np.int64).ravel()
    unknown = np.setdiff1d(np.arange(n), known)
    Auu = Q[np.ix_(unknown, unknown)]
    Auk = Q[np.ix_(unknown, known)]
    Aku = Q[np.ix_(known, unknown)]
    return MQWFDenseData(
        n=n, known=known, unknown=unknown, Auu=Auu,
        Auk_plus_AkuT=Auk + Aku.T,
    )


def mqwf_dense_solve(
    data: MQWFDenseData, rhs: np.ndarray, known_val: np.ndarray
) -> np.ndarray:
    rhs = np.asarray(rhs, dtype=np.float64)
    known_val = np.asarray(known_val, dtype=np.float64)
    if data.known.size == 0:
        reduced = -rhs
    else:
        reduced = -0.5 * data.Auk_plus_AkuT @ known_val - rhs[data.unknown]
    xu = np.linalg.solve(data.Auu, reduced)
    x = np.empty(data.n)
    x[data.unknown] = xu
    x[data.known] = known_val
    return x


def lscm_flatten(
    V: np.ndarray, F: np.ndarray, b: np.ndarray, bc: np.ndarray
) -> np.ndarray:
    """LSCM flatten of one patch: minimize the conformal energy with UV of
    vertices b pinned to bc [k, 2].  Returns UV [n, 2]."""
    V = np.asarray(V, dtype=np.float64)
    F = np.asarray(F, dtype=np.int64)
    n = V.shape[0]
    L = cotmatrix_dense(V, F)
    A = vector_area_matrix(F, n)
    Q = -np.block(
        [[L, np.zeros((n, n))], [np.zeros((n, n)), L]]
    ) + 2.0 * A
    # stacked layout: block0 -> UV col 1, block1 -> UV col 0
    # (reference src/joint_lscm.cpp:636-640)
    b = np.asarray(b, dtype=np.int64).ravel()
    bc = np.asarray(bc, dtype=np.float64).reshape(-1, 2)
    b_UV = np.concatenate([b, b + n])
    bc_UV = np.concatenate([bc[:, 1], bc[:, 0]])
    data = mqwf_dense_precompute(Q, b_UV)
    flat = mqwf_dense_solve(data, np.zeros(2 * n), bc_UV)
    UV = np.empty((n, 2))
    UV[:, 1] = flat[:n]
    UV[:, 0] = flat[n:]
    return UV
