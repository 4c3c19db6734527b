"""2D barycentric coordinates of a point against many triangles (ports ``surface_multigrid_code_tpu/utils/barycentric.py``).

Semantics of reference src/compute_barycentric.cpp:33-58 (classic
dot-product formula); vectorized over faces. ``snap_to_best_face`` is the
reference's relocation rule between charts.
"""

from __future__ import annotations

import numpy as np


def compute_barycentric(p: np.ndarray, UV: np.ndarray, F: np.ndarray) -> np.ndarray:
    """Barycentric coords of 2D point p w.r.t. every triangle of (UV, F).

    Returns B [m, 3] with rows (u, v, w) so that
    p = u*UV[F[:,0]] + v*UV[F[:,1]] + w*UV[F[:,2]] when p is in the plane.
    """
    p = np.asarray(p, dtype=np.float64).reshape(2)
    UV = np.asarray(UV, dtype=np.float64)
    F = np.asarray(F, dtype=np.int64)
    a = UV[F[:, 0]]
    b = UV[F[:, 1]]
    c = UV[F[:, 2]]
    v0 = b - a
    v1 = c - a
    v2 = p[None, :] - a
    d00 = (v0 * v0).sum(axis=1)
    d01 = (v0 * v1).sum(axis=1)
    d11 = (v1 * v1).sum(axis=1)
    d20 = (v2 * v0).sum(axis=1)
    d21 = (v2 * v1).sum(axis=1)
    denom = d00 * d11 - d01 * d01
    v = (d11 * d20 - d01 * d21) / denom
    w = (d00 * d21 - d01 * d20) / denom
    u = 1.0 - (v + w)
    B = np.stack([u, v, w], axis=1)
    assert not np.isnan(B).any(), "barycentric coordinate has nan"
    return B


def snap_to_best_face(B: np.ndarray) -> tuple[int, np.ndarray]:
    """Pick the face whose min barycentric coord is largest; clamp + renorm.

    This is the reference's relocation rule after mapping a query point
    between UV charts (src/query_fine_to_coarse.cpp:98-118): choose argmax
    over faces of min(B_row), clamp negatives to 0, renormalize to sum 1.
    Returns (face_index, clamped_row[3]).
    """
    mins = B.min(axis=1)
    fi = int(np.argmax(mins))
    row = np.maximum(B[fi], 0.0)
    s = row.sum()
    if s <= 0.0:
        row = np.full(3, 1.0 / 3.0)
    else:
        row = row / s
    return fi, row
