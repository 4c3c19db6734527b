"""Public per-vertex quadric computation (ports ``surface_multigrid_code_tpu/ssp/quadrics.py``).

Mirrors the reference's `src/compute_vertex_quadrics.cpp:12-165` (the
generic nD qslim quadric initialization from "Simplifying Surfaces with
Color and Texture using Quadric Error Metric"): every vertex starts with
a w=1e-10 pull toward its original position; each finite face throws an
area-weighted plane quadric at its three corners; each boundary edge
throws a (length^2/100)-weighted subspace quadric (spanned by the edge
direction plus the complement of the incident face's plane) at its two
endpoints — reference :110-163, where boundary faces appear as faces
with one "infinite" corner after connect-to-infinity closure.

The reference keeps this file dead (its call sites are commented out,
`src/SSP_qslim.cpp:45-46` — the engine re-derives the same quadrics
internally, as does `native/ssp.cpp vertex_quadrics`); the API is
provided here for completeness and as the oracle the native engine's
qslim costs are tested against.

A quadric triple (A [3,3], b [3], c) measures x'Ax + 2 b'x + c.
"""

from __future__ import annotations

import numpy as np


def _subspace_quadric(p, S_rows, weight):
    """Vectorized reference subspace_quadric (:59-80): p [m,3] points,
    S_rows list of [m,3] orthonormal spanning rows, weight [m]."""
    m = p.shape[0]
    A = np.broadcast_to(np.eye(3), (m, 3, 3)).copy()
    b = -p.copy()
    c = (p * p).sum(axis=1)
    for ei in S_rows:
        A -= ei[:, :, None] * ei[:, None, :]
        pe = (p * ei).sum(axis=1)
        b += pe[:, None] * ei
        c -= pe**2
    return weight[:, None, None] * A, weight[:, None] * b, weight * c


def compute_vertex_quadrics(V: np.ndarray, F: np.ndarray):
    """Per-vertex quadrics (A [n,3,3], b [n,3], c [n]); see module doc."""
    V = np.asarray(V, dtype=np.float64)
    F = np.asarray(F, dtype=np.int64)
    n = V.shape[0]

    # w=1e-10 pull toward the original position (reference :26-33)
    w = 1e-10
    A = w * np.broadcast_to(np.eye(3), (n, 3, 3)).copy()
    b = w * -V.copy()
    c = w * (V * V).sum(axis=1)

    # finite faces: area-weighted plane quadric at all 3 corners (:81-107)
    p, q, r = V[F[:, 0]], V[F[:, 1]], V[F[:, 2]]
    pq, pr = q - p, r - p
    gram = (pq * pq).sum(1) * (pr * pr).sum(1) - (pq * pr).sum(1) ** 2
    area = np.sqrt(np.maximum(gram, 0.0))
    e1 = pq / np.maximum(np.linalg.norm(pq, axis=1, keepdims=True), 1e-300)
    pr_perp = pr - (e1 * pr).sum(1)[:, None] * e1
    e2 = pr_perp / np.maximum(
        np.linalg.norm(pr_perp, axis=1, keepdims=True), 1e-300
    )
    fA, fb, fc = _subspace_quadric(p, [e1, e2], area)
    for k in range(3):
        np.add.at(A, F[:, k], fA)
        np.add.at(b, F[:, k], fb)
        np.add.at(c, F[:, k], fc)

    # boundary edges: the reference sees them as faces with one infinite
    # corner (:108-163); here they are the edge-flap rows with an empty
    # second slot (utils.mesh.edges_and_flaps, which also enforces
    # edge-manifoldness — the same gate the decimator applies).  Subspace
    # = {edge direction} + the orthogonal complement of span{edge, other
    # in-face edge}; weight = length^2 / 100.
    from surface_multigrid_code_torch.utils.mesh import edges_and_flaps

    _E, _EMAP, EF, EI = edges_and_flaps(F)
    bnd = np.nonzero(EF[:, 1] < 0)[0]
    if bnd.size:
        face = EF[bnd, 0].astype(np.int64)
        opp_c = EI[bnd, 0].astype(np.int64)      # corner OPPOSITE the edge
        i0 = F[face, (opp_c + 1) % 3]            # reference p (:111)
        i1 = F[face, (opp_c + 2) % 3]
        iu = F[face, opp_c]                      # opposite in-face vertex
        pb = V[i0]
        ev = V[i1] - pb
        length = np.linalg.norm(ev, axis=1)
        ev = ev / np.maximum(length[:, None], 1e-300)
        eu = V[iu] - pb
        # orthogonal complement of span{ev, eu} (3D: one normal row)
        nrm = np.cross(ev, eu)
        nrm = nrm / np.maximum(
            np.linalg.norm(nrm, axis=1, keepdims=True), 1e-300
        )
        bA, bb, bc = _subspace_quadric(pb, [ev, nrm], length**2 / 100.0)
        for idx in (i0, i1):
            np.add.at(A, idx, bA)
            np.add.at(b, idx, bb)
            np.add.at(c, idx, bc)
    return A, b, c
