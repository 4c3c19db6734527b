"""Midpoint (loop-connectivity) upsampling + barycentric extraction (ports ``surface_multigrid_code_tpu/utils/upsample.py``).

Used by subdivision remeshing (reference examples 08/09, the CLI's
``remesh``): build the subdivision operator S (new = S @ old) over ``n``
iterations, then express every subdivided vertex as barycentric
coordinates on a face of the COARSE mesh (reference
loop_upsample_barycentric, 08_subdiv_remesh/main.cpp:45-113). The
connectivity matches the neuralSubdiv-compatible ordering
(09_random_subdiv_remesh/main.cpp:46-139): new vertex ids are nV +
lexicographic-unique-edge index, faces come in 4 blocks (3 corner blocks
then center faces).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from surface_multigrid_code_torch.utils.synthetic import midpoint_subdivide


def upsample_operator(
    V: np.ndarray, F: np.ndarray, n_subdiv: int
) -> tuple[sp.csr_matrix, list[np.ndarray]]:
    """Chained midpoint subdivision.

    Returns (S, faces_per_level) where S maps level-0 vertices to the
    finest subdivided vertices and faces_per_level[k] is the face list
    after k subdivisions (k = 0..n_subdiv).
    """
    faces = [np.asarray(F, dtype=np.int64)]
    S = sp.identity(V.shape[0], format="csr")
    Vk = np.asarray(V, dtype=np.float64)
    for _ in range(n_subdiv):
        Vk, Fk, Pk = midpoint_subdivide(Vk, faces[-1])
        faces.append(Fk)
        S = (Pk @ S).tocsr()
    return S, faces


def upsample_barycentric(
    V: np.ndarray, F: np.ndarray, n_subdiv: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, list[np.ndarray]]:
    """(BC, BF, FIdx, faces_per_level) for all subdivided vertices.

    Every row of the subdivision operator S is supported on the vertices of
    exactly one coarse face (midpoint subdivision never crosses faces);
    that face provides (BC one-per-corner, BF = its vertices, FIdx = id).
    """
    F = np.asarray(F, dtype=np.int64)
    S, faces = upsample_operator(V, F, n_subdiv)
    nq = S.shape[0]
    BC = np.zeros((nq, 3))
    BF = np.zeros((nq, 3), dtype=np.int64)
    FIdx = np.zeros(nq, dtype=np.int64)
    # vertex -> incident coarse faces
    nV = V.shape[0]
    vfaces: list[list[int]] = [[] for _ in range(nV)]
    for fi, f in enumerate(F):
        for v in f:
            vfaces[v].append(fi)
    fsets = [set(map(int, f)) for f in F]
    indptr, indices, data = S.indptr, S.indices, S.data
    for r in range(nq):
        cols = indices[indptr[r] : indptr[r + 1]]
        vals = data[indptr[r] : indptr[r + 1]]
        support = set(map(int, cols))
        # find a coarse face containing the whole support
        fIdx = -1
        for cand in vfaces[cols[0]]:
            if support <= fsets[cand]:
                fIdx = cand
                break
        if fIdx < 0:
            raise ValueError("subdivided vertex support crosses coarse faces")
        FIdx[r] = fIdx
        BF[r] = F[fIdx]
        for c in range(3):
            for j, col in enumerate(cols):
                if F[fIdx, c] == col:
                    BC[r, c] = vals[j]
                    break
    return BC, BF, FIdx, faces
