"""Locality orderings of a hierarchy (ports ``surface_multigrid_code_tpu/solver/ordering.py``).

The row-partitioned hierarchy (``parallel/halo.py``) cuts every level into
contiguous row blocks, one per rank; a block's halo is thin only if the
vertex ordering is spatially coherent. The finest level gets reverse
Cuthill-McKee; coarser levels take the ordering *induced* by the finest
(each coarse vertex sorted by the least RCM rank of the fine rows its
prolongation column touches), so a coarse block lines up with the fine
block it restricts from and Pᵀ's stencils stay near the block boundary.

The same ordering keeps the static precompute's SpMV gathers local on one
card where the finest band streams more than the L2 (``locality_ordering``):
a row's columns lie within the narrowed band, so the gathered vector's
lines are still in the L2 when the next rows read them.

``finest_rcm``, ``induced_orderings``, ``permute_hierarchy`` and
``nnz_permutation_map`` are the JAX package's, held bit-identical
(``tests/test_torch_host.py``); numpy and scipy only.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import reverse_cuthill_mckee


def finest_rcm(A: sp.spmatrix) -> np.ndarray:
    """RCM permutation of the finest operator (perm[newrow] = oldrow)."""
    return np.asarray(
        reverse_cuthill_mckee(A.tocsr(), symmetric_mode=True), dtype=np.int64
    )


def bandwidth(A: sp.spmatrix) -> int:
    """max |i - j| over the stored entries of A."""
    A = A.tocsr()
    rows = np.repeat(np.arange(A.shape[0], dtype=np.int64), np.diff(A.indptr))
    return int(np.abs(rows - A.indices).max(initial=0))


def locality_ordering(
    A: sp.spmatrix, Ps: list[sp.spmatrix], cache_bytes: int, itemsize: int
) -> list[np.ndarray] | None:
    """The finest RCM of A and the orderings it induces through Ps
    (``induced_orderings``), or None where A's band fits in the cache.

    A gather reaches back at most A's bandwidth rows. Where those rows
    stream at most ``cache_bytes`` in a one-column sweep (the row pointer,
    each nonzero's column id and value, and five vectors, values and
    vectors of ``itemsize`` bytes), a gathered line is still cached when
    the band comes back to it, whatever the order: a mesh whose finest
    level fits in the cache, or an input already in a banded order, keeps
    its order."""
    n = A.shape[0]
    row_bytes = 4 + A.nnz / max(n, 1) * (4 + itemsize) + 5 * itemsize
    if bandwidth(A) * row_bytes <= cache_bytes:
        return None
    return induced_orderings(finest_rcm(A), Ps)


def induced_orderings(
    perm0: np.ndarray, Ps: list[sp.spmatrix]
) -> list[np.ndarray]:
    """Per-level permutations [perm0, perm1, ...] induced by the finest RCM.

    Level l+1's coarse vertex c gets score = min over fine rows r with
    P[r, c] != 0 of level-l's rank[r]; sorting by score orders coarse
    vertices along the same band sweep as the fine level.
    """
    perms = [np.asarray(perm0, dtype=np.int64)]
    n0 = perm0.shape[0]
    rank = np.empty(n0, dtype=np.int64)
    rank[perms[0]] = np.arange(n0)
    for P in Ps:
        Pc = P.tocsc()
        m = Pc.shape[1]
        score = np.full(m, np.iinfo(np.int64).max, dtype=np.int64)
        if Pc.nnz:
            row_ranks = rank[Pc.indices]
            nz_cols = np.flatnonzero(np.diff(Pc.indptr) > 0)
            mins = np.minimum.reduceat(row_ranks, Pc.indptr[nz_cols])
            score[nz_cols] = mins
        p = np.argsort(score, kind="stable").astype(np.int64)
        perms.append(p)
        rank = np.empty(m, dtype=np.int64)
        rank[p] = np.arange(m)
    return perms


def permute_hierarchy(
    As: list[sp.spmatrix], Ps: list[sp.spmatrix], perms: list[np.ndarray]
) -> tuple[list[sp.csr_matrix], list[sp.csr_matrix]]:
    """Apply per-level permutations: A_l -> A_l[p_l][:, p_l],
    P_l (fine x coarse) -> P_l[p_{l}][:, p_{l+1}]."""
    As_p = [
        As[l].tocsr()[perms[l]][:, perms[l]].tocsr() for l in range(len(As))
    ]
    Ps_p = [
        Ps[l].tocsr()[perms[l]][:, perms[l + 1]].tocsr()
        for l in range(len(Ps))
    ]
    return As_p, Ps_p


def nnz_permutation_map(A: sp.spmatrix, perm: np.ndarray) -> np.ndarray:
    """For each canonical-CSR nnz of A_perm = A[perm][:, perm], the nnz id
    within (canonical-CSR) A — so permuted-space value vectors can be
    produced by one static gather."""
    A = A.tocsr()
    A.sum_duplicates()
    A.sort_indices()
    n = A.shape[0]
    perm = np.asarray(perm, dtype=np.int64)
    Ap = A[perm][:, perm].tocsr()
    Ap.sum_duplicates()
    Ap.sort_indices()
    rows_p = np.repeat(np.arange(n), np.diff(Ap.indptr))
    # source (row, col) of each permuted nnz
    src_r = perm[rows_p]
    src_c = perm[Ap.indices]
    prows = np.repeat(np.arange(n, dtype=np.int64), np.diff(A.indptr))
    pkeys = prows * n + A.indices
    qkeys = src_r * n + src_c
    slots = np.searchsorted(pkeys, qkeys)
    if slots.max(initial=-1) >= pkeys.shape[0] or not np.array_equal(
        pkeys[np.minimum(slots, pkeys.shape[0] - 1)], qkeys
    ):
        raise ValueError("permuted nnz missing from source pattern")
    return slots.astype(np.int64)
