"""The byte count of one V-cycle on icosphere(2), against a hand count."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from portbench.lib import bounds, meshes
from portbench.reference.laplacian import barycentric_mass, cotmatrix, screened_operator


def two_levels():
    """A_0 on icosphere(2) (162 V), the subdivision prolongation P from
    icosphere(1) (42 V), and A_1 = P^T A_0 P."""
    V1, F1 = meshes.icosphere(1)
    V0, F0 = meshes.icosphere(2)
    n1 = V1.shape[0]
    e = np.sort(np.concatenate([F1[:, [0, 1]], F1[:, [1, 2]], F1[:, [2, 0]]]), axis=1)
    edges = np.unique(e, axis=0)
    rows = np.concatenate([np.arange(n1), n1 + np.arange(len(edges)), n1 + np.arange(len(edges))])
    cols = np.concatenate([np.arange(n1), edges[:, 0], edges[:, 1]])
    vals = np.concatenate([np.ones(n1), np.full(2 * len(edges), 0.5)])
    P = sp.csr_matrix((vals, (rows, cols)), shape=(V0.shape[0], n1))
    A0 = screened_operator(barycentric_mass(V0, F0), cotmatrix(V0, F0), 0.01)
    return A0, P, (P.T @ A0 @ P).tocsr()


def test_shapes_by_hand():
    A0, P, A1 = two_levels()
    # 162 vertices and 480 edges: the diagonal and two entries an edge
    assert A0.shape == (162, 162) and A0.nnz == 162 + 2 * 480
    # identity on the 42 old vertices, two halves on each of the 120 new ones
    assert P.shape == (162, 42) and P.nnz == 42 + 2 * 120
    assert A1.shape == (42, 42)


def test_cycle_bytes_by_hand():
    A0, P, A1 = two_levels()
    n0, n1, a0, p = 162, 42, A0.nnz, P.nnz
    it = 4  # float32
    # A_0: indptr (n0 + 1) int32, nnz int32 + value, x gathered (n0), y (n0)
    base = 4 * (n0 + 1) + a0 * (4 + it) + n0 * it + n0 * it
    axpby = base + 2 * n0 * it + n0 * it      # u and b, and the row scale s
    resid = base + n0 * it                    # b
    # P^T: n1 rows, P's nonzeros, gathers all n0 rows of r, writes n1
    restrict = 4 * (n1 + 1) + p * (4 + it) + n0 * it + n1 * it
    # P with add: n0 rows, gathers the n1 coarse values, reads u, writes n0
    prolong = 4 * (n0 + 1) + p * (4 + it) + n1 * it + n0 * it + n0 * it
    hand = 4 * axpby + resid + restrict + prolong
    counts = [{"A": (n0, a0, n0)},
              {"A": (n1, A1.nnz, n1), "P": (n0, p, n1), "PT": (n1, p, n0)}]
    assert bounds.cycle_spmv_bytes(counts, 1, it, sweeps=4) == hand
    # the frozen copy of bench.cycle_bytes counts the same SpMVs
    total, _ = bounds.cycle_bytes([A0, A1], [P], it)
    assert total["spmv"] == hand
    # 16 columns: the vectors' bytes 16 times, the operators' once
    ops = 5 * (4 * (n0 + 1) + a0 * (4 + it)) + 4 * n0 * it + 2 * (p * (4 + it)) \
        + 4 * (n1 + 1) + 4 * (n0 + 1)
    wide = bounds.cycle_spmv_bytes(counts, 16, it, sweeps=4)
    assert wide == ops + 16 * (hand - ops)


def test_counts_agree_with_the_frozen_rule():
    A0, P, _ = two_levels()
    for H in (A0, P, P.T.tocsr()):
        for C in (1, 3, 16):
            for epi in (None, "axpby", "resid", "add"):
                b, _ = bounds.spmv_bytes(H, C, epi, itemsize=8)
                assert bounds.spmv_counts(H.shape[0], H.nnz, np.unique(H.indices).size, C, epi,
                                          8) == b
