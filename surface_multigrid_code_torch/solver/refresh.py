"""Slot maps into a fixed CSR pattern (ports ``csr_slot_map`` of ``surface_multigrid_code_tpu/solver/refresh.py``).

The balloon stepper assembles per-face Hessian blocks straight into the
values of a fixed vertex pattern; ``csr_slot_map`` says which nnz slot each
(row, col) entry lands in. ``RefreshableMGSolver`` (the scalar refreshed
solver of MCF) is not ported yet (ROADMAP queue 1, MCF).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def csr_slot_map(
    pattern: sp.csr_matrix, rows: np.ndarray, cols: np.ndarray
) -> np.ndarray:
    """nnz slot of every (row, col) pair in the pattern (fully vectorized).

    Canonical CSR keys (row * ncols + col) are globally sorted, so ONE
    np.searchsorted resolves every query."""
    pattern = pattern.tocsr()
    pattern.sort_indices()  # no-op when already canonical
    ncols = pattern.shape[1]
    prows = np.repeat(
        np.arange(pattern.shape[0], dtype=np.int64), np.diff(pattern.indptr)
    )
    pkeys = prows * ncols + pattern.indices
    qkeys = np.asarray(rows, dtype=np.int64) * ncols + np.asarray(
        cols, dtype=np.int64
    )
    slots = np.searchsorted(pkeys, qkeys)
    if slots.max(initial=-1) >= pkeys.shape[0] or not np.array_equal(
        pkeys[np.minimum(slots, pkeys.shape[0] - 1)], qkeys
    ):
        raise ValueError("entry outside pattern")
    return slots
