"""The least time the card could take for a piece of work, and the bytes a fused SpMV moves.

A bound is the larger of two times: the bytes the work must move (each
input read once, each output written once) over the HBM rate, and its
operations over the CUDA cores' peak for their type. The peaks are one
H100 SXM's, from NVIDIA's data sheet. ``bench.py`` and ``chip_smoke.py``
count with these functions, so their bounds agree.
"""

from __future__ import annotations

import numpy as np

# HBM3 bytes per second, and float32 and float64 operations per second
# outside the tensor cores, of one H100 SXM.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
F64_FLOPS_PER_S = 34e12


def bound_ms(nbytes, flops, f64=False):
    """(ms, "bytes" or "operations"): bytes over the HBM rate or operations
    over the f32 (or f64) peak, whichever is larger."""
    peak = F64_FLOPS_PER_S if f64 else F32_FLOPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def spmv_bytes(H, C, epi, rows=None, itemsize=4):
    """(bytes, operations) of one fused SpMV on the host CSR ``H`` with C
    right-hand sides: each input read once and each output written once,
    i.e. the rows' index range (and row ids), their nonzeros' indices and
    values, the x rows they gather, the epilogue operands and y. With a row
    subset the update is in place: u is x, and its rows are among the
    gathered ones (every row stores its diagonal)."""
    sub = H if rows is None else H[rows]
    n_out = sub.shape[0]
    per = n_out * C * itemsize
    nbytes = 4 * (H.shape[0] + 1) if rows is None else 12 * n_out
    nbytes += sub.nnz * (4 + itemsize) + np.unique(sub.indices).size * C * itemsize + per
    ops = {None: "", "axpby": "ubs", "resid": "b", "add": "u", "resid_scaled": "bs"}[epi]
    nbytes += per * (("b" in ops) + ("u" in ops and rows is None)) + ("s" in ops) * n_out * itemsize
    return nbytes, 2 * sub.nnz * C
