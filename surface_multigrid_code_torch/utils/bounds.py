"""The least time the card could take for a piece of work, and the bytes a fused SpMV moves.

A bound is the larger of two times: the bytes the work must move (each
input read once, each output written once) over the HBM rate, and its
operations over the card's peak for their type: the CUDA cores' for f32,
the tensor cores' (dense) for f64 (DMMA), TF32 and bf16. The peaks are
one H100 SXM's, from NVIDIA's data sheet. ``bench.py``, ``chip_smoke.py``
and ``probes/`` count with these functions, so their bounds agree.
"""

from __future__ import annotations

import numpy as np

# HBM3 bytes per second, float32 operations per second outside the tensor
# cores, and float64 operations per second: the card's peak (its tensor
# cores) and its CUDA cores' alone, of one H100 SXM.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
F64_FLOPS_PER_S = 67e12
F64_CUDA_CORE_FLOPS_PER_S = 34e12
# dense tensor-core peaks of one H100 SXM
TF32_FLOPS_PER_S = 495e12
BF16_FLOPS_PER_S = 989e12


def bound_ms(nbytes, flops, f64=False, peak=None):
    """(ms, "bytes" or "operations"): bytes over the HBM rate or operations
    over the f32 (or f64, or the given ``peak``) rate, whichever is larger."""
    if peak is None:
        peak = F64_FLOPS_PER_S if f64 else F32_FLOPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def spmv_bytes(H, C, epi, rows=None, itemsize=4, value_itemsize=None):
    """(bytes, operations) of one fused SpMV on the host CSR ``H`` with C
    right-hand sides: each input read once and each output written once,
    i.e. the rows' index range (and row ids), their nonzeros' indices and
    values, the x rows they gather, the epilogue operands and y. With a row
    subset the update is in place: u is x, and its rows are among the
    gathered ones (every row stores its diagonal). ``value_itemsize``: the
    bytes of a stored value where it differs from the vectors' (bf16: 2)."""
    sub = H if rows is None else H[rows]
    n_out = sub.shape[0]
    per = n_out * C * itemsize
    vsize = itemsize if value_itemsize is None else value_itemsize
    nbytes = 4 * (H.shape[0] + 1) if rows is None else 12 * n_out
    nbytes += sub.nnz * (4 + vsize) + np.unique(sub.indices).size * C * itemsize + per
    ops = {None: "", "axpby": "ubs", "resid": "b", "add": "u", "resid_scaled": "bs"}[epi]
    nbytes += per * (("b" in ops) + ("u" in ops and rows is None)) + ("s" in ops) * n_out * itemsize
    return nbytes, 2 * sub.nnz * C
