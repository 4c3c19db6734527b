"""The least bytes of the solver's sparse work, and the least time the card needs for them.

Frozen copies, so that a later change to the program cannot change the
yardstick:

- ``HBM_BYTES_PER_S``, ``bound_ms`` and ``spmv_bytes`` from
  ``surface_multigrid_code_torch/utils/bounds.py`` at commit 261c938
  (``spmv_bytes`` without its ``value_itemsize`` argument);
- ``nnz_per_cycle`` and ``cycle_bytes`` from
  ``surface_multigrid_code_torch/bench.py`` at commit 261c938.

``spmv_counts`` and ``cycle_spmv_bytes`` are the same rule on an
operator's counts (rows, nonzeros, columns it gathers) and for C right-hand
sides, so the harness can count from the shapes of the program's levels
and the cycles done, whatever kernels did the work.
"""

from __future__ import annotations

import numpy as np

# HBM3 bytes per second and float32 operations per second outside the
# tensor cores of one H100 SXM (NVIDIA's data sheet).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
F64_FLOPS_PER_S = 67e12

_OPERANDS = {None: "", "axpby": "ubs", "resid": "b", "add": "u", "resid_scaled": "bs"}


def bound_ms(nbytes, flops, f64=False):
    """(ms, "bytes" or "operations"): bytes over the HBM rate or operations
    over the f32 (or f64) rate, whichever is larger."""
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
    ops = _OPERANDS[epi]
    nbytes += per * (("b" in ops) + ("u" in ops and rows is None)) + ("s" in ops) * n_out * itemsize
    return nbytes, 2 * sub.nnz * C


def spmv_counts(n_rows, nnz, gathered, C, epi, itemsize):
    """``spmv_bytes`` of a whole-operator SpMV from its counts: rows,
    nonzeros and the columns its nonzeros gather."""
    per = n_rows * C * itemsize
    ops = _OPERANDS[epi]
    return (4 * (n_rows + 1) + nnz * (4 + itemsize) + gathered * C * itemsize + per
            + per * (("b" in ops) + ("u" in ops)) + ("s" in ops) * n_rows * itemsize)


def nnz_per_cycle(As, Ps) -> int:
    """Nonzeros a V-cycle touches: 2 + 2 smoother sweeps and the residual
    per level above the coarsest, the restriction and the prolongation per P."""
    L = len(As)
    return sum(5 * int(As[lv].nnz) for lv in range(L - 1)) + sum(2 * int(P.nnz) for P in Ps)


def cycle_bytes(As, Ps, itemsize: int) -> dict:
    """Bytes a cycle of one right-hand side must move: per level above the
    coarsest 4 Jacobi sweeps (axpby) and the residual on A_l, the
    restriction by P^T and the prolongation-and-add by P; the coarse dense
    correction and its add; the zero guess of each coarser level; the copy
    of u the cycle starts from; and a normalisation of u after the cycle.
    Returns {"spmv", "coarse", "vectors", "total"} and the SpMV operations."""
    spmv = flops = 0
    for lv in range(len(As) - 1):
        for epi, times in (("axpby", 4), ("resid", 1)):
            b, f = spmv_bytes(As[lv], 1, epi, itemsize=itemsize)
            spmv, flops = spmv + times * b, flops + times * f
        P = Ps[lv].tocsr()
        for H, epi in ((P.T.tocsr(), None), (P, "add")):
            b, f = spmv_bytes(H, 1, epi, itemsize=itemsize)
            spmv, flops = spmv + b, flops + f
    nc, n0 = As[-1].shape[0], As[0].shape[0]
    coarse = itemsize * (nc * nc + 2 * nc + 3 * nc)
    vectors = itemsize * (sum(A.shape[0] for A in As[1:]) + 2 * n0 + 5 * n0)
    return {"spmv": spmv, "coarse": coarse, "vectors": vectors,
            "total": spmv + coarse + vectors}, flops + 2 * nc * nc


def cycle_spmv_bytes(levels, C, itemsize, sweeps) -> int:
    """The SpMV bytes of one V-cycle on C right-hand sides: per level above
    the coarsest ``sweeps`` smoother sweeps, each counted as one whole-level
    axpby (a multicolor sweep updates every row once, in place), and the
    residual; the restriction by P^T and the prolongation-and-add by P.
    ``levels``: finest first, each {"A": counts, "P": counts, "PT": counts}
    (P and PT from level 1 on), counts = (rows, nonzeros, gathered)."""
    total = 0
    for lv in range(len(levels) - 1):
        A = levels[lv]["A"]
        total += sweeps * spmv_counts(*A, C, "axpby", itemsize)
        total += spmv_counts(*A, C, "resid", itemsize)
        nxt = levels[lv + 1]
        total += spmv_counts(*nxt["PT"], C, None, itemsize)
        total += spmv_counts(*nxt["P"], C, "add", itemsize)
    return total
