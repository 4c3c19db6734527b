"""Device sparse-matrix container (counterpart of ``surface_multigrid_code_tpu/ops/sparse.py``).

The JAX package keeps operators in padded-row ELL form because the TPU
wants constant-shape rows. The port keeps CSR: on a GPU a gather is a load,
and the constrained ogre hierarchy has PT hub rows 171 wide, to which ELL
would pad every row of an operator whose rows mostly hold 3 to 25.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn


def row_lanes(nnz: int, n_rows: int) -> int:
    """Lanes of the sub-warp that computes one row in the CUDA SpMV kernels
    (``csrc/spmv.cu`` over nonzeros, ``csrc/bsr_spmv.cu`` over 3x3 blocks):
    the smallest power of two at or above the mean row length
    ``nnz / n_rows``, at most 32 (a warp). A launch too large for one wave
    of the card uses fewer (``ops.spmv.launch_lanes``)."""
    lanes = 1
    while lanes < 32 and lanes * max(n_rows, 1) < nnz:
        lanes *= 2
    return lanes


class CSRMatrix(nn.Module):
    """CSR sparse matrix on a device.

    indptr:  int32 [n_rows + 1]
    indices: int32 [nnz] column ids
    data:    float [nnz] values (stored zeros are kept)
    n_cols:  int
    lanes:   int, the kernel's lanes per row (``row_lanes``), read from
             the shapes when the matrix is built, so a call needs no sync
    """

    def __init__(self, indptr: torch.Tensor, indices: torch.Tensor,
                 data: torch.Tensor, n_cols: int):
        super().__init__()
        self.register_buffer("indptr", indptr)
        self.register_buffer("indices", indices)
        self.register_buffer("data", data)
        self.n_cols = int(n_cols)
        self.lanes = row_lanes(indices.shape[0], indptr.shape[0] - 1)

    @property
    def n_rows(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n_rows, self.n_cols)

    def extra_repr(self) -> str:
        return (f"shape={self.shape}, nnz={self.data.shape[0]}, dtype={self.data.dtype}, "
                f"lanes={self.lanes}")


def csr_from_scipy(A: sp.spmatrix, device, dtype=torch.float32) -> CSRMatrix:
    """Upload a scipy sparse matrix (duplicates summed, stored zeros kept)."""
    A = sp.csr_matrix(A, copy=True)
    A.sum_duplicates()
    if A.nnz >= 2**31:
        raise ValueError("CSRMatrix indexes nonzeros with int32")
    return CSRMatrix(
        indptr=torch.as_tensor(A.indptr.astype(np.int32), device=device),
        indices=torch.as_tensor(A.indices.astype(np.int32), device=device),
        data=torch.as_tensor(A.data, dtype=torch.float64).to(device=device, dtype=dtype),
        n_cols=A.shape[1],
    )


def inverse_permutation(perm: torch.Tensor) -> torch.Tensor:
    """inv with inv[perm[i]] = i (int64, on perm's device)."""
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], dtype=perm.dtype, device=perm.device)
    return inv


def csr_permuted(A: CSRMatrix, rows: torch.Tensor, cols: torch.Tensor) -> CSRMatrix:
    """A[rows][:, cols] on A's device, with the column ids of each row
    ascending as ``csr_from_scipy`` uploads them. rows, cols: int64
    permutations on that device, new id -> old id. One gather of the
    column ids through the inverse and one sort by (row, column)."""
    n, m = A.shape
    new_row = inverse_permutation(rows)[csr_row_ids(A)]
    new_col = inverse_permutation(cols)[A.indices.long()]
    order = torch.argsort(new_row * m + new_col)
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=rows.device)
    indptr[1:] = torch.cumsum(torch.bincount(new_row, minlength=n), 0)
    return CSRMatrix(indptr.int(), new_col[order].int(), A.data[order], m)


def csr_row_ids(A: CSRMatrix) -> torch.Tensor:
    """Row id of every stored nonzero (int64 [nnz])."""
    return row_ids(A.indptr, A.data.shape[0])


def csr_spmv(A: CSRMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for x of shape [n_cols] or [n_cols, C] (plain PyTorch).

    An index gather of x plus a per-row sum with index_add_; each row sums
    its nonzeros in CSR order.
    """
    idx = A.indices.long()
    prod = A.data[:, None] * x[idx] if x.ndim == 2 else A.data * x[idx]
    y = torch.zeros((A.n_rows, *x.shape[1:]), dtype=x.dtype, device=x.device)
    return y.index_add_(0, csr_row_ids(A), prod)


class BSRMatrix(nn.Module):
    """3x3-block CSR matrix on a device, over a vertex graph.

    indptr:  int32 [n_rows + 1]
    indices: int32 [nnz] block-column ids
    blocks:  float [nnz, 3, 3], 9 contiguous row-major values per block
    n_cols:  int (block columns)
    lanes:   int, the kernel's lanes per block row (``row_lanes`` of the
             blocks per row), read from the shapes when the matrix is
             built, so a call needs no sync

    The counterpart of the JAX package's ELL ``BSRMatrix``
    (``solver/bsr.py:41``) without its padding slots.
    """

    def __init__(self, indptr: torch.Tensor, indices: torch.Tensor,
                 blocks: torch.Tensor, n_cols: int):
        super().__init__()
        self.register_buffer("indptr", indptr)
        self.register_buffer("indices", indices)
        self.register_buffer("blocks", blocks)
        self.n_cols = int(n_cols)
        self.lanes = row_lanes(indices.shape[0], indptr.shape[0] - 1)

    @property
    def n_rows(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def nnz(self) -> int:
        return self.indices.shape[0]

    def extra_repr(self) -> str:
        return (f"blocks={self.n_rows}x{self.n_cols}, nnz={self.nnz}, dtype={self.blocks.dtype}, "
                f"lanes={self.lanes}")


def row_ids(indptr: torch.Tensor, nnz: int) -> torch.Tensor:
    """Row id of every stored nonzero of a CSR layout (int64 [nnz])."""
    counts = (indptr[1:] - indptr[:-1]).long()
    return torch.repeat_interleave(
        torch.arange(indptr.shape[0] - 1, device=indptr.device), counts,
        output_size=nnz,
    )


def bsr_spmv(A: BSRMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for x of shape [n_cols, 3] (plain PyTorch): a row gather of
    x, one 3x3 product per block, and a per-row sum in CSR order."""
    prod = torch.einsum("kij,kj->ki", A.blocks, x[A.indices.long()])
    y = torch.zeros((A.n_rows, 3), dtype=x.dtype, device=x.device)
    return y.index_add_(0, row_ids(A.indptr, A.nnz), prod)
