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


class CSRMatrix(nn.Module):
    """CSR sparse matrix on a device.

    indptr:  int32 [n_rows + 1]
    indices: int32 [nnz] column ids
    data:    float [nnz] values (stored zeros are kept)
    n_cols:  int
    """

    def __init__(self, indptr: torch.Tensor, indices: torch.Tensor,
                 data: torch.Tensor, n_cols: int):
        super().__init__()
        self.register_buffer("indptr", indptr)
        self.register_buffer("indices", indices)
        self.register_buffer("data", data)
        self.n_cols = int(n_cols)

    @property
    def n_rows(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n_rows, self.n_cols)

    def extra_repr(self) -> str:
        return f"shape={self.shape}, nnz={self.data.shape[0]}, dtype={self.data.dtype}"


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

    @property
    def n_rows(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def nnz(self) -> int:
        return self.indices.shape[0]

    def extra_repr(self) -> str:
        return f"blocks={self.n_rows}x{self.n_cols}, nnz={self.nnz}, dtype={self.blocks.dtype}"


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
