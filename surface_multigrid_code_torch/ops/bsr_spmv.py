"""Fused 3x3-block SpMV + epilogue (counterpart of ``well_spmv_block3`` / ``well_block3_apply``, ``surface_multigrid_code_tpu/ops/well.py:1222, :1535``).

``fused_bsr_spmv(A, x, epi, b, u, s, escale)`` computes ``y = epi(A @ x)``
for a ``BSRMatrix`` A (3x3 blocks on a vertex graph) and ``x`` of shape
``[n_cols, 3]``, with the epilogue table of ``fused_spmv``:

    None:          y = Ax
    "axpby":       y = u + (b - Ax) * (s * escale)
    "resid":       y = b - Ax
    "add":         y = u + Ax
    "resid_scaled": y = (b - Ax) * (s * escale)

``u``, ``b`` and ``s`` are ``[n_rows, 3]``: unlike the scalar kernels the
scale is per component (``_EPI_KINDS_B3``, ``ops/well.py:727-730``), the
inverse of the block diagonal's three scalar entries.

A CUDA tensor goes to the hand-written kernel K3 of ``csrc/bsr_spmv.cu``;
a CPU tensor goes to ``fused_bsr_spmv_plain``, the plain PyTorch version
of the same function. There is no other route.
"""

from __future__ import annotations

import torch

from surface_multigrid_code_torch._build import load_library
from surface_multigrid_code_torch.ops.sparse import BSRMatrix, bsr_spmv
from surface_multigrid_code_torch.ops.spmv import _EPI_CODE, _EPI_OPERANDS, _epilogue


def fused_bsr_spmv_plain(A: BSRMatrix, x, epi=None, b=None, u=None, s=None,
                         escale=1.0):
    """Plain PyTorch version of ``fused_bsr_spmv`` (same arguments and result)."""
    fused_bsr_spmv_plain.calls += 1
    return _epilogue(bsr_spmv(A, x), epi, b, u, s, escale)


fused_bsr_spmv_plain.calls = 0


def _check(A: BSRMatrix, x, epi, b, u, s):
    """Raise on anything the kernel does not take."""
    if epi not in _EPI_CODE:
        raise ValueError(f"unknown epilogue {epi!r}")
    dev, dt = A.blocks.device, A.blocks.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"kernel takes float32 or float64 blocks, not {dt}")
    if tuple(A.blocks.shape) != (A.nnz, 3, 3) or not A.blocks.is_contiguous():
        raise ValueError("blocks must be a contiguous [nnz, 3, 3] tensor")
    given = {"u": u, "b": b, "s": s}
    for name in _EPI_OPERANDS[epi]:
        if given[name] is None:
            raise ValueError(f"epilogue {epi!r} needs {name}")
    yshape = (A.n_rows, 3)
    shapes = {"x": (A.n_cols, 3), "u": yshape, "b": yshape, "s": yshape}
    for name, t in {"x": x, **given}.items():
        if t is None:
            continue
        if t.device != dev or t.dtype != dt:
            raise TypeError(f"{name} is {t.dtype} on {t.device}; the operator is {dt} on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shapes[name]}")
    for name in ("indptr", "indices"):
        t = getattr(A, name)
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError(f"operator {name} must be contiguous int32 on {dev}")


def fused_bsr_spmv(A: BSRMatrix, x: torch.Tensor, epi: str | None = None,
                   b=None, u=None, s=None, escale: float = 1.0) -> torch.Tensor:
    """y = epi(A @ x) on [n, 3] states; see the module docstring.

    Returns a new tensor. Each kernel launch adds one to
    ``fused_bsr_spmv.launches``.
    """
    if x.device.type == "cpu":
        return fused_bsr_spmv_plain(A, x, epi, b, u, s, escale)
    if x.device.type != "cuda":
        raise TypeError(f"fused_bsr_spmv runs on CUDA or CPU tensors, not {x.device}")
    _check(A, x, epi, b, u, s)
    lib = load_library()
    out = torch.empty((A.n_rows, 3), dtype=x.dtype, device=x.device)
    if A.n_rows == 0:
        return out
    ptr = (lambda t: None if t is None else t.data_ptr())
    fn = lib.smg_bsr_spmv_f32 if x.dtype == torch.float32 else lib.smg_bsr_spmv_f64
    with torch.cuda.device(x.device):
        err = fn(
            A.indptr.data_ptr(), A.indices.data_ptr(), A.blocks.data_ptr(),
            x.data_ptr(), out.data_ptr(), ptr(u), ptr(b), ptr(s),
            float(escale), A.n_rows, _EPI_CODE[epi],
            torch.cuda.current_stream().cuda_stream,
        )
    fused_bsr_spmv.launches += 1
    if err != 0:
        raise RuntimeError(f"bsr_spmv launch failed: cudaError {err}")
    return out


fused_bsr_spmv.launches = 0
