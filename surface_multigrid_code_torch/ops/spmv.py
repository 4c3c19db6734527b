"""Fused SpMV + epilogue (counterpart of ``surface_multigrid_code_tpu/ops/well.py``).

One entry point, ``fused_spmv``, computes ``y = epi(A @ x)`` with the
epilogue table of ``ops/well.py:710-753``:

    None:          y = Ax
    "axpby":       y = u + (b - Ax) * (s * escale)
    "resid":       y = b - Ax
    "add":         y = u + Ax
    "resid_scaled": y = (b - Ax) * (s * escale)

``x`` is ``[n_cols]`` or ``[n_cols, C]``; ``u`` and ``b`` have the shape of
``y`` (one column each per right-hand side) and ``s`` is ``[n_rows]``,
shared by the columns (``_EPI_KINDS``, ``ops/well.py:720``). With ``rows``
only those rows are computed and written, in place, into ``out``: the
multicolor Gauss-Seidel update.

A CUDA tensor goes to the hand-written kernel of ``csrc/spmv.cu`` (K1 for
one column, K2 for C columns), which computes each row with a sub-warp of
``launch_lanes(A.lanes, rows launched, card_threads)`` lanes: the
operator's lanes (``ops.sparse.row_lanes``), fewer where the launch would
not fit the card in one wave. A CPU tensor goes to ``fused_spmv_plain``,
the plain PyTorch version of the same function. There is no other route.
The TPU's ``acc`` chaining over slot groups (``well_apply``) is a layout
artifact and has no counterpart.
"""

from __future__ import annotations

import functools

import torch

from surface_multigrid_code_torch._build import load_library
from surface_multigrid_code_torch.ops.sparse import CSRMatrix, csr_spmv

_LANES = (1, 2, 4, 8, 16, 32)
_EPI_CODE = {None: 0, "axpby": 1, "resid": 2, "add": 3, "resid_scaled": 4}
_EPI_OPERANDS = {
    None: (), "axpby": ("u", "b", "s"), "resid": ("b",), "add": ("u",),
    "resid_scaled": ("b", "s"),
}


def launch_lanes(lanes: int, n_out: int, card_threads: int) -> int:
    """Sub-warp width of one launch: the operator's ``lanes``, halved while
    the launched rows times lanes exceed the threads the card holds at once.
    A launch that fits in one wave keeps a lane per nonzero; a larger one
    has each lane walk several nonzeros instead of queueing more waves."""
    while lanes > 1 and n_out * lanes > card_threads:
        lanes //= 2
    return lanes


@functools.lru_cache(maxsize=None)
def card_threads(index: int) -> int:
    """Threads CUDA device ``index`` holds at once (SMs x threads per SM)."""
    p = torch.cuda.get_device_properties(index)
    return p.multi_processor_count * p.max_threads_per_multi_processor


def _epilogue(Ax, epi, b, u, s, escale):
    if epi is None:
        return Ax
    if epi == "resid":
        return b - Ax
    if epi == "add":
        return u + Ax
    sc = s * escale
    if sc.ndim < Ax.ndim:  # a row-shared scale over C columns
        sc = sc[:, None]
    if epi == "axpby":
        return u + (b - Ax) * sc
    return (b - Ax) * sc


def fused_spmv_plain(A: CSRMatrix, x, epi=None, b=None, u=None, s=None,
                     escale=1.0, rows=None, out=None):
    """Plain PyTorch version of ``fused_spmv`` (same arguments and result)."""
    fused_spmv_plain.calls += 1
    Ax = csr_spmv(A, x)
    if rows is None:
        y = _epilogue(Ax, epi, b, u, s, escale)
        if out is None:
            return y
        out.copy_(y)
        return out
    r = rows.long()
    pick = (lambda v: None if v is None else v[r])
    out[r] = _epilogue(Ax[r], epi, pick(b), pick(u), pick(s), escale)
    return out


fused_spmv_plain.calls = 0


def _check(A: CSRMatrix, x, epi, b, u, s, rows, out):
    """Raise on anything the kernel does not take."""
    if epi not in _EPI_CODE:
        raise ValueError(f"unknown epilogue {epi!r}")
    dev, dt = A.data.device, A.data.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"kernel takes float32 or float64 operators, not {dt}")
    if x.ndim not in (1, 2) or x.shape[0] != A.n_cols:
        raise ValueError(f"x of shape {tuple(x.shape)} for an operator of shape {A.shape}")
    yshape = (A.n_rows, *x.shape[1:])
    given = {"u": u, "b": b, "s": s}
    for name in _EPI_OPERANDS[epi]:
        if given[name] is None:
            raise ValueError(f"epilogue {epi!r} needs {name}")
    shapes = {"x": tuple(x.shape), "out": yshape, "u": yshape, "b": yshape,
              "s": (A.n_rows,)}
    for name, t in {"x": x, "out": out, **given}.items():
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
    if A.lanes not in _LANES:
        raise ValueError(f"operator lanes {A.lanes} is not one of {_LANES}")
    if rows is not None:
        if out is None:
            raise ValueError("a row subset is written in place: pass out=")
        if rows.device != dev or rows.dtype != torch.int32 or rows.ndim != 1 \
                or not rows.is_contiguous():
            raise TypeError("rows must be a contiguous 1-D int32 tensor on the operator's device")


def fused_spmv(A: CSRMatrix, x: torch.Tensor, epi: str | None = None,
               b=None, u=None, s=None, escale: float = 1.0, rows=None, out=None):
    """y = epi(A @ x); see the module docstring for the epilogues.

    Returns ``out`` when given (and always with ``rows``), else a new tensor.
    Each kernel launch adds one to ``fused_spmv.launches``; launches of the
    multi-column kernel (K2) also add one to ``fused_spmv.planes_launches``.
    ``fused_spmv.last_lanes`` is the sub-warp width of the last launch.
    """
    if x.device.type == "cpu":
        return fused_spmv_plain(A, x, epi, b, u, s, escale, rows, out)
    if x.device.type != "cuda":
        raise TypeError(f"fused_spmv runs on CUDA or CPU tensors, not {x.device}")
    _check(A, x, epi, b, u, s, rows, out)
    lib = load_library()
    n_out = A.n_rows if rows is None else rows.shape[0]
    if out is None:
        out = torch.empty((A.n_rows, *x.shape[1:]), dtype=x.dtype, device=x.device)
    if n_out == 0:
        return out
    ptr = (lambda t: None if t is None else t.data_ptr())
    suffix = "f32" if x.dtype == torch.float32 else "f64"
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        lanes = launch_lanes(A.lanes, n_out, card_threads(torch.cuda.current_device()))
        args = (
            A.indptr.data_ptr(), A.indices.data_ptr(), A.data.data_ptr(),
            x.data_ptr(), out.data_ptr(), ptr(u), ptr(b), ptr(s),
            float(escale), ptr(rows), n_out,
        )
        if x.ndim == 1:
            err = getattr(lib, f"smg_spmv_fused_{suffix}")(
                *args, lanes, _EPI_CODE[epi], stream)
        else:
            err = getattr(lib, f"smg_spmv_fused_planes_{suffix}")(
                *args, x.shape[1], lanes, _EPI_CODE[epi], stream)
            fused_spmv.planes_launches += 1
    fused_spmv.launches += 1
    fused_spmv.last_lanes = lanes
    if err != 0:
        raise RuntimeError(f"spmv_fused launch failed: cudaError {err}")
    return out


fused_spmv.launches = 0
fused_spmv.planes_launches = 0
fused_spmv.last_lanes = None
