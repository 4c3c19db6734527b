"""Newton-Schulz matrix-sign apply for the per-face PSD projection (counterpart of ``surface_multigrid_code_tpu/ops/psd.py``).

``ns_sign_apply(X)`` takes symmetric blocks ``[m, d, d]`` (d in {9, 18},
``||X||_2 <= 1.4`` per block) and returns ``X + X @ Z``, where ``Z`` is
the cubic iteration ``Z <- a Z - b Z^3`` started from ``X`` over the
12-step ``NS_SCHEDULE``: the matrix sign of X, so that ``(X + X sign(X))/2``
is X's PSD part. ``models/shell.psd_project_blocks`` scales and clamps
around it.

A CUDA tensor goes to the hand-written kernel K4 of ``csrc/psd.cu``; a
CPU tensor goes to ``ns_sign_apply_plain``, the same arithmetic as batched
``torch.bmm``. Both run in the working type (f32 or f64) without TF32:
the schedule's growth cubics amplify input rounding about 700-fold on
small-eigenvalue directions (see the JAX package's module note), so the
products must stay full precision. Each block is computed alone: the
TPU's 126-wide block-diagonal packing and its selector einsums are not
needed here.
"""

from __future__ import annotations

import ctypes

import torch

from surface_multigrid_code_torch._build import load_library

# Designed by benchmarks/probes/design_ns_schedule.py: (a, b) per cubic
# step x <- a*x - b*x^3.  Valid (p >= 0, bounded by 1.2) on |x| <= 1.4;
# saturates |sign - 1| <= 5e-9 for |x| >= 1.5e-3 (7 greedy growth steps
# + 5 plain-NS quadratic cleanup steps).
NS_SCHEDULE = (
    (2.224875, 1.133054),
    (2.592197, 1.792000),
    (2.587663, 1.782611),
    (2.571791, 1.750010),
    (2.533244, 1.672496),
    (2.435745, 1.486720),
    (2.213538, 1.115821),
    (1.5, 0.5),
    (1.5, 0.5),
    (1.5, 0.5),
    (1.5, 0.5),
    (1.5, 0.5),
)

BLOCK_SIZES = (9, 18)


def ns_sign_apply_plain(X: torch.Tensor, schedule=NS_SCHEDULE) -> torch.Tensor:
    """Plain PyTorch version of ``ns_sign_apply`` (batched bmm, TF32 off)."""
    ns_sign_apply_plain.calls += 1
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        Z = X
        for a, b in schedule:
            Z = a * Z - b * torch.bmm(torch.bmm(Z, Z), Z)
        return X + torch.bmm(X, Z)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


ns_sign_apply_plain.calls = 0


def ns_sign_apply(X: torch.Tensor, schedule=NS_SCHEDULE) -> torch.Tensor:
    """X + X @ sign(X) per block of ``X [m, d, d]``; see the module docstring.

    Returns a new tensor. Each kernel launch adds one to
    ``ns_sign_apply.launches``.
    """
    if X.device.type == "cpu":
        return ns_sign_apply_plain(X, schedule)
    if X.device.type != "cuda":
        raise TypeError(f"ns_sign_apply runs on CUDA or CPU tensors, not {X.device}")
    if X.ndim != 3 or X.shape[1] != X.shape[2] or X.shape[1] not in BLOCK_SIZES:
        raise ValueError(f"X must be [m, d, d] with d in {BLOCK_SIZES}, not {tuple(X.shape)}")
    if X.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kernel takes float32 or float64 blocks, not {X.dtype}")
    if not X.is_contiguous():
        raise ValueError("X must be contiguous")
    if X.shape[0] >= 2**31:
        raise ValueError("too many blocks for one launch")
    lib = load_library()
    Y = torch.empty_like(X)
    if X.shape[0] == 0:
        return Y
    coeffs = (ctypes.c_double * (2 * len(schedule)))(
        *(float(v) for pair in schedule for v in pair))
    fn = lib.smg_ns_sign_apply_f32 if X.dtype == torch.float32 else lib.smg_ns_sign_apply_f64
    with torch.cuda.device(X.device):
        err = fn(X.data_ptr(), Y.data_ptr(), X.shape[0], X.shape[1],
                 ctypes.cast(coeffs, ctypes.c_void_p), len(schedule),
                 torch.cuda.current_stream().cuda_stream)
    ns_sign_apply.launches += 1
    if err != 0:
        raise RuntimeError(f"ns_sign_apply launch failed: cudaError {err}")
    return Y


ns_sign_apply.launches = 0
