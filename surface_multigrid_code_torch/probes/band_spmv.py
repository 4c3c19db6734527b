"""SpMV as a dense band on tensor cores on the card: can bytes of zeros pay for mma?

The counterpart of ``benchmarks/probes/probe_mxu_band.py``, which ran the
RCM-ordered operator as dense band x contiguous x window products on the
MXU (its record, TPU v5e: 21-33 times slower than the windowed kernel at
3 columns). The layout (``band_layout``, the probe's ``:52-81``): row blocks
of ``BAND_ROWS`` rows; block r's window starts at its least column; the
band holds entry (i, c) = A[i, start + c] over the largest span W (rounded
up to ``BAND_K``), in bf16 or in f32. ``band_spmv_tc``
(``csrc/spmv_probe.cu``) computes Y = A X for X [n, nc] (nc <= 128) with
``mma.sync``: bf16 inputs (x rounded to bf16) or TF32 for the f32 band,
f32 accumulation.

The probe runs it at nc = 128 (the TPU probe's best case) and nc = 3 (the
workload's), for both band types, on the finest operator of
``bench.ico_operators``; an operator whose band exceeds ``MAX_BAND_BYTES``
is skipped (the TPU probe's rule, ``:72-74``) and says so. Beside it: K2
at C = 3, K1 three times (a column each) and cuSPARSE (``torch.sparse_csr_
tensor @ X``, the library time) on the same operator, in turns. The
kernel is held to its plain version, ``band_spmv_tc_plain`` (the band
product with ``torch.matmul``, TF32 off on bf16-rounded x for the bf16
band, TF32 on for the f32 band), within ``band_tolerance`` of |A| |X|.
Its bound is the function's (the CSR operator, the X rows it gathers and
Y: ``utils.bounds.spmv_bytes``), not the band's: the zeros the band
moves are the layout's cost, reported as ``band_bound_ms``.

    python -m surface_multigrid_code_torch.probes.band_spmv [--device cpu] [--orders 6 7]
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from surface_multigrid_code_torch._build import load_library
from surface_multigrid_code_torch.ops.sparse import csr_from_scipy
from surface_multigrid_code_torch.ops.spmv import fused_spmv
from surface_multigrid_code_torch.probes import _common as C
from surface_multigrid_code_torch.probes.bf16_values import K1_KERNEL
from surface_multigrid_code_torch.probes.staged_spmv import library_csr
from surface_multigrid_code_torch.utils.bounds import spmv_bytes

ORDERS = (6, 7)
BAND_ROWS = 256  # csrc/spmv_probe.cu kBandRows: 8 warps x 2 tiles of 16 rows
BAND_K = 32  # kBandK: window rows a step
MAX_NC = 128
NCS = (128, 3)
BAND_TYPES = (torch.bfloat16, torch.float32)
MAX_BAND_BYTES = 6e9
F32_U = 2.0**-24


@dataclass
class BandLayout:
    """A [n_rows, n_cols] operator as row blocks of BAND_ROWS rows, block r
    holding A[rows of r, start[r] : start[r] + W] densely in ``band``
    ([blocks x BAND_ROWS, W], bf16 or f32)."""

    n_rows: int
    n_cols: int
    W: int
    start: torch.Tensor
    band: torch.Tensor
    max_row: int
    x_rows: int  # max(start) + W: the rows of X the windows reach

    @property
    def blocks(self) -> int:
        return self.start.shape[0]


def band_shape(H: sp.csr_matrix) -> tuple:
    """(start [blocks] int64, W) of the host CSR ``H``: each block's least
    column and the largest span, rounded up to BAND_K."""
    n = H.shape[0]
    starts = np.arange(0, n, BAND_ROWS)
    ends = np.minimum(starts + BAND_ROWS, n)
    nnz = H.indptr[ends] - H.indptr[starts]
    lo = np.zeros(starts.size, np.int64)
    hi = np.zeros(starts.size, np.int64)
    full = nnz > 0
    if full.any():
        offs = H.indptr[starts[full]]
        lo[full] = np.minimum.reduceat(H.indices, offs)
        hi[full] = np.maximum.reduceat(H.indices, offs)
    span = int((hi - lo + 1).max())
    return lo, -(-span // BAND_K) * BAND_K


def band_layout(H: sp.csr_matrix, dev, dtype) -> BandLayout:
    """The band of the host CSR ``H`` on ``dev`` (values rounded to dtype
    from f32, as the f32 operator holds them)."""
    H = sp.csr_matrix(H)
    H.sum_duplicates()
    start, W = band_shape(H)
    rows = np.repeat(np.arange(H.shape[0]), np.diff(H.indptr))
    loc = H.indices - start[rows // BAND_ROWS]
    band = torch.zeros((start.size * BAND_ROWS, W), dtype=dtype, device=dev)
    band[torch.as_tensor(rows, device=dev), torch.as_tensor(loc, device=dev)] = torch.as_tensor(
        H.data.astype(np.float32), device=dev).to(dtype)
    return BandLayout(H.shape[0], H.shape[1], W,
                      torch.as_tensor(start.astype(np.int32), device=dev), band,
                      int(np.diff(H.indptr).max()), int(start.max()) + W)


def windows(L: BandLayout, X: torch.Tensor) -> torch.Tensor:
    """X's window of every block, [blocks, W, nc] (zero past X's last row)."""
    idx = L.start.long()[:, None] + torch.arange(L.W, device=X.device)
    pad = L.x_rows - X.shape[0]
    Xp = torch.cat([X, X.new_zeros((pad, X.shape[1]))]) if pad > 0 else X
    return Xp[idx]


def band_spmv_tc_plain(L: BandLayout, X: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``band_spmv_tc``: the band times each
    block's window with torch.matmul; for the bf16 band X rounded to bf16
    and the products in f32 with TF32 off, for the f32 band TF32 on."""
    band_spmv_tc_plain.calls += 1
    A = L.band.view(L.blocks, BAND_ROWS, L.W)
    Xw = windows(L, X)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = L.band.dtype == torch.float32
    try:
        if L.band.dtype == torch.bfloat16:
            Y = torch.matmul(A.float(), Xw.to(torch.bfloat16).float())
        else:
            Y = torch.matmul(A, Xw)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    return Y.reshape(L.blocks * BAND_ROWS, -1)[:L.n_rows]


band_spmv_tc_plain.calls = 0


def band_spmv_tc(L: BandLayout, X: torch.Tensor) -> torch.Tensor:
    """Y [n_rows, nc] = A X through the band on tensor cores (bf16 or TF32
    by the band's type), X [n_cols, nc] f32, nc <= 128. A CUDA tensor goes
    to the kernel (each launch adds one to ``band_spmv_tc.launches``), a CPU
    tensor to the plain version."""
    if L.band.dtype not in BAND_TYPES:
        raise TypeError(f"the band must be bfloat16 or float32, not {L.band.dtype}")
    if (L.band.ndim != 2 or L.band.shape[0] != L.blocks * BAND_ROWS or L.band.shape[1] != L.W
            or L.W % BAND_K or L.blocks != -(-L.n_rows // BAND_ROWS)):
        raise ValueError(f"band of shape {tuple(L.band.shape)} for {L.n_rows} rows in "
                         f"{L.blocks} blocks and W = {L.W}")
    if X.ndim != 2 or X.shape[0] != L.n_cols or not 1 <= X.shape[1] <= MAX_NC:
        raise ValueError(f"X must be [{L.n_cols}, nc] with nc <= {MAX_NC}, not {tuple(X.shape)}")
    if X.dtype != torch.float32 or X.device != L.band.device:
        raise TypeError(f"X is {X.dtype} on {X.device}; float32 on {L.band.device} expected")
    if X.device.type == "cpu":
        return band_spmv_tc_plain(L, X)
    if X.device.type != "cuda":
        raise TypeError(f"band_spmv_tc runs on CUDA or CPU tensors, not {X.device}")
    if not (X.is_contiguous() and L.band.is_contiguous() and L.start.is_contiguous()):
        raise ValueError("X, the band and the starts must be contiguous")
    if L.start.dtype != torch.int32 or L.start.device != X.device:
        raise TypeError(f"the starts must be int32 on {X.device}")
    lib = load_library()
    Y = torch.empty((L.n_rows, X.shape[1]), dtype=torch.float32, device=X.device)
    if L.n_rows == 0:
        return Y
    with torch.cuda.device(X.device):
        err = lib.smg_band_spmv_tc(L.band.data_ptr(), L.start.data_ptr(), X.data_ptr(),
                                   Y.data_ptr(), L.n_rows, L.W, X.shape[0], X.shape[1],
                                   int(L.band.dtype == torch.bfloat16),
                                   torch.cuda.current_stream().cuda_stream)
    band_spmv_tc.launches += 1
    if err != 0:
        raise RuntimeError(f"band_spmv_tc launch failed: cudaError {err}")
    return Y


band_spmv_tc.launches = 0


def band_tolerance(L: BandLayout) -> float:
    """Bound on |kernel - plain| relative to (|A| |X|) entry by entry.

    - bf16: both sides multiply the same bf16 values (the band is stored
      in bf16, x rounded to nearest even on both), exactly in f32, and sum
      in f32 in other orders: at most 2 (max_row + 1) f32 roundoffs.
    - TF32: the kernel rounds both operands to nearest (cvt.rna); cuBLAS's
      TF32 may truncate, so each side's products are within 2 x 2^-10 of
      the f32 products: 4 x 2^-10 between them, plus the sums' roundoffs.
    """
    acc = 2 * (L.max_row + 1) * F32_U
    return acc if L.band.dtype == torch.bfloat16 else 4 * 2.0**-10 + acc


def prepare(H: sp.csr_matrix, dev: torch.device, label: str, seed: int = 0) -> dict:
    """The bands of the host CSR ``H`` (both types) on ``dev``, unless the
    bf16 band exceeds MAX_BAND_BYTES; X [n, 128] from ``seed``; the
    operator for K1/K2 and for cuSPARSE."""
    start, W = band_shape(H)
    p = {"H": H, "label": label, "W": W, "blocks": int(start.size)}
    size = start.size * BAND_ROWS * W * 2  # bytes of the bf16 band
    if size > MAX_BAND_BYTES:
        p["skipped"] = f"the bf16 band takes {size / 1e9:.2f} GB, over {MAX_BAND_BYTES / 1e9:g}"
        return p
    rng = np.random.default_rng(seed)
    X = torch.as_tensor(rng.standard_normal((H.shape[1], max(NCS))).astype(np.float32),
                        device=dev)
    p.update(X={nc: X[:, :nc].contiguous() for nc in NCS},
             cols=[X[:, k].contiguous() for k in range(3)],
             S=csr_from_scipy(H, dev, torch.float32), library=library_csr(H, dev),
             bands={dtype: band_layout(H, dev, dtype) for dtype in BAND_TYPES})
    return p


def check(p: dict) -> dict:
    """The kernel against its plain version for both band types and every
    nc, within ``band_tolerance`` of |A| |X| entry by entry; raises on a
    disagreement."""
    if "skipped" in p:
        return {"skipped": p["skipped"]}
    out = {}
    for dtype, L in p["bands"].items():
        for nc, X in p["X"].items():
            Y = band_spmv_tc(L, X)
            Yp = band_spmv_tc_plain(L, X)
            saved = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = False
            try:
                mag = torch.matmul(L.band.view(L.blocks, BAND_ROWS, L.W).abs().float(),
                                   windows(L, X.abs()))
            finally:
                torch.backends.cuda.matmul.allow_tf32 = saved
            mag = mag.reshape(L.blocks * BAND_ROWS, -1)[:L.n_rows]
            tol = band_tolerance(L)
            diff = (Y - Yp).abs()
            worst = float((diff / mag.clamp_min(1e-30)).max())
            name = f"{str(dtype)[6:]} nc={nc}"
            if not bool((diff <= tol * mag).all()):
                raise RuntimeError(f"band_spmv_tc ({name}) on {p['label']} is {worst:.3e} of "
                                   f"|A||X| from its plain version (limit {tol:.3e})")
            out[name] = {"max_abs_err": float(diff.max()), "worst_rel_to_abs_product": worst,
                         "tol": tol}
    return out


def measure(p: dict, dev: torch.device) -> dict:
    """The band kernel for both band types at nc = 128 and 3, timed in
    turns beside cuSPARSE, and at nc = 3 beside K2 (C = 3) and K1 three
    times, then the plain version (back-to-back calls: L2 warm where the
    inputs fit). ``bound_ms`` is the function's, Y = A X: the operator's
    CSR (values in the band's type), the X rows it gathers and Y
    (``spmv_bytes``), 2 nnz nc operations at the tensor cores' peak;
    ``band_bound_ms`` the layout's: the dense band, X's windows and Y,
    2 rows W nc operations. A skipped operator says why."""
    H = p["H"]
    rec = {"operator": p["label"], "rows": int(H.shape[0]), "nnz": int(H.nnz), "W": p["W"],
           "blocks": p["blocks"], "band_rows": BAND_ROWS}
    if "skipped" in p:
        return {**rec, "skipped": p["skipped"]}
    S, cols = p["S"], p["cols"]
    rec["cases"] = []
    for dtype, L in p["bands"].items():
        peak = C.BF16_FLOPS_PER_S if dtype == torch.bfloat16 else C.TF32_FLOPS_PER_S
        for nc, X in p["X"].items():
            case = {"band": str(dtype)[6:], "nc": nc,
                    "band_bytes": L.band.numel() * L.band.element_size()}
            nbytes, flops = spmv_bytes(H, nc, None, value_itemsize=L.band.element_size())
            case["bytes"] = int(nbytes)
            case["bound_ms"], case["bound_by"] = C.bound_ms(nbytes, flops, peak=peak)
            case["band_bound_ms"], case["band_bound_by"] = C.bound_ms(
                case["band_bytes"] + 4 * nc * (H.shape[1] + H.shape[0]),
                2 * L.band.shape[0] * L.W * nc, peak=peak)
            fns = {"band": lambda: band_spmv_tc(L, X), "library": lambda: p["library"] @ X,
                   "plain": lambda: band_spmv_tc_plain(L, X)}
            order = ["band", "library", "library", "band", "plain"]
            if nc == 3:
                fns.update(k2_c3=lambda: fused_spmv(S, X),
                           k1_x3=lambda: [fused_spmv(S, c) for c in cols])
                order = ["band", "k2_c3", "k1_x3", "library", "library", "k1_x3", "k2_c3",
                         "band", "plain"]
            t = C.timed(fns, order, {"band": "band_spmv_tc_kernel", "k2_c3": K1_KERNEL}, dev,
                        f"{p['label']} {case['band']} nc={nc}")
            case["turns_ms"] = {k: t[k]["turns_ms"] for k in fns if k != "plain"}
            for k in fns:
                case["ms" if k == "band" else f"{k}_ms"] = t[k]["ms"]
            case["call_ms"], case["plain_call_ms"] = t["band"]["call_ms"], t["plain"]["call_ms"]
            case["bound_share"] = C.share(case["bound_ms"], case["ms"])
            case["band_bound_share"] = C.share(case["band_bound_ms"], case["ms"])
            rec["cases"].append(case)
    return rec


def main(argv=None) -> int:
    return C.operator_main("band_spmv", __doc__, argv, ORDERS, "ico{k} A_0", prepare, measure,
                           check)


if __name__ == "__main__":
    raise SystemExit(main())
