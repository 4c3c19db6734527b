"""K1 with its x window staged in shared memory on the card: does a copy of x by chunk pay?

The counterpart of ``benchmarks/probes/probe_dbuf.py``, which double-buffered
the x-window copy of the TPU's dia-mode kernel (its record: "inconclusive:
below the noise floor"). ``spmv_staged`` (``csrc/spmv_probe.cu``) computes
K1's Jacobi sweep y = u + (b - A x) (s escale) on an RCM-ordered operator:
each CTA walks chunks of ``CHUNK_ROWS`` consecutive rows, copies the next
chunk's x window [least column, largest column] into shared memory with
``cp.async`` while it computes the current chunk from the other buffer,
and gathers x from shared memory. A chunk whose window exceeds a buffer
(``WINDOW`` floats) gathers x from global memory instead; the plan
(``staged_plan``, on the host) counts such chunks. None is wide at ico7
or ico9 with ``WINDOW``, so the check also runs a plan whose buffers hold
half the widest window (``narrow_plan``), where some are.

The probe runs it in turns with K1 and cuSPARSE (``torch.sparse_csr_tensor
@ x``, the library time) on the finest operator of ``bench.ico_operators``
(ico7: 13 MB, in the 50 MB L2; ico9: 210 MB, out of it), beside K1's byte
bound (``utils.bounds.spmv_bytes``) and the bytes the windows add, and
holds it, on both plans, to K1's plain version at ``TOL`` x max|y|.

    python -m surface_multigrid_code_torch.probes.staged_spmv [--device cpu] [--orders 7 9]
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from surface_multigrid_code_torch._build import load_library
from surface_multigrid_code_torch.ops.sparse import CSRMatrix, csr_from_scipy
from surface_multigrid_code_torch.ops.spmv import fused_spmv, fused_spmv_plain
from surface_multigrid_code_torch.probes import _common as C
from surface_multigrid_code_torch.probes.bf16_values import ESCALE, K1_KERNEL, jacobi_inputs
from surface_multigrid_code_torch.utils.bounds import spmv_bytes

ORDERS = (7, 9)
CHUNK_ROWS = 512
WINDOW = 8192  # floats a buffer: 32 KB, two a CTA
THREADS = 512  # csrc/spmv_probe.cu kStagedThreads
SMEM_PER_SM = 227 * 1024
MAX_LANES = 8
TOL = 1e-5


@dataclass
class StagedPlan:
    """The chunks of ``spmv_staged``: rows [c chunk_rows, (c + 1)
    chunk_rows) and x window [win_lo[c], win_hi[c]] ([0, -1] without a
    nonzero); ``wide``: chunks whose window (from win_lo rounded down to 4
    floats) exceeds ``window`` floats; ``staged_bytes``: the bytes the
    other chunks' windows copy a call."""

    chunk_rows: int
    window: int
    win_lo: torch.Tensor
    win_hi: torch.Tensor
    wide: int
    staged_bytes: int
    window_floats: dict

    @property
    def n_chunks(self) -> int:
        return self.win_lo.shape[0]


def staged_plan(H: sp.csr_matrix, dev, chunk_rows: int = CHUNK_ROWS,
                window: int = WINDOW) -> StagedPlan:
    """The chunks' x windows of the host CSR ``H``."""
    if window % 4 or window <= 0 or chunk_rows <= 0:
        raise ValueError("window must be a positive multiple of 4, chunk_rows positive")
    n = H.shape[0]
    starts = np.arange(0, n, chunk_rows)
    ends = np.minimum(starts + chunk_rows, n)
    nnz = H.indptr[ends] - H.indptr[starts]
    lo = np.zeros(starts.size, np.int64)
    hi = np.full(starts.size, -1, np.int64)
    full = nnz > 0
    if full.any():
        offs = H.indptr[starts[full]]
        lo[full] = np.minimum.reduceat(H.indices, offs)
        hi[full] = np.maximum.reduceat(H.indices, offs)
    count = hi + 1 - (lo & ~3)
    wide = count > window
    return StagedPlan(
        chunk_rows=chunk_rows, window=window,
        win_lo=torch.as_tensor(lo.astype(np.int32), device=dev),
        win_hi=torch.as_tensor(hi.astype(np.int32), device=dev),
        wide=int(wide.sum()), staged_bytes=int(4 * count[~wide].sum()),
        window_floats={"mean": float(count.mean()), "max": int(count.max())})


def spmv_staged_plain(A: CSRMatrix, plan: StagedPlan, x, u, b, s, escale=1.0):
    """Plain PyTorch version of ``spmv_staged``: K1's plain version (the
    staging changes where x is read from, not the result)."""
    spmv_staged_plain.calls += 1
    return fused_spmv_plain(A, x, "axpby", b=b, u=u, s=s, escale=escale)


spmv_staged_plain.calls = 0


def resident_ctas(index: int, window: int) -> int:
    """CTAs of ``spmv_staged`` the card holds at once: by threads and by
    shared memory (two buffers and 1 KB the runtime keeps per CTA)."""
    p = torch.cuda.get_device_properties(index)
    per_sm = min(p.max_threads_per_multi_processor // THREADS,
                 SMEM_PER_SM // (2 * 4 * window + 1024))
    return p.multi_processor_count * max(per_sm, 1)


def spmv_staged(A: CSRMatrix, plan: StagedPlan, x, u, b, s, escale=1.0) -> torch.Tensor:
    """y = u + (b - A x) (s escale) with x staged by chunk (f32, one
    column). A CUDA tensor goes to the kernel, persistent CTAs over the
    plan's chunks, min(A.lanes, 8) lanes a row (each launch adds one to
    ``spmv_staged.launches``), a CPU tensor to the plain version."""
    n = A.n_rows
    if A.data.dtype != torch.float32:
        raise TypeError(f"kernel takes a float32 operator, not {A.data.dtype}")
    if plan.n_chunks != -(-n // plan.chunk_rows):
        raise ValueError(f"the plan has {plan.n_chunks} chunks of {plan.chunk_rows} rows for "
                         f"{n} rows")
    for name, t, shape in (("x", x, (A.n_cols,)), ("u", u, (n,)), ("b", b, (n,)),
                           ("s", s, (n,))):
        if t.dtype != torch.float32 or t.device != A.data.device:
            raise TypeError(f"{name} is {t.dtype} on {t.device}; float32 on {A.data.device} "
                            "expected")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous of shape {shape}, not {tuple(t.shape)}")
    if x.device.type == "cpu":
        return spmv_staged_plain(A, plan, x, u, b, s, escale)
    if x.device.type != "cuda":
        raise TypeError(f"spmv_staged runs on CUDA or CPU tensors, not {x.device}")
    for t in (A.indptr, A.indices, plan.win_lo, plan.win_hi):
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != x.device:
            raise TypeError(f"the operator's and the plan's indices must be contiguous int32 "
                            f"on {x.device}")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned (cp.async copies 16 B)")
    lib = load_library()
    y = torch.empty_like(u)
    if n == 0:
        return y
    with torch.cuda.device(x.device):
        grid = min(plan.n_chunks, resident_ctas(torch.cuda.current_device(), plan.window))
        err = lib.smg_spmv_staged_f32(
            A.indptr.data_ptr(), A.indices.data_ptr(), A.data.data_ptr(), x.data_ptr(),
            y.data_ptr(), u.data_ptr(), b.data_ptr(), s.data_ptr(), float(escale),
            plan.win_lo.data_ptr(), plan.win_hi.data_ptr(), n, plan.chunk_rows,
            plan.n_chunks, plan.window, min(A.lanes, MAX_LANES), grid,
            torch.cuda.current_stream().cuda_stream)
    spmv_staged.launches += 1
    if err != 0:
        raise RuntimeError(f"spmv_staged launch failed: cudaError {err}")
    return y


spmv_staged.launches = 0


def library_csr(H: sp.csr_matrix, dev):
    """The operator as a torch sparse CSR tensor (cuSPARSE on the card)."""
    return torch.sparse_csr_tensor(
        torch.as_tensor(H.indptr, dtype=torch.int32, device=dev),
        torch.as_tensor(H.indices, dtype=torch.int32, device=dev),
        torch.as_tensor(H.data, dtype=torch.float32, device=dev), size=H.shape)


def prepare(H: sp.csr_matrix, dev: torch.device, label: str, seed: int = 0) -> dict:
    """The operator of the host CSR ``H`` on ``dev``, its plan, the
    sweep's inputs and the cuSPARSE operator."""
    return {"H": H, "label": label, "A": csr_from_scipy(H, dev, torch.float32),
            "plan": staged_plan(H, dev), "v": jacobi_inputs(H, dev, seed),
            "library": library_csr(H, dev)}


def calls(p: dict, plan: StagedPlan | None = None) -> dict:
    """() -> K1's sweep, the staged one (on ``plan``, by default the
    prepared one), the plain version and cuSPARSE's A x."""
    A, v = p["A"], p["v"]
    plan = p["plan"] if plan is None else plan
    args = (v["x"], v["u"], v["b"], v["s"], ESCALE)
    return {"k1": lambda: fused_spmv(A, v["x"], "axpby", b=v["b"], u=v["u"], s=v["s"],
                                     escale=ESCALE),
            "staged": lambda: spmv_staged(A, plan, *args),
            "plain": lambda: spmv_staged_plain(A, plan, *args),
            "library": lambda: p["library"] @ v["x"]}


def narrow_plan(p: dict) -> StagedPlan:
    """A plan of the prepared operator whose buffers hold half its widest
    chunk's window (a multiple of 4 floats, at most WINDOW), so that at
    least that chunk takes the wide branch (x from global memory)."""
    window = min(WINDOW, max(4, p["plan"].window_floats["max"] // 2 // 4 * 4))
    return staged_plan(p["H"], p["A"].data.device, window=window)


def check(p: dict) -> dict:
    """``spmv_staged`` against its plain version at ``TOL`` x max|y|, on
    the prepared plan and on ``narrow_plan`` (which must have wide
    chunks); raises on a disagreement."""
    out = {}
    for name, plan in (("plan", p["plan"]), ("narrow", narrow_plan(p))):
        if name == "narrow" and plan.wide == 0:
            raise RuntimeError(f"the narrow plan of {p['label']} has no wide chunk")
        fns = calls(p, plan)
        y, yp = fns["staged"](), fns["plain"]()
        err, scale = float((y - yp).abs().max()), float(yp.abs().max())
        if not err <= TOL * scale:
            raise RuntimeError(f"spmv_staged on {p['label']} (window {plan.window}, "
                               f"{plan.wide} wide chunks) is {err:.3e} from its plain version "
                               f"(limit {TOL * scale:.3e})")
        out[name] = {"window": plan.window, "chunks": plan.n_chunks, "wide_chunks": plan.wide,
                     "max_abs_err": err, "max_abs_y": scale}
    return {"max_abs_err": max(r["max_abs_err"] for r in out.values()), "tol": TOL, **out}


def measure(p: dict, dev: torch.device) -> dict:
    """``spmv_staged`` in turns with K1 and cuSPARSE (K1, staged, cuSPARSE,
    cuSPARSE, staged, K1, then the plain version; back-to-back calls: L2
    warm where the call's bytes fit in the 50 MB L2), beside K1's byte
    bound and the bytes the windows add."""
    H, plan = p["H"], p["plan"]
    fns = calls(p)
    nbytes, flops = spmv_bytes(H, 1, "axpby")
    bound, by = C.bound_ms(nbytes, flops)
    rec = {"operator": p["label"], "rows": int(H.shape[0]), "nnz": int(H.nnz),
           "l2": "warm" if nbytes < 50e6 else "exceeds the 50 MB L2",
           "chunk_rows": plan.chunk_rows, "window": plan.window, "chunks": plan.n_chunks,
           "wide_chunks": plan.wide, "window_floats": plan.window_floats,
           "staged_bytes": plan.staged_bytes, "bytes": int(nbytes), "bound_ms": bound,
           "bound_by": by}
    t = C.timed(fns, ("k1", "staged", "library", "library", "staged", "k1", "plain"),
                {"k1": K1_KERNEL, "staged": "spmv_staged_kernel"}, dev, p["label"])
    rec["turns_ms"] = {k: t[k]["turns_ms"] for k in ("k1", "staged", "library")}
    rec["ms"], rec["k1_ms"], rec["library_ms"], rec["plain_ms"] = (
        t[k]["ms"] for k in ("staged", "k1", "library", "plain"))
    rec["call_ms"], rec["plain_call_ms"] = t["staged"]["call_ms"], t["plain"]["call_ms"]
    rec["bound_share"], rec["k1_bound_share"] = (C.share(bound, rec[k]) for k in ("ms", "k1_ms"))
    return rec


def main(argv=None) -> int:
    return C.operator_main("staged_spmv", __doc__, argv, ORDERS, "ico{k} A_0 axpby", prepare,
                           measure, check)


if __name__ == "__main__":
    raise SystemExit(main())
