"""K1 with x held in a shared-memory ring on the card: does staging x by chunk pay?

The counterpart of ``benchmarks/probes/probe_dbuf.py``, which double-buffered
the x-window copy of the TPU's dia-mode kernel (its record: "inconclusive:
below the noise floor"). ``spmv_staged`` (``csrc/spmv_probe.cu``) computes
K1's Jacobi sweep y = u + (b - A x) (s escale) on an RCM-ordered operator,
in chunks of ``CHUNK_ROWS`` consecutive rows: each persistent CTA walks a
contiguous range of chunks (balanced by nonzeros) and keeps x in a ring of
``RING`` floats, to which each chunk adds only the columns its window
reaches past the previous one's, by bulk copies, while the chunk before
computes; it gathers x from the ring. The plan (``staged_plan``, on the
host) gives every copy and marks wide the chunks whose window the ring
cannot hold while the next copy lands: those gather x from global memory.
With ``stage_a`` the operator's and the vectors' slices of each chunk come
by bulk copies too. None is wide at ico7 or ico9 with ``RING``, so the
check also runs a ring of at most half the widest window
(``narrow_plan``), where most are.

The probe runs it in turns with K1 and cuSPARSE (``torch.sparse_csr_tensor
@ x``, the library time) on the finest operator of ``bench.ico_operators``
(ico7: 13 MB, in the 50 MB L2; ico9: 210 MB, out of it), beside K1's byte
bound (``utils.bounds.spmv_bytes``) and the bytes the ring's copies bring,
and holds it, on every plan, to K1's plain version at ``TOL`` x max|y|.

    python -m surface_multigrid_code_torch.probes.staged_spmv [--device cpu] [--orders 7 9]
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from surface_multigrid_code_torch._build import load_library
from surface_multigrid_code_torch.ops.sparse import CSRMatrix, csr_from_scipy
from surface_multigrid_code_torch.ops.spmv import (
    card_threads,
    fused_spmv,
    fused_spmv_plain,
    launch_lanes,
)
from surface_multigrid_code_torch.probes import _common as C
from surface_multigrid_code_torch.probes.bf16_values import ESCALE, K1_KERNEL, jacobi_inputs
from surface_multigrid_code_torch.utils.bounds import spmv_bytes

ORDERS = (7, 9)
CHUNK_ROWS = 512
RING = 8192  # floats of the x ring (32 KB), a power of two
THREADS = 544  # csrc/spmv_probe.cu kStagedThreads: 16 compute warps and the producer
SMEM_PER_SM = 227 * 1024
DEFAULT_GRID = 264  # the plan's CTAs off the card (two on each of 132 SMs)
# With stage_a the operator's slices come by bulk copies too: faster than
# streaming them at ico9 (210 MB, out of the L2), slower at ico7 (13 MB;
# kernel_ab.py staged, PERF.md), so the plan's default stages them only
# for an operator whose values and indices exceed the L2.
L2_BYTES = 50e6
MAX_LANES = 8
TOL = 1e-5


@dataclass
class StagedPlan:
    """The chunks of ``spmv_staged``: rows [c chunk_rows, (c + 1)
    chunk_rows), x window [win_lo[c], win_hi[c]] ([0, -1] without a
    nonzero); CTA b walks the chunks [cta_ptr[b], cta_ptr[b + 1]) (balanced
    by nonzeros) with x in a ring of ``ring`` floats; ``table`` [n_chunks,
    4] int32: the columns [copy_lo, copy_hi) each chunk adds to the ring
    (``ring_table``) and whether it is wide (x from global memory);
    ``wide``: the wide chunks; ``copy_bytes``: the bytes of x the copies
    bring a call; ``a_cap``: floats of the largest chunk's slice of
    indices or values rounded out to 16 bytes (``stage_a``: they come by
    bulk copies too)."""

    chunk_rows: int
    ring: int
    stage_a: bool
    win_lo: torch.Tensor
    win_hi: torch.Tensor
    table: torch.Tensor
    cta_ptr: torch.Tensor
    a_cap: int
    wide: int
    copy_bytes: int
    window_floats: dict

    @property
    def n_chunks(self) -> int:
        return self.win_lo.shape[0]

    @property
    def grid(self) -> int:
        return self.cta_ptr.shape[0] - 1


def chunk_windows(H: sp.csr_matrix, chunk_rows: int) -> tuple:
    """(lo, hi) [n_chunks] int64: each chunk's least and largest column,
    (0, -1) for a chunk with no nonzero."""
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
    return lo, hi


def cta_ranges(chunk_nnz: np.ndarray, grid: int) -> np.ndarray:
    """[grid + 1] boundaries of contiguous chunk ranges with about equal
    nonzeros (grid at most the chunks)."""
    grid = max(1, min(grid, chunk_nnz.size))
    cum = np.concatenate([[0], np.cumsum(chunk_nnz)])
    ptr = np.searchsorted(cum, cum[-1] * np.arange(grid + 1) / grid, side="left")
    ptr[0], ptr[-1] = 0, chunk_nnz.size
    return np.maximum.accumulate(np.clip(ptr, 0, chunk_nnz.size))


def ring_table(lo: np.ndarray, hi: np.ndarray, cta_ptr: np.ndarray, ring: int) -> np.ndarray:
    """[n_chunks, 4] int32 (copy_lo, copy_hi, wide, 0) of the chunks' x
    windows (``chunk_windows``) walked in the CTAs' ranges with a ring of
    ``ring`` floats (a power of two), 16-byte aligned: [L, H) = [lo & ~3,
    (hi + 4) & ~3).

    Each CTA's first chunk with a nonzero copies its whole window; after
    it the ring holds columns up to E (exclusive) and each chunk copies
    [max(E, H - ring), H) where H > E. While chunk c computes, the copy of
    the next chunk lands, so c reads the ring only if its window lies
    within the columns loaded since the CTA's first chunk and within the
    last ``ring`` columns below the end the next copy reaches: L >= max(S,
    E_next - ring). Any other chunk is wide (x from global memory); its
    copy is made all the same."""
    L = lo & ~3
    Hx = (hi + 4) & ~3
    table = np.zeros((lo.size, 4), np.int64)
    for b in range(cta_ptr.size - 1):
        chunks = [c for c in range(cta_ptr[b], cta_ptr[b + 1]) if hi[c] >= lo[c]]
        if not chunks:
            continue
        first = E = int(L[chunks[0]])
        ends = []
        for c in chunks:
            end = max(E, int(Hx[c]))
            if end > E:
                table[c, :2] = (max(E, end - ring), end)
            E = end
            ends.append(E)
        for k, c in enumerate(chunks):
            nxt = ends[k + 1] if k + 1 < len(chunks) else ends[k]
            table[c, 2] = not (L[c] >= first and L[c] >= nxt - ring)
    return table.astype(np.int32)


def resident_ctas(index: int, ring: int, stage_a: bool = False, a_cap: int = 0,
                  chunk_rows: int = CHUNK_ROWS) -> int:
    """CTAs of ``spmv_staged`` the card holds at once: by threads and by
    shared memory (the ring, with stage_a the two slice buffers, and 1 KB
    the runtime keeps per CTA)."""
    p = torch.cuda.get_device_properties(index)
    per_sm = min(p.max_threads_per_multi_processor // THREADS,
                 SMEM_PER_SM // staged_smem(ring, stage_a, a_cap, chunk_rows))
    return p.multi_processor_count * max(per_sm, 1)


def staged_smem(ring: int, stage_a: bool, a_cap: int, chunk_rows: int) -> int:
    """Shared-memory bytes of a CTA (``launch_staged``), 1 KB of the runtime's included."""
    return 1024 + 128 + 4 * ring + (8 * (2 * a_cap + 4 * (chunk_rows + 4)) if stage_a else 0)


def staged_plan(H: sp.csr_matrix, dev, chunk_rows: int = CHUNK_ROWS, ring: int = RING,
                grid: int | None = None, stage_a: bool | None = None) -> StagedPlan:
    """The chunks, CTA ranges and ring copies of the host CSR ``H``; grid:
    the CTAs (by default the card's resident count, DEFAULT_GRID off the
    card); stage_a: by default whether H's values and indices exceed
    L2_BYTES."""
    if ring < 4 or ring & (ring - 1) or chunk_rows <= 0:
        raise ValueError("ring must be a power of two of at least 4, chunk_rows positive")
    if stage_a is None:
        stage_a = staged_plan_default_a(H)
    n = H.shape[0]
    lo, hi = chunk_windows(H, chunk_rows)
    starts = np.arange(0, n, chunk_rows)
    ends = np.minimum(starts + chunk_rows, n)
    p0, p1 = H.indptr[starts], H.indptr[ends]
    a_cap = int(((((p1 + 3) & ~3) - (p0 & ~3)).max(initial=0) + 3) & ~3)
    if grid is None:
        dev = torch.device(dev)
        grid = (resident_ctas(dev.index or 0, ring, stage_a, a_cap, chunk_rows)
                if dev.type == "cuda" else DEFAULT_GRID)
    cta_ptr = cta_ranges(p1 - p0, grid)
    table = ring_table(lo, hi, cta_ptr, ring)
    count = np.where(hi >= lo, ((hi + 4) & ~3) - (lo & ~3), 0)
    return StagedPlan(
        chunk_rows=chunk_rows, ring=ring, stage_a=stage_a,
        win_lo=torch.as_tensor(lo.astype(np.int32), device=dev),
        win_hi=torch.as_tensor(hi.astype(np.int32), device=dev),
        table=torch.as_tensor(table, device=dev),
        cta_ptr=torch.as_tensor(cta_ptr.astype(np.int32), device=dev), a_cap=a_cap,
        wide=int(table[:, 2].sum()),
        copy_bytes=int(4 * (table[:, 1] - table[:, 0]).astype(np.int64).sum()),
        window_floats={"mean": float(count.mean()), "max": int(count.max())})


def staged_plan_default_a(H: sp.csr_matrix) -> bool:
    """``staged_plan``'s default stage_a for ``H``."""
    return 8 * H.nnz > L2_BYTES


def spmv_staged_plain(A: CSRMatrix, plan: StagedPlan, x, u, b, s, escale=1.0):
    """Plain PyTorch version of ``spmv_staged``: K1's plain version (the
    ring changes where x is read from, not the result)."""
    spmv_staged_plain.calls += 1
    return fused_spmv_plain(A, x, "axpby", b=b, u=u, s=s, escale=escale)


spmv_staged_plain.calls = 0


def spmv_staged(A: CSRMatrix, plan: StagedPlan, x, u, b, s, escale=1.0) -> torch.Tensor:
    """y = u + (b - A x) (s escale) with x in a shared-memory ring (f32,
    one column). A CUDA tensor goes to the kernel, the plan's persistent
    CTAs over its chunk ranges, K1's lanes a row (``launch_lanes`` of
    min(A.lanes, 8)) (each launch adds one to ``spmv_staged.launches``),
    a CPU tensor to the plain version."""
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
    for t in (A.indptr, A.indices, plan.table, plan.cta_ptr):
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != x.device:
            raise TypeError(f"the operator's and the plan's indices must be contiguous int32 "
                            f"on {x.device}")
    if tuple(plan.table.shape) != (plan.n_chunks, 4) or plan.chunk_rows % 4:
        raise ValueError("the plan's table must be [n_chunks, 4], chunk_rows a multiple of 4")
    aligned = (x, plan.table) + ((A.indptr, A.indices, A.data, u, b, s) if plan.stage_a else ())
    if any(t.data_ptr() % 16 for t in aligned):
        raise ValueError("x, the table (and with stage_a the operator, u, b, s) must be "
                         "16-byte aligned: bulk copies move 16-byte units")
    lib = load_library()
    y = torch.empty_like(u)
    if n == 0:
        return y
    with torch.cuda.device(x.device):
        err = lib.smg_spmv_staged_f32(
            A.indptr.data_ptr(), A.indices.data_ptr(), A.data.data_ptr(), x.data_ptr(),
            y.data_ptr(), u.data_ptr(), b.data_ptr(), s.data_ptr(), float(escale),
            plan.table.data_ptr(), plan.cta_ptr.data_ptr(), n, A.n_cols,
            int(A.indices.shape[0]), plan.chunk_rows, plan.ring, plan.a_cap,
            launch_lanes(min(A.lanes, MAX_LANES), n, card_threads(x.device.index or 0)),
            int(plan.stage_a), plan.grid,
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
    """The operator of the host CSR ``H`` on ``dev``, its plans (the
    default one, and the same with the operator's slices streamed where
    the default stages them, or the other way round), the sweep's inputs
    and the cuSPARSE operator."""
    return {"H": H, "label": label, "A": csr_from_scipy(H, dev, torch.float32),
            "plan": staged_plan(H, dev),
            "plan_a": staged_plan(H, dev, stage_a=not staged_plan_default_a(H)),
            "v": jacobi_inputs(H, dev, seed), "library": library_csr(H, dev)}


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
    """A plan of the prepared operator whose ring holds at most half its
    widest chunk's window (the largest power of two there, at most RING),
    so that at least that chunk takes the wide branch (x from global
    memory)."""
    half = max(4, p["plan"].window_floats["max"] // 2)
    ring = min(RING, 1 << (half.bit_length() - 1))
    return staged_plan(p["H"], p["A"].data.device, ring=ring)


def check(p: dict) -> dict:
    """``spmv_staged`` against its plain version at ``TOL`` x max|y|, on
    the prepared plans (the operator's slices streamed and staged) and on
    ``narrow_plan`` (which must have wide chunks); raises on a
    disagreement."""
    out = {}
    plans = (("plan", p["plan"]), ("plan_a", p["plan_a"]), ("narrow", narrow_plan(p)))
    for name, plan in plans:
        if name == "narrow" and plan.wide == 0:
            raise RuntimeError(f"the narrow plan of {p['label']} has no wide chunk")
        fns = calls(p, plan)
        y, yp = fns["staged"](), fns["plain"]()
        err, scale = float((y - yp).abs().max()), float(yp.abs().max())
        if not err <= TOL * scale:
            raise RuntimeError(f"spmv_staged on {p['label']} (ring {plan.ring}, stage_a "
                               f"{plan.stage_a}, {plan.wide} wide chunks) is {err:.3e} from its "
                               f"plain version (limit {TOL * scale:.3e})")
        out[name] = {"ring": plan.ring, "stage_a": plan.stage_a, "chunks": plan.n_chunks,
                     "grid": plan.grid, "wide_chunks": plan.wide, "max_abs_err": err,
                     "max_abs_y": scale}
    return {"max_abs_err": max(r["max_abs_err"] for r in out.values()), "tol": TOL, **out}


def measure(p: dict, dev: torch.device) -> dict:
    """``spmv_staged`` in turns with K1 and cuSPARSE (K1, staged, staged
    with the other A route, cuSPARSE, cuSPARSE, the other route, staged,
    K1, then the plain version; back-to-back calls: L2 warm where the
    call's bytes fit in the 50 MB L2), beside K1's byte bound and the
    bytes the ring's copies bring."""
    H, plan = p["H"], p["plan"]
    fns = calls(p)
    fns["staged_a"] = calls(p, p["plan_a"])["staged"]
    nbytes, flops = spmv_bytes(H, 1, "axpby")
    bound, by = C.bound_ms(nbytes, flops)
    rec = {"operator": p["label"], "rows": int(H.shape[0]), "nnz": int(H.nnz),
           "l2": "warm" if nbytes < 50e6 else "exceeds the 50 MB L2",
           "chunk_rows": plan.chunk_rows, "ring": plan.ring, "stage_a": plan.stage_a,
           "chunks": plan.n_chunks, "grid": plan.grid, "grid_a": p["plan_a"].grid,
           "wide_chunks": plan.wide, "window_floats": plan.window_floats,
           "copy_bytes": plan.copy_bytes, "bytes": int(nbytes), "bound_ms": bound,
           "bound_by": by}
    t = C.timed(fns, ("k1", "staged", "staged_a", "library", "library", "staged_a", "staged",
                      "k1", "plain"),
                {"k1": K1_KERNEL, "staged": "spmv_staged_kernel",
                 "staged_a": "spmv_staged_kernel"}, dev, p["label"])
    rec["turns_ms"] = {k: t[k]["turns_ms"] for k in ("k1", "staged", "staged_a", "library")}
    rec["ms"], rec["staged_a_ms"], rec["k1_ms"], rec["library_ms"], rec["plain_ms"] = (
        t[k]["ms"] for k in ("staged", "staged_a", "k1", "library", "plain"))
    rec["call_ms"], rec["plain_call_ms"] = t["staged"]["call_ms"], t["plain"]["call_ms"]
    rec["bound_share"], rec["staged_a_bound_share"], rec["k1_bound_share"] = (
        C.share(bound, rec[k]) for k in ("ms", "staged_a_ms", "k1_ms"))
    return rec


def main(argv=None) -> int:
    return C.operator_main("staged_spmv", __doc__, argv, ORDERS, "ico{k} A_0 axpby", prepare,
                           measure, check)


if __name__ == "__main__":
    raise SystemExit(main())
