"""SpMV as a band on tensor cores on the card: can bytes of zeros pay for the tensor cores?

The counterpart of ``benchmarks/probes/probe_mxu_band.py``, which ran the
RCM-ordered operator as dense band x contiguous x window products on the
MXU (its record, TPU v5e: 21-33 times slower than the windowed kernel at
3 columns). The layout (``band_layout``, the probe's ``:52-81``): row blocks
of ``BAND_ROWS`` rows; block r's window starts at its least column rounded
down to ``BAND_K``; the band holds entry (i, c) = A[i, start + c] over the
largest span W (rounded up to ``BAND_K``), in bf16 or in f32. The band is
cut into tiles of BAND_ROWS x BAND_K, and two tile lists name the tiles to
multiply: "dense" every tile (the TPU probe's question as it was asked),
"skip" only the tiles that hold a nonzero (a CSR per row block:
``tile_ptr``, ``tile_k``). Each list's tiles lie tile-major on the card in
wgmma's core-matrix order (``pack_tiles``). ``band_spmv_tc``
(``csrc/spmv_probe.cu``) computes Y = A X for X [n, nc] (nc <= 128) from a
list: a cast pass writes X once as bf16 (or TF32 for the f32 band) tiles,
and the product runs ``wgmma`` from a ring of shared-memory stages filled
by bulk copies, f32 accumulation.

The probe runs it at nc = 128 (the TPU probe's best case) and nc = 3 (the
workload's), for both band types and both lists, on the finest operator of
``bench.ico_operators``; an operator whose bf16 band and lists exceed
``MAX_BAND_BYTES`` is skipped (the TPU probe's rule, ``:72-74``) and says
so. Beside it: K2 at C = 3, K1 three times (a column each) and cuSPARSE
(``torch.sparse_csr_tensor @ X``, the library time) on the same operator,
in turns. The kernel is held to its plain version, ``band_spmv_tc_plain``
(the dense band product with ``torch.matmul``, TF32 off on bf16-rounded x
for the bf16 band, TF32 on for the f32 band), within ``band_tolerance`` of
|A| |X|. Its bound is the function's (the CSR operator, the X rows it
gathers and Y: ``utils.bounds.spmv_bytes``); the zeros the layout moves
are its cost, reported as ``band_bound_ms`` (the dense band) and
``tile_bound_ms`` (a list's tiles).

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
BAND_ROWS = 128  # csrc/spmv_probe.cu kBandRows: two warpgroups of 64 rows
BAND_K = 32  # kBandK: window columns of a tile; the starts are multiples of it
MAX_NC = 128
NCS = (128, 3)
BAND_TYPES = (torch.bfloat16, torch.float32)
TILE_LISTS = ("skip", "dense")
MAX_BAND_BYTES = 6e9
F32_U = 2.0**-24
KERNEL = "band_spmv_tc_kernel"  # the profiler's names of a call's two launches
CAST = "band_x_cast_kernel"


@dataclass
class TileList:
    """The window tiles ``band_spmv_tc`` multiplies: block r's are
    ``tile_k[tile_ptr[r] : tile_ptr[r + 1]]`` (window tile j covers the
    columns start[r] + BAND_K j ..), and ``tiles`` holds them in that
    order, [n_tiles, BAND_ROWS x BAND_K], each in wgmma's core-matrix
    order (``pack_tiles``)."""

    tile_ptr: torch.Tensor
    tile_k: torch.Tensor
    tiles: torch.Tensor

    @property
    def n_tiles(self) -> int:
        return self.tile_k.shape[0]

    @property
    def nbytes(self) -> int:
        return self.tiles.numel() * self.tiles.element_size()


@dataclass
class BandLayout:
    """A [n_rows, n_cols] operator as row blocks of BAND_ROWS rows, block r
    holding A[rows of r, start[r] : start[r] + W] densely in ``band``
    ([blocks x BAND_ROWS, W], bf16 or f32; the plain version's input), and
    its tile lists ("dense": every tile of W, "skip": those that hold a
    nonzero) for the kernel."""

    n_rows: int
    n_cols: int
    W: int
    start: torch.Tensor
    band: torch.Tensor
    max_row: int
    x_rows: int  # max(start) + W: the rows of X the windows reach
    lists: dict

    @property
    def blocks(self) -> int:
        return self.start.shape[0]

    @property
    def x_tiles(self) -> int:
        return self.x_rows // BAND_K

    @property
    def nbytes(self) -> int:
        """Bytes the layout keeps on its device: the band and every list."""
        return (self.band.numel() * self.band.element_size()
                + sum(t.nbytes for t in self.lists.values()))


def band_shape(H: sp.csr_matrix) -> tuple:
    """(start [blocks] int64, W) of the host CSR ``H``: each block's least
    column rounded down to BAND_K, and the largest span from there,
    rounded up to BAND_K."""
    n = H.shape[0]
    starts = np.arange(0, n, BAND_ROWS)
    ends = np.minimum(starts + BAND_ROWS, n)
    nnz = H.indptr[ends] - H.indptr[starts]
    lo = np.zeros(starts.size, np.int64)
    hi = np.zeros(starts.size, np.int64)
    full = nnz > 0
    if full.any():
        offs = H.indptr[starts[full]]
        lo[full] = np.minimum.reduceat(H.indices, offs) // BAND_K * BAND_K
        hi[full] = np.maximum.reduceat(H.indices, offs)
    span = int((hi - lo + 1).max())
    return lo, -(-span // BAND_K) * BAND_K


def nonempty_tiles(H: sp.csr_matrix, start: np.ndarray, W: int) -> np.ndarray:
    """Sorted ids r (W / BAND_K) + j of the window tiles of ``H`` that hold
    a nonzero value."""
    rows = np.repeat(np.arange(H.shape[0]), np.diff(H.indptr))
    keep = H.data != 0
    r = rows[keep] // BAND_ROWS
    return np.unique(r * (W // BAND_K) + (H.indices[keep] - start[r]) // BAND_K)


def core_k(dtype) -> int:
    """Columns of a core matrix of wgmma (16 bytes): 8 bf16, 4 f32."""
    return 16 // torch.empty((), dtype=dtype).element_size()


def pack_tiles(band: torch.Tensor, W: int) -> torch.Tensor:
    """Every tile of ``band`` ([blocks x BAND_ROWS, W]), block-major then by
    window tile, [blocks x W / BAND_K, BAND_ROWS x BAND_K], each in the
    order [k group][row group][8 rows][KC columns] (KC = ``core_k``): 8 x
    16-byte core matrices, K-major, as wgmma reads them without swizzle."""
    kc = core_k(band.dtype)
    t = band.view(-1, BAND_ROWS // 8, 8, W // BAND_K, BAND_K // kc, kc)
    return t.permute(0, 3, 4, 1, 2, 5).reshape(-1, BAND_ROWS * BAND_K)


def unpack_tiles(tiles: torch.Tensor, W: int) -> torch.Tensor:
    """The band of every tile (``pack_tiles``' inverse)."""
    kc = core_k(tiles.dtype)
    t = tiles.view(-1, W // BAND_K, BAND_K // kc, BAND_ROWS // 8, 8, kc)
    return t.permute(0, 3, 4, 1, 2, 5).reshape(-1, W)


def tile_list(ids: np.ndarray, blocks: int, W: int, all_tiles: torch.Tensor) -> TileList:
    """The list of the tile ids ``ids`` (sorted), their tiles taken from
    ``all_tiles`` (``pack_tiles``)."""
    nw = W // BAND_K
    dev = all_tiles.device
    ptr = np.zeros(blocks + 1, np.int64)
    ptr[1:] = np.cumsum(np.bincount(ids // nw, minlength=blocks))
    tiles = all_tiles if ids.size == blocks * nw else all_tiles[torch.as_tensor(ids, device=dev)]
    return TileList(torch.as_tensor(ptr.astype(np.int32), device=dev),
                    torch.as_tensor((ids % nw).astype(np.int32), device=dev),
                    tiles.contiguous())


def layout_bytes(H: sp.csr_matrix, itemsize: int) -> int:
    """Bytes of ``band_layout`` of ``H`` with values of ``itemsize`` bytes:
    the band, its dense list (as many) and its skip list."""
    start, W = band_shape(H)
    tile = BAND_ROWS * BAND_K * itemsize
    return (2 * start.size * (W // BAND_K) + nonempty_tiles(H, start, W).size) * tile


def band_layout(H: sp.csr_matrix, dev, dtype) -> BandLayout:
    """The band of the host CSR ``H`` on ``dev`` (values rounded to dtype
    from f32, as the f32 operator holds them) and its two tile lists."""
    H = sp.csr_matrix(H)
    H.sum_duplicates()
    start, W = band_shape(H)
    rows = np.repeat(np.arange(H.shape[0]), np.diff(H.indptr))
    loc = H.indices - start[rows // BAND_ROWS]
    band = torch.zeros((start.size * BAND_ROWS, W), dtype=dtype, device=dev)
    band[torch.as_tensor(rows, device=dev), torch.as_tensor(loc, device=dev)] = torch.as_tensor(
        H.data.astype(np.float32), device=dev).to(dtype)
    all_tiles = pack_tiles(band, W)
    nw = W // BAND_K
    lists = {"dense": tile_list(np.arange(start.size * nw), start.size, W, all_tiles),
             "skip": tile_list(nonempty_tiles(H, start, W), start.size, W, all_tiles)}
    return BandLayout(H.shape[0], H.shape[1], W,
                      torch.as_tensor(start.astype(np.int32), device=dev), band,
                      int(np.diff(H.indptr).max()), int(start.max()) + W, lists)


def band_n(nc: int) -> int:
    """The kernel's N: nc rounded up to a power of two, at least 8."""
    return max(8, 1 << (nc - 1).bit_length())


def windows(L: BandLayout, X: torch.Tensor) -> torch.Tensor:
    """X's window of every block, [blocks, W, nc] (zero past X's last row)."""
    idx = L.start.long()[:, None] + torch.arange(L.W, device=X.device)
    pad = L.x_rows - X.shape[0]
    Xp = torch.cat([X, X.new_zeros((pad, X.shape[1]))]) if pad > 0 else X
    return Xp[idx]


def band_spmv_tc_plain(L: BandLayout, X: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``band_spmv_tc``: the band times each
    block's window with torch.matmul; for the bf16 band X rounded to bf16
    and the products in f32 with TF32 off, for the f32 band TF32 on. The
    tiles a list leaves out are zero, so every list gives this."""
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


def band_spmv_tc(L: BandLayout, X: torch.Tensor, tiles: str = "skip") -> torch.Tensor:
    """Y [n_rows, nc] = A X through the band's tile list ``tiles`` ("skip"
    or "dense") on tensor cores (bf16 or TF32 by the band's type), X
    [n_cols, nc] f32, nc <= 128. A CUDA tensor goes to the kernel (each
    call, a cast pass of X and the product, adds one to
    ``band_spmv_tc.launches``), a CPU tensor to the plain version."""
    if L.band.dtype not in BAND_TYPES:
        raise TypeError(f"the band must be bfloat16 or float32, not {L.band.dtype}")
    if (L.band.ndim != 2 or L.band.shape[0] != L.blocks * BAND_ROWS or L.band.shape[1] != L.W
            or L.W % BAND_K or L.blocks != -(-L.n_rows // BAND_ROWS)):
        raise ValueError(f"band of shape {tuple(L.band.shape)} for {L.n_rows} rows in "
                         f"{L.blocks} blocks and W = {L.W}")
    if tiles not in L.lists:
        raise ValueError(f"no tile list {tiles!r}: {sorted(L.lists)}")
    if X.ndim != 2 or X.shape[0] != L.n_cols or not 1 <= X.shape[1] <= MAX_NC:
        raise ValueError(f"X must be [{L.n_cols}, nc] with nc <= {MAX_NC}, not {tuple(X.shape)}")
    if X.dtype != torch.float32 or X.device != L.band.device:
        raise TypeError(f"X is {X.dtype} on {X.device}; float32 on {L.band.device} expected")
    if X.device.type == "cpu":
        return band_spmv_tc_plain(L, X)
    if X.device.type != "cuda":
        raise TypeError(f"band_spmv_tc runs on CUDA or CPU tensors, not {X.device}")
    T = L.lists[tiles]
    if T.tiles.dtype != L.band.dtype or tuple(T.tiles.shape) != (T.n_tiles, BAND_ROWS * BAND_K):
        raise ValueError(f"the {tiles} tiles are {T.tiles.dtype} {tuple(T.tiles.shape)}")
    if T.tile_ptr.shape[0] != L.blocks + 1:
        raise ValueError(f"tile_ptr has {T.tile_ptr.shape[0]} entries for {L.blocks} blocks")
    for name, t in (("tile_ptr", T.tile_ptr), ("tile_k", T.tile_k), ("start", L.start)):
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != X.device:
            raise TypeError(f"{name} must be contiguous int32 on {X.device}")
    if not (X.is_contiguous() and T.tiles.is_contiguous()) or T.tiles.data_ptr() % 16:
        raise ValueError("X and the tiles must be contiguous, the tiles 16-byte aligned")
    lib = load_library()
    Y = torch.empty((L.n_rows, X.shape[1]), dtype=torch.float32, device=X.device)
    if L.n_rows == 0:
        return Y
    xt = torch.empty(L.x_tiles * BAND_K * band_n(X.shape[1]), dtype=L.band.dtype,
                     device=X.device)
    with torch.cuda.device(X.device):
        err = lib.smg_band_spmv_tc(T.tiles.data_ptr(), T.tile_ptr.data_ptr(),
                                   T.tile_k.data_ptr(), L.start.data_ptr(), X.data_ptr(),
                                   xt.data_ptr(), Y.data_ptr(), L.n_rows, L.blocks, L.x_tiles,
                                   X.shape[0], X.shape[1], int(L.band.dtype == torch.bfloat16),
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
    - TF32: the kernel rounds x to nearest (cvt.rna) and the tensor cores
      read the stored f32 values as TF32 (at most 2^-10 relative either
      way); cuBLAS's TF32 may truncate; so each side's products are within
      2 x 2^-10 of the f32 products: 4 x 2^-10 between them, plus the
      sums' roundoffs.
    """
    acc = 2 * (L.max_row + 1) * F32_U
    return acc if L.band.dtype == torch.bfloat16 else 4 * 2.0**-10 + acc


def prepare(H: sp.csr_matrix, dev: torch.device, label: str, seed: int = 0) -> dict:
    """The band layouts of the host CSR ``H`` (both types, each with its
    dense and skip lists) on ``dev``, unless the bf16 layout exceeds
    MAX_BAND_BYTES; X [n, 128] from ``seed``; the operator for K1/K2 and
    for cuSPARSE."""
    start, W = band_shape(H)
    p = {"H": H, "label": label, "W": W, "blocks": int(start.size)}
    size = layout_bytes(H, 2)
    if size > MAX_BAND_BYTES:
        p["skipped"] = (f"the bf16 band and its tile lists take {size / 1e9:.2f} GB, over "
                        f"{MAX_BAND_BYTES / 1e9:g}")
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
    """The kernel against its plain version for both band types, both tile
    lists and every nc, within ``band_tolerance`` of |A| |X| entry by
    entry; raises on a disagreement."""
    if "skipped" in p:
        return {"skipped": p["skipped"]}
    out = {}
    for dtype, L in p["bands"].items():
        for nc, X in p["X"].items():
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
            for tiles in TILE_LISTS:
                Y = band_spmv_tc(L, X, tiles)
                diff = (Y - Yp).abs()
                worst = float((diff / mag.clamp_min(1e-30)).max())
                name = f"{str(dtype)[6:]} nc={nc} {tiles}"
                if not bool((diff <= tol * mag).all()):
                    raise RuntimeError(f"band_spmv_tc ({name}) on {p['label']} is {worst:.3e} of "
                                       f"|A||X| from its plain version (limit {tol:.3e})")
                out[name] = {"max_abs_err": float(diff.max()),
                             "worst_rel_to_abs_product": worst, "tol": tol}
    return out


def timed_band(fns: dict, order, kernels: dict, dev: torch.device, label: str) -> dict:
    """``probes._common.timed`` with the band's calls ("skip", "dense"):
    each a cast pass and the product, timed by the profiler's mean of each
    of the two launches (``cast_ms``, ``product_ms``; ``ms`` their sum),
    beside the back-to-back event time of the calls (``burst_ms``), in the
    same turns as the others."""
    from surface_multigrid_code_torch.utils import timing

    band = [k for k in fns if k in TILE_LISTS]
    if dev.type != "cuda":
        return {w: dict.fromkeys(("ms", "turns_ms", "call_ms", "cast_ms", "product_ms"))
                for w in fns}
    others = {k: v for k, v in fns.items() if k not in band}
    out = {}

    def measure(w):
        if w in band:
            parts = {k: timing.device_ms(fns[w], C.REPS, k)["ms"] for k in (CAST, KERNEL)}
            return {"ms": sum(parts.values()), "cast_ms": parts[CAST],
                    "product_ms": parts[KERNEL], "burst_ms": timing.burst_ms(fns[w], C.REPS),
                    "call_ms": timing.cuda_ms(fns[w], C.REPS)}
        t = C.timed({w: others[w]}, [w], {w: kernels[w]} if w in kernels else {}, dev, label)
        return {"ms": t[w]["ms"], "call_ms": t[w]["call_ms"]}

    turns = timing.in_turns({w: w for w in fns}, order, measure)
    for w, recs in turns.items():
        out[w] = {"turns_ms": [r["ms"] for r in recs],
                  **{k: C.median([r[k] for r in recs]) for k in recs[0]}}
    return out


def measure(p: dict, dev: torch.device) -> dict:
    """The band kernel for both band types at nc = 128 and 3 on both tile
    lists, timed in turns beside cuSPARSE (skip, dense, cuSPARSE,
    cuSPARSE, dense, skip), and at nc = 3 beside K2 (C = 3) and K1 three
    times, then the plain version (back-to-back calls: L2 warm where the
    inputs fit). ``bound_ms`` is the function's, Y = A X: the operator's
    CSR (values in the band's type), the X rows it gathers and Y
    (``spmv_bytes``), 2 nnz nc operations at the tensor cores' peak;
    ``band_bound_ms`` the dense band's: the band, X and Y, 2 rows W nc
    operations; ``tile_bound_ms`` (per list) the listed tiles, X and Y
    once, 2 (listed tiles) 128 x 32 nc operations, beside
    ``x_tile_bytes``, the X tiles (written by the cast pass, N columns of
    the band's type) the list reads through the L2. A band time is the
    cast pass's and the product's (``timed_band``). A skipped operator
    says why."""
    H = p["H"]
    rec = {"operator": p["label"], "rows": int(H.shape[0]), "nnz": int(H.nnz), "W": p["W"],
           "blocks": p["blocks"], "band_rows": BAND_ROWS, "band_k": BAND_K}
    if "skipped" in p:
        return {**rec, "skipped": p["skipped"]}
    S, cols = p["S"], p["cols"]
    L0 = next(iter(p["bands"].values()))
    rec["tiles"] = {name: T.n_tiles for name, T in L0.lists.items()}
    rec["cases"] = []
    for dtype, L in p["bands"].items():
        peak = C.BF16_FLOPS_PER_S if dtype == torch.bfloat16 else C.TF32_FLOPS_PER_S
        item = L.band.element_size()
        for nc, X in p["X"].items():
            case = {"band": str(dtype)[6:], "nc": nc, "N": band_n(nc),
                    "band_bytes": L.band.numel() * item, "layout_bytes": L.nbytes}
            nbytes, flops = spmv_bytes(H, nc, None, value_itemsize=item)
            case["bytes"] = int(nbytes)
            case["bound_ms"], case["bound_by"] = C.bound_ms(nbytes, flops, peak=peak)
            case["band_bound_ms"], case["band_bound_by"] = C.bound_ms(
                case["band_bytes"] + 4 * nc * (H.shape[1] + H.shape[0]),
                2 * L.band.shape[0] * L.W * nc, peak=peak)
            tile = BAND_ROWS * BAND_K * item
            for name, T in L.lists.items():
                tb = T.n_tiles * tile + 4 * nc * (H.shape[1] + H.shape[0])
                case[f"{name}_tile_bytes"] = T.n_tiles * tile
                case[f"{name}_x_tile_bytes"] = T.n_tiles * BAND_K * band_n(nc) * item
                case[f"{name}_tile_bound_ms"], case[f"{name}_tile_bound_by"] = C.bound_ms(
                    tb, 2 * T.n_tiles * BAND_ROWS * BAND_K * nc, peak=peak)
            fns = {"skip": lambda: band_spmv_tc(L, X, "skip"),
                   "dense": lambda: band_spmv_tc(L, X, "dense"),
                   "library": lambda: p["library"] @ X}
            order = ["skip", "dense", "library", "library", "dense", "skip"]
            if nc == 3:
                fns.update(k2_c3=lambda: fused_spmv(S, X),
                           k1_x3=lambda: [fused_spmv(S, c) for c in cols])
                order = ["skip", "dense", "k2_c3", "k1_x3", "library", "library", "k1_x3",
                         "k2_c3", "dense", "skip"]
            what = f"{p['label']} {case['band']} nc={nc}"
            plain = C.timed({"plain": lambda: band_spmv_tc_plain(L, X)}, ["plain"], {}, dev,
                            what)["plain"]
            t = timed_band(fns, order, {"k2_c3": K1_KERNEL}, dev, what)
            case["turns_ms"] = {k: t[k]["turns_ms"] for k in fns}
            for k in fns:
                case["ms" if k == "skip" else f"{k}_ms"] = t[k]["ms"]
                case["call_ms" if k == "skip" else f"{k}_call_ms"] = t[k]["call_ms"]
            for k in TILE_LISTS:
                case[f"{k}_cast_ms"] = t[k]["cast_ms"]
                case[f"{k}_product_ms"] = t[k]["product_ms"]
            case["plain_ms"], case["plain_call_ms"] = plain["ms"], plain["call_ms"]
            case["bound_share"] = C.share(case["bound_ms"], case["ms"])
            case["dense_bound_share"] = C.share(case["bound_ms"], case["dense_ms"])
            case["band_bound_share"] = C.share(case["band_bound_ms"], case["dense_ms"])
            for name in TILE_LISTS:
                case[f"{name}_tile_bound_share"] = C.share(
                    case[f"{name}_tile_bound_ms"], case["ms" if name == "skip" else "dense_ms"])
            rec["cases"].append(case)
    return rec


def main(argv=None) -> int:
    return C.operator_main("band_spmv", __doc__, argv, ORDERS, "ico{k} A_0", prepare, measure,
                           check)


if __name__ == "__main__":
    raise SystemExit(main())
