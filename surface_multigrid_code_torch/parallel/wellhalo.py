"""Band-segment halo multigrid over torch.distributed (ports ``surface_multigrid_code_tpu/parallel/wellhalo.py``).

The JAX package's default multi-device backend: rows keep the GLOBAL
induced-RCM ordering (``solver/ordering.py``: RCM on the finest level,
each coarser level in the order its prolongation induces), so every
operator family stays banded, and a level's halo is exchanged as two
CONTIGUOUS BAND SEGMENTS (``Comm.shift``):

    [last lo rows of rank d-1; this rank's rows; first hi rows of rank d+1]

a contiguous global slice [d*R - lo, (d+1)*R + hi) of the level's vector,
over which this rank's operators hold their columns.

Carried over from the JAX module:

- blocks: every level cut into D equal contiguous blocks of
  R_l = ceil(n_l / D) rows; pad rows hold no entries, a zero right-hand
  side and diagonal 1, and stay zero;
- extents (``_col_extents``, ``wellhalo.py:83-96``): a level's vector is
  read by its A, by P_{l-1} (the finer level's rows) and by Pᵀ_l; (lo, hi)
  is how far below and above its own block any rank's rows of those reach;
- the mode rule (``wellhalo.py:196-218``): band segments when lo and hi
  (Pᵀ included) are at most R; otherwise, when only Pᵀ does not fit, the
  segments serve A and P and the restriction is column-partitioned (each
  rank holds Pᵀ[:, its block], its partial product is summed by
  ``allreduce_sum``); otherwise the level is replicated (``gather_rows``)
  and its readers keep global columns;
- each rank's operators as CSR over its window (``_stack_blocks`` and
  ``_stack_colblocks``, ``wellhalo.py:99-129``);
- the coarsest level: the host's dense pseudo-inverse (identity on the
  pad), each rank holding its rows;
- the V-cycle of ``_shard_body`` (``wellhalo.py:301-413``), shared with
  ``parallel/halo.py`` (``RowPartitioned``): one launch of K1 per SpMV
  for one column, of K2 for C columns, with the fused epilogues;
- multicolor Gauss-Seidel raises (``wellhalo.py:172-177``).

Not carried over: the windowed-ELL layouts, the B_ROWS (1024-row)
alignment of blocks and extents and the cap on slot groups. They are
TPU layout rules; here every operator is CSR.

The refresh (``enable_refresh`` / ``refresh`` / ``solve_values``, the
slot-space value chain of ``wellhalo.py:458-760``): a level's values live
in its canonical CSR nnz order (in the permuted ordering), where rank d's
rows own one contiguous range. The ranges differ in size; they are not
padded to the largest, every rank computes every rank's range on the
host alike. G_{l+1} (``solver/galerkin.galerkin_triples``: G[seg, in_id]
+= w) maps level l's nnz to level l+1's; each rank holds its rows of it
over its window of level l's nnz, exchanged by ``shift`` with extents
maxed over the ranks, or gathered whole where a segment would exceed the
smallest rank's range. Per refresh, on each rank:

- its slice of the finest values, taken from ``A0_vals`` directly (the
  JAX fill operator and its exchange, ``wellhalo.py:558-565``, exist only
  because the JAX input is an evenly sharded array);
- vals_{l+1} = G_{l+1} · exchange(vals_l), a K1 launch per level; its A
  data and diagonal are its own slice;
- the Chebyshev bound of D⁻¹A by a sharded power iteration (12 steps from
  the uniform start, an exchange and an ``allreduce_sum`` each, times
  1.1; ``wellhalo.py:644-673``);
- the coarsest matrix: each rank scatters its own nnz into a dense
  nL × nL, ``allreduce_sum``, the diagonal shift 1e-12, a Cholesky factor
  (``wellhalo.py:674-687``).

No rank computes or keeps another rank's rows of any level's values.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from surface_multigrid_code_torch.config import SmootherType, SolveConfig
from surface_multigrid_code_torch.ops.sparse import CSRMatrix
from surface_multigrid_code_torch.ops.spmv import fused_spmv
from surface_multigrid_code_torch.parallel.comm import Comm, rank_device
from surface_multigrid_code_torch.parallel.halo import (
    RowPartitioned,
    _csr,
    _diag_slots,
    _pad_to,
    _rows_block,
    nnz_order,
)
from surface_multigrid_code_torch.solver.galerkin import galerkin_triples
from surface_multigrid_code_torch.solver.ordering import (
    finest_rcm,
    induced_orderings,
    permute_hierarchy,
)
from surface_multigrid_code_torch.solver.vcycle import _power_iteration_lam_max

# the diagonal shift of the refreshed coarsest factor (wellhalo.py:601)
COARSE_SHIFT = 1e-12


def _col_extents(M: sp.csr_matrix, rows: np.ndarray, cols: np.ndarray) -> tuple[int, int]:
    """(lo, hi) >= 0: how far below ``cols[d]`` and above ``cols[d+1] - 1``
    any rank d's rows [rows[d], rows[d+1]) of the CSR M reach, maxed over
    the ranks (the JAX ``_col_extents`` with the block bounds given)."""
    lo = hi = 0
    for d in range(len(rows) - 1):
        c = M.indices[M.indptr[rows[d]]:M.indptr[rows[d + 1]]]
        if c.size:
            lo = max(lo, int(cols[d]) - int(c.min()))
            hi = max(hi, int(c.max()) - (int(cols[d + 1]) - 1))
    return lo, hi


def _row_bounds(n: int, R: int, D: int) -> np.ndarray:
    """Block bounds of D blocks of R rows over n rows (clipped at n)."""
    return np.minimum(np.arange(D + 1, dtype=np.int64) * R, n)


def _local_csr(M: sp.csr_matrix, r0: int, r1: int, c0: int, n_cols: int, device, dtype):
    """Rows [r0, r1) of M (rows past its end empty) with columns shifted by
    -c0 into [0, n_cols)."""
    indptr, cols, data, _ = _rows_block(M, r0, r1)
    cols = cols - c0
    if cols.size and (cols.min() < 0 or cols.max() >= n_cols):
        raise ValueError("the window does not cover this block's stencil")
    return _csr(indptr, cols, data, n_cols, device, dtype)


def galerkin_maps(A0: sp.csr_matrix, Ps) -> list[tuple[sp.csr_matrix, sp.csr_matrix]]:
    """Per coarser level l+1: (G_{l+1}, its pattern). G_{l+1} [nnz_{l+1},
    nnz_l] maps level l's values (canonical CSR order) to level l+1's, on
    the full symbolic PᵀAP pattern of the chain from A0's pattern."""
    out, A = [], sp.csr_matrix(A0)
    for P in Ps:
        seg, in_id, w, A_out = galerkin_triples(A, sp.csr_matrix(P))
        G = sp.csr_matrix((w, (seg, in_id)), shape=(A_out.nnz, A.nnz))
        G.sum_duplicates()
        out.append((G, A_out))
        A = A_out
    return out


class WellLevel(nn.Module):
    """One rank's part of one level.

    R: rows per rank. lo, hi: the rows of the neighbours this level's
    exchange brings (0, 0 when replicated). rep: replicated (gathered
    whole). A: CSR [R, lo + R + hi] over the window, or [R, R*D] (global
    columns) when replicated; diag, dinv [R]; diag_pos: int64 [R] local
    nnz position of each row's diagonal entry (-1: a pad row).
    P: this level's rows of the prolongation from the next coarser level,
    over that level's window. PT: the restriction, CSR [Rc, window of this
    level], or column-partitioned (``pt_cols``): [Rc*D, R], every coarse
    row, this rank's columns. lam_max: Chebyshev bound (None unless
    Chebyshev smooths).
    """

    def __init__(self, R: int, lo: int, hi: int, rep: bool, A: CSRMatrix, diag: torch.Tensor,
                 diag_pos: torch.Tensor, P: CSRMatrix | None = None,
                 PT: CSRMatrix | None = None, pt_cols: bool = False, lam_max=None):
        super().__init__()
        self.R, self.lo, self.hi, self.rep = int(R), int(lo), int(hi), bool(rep)
        self.A, self.P, self.PT = A, P, PT
        self.register_buffer("diag", diag)
        self.register_buffer("dinv", 1.0 / diag)
        self.register_buffer("diag_pos", diag_pos)
        self.pt_cols = bool(pt_cols)
        self.lam_max = lam_max

    @property
    def mode(self) -> str:
        if self.rep:
            return "replicated"
        return "segments, column-partitioned restriction" if self.pt_cols else "segments"


class WellHaloHierarchy(RowPartitioned):
    """One rank's share of the band-segment halo hierarchy.

    As, Ps: the hierarchy (scipy), the same on every rank; Ps[l] maps level
    l+1 to level l. cfg: Jacobi unless given (the JAX default). group: the
    torch.distributed process group (None: the default); every rank of it
    constructs the object and calls ``solve`` together. device: this
    rank's device, ``cuda`` meaning ``cuda:{rank % device count}``.

    reorder=False keeps the levels in the order given (``galerkin`` orders
    them first); replicate=True gathers every level whole before each SpMV,
    with global columns: the GSPMD layout of ``parallel/spmd.py``, in the
    order given. Chebyshev bounds of ``solve`` come from the host power
    iteration on the levels as given, as ``HaloHierarchy``'s.
    """

    def __init__(self, As, Ps, cfg: SolveConfig | None = None,
                 dtype: torch.dtype = torch.float32, device="cuda", group=None, *,
                 reorder: bool = True, replicate: bool = False):
        self.cfg = cfg or SolveConfig(smoother=SmootherType.JACOBI)
        if self.cfg.smoother == SmootherType.MULTICOLOR_GS:
            raise ValueError(
                "multicolor Gauss-Seidel depends on row order and does not shard "
                "order-free; use SmootherType.JACOBI or SmootherType.CHEBYSHEV")
        self.comm = Comm(group)
        self.device = rank_device(device)
        self.dtype = dtype
        D, rank = self.comm.size, self.comm.rank
        self.D, self.rank = D, rank
        L = len(As)
        self.n0 = As[0].shape[0]
        A0 = sp.csr_matrix(As[0], copy=True)
        A0.sum_duplicates()
        self._A0_orig = A0
        cheb = self.cfg.smoother == SmootherType.CHEBYSHEV
        lams = [_power_iteration_lam_max(sp.csr_matrix(A)) if cheb and lv < L - 1 else None
                for lv, A in enumerate(As)]
        if reorder and not replicate:
            perms = induced_orderings(finest_rcm(A0), Ps)
            As, Ps = permute_hierarchy(As, Ps, perms)
            self.perm0 = perms[0]
        else:
            As = [sp.csr_matrix(A, copy=True) for A in As]
            Ps = [sp.csr_matrix(P, copy=True) for P in Ps]
            self.perm0 = np.arange(self.n0)
        for M in (*As, *Ps):
            M.sum_duplicates()
        self._As, self._Ps = As, Ps
        Rs = [_pad_to(A.shape[0], D) // D for A in As]
        self.Rs = Rs

        # per level: the extents of its readers (A_lv, P_{lv-1}) and of the
        # restriction PT_lv, and the mode they allow (module docstring)
        self.extents, self.pt_extents, modes = [], [], []
        for lv in range(L):
            R = Rs[lv]
            blocks = np.arange(D + 1, dtype=np.int64) * R
            lo, hi = _col_extents(As[lv], _row_bounds(As[lv].shape[0], R, D), blocks)
            if lv > 0:
                P = Ps[lv - 1]
                l2, h2 = _col_extents(P, _row_bounds(P.shape[0], Rs[lv - 1], D), blocks)
                lo, hi = max(lo, l2), max(hi, h2)
            lpt = hpt = 0
            if lv < L - 1:
                PT = Ps[lv].T.tocsr()
                lpt, hpt = _col_extents(PT, _row_bounds(PT.shape[0], Rs[lv + 1], D), blocks)
            self.extents.append((lo, hi))
            self.pt_extents.append((lpt, hpt))
            mlo, mhi = max(lo, lpt), max(hi, hpt)
            if replicate:
                modes.append((0, 0, True, False))
            elif mlo <= R and mhi <= R:
                modes.append((mlo, mhi, False, False))
            elif lo <= R and hi <= R:
                modes.append((lo, hi, False, lv < L - 1))
            else:
                modes.append((0, 0, True, False))

        dev, dt = self.device, dtype
        levels = []
        for lv in range(L):
            A, R = As[lv], Rs[lv]
            lo, hi, rep, ptc = modes[lv]
            c0, nc = self._window(lv, modes)
            n = A.shape[0]
            r0, r1 = min(rank * R, n), min((rank + 1) * R, n)
            real = np.arange(r0, r1)
            ids = _diag_slots(A, real)
            pos = np.full(R, -1, dtype=np.int64)
            pos[:real.size] = np.where(ids >= 0, ids - A.indptr[r0], -1)
            diag = np.ones(R)
            diag[:real.size] = np.where(ids >= 0, A.data[np.maximum(ids, 0)], 0.0)
            levels.append(WellLevel(
                R, lo, hi, rep, _local_csr(A, rank * R, (rank + 1) * R, c0, nc, dev, dt),
                torch.as_tensor(diag).to(dev, dt), torch.as_tensor(pos, device=dev),
                pt_cols=ptc, lam_max=lams[lv]))
        for lv in range(L - 1):
            fine, Rf, Rc = levels[lv], Rs[lv], Rs[lv + 1]
            P, PT = Ps[lv], Ps[lv].T.tocsr()
            c0, nc = self._window(lv + 1, modes)
            fine.P = _local_csr(P, rank * Rf, (rank + 1) * Rf, c0, nc, dev, dt)
            if fine.pt_cols:
                PTc = sp.csr_matrix(PT, copy=True)
                PTc.resize((Rc * D, Rf * D))
                fine.PT = _local_csr(PTc[:, rank * Rf:(rank + 1) * Rf].tocsr(), 0, Rc * D, 0,
                                     Rf, dev, dt)
            else:
                c0, nc = self._window(lv, modes)
                fine.PT = _local_csr(PT, rank * Rc, (rank + 1) * Rc, c0, nc, dev, dt)
        self.levels = levels
        self._coarse_inv = None
        self._refresh = None
        # bytes this rank has sent, per level: exchanges of the level's
        # vector, the coarsest gather, and the partial coarse vectors of a
        # column-partitioned restriction (under the coarse level)
        self.sent_bytes = [0] * L

    def _window(self, lv: int, modes) -> tuple[int, int]:
        """(first global column, width) of this rank's window of level lv."""
        lo, hi, rep, _ = modes[lv]
        R = self.Rs[lv]
        if rep:
            return 0, R * self.D
        return self.rank * R - lo, lo + R + hi

    @classmethod
    def galerkin(cls, A0, Ps, cfg: SolveConfig | None = None,
                 dtype: torch.dtype = torch.float32, device="cuda",
                 group=None) -> "WellHaloHierarchy":
        """The hierarchy of A0's Galerkin chain over Ps on its full symbolic
        PᵀAP pattern, in the induced ordering, refresh enabled: the maps
        G_l are built once, in the partition's order, and serve both the
        stored chain (G_l applied on the host, f64) and ``solve_values``.
        The JAX steppers build the same chain with ``galerkin_chain`` in
        the order given; its values differ only by rounding."""
        A0 = sp.csr_matrix(A0, copy=True)
        A0.sum_duplicates()
        perms = induced_orderings(finest_rcm(A0), Ps)
        (A0p,), Psp = permute_hierarchy([A0], Ps, perms)
        A0p.sum_duplicates()
        maps = galerkin_maps(A0p, Psp)
        As, v = [A0p], A0p.data
        for G, pat in maps:
            v = G @ v
            As.append(sp.csr_matrix((v, pat.indices.copy(), pat.indptr.copy()), shape=pat.shape))
        h = cls(As, Psp, cfg, dtype, device, group, reorder=False)
        h.perm0, h._A0_orig = perms[0], A0
        return h._enable_refresh(maps)

    # ------------------------------------------------------------ exchange
    def _exchange(self, lv: int, x: torch.Tensor) -> torch.Tensor:
        lvl = self.levels[lv]
        self.sent_bytes[lv] += self.exchange_bytes(lv, x.element_size(), x.numel() // x.shape[0])
        if lvl.rep:
            return self.comm.gather_rows(x)
        if not (lvl.lo or lvl.hi):
            return x
        return self.comm.shift(x, lvl.lo, lvl.hi)

    def exchange_bytes(self, lv: int, itemsize: int = 4, C: int = 1) -> int:
        """Bytes this rank sends in one exchange of level lv's vector."""
        lvl = self.levels[lv]
        rows = lvl.R if lvl.rep else ((lvl.lo if self.rank + 1 < self.D else 0)
                                      + (lvl.hi if self.rank > 0 else 0))
        return rows * C * itemsize

    # -------------------------------------------------------------- refresh
    def enable_refresh(self):
        """Build the value chain (module docstring); afterwards
        ``solve_values`` takes finest nnz values in the canonical CSR order
        of the A0 the hierarchy was built from. The stored chain must carry
        the full symbolic PᵀAP pattern (build it with ``solver.galerkin.
        galerkin_chain``, or build the hierarchy with ``galerkin``)."""
        maps = galerkin_maps(self._As[0], self._Ps)
        for lv, (_, pat) in enumerate(maps):
            stored = self._As[lv + 1]
            if pat.nnz != stored.nnz or not (np.array_equal(pat.indptr, stored.indptr)
                                             and np.array_equal(pat.indices, stored.indices)):
                raise ValueError(
                    f"level {lv + 1} pattern mismatch (symbolic {pat.nnz} vs stored "
                    f"{stored.nnz} nnz): build the hierarchy's As with "
                    "solver.galerkin.galerkin_chain")
        return self._enable_refresh(maps)

    def _enable_refresh(self, maps):
        D, rank, dev = self.D, self.rank, self.device
        As = self._As
        # each level's nnz range of every rank
        bounds = [A.indptr[_row_bounds(A.shape[0], R, D)].astype(np.int64)
                  for A, R in zip(As, self.Rs)]
        perm_local = nnz_order(self._A0_orig, As[0], self.perm0)[bounds[0][rank]:
                                                                  bounds[0][rank + 1]]
        chain = []
        for lv, (G, _) in enumerate(maps):
            rb, cb = bounds[lv + 1], bounds[lv]
            counts = np.diff(cb)
            lo, hi = _col_extents(G, rb, cb)
            rep = not (lo <= counts[:-1].min(initial=lo) and hi <= counts[1:].min(initial=hi))
            if rep:
                c0, nc, lo, hi = 0, G.shape[1], 0, 0
            else:
                c0, nc = cb[rank] - lo, lo + counts[rank] + hi
            chain.append({"G": _local_csr(G, rb[rank], rb[rank + 1], c0, nc, dev, self.dtype),
                          "lo": lo, "hi": hi, "rep": rep, "counts": counts.tolist()})
        AL = As[-1]
        sL, eL = bounds[-1][rank], bounds[-1][rank + 1]
        rowsL = np.repeat(np.arange(AL.shape[0], dtype=np.int64), np.diff(AL.indptr))
        self._refresh = {
            "perm_local": perm_local,
            "perm_local_t": torch.as_tensor(perm_local, device=dev),
            "chain": chain,
            "bounds": bounds,
            "rowsL": torch.as_tensor(rowsL[sL:eL], device=dev),
            "colsL": torch.as_tensor(AL.indices[sL:eL].astype(np.int64), device=dev),
        }
        return self

    def _gather_nnz(self, x: torch.Tensor, counts: list[int]) -> torch.Tensor:
        """Every rank's nnz range of a level, concatenated: each padded to
        the largest for the all-gather, the pads dropped after."""
        W = max(counts)
        g = self.comm.gather_rows(torch.cat([x, x.new_zeros(W - x.shape[0])]))
        return torch.cat([g[d * W:d * W + c] for d, c in enumerate(counts)])

    def level_values(self, A0_vals) -> list[torch.Tensor]:
        """This rank's nnz range of every level's values for the finest
        values ``A0_vals`` (original canonical CSR order; numpy or a
        tensor), finest first: its slice of the finest, then a G chain
        launch (K1) per level."""
        if self._refresh is None:
            raise RuntimeError("call enable_refresh() first")
        st = self._refresh
        if isinstance(A0_vals, torch.Tensor):
            v = A0_vals.to(self.device)[st["perm_local_t"]].to(self.dtype)
        else:
            v = torch.as_tensor(np.asarray(A0_vals, dtype=np.float64)[st["perm_local"]])
            v = v.to(self.device, self.dtype)
        out = [v]
        for ch in st["chain"]:
            if ch["rep"]:
                x = self._gather_nnz(v, ch["counts"])
            elif ch["lo"] or ch["hi"]:
                x = self.comm.shift(v, ch["lo"], ch["hi"])
            else:
                x = v
            v = fused_spmv(ch["G"], x)
            out.append(v)
        return out

    def _lam_max(self, lv: int, A: CSRMatrix, diag: torch.Tensor) -> torch.Tensor:
        """lam_max(D^-1 A) of level lv by the sharded power iteration from
        the uniform start, times 1.1 (a 0-d tensor, the same on every rank)."""
        R, n = self.levels[lv].R, self._As[lv].shape[0]
        rows = torch.arange(self.rank * R, (self.rank + 1) * R, device=self.device)
        x = (rows < n).to(self.dtype) / float(np.sqrt(n))
        lam = torch.ones((), dtype=self.dtype, device=self.device)
        for _ in range(self.cfg.lam_power_iters):
            y = fused_spmv(A, self._exchange(lv, x)) / diag
            lam = torch.sqrt(self.comm.allreduce_sum((y * y).sum().reshape(1)))[0]
            x = y / lam
        return 1.1 * lam

    def refresh(self, A0_vals) -> tuple[list[WellLevel], torch.Tensor]:
        """This rank's levels for finest values A0_vals (original CSR
        order), and its rows of the refreshed coarse inverse (module
        docstring)."""
        vals = self.level_values(A0_vals)
        L = len(vals)
        cheb = self.cfg.smoother == SmootherType.CHEBYSHEV
        one = torch.ones((), dtype=self.dtype, device=self.device)
        out = []
        for lv, (lvl, v) in enumerate(zip(self.levels, vals)):
            A = CSRMatrix(lvl.A.indptr, lvl.A.indices, v, lvl.A.n_cols)
            diag = torch.where(lvl.diag_pos >= 0, v[lvl.diag_pos.clamp(min=0)], one)
            lam = self._lam_max(lv, A, diag) if cheb and lv < L - 1 else None
            out.append(WellLevel(lvl.R, lvl.lo, lvl.hi, lvl.rep, A, diag, lvl.diag_pos,
                                 lvl.P, lvl.PT, lvl.pt_cols, lam))
        st = self._refresh
        nL, RL = self._As[-1].shape[0], self.levels[-1].R
        dense = torch.zeros((nL, nL), dtype=self.dtype, device=self.device)
        dense.index_put_((st["rowsL"], st["colsL"]), vals[-1], accumulate=True)
        self.comm.allreduce_sum(dense)
        eye = torch.eye(nL, dtype=self.dtype, device=self.device)
        dense += COARSE_SHIFT * eye
        chol, _ = torch.linalg.cholesky_ex(dense)
        cinv = torch.cholesky_solve(eye, chol)
        rows = torch.zeros((RL, RL * self.D), dtype=self.dtype, device=self.device)
        r0 = min(self.rank * RL, nL)
        r1 = min(r0 + RL, nL)
        rows[:r1 - r0, :nL] = cinv[r0:r1]
        return out, rows


def galerkin_hierarchy(A0, Ps, cfg: SolveConfig, dtype: torch.dtype, device, group,
                       backend: str = "well", reorder: bool = True):
    """The refreshable row-partitioned hierarchy of A0's Galerkin chain over
    Ps, the sharded steppers' solver: ``backend="well"`` this module's
    (always in the induced ordering), ``"halo"`` ``parallel/halo.
    HaloHierarchy`` (in the induced ordering, or with reorder=False in the
    order given)."""
    from surface_multigrid_code_torch.parallel.halo import HaloHierarchy
    from surface_multigrid_code_torch.solver.galerkin import galerkin_chain

    if backend == "well":
        if not reorder:
            raise ValueError(
                "backend='well' always applies the induced-RCM ordering (its band-segment "
                "exchange needs banded operators); pass backend='halo' for reorder=False")
        return WellHaloHierarchy.galerkin(A0, Ps, cfg, dtype, device, group)
    if backend == "halo":
        if reorder:
            return HaloHierarchy.galerkin(A0, Ps, cfg, dtype, device, group)
        return HaloHierarchy(galerkin_chain(A0, Ps), Ps, cfg, dtype, device, group,
                             reorder=False).enable_refresh()
    raise ValueError(f"unknown backend {backend!r} (well|halo)")
