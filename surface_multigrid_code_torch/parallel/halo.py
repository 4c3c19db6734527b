"""Row-partitioned multigrid over torch.distributed (ports ``surface_multigrid_code_tpu/parallel/halo.py``).

Every level's rows are cut into D equal contiguous blocks, one per rank,
and every SpMV exchanges only the halo: the vector entries that another
rank's stencils read (the 1-ring and the P / Pᵀ stencils at the block
boundaries).

Plan (host, once, on every rank from the same matrices):

- the levels are put in the induced ordering of ``solver/ordering.py``
  (RCM on the finest level, each coarser level ordered by the fine rows
  its prolongation column touches), so that blocks are spatially coherent
  and a coarse block lines up with the fine block it restricts from;
- per level, each rank's ``send``: the sorted local row ids that another
  rank's A, P or Pᵀ stencil reads, padded to the level's largest count S
  by repeating the last id (the JAX package's table, bit for bit);
- each rank's rows of A_l, P_l and Pᵀ_l as CSR over the rank's local
  address space [0, R + D*S): its own R entries, then the D publish
  buffers, rank-major. Rows past n (the last block is padded to R rows)
  are identity rows with zero right-hand side, and stay zero.

Per V-cycle, on each rank (one hand-kernel launch, K1 for one column and
K2 for C columns, per SpMV, with the fused epilogues):

- smoothing: ``exchange``, then ``fused_spmv(epi="axpby")`` (Jacobi) or
  ``epi="resid_scaled"`` in the Chebyshev recurrence;
- residual: ``exchange``, ``epi="resid"``;
- restriction: Pᵀ reads the fine halo; or, where the coarse level has
  fewer than ``COLUMN_RESTRICT_ROWS`` rows per rank, column-partitioned:
  each rank holds Pᵀ[:, its fine block], computes a full-length partial
  coarse vector from its local residual alone, and the partials are
  summed by ``allreduce_sum`` (the JAX ``wellhalo.py:36-44`` design; its
  B_ROWS alignment is a TPU layout rule and is not carried over);
- prolongation: ``exchange`` of the coarse vector, ``epi="add"``;
- the coarsest level: ``gather_rows`` of the right-hand side, then this
  rank's rows of the replicated dense (pseudo-)inverse.

Multicolor Gauss-Seidel depends on row order and does not shard
order-free; it raises, as ``wellhalo.py`` does (``halo.py`` itself ran
Jacobi quietly for any smoother but Chebyshev).

``enable_refresh`` / ``solve_values``: finest nnz values in, every level
refreshed on every rank (the replicated ``solver/galerkin.refresh_values``),
each rank's slice taken through ``A_src`` / ``diag_src`` (nnz ids of the
level's canonical CSR order; -2 marks an identity-pad entry, which stays
1.0; -1 would be ELL padding, which the CSR blocks do not have).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from surface_multigrid_code_torch.config import SmootherType, SolveConfig
from surface_multigrid_code_torch.ops.smoothers import chebyshev_smooth, jacobi_sweep
from surface_multigrid_code_torch.ops.sparse import CSRMatrix, row_ids
from surface_multigrid_code_torch.ops.spmv import fused_spmv
from surface_multigrid_code_torch.parallel.comm import Comm, rank_device
from surface_multigrid_code_torch.solver.galerkin import (
    _refresh_values_host,
    build_galerkin_plan,
    device_plan,
    plan_pattern,
    refresh_values,
)
from surface_multigrid_code_torch.solver.ordering import (
    finest_rcm,
    induced_orderings,
    permute_hierarchy,
)
from surface_multigrid_code_torch.solver.refresh import _device_lam_max, csr_slot_map
from surface_multigrid_code_torch.solver.vcycle import (
    _power_iteration_lam_max,
    coarse_pseudo_inverse,
)

# A restriction into a level of fewer rows per rank than this is
# column-partitioned. At that size a rank's block of a surface level is
# nearly all boundary (the SSP hierarchy of icosphere(5) at D = 4: every
# row published at 161 rows per rank, 333 of 641 at 641), so the row
# partition saves no traffic there; the column partition keeps Pᵀ's reads
# out of the fine level's publish set and moves instead one allreduce of
# the coarse vector, at most 256 * D values (4 KB in f32 at D = 4), a
# message whose cost is latency (gloo on CUDA tensors took the same time
# for 64 and 4,096 floats). Above it the allreduce grows with the level,
# the halo only with the block's boundary.
COLUMN_RESTRICT_ROWS = 256


def _pad_to(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


def _publish_sets(readers, D: int, R: int) -> np.ndarray:
    """send [D, S]: per owner rank, the sorted local ids of its rows that
    another rank reads. ``readers``: (matrix over this level's columns,
    rows per rank of that matrix's own partition). Padded to S by the last
    id (0 for an empty set); S >= 1. The JAX package's ``_build_level``."""
    need = [[] for _ in range(D)]
    for M, RM in readers:
        M = M.tocsr()
        for d in range(D):
            lo, hi = min(d * RM, M.shape[0]), min((d + 1) * RM, M.shape[0])
            cols = M.indices[M.indptr[lo]:M.indptr[hi]].astype(np.int64)
            owner = cols // R
            other = owner != d
            for od in np.unique(owner[other]):
                need[od].append(cols[other & (owner == od)] - od * R)
    ids = [np.unique(np.concatenate(x)) if x else np.zeros(0, np.int64) for x in need]
    S = max(1, max(i.shape[0] for i in ids))
    send = np.zeros((D, S), dtype=np.int64)
    for d, i in enumerate(ids):
        send[d, :i.shape[0]] = i
        if i.shape[0]:
            send[d, i.shape[0]:] = i[-1]
    return send


def _remap_columns(cols: np.ndarray, D: int, R: int, send: np.ndarray, rank: int):
    """Column id -> local address for ``rank``: its own rows [rank*R,
    (rank+1)*R) -> [0, R); a row of rank od -> R + od*S + its slot in
    od's send list (which must hold it)."""
    out = np.empty_like(cols)
    owner = cols // R
    local = owner == rank
    out[local] = cols[local] - rank * R
    S = send.shape[1]
    for od in range(D):
        m = (~local) & (owner == od)
        if not m.any():
            continue
        want = cols[m] - od * R
        slot = np.minimum(np.searchsorted(send[od], want), S - 1)
        if not np.all(send[od][slot] == want):
            raise ValueError(
                f"column remap: rows {np.unique(want[send[od][slot] != want])[:8]} read by "
                f"rank {rank} are missing from rank {od}'s send list")
        out[m] = R + od * S + slot
    return out


def _rows_block(M: sp.csr_matrix, lo: int, hi: int):
    """(indptr from 0, indices, data, nnz ids) of rows [lo, hi) of a CSR,
    entries in the matrix's order; rows past its end are empty."""
    nr = M.shape[0]
    a, b = min(lo, nr), min(hi, nr)
    indptr = np.concatenate([M.indptr[a:b + 1], np.full(hi - lo - (b - a), M.indptr[b])])
    indptr = indptr - M.indptr[a]
    ids = np.arange(M.indptr[a], M.indptr[b], dtype=np.int64)
    return indptr, M.indices[ids].astype(np.int64), M.data[ids], ids


def _csr(indptr, indices, data, n_cols, device, dtype) -> CSRMatrix:
    if indices.shape[0] >= 2**31:
        raise ValueError("CSRMatrix indexes nonzeros with int32")
    return CSRMatrix(
        torch.as_tensor(np.asarray(indptr, dtype=np.int32), device=device),
        torch.as_tensor(np.asarray(indices, dtype=np.int32), device=device),
        torch.as_tensor(np.asarray(data, dtype=np.float64)).to(device=device, dtype=dtype),
        n_cols,
    )


def _nonzero(M: sp.spmatrix) -> sp.csr_matrix:
    """A transfer operator without its stored zeros (they add nothing;
    the JAX ELL layout drops them with its padding)."""
    M = sp.csr_matrix(M, copy=True)
    M.eliminate_zeros()
    return M


class HaloLevel(nn.Module):
    """One rank's part of one level.

    R, S: rows per rank and publish slots per rank.
    send: int64 [S] local row ids this rank publishes.
    A: CSR [R, R + D*S] over the local address space; diag, dinv [R].
    P: this level's rows of the prolongation from the next coarser level,
       CSR [R, Rc + D*Sc] over the coarse level's local address space.
    PT: the restriction to the next coarser level: CSR [Rc, R + D*S] over
       this level's address space, or, column-partitioned (``pt_cols``),
       CSR [Rc*D, R]: every coarse row, this rank's fine columns.
    A_src / diag_src: int64 refresh maps (module docstring).
    lam_max: Chebyshev bound of D^-1 A (None unless Chebyshev smooths).
    """

    def __init__(self, R: int, S: int, send: torch.Tensor, A: CSRMatrix,
                 diag: torch.Tensor, A_src: torch.Tensor, diag_src: torch.Tensor,
                 P: CSRMatrix | None = None, PT: CSRMatrix | None = None,
                 pt_cols: bool = False, lam_max: float | None = None):
        super().__init__()
        self.R, self.S = int(R), int(S)
        self.register_buffer("send", send)
        self.A, self.P, self.PT = A, P, PT
        self.register_buffer("diag", diag)
        self.register_buffer("dinv", 1.0 / diag)
        self.register_buffer("A_src", A_src)
        self.register_buffer("diag_src", diag_src)
        self.pt_cols = bool(pt_cols)
        self.lam_max = lam_max


class RowPartitioned:
    """The V-cycle, solve loop and host API of a row-partitioned hierarchy.

    Every level's rows are cut into D equal blocks of R rows, one per rank
    (the last padded past n). A subclass builds, per rank, ``levels``
    (each with ``R``, ``A``, ``dinv``, ``lam_max``, and above the coarsest
    ``P``, ``PT`` and ``pt_cols``), ``_As`` (the host levels in the
    partition's order), ``perm0``, ``n0``, ``comm``, ``device``, ``dtype``,
    ``cfg``, ``sent_bytes`` and ``_coarse_inv = None``, and defines
    ``_exchange(lv, x)``: the vector this rank's operators read from its
    rows ``x`` of level lv. A refreshable one also defines ``refresh``.
    """

    @property
    def coarse_inv(self) -> torch.Tensor:
        """This rank's rows of the dense pseudo-inverse of the coarsest
        level (identity rows on its pad), built on first use: the refreshed
        solves build their own."""
        if self._coarse_inv is None:
            RL = self.levels[-1].R
            A = self._As[-1]
            Ac = sp.csr_matrix(A, copy=True)
            Ac.resize((RL * self.D, RL * self.D))
            Ac = Ac + sp.diags(np.r_[np.zeros(A.shape[0]), np.ones(RL * self.D - A.shape[0])])
            Cinv = coarse_pseudo_inverse(Ac)[self.rank * RL:(self.rank + 1) * RL]
            self._coarse_inv = torch.as_tensor(Cinv).to(self.device, self.dtype)
        return self._coarse_inv

    # ------------------------------------------------------------- V-cycle
    def _smooth(self, lv: int, lvl, b, u, n_iter: int):
        x_of = (lambda v: self._exchange(lv, v))
        if self.cfg.smoother == SmootherType.CHEBYSHEV:
            return chebyshev_smooth(lvl.A, lvl.dinv, lvl.lam_max, b, u, degree=n_iter,
                                    x_of=x_of)
        for _ in range(n_iter):
            u = jacobi_sweep(lvl.A, lvl.dinv, b, u, weight=self.cfg.jacobi_weight, x_of=x_of)
        return u

    def _cycle(self, lv: int, b, u, levels, coarse_rows):
        lvl = levels[lv]
        if lv == len(levels) - 1:
            b_all = self.comm.gather_rows(b)
            self.sent_bytes[lv] += b.numel() * b.element_size()
            return u + coarse_rows @ b_all
        cfg = self.cfg
        u = self._smooth(lv, lvl, b, u, cfg.pre_relax_iter)
        r = fused_spmv(lvl.A, self._exchange(lv, u), epi="resid", b=b)
        Rc = levels[lv + 1].R
        if lvl.pt_cols:
            part = self.comm.allreduce_sum(fused_spmv(lvl.PT, r))
            self.sent_bytes[lv + 1] += part.numel() * part.element_size()
            rc = part[self.rank * Rc:(self.rank + 1) * Rc].contiguous()
        else:
            rc = fused_spmv(lvl.PT, self._exchange(lv, r))
        uc = self._cycle(lv + 1, rc, torch.zeros_like(rc), levels, coarse_rows)
        u = fused_spmv(lvl.P, self._exchange(lv + 1, uc), epi="add", u=u)
        return self._smooth(lv, lvl, b, u, cfg.post_relax_iter)

    def vcycle(self, b: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """One V-cycle on this rank's rows of the finest level (b, u: [R0]
        or [R0, C]); every rank calls it together. Returns a new tensor."""
        return self._cycle(0, b, u, self.levels, self.coarse_inv)

    def _loop(self, rhs, z, tol: float, max_iter: int, levels, coarse_rows):
        """The solve loop of ``solver/vcycle.solve_loop`` on the local rows:
        record the global residual norm (an allreduce, so every rank takes
        the same decision), stop before cycling once it is below tol."""
        A0 = levels[0].A
        tol_t = torch.tensor(tol, dtype=rhs.dtype, device=rhs.device)
        r_his = []
        for _ in range(max_iter):
            r = fused_spmv(A0, self._exchange(0, z), epi="resid", b=rhs)
            res = torch.sqrt(self.comm.allreduce_sum((r * r).sum().reshape(1)))[0]
            r_his.append(res)
            if bool(res < tol_t):
                break
            z = self._cycle(0, rhs, z, levels, coarse_rows)
        return z, torch.stack(r_his)

    # ------------------------------------------------------------ host API
    def local_rows(self, v) -> torch.Tensor:
        """This rank's rows of a full vector ([n0] or [n0, C], numpy) in the
        partition's order, zero on the pad."""
        v = np.asarray(v, dtype=np.float64)
        R0 = self.levels[0].R
        out = np.zeros((R0 * self.D,) + v.shape[1:])
        out[:self.n0] = v[self.perm0]
        blk = out[self.rank * R0:(self.rank + 1) * R0]
        return torch.as_tensor(blk).to(device=self.device, dtype=self.dtype)

    def _finish(self, z, r_his, tolerance):
        z_all = self.comm.gather_rows(z).cpu().to(torch.float64).numpy()
        z_out = np.empty((self.n0,) + z_all.shape[1:])
        z_out[self.perm0] = z_all[:self.n0]
        r_list = [float(r) for r in r_his.cpu()]
        return z_out, r_list, bool(r_list and r_list[-1] <= tolerance)

    def solve(self, rhs, z0=None, tolerance: float = 1e-3, max_iter: int = 20):
        """Solve A0 z = rhs (rhs [n0] or [n0, C], numpy, the same on every
        rank); returns (z f64 numpy, the residual list, converged) on every
        rank, as the JAX ``HaloHierarchy.solve``."""
        rhs_l = self.local_rows(rhs)
        z_l = torch.zeros_like(rhs_l) if z0 is None else self.local_rows(z0)
        z, r_his = self._loop(rhs_l, z_l, float(tolerance), int(max_iter), self.levels,
                              self.coarse_inv)
        return self._finish(z, r_his, tolerance)

    def solve_values(self, A0_vals, rhs, z0=None, tolerance: float = 1e-3,
                     max_iter: int = 20):
        """Refresh every level from finest nnz values (original canonical CSR
        order of the A0 the hierarchy was built from; numpy or a tensor),
        then solve as ``solve``. Requires ``enable_refresh()``."""
        levels, coarse_rows = self.refresh(A0_vals)
        rhs_l = self.local_rows(rhs)
        z_l = torch.zeros_like(rhs_l) if z0 is None else self.local_rows(z0)
        z, r_his = self._loop(rhs_l, z_l, float(tolerance), int(max_iter), levels,
                              coarse_rows)
        return self._finish(z, r_his, tolerance)


class HaloHierarchy(RowPartitioned):
    """One rank's share of a row-partitioned multigrid hierarchy.

    As, Ps: the hierarchy (scipy), the same on every rank; Ps[l] maps level
    l+1 to level l. group: the torch.distributed process group (None: the
    default group); every rank of it constructs the object and calls
    ``solve`` together. device: this rank's device, ``cuda`` meaning
    ``cuda:{rank % device count}`` (``comm.rank_device``). reorder: put the
    levels in the induced RCM ordering (``solver/ordering.py``); with False
    the partition follows the given order (the JAX ``reorder=False``).

    Chebyshev bounds come from the host power iteration on the levels as
    given, before reordering, so they are the single-device hierarchy's
    (``solver/vcycle.build_device_hierarchy``) whatever D and the ordering.
    """

    def __init__(self, As, Ps, cfg: SolveConfig | None = None,
                 dtype: torch.dtype = torch.float32, device="cuda", group=None,
                 reorder: bool = True):
        self.cfg = cfg or SolveConfig(smoother=SmootherType.CHEBYSHEV)
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
        if reorder:
            perms = induced_orderings(finest_rcm(A0), Ps)
            As, Ps = permute_hierarchy(As, Ps, perms)
            self.perm0 = perms[0]
        else:
            As = [sp.csr_matrix(A, copy=True) for A in As]
            Ps = [sp.csr_matrix(P, copy=True) for P in Ps]
            self.perm0 = np.arange(self.n0)
        for A in As:
            A.sum_duplicates()
        self._As, self._Ps = As, Ps
        Rs = [_pad_to(A.shape[0], D) // D for A in As]
        self.pt_cols = [lv < L - 1 and Rs[lv + 1] < COLUMN_RESTRICT_ROWS for lv in range(L)]

        sends = []
        for lv in range(L):
            # this level's vector is read by its A, by Pᵀ_lv (coarse rows
            # reading fine entries) unless that restriction is column-
            # partitioned, and by P_{lv-1} (finer rows reading this level)
            readers = [(As[lv], Rs[lv])]
            if lv < L - 1 and not self.pt_cols[lv]:
                readers.append((Ps[lv].T.tocsr(), Rs[lv + 1]))
            if lv > 0:
                readers.append((Ps[lv - 1], Rs[lv - 1]))
            sends.append(_publish_sets(readers, D, Rs[lv]))
        self.sends = sends

        dev, dt = self.device, dtype
        as_t = (lambda a, d=torch.int64: torch.as_tensor(np.asarray(a), dtype=d, device=dev))
        levels = []
        for lv in range(L):
            A, R, send = As[lv], Rs[lv], sends[lv]
            n = A.shape[0]
            lo, hi = rank * R, (rank + 1) * R
            indptr, cols, data, src = _rows_block(A, lo, hi)
            # identity rows past n, stored after the block's real entries
            n_pad_rows = max(0, hi - max(lo, n))
            if n_pad_rows:
                first = max(lo, n)
                pad_cols = np.arange(first, hi, dtype=np.int64)
                indptr = indptr.copy()
                indptr[first - lo + 1:] += np.arange(1, n_pad_rows + 1)
                cols = np.concatenate([cols, pad_cols])
                data = np.concatenate([data, np.ones(n_pad_rows)])
                src = np.concatenate([src, np.full(n_pad_rows, -2, dtype=np.int64)])
            local = _remap_columns(cols, D, R, send, rank)
            S = send.shape[1]
            rows = np.arange(lo, hi)
            real = rows < n
            dslot = np.full(R, -2, dtype=np.int64)
            if real.any():
                dslot[np.flatnonzero(real)] = _diag_slots(A, rows[real])
            diag = np.ones(R)
            has = dslot >= 0
            diag[has] = A.data[dslot[has]]
            diag[real & ~has] = 0.0
            levels.append(HaloLevel(
                R, S, as_t(send[rank]), _csr(indptr, local, data, R + D * S, dev, dt),
                as_t(diag, torch.float64).to(dt), as_t(src), as_t(dslot),
                lam_max=lams[lv]))
        for lv in range(L - 1):
            fine, coarse = levels[lv], levels[lv + 1]
            Rf, Rc = fine.R, coarse.R
            P = _nonzero(Ps[lv])
            indptr, cols, data, _ = _rows_block(P, rank * Rf, (rank + 1) * Rf)
            local = _remap_columns(cols, D, Rc, sends[lv + 1], rank)
            fine.P = _csr(indptr, local, data, Rc + D * coarse.S, dev, dt)
            PT = P.T.tocsr()
            if self.pt_cols[lv]:
                PTc = sp.csr_matrix(PT, copy=True)
                PTc.resize((Rc * D, Rf * D))
                PTc = PTc[:, rank * Rf:(rank + 1) * Rf].tocsr()
                fine.PT = _csr(PTc.indptr, PTc.indices, PTc.data, Rf, dev, dt)
            else:
                indptr, cols, data, _ = _rows_block(PT, rank * Rc, (rank + 1) * Rc)
                local = _remap_columns(cols, D, Rf, sends[lv], rank)
                fine.PT = _csr(indptr, local, data, Rf + D * fine.S, dev, dt)
            fine.pt_cols = self.pt_cols[lv]
        self.levels = levels
        self._coarse_inv = None
        self._refresh = None
        # bytes this rank has sent, per level: exchanges of the level's
        # vector, the coarsest gather, and the partial coarse vectors of a
        # column-partitioned restriction (under the coarse level)
        self.sent_bytes = [0] * L

    @classmethod
    def galerkin(cls, A0, Ps, cfg: SolveConfig | None = None,
                 dtype: torch.dtype = torch.float32, device="cuda",
                 group=None) -> "HaloHierarchy":
        """The hierarchy of A0's Galerkin chain over Ps on its full symbolic
        PᵀAP pattern (``solver.galerkin.galerkin_chain``) in the induced
        ordering, refresh enabled: the symbolic plan is built once, in the
        partition's order, and serves both the chain and ``solve_values``.
        The stored chain's values (and so its Chebyshev bounds) are
        computed in that order."""
        A0 = sp.csr_matrix(A0, copy=True)
        A0.sum_duplicates()
        perms = induced_orderings(finest_rcm(A0), Ps)
        (A0p,), Psp = permute_hierarchy([A0], Ps, perms)
        A0p.sum_duplicates()
        plan = build_galerkin_plan(A0p, Psp)
        vals = _refresh_values_host(plan, A0p.data)
        As = [A0p] + [sp.csr_matrix((v, pat.indices, pat.indptr), shape=pat.shape)
                      for v, pat in zip(vals[1:], map(plan_pattern, plan.levels))]
        h = cls(As, Psp, cfg, dtype, device, group, reorder=False)
        h.perm0, h._A0_orig = perms[0], A0
        return h._enable_refresh(plan)

    def _exchange(self, lv: int, x: torch.Tensor) -> torch.Tensor:
        lvl = self.levels[lv]
        self.sent_bytes[lv] += lvl.send.shape[0] * (x.numel() // x.shape[0]) * x.element_size()
        return self.comm.exchange(x, lvl.send)

    # -------------------------------------------------------------- refresh
    def enable_refresh(self):
        """Build the Galerkin plan of the (reordered) hierarchy and the
        value maps; afterwards ``solve_values`` takes finest nnz values in
        the canonical CSR order of the A0 the hierarchy was built from.
        The stored chain must carry the plan's full symbolic PᵀAP pattern
        (build it with ``solver.galerkin.galerkin_chain``, or build the
        hierarchy with ``HaloHierarchy.galerkin``)."""
        return self._enable_refresh(build_galerkin_plan(self._As[0], self._Ps))

    def _enable_refresh(self, plan):
        A0p = self._As[0]
        for lv, pl_ in enumerate(plan.levels):
            A_lv, pat = self._As[lv + 1], plan_pattern(pl_)
            if pl_.nnz_out != A_lv.nnz or not (
                    np.array_equal(pat.indptr, A_lv.indptr)
                    and np.array_equal(pat.indices, A_lv.indices)):
                raise ValueError(
                    f"level {lv + 1} pattern mismatch (plan {pl_.nnz_out} vs stored "
                    f"{A_lv.nnz} nnz): build the hierarchy's As with "
                    "solver.galerkin.galerkin_chain so the stored chain keeps the full "
                    "symbolic PtAP pattern")
        self._refresh = {
            "plans": device_plan(plan, A0p, self.device, self.dtype),
            "perm_nnz": torch.as_tensor(nnz_order(self._A0_orig, A0p, self.perm0),
                                        device=self.device),
        }
        return self

    def refresh(self, A0_vals) -> tuple[list[HaloLevel], torch.Tensor]:
        """This rank's levels for finest values A0_vals (original CSR order):
        every level refreshed replicated, this rank's A and diagonal taken
        through A_src / diag_src; Chebyshev bounds by the 12-step power
        iteration from the uniform start on each whole level (K1, the
        single-device ``_device_lam_max``), times 1.1; and this rank's rows
        of the coarse inverse: the dense coarsest level with identity pad
        rows and the diagonal shift, inverted through its Cholesky factor."""
        if self._refresh is None:
            raise RuntimeError("call enable_refresh() first")
        st = self._refresh
        vals0 = torch.as_tensor(A0_vals).to(device=self.device, dtype=self.dtype)
        vals = refresh_values(st["plans"], vals0[st["perm_nnz"]])
        L = len(vals)
        cheb = self.cfg.smoother == SmootherType.CHEBYSHEV
        lams = [None] * L
        if cheb and L > 1:
            est = [_device_lam_max(CSRMatrix(pl_.indptr, pl_.indices, v, pl_.n), d,
                                   iters=self.cfg.lam_power_iters)
                   for pl_, (v, d) in zip(st["plans"][:-1], vals[:-1])]
            lams[:-1] = torch.stack(est).tolist()
        one = torch.ones((), dtype=self.dtype, device=self.device)
        zero = torch.zeros((), dtype=self.dtype, device=self.device)
        out = []
        for lv, (lvl, (v, _)) in enumerate(zip(self.levels, vals)):
            src, dsrc = lvl.A_src, lvl.diag_src
            data = torch.where(src >= 0, v[src.clamp(min=0)],
                               torch.where(src == -2, one, zero))
            diag = torch.where(dsrc >= 0, v[dsrc.clamp(min=0)], one)
            A = CSRMatrix(lvl.A.indptr, lvl.A.indices, data, lvl.A.n_cols)
            out.append(HaloLevel(lvl.R, lvl.S, lvl.send, A, diag, src, dsrc,
                                 lvl.P, lvl.PT, lvl.pt_cols, lams[lv]))
        pl_ = st["plans"][-1]
        RL, n = self.levels[-1].R, pl_.n
        nLp = RL * self.D
        dense = torch.zeros((nLp, nLp), dtype=self.dtype, device=self.device)
        dense.index_put_((row_ids(pl_.indptr, pl_.nnz_out), pl_.indices.long()), vals[-1][0],
                         accumulate=True)
        pad = torch.arange(n, nLp, device=self.device)
        dense[pad, pad] += 1.0
        eye = torch.eye(nLp, dtype=self.dtype, device=self.device)
        dense += self.cfg.coarsest_diag_shift * eye
        cinv = torch.cholesky_solve(eye, torch.linalg.cholesky(dense))
        return out, cinv[self.rank * RL:(self.rank + 1) * RL].contiguous()


def nnz_order(A0: sp.csr_matrix, A0p: sp.csr_matrix, perm0: np.ndarray) -> np.ndarray:
    """For each nonzero of A0p (A0 with rows and columns in the order
    perm0, canonical CSR), the id of that entry in A0's canonical CSR
    order: A0p.data == A0.data[nnz_order(A0, A0p, perm0)]."""
    n = A0.shape[0]
    invp = np.empty(n, dtype=np.int64)
    invp[perm0] = np.arange(n)
    orows = np.repeat(np.arange(n, dtype=np.int64), np.diff(A0.indptr))
    slot_of_orig = csr_slot_map(A0p, invp[orows], invp[A0.indices])
    out = np.empty_like(slot_of_orig)
    out[slot_of_orig] = np.arange(slot_of_orig.shape[0])
    return out


def _diag_slots(A: sp.csr_matrix, rows: np.ndarray) -> np.ndarray:
    """nnz id of the diagonal entry of each of ``rows`` in the canonical CSR
    A, or -2 where the row stores no diagonal."""
    n = A.shape[0]
    prows = np.repeat(np.arange(n, dtype=np.int64), np.diff(A.indptr))
    pkeys = prows * A.shape[1] + A.indices
    dkeys = rows.astype(np.int64) * (A.shape[1] + 1)
    pos = np.searchsorted(pkeys, dkeys)
    has = (pos < pkeys.size) & (pkeys[np.minimum(pos, pkeys.size - 1)] == dkeys)
    return np.where(has, pos, -2)
