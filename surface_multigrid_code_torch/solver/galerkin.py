"""Galerkin coarsening with cached symbolic structure (ports ``surface_multigrid_code_tpu/solver/galerkin.py``).

The hierarchy's prolongations P are fixed, so the sparsity of every
Galerkin product A_{l+1} = P^T A_l P is static and only values change.
Per level the symbolic expansion

    A_out[k] = sum_{(a,b,c) in triples(k)} P[a] * A_in[b] * P[c]

is precomputed once, with the static P*P weights folded into one
coefficient per contribution, so a value refresh is one gather, multiply
and segment sum per level. This module builds those plans on the host
(numpy), moves them to a device once (``device_plan``) and refreshes the
values there (``refresh_values``: scalar values for MCF's
``RefreshableMGSolver``, [3, 3] blocks for the balloon's
``BsrRefreshableSolver``).

The plans keep the JAX package's layout so both packages index the same
values: short segments as a gather table [nnz_out, W] into the input
values padded by one trailing zero, the long-segment rest as a sorted
tail, and each level's ELL gather map and diagonal slots.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn


@dataclass(frozen=True)
class LevelPlan:
    """Symbolic PtAP for one level (numpy arrays; static per hierarchy)."""

    # short segments: indices into the input values PADDED by one
    # trailing zero (index nnz_in = padding), with folded P*P weights
    gat_idx: np.ndarray    # [nnz_out, W] int32
    gat_w: np.ndarray      # [nnz_out, W]
    # long-segment tail (may be empty)
    tail_idx: np.ndarray   # [n_tail] into the input values
    tail_w: np.ndarray     # [n_tail]
    tail_seg: np.ndarray   # [n_tail] output nnz id (ascending)
    nnz_in: int
    nnz_out: int
    # ELL layout of the output level: gather map from the value vector
    # (padded by one trailing zero) into [n, width]
    ell_gather: np.ndarray   # [n, width] int32 (nnz_out = padding)
    ell_shape: tuple[int, int]
    ell_indices: np.ndarray  # [n, width] int32 column ids
    diag_idx: np.ndarray     # [n] nnz id of each diagonal entry


@dataclass(frozen=True)
class GalerkinPlan:
    levels: tuple[LevelPlan, ...]
    # finest-level layout (same fields for level 0)
    lvl0: LevelPlan


def _ell_layout(A: sp.csr_matrix, min_width: int = 1):
    """Static ELL layout of a CSR pattern: a GATHER map from the nnz value
    vector (padded by one trailing zero at index nnz) into [n, width],
    plus padded column ids (padding points at row 0) and diagonal nnz ids."""
    n, _ = A.shape
    counts = np.diff(A.indptr)
    width = max(int(counts.max(initial=0)), min_width)
    rows = np.repeat(np.arange(n), counts)
    slots = np.arange(A.nnz) - np.repeat(A.indptr[:-1], counts)
    indices = np.zeros((n, width), dtype=np.int32)
    indices[rows, slots] = A.indices
    gather = np.full((n, width), A.nnz, dtype=np.int32)
    gather[rows, slots] = np.arange(A.nnz, dtype=np.int32)
    # diagonal nnz ids (vectorized: canonical CSR keys are globally sorted)
    pkeys = rows.astype(np.int64) * A.shape[1] + A.indices
    dkeys = np.arange(n, dtype=np.int64) * (A.shape[1] + 1)
    pos = np.searchsorted(pkeys, dkeys)
    ok = (pos < pkeys.size) & (pkeys[np.minimum(pos, pkeys.size - 1)] == dkeys)
    if not ok.all():
        raise ValueError("pattern is missing a diagonal entry")
    diag_idx = pos.astype(np.int64)
    return gather, (n, width), indices, diag_idx


def _ellize_segments(seg, idx, w, nnz_in, nnz_out, W_cap=32):
    """Split sorted segments into an ELL part (first <= W entries of each
    segment) and a tail for a segment sum. Padding gathers the trailing
    zero at index nnz_in with weight 0."""
    counts = np.bincount(seg, minlength=nnz_out)
    W = int(min(max(counts.max(initial=1), 1), W_cap))
    starts = np.concatenate([[0], np.cumsum(counts)])
    pos_in_seg = np.arange(seg.shape[0]) - starts[seg]
    in_ell = pos_in_seg < W
    gat_idx = np.full((nnz_out, W), nnz_in, dtype=np.int32)
    gat_w = np.zeros((nnz_out, W))
    gat_idx[seg[in_ell], pos_in_seg[in_ell]] = idx[in_ell]
    gat_w[seg[in_ell], pos_in_seg[in_ell]] = w[in_ell]
    tail = ~in_ell
    return (
        gat_idx, gat_w,
        idx[tail].astype(np.int64), w[tail], seg[tail].astype(np.int64),
    )


def galerkin_triples(A: sp.csr_matrix, P: sp.csr_matrix):
    """Expand PT @ A @ P into sorted contribution triples.

    Returns (seg, in_id, w, A_out): for each contribution, the OUTPUT nnz
    segment id (ascending), the INPUT A-nnz id it reads, and the scalar
    weight Pdat[a]*Pdat[c]; A_out is the coarse CSR pattern (zeros) whose
    canonical nnz order defines the segment ids."""
    A = A.tocsr()
    A.sum_duplicates()
    P = P.tocsr()
    P.sum_duplicates()
    nnzA = A.nnz
    # For A nnz (i, j, b): rows of the products are P columns of row i,
    # cols are P columns of row j.
    Ai = np.repeat(np.arange(A.shape[0]), np.diff(A.indptr))
    Aj = A.indices
    Pptr, Pind = P.indptr, P.indices
    Pcnt = np.diff(Pptr)
    ci = Pcnt[Ai]  # count of left factors per A nnz
    cj = Pcnt[Aj]
    reps = ci * cj
    b = np.repeat(np.arange(nnzA), reps)  # A nnz id per triple
    total = int(reps.sum())
    # local (u, v) grids: u in [0, ci), v in [0, cj)
    offs = np.concatenate([[0], np.cumsum(reps)])
    local = np.arange(total) - np.repeat(offs[:-1], reps)
    u = local // np.repeat(cj, reps)
    v = local % np.repeat(cj, reps)
    a = np.repeat(Pptr[Ai], reps) + u  # left P nnz id
    c = np.repeat(Pptr[Aj], reps) + v  # right P nnz id
    out_r = Pind[a]
    out_c = Pind[c]
    # sort by (out_r, out_c) to form segments
    nc = int(P.shape[1])
    key = out_r.astype(np.int64) * nc + out_c
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    uniq, seg = np.unique(key_s, return_inverse=True)
    nnz_out = uniq.shape[0]
    out_rows = (uniq // nc).astype(np.int64)
    out_cols = (uniq % nc).astype(np.int64)
    counts = np.bincount(out_rows, minlength=nc)
    indptr = np.concatenate([[0], np.cumsum(counts)])
    A_out = sp.csr_matrix(
        (np.zeros(nnz_out), out_cols, indptr), shape=(nc, nc)
    )
    Pdat = P.data
    w = Pdat[a[order]] * Pdat[c[order]]
    return seg, b[order], w, A_out


def _level_symbolic(A: sp.csr_matrix, P: sp.csr_matrix) -> LevelPlan:
    """Expand PT @ A @ P into (triple index, weight, output segment)."""
    seg, in_id, w, A_out = galerkin_triples(A, P)
    nnzA = A.tocsr().nnz
    nnz_out = A_out.nnz
    gather, shape, indices, diag_idx = _ell_layout(A_out)
    gat_idx, gat_w, tail_idx, tail_w, tail_seg = _ellize_segments(
        seg, in_id, w, nnzA, nnz_out
    )
    return LevelPlan(
        gat_idx=gat_idx, gat_w=gat_w, tail_idx=tail_idx, tail_w=tail_w,
        tail_seg=tail_seg, nnz_in=nnzA, nnz_out=nnz_out, ell_gather=gather,
        ell_shape=shape, ell_indices=indices, diag_idx=diag_idx,
    )


def build_galerkin_plan(A0_pattern: sp.csr_matrix, Ps: list[sp.spmatrix]) -> GalerkinPlan:
    """Host symbolic setup: A0's layout + per-level PtAP expansions.

    A0_pattern: finest-level matrix (pattern + any values); Ps[l] maps
    level l+1 -> level l as in mg_data.
    """
    A = A0_pattern.tocsr().copy()
    A.sum_duplicates()
    gather, shape, indices, diag_idx = _ell_layout(A)
    empty_i = np.zeros(0, dtype=np.int64)
    lvl0 = LevelPlan(
        gat_idx=np.zeros((0, 1), dtype=np.int32),
        gat_w=np.zeros((0, 1)),
        tail_idx=empty_i,
        tail_w=np.zeros(0),
        tail_seg=empty_i,
        nnz_in=A.nnz,
        nnz_out=A.nnz,
        ell_gather=gather,
        ell_shape=shape,
        ell_indices=indices,
        diag_idx=diag_idx,
    )
    levels = []
    A_sym = A
    for P in Ps:
        plan = _level_symbolic(A_sym, P.tocsr())
        levels.append(plan)
        A_sym = plan_pattern(plan)
    return GalerkinPlan(levels=tuple(levels), lvl0=lvl0)


def plan_pattern(plan: LevelPlan) -> sp.csr_matrix:
    """Reconstruct a level's CSR pattern from its ELL gather layout
    (real slots are those gathering below nnz_out)."""
    n, w = plan.ell_shape
    gather = np.asarray(plan.ell_gather)
    cols = np.asarray(plan.ell_indices)
    valid = gather < plan.nnz_out
    rows = np.repeat(np.arange(n), w).reshape(n, w)
    return sp.coo_matrix(
        (np.ones(int(valid.sum())), (rows[valid], cols[valid])),
        shape=(n, n),
    ).tocsr()


def _refresh_values_host(plan: GalerkinPlan, A0_vals: np.ndarray) -> list[np.ndarray]:
    """Per-level nnz value vectors in canonical CSR order (host f64): the
    ``raw=True`` form of the JAX package's ``refresh_values``."""
    vals = np.asarray(A0_vals, dtype=np.float64)
    out = [vals]
    for pl_ in plan.levels:
        vpad = np.concatenate([vals, np.zeros(1)])
        vals = (pl_.gat_w * vpad[pl_.gat_idx]).sum(axis=1)
        if pl_.tail_idx.shape[0]:
            np.add.at(vals, pl_.tail_seg, pl_.tail_w * vpad[pl_.tail_idx])
        out.append(vals)
    return out


def galerkin_chain(A0: sp.spmatrix, Ps: list[sp.spmatrix]) -> list[sp.csr_matrix]:
    """Galerkin-coarsen keeping the full SYMBOLIC Pᵀ A P pattern per level
    (explicit zeros retained), so every level's stored CSR layout matches
    build_galerkin_plan's canonical order.

    scipy's numeric triple product can drop entries whose products cancel
    exactly (e.g. through the exact-zero barycentric weights SSP
    prolongations carry), which would de-synchronize a numerically built
    chain from the symbolic plan.
    """
    A0 = A0.tocsr().copy()
    A0.sum_duplicates()
    plan = build_galerkin_plan(A0, Ps)
    vals = _refresh_values_host(plan, A0.data)
    As = [A0]
    for lv, pl_ in enumerate(plan.levels):
        pat = plan_pattern(pl_)
        As.append(
            sp.csr_matrix(
                (vals[lv + 1], pat.indices.copy(), pat.indptr.copy()),
                shape=pat.shape,
            )
        )
    return As


class DevicePlanLevel(nn.Module):
    """One ``LevelPlan`` on a device, with its level's CSR pattern."""

    def __init__(self, pl_: LevelPlan, pattern: sp.csr_matrix, device,
                 dtype: torch.dtype):
        super().__init__()
        t = (lambda a, dt: torch.as_tensor(np.asarray(a)).to(device=device, dtype=dt))
        self.register_buffer("gat_idx", t(pl_.gat_idx, torch.int64))
        self.register_buffer("gat_w", t(pl_.gat_w, dtype))
        self.register_buffer("tail_idx", t(pl_.tail_idx, torch.int64))
        self.register_buffer("tail_w", t(pl_.tail_w, dtype))
        self.register_buffer("tail_seg", t(pl_.tail_seg, torch.int64))
        self.register_buffer("diag_idx", t(pl_.diag_idx, torch.int64))
        self.register_buffer("indptr", t(pattern.indptr, torch.int32))
        self.register_buffer("indices", t(pattern.indices, torch.int32))
        self.nnz_out = int(pl_.nnz_out)
        if pattern.nnz != self.nnz_out:
            raise ValueError("plan and pattern disagree on the nnz count")

    @property
    def n(self) -> int:
        return self.indptr.shape[0] - 1


def device_plan(plan: GalerkinPlan, pattern0: sp.csr_matrix, device,
                dtype: torch.dtype) -> list[DevicePlanLevel]:
    """All levels of a plan on a device, finest first (level 0 has no
    triple expansion; its pattern is the one the plan was built on)."""
    out = [DevicePlanLevel(plan.lvl0, pattern0, device, dtype)]
    out += [DevicePlanLevel(pl_, plan_pattern(pl_), device, dtype) for pl_ in plan.levels]
    return out


def refresh_values(plans: list[DevicePlanLevel], A0_vals: torch.Tensor):
    """All-level Galerkin value refresh on the plans' device (ports the JAX
    package's ``refresh_values``). ``A0_vals`` [nnz, *E] holds the finest
    values in the canonical CSR order of the plan's pattern, each a scalar
    (E empty) or an entry of shape E (the balloon's [3, 3] blocks; the P
    weights are scalars). Per level, vals_out[k] = sum w * vals_in[b] as one
    gather-multiply-sum over the short segments plus an ``index_add_`` of
    the long-segment tail. Returns per level (values [nnz_l, *E] in the
    level's canonical CSR order, which is its CSR data, and the diagonal
    entries [n_l, *E]), finest first."""
    vals = A0_vals
    ent = tuple(vals.shape[1:])
    bcast = (None,) * len(ent)
    out = [(vals, vals[plans[0].diag_idx])]
    for pl_ in plans[1:]:
        vpad = torch.cat([vals, vals.new_zeros((1, *ent))])
        vals = (pl_.gat_w[(..., *bcast)] * vpad[pl_.gat_idx]).sum(dim=1)
        if pl_.tail_idx.shape[0]:
            tail = torch.zeros_like(vals).index_add_(
                0, pl_.tail_seg, pl_.tail_w[(..., *bcast)] * vpad[pl_.tail_idx])
            vals = vals + tail
        out.append((vals, vals[pl_.diag_idx]))
    return out
