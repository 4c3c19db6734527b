"""Carry JAX-package device state into the port.

``hierarchy_from_jax`` takes the leaves of a
``surface_multigrid_code_tpu.solver.vcycle.DeviceHierarchy`` as numpy
arrays (the caller converts them; this module imports nothing of JAX) and
returns the port's ``DeviceHierarchy`` on the same operators, so both
V-cycles can be run on identical inputs.

Per level, ``levels[lv]`` is a dict with

    "A":       (indices [n, w] int, data [n, w] float)  ELL of A
    "P", "PT": the same for P and PT, or None at level 0
    "diag":    [n] float
    "groups":  list of int row-id arrays, padded by repeating the last row
    "lam_max": float or None

and ``coarse_inv`` is the dense [nc, nc] coarse (pseudo-)inverse. ELL
padding slots (index 0, value 0) are dropped, and so is any stored value
that is exactly zero, which contributes nothing to a product. The padded
color groups are de-duplicated, which makes the JAX package's per-row
``group_scale`` unnecessary.

``mg_from_jax`` turns the JAX package's ``MGLevel`` records (numpy arrays
and scipy matrices; no JAX type) into the port's, so both packages run on
one SSP hierarchy; a refreshed hierarchy (the leaves of the JAX
``RefreshableMGSolver._refresh_impl``) goes through ``hierarchy_from_jax``.

``halo_rank_from_jax`` takes a JAX ``parallel.halo.HaloHierarchy``'s
per-device arrays and returns one rank's levels of the port's
``parallel.halo.HaloHierarchy``, so both packages run from the same plan.

``bsr_hierarchy_from_jax`` does the same for a ``solver.bsr.BsrHierarchy``
(the balloon's block multigrid), and ``shell_state_from_jax`` copies a JAX
``ShellEnergy``'s rest state (``abars``, ``bbars``) into a port
``ShellEnergy``, so both packages run their V-cycles and energies on
identical operators and rest states.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from surface_multigrid_code_torch.config import DecimationType
from surface_multigrid_code_torch.models.shell import ShellEnergy
from surface_multigrid_code_torch.ops.sparse import BSRMatrix, CSRMatrix, csr_from_scipy
from surface_multigrid_code_torch.parallel.halo import HaloLevel
from surface_multigrid_code_torch.solver.bsr import BsrHierarchy, BsrLevel
from surface_multigrid_code_torch.solver.hierarchy import MGLevel
from surface_multigrid_code_torch.solver.vcycle import DeviceHierarchy, DeviceLevel


def mg_from_jax(levels) -> list[MGLevel]:
    """The port's MGLevel list from the JAX package's ``MGLevel`` records:
    the same arrays and matrices (copied), the decimation type as the
    port's ``DecimationType``."""
    out = []
    for lv in levels:
        copy = (lambda a: None if a is None else a.copy())
        out.append(MGLevel(
            V=np.array(lv.V), F=np.array(lv.F), P_full=copy(lv.P_full), P=copy(lv.P),
            PT=copy(lv.PT), A=copy(lv.A), A_diag=copy(lv.A_diag),
            dec_type=None if lv.dec_type is None else DecimationType(int(lv.dec_type)),
            ratio=lv.ratio))
    return out


def ell_to_csr(indices: np.ndarray, data: np.ndarray, n_cols: int,
               device, dtype: torch.dtype) -> CSRMatrix:
    """ELL (indices, data) -> device CSR, dropping zero-valued slots."""
    indices = np.asarray(indices)
    data = np.asarray(data, dtype=np.float64)
    n, w = indices.shape
    keep = data != 0.0
    rows = np.repeat(np.arange(n), w).reshape(n, w)[keep]
    A = sp.csr_matrix((data[keep], (rows, indices[keep])), shape=(n, n_cols))
    return csr_from_scipy(A, device, dtype)


def hierarchy_from_jax(levels: list[dict], coarse_inv: np.ndarray, device,
                       dtype: torch.dtype) -> DeviceHierarchy:
    """Build the port's DeviceHierarchy from JAX hierarchy leaves (see module doc)."""
    sizes = [np.asarray(lv["diag"]).shape[0] for lv in levels]
    out = []
    for lv, d in enumerate(levels):
        n = sizes[lv]
        A = ell_to_csr(*d["A"], n, device, dtype)
        P = PT = None
        if lv > 0:
            P = ell_to_csr(*d["P"], n, device, dtype)
            PT = ell_to_csr(*d["PT"], sizes[lv - 1], device, dtype)
        groups = tuple(
            torch.as_tensor(np.unique(np.asarray(g)).astype(np.int32), device=device)
            for g in d["groups"]
        )
        diag = torch.as_tensor(np.array(d["diag"], dtype=np.float64)).to(device, dtype)
        lam = d["lam_max"]
        out.append(DeviceLevel(A, diag, P, PT, groups,
                               None if lam is None else float(lam)))
    C = torch.as_tensor(np.array(coarse_inv, dtype=np.float64)).to(device, dtype)
    return DeviceHierarchy(out, C)


def _t(a, device, dtype):
    return torch.as_tensor(np.array(a, dtype=np.float64)).to(device=device, dtype=dtype)


def bsr_hierarchy_from_jax(levels: list[dict], coarse_inv: np.ndarray, device,
                           dtype: torch.dtype) -> BsrHierarchy:
    """Build the port's BsrHierarchy from JAX BSR hierarchy leaves.

    Per level, ``levels[lv]`` is a dict with

        "indices": [n, w] int    ELL block-column ids of A
        "blocks":  [n, w, 3, 3]  ELL blocks of A
        "gather":  [n, w] int    the plan's ``ell_gather`` of the level
        "nnz":     int           the plan's ``nnz_out``: gather == nnz marks padding
        "diag":    [n, 3]
        "P", "PT": (indices, data) ELL of the scalar transfers, or None at level 0
        "lam_max": float or None

    Real slots, in row-major order, are the level's canonical CSR order.
    ``coarse_inv`` is the dense [3nc, 3nc] coarsest inverse.
    """
    sizes = [np.asarray(lv["diag"]).shape[0] for lv in levels]
    out = []
    for lv, d in enumerate(levels):
        n = sizes[lv]
        valid = np.asarray(d["gather"]) < int(d["nnz"])
        indptr = np.concatenate([[0], np.cumsum(valid.sum(axis=1))]).astype(np.int32)
        A = BSRMatrix(
            torch.as_tensor(indptr, device=device),
            torch.as_tensor(np.asarray(d["indices"])[valid].astype(np.int32), device=device),
            _t(np.asarray(d["blocks"])[valid], device, dtype).contiguous(),
            n,
        )
        P = PT = None
        if lv > 0:
            P = ell_to_csr(*d["P"], n, device, dtype)
            PT = ell_to_csr(*d["PT"], sizes[lv - 1], device, dtype)
        lam = d["lam_max"]
        out.append(BsrLevel(A, _t(d["diag"], device, dtype), P, PT,
                            None if lam is None else float(lam)))
    return BsrHierarchy(out, _t(coarse_inv, device, dtype))


def shell_state_from_jax(shell: ShellEnergy, abars: np.ndarray,
                         bbars: np.ndarray | None = None) -> ShellEnergy:
    """Give a port ShellEnergy the rest metrics ``abars`` [m, 2, 2] (and
    rest second fundamental forms ``bbars``) of a JAX ShellEnergy; returns it."""
    shell.abars = _t(abars, shell.device, torch.float64)
    if bbars is not None:
        shell.bbars = _t(bbars, shell.device, torch.float64)
    return shell


def _ell_rows_to_csr(idx, dat, keep, n_cols, device, dtype) -> tuple[CSRMatrix, np.ndarray]:
    """ELL rows -> CSR keeping the ``keep`` slots in row-major order (the
    order the JAX package filled them: its rows' CSR order); also returns
    the kept slots' flat positions."""
    idx, dat, keep = np.asarray(idx), np.asarray(dat, dtype=np.float64), np.asarray(keep)
    indptr = np.concatenate([[0], np.cumsum(keep.sum(axis=1))]).astype(np.int32)
    flat = np.flatnonzero(keep.reshape(-1))
    return CSRMatrix(
        torch.as_tensor(indptr, device=device),
        torch.as_tensor(idx.reshape(-1)[flat].astype(np.int32), device=device),
        _t(dat.reshape(-1)[flat], device, dtype),
        n_cols,
    ), flat


def halo_rank_from_jax(levels: list[dict], coarse_inv: np.ndarray, rank: int, D: int,
                       device, dtype: torch.dtype) -> tuple[list[HaloLevel], torch.Tensor]:
    """One rank's levels of the port's row-partitioned hierarchy from a JAX
    ``HaloHierarchy`` (numpy arrays of its ``levels`` and ``coarse_inv``).

    Per level, ``levels[lv]`` holds the device-stacked arrays: "send"
    [D, S], "A_idx" / "A_dat" [D*R, w] (ELL over the local address space),
    "diag" [D*R], "P_idx" / "P_dat" and "PT_idx" / "PT_dat" (None at the
    coarsest level), "lam_max", and the refresh maps "A_src" [D*R, w] and
    "diag_src" [D*R] (the JAX object's ``_A_srcs`` / ``_diag_srcs``). ELL
    padding is dropped: the A slots whose A_src is -1, and every
    zero-valued P / Pᵀ slot, as the JAX layout pads them. Returns the
    levels and this rank's rows of the coarse inverse."""
    sizes = [np.asarray(lv["diag"]).shape[0] // D for lv in levels]
    out = []
    for lv, d in enumerate(levels):
        R, send = sizes[lv], np.asarray(d["send"])
        S = send.shape[1]
        rows = slice(rank * R, (rank + 1) * R)
        idx, dat = np.asarray(d["A_idx"])[rows], np.asarray(d["A_dat"])[rows]
        src = np.asarray(d["A_src"])[rows]
        A, flat = _ell_rows_to_csr(idx, dat, src != -1, R + D * S, device, dtype)
        P = PT = None
        if d.get("P_idx") is not None:
            Rc, Sc = sizes[lv + 1], np.asarray(levels[lv + 1]["send"]).shape[1]
            pdat = np.asarray(d["P_dat"])[rows]
            P, _ = _ell_rows_to_csr(np.asarray(d["P_idx"])[rows], pdat, pdat != 0.0,
                                    Rc + D * Sc, device, dtype)
            crow = slice(rank * Rc, (rank + 1) * Rc)
            tdat = np.asarray(d["PT_dat"])[crow]
            PT, _ = _ell_rows_to_csr(np.asarray(d["PT_idx"])[crow], tdat, tdat != 0.0,
                                     R + D * S, device, dtype)
        ids = (lambda a: torch.as_tensor(np.array(a, dtype=np.int64), device=device))
        lam = d.get("lam_max")
        diag = _t(np.asarray(d["diag"])[rows], device, dtype)
        out.append(HaloLevel(R, S, ids(send[rank]), A, diag, ids(src.reshape(-1)[flat]),
                             ids(np.asarray(d["diag_src"])[rows]), P, PT, False,
                             None if lam is None else float(lam)))
    RL = sizes[-1]
    return out, _t(np.asarray(coarse_inv)[rank * RL:(rank + 1) * RL], device, dtype)
