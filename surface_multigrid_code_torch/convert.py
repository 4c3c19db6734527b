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
