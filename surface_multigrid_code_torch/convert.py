"""Carry a JAX-package device hierarchy into the port.

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
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from surface_multigrid_code_torch.ops.sparse import CSRMatrix, csr_from_scipy
from surface_multigrid_code_torch.solver.vcycle import DeviceHierarchy, DeviceLevel


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
