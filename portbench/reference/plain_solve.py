"""A plain solver of the reference, in a chosen precision, to stand in the program's place.

It makes the control of ``control.py``: the reference computed in the
precision just below the one the configuration states (float32 for a
float64 configuration), next to the same solver in the stated precision,
which has to pass. Plain PyTorch on the run's device: a
Jacobi-preconditioned conjugate gradient on ``torch.sparse_csr_tensor``
products, each column its own CG.
"""

from __future__ import annotations

import warnings

import numpy as np
import scipy.sparse as sp
import torch


class Operator:
    """A on the device in ``dtype`` (its float64 values rounded once)."""

    def __init__(self, A: sp.csr_matrix, device, dtype):
        A = A.tocsr()
        vals = torch.as_tensor(A.data).to(device=device, dtype=dtype)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)  # "sparse CSR support is in beta"
            self.A = torch.sparse_csr_tensor(torch.as_tensor(A.indptr, device=device),
                                             torch.as_tensor(A.indices, device=device), vals,
                                             size=A.shape, check_invariants=False)
        self.dinv = 1.0 / torch.as_tensor(A.diagonal()).to(device=device, dtype=dtype)

    def __call__(self, x):
        return self.A @ x


def pcg(op: Operator, b: torch.Tensor, x0: torch.Tensor, tol: float, max_iter: int,
        replace_every: int = 10):
    """Jacobi-preconditioned CG on each column of b [n, C] from x0, stopped
    when ||b - A x||_F, computed in the solver's precision, is below tol.
    Every ``replace_every`` iterations the recurred residual is replaced by
    b - A x (residual replacement), so the stop tests the true residual of
    that precision and not one that has drifted from it. Where that
    precision cannot reach tol, the iterate with the least such residual is
    returned. Returns (x, iterations, its residual)."""
    x = x0.clone()
    r = b - op(x)
    res = float(torch.linalg.norm(r))
    best = (res, x.clone())
    z = op.dinv[:, None] * r
    p = z.clone()
    rz = (r * z).sum(dim=0)
    it = 0
    while it < max_iter and res > tol:
        Ap = op(p)
        alpha = rz / (p * Ap).sum(dim=0)
        x += alpha * p
        r -= alpha * Ap
        it += 1
        if it % replace_every == 0:
            r = b - op(x)
            res = float(torch.linalg.norm(r))
            if res < best[0]:
                best = (res, x.clone())
        z = op.dinv[:, None] * r
        rz_new = (r * z).sum(dim=0)
        p = z + (rz_new / rz) * p
        rz = rz_new
    return best[1], it, best[0]


def solve_control(A: sp.csr_matrix, mass: np.ndarray, U: np.ndarray, tol: float, max_iter: int,
                  device, dtype):
    """Z of A Z = M U by ``pcg`` in ``dtype``, from Z = 0, to the absolute
    tol on ||M U - A Z||_F. Returns (Z float64 numpy, iterations)."""
    op = Operator(A, device, dtype)
    Ud = torch.as_tensor(U).to(device=device, dtype=dtype)
    B = torch.as_tensor(mass).to(device=device, dtype=dtype)[:, None] * Ud
    Z, it, _ = pcg(op, B, torch.zeros_like(B), tol, max_iter)
    return Z.to("cpu", torch.float64).numpy(), it
