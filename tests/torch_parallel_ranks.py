"""Rank-side tasks of ``tests/test_torch_parallel.py`` and ``tests/test_torch_wellhalo*.py``.

Each runs on the ranks of a ``parallel.comm.RankPool`` as
``fn(group, device, *args)``; the ranks import this module (not the test
file, which imports jax), so it imports torch, numpy and the port only.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from surface_multigrid_code_torch.config import SmootherType, SolveConfig
from surface_multigrid_code_torch.parallel import halo


@contextlib.contextmanager
def column_rows(rows):
    """``halo.COLUMN_RESTRICT_ROWS`` set to ``rows`` (None: as it is)."""
    keep = halo.COLUMN_RESTRICT_ROWS
    halo.COLUMN_RESTRICT_ROWS = keep if rows is None else rows
    try:
        yield
    finally:
        halo.COLUMN_RESTRICT_ROWS = keep


def _hier(group, dev, As, Ps, smoother, rows=None, reorder=True):
    with column_rows(rows):
        return halo.HaloHierarchy(As, Ps, SolveConfig(smoother=SmootherType(smoother)),
                                  torch.float64, dev, group, reorder=reorder)


def _csr(M):
    return None if M is None else (M.indptr.numpy(), M.indices.numpy(), M.data.numpy())


def plan(group, dev, As, Ps, smoother, rows, reorder):
    """Every level's send table, and this rank's CSR blocks and maps."""
    h = _hier(group, dev, As, Ps, smoother, rows, reorder)
    return {"sends": h.sends, "pt_cols": h.pt_cols, "levels": [
        {"R": lv.R, "S": lv.S, "send": lv.send.numpy(), "A": _csr(lv.A), "P": _csr(lv.P),
         "PT": _csr(lv.PT), "diag": lv.diag.numpy(), "A_src": lv.A_src.numpy(),
         "diag_src": lv.diag_src.numpy(), "lam_max": lv.lam_max} for lv in h.levels]}


def solve(group, dev, As, Ps, smoother, rows, rhs, tol, max_iter):
    h = _hier(group, dev, As, Ps, smoother, rows)
    z, r_his, ok = h.solve(rhs, tolerance=tol, max_iter=max_iter)
    return z, r_his, ok, [lv.lam_max for lv in h.levels], h.pt_cols


def solve_values(group, dev, As, Ps, smoother, vals, rhs, tol, max_iter):
    h = _hier(group, dev, As, Ps, smoother).enable_refresh()
    return h.solve_values(vals, rhs, tolerance=tol, max_iter=max_iter)


def restrict(group, dev, As, Ps, rows, seed):
    """Every restriction of the hierarchy on this rank's rows of a random
    fine vector, both partitions as the threshold ``rows`` picks them,
    against the plain product Pᵀ r of the whole (reordered) level."""
    h = _hier(group, dev, As, Ps, "jacobi", rows)
    out = []
    for lv in range(len(h.levels) - 1):
        fine, coarse = h.levels[lv], h.levels[lv + 1]
        n = h._As[lv].shape[0]
        r = np.zeros(fine.R * h.D)
        r[:n] = np.random.default_rng(seed + lv).standard_normal(n)
        r_l = torch.as_tensor(r[h.rank * fine.R:(h.rank + 1) * fine.R])
        if fine.pt_cols:
            part = h.comm.allreduce_sum(halo.fused_spmv(fine.PT, r_l))
            rc = part[h.rank * coarse.R:(h.rank + 1) * coarse.R]
        else:
            rc = halo.fused_spmv(fine.PT, h.comm.exchange(r_l, fine.send))
        got = h.comm.gather_rows(rc).numpy()[:h._As[lv + 1].shape[0]]
        want = h._Ps[lv].T @ r[:n]
        out.append((fine.pt_cols, float(np.abs(got - want).max()), float(np.abs(want).max())))
    return out


def mcf_step(group, dev, V, F, mg, backend="halo"):
    from surface_multigrid_code_torch.parallel.mcf import ShardedMCFStepper

    st = ShardedMCFStepper(V, F, mg, cfg=SolveConfig(smoother=SmootherType.JACOBI),
                           dtype=torch.float64, device=dev, group=group, backend=backend)
    return st.step(V.copy())


def balloon(group, dev, V, F, young, poisson, mg, dt, pressure, g_tol, n_newton, step_tol,
            backend="halo"):
    """The Newton direction of H dx = g at rest (g of the inflated rest
    state), then one sharded implicit-Euler step from rest."""
    from surface_multigrid_code_torch.models.balloon import inflation_force, lumped_mass_matrix
    from surface_multigrid_code_torch.models.shell import ShellEnergy, lame_parameters
    from surface_multigrid_code_torch.parallel.balloon import (
        ShardedBalloonNewton,
        implicit_euler_mg_balloon_sharded,
    )

    alpha, beta = lame_parameters(young, poisson)
    shell = ShellEnergy(V, F, 0.1, alpha, beta, "neohookean", device=dev)
    M = 1000.0 * lumped_mass_matrix(V, F)
    fExt = inflation_force(V, F, pressure)
    ns = ShardedBalloonNewton(shell, M, mg, dt, group=group, backend=backend)
    g = -(dt * shell.gradient(V.reshape(-1)) + dt * fExt)
    vals = ns.hessian_values(V.reshape(-1), dt)
    dx, r_his, ok = ns.solve(vals, g, tolerance=g_tol, max_iter=20)
    pos, qdot, _ = implicit_euler_mg_balloon_sharded(
        shell, M, V.copy(), np.zeros(3 * V.shape[0]), fExt, dt, mg, group,
        mg_tolerance=step_tol, n_newton=n_newton, newton_solver=ns, verbose=False)
    return dx, r_his, ok, pos, ns.last_newton


def default_device(group, dev, As, Ps, V, F, mg):
    """What HaloHierarchy and ShardedMCFStepper raise when no device is
    given on a machine without a card (None where one did not raise)."""
    from surface_multigrid_code_torch.parallel.mcf import ShardedMCFStepper

    out = []
    for build in (lambda: halo.HaloHierarchy(As, Ps, group=group),
                  lambda: ShardedMCFStepper(V, F, mg, group=group, backend="halo")):
        try:
            build()
            out.append(None)
        except RuntimeError as e:
            out.append(str(e))
    return out


# ------------------------------------------------ tests/test_torch_wellhalo*.py
def _well(group, dev, As, Ps, smoother):
    from surface_multigrid_code_torch.parallel.wellhalo import WellHaloHierarchy

    return WellHaloHierarchy(As, Ps, SolveConfig(smoother=SmootherType(smoother)),
                             torch.float64, dev, group)


def well_plan(group, dev, As, Ps):
    """The plan: ordering, R, extents and mode of every level."""
    h = _well(group, dev, As, Ps, "jacobi")
    return {"perm0": h.perm0, "Rs": h.Rs, "extents": h.extents, "pt_extents": h.pt_extents,
            "modes": [(lv.lo, lv.hi, lv.rep, lv.pt_cols) for lv in h.levels]}


def well_solve(group, dev, As, Ps, smoother, rhs, tol, max_iter):
    return _well(group, dev, As, Ps, smoother).solve(rhs, tolerance=tol, max_iter=max_iter)


def well_solve_values(group, dev, As, Ps, smoother, value_sets, rhs, tol, max_iter):
    """solve_values for each value set, and this rank's refreshed values of
    every level against its slice of the replicated refresh_values."""
    from surface_multigrid_code_torch.solver.galerkin import (
        build_galerkin_plan,
        device_plan,
        refresh_values,
    )

    h = _well(group, dev, As, Ps, smoother).enable_refresh()
    plans = device_plan(build_galerkin_plan(h._As[0], h._Ps), h._As[0], dev, torch.float64)
    perm = halo.nnz_order(h._A0_orig, h._As[0], h.perm0)
    out = []
    for vals in value_sets:
        mine = h.level_values(vals)
        ref = refresh_values(plans, torch.as_tensor(np.asarray(vals)[perm]))
        gaps = []
        for lv, (v, (r, _)) in enumerate(zip(mine, ref)):
            b = h._refresh["bounds"][lv]
            want = r[b[h.rank]:b[h.rank + 1]]
            gaps.append(float((v - want).abs().max() / r.abs().max()) if v.numel() else 0.0)
        out.append((h.solve_values(vals, rhs, tolerance=tol, max_iter=max_iter), gaps,
                    [v.shape[0] for v in mine]))
    return out


def spmd_solve(group, dev, As, Ps, rhs, tol, max_iter):
    from surface_multigrid_code_torch.parallel.spmd import build_sharded_hierarchy, sharded_solve

    hier, sizes = build_sharded_hierarchy(As, Ps, dtype=torch.float64, device=dev, group=group)
    return sharded_solve(hier, sizes, rhs, tolerance=tol, max_iter=max_iter), sizes


def shift(group, dev, n_rows, lo, hi, C):
    """Comm.shift of this rank's block of a known vector, and the slice of
    the whole vector it must equal (zeros outside it)."""
    from surface_multigrid_code_torch.parallel.comm import Comm

    comm = Comm(group)
    whole = np.arange(comm.size * n_rows * C, dtype=np.float64).reshape(-1, C) + 1.0
    r0 = comm.rank * n_rows
    got = comm.shift(torch.as_tensor(whole[r0:r0 + n_rows]).to(dev), lo, hi)
    padded = np.concatenate([np.zeros((lo, C)), whole, np.zeros((hi, C))])
    return got.cpu().numpy(), padded[r0:r0 + lo + n_rows + hi], dict(comm.counts)


def well_default_device(group, dev, As, Ps, V, F, mg):
    """What WellHaloHierarchy, build_sharded_hierarchy and the "well"
    MCF stepper raise when no device is given on a machine without a card."""
    from surface_multigrid_code_torch.parallel.mcf import ShardedMCFStepper
    from surface_multigrid_code_torch.parallel.spmd import build_sharded_hierarchy
    from surface_multigrid_code_torch.parallel.wellhalo import WellHaloHierarchy

    out = []
    for build in (lambda: WellHaloHierarchy(As, Ps, group=group),
                  lambda: build_sharded_hierarchy(As, Ps, group=group),
                  lambda: ShardedMCFStepper(V, F, mg, group=group)):
        try:
            build()
            out.append(None)
        except RuntimeError as e:
            out.append(str(e))
    return out


def mcf_backends(group, dev, V, F, mg):
    """One MCF step (Jacobi, f64) with backend "well", "halo" and "halo"
    without reordering."""
    from surface_multigrid_code_torch.parallel.mcf import ShardedMCFStepper

    out = []
    for backend, reorder in (("well", True), ("halo", True), ("halo", False)):
        st = ShardedMCFStepper(V, F, mg, mg_tol=1e-10, cfg=SolveConfig(smoother=SmootherType.JACOBI),
                               dtype=torch.float64, device=dev, group=group, reorder=reorder,
                               backend=backend)
        out.append(st.step(V.copy()))
    return out
