"""The port's refreshed scalar multigrid against the JAX package's.

Both packages run on one SSP hierarchy (the JAX ``mg_precompute``,
carried over by ``convert.mg_from_jax``) of a bumpy icosphere(3), on the
MCF system M - 0.01 L, in float64; the JAX ``RefreshableMGSolver`` with
``well=False`` (the plan-gather refresh), the port on its plain versions
(CPU tensors):

- the Galerkin value refresh: every level's values, diagonal and the
  coarse inverse against JAX ``_refresh_impl``, within 1e-12 relative;
- ``_device_lam_max`` on every smoothed level;
- ``RefreshableMGSolver.solve`` with Jacobi, multicolor GS and Chebyshev,
  and on the constrained path with C = 1 and C = 3 right-hand sides:
  r_his within rtol 1e-9, z within 1e-10 (to tol 1e-6 ||rhs||: the
  residuals then stay far above the f64 rounding of ||b - A z||, about
  1e-15 absolute here, which rtol 1e-9 could not hold near 1e-8);
- ``massmatrix_barycentric_diag`` against the JAX device twin and the
  host mass matrix;
- the balloon's scalar cross-check: one ``implicit_euler_mg_balloon``
  step on icosphere(2) within 1e-8 relative of the JAX package's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from surface_multigrid_code_tpu.config import SmootherType as JSmoother
from surface_multigrid_code_tpu.config import SolveConfig as JSolveConfig
from surface_multigrid_code_tpu.models import balloon as jb
from surface_multigrid_code_tpu.models.shell import ShellEnergy as JShell
from surface_multigrid_code_tpu.ops.laplacian import massmatrix_barycentric_diag_jax
from surface_multigrid_code_tpu.solver import refresh as jref
from surface_multigrid_code_tpu.solver.hierarchy import mg_precompute as jmg_precompute
from surface_multigrid_code_tpu.solver.hierarchy import mg_precompute_block as jmg_block

from surface_multigrid_code_torch.config import SmootherType, SolveConfig
from surface_multigrid_code_torch.convert import hierarchy_from_jax, mg_from_jax
from surface_multigrid_code_torch.convert import shell_state_from_jax
from surface_multigrid_code_torch.models import balloon as tb
from surface_multigrid_code_torch.models.shell import ShellEnergy, lame_parameters
from surface_multigrid_code_torch.ops.laplacian import (
    cotmatrix,
    massmatrix,
    massmatrix_barycentric_diag,
)
from surface_multigrid_code_torch.solver import refresh as tref
from surface_multigrid_code_torch.solver.vcycle import vcycle
from surface_multigrid_code_torch.utils.mesh import normalize_unit_area
from surface_multigrid_code_torch.utils.synthetic import icosphere

torch.set_num_threads(1)

SMOOTHERS = ["jacobi", "multicolor_gs", "chebyshev"]


def bumpy_sphere():
    """The bumpy icosphere(3) of tests/test_mcf.py."""
    V, F = icosphere(3)
    V = V * (1.0 + 0.1 * np.sin(5 * V[:, [0]]) * np.cos(5 * V[:, [1]]))
    return normalize_unit_area(V, F), F


@pytest.fixture(scope="module")
def system():
    """The bumpy sphere, its 3-level JAX hierarchy (642 / 162 / 42 V) and
    the port's copy, the MCF operator M - 0.01 L and its values."""
    V, F = bumpy_sphere()
    mgj = jmg_precompute(V, F, min_coarsest_nv=30, verbose=False)
    mgt = mg_from_jax(mgj)
    A = (massmatrix(V, F, kind="barycentric") - 0.01 * cotmatrix(V, F)).tocsr()
    A.sum_duplicates()
    return V, F, mgj, mgt, A


def _pair(system, smoother, known=None):
    _V, _F, mgj, mgt, A = system
    js = jref.RefreshableMGSolver(
        mgj, A, known=known, cfg=JSolveConfig(smoother=JSmoother(smoother)),
        dtype=jnp.float64, well=False)
    ts = tref.RefreshableMGSolver(
        mgt, A, known=known, cfg=SolveConfig(smoother=SmootherType(smoother)),
        dtype=torch.float64, device="cpu")
    return js, ts


def test_mg_from_jax_copies_the_hierarchy(system):
    _V, _F, mgj, mgt, _A = system
    assert len(mgt) == len(mgj) == 3
    for lt, lj in zip(mgt, mgj):
        assert np.array_equal(lt.V, lj.V) and np.array_equal(lt.F, lj.F)
        assert (lt.dec_type is None) == (lj.dec_type is None)
        if lt.dec_type is not None:
            assert int(lt.dec_type) == int(lj.dec_type) and lt.ratio == lj.ratio
    for lt, lj in zip(mgt[1:], mgj[1:]):
        assert (lt.P_full != lj.P_full).nnz == 0 and lt.P_full is not lj.P_full


@pytest.mark.parametrize("smoother", ["multicolor_gs", "chebyshev"])
def test_refresh_matches_jax(system, smoother):
    """Every level's values (the canonical CSR order of the level's
    pattern), diagonal, GS colors and Chebyshev bound, and the coarse
    inverse, against JAX ``_refresh_impl``."""
    _V, _F, _mgj, _mgt, A = system
    js, ts = _pair(system, smoother)
    vals = np.random.default_rng(5).uniform(0.5, 1.5) * A.data
    hj = js._refresh_impl(js._state, jnp.asarray(vals))
    ht = ts.refresh(torch.as_tensor(vals))
    plans = [js.plan.lvl0, *js.plan.levels]
    assert ht.n_levels == hj.n_levels == 3
    for lv, (lt, lj, pl_) in enumerate(zip(ht.levels, hj.levels, plans)):
        real = np.asarray(pl_.ell_gather) < pl_.nnz_out
        ref = np.asarray(lj.A.data)[real]
        scale = np.abs(ref).max()
        assert lt.A.data.shape == ref.shape
        assert np.abs(lt.A.data.numpy() - ref).max() <= 1e-12 * scale
        assert np.array_equal(lt.A.indices.numpy(), np.asarray(lj.A.indices)[real])
        assert np.abs(lt.diag.numpy() - np.asarray(lj.diag)).max() <= 1e-12 * scale
        if lv < 2 and smoother == "multicolor_gs":
            assert [np.unique(np.asarray(g)).tolist() for g in lj.groups] == \
                [g.tolist() for g in lt.groups]
        if lj.lam_max is None:
            assert lt.lam_max is None
        else:
            assert abs(lt.lam_max - float(lj.lam_max)) <= 1e-12 * float(lj.lam_max)
    cinv = np.asarray(hj.coarse_inv)
    assert np.abs(ht.coarse_inv.numpy() - cinv).max() <= 1e-12 * np.abs(cinv).max()

    # the JAX hierarchy through hierarchy_from_jax: one V-cycle on each
    ell = (lambda E: None if E is None else (np.asarray(E.indices), np.asarray(E.data)))
    leaves = [{"A": ell(lv.A), "P": ell(lv.P), "PT": ell(lv.PT), "diag": np.asarray(lv.diag),
               "groups": [np.asarray(g) for g in lv.groups],
               "lam_max": None if lv.lam_max is None else float(lv.lam_max)}
              for lv in hj.levels]
    hc = hierarchy_from_jax(leaves, cinv, "cpu", torch.float64)
    rng = np.random.default_rng(6)
    b, u = (torch.as_tensor(rng.standard_normal(A.shape[0])) for _ in range(2))
    yc = vcycle(hc, b, u, ts.cfg)
    yt = vcycle(ht, b, u, ts.cfg)
    assert (yt - yc).abs().max() <= 1e-12 * yc.abs().max()


@pytest.mark.parametrize("level", [0, 1])
def test_device_lam_max_matches_jax(system, level):
    _V, _F, _mgj, _mgt, A = system
    js, ts = _pair(system, "jacobi")
    hj = js._refresh_impl(js._state, jnp.asarray(A.data))
    ht = ts.refresh(torch.as_tensor(A.data))
    ref = float(jref._device_lam_max(hj.levels[level].A, hj.levels[level].diag))
    got = float(tref._device_lam_max(ht.levels[level].A, ht.levels[level].diag))
    assert abs(got - ref) <= 1e-12 * ref
    assert 1.0 < got < 2.5  # lam_max(D^-1 A) of an SPD matrix, x1.1


@pytest.mark.parametrize("smoother", SMOOTHERS)
def test_solve_matches_jax(system, smoother):
    _V, _F, _mgj, _mgt, A = system
    js, ts = _pair(system, smoother)
    rng = np.random.default_rng(7)
    rhs = rng.standard_normal(A.shape[0])
    z0 = rng.standard_normal(A.shape[0])
    tol = 1e-6 * np.linalg.norm(rhs)
    zj, rj, okj = js.solve(A.data, rhs, z0=z0, tolerance=tol, max_iter=20)
    zt, rt, okt = ts.solve(A.data, rhs, z0=z0, tolerance=tol, max_iter=20)
    assert okt and okj and len(rt) == len(rj) > 3
    np.testing.assert_allclose(rt, rj, rtol=1e-9)
    assert np.abs(zt - zj).max() <= 1e-10


@pytest.mark.parametrize("C", [1, 3])
def test_constrained_solve_matches_jax(system, C):
    """The known path: P row-sliced and pruned, A_uu / A_uk gathered from
    the full values, the known values folded into the right-hand side."""
    V, _F, _mgj, _mgt, A = system
    rng = np.random.default_rng(11 + C)
    known = np.sort(rng.choice(V.shape[0], size=25, replace=False))
    shp = (V.shape[0],) if C == 1 else (V.shape[0], C)
    rhs = rng.standard_normal(shp)
    kv = rng.standard_normal((known.size,) + shp[1:])
    js, ts = _pair(system, "multicolor_gs", known=known)
    assert np.array_equal(ts.unknown, js.unknown)
    tol = 1e-6 * np.linalg.norm(rhs)
    zj, rj, okj = js.solve(A.data, rhs, known_val=kv, tolerance=tol, max_iter=20)
    zt, rt, okt = ts.solve(A.data, rhs, known_val=kv, tolerance=tol, max_iter=20)
    assert okt and okj and len(rt) == len(rj) > 3
    np.testing.assert_allclose(rt, rj, rtol=1e-9)
    assert zt.shape == shp and np.array_equal(zt[known], kv)
    assert np.abs(zt - zj).max() <= 1e-10
    # the unknowns solve A_uu z_u = rhs_u - A_uk kv
    u = ts.unknown
    r = rhs[u] - A[u][:, known] @ kv - A[u][:, u] @ zt[u]
    assert np.linalg.norm(r) <= tol


def test_massmatrix_barycentric_diag(system):
    V, F, _mgj, _mgt, _A = system
    got = massmatrix_barycentric_diag(torch.as_tensor(V), torch.as_tensor(F)).numpy()
    ref = np.asarray(massmatrix_barycentric_diag_jax(jnp.asarray(V), jnp.asarray(F)))
    host = massmatrix(V, F, kind="barycentric").diagonal()
    assert np.abs(got - ref).max() <= 1e-15 * np.abs(ref).max()
    assert np.abs(got - host).max() <= 1e-15 * np.abs(host).max()
    assert abs(got.sum() - 1.0) < 1e-12  # unit area


def test_refreshable_solver_default_device_is_the_card(system):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    _V, _F, _mgj, mgt, A = system
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tref.RefreshableMGSolver(mgt, A)


def test_scalar_balloon_step_matches_jax():
    """One implicit_euler_mg_balloon step (3 Newton iterations, multicolor
    GS on the 3-expanded hierarchy) from rest at the example-06 settings."""
    V, F = icosphere(2)
    al, be = lame_parameters(6e6, 0.5)
    M = 1000.0 * tb.lumped_mass_matrix(V, F)
    fExt = tb.inflation_force(V, F, 1e6)
    jshell = JShell(V, F, 0.1, al, be, "neohookean")
    tshell = shell_state_from_jax(ShellEnergy(V, F, 0.1, al, be, "neohookean", device="cpu"),
                                  np.asarray(jshell.abars))
    mgj = jmg_block(V, F, min_coarsest_nv=10, verbose=False)
    mgt = mg_from_jax(mgj)
    assert len(mgt) == 3 and mgt[1].P_full.shape == (3 * V.shape[0], 3 * mgt[1].V.shape[0])
    qdot0 = np.zeros(V.size)
    pj, qj, _ = jb.implicit_euler_mg_balloon(jshell, M, V.copy(), qdot0, fExt, 1e-3, mgj,
                                             n_newton=3, verbose=False)
    pt, qt, ns = tb.implicit_euler_mg_balloon(tshell, M, V.copy(), qdot0, fExt, 1e-3, mgt,
                                              n_newton=3, verbose=False)
    assert ns.dtype == torch.float64 and ns.solver.cfg.smoother == SmootherType.MULTICOLOR_GS
    assert [r["found"] for r in ns.last_newton] == [True] * 3
    assert all(r["converged"] for r in ns.last_newton)
    disp = np.abs(pj - V).max()
    assert disp > 1e-4
    assert np.abs(pt - pj).max() <= 1e-8 * disp
    assert np.abs(qt - qj).max() <= 1e-8 * np.abs(qj).max()
