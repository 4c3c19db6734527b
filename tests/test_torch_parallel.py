"""The port's row-partitioned paths against the JAX package's halo paths.

The port's ranks are processes of one ``parallel.comm.RankPool`` of four
gloo ranks on the CPU (module scope, so process start-up is paid once); a
task on D = 2 runs on a subgroup of two of them. They run the plain
versions of K1/K2 in float64 (``tests/torch_parallel_ranks.py``). The JAX
side runs in the pytest process on the conftest's 8 virtual CPU devices
(``make_row_mesh``), each object built once per module.

- (a) the plan, ``reorder=False`` in both packages, every restriction
  row-partitioned: the send tables equal the JAX plan's bit for bit, and
  each rank's CSR blocks and refresh maps equal ``convert.
  halo_rank_from_jax`` of the JAX plan;
- (b) ``solve`` on ``subdivision_hierarchy(3)``, Jacobi and Chebyshev,
  D = 2 and 4, every restriction row-partitioned and every one
  column-partitioned: residual histories within rtol 1e-10 of the JAX
  ``HaloHierarchy(reorder=True)``, z within 1e-10. The JAX object's
  Chebyshev bounds are set to the port's: both estimate them by a host
  power iteration from one random start, which lands on a slightly
  different estimate in each package's ordering (the port estimates on
  the levels as given, as its single-device hierarchy does);
- (c) the multi-column right-hand side; (d) ``solve_values``;
- (e) the column-partitioned restriction against the plain Pᵀ r;
- (f) ``ShardedMCFStepper`` on ogre_sim (2,612 V, 150 boundary vertices)
  against the JAX ``ShardedMCFStepper(backend="halo")``, one step;
- (g) the stiff Newton direction of ``tests/test_balloon_sharded.py:32``
  (exact-zero stored entries) against the JAX
  ``ShardedBalloonNewton(backend="halo")`` at atol 1e-10, and one sharded
  implicit-Euler step with n_newton = 3;
- (h) multicolor Gauss-Seidel raises.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from surface_multigrid_code_tpu.config import SmootherType as JSmoother
from surface_multigrid_code_tpu.config import SolveConfig as JSolveConfig
from surface_multigrid_code_tpu.models.shell import ShellEnergy as JShellEnergy
from surface_multigrid_code_tpu.models.shell import lame_parameters as jlame
from surface_multigrid_code_tpu.parallel.balloon import ShardedBalloonNewton as JBalloon
from surface_multigrid_code_tpu.parallel.balloon import (
    implicit_euler_mg_balloon_sharded as jballoon_step,
)
from surface_multigrid_code_tpu.parallel.halo import HaloHierarchy as JHalo
from surface_multigrid_code_tpu.parallel.mcf import ShardedMCFStepper as JMCF
from surface_multigrid_code_tpu.parallel.spmd import make_row_mesh
from surface_multigrid_code_tpu.models.balloon import lumped_mass_matrix as jlumped
from surface_multigrid_code_tpu.models.balloon import vertex_normals as jnormals
from surface_multigrid_code_tpu.ops.laplacian import massmatrix as jmass
from surface_multigrid_code_tpu.solver.hierarchy import mg_precompute as jmg_precompute
from surface_multigrid_code_tpu.solver.hierarchy import mg_precompute_block as jmg_block
from surface_multigrid_code_tpu.utils.mesh import normalize_unit_area as jnormalize
from surface_multigrid_code_tpu.utils.obj_io import read_obj as jread
from surface_multigrid_code_tpu.utils.paths import mesh_path as jpath
from surface_multigrid_code_tpu.utils.synthetic import icosphere as jico

from surface_multigrid_code_torch.config import SmootherType, SolveConfig
from surface_multigrid_code_torch.convert import halo_rank_from_jax, mg_from_jax
from surface_multigrid_code_torch.parallel.comm import RankPool
from surface_multigrid_code_torch.parallel.halo import HaloHierarchy

import torch_parallel_ranks as ranks
from tests.test_halo import hierarchy_system

TOL = 1e-10
SOLVE_TOL = 1e-6


def same_history(r_his, rj):
    """Residual histories within rtol TOL. An entry ||b - A z|| sums terms
    of the size of ||b|| whatever its own size, so two summation orders
    differ by f64 rounding of ||b|| (3e-17 at ||b|| = 0.65 here, 5e-10 of
    an entry at 6e-8): entries are also held within 1e-15 of the first."""
    assert len(r_his) == len(rj) > 3, (r_his, rj)
    np.testing.assert_allclose(r_his, rj, rtol=TOL, atol=1e-15 * rj[0])
ROWS = {"rows": 0, "columns": 10**9}  # COLUMN_RESTRICT_ROWS forcing each partition


@pytest.fixture(scope="module")
def pool():
    with RankPool(4, "gloo", "cpu", timeout=300) as p:
        yield p


@pytest.fixture(scope="module")
def system():
    return hierarchy_system(depth=3)


def _jax(As, Ps, D, smoother, **kw):
    return JHalo(As, Ps, make_row_mesh(D), cfg=JSolveConfig(smoother=JSmoother(smoother)),
                 dtype=jnp.float64, **kw)


def _np(x):
    return None if x is None else np.asarray(x)


@pytest.mark.parametrize("D", [2, 4])
def test_plan_matches_jax(pool, system, D):
    As, Ps, _ = system
    j = _jax(As, Ps, D, "chebyshev", reorder=False)
    got = pool.run(ranks.plan, D, As, Ps, "chebyshev", ROWS["rows"], False)
    jlevels = [dict({k: _np(v) for k, v in lv.items() if k not in ("R", "S")},
                    A_src=j._A_srcs[i], diag_src=j._diag_srcs[i])
               for i, lv in enumerate(j.levels)]
    for rank, mine in enumerate(got):
        assert not any(mine["pt_cols"])
        for lv, send in enumerate(mine["sends"]):
            assert send.dtype == np.int64
            assert np.array_equal(send, jlevels[lv]["send"]), lv
        theirs, _ = halo_rank_from_jax(jlevels, np.asarray(j.coarse_inv), rank, D, "cpu",
                                       torch.float64)
        for lv, (a, b) in enumerate(zip(mine["levels"], theirs)):
            assert (a["R"], a["S"]) == (b.R, b.S)
            assert np.array_equal(a["send"], b.send.numpy())
            for name in ("A", "P", "PT"):
                x, y = a[name], getattr(b, name)
                assert (x is None) == (y is None), (lv, name)
                if x is not None:
                    for u, v in zip(x, (y.indptr, y.indices, y.data)):
                        assert np.array_equal(u, v.numpy()), (lv, name)
            assert np.array_equal(a["diag"], b.diag.numpy())
            assert np.array_equal(a["A_src"], b.A_src.numpy())
            assert np.array_equal(a["diag_src"], b.diag_src.numpy())


@pytest.fixture(scope="module")
def jax_solves(system):
    """The JAX reorder=True solves, per (D, smoother), with the port's
    Chebyshev bounds (module docstring)."""
    from surface_multigrid_code_torch.solver.vcycle import _power_iteration_lam_max

    As, Ps, rhs = system
    lams = [_power_iteration_lam_max(A.tocsr()) for A in As]
    out = {}
    for D in (2, 4):
        for sm in ("jacobi", "chebyshev"):
            j = _jax(As, Ps, D, sm)
            if sm == "chebyshev":
                for lv, lam in zip(j.levels, lams):
                    lv["lam_max"] = jnp.asarray(lam, dtype=jnp.float64)
            out[D, sm] = j.solve(rhs, tolerance=SOLVE_TOL, max_iter=40)
    return out


@pytest.mark.parametrize("restriction", ["rows", "columns"])
@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("smoother", ["jacobi", "chebyshev"])
def test_solve_matches_jax(pool, system, jax_solves, smoother, D, restriction):
    As, Ps, rhs = system
    z, r_his, ok, lams, pt_cols = pool.run(ranks.solve, D, As, Ps, smoother, ROWS[restriction],
                                           rhs, SOLVE_TOL, 40)[0]
    assert pt_cols[:-1] == [restriction == "columns"] * (len(As) - 1)
    zj, rj, okj = jax_solves[D, smoother]
    assert ok and okj
    same_history(r_his, rj)
    np.testing.assert_allclose(z, zj, rtol=0, atol=TOL)


def test_multicolumn_solve_matches_jax(pool, system):
    As, Ps, rhs = system
    rhs3 = np.stack([rhs, -2 * rhs, 0.5 * rhs], axis=1)
    zj, rj, okj = _jax(As, Ps, 4, "jacobi").solve(rhs3, tolerance=SOLVE_TOL, max_iter=40)
    z, r_his, ok, _, _ = pool.run(ranks.solve, 4, As, Ps, "jacobi", None, rhs3, SOLVE_TOL,
                                  40)[0]
    assert ok and okj
    same_history(r_his, rj)
    np.testing.assert_allclose(z, zj, rtol=0, atol=TOL)


@pytest.mark.parametrize("smoother", ["jacobi", "chebyshev"])
def test_solve_values_matches_jax(pool, system, smoother):
    """A value refresh to the system M - 0.05 L on the hierarchy of
    M - 0.01 L (the chain of tests/test_halo_refresh.py)."""
    from surface_multigrid_code_tpu.ops.laplacian import cotmatrix as jcot
    from surface_multigrid_code_tpu.utils.synthetic import subdivision_hierarchy as jsub

    As, Ps, rhs = system
    V, F = jsub(3)[0][0]
    A2 = (jmass(V, F) - 0.05 * jcot(V, F)).tocsr()
    A2.sum_duplicates()
    A0 = As[0].tocsr().copy()
    A0.sum_duplicates()
    assert np.array_equal(A2.indices, A0.indices) and np.array_equal(A2.indptr, A0.indptr)
    j = _jax(As, Ps, 4, smoother).enable_refresh()
    zj, rj, okj = j.solve_values(jnp.asarray(A2.data), rhs, tolerance=SOLVE_TOL, max_iter=40)
    z, r_his, ok = pool.run(ranks.solve_values, 4, As, Ps, smoother, A2.data, rhs, SOLVE_TOL,
                            40)[0]
    assert ok and okj
    same_history(r_his, rj)
    np.testing.assert_allclose(z, zj, rtol=0, atol=TOL)
    assert np.linalg.norm(A2 @ z - rhs) < SOLVE_TOL


@pytest.mark.parametrize("D", [2, 4])
def test_column_partitioned_restriction_is_the_plain_product(pool, system, D):
    As, Ps, _ = system
    for per_rank in pool.run(ranks.restrict, D, As, Ps, ROWS["columns"], 5):
        assert [c for c, _, _ in per_rank] == [True] * (len(As) - 1)
        for _, err, scale in per_rank:
            assert err <= 1e-14 * scale


def test_sharded_mcf_matches_jax(pool):
    V, F = jread(jpath("ogre_sim"))
    V = jnormalize(V, F)
    mgj = jmg_precompute(V, F, verbose=False)
    cfg = JSolveConfig(smoother=JSmoother.JACOBI)
    Uj, rj, okj = JMCF(V, F, mgj, make_row_mesh(4), cfg=cfg, dtype=jnp.float64,
                       backend="halo").step(V.copy())
    U, r_his, ok = pool.run(ranks.mcf_step, 4, V, F, mg_from_jax(mgj))[0]
    assert ok and okj
    same_history(r_his, rj)
    np.testing.assert_allclose(U, Uj, rtol=0, atol=TOL)


def test_sharded_balloon_matches_jax(pool):
    """The stiff rest-state Hessian (young 6e6, poisson 0.5 - 1e-3) stores
    exact zeros, which must keep their slots through the identity pad and
    the refresh maps. Then one implicit-Euler step of 3 Newton iterations
    at mg tolerance 1e-8 in both packages."""
    V, F = jico(2)
    young, poisson, dt, pressure = 6e6, 0.5 - 1e-3, 1e-3, 1e6
    alpha, beta = jlame(young, poisson)
    shell = JShellEnergy(V, F, 0.1, alpha, beta, "neohookean")
    M = 1000.0 * jlumped(V, F)
    mgj = jmg_block(V, F, min_coarsest_nv=60, verbose=False)
    N = jnormals(V, F)
    Mvd = np.asarray(jmass(V, F, kind="voronoi").diagonal())
    fExt = (-(N * Mvd[:, None]) * pressure).reshape(-1)
    g = -(dt * shell.gradient(V.reshape(-1)) + dt * fExt)
    jns = JBalloon(shell, M, mgj, make_row_mesh(4), dt, backend="halo")
    vals = jns.hessian_values(V.reshape(-1), dt)
    dxj, rj, okj = jns.solve(vals, g, tolerance=1e-9, max_iter=20)
    pj, _, _ = jballoon_step(shell, M, V.copy(), np.zeros(3 * V.shape[0]), fExt, dt, mgj,
                             make_row_mesh(4), mg_tolerance=1e-8, n_newton=3,
                             newton_solver=jns, verbose=False)
    dx, r_his, ok, pos, newton = pool.run(ranks.balloon, 4, V, F, young, poisson,
                                          mg_from_jax(mgj), dt, pressure, 1e-9, 3, 1e-8)[0]
    assert ok and okj, (r_his, rj)
    np.testing.assert_allclose(dx, np.asarray(dxj), rtol=0, atol=TOL)
    assert all(rec["found"] for rec in newton), newton
    scale = max(1.0, np.abs(pj - V).max())
    assert np.abs(pos - pj).max() < TOL * scale


def test_default_device_is_the_card(pool, system):
    """Like every entry point of the port, the sharded ones run on the card
    unless given device="cpu": without one they raise on every rank."""
    from surface_multigrid_code_torch.solver.hierarchy import MGLevel
    from surface_multigrid_code_torch.utils.synthetic import subdivision_hierarchy

    As, Ps, _ = system
    meshes, Psub = subdivision_hierarchy(2)
    mg = [MGLevel(V=V, F=F, P_full=P) for (V, F), P in zip(meshes, [None, *Psub])]
    for msgs in pool.run(ranks.default_device, 2, As, Ps, *meshes[0], mg):
        assert len(msgs) == 2
        for msg in msgs:
            assert msg is not None and "device 'cuda'" in msg and "device='cpu'" in msg


def test_multicolor_gs_raises(system):
    As, Ps, _ = system
    with pytest.raises(ValueError, match="multicolor"):
        HaloHierarchy(As, Ps, SolveConfig(smoother=SmootherType.MULTICOLOR_GS), device="cpu")
