"""The port's band-segment halo hierarchy and spmd against the JAX package's.

``parallel/wellhalo.py`` (``WellHaloHierarchy``) and ``parallel/spmd.py``
of the port run on the ranks of one ``parallel.comm.RankPool`` of four
gloo ranks on the CPU (module scope; a task on D = 2 runs on a subgroup
of two), with the plain versions of K1/K2 in float64
(``tests/torch_parallel_ranks.py``). The JAX side runs in the pytest
process on the conftest's 8 virtual CPU devices (``make_row_mesh``), its
Pallas kernels in interpret mode, each object built once per module. The
value refresh is tested in ``test_torch_wellhalo_refresh.py``, the
``"well"`` steppers in ``test_torch_wellhalo_steppers.py`` (three files,
so that a parallel test run spreads the JAX compiles over workers).

- (a) the plan: the ordering, and per level the extents, which equal the
  JAX ``_col_extents`` on the JAX package's permuted matrices at the
  port's R = ceil(n / D) (no B_ROWS), and the mode rule; at D = 4 all three
  modes are in play;
- (b) ``solve`` at D = 2 and 4, Jacobi and Chebyshev, against the JAX
  ``WellHaloHierarchy.solve``: histories within rtol 1e-10, z within
  1e-10. The JAX object's Chebyshev bounds are set to the port's (both
  estimate them by a host power iteration from a random start, in the
  JAX package on the permuted levels, in the port on the levels as given);
- (g) ``spmd.sharded_solve`` at D = 4 against the JAX one;
- (h) ``Comm.shift`` against slicing the whole vector, first and last
  rank included; multicolor Gauss-Seidel and ``backend="well"`` with
  ``reorder=False`` raise; one MCF step is the same with ``"well"``,
  ``"halo"`` and ``"halo"`` with ``reorder=False``; the entry points raise
  without ``device=`` on a machine with no card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from surface_multigrid_code_tpu.config import SmootherType as JSmoother
from surface_multigrid_code_tpu.config import SolveConfig as JSolveConfig
from surface_multigrid_code_tpu.parallel import spmd as jspmd
from surface_multigrid_code_tpu.parallel.wellhalo import WellHaloHierarchy as JWell
from surface_multigrid_code_tpu.parallel.wellhalo import _col_extents as jextents
from surface_multigrid_code_tpu.solver.ordering import finest_rcm as jrcm
from surface_multigrid_code_tpu.solver.ordering import induced_orderings as jinduced
from surface_multigrid_code_tpu.solver.ordering import permute_hierarchy as jpermute

from surface_multigrid_code_torch.config import SmootherType, SolveConfig
from surface_multigrid_code_torch.parallel.comm import RankPool
from surface_multigrid_code_torch.parallel.wellhalo import WellHaloHierarchy
from surface_multigrid_code_torch.solver.vcycle import _power_iteration_lam_max

import torch_parallel_ranks as ranks
from tests.test_halo import hierarchy_system
from tests.test_torch_parallel import same_history

TOL = 1e-10
SOLVE_TOL = 1e-8


@pytest.fixture(scope="module")
def pool():
    with RankPool(4, "gloo", "cpu", timeout=300) as p:
        yield p


@pytest.fixture(scope="module")
def system():
    return hierarchy_system(depth=3)


def _cfg(smoother):
    return JSolveConfig(smoother=JSmoother(smoother))


def _mode(lo, hi, lpt, hpt, R, last):
    """The JAX mode rule (wellhalo.py:211-224) without the B_ROWS rounding:
    (lo, hi, replicated, column-partitioned restriction)."""
    mlo, mhi = max(lo, lpt), max(hi, hpt)
    if mlo <= R and mhi <= R:
        return (mlo, mhi, False, False)
    if lo <= R and hi <= R:
        return (lo, hi, False, not last)
    return (0, 0, True, False)


@pytest.mark.parametrize("D", [2, 4])
def test_plan_matches_jax(pool, system, D):
    As, Ps, _ = system
    plan = pool.run(ranks.well_plan, D, As, Ps)[0]
    perms = jinduced(jrcm(As[0].tocsr()), Ps)
    jAs, jPs = jpermute(As, Ps, perms)
    assert np.array_equal(plan["perm0"], perms[0])
    L = len(As)
    Rs = [-(-A.shape[0] // D) for A in As]
    assert plan["Rs"] == Rs
    modes = []
    for lv in range(L):
        lo, hi = jextents(jAs[lv], Rs[lv], Rs[lv], D)
        if lv > 0:
            l2, h2 = jextents(jPs[lv - 1], Rs[lv - 1], Rs[lv], D)
            lo, hi = max(lo, l2), max(hi, h2)
        lpt, hpt = (jextents(jPs[lv].T.tocsr(), Rs[lv + 1], Rs[lv], D) if lv < L - 1
                    else (0, 0))
        assert tuple(plan["extents"][lv]) == (lo, hi), lv
        assert tuple(plan["pt_extents"][lv]) == (lpt, hpt), lv
        modes.append(_mode(lo, hi, lpt, hpt, Rs[lv], lv == L - 1))
    assert [tuple(m) for m in plan["modes"]] == modes
    reps, ptcols = [m[2] for m in modes], [m[3] for m in modes]
    if D == 4:  # all three modes in play (tests/test_wellhalo.py:35-37)
        assert any(reps) and not all(reps) and any(ptcols), modes
    else:
        assert not any(reps) and not any(ptcols), modes


@pytest.fixture(scope="module")
def jax_solves(system):
    """The JAX WellHaloHierarchy solves per (D, smoother), with the port's
    Chebyshev bounds (module docstring)."""
    As, Ps, rhs = system
    lams = [_power_iteration_lam_max(A.tocsr()) for A in As[:-1]]
    out = {}
    for D in (2, 4):
        for sm in ("jacobi", "chebyshev"):
            j = JWell(As, Ps, jspmd.make_row_mesh(D), cfg=_cfg(sm), dtype=jnp.float64)
            if sm == "chebyshev":
                for lv, lam in zip(j.levels, lams):
                    lv["lam_max"] = jnp.asarray(lam, dtype=jnp.float64)
            out[D, sm] = j.solve(rhs, tolerance=SOLVE_TOL, max_iter=40)
    return out


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("smoother", ["jacobi", "chebyshev"])
def test_solve_matches_jax(pool, system, jax_solves, smoother, D):
    As, Ps, rhs = system
    z, r_his, ok = pool.run(ranks.well_solve, D, As, Ps, smoother, rhs, SOLVE_TOL, 40)[0]
    zj, rj, okj = jax_solves[D, smoother]
    assert ok and okj
    same_history(r_his, rj)
    np.testing.assert_allclose(z, zj, rtol=0, atol=TOL)
    assert np.linalg.norm(As[0] @ z - rhs) < SOLVE_TOL


def test_spmd_sharded_solve_matches_jax(pool, system):
    As, Ps, rhs = system
    mesh = jspmd.make_row_mesh(4)
    hj, sizes_j = jspmd.build_sharded_hierarchy(As, Ps, mesh, dtype=jnp.float64)
    zj, rj, kj = jspmd.sharded_solve(hj, sizes_j, mesh, rhs, tolerance=SOLVE_TOL, max_iter=40,
                                     dtype=jnp.float64)
    (z, r_his, k), sizes = pool.run(ranks.spmd_solve, 4, As, Ps, rhs, SOLVE_TOL, 40)[0]
    assert sizes == list(sizes_j) and k == kj
    same_history(r_his, rj)
    np.testing.assert_allclose(z, np.asarray(zj), rtol=0, atol=TOL)


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("lo, hi, C", [(3, 2, 1), (0, 5, 2), (5, 0, 1), (7, 7, 3)])
def test_shift_is_the_slice(pool, D, lo, hi, C):
    for got, want, counts in pool.run(ranks.shift, D, 7, lo, hi, C):
        assert got.shape == want.shape and np.array_equal(got, want)
        assert counts == {"shift": 1}


def test_multicolor_gs_raises(system):
    As, Ps, _ = system
    with pytest.raises(ValueError, match="multicolor"):
        WellHaloHierarchy(As, Ps, SolveConfig(smoother=SmootherType.MULTICOLOR_GS),
                          device="cpu")


def test_well_without_reorder_raises(system):
    from surface_multigrid_code_torch.parallel.wellhalo import galerkin_hierarchy

    As, Ps, _ = system
    with pytest.raises(ValueError, match="reorder=False"):
        galerkin_hierarchy(As[0], Ps, SolveConfig(smoother=SmootherType.JACOBI),
                           torch.float64, "cpu", None, "well", reorder=False)


def test_mcf_backends_and_orderings_agree(pool):
    """Jacobi smoothing and the exact coarse solve do not depend on the row
    order, so one MCF step is the same with backend "well", "halo" and
    "halo" with reorder=False (a subdivided icosahedron, f64)."""
    from surface_multigrid_code_torch.solver.hierarchy import MGLevel
    from surface_multigrid_code_torch.utils.mesh import normalize_unit_area
    from surface_multigrid_code_torch.utils.synthetic import subdivision_hierarchy

    meshes, Psub = subdivision_hierarchy(3)
    mg = [MGLevel(V=V, F=F, P_full=P) for (V, F), P in zip(meshes, [None, *Psub])]
    V, F = meshes[0]
    V = normalize_unit_area(V, F)
    (U0, r0, ok0), *others = pool.run(ranks.mcf_backends, 4, V, F, mg)[0]
    assert ok0
    for U, r_his, ok in others:
        assert ok
        same_history(r_his, r0)
        np.testing.assert_allclose(U, U0, rtol=0, atol=TOL)


def test_default_device_is_the_card(pool, system):
    from surface_multigrid_code_torch.solver.hierarchy import MGLevel
    from surface_multigrid_code_torch.utils.synthetic import subdivision_hierarchy

    As, Ps, _ = system
    meshes, Psub = subdivision_hierarchy(2)
    mg = [MGLevel(V=V, F=F, P_full=P) for (V, F), P in zip(meshes, [None, *Psub])]
    for msgs in pool.run(ranks.well_default_device, 2, As, Ps, *meshes[0], mg):
        assert len(msgs) == 3
        for msg in msgs:
            assert msg is not None and "device 'cuda'" in msg and "device='cpu'" in msg
