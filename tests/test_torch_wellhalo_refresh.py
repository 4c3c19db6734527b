"""The port's sharded Galerkin value refresh against the JAX package's.

``WellHaloHierarchy.enable_refresh`` / ``solve_values`` (``parallel/
wellhalo.py``) on the ranks of a ``RankPool`` of four gloo ranks on the
CPU, plain K1/K2 in float64, against the JAX ``WellHaloHierarchy`` on the
conftest's 8 virtual CPU devices (as ``test_torch_wellhalo.py``), on
``tests/test_wellhalo.py::_refreshable_system(depth=3)``:

- (c) ``solve_values`` with both value sets, Jacobi and Chebyshev, at
  D = 4: histories within rtol 1e-10, z within 1e-10 (the refreshed
  Chebyshev bounds come from the same sharded power iteration in both);
  each rank's refreshed values of every level equal its slice of the
  port's replicated ``refresh_values`` within 1e-12 of the level's
  largest value (the G chain sums in another order), and the ranks'
  ranges cover every level's nnz once;
- (d) an [n, 2] right-hand side in ``solve_values``.

max_iter is 20 where ``tests/test_wellhalo.py`` uses 12: Chebyshev needs
more cycles to reach 1e-8 on the first value set, in both packages.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from surface_multigrid_code_tpu.config import SmootherType as JSmoother
from surface_multigrid_code_tpu.config import SolveConfig as JSolveConfig
from surface_multigrid_code_tpu.parallel.spmd import make_row_mesh
from surface_multigrid_code_tpu.parallel.wellhalo import WellHaloHierarchy as JWell

from surface_multigrid_code_torch.parallel.comm import RankPool

import torch_parallel_ranks as ranks
from tests.test_torch_parallel import same_history
from tests.test_wellhalo import _refreshable_system

TOL = 1e-10
SOLVE_TOL = 1e-8
VALUES_TOL = 1e-12


@pytest.fixture(scope="module")
def pool():
    with RankPool(4, "gloo", "cpu", timeout=300) as p:
        yield p


@pytest.fixture(scope="module")
def refreshable():
    return _refreshable_system(depth=3)


def _cfg(smoother):
    return JSolveConfig(smoother=JSmoother(smoother))


@pytest.fixture(scope="module")
def jax_values(refreshable):
    """The JAX solve_values on D = 4: both value sets per smoother, and an
    [n, 2] right-hand side with Jacobi."""
    As, Ps, vals1, vals2, rhs = refreshable
    out = {}
    for sm in ("jacobi", "chebyshev"):
        j = JWell(As, Ps, make_row_mesh(4), cfg=_cfg(sm),
                  dtype=jnp.float64).enable_refresh()
        out[sm] = [j.solve_values(v, rhs, tolerance=SOLVE_TOL, max_iter=20)
                   for v in (vals1, vals2)]
        if sm == "jacobi":
            out["columns"] = j.solve_values(vals2, np.stack([rhs, 0.3 * rhs + 0.1], axis=1),
                                            tolerance=SOLVE_TOL, max_iter=20)
    return out


@pytest.mark.parametrize("smoother", ["jacobi", "chebyshev"])
def test_solve_values_matches_jax(pool, refreshable, jax_values, smoother):
    As, Ps, vals1, vals2, rhs = refreshable
    got = pool.run(ranks.well_solve_values, 4, As, Ps, smoother, [vals1, vals2], rhs,
                   SOLVE_TOL, 20)
    for k, vals in enumerate((vals1, vals2)):
        zj, rj, okj = jax_values[smoother][k]
        (z, r_his, ok), _, _ = got[0][k]
        assert ok and okj, (r_his, rj)
        same_history(r_his, rj)
        np.testing.assert_allclose(z, zj, rtol=0, atol=TOL)
        A = As[0].copy()
        A.data = np.asarray(vals, dtype=np.float64)
        assert np.linalg.norm(A @ z - rhs) < SOLVE_TOL
        # each rank refreshed its own nnz range of every level, and only it
        sizes = np.array([rank_out[k][2] for rank_out in got])
        assert np.array_equal(sizes.sum(axis=0), [A.nnz for A in As])
        for rank_out in got:
            assert max(rank_out[k][1]) <= VALUES_TOL, rank_out[k][1]


def test_solve_values_multicolumn_matches_jax(pool, refreshable, jax_values):
    As, Ps, _, vals2, rhs = refreshable
    RHS = np.stack([rhs, 0.3 * rhs + 0.1], axis=1)
    (z, r_his, ok), _, _ = pool.run(ranks.well_solve_values, 4, As, Ps, "jacobi", [vals2], RHS,
                                    SOLVE_TOL, 20)[0][0]
    zj, rj, okj = jax_values["columns"]
    assert ok and okj and z.shape == RHS.shape
    same_history(r_his, rj)
    np.testing.assert_allclose(z, zj, rtol=0, atol=TOL)
