"""The port's ``backend="well"`` sharded steppers against the JAX package's.

``ShardedMCFStepper`` and ``ShardedBalloonNewton`` with the band-segment
backend (``parallel/wellhalo.py``, the sharded value refresh) on the
ranks of a ``RankPool`` of four gloo ranks on the CPU, plain K1/K2 in
float64, against the JAX ``backend="well"`` on the conftest's 8 virtual
CPU devices (its Pallas kernels in interpret mode):

- (e) ``ShardedMCFStepper``, one step on ogre_sim (2,612 V, 150 boundary
  vertices): histories within rtol 1e-10, positions within 1e-10;
- (f) ``ShardedBalloonNewton``: the stiff direction of
  ``tests/test_balloon_sharded.py:32`` (exact-zero stored entries) at
  atol 1e-10.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from surface_multigrid_code_tpu.config import SmootherType as JSmoother
from surface_multigrid_code_tpu.config import SolveConfig as JSolveConfig
from surface_multigrid_code_tpu.models.balloon import lumped_mass_matrix as jlumped
from surface_multigrid_code_tpu.models.balloon import vertex_normals as jnormals
from surface_multigrid_code_tpu.models.shell import ShellEnergy as JShellEnergy
from surface_multigrid_code_tpu.models.shell import lame_parameters as jlame
from surface_multigrid_code_tpu.ops.laplacian import massmatrix as jmass
from surface_multigrid_code_tpu.parallel.balloon import ShardedBalloonNewton as JBalloon
from surface_multigrid_code_tpu.parallel.mcf import ShardedMCFStepper as JMCF
from surface_multigrid_code_tpu.parallel.spmd import make_row_mesh
from surface_multigrid_code_tpu.solver.hierarchy import mg_precompute as jmg_precompute
from surface_multigrid_code_tpu.solver.hierarchy import mg_precompute_block as jmg_block
from surface_multigrid_code_tpu.utils.mesh import normalize_unit_area as jnormalize
from surface_multigrid_code_tpu.utils.obj_io import read_obj as jread
from surface_multigrid_code_tpu.utils.paths import mesh_path as jpath
from surface_multigrid_code_tpu.utils.synthetic import icosphere as jico

from surface_multigrid_code_torch.convert import mg_from_jax
from surface_multigrid_code_torch.parallel.comm import RankPool

import torch_parallel_ranks as ranks
from tests.test_torch_parallel import same_history

TOL = 1e-10


@pytest.fixture(scope="module")
def pool():
    with RankPool(4, "gloo", "cpu", timeout=300) as p:
        yield p


def test_sharded_mcf_well_matches_jax(pool):
    V, F = jread(jpath("ogre_sim"))
    V = jnormalize(V, F)
    mgj = jmg_precompute(V, F, verbose=False)
    Uj, rj, okj = JMCF(V, F, mgj, make_row_mesh(4), cfg=JSolveConfig(smoother=JSmoother.JACOBI),
                       dtype=jnp.float64).step(V.copy())
    U, r_his, ok = pool.run(ranks.mcf_step, 4, V, F, mg_from_jax(mgj), "well")[0]
    assert ok == okj
    same_history(r_his, rj)
    np.testing.assert_allclose(U, Uj, rtol=0, atol=TOL)


def test_sharded_balloon_well_matches_jax(pool):
    """The stiff rest-state direction (young 6e6, poisson 0.5 - 1e-3), whose
    Hessian stores exact zeros, against the JAX "well" backend."""
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
    jns = JBalloon(shell, M, mgj, make_row_mesh(4), dt)
    dxj, rj, okj = jns.solve(jns.hessian_values(V.reshape(-1), dt), g, tolerance=1e-9,
                             max_iter=20)
    dx, r_his, ok, _, _ = pool.run(ranks.balloon, 4, V, F, young, poisson, mg_from_jax(mgj),
                                   dt, pressure, 1e-9, 0, 1e-8, "well")[0]
    assert ok and okj, (r_his, rj)
    assert len(r_his) == len(rj)
    np.testing.assert_allclose(dx, np.asarray(dxj), rtol=0, atol=TOL)
