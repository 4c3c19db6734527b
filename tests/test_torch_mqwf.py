"""The slice end to end: the port's min_quad_with_fixed_mg_* against the JAX package's.

Both packages build their hierarchy from the same SSP / subdivision levels
and solve with the same explicit dtype; the JAX side runs its ELL V-cycle
(the CPU default, no windowed kernel). In f64 the residual histories agree
to rtol 1e-8, with the same cycle count, and z to 1e-8 relative. Entries
near the end of a history sit close to the f64 roundoff floor of
||b - Az||, which the two summation orders move by about
eps ||(|b| + |A||z|)||; the comparison allows 16 times that, absolutely.
"""

import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from surface_multigrid_code_tpu.config import SmootherType as JSmoother
from surface_multigrid_code_tpu.config import SolveConfig as JSolveConfig
from surface_multigrid_code_tpu.ops.laplacian import cotmatrix, massmatrix
from surface_multigrid_code_tpu.solver import mqwf_mg as jmq
from surface_multigrid_code_tpu.solver.hierarchy import MGLevel as JMGLevel
from surface_multigrid_code_tpu.solver.hierarchy import mg_precompute as jax_mg_precompute
from surface_multigrid_code_tpu.utils.synthetic import icosphere, subdivision_hierarchy

from surface_multigrid_code_torch import (
    SolveConfig,
    mg_precompute,
    min_quad_with_fixed_mg_precompute,
    min_quad_with_fixed_mg_solve,
)
from surface_multigrid_code_torch.config import SmootherType
from surface_multigrid_code_torch.solver.hierarchy import MGLevel
from surface_multigrid_code_torch.utils.mesh import normalize_unit_area
from surface_multigrid_code_torch.utils.obj_io import read_obj
from surface_multigrid_code_torch.utils.paths import mesh_path

torch.set_num_threads(1)


def _subdiv_mgs(n_subdiv):
    """tests/test_vcycle.py::build_mg for both packages."""
    meshes, Ps = subdivision_hierarchy(n_subdiv)
    out = []
    for cls in (JMGLevel, MGLevel):
        mg = [cls(V=meshes[0][0], F=meshes[0][1])]
        for lv in range(1, len(meshes)):
            P = Ps[lv - 1].tocsr()
            mg.append(cls(V=meshes[lv][0], F=meshes[lv][1], P_full=P, P=P,
                          PT=P.T.tocsr()))
        out.append(mg)
    return out


def _solve_both(A, known, mgs, smoother, RHS, dtype, **solve_kw):
    jmg, tmg = mgs
    jd = jmq.min_quad_with_fixed_mg_precompute(
        A, known, jmg, cfg=JSolveConfig(smoother=JSmoother(smoother)),
        dtype=jnp.float64 if dtype == torch.float64 else jnp.float32,
    )
    td = min_quad_with_fixed_mg_precompute(
        A, known, tmg, SolveConfig(smoother=SmootherType(smoother)),
        device="cpu", dtype=dtype,
    )
    jz, jr, jok = jmq.min_quad_with_fixed_mg_solve(jd, RHS, **solve_kw)
    tz, tr, tok = min_quad_with_fixed_mg_solve(td, RHS, **solve_kw)
    return (jz, jr, jok), (tz, tr, tok)


def _assert_same(j, t, A, RHS):
    (jz, jr, jok), (tz, tr, tok) = j, t
    assert jok and tok, (jr, tr)
    assert len(jr) == len(tr)
    floor = 16 * np.finfo(np.float64).eps * np.linalg.norm(
        np.abs(RHS) + abs(A) @ np.abs(jz))
    np.testing.assert_allclose(tr, jr, rtol=1e-8, atol=floor)
    assert np.linalg.norm(tz - jz) <= 1e-8 * np.linalg.norm(jz)


@pytest.fixture(scope="module")
def ico4():
    V, F = icosphere(4)
    mg = jax_mg_precompute(V, F, verbose=False)
    M = massmatrix(V, F)
    A = (M - 0.01 * cotmatrix(V, F)).tocsr()
    return V, F, mg, A, M


@pytest.mark.parametrize("smoother", ["jacobi", "multicolor_gs"])
def test_unconstrained_icosphere4(ico4, smoother):
    V, F, mg, A, M = ico4
    B = np.asarray(M @ V[:, 0])
    mgs = (copy.deepcopy(mg), copy.deepcopy(mg))
    j, t = _solve_both(A, None, mgs, smoother, B, torch.float64,
                       tolerance=1e-10 * np.linalg.norm(B))
    _assert_same(j, t, A, B)


def test_constrained_matches_jax():
    """The constrained case of tests/test_vcycle.py::test_constrained_solve_matches_direct."""
    mgs = _subdiv_mgs(3)
    V, F = mgs[0][0].V, mgs[0][0].F
    A = (-cotmatrix(V, F)).tocsr()
    n = A.shape[0]
    rng = np.random.default_rng(1)
    known = np.sort(rng.choice(n, size=12, replace=False))
    known_val = rng.normal(size=12)
    B = massmatrix(V, F, "barycentric") @ np.ones(n)
    j, t = _solve_both(A, known, mgs, "multicolor_gs", B, torch.float64,
                       known_val=known_val, tolerance=1e-10, max_iter=40)
    _assert_same(j, t, A, B)
    np.testing.assert_array_equal(t[0][known], known_val)


def test_multicolumn_rhs_matches_jax():
    mgs = _subdiv_mgs(3)
    V, F = mgs[0][0].V, mgs[0][0].F
    A = (-cotmatrix(V, F) + 1e-2 * massmatrix(V, F, "barycentric")).tocsr()
    B = np.random.default_rng(2).normal(size=(A.shape[0], 3))
    j, t = _solve_both(A, None, mgs, "multicolor_gs", B, torch.float64,
                       tolerance=1e-8, max_iter=40)
    assert t[0].shape == B.shape
    _assert_same(j, t, A, B)


def test_refinement_ex04_shape():
    """ex04: bunny, vertices nearest the hilbert_cube_known markers known,
    random z0, tol 1e-10, an f32 hierarchy on both sides: both engage f64
    iterative refinement and converge within one cycle of each other (the
    two f32 summation orders differ, so the histories are not compared
    entry by entry)."""
    V, F = read_obj(mesh_path("bunny"))
    Vk, _ = read_obj(mesh_path("hilbert_cube_known"))
    known = np.unique(((V[None, :, :] - Vk[:, None, :]) ** 2).sum(-1).argmin(axis=1))
    V = normalize_unit_area(V, F)
    mg = mg_precompute(V, F, verbose=False)
    A = (-cotmatrix(V, F)).tocsr()
    B = np.asarray(massmatrix(V, F) @ np.ones(V.shape[0]))
    B[known] = 0.0
    z0 = np.random.default_rng(0).uniform(-1, 1, V.shape[0])
    jmg = [JMGLevel(**{k: getattr(lv, k) for k in ("V", "F", "P_full", "P", "PT")})
           for lv in mg]
    (jz, jr, jok), (tz, tr, tok) = _solve_both(
        A, known, (jmg, copy.deepcopy(mg)), "multicolor_gs", B, torch.float32,
        known_val=np.zeros(known.size), z0=z0, tolerance=1e-10,
    )
    assert jok and tok, (jr, tr)
    assert abs(len(jr) - len(tr)) <= 1
    assert tr[-1] <= 1e-10 and jr[-1] <= 1e-10
    # f32 cycles but f64 refinement: far below the f32 floor of ~1e-6 r0
    assert tr[-1] < 1e-9 * tr[0]
    assert np.linalg.norm(tz - jz) <= 1e-6 * np.linalg.norm(jz)
