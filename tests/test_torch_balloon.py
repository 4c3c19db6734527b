"""The port's balloon step against the JAX package's, the whole slice end to end.

One ``BsrBalloonStepper.step`` of 3 Newton iterations at the reference's
operating point (example 06: Young 6e6, Poisson 0.5, pressure 1e6, where
the per-face PSD projection clamps) on icosphere(2), in float64, with
``coarsest_nv`` passed on both sides (the default depends on the backend).
The JAX stepper runs with ``well=False`` (the plan-gather refresh, XLA
block SpMV), the port on its plain versions. Positions must agree within
1e-6 max(1, max|disp|), the tolerance of ``tests/test_balloon_stepper.py``.
"""

import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from surface_multigrid_code_tpu.models import balloon as jb
from surface_multigrid_code_tpu.models.shell import ShellEnergy as JShell
from surface_multigrid_code_tpu.solver.hierarchy import mg_precompute as jmg_precompute

from surface_multigrid_code_torch import mg_precompute, mg_precompute_block
from surface_multigrid_code_torch.convert import shell_state_from_jax
from surface_multigrid_code_torch.models import balloon as tb
from surface_multigrid_code_torch.models.shell import ShellEnergy, lame_parameters
from surface_multigrid_code_torch.utils.synthetic import icosphere

torch.set_num_threads(1)

DT = 1e-3


def _setup():
    V, F = icosphere(2)
    al, be = lame_parameters(6e6, 0.5)
    M = 1000.0 * tb.lumped_mass_matrix(V, F)
    assert (M != 1000.0 * jb.lumped_mass_matrix(V, F)).nnz == 0
    fExt = tb.inflation_force(V, F, 1e6)
    N = jb.vertex_normals(V, F)
    assert np.array_equal(N, tb.vertex_normals(V, F))
    return V, F, al, be, M, fExt


@pytest.mark.parametrize("bending", [False, True])
def test_bsr_balloon_step_matches_jax(bending):
    V, F, al, be, M, fExt = _setup()
    jshell = JShell(V, F, 0.1, al, be, "neohookean", bending=bending)
    tshell = shell_state_from_jax(
        ShellEnergy(V, F, 0.1, al, be, "neohookean", bending=bending, device="cpu"),
        np.asarray(jshell.abars), None if not bending else np.asarray(jshell.bbars))
    jstep = jb.BsrBalloonStepper(
        jshell, M, jmg_precompute(V, F, min_coarsest_nv=40, verbose=False), DT,
        n_newton=3, dtype=jnp.float64, well=False, coarsest_nv=0)
    tstep = tb.BsrBalloonStepper(
        tshell, M, mg_precompute(V, F, min_coarsest_nv=40, verbose=False), DT,
        n_newton=3, dtype=torch.float64, coarsest_nv=0)
    assert tstep.solver.plan.lvl0.nnz_out == jstep.pattern.nnz
    qdot0 = np.zeros(3 * V.shape[0])
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message="balloon step")  # no rejects
        pj, qj = jstep.step(V.copy(), qdot0, fExt)
        pt, qt = tstep.step(V.copy(), qdot0, fExt)
    assert jstep.last_rejected == tstep.last_rejected == 0
    assert len(tstep.last_newton) == 3
    assert all(r["converged"] for r in tstep.last_newton)
    disp = np.abs(pj - V).max()
    assert disp > 1e-4
    assert np.abs(pt - pj).max() < 1e-6 * max(1.0, disp)
    assert np.abs(qt - qj).max() < 1e-6 * max(1.0, np.abs(qj).max())


def test_frozen_state_guard_keeps_qdot_bitwise():
    """A direction that fails every line-search trial leaves qdot bitwise
    unchanged and is counted, with a warning."""
    V, F, al, be, M, fExt = _setup()
    shell = ShellEnergy(V, F, 0.1, al, be, "neohookean", device="cpu")
    step = tb.BsrBalloonStepper(
        shell, M, mg_precompute(V, F, min_coarsest_nv=40, verbose=False), DT,
        n_newton=2, coarsest_nv=0)
    solve = tb.bsr_solve_loop

    def bad_solve(hier, rhs, z0, tol, max_iter, cfg):
        z, r, k = solve(hier, rhs, z0, tol, max_iter, cfg)
        return torch.full_like(z, float("inf")), r, k

    qdot0 = np.random.default_rng(0).standard_normal(3 * V.shape[0]) * 1e-3
    tb.bsr_solve_loop = bad_solve
    try:
        with pytest.warns(UserWarning, match="2 Newton iteration"):
            p, q = step.step(V.copy(), qdot0, fExt)
    finally:
        tb.bsr_solve_loop = solve
    assert step.last_rejected == 2
    assert np.array_equal(q, qdot0)
    assert np.array_equal(p, V + DT * qdot0.reshape(-1, 3))


def test_run_balloon_defaults_and_scalar_solver():
    V, F = icosphere(1)
    stats = []
    out = list(tb.run_balloon(V, F, n_steps=2, n_newton=2, verbose=False, device="cpu",
                              mg=mg_precompute(V, F, min_coarsest_nv=10, verbose=False),
                              stats=stats))
    assert len(out) == len(stats) == 2
    assert all(np.isfinite(p).all() for p in out)
    assert [s["last_rejected"] for s in stats] == [0, 0]
    assert np.abs(out[1] - V).max() > np.abs(out[0] - V).max() > 0
    # the scalar cross-check: the 3-expanded hierarchy, multicolor GS
    stats = []
    out = list(tb.run_balloon(V, F, solver="scalar", n_steps=2, n_newton=2, verbose=False,
                              device="cpu", stats=stats,
                              mg=mg_precompute_block(V, F, min_coarsest_nv=10, verbose=False)))
    assert len(out) == len(stats) == 2
    assert all(p.shape == V.shape and np.isfinite(p).all() for p in out)
    assert [s["last_rejected"] for s in stats] == [0, 0]
    assert all(len(s["newton"]) == 2 and np.isfinite(s["qdot"]).all() for s in stats)
    assert np.abs(out[1] - V).max() > np.abs(out[0] - V).max() > 0
    with pytest.raises(ValueError, match="unknown solver"):
        next(tb.run_balloon(V, F, solver="dense", verbose=False, device="cpu"))


def test_run_balloon_default_device_is_the_card():
    """Without a CUDA device, the default device raises at the first step;
    there is no fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    V, F = icosphere(1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(tb.run_balloon(V, F, verbose=False))
