"""The port's ``DeviceBalloonStepper`` against the JAX package's.

The setup of ``tests/test_balloon_stepper.py`` (icosphere(2), Young 6e4,
Poisson 0.3, pressure 1e3, the block hierarchy of ``mg_precompute_block``
with ``min_coarsest_nv=60``), in float64 on the CPU (the port's plain
versions); the port runs on the JAX hierarchy (``convert.mg_from_jax``)
and the JAX rest metrics (``convert.shell_state_from_jax``):

- two steps of 3 Newton iterations at tol 1e-8 against the JAX stepper:
  positions within 1e-8 max(1, max|disp|) (the bar of the port's scalar
  step against JAX, ``tests/test_torch_refresh.py``), velocities within
  1e-10 max|qdot| (the displacements are ~1e-6 at this pressure; the
  gap read 5e-15), the same ``last_rejected``; with bending, and without
  the PSD projection;
- against the port's ``implicit_euler_mg_balloon`` with the stepper's own
  ``newton_solver``, and the port's ``BsrBalloonStepper`` against it:
  positions within 1e-6 max|disp| and velocities within 1e-6 max|qdot|
  (the JAX tests' 1e-6, ``tests/test_balloon_stepper.py``,
  ``tests/test_bsr.py``, taken relative to the motion, since max|disp| is
  ~1e-6 here; the gaps read 0 and 3e-16);
- ``BalloonNewtonSolver.hessian_values`` on a tensor equals it on numpy;
- without ``device=`` and without a card, the stepper's shell raises.
"""

import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from surface_multigrid_code_tpu.models import balloon as jb
from surface_multigrid_code_tpu.models.shell import ShellEnergy as JShell
from surface_multigrid_code_tpu.solver.hierarchy import mg_precompute_block as jmg_block

from surface_multigrid_code_torch import mg_precompute, mg_precompute_block
from surface_multigrid_code_torch.convert import mg_from_jax, shell_state_from_jax
from surface_multigrid_code_torch.models import balloon as tb
from surface_multigrid_code_torch.models.shell import ShellEnergy, lame_parameters
from surface_multigrid_code_torch.utils.synthetic import icosphere

torch.set_num_threads(1)

DT = 1e-3


def _force(V, F):
    N = tb.vertex_normals(V, F)
    Mvd = np.asarray(tb.massmatrix(V, F, kind="voronoi").diagonal())
    return (-(N * Mvd[:, None]) * 1e3).reshape(-1)


def _setup(bending=False):
    V, F = icosphere(2)
    al, be = lame_parameters(6e4, 0.3)
    M = 1000.0 * tb.lumped_mass_matrix(V, F)
    shell = ShellEnergy(V, F, 0.1, al, be, "neohookean", bending=bending, device="cpu")
    return V, F, al, be, shell, M, _force(V, F)


def _steps(stepper, V, fExt, n=2):
    p, q = V.copy(), np.zeros(V.size)
    out = []
    for _ in range(n):
        p, q = stepper.step(p, q, fExt)
        out.append((p, q, stepper.last_rejected))
    return out


@pytest.mark.parametrize("bending,psd_project", [(False, True), (True, True), (False, False)])
def test_device_stepper_matches_jax(bending, psd_project):
    V, F, al, be, tshell, M, fExt = _setup(bending)
    jshell = JShell(V, F, 0.1, al, be, "neohookean", bending=bending)
    shell_state_from_jax(tshell, np.asarray(jshell.abars),
                         np.asarray(jshell.bbars) if bending else None)
    mgj = jmg_block(V, F, min_coarsest_nv=60, verbose=False)
    jstep = jb.DeviceBalloonStepper(jshell, M, mgj, DT, mg_tolerance=1e-8, n_newton=3,
                                    dtype=jnp.float64, psd_project=psd_project)
    tstep = tb.DeviceBalloonStepper(tshell, M, mg_from_jax(mgj), DT, mg_tolerance=1e-8,
                                    n_newton=3, psd_project=psd_project)
    assert tstep.dtype == torch.float64 and tstep.cfg.smoother.value == "chebyshev"
    assert tstep.newton_solver.psd_project is psd_project
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # a reject warns; the counts are compared
        js, ts = _steps(jstep, V, fExt), _steps(tstep, V, fExt)
    for (pj, qj, rj), (pt, qt, rt) in zip(js, ts):
        scale = max(1.0, np.abs(pj - V).max())
        assert np.isfinite(pt).all() and np.isfinite(qt).all()
        assert np.abs(pt - pj).max() < 1e-8 * scale
        # max|disp| is ~1e-6 here, so the velocities are held relative too
        assert np.abs(qt - qj).max() <= 1e-10 * np.abs(qj).max()
        assert rt == rj
    assert np.abs(ts[1][0] - V).max() > np.abs(ts[0][0] - V).max() > 0
    assert len(tstep.last_newton) == 3


def test_device_stepper_matches_host_step_and_bsr():
    V, F, _al, _be, shell, M, fExt = _setup()
    mg_b = mg_precompute_block(V, F, min_coarsest_nv=60, verbose=False)
    stepper = tb.DeviceBalloonStepper(shell, M, mg_b, DT, mg_tolerance=1e-8, n_newton=3)
    qdot0 = np.zeros(V.size)
    p1, q1 = stepper.step(V.copy(), qdot0, fExt)
    assert stepper.last_rejected == 0
    p2, q2, _ = tb.implicit_euler_mg_balloon(
        shell, M, V.copy(), qdot0, fExt, DT, mg_b, n_newton=3, mg_tolerance=1e-8,
        newton_solver=stepper.newton_solver, verbose=False)
    assert np.abs(p1 - p2).max() <= 1e-6 * np.abs(p2 - V).max()
    assert np.abs(q1 - q2).max() <= 1e-6 * np.abs(q2).max()
    # the BSR stepper on the scalar hierarchy of the same mesh
    bsr = tb.BsrBalloonStepper(shell, M, mg_precompute(V, F, min_coarsest_nv=60, verbose=False),
                               DT, mg_tolerance=1e-8, n_newton=3)
    p3, q3 = bsr.step(V.copy(), qdot0, fExt)
    assert np.abs(p3 - p1).max() <= 1e-6 * np.abs(p1 - V).max()
    assert np.abs(q3 - q1).max() <= 1e-6 * np.abs(q1).max()
    # a second step continues from the first
    p1b, _ = stepper.step(p1, q1, fExt)
    assert np.isfinite(p1b).all()
    assert np.abs(p1b - V).max() > np.abs(p1 - V).max() * 0.5


def test_hessian_values_takes_a_tensor():
    V, F, _al, _be, shell, M, _fExt = _setup(bending=True)
    ns = tb.BalloonNewtonSolver(shell, M, None, build_solver=False)
    x = V.reshape(-1) + 1e-3 * np.random.default_rng(0).standard_normal(V.size)
    a = ns.hessian_values(x, DT)
    b = ns.hessian_values(torch.as_tensor(x), DT)
    assert a.dtype == torch.float64 and torch.equal(a, b)
    raw = tb.BalloonNewtonSolver(shell, M, None, build_solver=False, psd_project=False)
    c = raw.hessian_values(torch.as_tensor(x), DT)
    assert c.shape == a.shape and not torch.equal(c, a)  # the projection clamps some faces


def test_device_stepper_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    V, F = icosphere(1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShellEnergy(V, F, 0.1, 1.0, 1.0, "neohookean")
