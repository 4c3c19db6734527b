"""The port's mean-curvature flow against the JAX package's, the slice end to end.

``MCFStepper`` of both packages on one hierarchy (the JAX
``mg_precompute`` of the bumpy icosphere(3) of ``tests/test_mcf.py``,
carried over by ``convert.mg_from_jax``), in float64: the JAX stepper
with ``well=False`` (the plan-gather refresh), the port on its plain
versions (CPU tensors). Three steps: r_his within rtol 1e-9, U within
1e-10 absolute. Then the port's counterparts of ``tests/test_mcf.py``:
one step against the host-assembled solve, and the flow smoothing the
surface at unit area. The stepper, like every entry point of the port,
runs on the card unless the caller asks for the CPU.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from surface_multigrid_code_tpu.models.mcf import MCFStepper as JMCFStepper
from surface_multigrid_code_tpu.solver.hierarchy import mg_precompute as jmg_precompute

from surface_multigrid_code_torch import MCFStepper, min_quad_with_fixed_mg_precompute
from surface_multigrid_code_torch import min_quad_with_fixed_mg_solve
from surface_multigrid_code_torch.convert import mg_from_jax
from surface_multigrid_code_torch.models import mcf as tmcf
from surface_multigrid_code_torch.ops.laplacian import cotmatrix, massmatrix
from surface_multigrid_code_torch.utils.mesh import doublearea, normalize_unit_area
from surface_multigrid_code_torch.utils.synthetic import icosphere

torch.set_num_threads(1)


def bumpy_sphere():
    """The bumpy icosphere(3) of tests/test_mcf.py."""
    V, F = icosphere(3)
    V = V * (1.0 + 0.1 * np.sin(5 * V[:, [0]]) * np.cos(5 * V[:, [1]]))
    return normalize_unit_area(V, F), F


@pytest.fixture(scope="module")
def flow():
    """The bumpy sphere, the port's copy of the JAX hierarchy (as in
    tests/test_mcf.py: min_coarsest_nv 100, two levels), and 3 steps of
    each package's stepper from V: (U, r_his, converged) per step."""
    V, F = bumpy_sphere()
    mgj = jmg_precompute(V, F, min_coarsest_nv=100, verbose=False)
    mgt = mg_from_jax(mgj)
    js = JMCFStepper(V, F, mgj, dtype=jnp.float64, well=False)
    ts = MCFStepper(V, F, mgt, dtype=torch.float64, device="cpu")
    runs = {"jax": [], "port": []}
    for name, st in (("jax", js), ("port", ts)):
        U = V.copy()
        for _ in range(3):
            U, r_his, ok = st.step(U)
            runs[name].append((U, r_his, ok))
    return V, F, mgt, ts, runs


@pytest.mark.parametrize("k", [0, 1, 2])
def test_mcf_steps_match_jax(flow, k):
    _V, _F, _mgt, _ts, runs = flow
    Uj, rj, okj = runs["jax"][k]
    Ut, rt, okt = runs["port"][k]
    assert okj and okt and len(rt) == len(rj) >= 2
    assert rt[-1] <= 5e-7 < rt[-2]
    np.testing.assert_allclose(rt, rj, rtol=1e-9)
    assert Ut.shape == Uj.shape and Ut.dtype == np.float64
    assert np.abs(Ut - Uj).max() <= 1e-10


def test_mcf_step_smooths_and_converges(flow):
    V, F, _mgt, _ts, runs = flow

    def roughness(X):
        C = X - X.mean(axis=0)
        r = np.linalg.norm(C, axis=1)
        return r.std() / r.mean()

    U = runs["port"][-1][0]
    assert roughness(U) < 0.7 * roughness(V)
    assert abs(doublearea(U, F).sum() / 2.0 - 1.0) < 1e-6
    assert abs(U[:, 0].mean()) < 1e-12 and abs(U[:, 1].mean()) < 1e-12
    assert abs(U[:, 2].min()) < 1e-12


def test_mcf_matches_host_path(flow):
    """One step against the host-assembled ex05 system, solved by the
    port's static path on the same hierarchy (same smoother)."""
    V, F, mgt, _ts, runs = flow
    U1, r1, _ = runs["port"][0]
    L = cotmatrix(V, F)
    M = massmatrix(V, F, kind="barycentric")
    data = min_quad_with_fixed_mg_precompute((M - 0.01 * L).tocsr(), None, mgt,
                                             dtype=torch.float64, device="cpu")
    U2, r2, _ = min_quad_with_fixed_mg_solve(data, np.asarray(M @ V), z0=V.copy(),
                                             tolerance=5e-7, max_iter=20)
    U2 = normalize_unit_area(U2, F)
    np.testing.assert_allclose(r1, r2, rtol=1e-6)
    np.testing.assert_allclose(U1, U2, atol=1e-9)


def test_mcf_timed_phases(flow):
    """``timed`` records the host seconds of each phase of a step, and
    leaves the step's result as it was."""
    V, _F, _mgt, ts, runs = flow
    ts.timed = True
    try:
        U, r_his, k = ts.step_device(torch.as_tensor(V))
    finally:
        ts.timed = False
    assert set(ts.last_phases) == set(tmcf.PHASES)
    assert all(s >= 0.0 for s in ts.last_phases.values())
    assert k == len(runs["port"][0][1]) and r_his.shape == (ts.max_iter,)
    assert np.abs(U.numpy() - runs["port"][0][0]).max() <= 1e-13


def test_mcf_default_device_is_the_card(flow):
    """Without a CUDA device, the default device raises when the stepper
    is built; there is no fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    V, F, mgt, _ts, _runs = flow
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MCFStepper(V, F, mgt)
