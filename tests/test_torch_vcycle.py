"""The port's V-cycle and solve loop against the JAX package's, on the same operators.

The JAX ``DeviceHierarchy`` (ELL, f64, no windowed kernel) of the small
``__graft_entry__._system(3)`` is carried into the port with
``hierarchy_from_jax``, so both V-cycles run on identical operators,
colorings and coarse inverse. The port's own ``build_device_hierarchy`` on
the same matrices must then give the same V-cycle as the converted one.
"""

import importlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from surface_multigrid_code_tpu.config import SmootherType as JSmoother
from surface_multigrid_code_tpu.config import SolveConfig as JSolveConfig

from surface_multigrid_code_torch.config import SmootherType, SolveConfig
from surface_multigrid_code_torch.convert import hierarchy_from_jax

torch.set_num_threads(1)

# the JAX package's solver/__init__ re-exports a function named vcycle
jvc = importlib.import_module("surface_multigrid_code_tpu.solver.vcycle")
tvc = importlib.import_module("surface_multigrid_code_torch.solver.vcycle")

SMOOTHERS = ["jacobi", "multicolor_gs", "chebyshev"]


def _graft_system(depth):
    path = Path(__file__).resolve().parents[1] / "__graft_entry__.py"
    spec = importlib.util.spec_from_file_location("_graft_entry", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._system(depth)


@pytest.fixture(scope="module")
def system():
    return _graft_system(3)


def _leaves(h):
    """numpy leaves of a JAX DeviceHierarchy, as hierarchy_from_jax takes them."""
    ell = (lambda E: None if E is None else (np.asarray(E.indices), np.asarray(E.data)))
    levels = [
        {
            "A": ell(lv.A), "P": ell(lv.P), "PT": ell(lv.PT),
            "diag": np.asarray(lv.diag),
            "groups": [np.asarray(g) for g in lv.groups],
            "lam_max": None if lv.lam_max is None else float(lv.lam_max),
        }
        for lv in h.levels
    ]
    return levels, np.asarray(h.coarse_inv)


def _both(system, smoother):
    As, Ps, rhs = system
    jcfg = JSolveConfig(smoother=JSmoother(smoother))
    tcfg = SolveConfig(smoother=SmootherType(smoother))
    jh = jvc.build_device_hierarchy(As, Ps, cfg=jcfg, dtype=jnp.float64, well=False)
    th = hierarchy_from_jax(*_leaves(jh), device="cpu", dtype=torch.float64)
    return jh, th, jcfg, tcfg, rhs


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("smoother", SMOOTHERS)
def test_vcycle_matches_jax(system, smoother):
    jh, th, jcfg, tcfg, rhs = _both(system, smoother)
    u0 = np.random.default_rng(3).standard_normal(rhs.shape[0])
    ref = jvc.vcycle(jh, jnp.asarray(rhs), jnp.asarray(u0), jcfg)
    u = torch.as_tensor(u0.copy())
    got = tvc.vcycle(th, torch.as_tensor(rhs), u, tcfg)
    assert np.array_equal(u.numpy(), u0)  # the caller's u is not modified
    assert _rel(got.numpy(), ref) <= 1e-12


@pytest.mark.parametrize("smoother", SMOOTHERS)
def test_solve_loop_matches_jax(system, smoother):
    jh, th, jcfg, tcfg, rhs = _both(system, smoother)
    tol, max_iter = 1e-9 * np.linalg.norm(rhs), 25
    zj, rj, kj = jvc.solve_loop(
        jh, jnp.asarray(rhs), jnp.zeros(rhs.shape[0]),
        jnp.asarray(tol), max_iter, jcfg,
    )
    zt, rt, kt = tvc.solve_loop(
        th, torch.as_tensor(rhs), torch.zeros(rhs.shape[0], dtype=torch.float64),
        tol, max_iter, tcfg,
    )
    assert int(kj) == kt
    rj, rt = np.asarray(rj), rt.numpy()
    assert np.all(rt[kt:] == -1.0) and rt[kt - 1] < tol
    # the two summation orders leave an f64 roundoff floor of a few 1e-18
    # in ||b - Az|| here; atol = 1e-15 r0 sits above it
    np.testing.assert_allclose(rt[:kt], rj[:kt], rtol=1e-9, atol=1e-15 * rj[0])
    assert _rel(zt.numpy(), zj) <= 1e-9


@pytest.mark.parametrize("smoother", SMOOTHERS)
def test_port_hierarchy_matches_converted(system, smoother):
    """build_device_hierarchy (port) == hierarchy_from_jax (JAX build)."""
    jh, th, jcfg, tcfg, rhs = _both(system, smoother)
    As, Ps, _ = system
    own = tvc.build_device_hierarchy(As, Ps, cfg=tcfg, device="cpu",
                                     dtype=torch.float64)
    assert own.n_levels == th.n_levels
    assert torch.equal(own.coarse_inv, th.coarse_inv)
    for a, b in zip(own.levels, th.levels):
        assert len(a.groups) == len(b.groups)
        for ga, gb in zip(a.groups, b.groups):
            assert torch.equal(ga, gb)
        assert a.lam_max == b.lam_max
    u0 = torch.as_tensor(np.random.default_rng(4).standard_normal(rhs.shape[0]))
    b = torch.as_tensor(rhs)
    assert _rel(tvc.vcycle(own, b, u0, tcfg), tvc.vcycle(th, b, u0, tcfg)) <= 1e-13
