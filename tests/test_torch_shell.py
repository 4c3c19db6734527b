"""The port's shell energies against the JAX package's, in float64.

Energy, gradient (one reverse pass), the structured 9x9 stretching
Hessian and the 18x18 bending Hessian, for the three materials, at a
numpy-seeded deformation of icosphere(2); within 1e-10 relative. Both
sides differentiate the same densities with autodiff in another framework,
so they differ only by rounding.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from surface_multigrid_code_tpu.models.shell import ShellEnergy as JShell
from surface_multigrid_code_tpu.models.shell import opposite_vertices as jopp

from surface_multigrid_code_torch.models.shell import (
    ShellEnergy,
    lame_parameters,
    opposite_vertices,
)
from surface_multigrid_code_torch.utils.synthetic import icosphere

torch.set_num_threads(1)

RTOL = 1e-10
MATERIALS = ["neohookean", "stvk", "tension_field"]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.fixture(scope="module")
def mesh():
    V, F = icosphere(2)
    rng = np.random.default_rng(21)
    # inflate and jitter: some faces stretch, some compress
    x = (V * 1.05 + 0.02 * rng.standard_normal(V.shape)).reshape(-1)
    return V, F, x


def _pair(V, F, material, bending):
    al, be = lame_parameters(6e4, 0.3)
    j = JShell(V, F, 0.1, al, be, material, bending=bending)
    t = ShellEnergy(V, F, 0.1, al, be, material, bending=bending)
    return j, t


@pytest.mark.parametrize("material", MATERIALS)
def test_stretch_energy_gradient_hessian(mesh, material):
    V, F, x = mesh
    j, t = _pair(V, F, material, bending=False)
    assert _rel(t.abars.numpy(), np.asarray(j.abars)) < 1e-14
    assert abs(t.energy(x) - j.energy(x)) <= RTOL * abs(j.energy(x))
    assert _rel(t.gradient(x), j.gradient(x)) < RTOL
    x9 = x.reshape(-1, 3)[F].reshape(-1, 9)
    Hj = np.asarray(j._face_hess(jnp.asarray(x9), j.abars))
    Ht = t.face_hess(torch.as_tensor(x9), t.abars).numpy()
    assert Ht.shape == Hj.shape == (F.shape[0], 9, 9)
    assert _rel(Ht, Hj) < RTOL
    # the assembled, PSD-projected stiffness of the direct solver
    Kj = j.hessian(x, psd_project=True)
    Kt = t.hessian(x, psd_project=True)
    assert _rel(Kt.toarray(), Kj.toarray()) < RTOL


@pytest.mark.parametrize("material", ["neohookean", "stvk"])
def test_bending_energy_gradient_hessian(mesh, material):
    V, F, x = mesh
    opp, mask = opposite_vertices(F)
    jo, jm = jopp(F)
    assert np.array_equal(opp, jo) and np.array_equal(mask, jm)
    j, t = _pair(V, F, material, bending=True)
    assert _rel(t.bbars.numpy(), np.asarray(j.bbars)) < 1e-12
    assert abs(t.energy(x) - j.energy(x)) <= RTOL * abs(j.energy(x))
    assert _rel(t.gradient(x), j.gradient(x)) < RTOL
    xv = x.reshape(-1, 3)
    x18 = np.concatenate([xv[F].reshape(-1, 9), xv[opp].reshape(-1, 9)], axis=1)
    Hj = np.asarray(j._face_hess_bend(jnp.asarray(x18), j.abars, j.bbars, jnp.asarray(mask)))
    Ht = t.face_hess_bend(torch.as_tensor(x18), t.abars, t.bbars,
                          torch.as_tensor(mask)).numpy()
    assert Ht.shape == Hj.shape == (F.shape[0], 18, 18)
    assert _rel(Ht, Hj) < RTOL
