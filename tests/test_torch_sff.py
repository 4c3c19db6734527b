"""The port's angle-based second fundamental form and cotangent entries
against the JAX package's.

- ``edge_tables`` bit for bit;
- the batched torch ``edge_thetas`` and ``second_fundamental_form_angle``
  (tan and sin variants, with nonzero edge DOFs phi) against the JAX
  functions (the SFF vmapped over faces, as ``tests/test_sff_angle.py``
  calls it) within 1e-12, on icosphere(3), on a randomly perturbed copy
  and on a patch with boundary edges;
- ``cotmatrix_entries_tensor`` against ``cotmatrix_entries_jax`` within
  1e-14 (and the numpy ``cotmatrix_entries``), on the same meshes.
All in float64 on the CPU.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from surface_multigrid_code_tpu.models import shell as jshell
from surface_multigrid_code_tpu.ops.laplacian import cotmatrix_entries_jax

from surface_multigrid_code_torch.models import shell as tshell
from surface_multigrid_code_torch.ops.laplacian import cotmatrix_entries, cotmatrix_entries_tensor
from surface_multigrid_code_torch.utils.synthetic import icosphere

torch.set_num_threads(1)


def _mesh(kind):
    V, F = icosphere(3)
    if kind == "perturbed":
        V = V + 0.02 * np.random.default_rng(0).standard_normal(V.shape)
    elif kind == "patch":
        keep = V[:, 2] > 0.2
        Fs = F[keep[F].all(axis=1)]
        used = np.unique(Fs)
        remap = -np.ones(V.shape[0], dtype=np.int64)
        remap[used] = np.arange(used.shape[0])
        V, F = V[used], remap[Fs]
    return V, F


MESHES = ["icosphere3", "perturbed", "patch"]


@pytest.mark.parametrize("kind", MESHES)
def test_edge_tables_bitwise(kind):
    _V, F = _mesh(kind)
    for a, b in zip(tshell.edge_tables(F), jshell.edge_tables(F)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("kind", MESHES)
def test_angle_sff_matches_jax(kind):
    V, F = _mesh(kind)
    eid, orient, ev = tshell.edge_tables(F)
    assert (ev[:, 3] < 0).any() == (kind == "patch")
    th_t = tshell.edge_thetas(torch.as_tensor(V), torch.as_tensor(ev))
    th_j = np.asarray(jshell.edge_thetas_jax(jnp.asarray(V), jnp.asarray(ev)))
    assert th_t.dtype == torch.float64
    np.testing.assert_allclose(th_t.numpy(), th_j, rtol=0, atol=1e-12)
    assert np.abs(th_j).max() > 0.1
    phi = 0.05 * np.random.default_rng(1).standard_normal(ev.shape[0])
    x9 = V[F].reshape(-1, 9)
    for variant in ("tan", "sin"):
        b_t = tshell.second_fundamental_form_angle(
            torch.as_tensor(x9), th_t[torch.as_tensor(eid)], torch.as_tensor(phi[eid]),
            torch.as_tensor(orient), variant)
        b_j = np.asarray(jax.vmap(
            lambda x, t, p, o: jshell.second_fundamental_form_angle(x, t, p, o, variant)
        )(jnp.asarray(x9), jnp.asarray(th_j[eid]), jnp.asarray(phi[eid]),
          jnp.asarray(orient)))
        assert b_t.shape == (F.shape[0], 2, 2)
        np.testing.assert_allclose(b_t.numpy(), b_j, rtol=0, atol=1e-12)


@pytest.mark.parametrize("kind", MESHES)
def test_cotmatrix_entries_tensor_matches_jax(kind):
    V, F = _mesh(kind)
    c_t = cotmatrix_entries_tensor(torch.as_tensor(V), torch.as_tensor(F))
    c_j = np.asarray(cotmatrix_entries_jax(jnp.asarray(V), jnp.asarray(F)))
    assert c_t.dtype == torch.float64 and c_t.shape == (F.shape[0], 3)
    np.testing.assert_allclose(c_t.numpy(), c_j, rtol=0, atol=1e-14)
    np.testing.assert_allclose(c_t.numpy(), cotmatrix_entries(V, F), rtol=0, atol=1e-14)
