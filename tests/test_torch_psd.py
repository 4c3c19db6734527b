"""The port's Newton-Schulz sign-apply (plain version, CPU) against the JAX package's.

``ns_sign_apply`` takes the blocks one by one; the JAX kernel
``ns_sign_apply_packed`` takes them packed block-diagonally into 128x128
tiles (126 // d blocks per tile). The tests pack numpy-seeded blocks for
the JAX side, unpack its result and compare block by block:

- the Pallas kernel (interpret mode on the CPU, float32) within
  1e-5 max|Y|: the two sum each product in another order, and the growth
  cubics amplify that rounding on small-eigenvalue directions;
- the XLA version (float64) within 1e-12 max|Y|.

Then ``psd_project_blocks`` against the JAX package's in float64, and its
two safeguards: PSD blocks pass bitwise, indefinite ones come out PSD.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from surface_multigrid_code_tpu.models.shell import psd_project_blocks as jpsd
from surface_multigrid_code_tpu.ops.psd import (
    NS_SCHEDULE as JSCHEDULE,
    ns_sign_apply_packed,
    ns_sign_apply_packed_xla,
)

from surface_multigrid_code_torch.models.shell import psd_project_blocks
from surface_multigrid_code_torch.ops.psd import NS_SCHEDULE, ns_sign_apply

torch.set_num_threads(1)

TILE = 128


def _scaled_blocks(m, d, seed):
    """Random symmetric indefinite blocks scaled as psd_project_blocks scales them."""
    B = np.random.default_rng(seed).standard_normal((m, d, d))
    H = 0.5 * (B + B.transpose(0, 2, 1))
    return H / np.abs(H).sum(axis=-1).max(axis=-1)[:, None, None]


def _pack(X):
    m, d, _ = X.shape
    pack = 126 // d  # as psd_project_blocks packs
    g = -(-m // pack)
    Z = np.zeros((g, TILE, TILE))
    for i in range(m):
        o = (i % pack) * d
        Z[i // pack, o:o + d, o:o + d] = X[i]
    return Z, pack


def _unpack(Y, m, d, pack):
    return np.stack([
        Y[i // pack, (i % pack) * d:(i % pack) * d + d, (i % pack) * d:(i % pack) * d + d]
        for i in range(m)
    ])


def test_schedule_is_the_reference():
    assert NS_SCHEDULE == JSCHEDULE


@pytest.mark.parametrize("d", [9, 18])
def test_sign_apply_f32_matches_pallas(d):
    X = _scaled_blocks(56, d, seed=d).astype(np.float32)
    Z, pack = _pack(X)
    ref = _unpack(np.asarray(ns_sign_apply_packed(jnp.asarray(Z, dtype=jnp.float32))),
                  X.shape[0], d, pack)
    got = ns_sign_apply(torch.as_tensor(X)).numpy()
    assert got.dtype == np.float32
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("d", [9, 18])
def test_sign_apply_f64_matches_xla(d):
    X = _scaled_blocks(40, d, seed=100 + d)
    Z, pack = _pack(X)
    ref = _unpack(np.asarray(ns_sign_apply_packed_xla(jnp.asarray(Z))), X.shape[0], d, pack)
    got = ns_sign_apply(torch.as_tensor(X)).numpy()
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()
    # (s/2) Y is the PSD part: its eigenvalues are max(lam, 0) up to the
    # schedule's residue on eigenvalues near zero
    w = np.linalg.eigvalsh(0.5 * (got + got.transpose(0, 2, 1)) / 2)
    lam = np.linalg.eigvalsh(X)
    assert np.abs(np.sort(w) - np.sort(np.maximum(lam, 0.0))).max() < 2e-3


@pytest.mark.parametrize("d", [9, 18])
def test_psd_project_blocks_matches_jax(d):
    rng = np.random.default_rng(7 + d)
    B = rng.standard_normal((24, d, d)) * 10.0
    H = 0.5 * (B + B.transpose(0, 2, 1))   # indefinite symmetric
    Hpsd = np.einsum("fij,fkj->fik", B, B)  # PSD by construction
    Hall = np.concatenate([H, Hpsd])
    got = psd_project_blocks(torch.as_tensor(Hall)).numpy()
    ref = np.asarray(jpsd(jnp.asarray(Hall)))
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()
    # eigenvalues below ~1.5e-3 of the block's inf-norm saturate slowly
    # through the schedule and keep a residue of at most their size
    w = np.linalg.eigvalsh(got[:24])
    s = np.abs(H).sum(axis=-1).max(axis=-1)
    assert (w.min(axis=1) >= -1.5e-3 * s).all()
    assert np.array_equal(got[24:], Hpsd), "PSD blocks must pass bitwise"
    # clamped blocks keep their positive part: x^T Hp x >= x^T H x
    x = rng.standard_normal(d)
    assert (x @ got[0] @ x) >= (x @ H[0] @ x) - 1e-8
