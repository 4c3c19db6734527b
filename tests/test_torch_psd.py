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
two safeguards: PSD blocks pass bitwise, indefinite ones come out PSD;
and on real shell Hessians (the 9x9 stretch and the 18x18 bending blocks
of icosphere(2) at a deformed pose, where the projection clamps), in
float32 through the Pallas kernel and in float64 through the XLA one.

The plain version at the edges of the schedule's range (eigenvalues at
+-1.5e-3, +-1e-2 and 1.4) against the exact eigen-projection
``U max(L, 0) U^T``: the yardstick the card's check of K4 uses. And the
contract K4 relies on: ``psd_project_blocks`` hands it exactly symmetric
blocks, whatever H it is given.
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

from surface_multigrid_code_torch.models.balloon import face_hessians
from surface_multigrid_code_torch.models.shell import (
    ShellEnergy,
    lame_parameters,
    psd_project_blocks,
)
from surface_multigrid_code_torch.ops.psd import (
    NS_SCHEDULE,
    ns_sign_apply,
    ns_sign_apply_plain,
)

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


def _shell_hessians():
    """The 9x9 stretch and 18x18 bending Hessians (float64) of the example-06
    shell with bending on icosphere(2), stretched anisotropically and
    jittered (numpy seed): a pose where both kinds go indefinite."""
    from surface_multigrid_code_torch.utils.synthetic import icosphere

    V, F = icosphere(2)
    al, be = lame_parameters(6e6, 0.5)
    shell = ShellEnergy(V, F, 0.1, al, be, "neohookean", bending=True, device="cpu")
    X = V * np.array([1.4, 0.7, 1.0]) + 0.03 * np.random.default_rng(11).standard_normal(V.shape)
    x = torch.as_tensor(X.reshape(-1))
    x9 = x.reshape(-1, 3)[shell.Ft].reshape(-1, 9)
    return {h.shape[1]: h.numpy() for h in face_hessians(shell, x, x9, shell.abars,
                                                        shell.bend_state())}


@pytest.mark.parametrize("dtype, tol", [
    # the Pallas kernel (interpret mode) and the plain version sum each
    # product in another order; the growth cubics amplify that rounding
    (np.float32, 1e-5),
    (np.float64, 1e-12),
])
@pytest.mark.parametrize("d", [9, 18])
def test_psd_project_blocks_on_shell_hessians_matches_jax(d, dtype, tol):
    H = _shell_hessians()[d].astype(dtype)
    got = psd_project_blocks(torch.as_tensor(H)).numpy()
    ref = np.asarray(jpsd(jnp.asarray(H)))
    assert got.dtype == ref.dtype == dtype
    assert np.abs(got - ref).max() <= tol * np.abs(H).max()
    clamped = (got != H).any(axis=(1, 2))
    assert clamped.sum() > 0, "the pose must make the projection clamp"
    assert np.array_equal(clamped, (ref != H).any(axis=(1, 2)))


EDGE = np.array([-1.5e-3, 1.5e-3, -1e-2, 1e-2, 1.4])
# the least eigenvalue of (1/2) Y allowed on those blocks, as on the card
# (chip_smoke.EDGE_LEAST); measured here: -4.3e-8 (f32), -5.7e-16 (f64)
EDGE_LEAST = {torch.float32: 2e-7, torch.float64: 2.5e-15}


def _edge_blocks(m, d, seed):
    """Symmetric blocks U diag(lam) U^T whose eigenvalues lam all lie in
    EDGE (each block holds every value of EDGE), and their exact PSD parts
    U max(lam, 0) U^T."""
    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.standard_normal((m, d, d)))
    lam = rng.choice(EDGE, size=(m, d))
    lam[:, :EDGE.size] = EDGE
    X = np.einsum("mij,mj,mkj->mik", U, lam, U)
    P = np.einsum("mij,mj,mkj->mik", U, np.maximum(lam, 0.0), U)
    return 0.5 * (X + X.transpose(0, 2, 1)), P


@pytest.mark.parametrize("dtype, tol", [
    # f64: the schedule leaves |sign - 1| <= 5e-9 for |x| >= 1.5e-3, so at
    # most 1.5e-3 * 5e-9 / 2 on the PSD part, plus rounding
    (torch.float64, 1e-11),
    # f32: rounding amplified by the growth cubics (1.1e-5 measured here)
    (torch.float32, 1e-4),
])
@pytest.mark.parametrize("d", [9, 18])
def test_plain_sign_apply_at_the_schedule_edges(d, dtype, tol):
    X, P = _edge_blocks(64, d, seed=200 + d)
    half = 0.5 * ns_sign_apply_plain(torch.as_tensor(X, dtype=dtype)).double().numpy()
    assert np.abs(half - P).max() <= tol
    assert np.linalg.eigvalsh(0.5 * (half + half.transpose(0, 2, 1))).min() >= -EDGE_LEAST[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("d", [9, 18])
def test_psd_project_blocks_hands_symmetric_blocks(d, dtype, monkeypatch):
    """K4's 9x9 float32 body starts its iterate from X's upper triangle,
    so it needs X exactly symmetric: psd_project_blocks symmetrizes even a
    non-symmetric H before the call."""
    from surface_multigrid_code_torch.models import shell

    seen = []

    def spy(X, schedule=NS_SCHEDULE):
        seen.append(torch.equal(X, X.transpose(-1, -2)))
        return ns_sign_apply(X, schedule)

    monkeypatch.setattr(shell, "ns_sign_apply", spy)
    H = torch.as_tensor(np.random.default_rng(300 + d).standard_normal((16, d, d)), dtype=dtype)
    out = psd_project_blocks(H)
    assert seen == [True]
    assert out.shape == H.shape and torch.isfinite(out).all()
