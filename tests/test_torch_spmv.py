"""The port's fused SpMV (plain version, CPU) against the JAX package's kernels.

The same operators and numpy-seeded inputs go through
``surface_multigrid_code_torch.ops.spmv.fused_spmv`` (which takes its plain
PyTorch version on CPU tensors) and through the JAX package's windowed
Pallas kernel (``well_apply``, interpret mode on CPU) and its ELL gather
(``ell_spmv`` with the epilogue applied in numpy). All in f64: the sums
differ only in order, so max|d| <= 1e-11 max|y|.

The CUDA kernel's launch plan (``CSRMatrix.lanes``, the sub-warp width
per row) is read from the shapes on the host, so it is tested here too.
"""

import importlib

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from surface_multigrid_code_tpu.config import SmootherType as JSmoother
from surface_multigrid_code_tpu.config import SolveConfig as JSolveConfig
from surface_multigrid_code_tpu.ops import smoothers as jsm
from surface_multigrid_code_tpu.ops.laplacian import cotmatrix, massmatrix
from surface_multigrid_code_tpu.ops.sparse import ell_from_csr, ell_spmv
from surface_multigrid_code_tpu.ops.well import build_well_auto, well_apply
from surface_multigrid_code_tpu.solver.hierarchy import mg_precompute
from surface_multigrid_code_tpu.utils.synthetic import icosphere

from surface_multigrid_code_torch.convert import ell_to_csr, hierarchy_from_jax
from surface_multigrid_code_torch.ops import smoothers as tsm
from surface_multigrid_code_torch.ops.sparse import csr_from_scipy
from surface_multigrid_code_torch.ops.spmv import fused_spmv, launch_lanes

# the JAX package's solver/__init__ re-exports a function named vcycle
jvc = importlib.import_module("surface_multigrid_code_tpu.solver.vcycle")

torch.set_num_threads(1)

EPIS = [None, "axpby", "resid", "add", "resid_scaled"]
RTOL = 1e-11
ESCALE = 2.0 / 3.0


@pytest.fixture(scope="module")
def ops():
    """icosphere(3) A = M - 0.01 L and one SSP level's P and PT."""
    V, F = icosphere(3)
    A = (massmatrix(V, F) - 0.01 * cotmatrix(V, F)).tocsr()
    mg = mg_precompute(V, F, min_coarsest_nv=100, verbose=False)
    P = mg[1].P_full.tocsr()
    return {"A": A, "P": P, "PT": P.T.tocsr()}


def _epi_np(Ax, epi, b, u, s):
    if epi is None:
        return Ax
    if epi == "resid":
        return b - Ax
    if epi == "add":
        return u + Ax
    sc = s * ESCALE
    sc = sc if Ax.ndim == 1 else sc[:, None]
    return u + (b - Ax) * sc if epi == "axpby" else (b - Ax) * sc


def _close(y, ref):
    y, ref = np.asarray(y), np.asarray(ref)
    assert y.shape == ref.shape
    assert np.abs(y - ref).max() <= RTOL * np.abs(ref).max()


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("epi", EPIS)
def test_fused_spmv_matches_jax(ops, epi, C):
    rng = np.random.default_rng(11 + C)
    for name, S in ops.items():
        n, m = S.shape
        shp = (n,) if C == 1 else (n, C)
        x = rng.standard_normal((m,) if C == 1 else (m, C))
        u, b = rng.standard_normal(shp), rng.standard_normal(shp)
        s = rng.uniform(0.5, 2.0, n)

        got = fused_spmv(
            csr_from_scipy(S, "cpu", torch.float64), torch.as_tensor(x),
            epi=epi, u=torch.as_tensor(u), b=torch.as_tensor(b),
            s=torch.as_tensor(s), escale=ESCALE,
        ).numpy()

        # the Pallas kernel (interpret mode); multi-column runs in planes [C, n]
        W = build_well_auto(S, dtype=jnp.float64)
        kw = {"epi": epi, "escale": ESCALE}
        if epi is not None:
            named = {"u": u, "b": b, "s": s}
            for k in {"axpby": "ubs", "resid": "b", "add": "u",
                      "resid_scaled": "bs"}[epi]:
                v = named[k]
                kw[k] = jnp.asarray(v if (v.ndim == 1 or C == 1) else v.T)
        xj = jnp.asarray(x if C == 1 else x.T)
        yw = np.asarray(well_apply(W, xj, **kw))
        _close(got, yw if C == 1 else yw.T)

        # the ELL gather + the epilogue table
        ye = _epi_np(np.asarray(ell_spmv(ell_from_csr(S), jnp.asarray(x))),
                     epi, b, u, s)
        _close(got, ye)


@pytest.mark.parametrize("C", [1, 3])
def test_multicolor_gs_rows_match_jax(ops, C):
    """The in-place row-subset update (one fused call per color) against the
    JAX gather-and-scatter GS sweep with its padded color groups."""
    A = ops["A"]
    n = A.shape[0]
    rng = np.random.default_rng(5)
    shp = (n,) if C == 1 else (n, C)
    u, b = rng.standard_normal(shp), rng.standard_normal(shp)
    color = jsm.greedy_coloring(A)
    assert np.array_equal(color, tsm.greedy_coloring(A))
    jg = jsm.color_groups(color)
    ref = jsm.multicolor_gs_sweep(
        ell_from_csr(A), jnp.asarray(A.diagonal()),
        tuple(jnp.asarray(g) for g in jg),
        tuple(jnp.asarray(sc) for sc in jsm.group_scales(jg)),
        jnp.asarray(b), jnp.asarray(u),
    )
    ut = torch.as_tensor(u.copy())
    got = tsm.multicolor_gs_sweep(
        csr_from_scipy(A, "cpu", torch.float64),
        torch.as_tensor(1.0 / A.diagonal()),
        tuple(torch.as_tensor(g) for g in tsm.color_groups(color)),
        torch.as_tensor(b), ut,
    )
    assert got is ut  # updated in place
    _close(got.numpy(), ref)


@pytest.fixture(scope="module")
def converted(ops):
    """The ico operators through the JAX package's device hierarchy and
    ``hierarchy_from_jax``: {name: (scipy matrix, converted CSRMatrix)}."""
    A0, P = ops["A"], ops["P"]
    A1 = (P.T @ A0 @ P).tocsr()
    jh = jvc.build_device_hierarchy([A0, A1], [P], cfg=JSolveConfig(smoother=JSmoother.JACOBI),
                                    dtype=jnp.float64, well=False)
    ell = (lambda E: (np.asarray(E.indices), np.asarray(E.data)))
    leaves = [{"A": ell(lv.A), "P": None if lv.P is None else ell(lv.P),
               "PT": None if lv.PT is None else ell(lv.PT), "diag": np.asarray(lv.diag),
               "groups": [], "lam_max": None} for lv in jh.levels]
    th = hierarchy_from_jax(leaves, np.asarray(jh.coarse_inv), device="cpu",
                            dtype=torch.float64)
    return {"A_0": (A0, th.levels[0].A), "A_1": (A1, th.levels[1].A),
            "P": (P, th.levels[1].P), "PT": (ops["PT"], th.levels[1].PT)}


def _rows_of(lengths, n_cols=400, seed=0):
    """A CSR matrix with the given nonzeros per row, random nonzero values."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(len(lengths)), lengths)
    cols = np.concatenate([rng.choice(n_cols, k, replace=False) for k in lengths])
    return sp.csr_matrix((rng.uniform(0.5, 1.5, rows.size), (rows, cols)),
                         shape=(len(lengths), n_cols))


@pytest.mark.parametrize("name, lanes", [
    ("A_0", 8), ("A_1", 32), ("P", 4), ("PT", 16),   # icosphere(3) levels 0-1
    ("hub rows of 171", 32), ("mean exactly 4", 4), ("mean just above 4", 8),
    ("half the rows empty", 8),
])
def test_launch_plan_lanes(converted, name, lanes):
    """CSRMatrix.lanes: the smallest power of two in [1, 32] at or above the
    mean row length, the same through csr_from_scipy and the converters."""
    if name in converted:
        S, conv = converted[name]
    else:
        S = _rows_of({"hub rows of 171": [171, 3, 171, 171],
                      "mean exactly 4": [4, 2, 6, 4],
                      "mean just above 4": [4, 2, 6, 5],
                      "half the rows empty": [0, 10, 0, 10, 0, 10]}[name])
        E = ell_from_csr(S)
        conv = ell_to_csr(np.asarray(E.indices), np.asarray(E.data), S.shape[1], "cpu",
                          torch.float64)
    mean = S.nnz / S.shape[0]
    got = csr_from_scipy(S, "cpu", torch.float64).lanes
    assert got == conv.lanes == lanes
    assert lanes in (1, 2, 4, 8, 16, 32)
    assert lanes >= mean or lanes == 32
    assert lanes == 1 or lanes / 2 < mean


H100_THREADS = 132 * 2048  # SMs x resident threads per SM


@pytest.mark.parametrize("lanes, n_out, launched", [
    (8, 163842, 1), (4, 163842, 1),            # ico7 A_0, P_1: one thread per row
    (32, 40962, 4), (16, 40962, 4), (8, 40962, 4),  # A_1, PT_1, a level-0 GS color
    (32, 10242, 16), (32, 2562, 32), (32, 4330, 32),  # A_2, A_3, a level-1 color
    (16, 4932, 16), (1, 5, 1), (32, 1, 32),    # ogre's hub PT, tiny launches
    (8, 15804, 8), (32, 249, 32),              # K3: bunny_15K block rows, levels 0, 3
    (8, 63210, 4),                             # K3: the subdivided bunny's level 0
])
def test_launch_lanes_fit_one_wave(lanes, n_out, launched):
    """A launch keeps the operator's lanes unless rows x lanes exceed the
    card's resident threads; then it halves them, never below 1."""
    got = launch_lanes(lanes, n_out, H100_THREADS)
    assert got == launched
    assert got == 1 or n_out * got <= H100_THREADS
    assert got == lanes or n_out * 2 * got > H100_THREADS
