"""The port's fused SpMV (plain version, CPU) against the JAX package's kernels.

The same operators and numpy-seeded inputs go through
``surface_multigrid_code_torch.ops.spmv.fused_spmv`` (which takes its plain
PyTorch version on CPU tensors) and through the JAX package's windowed
Pallas kernel (``well_apply``, interpret mode on CPU) and its ELL gather
(``ell_spmv`` with the epilogue applied in numpy). All in f64: the sums
differ only in order, so max|d| <= 1e-11 max|y|.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from surface_multigrid_code_tpu.ops import smoothers as jsm
from surface_multigrid_code_tpu.ops.laplacian import cotmatrix, massmatrix
from surface_multigrid_code_tpu.ops.sparse import ell_from_csr, ell_spmv
from surface_multigrid_code_tpu.ops.well import build_well_auto, well_apply
from surface_multigrid_code_tpu.solver.hierarchy import mg_precompute
from surface_multigrid_code_tpu.utils.synthetic import icosphere

from surface_multigrid_code_torch.ops import smoothers as tsm
from surface_multigrid_code_torch.ops.sparse import csr_from_scipy
from surface_multigrid_code_torch.ops.spmv import fused_spmv

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
