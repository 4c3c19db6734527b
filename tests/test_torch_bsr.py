"""The port's block SpMV and BSR multigrid against the JAX package's.

- ``fused_bsr_spmv`` (plain version on the CPU) against the Pallas block
  kernel ``well_block3_apply`` (interpret mode, float32) for all five
  epilogues, within 1e-5 max|y|, and against the XLA ``bsr_spmv`` with the
  epilogue applied in numpy, in float64, within 1e-12 max|y|.
- The balloon's block Hessian (assembly + PSD projection), the Galerkin
  block refresh and the solve loop against the JAX ``BsrBalloonStepper``'s
  assembly and ``BsrRefreshableSolver`` (``well=False``) in float64: the
  refreshed operators, the Chebyshev bounds, the coarse inverse and the
  residual histories.
- ``bsr_hierarchy_from_jax``: both V-cycles on identical operators.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.sparse.csgraph import reverse_cuthill_mckee

import jax.numpy as jnp

from surface_multigrid_code_tpu.config import SmootherType as JSmoother
from surface_multigrid_code_tpu.config import SolveConfig as JSolveConfig
from surface_multigrid_code_tpu.models import balloon as jb
from surface_multigrid_code_tpu.models.shell import ShellEnergy as JShell
from surface_multigrid_code_tpu.ops.well import (
    build_well_auto,
    well_block3_apply,
    well_repack_tap,
)
from surface_multigrid_code_tpu.solver import bsr as jbsr
from surface_multigrid_code_tpu.solver.hierarchy import mg_precompute as jmg_precompute

from surface_multigrid_code_torch import mg_precompute
from surface_multigrid_code_torch.config import SmootherType, SolveConfig
from surface_multigrid_code_torch.convert import bsr_hierarchy_from_jax, shell_state_from_jax
from surface_multigrid_code_torch.models import balloon as tb
from surface_multigrid_code_torch.models.shell import ShellEnergy, lame_parameters
from surface_multigrid_code_torch.ops.bsr_spmv import fused_bsr_spmv
from surface_multigrid_code_torch.ops.sparse import BSRMatrix
from surface_multigrid_code_torch.solver import bsr as tbsr
from surface_multigrid_code_torch.utils.synthetic import icosphere

torch.set_num_threads(1)

EPIS = [None, "axpby", "resid", "add", "resid_scaled"]
ESCALE = 2.0 / 3.0


def _epi_np(Ax, epi, b, u, s):
    if epi is None:
        return Ax
    if epi == "resid":
        return b - Ax
    if epi == "add":
        return u + Ax
    sc = s * ESCALE
    return u + (b - Ax) * sc if epi == "axpby" else (b - Ax) * sc


@pytest.fixture(scope="module")
def vertex_bsr():
    """icosphere(3)'s vertex graph in RCM order with random 3x3 blocks, and
    numpy-seeded x, u, b, s [n, 3]."""
    V, F = icosphere(3)
    n = V.shape[0]
    rows = np.repeat(F, 3, axis=1).reshape(-1)
    cols = np.tile(F, (1, 3)).reshape(-1)
    G = (sp.coo_matrix((np.ones(rows.size), (rows, cols)), shape=(n, n))
         + sp.identity(n)).tocsr()
    perm = reverse_cuthill_mckee(G, symmetric_mode=True)
    G = G[perm][:, perm].tocsr()
    G.sum_duplicates()
    G.sort_indices()
    rng = np.random.default_rng(3)
    blocks = rng.standard_normal((G.nnz, 3, 3))
    vecs = {k: rng.standard_normal((n, 3)) for k in ("x", "u", "b")}
    vecs["s"] = rng.uniform(0.5, 2.0, (n, 3))
    return G, blocks, vecs


def _port_bsr(G, blocks, dtype):
    return BSRMatrix(torch.as_tensor(G.indptr.astype(np.int32)),
                     torch.as_tensor(G.indices.astype(np.int32)),
                     torch.as_tensor(blocks, dtype=dtype), G.shape[0])


def _port_call(G, blocks, vecs, epi, dtype):
    t = {k: torch.as_tensor(v, dtype=dtype) for k, v in vecs.items()}
    return fused_bsr_spmv(_port_bsr(G, blocks, dtype), t["x"], epi, b=t["b"], u=t["u"],
                          s=t["s"], escale=ESCALE).numpy()


@pytest.mark.parametrize("epi", EPIS)
def test_block_spmv_f32_matches_pallas(vertex_bsr, epi):
    G, blocks, vecs = vertex_bsr
    n = G.shape[0]
    counts = np.diff(G.indptr)
    slot_rows = np.repeat(np.arange(n), counts)
    slot = np.arange(G.nnz) - np.repeat(G.indptr[:-1], counts)
    Ws = build_well_auto(G, dtype=jnp.float32)
    Wt = Ws if isinstance(Ws, tuple) else (Ws,)
    planes = []
    for i in range(3):
        for j in range(3):
            ell = np.zeros((n, counts.max()))
            ell[slot_rows, slot] = blocks[:, i, j]
            planes.append(ell)
    dats, k0 = [], 0
    for W in Wt:
        dats.append(tuple(
            well_repack_tap(W, jnp.asarray(p[:, k0:k0 + W.w], dtype=jnp.float32)).dat
            for p in planes))
        k0 += W.w
    pl = {k: jnp.asarray(v.T, dtype=jnp.float32) for k, v in vecs.items()}
    kw = {} if epi is None else {k: pl[k] for k in {
        "axpby": "ubs", "resid": "b", "add": "u", "resid_scaled": "bs"}[epi]}
    ref = np.asarray(well_block3_apply(Wt, pl["x"], tuple(dats), epi=epi,
                                       escale=ESCALE, **kw))[:, :n].T
    got = _port_call(G, blocks, vecs, epi, torch.float32)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("epi", EPIS)
def test_block_spmv_f64_matches_xla(vertex_bsr, epi):
    G, blocks, vecs = vertex_bsr
    n = G.shape[0]
    counts = np.diff(G.indptr)
    w = counts.max()
    idx = np.zeros((n, w), dtype=np.int32)
    ell = np.zeros((n, w, 3, 3))
    slot_rows = np.repeat(np.arange(n), counts)
    slot = np.arange(G.nnz) - np.repeat(G.indptr[:-1], counts)
    idx[slot_rows, slot] = G.indices
    ell[slot_rows, slot] = blocks
    Ax = np.asarray(jbsr.bsr_spmv(
        jbsr.BSRMatrix(indices=jnp.asarray(idx), blocks=jnp.asarray(ell), n_cols=n),
        jnp.asarray(vecs["x"])))
    ref = _epi_np(Ax, epi, vecs["b"], vecs["u"], vecs["s"])
    got = _port_call(G, blocks, vecs, epi, torch.float64)
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


@pytest.fixture(scope="module")
def balloon_pair():
    """Both packages' balloon steppers on icosphere(2) at the reference
    operating point, and an inflated pose x. The hierarchy goes down to
    about 10 vertices, so the refresh runs through two Galerkin levels."""
    V, F = icosphere(2)
    al, be = lame_parameters(6e6, 0.5)
    M = 1000.0 * tb.lumped_mass_matrix(V, F)
    jshell = JShell(V, F, 0.1, al, be, "neohookean")
    tshell = shell_state_from_jax(ShellEnergy(V, F, 0.1, al, be, "neohookean"),
                                  np.asarray(jshell.abars))
    mgj = jmg_precompute(V, F, min_coarsest_nv=10, verbose=False)
    mgt = mg_precompute(V, F, min_coarsest_nv=10, verbose=False)
    jstep = jb.BsrBalloonStepper(jshell, M, mgj, 1e-3, dtype=jnp.float64, well=False,
                                 coarsest_nv=0)
    tstep = tb.BsrBalloonStepper(tshell, M, mgt, 1e-3, dtype=torch.float64, coarsest_nv=0)
    rng = np.random.default_rng(8)
    x = (V * 1.3 + 0.01 * rng.standard_normal(V.shape)).reshape(-1)
    return V, F, mgj, mgt, jstep, tstep, x


def _block_vals(jstep, tstep, x):
    vj = np.array(jstep._block_vals(jstep._state, jnp.asarray(x)))
    xt = torch.as_tensor(x)
    H = [tb.psd_project_blocks(h) for h in tstep._face_blocks(xt, tstep._face9(xt))]
    return vj, tstep._assemble(H).numpy()


def test_block_assembly_matches_jax(balloon_pair):
    _V, _F, _mgj, _mgt, jstep, tstep, x = balloon_pair
    vj, vt = _block_vals(jstep, tstep, x)
    assert vt.shape == vj.shape == (tstep.nnz, 3, 3)
    assert np.abs(vt - vj).max() <= 1e-10 * np.abs(vj).max()


def _jax_leaves(jsolver, hier):
    plans = [jsolver.plan.lvl0, *jsolver.plan.levels]
    ell = (lambda E: None if E is None else (np.asarray(E.indices), np.asarray(E.data)))
    return [
        {"indices": np.asarray(lv.A.indices), "blocks": np.asarray(lv.A.blocks),
         "gather": np.asarray(pl_.ell_gather), "nnz": pl_.nnz_out,
         "diag": np.asarray(lv.diag), "P": ell(lv.P), "PT": ell(lv.PT),
         "lam_max": None if lv.lam_max is None else float(lv.lam_max)}
        for lv, pl_ in zip(hier.levels, plans)
    ], np.asarray(hier.coarse_inv)


@pytest.mark.parametrize("smoother", ["chebyshev", "jacobi"])
def test_refresh_and_solve_loop_match_jax(balloon_pair, smoother):
    V, F, mgj, mgt, jstep, tstep, x = balloon_pair
    vals, _ = _block_vals(jstep, tstep, x)
    pattern = tstep.pattern
    jsolver = jbsr.BsrRefreshableSolver(
        mgj, pattern, cfg=JSolveConfig(smoother=JSmoother(smoother)),
        dtype=jnp.float64, well=False)
    tsolver = tbsr.BsrRefreshableSolver(
        mgt, pattern, cfg=SolveConfig(smoother=SmootherType(smoother)), dtype=torch.float64)
    hj = jsolver._refresh_impl(jsolver._state, jnp.asarray(vals))
    ht = tsolver.refresh(torch.as_tensor(vals))
    assert ht.n_levels == hj.n_levels >= 3
    # the refreshed operators, level by level, and the coarse inverse
    leaves, cinv = _jax_leaves(jsolver, hj)
    hc = bsr_hierarchy_from_jax(leaves, cinv, "cpu", torch.float64)
    for lt, lc, lj in zip(ht.levels, hc.levels, hj.levels):
        assert torch.equal(lt.A.indptr, lc.A.indptr)
        assert torch.equal(lt.A.indices, lc.A.indices)
        scale = lc.A.blocks.abs().max()
        assert (lt.A.blocks - lc.A.blocks).abs().max() <= 1e-12 * scale
        assert np.abs(lt.diag.numpy() - np.asarray(lj.diag)).max() <= 1e-12 * float(scale)
        if lj.lam_max is None:
            assert lt.lam_max is None
        else:
            assert abs(lt.lam_max - float(lj.lam_max)) <= 1e-10 * float(lj.lam_max)
    assert np.abs(ht.coarse_inv.numpy() - cinv).max() <= 1e-9 * np.abs(cinv).max()

    # the solve loops: same residual histories, same iterates
    rng = np.random.default_rng(4)
    rhs = rng.standard_normal((V.shape[0], 3))
    tol = 1e-6 * np.linalg.norm(rhs)
    zj, rj, kj = jbsr.bsr_solve_loop(hj, jnp.asarray(rhs), jnp.zeros_like(jnp.asarray(rhs)),
                                    jnp.asarray(tol), 12, jsolver.cfg)
    rhs_t = torch.as_tensor(rhs)
    zt, rt, kt = tbsr.bsr_solve_loop(ht, rhs_t, torch.zeros_like(rhs_t), tol, 12, tsolver.cfg)
    assert kt == int(kj) > 2
    rj = np.asarray(rj)[:kt]
    assert rj[-1] < rj[0] * 1e-2
    assert np.abs(rt[:kt].numpy() - rj).max() <= 1e-9 * rj[0]
    assert np.abs(zt.numpy() - np.asarray(zj)).max() <= 1e-9 * np.abs(np.asarray(zj)).max()

    # the public solve: flat f64 result and the converged flag
    z, r_list, ok = tsolver.solve(vals, rhs.reshape(-1), tolerance=tol, max_iter=12)
    assert ok and len(r_list) == kt and z.shape == (3 * V.shape[0],)

    # both V-cycles on identical operators (the converted hierarchy)
    u0 = rng.standard_normal(rhs.shape)
    yj = np.asarray(jbsr.bsr_vcycle(hj, jnp.asarray(rhs), jnp.asarray(u0), jsolver.cfg))
    yc = tbsr.bsr_vcycle(hc, rhs_t, torch.as_tensor(u0), tsolver.cfg).numpy()
    assert np.abs(yc - yj).max() <= 1e-12 * np.abs(yj).max()


def test_gershgorin_bound_covers_power_iteration(balloon_pair):
    _V, _F, _mgj, _mgt, jstep, tstep, x = balloon_pair
    vals, _ = _block_vals(jstep, tstep, x)
    lv0 = tstep.solver.refresh(torch.as_tensor(vals)).levels[0]
    gersh = float(tbsr._bsr_gershgorin_lam(lv0.A, lv0.diag))
    hj = jstep.solver._refresh_impl(jstep.solver._state, jnp.asarray(vals))
    ref = float(jbsr._bsr_gershgorin_lam(hj.levels[0].A, hj.levels[0].diag))
    assert abs(gersh - ref) <= 1e-12 * ref
    assert gersh >= lv0.lam_max / 1.1
