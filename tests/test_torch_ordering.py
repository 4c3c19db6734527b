"""The static precompute's locality ordering against the caller's order.

``min_quad_with_fixed_mg_precompute`` keeps its device hierarchy in the
finest RCM and the orderings it induces below, where the finest
operator's band streams more than the L2 in a sweep
(``solver.ordering.locality_ordering``, ``vcycle.ordered_hierarchy``), and
``solve_loop`` / ``solve_loop_ir`` map the right-hand side and the answer
across it. The CPU models no cache (``utils.device.l2_bytes`` is 0), so
every icosphere here is ordered; the tests of the rule's other side give
the precompute a cache.

- Equivalence: on icosphere(3), the ordered public precompute solves as a
  hierarchy that ``build_device_hierarchy`` builds from the same host
  operators in the given order, for every smoother, constrained or not, at
  1 and 3 columns, in f64 and with f64 refinement around f32 cycles.
- Engagement and bypass: an icosphere is ordered and its band narrows; an
  input already in RCM order under a cache that holds its band, a mesh
  under the H100's L2, the refreshable solver's hierarchy and
  ``build_device_hierarchy``'s own keep the caller's order; the ordering
  survives a save and a load; the host operators the precompute leaves on
  ``mg`` and ``LHS`` are the given order's, bit for bit.
"""

import copy

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from surface_multigrid_code_torch import (
    SolveConfig,
    mg_precompute,
    min_quad_with_fixed_mg_precompute,
    min_quad_with_fixed_mg_solve,
)
from surface_multigrid_code_torch.config import SmootherType
from surface_multigrid_code_torch.ops.laplacian import cotmatrix, massmatrix
from surface_multigrid_code_torch.ops.sparse import csr_from_scipy
from surface_multigrid_code_torch.solver import mqwf_mg
from surface_multigrid_code_torch.solver.ordering import bandwidth, finest_rcm
from surface_multigrid_code_torch.solver.refresh import RefreshableMGSolver
from surface_multigrid_code_torch.solver.serialize import (
    load_device_hierarchy,
    save_device_hierarchy,
)
from surface_multigrid_code_torch.solver.vcycle import (
    build_device_hierarchy,
    solve_loop,
    solve_loop_ir,
)
from surface_multigrid_code_torch.utils.device import l2_bytes
from surface_multigrid_code_torch.utils.synthetic import icosphere

torch.set_num_threads(1)

KNOWN = np.arange(0, 642, 61)
# A cache that holds icosphere(3)'s band in RCM order (41 rows of about
# 128 bytes in f64) and not in the mesh's own (483 rows)
BAND_CACHE = 2**14
H100_L2 = 50 * 2**20


@pytest.fixture(scope="module")
def ico3():
    V, F = icosphere(3)
    mg = mg_precompute(V, F, min_coarsest_nv=40, verbose=False)
    M = massmatrix(V, F)
    return V, mg, (M - 0.01 * cotmatrix(V, F)).tocsr(), M


def _given_order(mg):
    """The host operators the precompute leaves on mg, finest first."""
    return [lv.A for lv in mg], [lv.P for lv in mg[1:]]


@pytest.mark.parametrize("precision", ["f64", "f32_refine"])
@pytest.mark.parametrize("cols", [1, 3])
@pytest.mark.parametrize("constrained", [False, True], ids=["free", "known"])
@pytest.mark.parametrize("smoother", ["jacobi", "multicolor_gs", "chebyshev"])
def test_ordered_solve_is_the_given_orders(ico3, smoother, constrained, cols, precision):
    """Same cycle count, z within 1e-10 relative, and r_his within 1e-10
    relative in f64. With f32 cycles the two orders of each row's sum round
    apart by f32's epsilon in every cycle, so r_his agrees to 1e-4 relative
    (the cases read up to 5e-6 above the floor below); z, refined in f64 to
    a 1e-11 relative residual, still to 1e-10."""
    V, mg, A, M = ico3
    mg = copy.deepcopy(mg)
    cfg = SolveConfig(smoother=SmootherType(smoother))
    dtype = torch.float64 if precision == "f64" else torch.float32
    known = KNOWN if constrained else None
    data = min_quad_with_fixed_mg_precompute(A, known, mg, cfg, device="cpu", dtype=dtype)
    assert data.perm is not None and data.hier.perm is not None
    As, Ps = _given_order(mg)
    ref = build_device_hierarchy(As, Ps, cfg, device="cpu", dtype=dtype,
                                 colorings=data.colorings)
    B = np.asarray(M @ V[:, :cols]) if cols > 1 else np.asarray(M @ V[:, 0])
    rhs = torch.as_tensor(B[data.unknown])
    z0 = torch.zeros_like(rhs)
    if precision == "f64":
        tol = 1e-9 * float(torch.linalg.norm(rhs))
        runs = [solve_loop(h, rhs, z0, tol, 40, cfg) for h in (data.hier, ref)]
        r_tol = 1e-10
    else:
        tol = 1e-11 * float(torch.linalg.norm(rhs))
        A64 = csr_from_scipy(As[0], "cpu", torch.float64)
        runs = [solve_loop_ir(data.hier, data.A64, rhs, z0, tol, 40, cfg),
                solve_loop_ir(ref, A64, rhs, z0, tol, 40, cfg)]
        r_tol = 1e-4
    (z, r, k), (z_ref, r_ref, k_ref) = runs
    assert k == k_ref and 3 <= k < 40 and float(r_ref[k - 1]) <= tol
    # entries near the end sit near the f64 floor of ||b - A z||, which the
    # two orders of each row's sum move by about eps ||(|b| + |A||z|)||
    zh = np.abs(z_ref.double().numpy())
    floor = 16 * np.finfo(np.float64).eps * np.linalg.norm(
        np.abs(rhs.numpy()) + abs(As[0]) @ zh)
    np.testing.assert_allclose(r[:k].numpy(), r_ref[:k].numpy(), rtol=r_tol, atol=floor)
    assert float(torch.linalg.norm(z - z_ref)) <= 1e-10 * float(torch.linalg.norm(z_ref))


def test_an_icosphere_is_ordered_and_its_band_narrows(ico3):
    V, mg, A, M = ico3
    data = min_quad_with_fixed_mg_precompute(A, None, copy.deepcopy(mg), device="cpu",
                                             dtype=torch.float64)
    A0 = data.hier.levels[0].A
    ordered = sp.csr_matrix((A0.data.numpy(), A0.indices.numpy(), A0.indptr.numpy()),
                            shape=A0.shape)
    assert np.array_equal(data.hier.perm.numpy(), data.perm)
    assert np.array_equal(data.hier.perm[data.hier.iperm].numpy(), np.arange(A.shape[0]))
    assert bandwidth(ordered) == bandwidth(A[data.perm][:, data.perm]) < bandwidth(A)
    assert (ordered != A[data.perm][:, data.perm]).nnz == 0


def test_an_input_in_rcm_order_keeps_it(ico3, monkeypatch):
    """Under a cache that holds RCM's band and not the mesh's own, the
    mesh's order is ordered and an input already in RCM order is kept."""
    V, mg, A, M = ico3
    monkeypatch.setattr(mqwf_mg, "l2_bytes", lambda device: BAND_CACHE)
    p = finest_rcm(A)
    given = min_quad_with_fixed_mg_precompute(A, None, copy.deepcopy(mg), device="cpu",
                                              dtype=torch.float64)
    mg = copy.deepcopy(mg)
    mg[1].P_full = mg[1].P_full.tocsr()[p]
    data = min_quad_with_fixed_mg_precompute(A[p][:, p].tocsr(), None, mg, device="cpu",
                                             dtype=torch.float64)
    assert given.perm is not None
    assert data.perm is None and data.hier.perm is None and data.hier.iperm is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_a_mesh_in_the_l2_keeps_its_order(ico3, monkeypatch, dtype):
    """Under the H100's L2 the whole of icosphere(3) is cached: the
    precompute keeps the caller's order and solves as the hierarchy
    ``build_device_hierarchy`` builds from the same operators."""
    V, mg, A, M = ico3
    assert l2_bytes("cpu") == 0
    monkeypatch.setattr(mqwf_mg, "l2_bytes", lambda device: H100_L2)
    mg = copy.deepcopy(mg)
    cfg = SolveConfig()
    data = min_quad_with_fixed_mg_precompute(A, None, mg, cfg, device="cpu", dtype=dtype)
    assert data.perm is None and data.hier.perm is None
    ref = build_device_hierarchy(*_given_order(mg), cfg, device="cpu", dtype=dtype)
    rhs = torch.as_tensor(np.asarray(M @ V), dtype=dtype)
    runs = [solve_loop(h, rhs, torch.zeros_like(rhs), 1e-5, 20, cfg) for h in (data.hier, ref)]
    assert runs[0][2] == runs[1][2] and torch.equal(runs[0][0], runs[1][0])


def test_other_builders_keep_the_callers_order(ico3):
    V, mg, A, M = ico3
    mg = copy.deepcopy(mg)
    data = min_quad_with_fixed_mg_precompute(A, None, mg, device="cpu", dtype=torch.float64)
    As, Ps = _given_order(mg)
    assert build_device_hierarchy(As, Ps, device="cpu").perm is None
    solver = RefreshableMGSolver(mg, A, dtype=torch.float64, device="cpu")
    hier = solver.refresh(torch.as_tensor(A.data))
    assert data.perm is not None and hier.perm is None


def test_the_ordering_survives_save_and_load(ico3, tmp_path):
    V, mg, A, M = ico3
    cfg = SolveConfig(smoother=SmootherType.MULTICOLOR_GS)
    data = min_quad_with_fixed_mg_precompute(A, None, copy.deepcopy(mg), cfg, device="cpu",
                                             dtype=torch.float64)
    save_device_hierarchy(tmp_path / "h.pt", data.hier)
    got = load_device_hierarchy(tmp_path / "h.pt", device="cpu")
    assert torch.equal(got.perm, data.hier.perm) and torch.equal(got.iperm, data.hier.iperm)
    rhs = torch.as_tensor(np.asarray(M @ V))
    runs = [solve_loop(h, rhs, torch.zeros_like(rhs), 1e-8, 20, cfg) for h in (data.hier, got)]
    assert runs[0][2] == runs[1][2] and torch.equal(runs[0][0], runs[1][0])


@pytest.mark.parametrize("constrained", [False, True], ids=["free", "known"])
def test_host_operators_stay_in_the_given_order(ico3, constrained):
    """What the benchmark's byte count reads: mg's A, P, PT and data.LHS
    are the Galerkin products in the caller's order, bit for bit."""
    V, mg, A, M = ico3
    cfg = SolveConfig()
    known = KNOWN if constrained else None
    want = copy.deepcopy(mg)
    _known, _unknown, LHS, _Auk = mqwf_mg._galerkin(A.astype(np.float64), known, want, cfg)
    got = copy.deepcopy(mg)
    data = min_quad_with_fixed_mg_precompute(A, known, got, cfg, device="cpu",
                                             dtype=torch.float64)
    assert data.perm is not None

    def same(S, T):
        return (S.shape == T.shape and np.array_equal(S.indptr, T.indptr)
                and np.array_equal(S.indices, T.indices) and np.array_equal(S.data, T.data))

    assert same(data.LHS, LHS)
    for lv, (g, w) in enumerate(zip(got, want)):
        assert same(g.A, w.A), lv
        if lv:
            assert same(g.P, w.P) and same(g.PT, w.PT), lv


def test_public_solve_answers_in_the_callers_order(ico3):
    """min_quad_with_fixed_mg_solve on the ordered hierarchy: the answer's
    residual, taken on the host in the caller's order, is the one the loop
    recorded."""
    V, mg, A, M = ico3
    data = min_quad_with_fixed_mg_precompute(A, KNOWN, copy.deepcopy(mg), device="cpu",
                                             dtype=torch.float64)
    B = np.asarray(M @ V)
    kv = V[KNOWN]
    z, r_his, ok = min_quad_with_fixed_mg_solve(data, B, known_val=kv, tolerance=1e-10)
    assert ok and np.array_equal(z[KNOWN], kv)
    r = B[data.unknown] - A[data.unknown] @ z
    assert abs(np.linalg.norm(r) - r_his[-1]) <= 1e-6 * r_his[-1] + 1e-15
