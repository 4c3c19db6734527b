"""Persistence: the collapse log and the host hierarchy across packages, and
the port's own device containers through torch.

The log and the hierarchy npz are one format in both packages, so a file
either writes loads in the other. The device containers (``DeviceHierarchy``,
``BsrHierarchy`` and the rest, ``solver/serialize.py``) round-trip every
tensor bit for bit with its dtype, float64 and int64 included, and a
loaded hierarchy gives bitwise the same solve.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from surface_multigrid_code_tpu.solver.hierarchy import load_hierarchy as jax_load_hierarchy
from surface_multigrid_code_tpu.solver.hierarchy import mg_precompute as jax_mg_precompute
from surface_multigrid_code_tpu.solver.hierarchy import save_hierarchy as jax_save_hierarchy
from surface_multigrid_code_tpu.ssp.decimate import load_log as jax_load_log
from surface_multigrid_code_tpu.ssp.decimate import save_log as jax_save_log
from surface_multigrid_code_tpu.utils.synthetic import icosphere

from surface_multigrid_code_torch import (
    SolveConfig,
    load_device_hierarchy,
    load_hierarchy,
    mg_precompute,
    min_quad_with_fixed_mg_precompute,
    min_quad_with_fixed_mg_solve,
    save_device_hierarchy,
    save_hierarchy,
)
from surface_multigrid_code_torch.config import SmootherType
from surface_multigrid_code_torch.ops.laplacian import cotmatrix, massmatrix
from surface_multigrid_code_torch.ops.sparse import CSRMatrix, csr_from_scipy
from surface_multigrid_code_torch.solver import serialize
from surface_multigrid_code_torch.solver.bsr import BsrRefreshableSolver, bsr_solve_loop
from surface_multigrid_code_torch.solver.vcycle import solve_loop
from surface_multigrid_code_torch.ssp.decimate import SSP_decimate, load_log, save_log

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ico3():
    V, F = icosphere(3)
    A = (massmatrix(V, F) - 0.01 * cotmatrix(V, F)).tocsr()
    return V, F, A


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_log_npz_across_packages(tmp_path, ico3, writer):
    V, F, _ = ico3
    ok, *_rest, log = SSP_decimate(V, F, 320, 1)
    assert ok
    save, load = (jax_save_log, load_log) if writer == "jax" else (save_log, jax_load_log)
    save(tmp_path / "log.npz", log)
    got = load(tmp_path / "log.npz")
    assert sorted(got) == sorted(log)
    for k in log:
        assert got[k].dtype == log[k].dtype and np.array_equal(got[k], log[k]), k


def _same_levels(a, b):
    assert len(a) == len(b) >= 2
    for la, lb in zip(a, b):
        assert np.array_equal(la.V, lb.V) and np.array_equal(la.F, lb.F)
        assert (la.ratio, None if la.dec_type is None else int(la.dec_type)) == \
            (lb.ratio, None if lb.dec_type is None else int(lb.dec_type))
        if la.P_full is None:
            assert lb.P_full is None
            continue
        for P, Q in ((la.P_full, lb.P_full), (la.PT, lb.PT)):
            assert P.shape == Q.shape and (P != Q).nnz == 0
            assert np.array_equal(P.indptr, Q.indptr) and np.array_equal(P.data, Q.data)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_hierarchy_npz_across_packages(tmp_path, ico3, writer):
    V, F, _ = ico3
    if writer == "jax":
        mg = jax_mg_precompute(V, F, min_coarsest_nv=40, verbose=False)
        jax_save_hierarchy(tmp_path / "h.npz", mg)
        got = load_hierarchy(tmp_path / "h.npz")
    else:
        mg = mg_precompute(V, F, min_coarsest_nv=40, verbose=False)
        save_hierarchy(tmp_path / "h.npz", mg)
        got = jax_load_hierarchy(tmp_path / "h.npz")
    _same_levels(mg, got)


def test_jax_written_hierarchy_gives_the_same_solve(tmp_path, ico3):
    """A hierarchy the JAX package wrote, loaded in the port, solves as the
    port's own hierarchy does, residual for residual."""
    V, F, A = ico3
    jax_save_hierarchy(tmp_path / "h.npz", jax_mg_precompute(V, F, min_coarsest_nv=40,
                                                             verbose=False))
    b = np.asarray(massmatrix(V, F) @ V[:, 0])
    runs = []
    for mg in (mg_precompute(V, F, min_coarsest_nv=40, verbose=False),
               load_hierarchy(tmp_path / "h.npz")):
        data = min_quad_with_fixed_mg_precompute(A, None, mg, device="cpu", dtype=torch.float64)
        runs.append(min_quad_with_fixed_mg_solve(data, b, tolerance=1e-8))
    (z0, r0, ok0), (z1, r1, ok1) = runs
    assert ok0 and ok1 and r0 == r1 and np.array_equal(z0, z1)


def _same_module(a, b):
    """Every buffer bitwise equal with its dtype, and the plain attributes."""
    sa, sb = a.state_dict(), b.state_dict()
    assert list(sa) == list(sb)
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and sa[k].device == sb[k].device, k
        assert torch.equal(sa[k], sb[k]), k
    for (na, ma), (nb, mb) in zip(a.named_modules(), b.named_modules()):
        assert na == nb and type(ma) is type(mb)
        for attr in ("lanes", "n_cols", "lam_max", "n_groups"):
            assert getattr(ma, attr, None) == getattr(mb, attr, None), (na, attr)


@pytest.mark.parametrize("smoother", ["jacobi", "multicolor_gs", "chebyshev"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_device_hierarchy_round_trip(tmp_path, ico3, smoother, dtype):
    V, F, A = ico3
    cfg = SolveConfig(smoother=SmootherType(smoother))
    data = min_quad_with_fixed_mg_precompute(
        A, None, mg_precompute(V, F, min_coarsest_nv=40, verbose=False), cfg,
        device="cpu", dtype=dtype)
    save_device_hierarchy(tmp_path / "h.pt", data.hier)
    got = load_device_hierarchy(tmp_path / "h.pt", device="cpu")
    _same_module(data.hier, got)
    rhs = torch.as_tensor(massmatrix(V, F) @ V[:, 1], dtype=dtype)
    runs = [solve_loop(h, rhs, torch.zeros_like(rhs), 1e-6, 8, cfg) for h in (data.hier, got)]
    assert runs[0][2] == runs[1][2] and torch.equal(runs[0][1], runs[1][1])
    assert torch.equal(runs[0][0], runs[1][0])


def test_bsr_hierarchy_round_trip(tmp_path, ico3):
    """A refreshed BsrHierarchy (f64 blocks, int32 patterns) round-trips
    and gives bitwise the same block solve."""
    V, F, _ = ico3
    mg = mg_precompute(V, F, min_coarsest_nv=40, verbose=False)
    n = V.shape[0]
    E = sp.coo_matrix((np.ones(3 * F.shape[0]), (F.ravel(), np.roll(F, 1, 1).ravel())),
                      shape=(n, n))
    adj = ((E + E.T) > 0).astype(np.float64)
    lap = (sp.diags(np.asarray(adj.sum(1)).ravel() + 0.5) - adj).tocsr()  # SPD
    solver = BsrRefreshableSolver(mg, lap, dtype=torch.float64, device="cpu")
    p = solver.pattern_v
    rng = np.random.default_rng(3)
    off = 0.05 * rng.standard_normal((p.nnz, 3, 3))
    blocks = p.data[:, None, None] * np.eye(3) + 0.5 * (off + off.transpose(0, 2, 1)) * \
        (p.indices == np.repeat(np.arange(n), np.diff(p.indptr)))[:, None, None]
    hier = solver.refresh(torch.as_tensor(blocks))
    save_device_hierarchy(tmp_path / "b.pt", hier)
    got = load_device_hierarchy(tmp_path / "b.pt", device="cpu")
    _same_module(hier, got)
    rhs = torch.as_tensor(rng.standard_normal((n, 3)))
    runs = [bsr_solve_loop(h, rhs, torch.zeros_like(rhs), 1e-8, 10, solver.cfg)
            for h in (hier, got)]
    assert runs[0][2] == runs[1][2] > 1 and torch.equal(runs[0][1], runs[1][1])


def test_save_pytree_nested(tmp_path):
    """Nested dict / tuple / list / None / literals / tensors of every
    dtype and a CSRMatrix come back as saved, types and all."""
    A = csr_from_scipy(sp.random(7, 5, density=0.4, random_state=1, format="csr"), "cpu",
                       torch.float64)
    A.lanes = 2  # a forced width survives
    tree = {
        "f64": torch.tensor([1.0 / 3.0, -2.5e-300], dtype=torch.float64),
        "i64": torch.tensor([2**40, -7], dtype=torch.int64),
        "mixed": (torch.arange(4, dtype=torch.int32), [None, True, 3, 0.1, "s"],
                  torch.zeros((0, 3), dtype=torch.float32)),
        "op": A,
        "empty": {},
    }
    serialize.save_pytree(tmp_path / "t.pt", tree)
    got = serialize.load_pytree(tmp_path / "t.pt", device="cpu")
    assert sorted(got) == sorted(tree)
    for k in ("f64", "i64"):
        assert got[k].dtype == tree[k].dtype and torch.equal(got[k], tree[k])
    assert isinstance(got["mixed"], tuple) and isinstance(got["mixed"][1], list)
    assert torch.equal(got["mixed"][0], tree["mixed"][0]) and got["mixed"][0].dtype == torch.int32
    assert got["mixed"][1] == [None, True, 3, 0.1, "s"]
    assert got["mixed"][2].shape == (0, 3) and got["empty"] == {}
    assert isinstance(got["op"], CSRMatrix)
    _same_module(A, got["op"])
    assert got["op"].lanes == 2


def test_save_pytree_refuses_what_it_cannot_rebuild(tmp_path):
    with pytest.raises(TypeError, match="str dict keys"):
        serialize.save_pytree(tmp_path / "x.pt", {1: torch.zeros(1)})
    with pytest.raises(TypeError, match="cannot serialize"):
        serialize.save_pytree(tmp_path / "x.pt", {"a": object()})


def test_load_device_hierarchy_default_device_is_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    serialize.save_pytree(tmp_path / "t.pt", {"a": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_device_hierarchy(tmp_path / "t.pt")
