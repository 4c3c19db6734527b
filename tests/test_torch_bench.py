"""The port's bench (``surface_multigrid_code_torch/bench.py``) and ``entry()`` against the JAX package's.

On the CPU the bench runs ``bench.py``'s small case, icosphere(4) in
float64: its line must parse and carry its fields, its residual history
must be the JAX package's ``solve_loop`` on the same system (rtol 1e-8),
and its byte count must be the sum of the SpMV launches a cycle makes.
``entry()``'s V-cycle must be the JAX ``__graft_entry__.entry(well=False)``
V-cycle in float32.
"""

import importlib
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from surface_multigrid_code_tpu.config import SmootherType as JSmoother
from surface_multigrid_code_tpu.config import SolveConfig as JSolveConfig
from surface_multigrid_code_tpu.ops.laplacian import cotmatrix as jcot
from surface_multigrid_code_tpu.ops.laplacian import massmatrix as jmass
from surface_multigrid_code_tpu.solver.hierarchy import mg_precompute as jmg_precompute
from surface_multigrid_code_tpu.solver.mqwf_mg import (
    min_quad_with_fixed_mg_precompute as jprecompute,
)
from surface_multigrid_code_tpu.utils.synthetic import icosphere as jicosphere

from surface_multigrid_code_torch import bench
from surface_multigrid_code_torch.entry import entry

REPO = Path(__file__).resolve().parents[1]
# the JAX package's solver/__init__ re-exports a function named vcycle
jvc = importlib.import_module("surface_multigrid_code_tpu.solver.vcycle")

torch.set_num_threads(1)


def _root_module(name):
    spec = importlib.util.spec_from_file_location(f"_{name}", REPO / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def cpu_record(tmp_path_factory):
    return bench.run("cpu", tmp_path_factory.mktemp("bench_cache"))


def test_python_m_bench_prints_one_json_line(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(REPO), env.get("PYTHONPATH", "")) if p)
    out = subprocess.run(
        [sys.executable, "-m", "surface_multigrid_code_torch", "bench", "--device", "cpu",
         "--cache-dir", str(tmp_path)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert (rec["metric"], rec["unit"], rec["ok"]) == ("vcycle_smoother_spmv_throughput",
                                                       "Gnnz/s", True)
    d = rec["detail"]
    det = d["vcycle_detail"]
    assert rec["value"] == det["gnnz_per_s"] > 0
    assert d["regime"] == "cpu_small" and d["headline"] is None and d["balloon"] is None
    assert d["balloon_step_ms"] is None and any("icosphere(9)" in s for s in d["skipped"])
    assert (det["mesh"], det["n"], det["dtype"]) == ("icosphere(4)", 2562, "float64")
    for key in ("t_vcycle_ms", "host_enqueue_ms", "chain_ms", "nnz_per_cycle",
                "bytes_per_cycle", "levels", "host_s", "check"):
        assert key in det, key
    assert det["host_s"]["cache_loaded"] is False and det["host_s"]["ssp_s"] > 0
    assert len(det["check"]["r_his"]) == bench.RESID_CYCLES and det["check"]["ok"]
    assert d["checks"] == {"detail_residual": True}
    assert d["device"]["platform"] == "cpu"


def test_bench_loads_its_cached_hierarchy(cpu_record, tmp_path):
    """A second run loads the SSP hierarchy the first saved, and solves alike."""
    first = bench.run("cpu", tmp_path)["detail"]["vcycle_detail"]
    again = bench.run("cpu", tmp_path)["detail"]["vcycle_detail"]
    assert not first["host_s"]["cache_loaded"] and again["host_s"]["cache_loaded"]
    assert again["check"]["r_his"] == first["check"]["r_his"]
    assert again["levels"] == first["levels"] == cpu_record["detail"]["vcycle_detail"]["levels"]


def test_bench_r_his_matches_jax_solve_loop(cpu_record):
    """The bench's solve_loop history on icosphere(4) (Jacobi, float64) is
    the JAX package's on the same system, as bench.py builds it, within
    rtol 1e-8."""
    port = cpu_record["detail"]["vcycle_detail"]["check"]["r_his"]
    V, F = jicosphere(bench.CPU_ORDER)
    mg = jmg_precompute(V, F, verbose=False)
    M = jmass(V, F)
    A = (M - 0.01 * jcot(V, F)).tocsr()
    rhs = np.asarray(M @ V[:, 0])
    cfg = JSolveConfig(smoother=JSmoother.JACOBI)
    data = jprecompute(A, None, mg, cfg=cfg, dtype=jnp.float64)
    if data.perm is not None:
        rhs = rhs[data.perm]
    b = jnp.asarray(rhs)
    _z, r_his, k = jvc.solve_loop(data.hier, b, jnp.zeros_like(b), jnp.asarray(0.0),
                                  bench.RESID_CYCLES, cfg)
    jax_r = np.asarray(r_his)[: int(k)]
    assert jax_r.shape == (len(port),)
    np.testing.assert_allclose(port, jax_r, rtol=1e-8)


def test_bench_nnz_count_is_bench_py_s(cpu_record):
    """nnz_per_cycle counts as bench.py's _nnz_per_cycle on the same levels."""
    from surface_multigrid_code_torch import min_quad_with_fixed_mg_precompute

    V, F, mg, _ = bench.ico_hierarchy(bench.CPU_ORDER, None)
    A, _rhs = bench.ico_system(V, F)
    min_quad_with_fixed_mg_precompute(A, None, mg, device="cpu", dtype=torch.float64)
    As, Ps = [lv.A for lv in mg], [lv.P for lv in mg[1:]]
    want = _root_module("bench")._nnz_per_cycle(mg)
    assert bench.nnz_per_cycle(As, Ps) == want == cpu_record["detail"]["vcycle_detail"][
        "nnz_per_cycle"]


def test_cycle_bytes_sum_the_launches_of_a_cycle(monkeypatch):
    """The SpMV bytes of cycle_bytes are spmv_bytes summed over the fused
    SpMV calls one Jacobi V-cycle makes (recorded at the call)."""
    from surface_multigrid_code_torch.config import SmootherType, SolveConfig
    from surface_multigrid_code_torch.ops import smoothers
    from surface_multigrid_code_torch.solver import vcycle as tvc
    from surface_multigrid_code_torch.utils.bounds import spmv_bytes

    As, Ps, rhs, _ = bench.ico_operators(3, None)
    cfg = SolveConfig(smoother=SmootherType.JACOBI)
    hier = tvc.build_device_hierarchy(As, Ps, cfg, device="cpu", dtype=torch.float32)
    seen = []
    real = tvc.fused_spmv

    def record(S, x, epi=None, **kw):
        H = sp.csr_matrix((S.data.double().numpy(), S.indices.numpy(), S.indptr.numpy()),
                          shape=S.shape)
        seen.append(spmv_bytes(H, 1, epi, itemsize=4))
        return real(S, x, epi=epi, **kw)

    monkeypatch.setattr(tvc, "fused_spmv", record)
    monkeypatch.setattr(smoothers, "fused_spmv", record)
    b = torch.as_tensor(rhs, dtype=torch.float32)
    tvc.vcycle(hier, b, torch.zeros_like(b), cfg)
    nbytes, flops = bench.cycle_bytes(As, Ps, 4)
    assert len(seen) == 6 * (len(As) - 1)
    assert nbytes["spmv"] == sum(n for n, _ in seen)
    assert flops == sum(f for _, f in seen) + 2 * As[-1].shape[0] ** 2
    assert nbytes["total"] == nbytes["spmv"] + nbytes["coarse"] + nbytes["vectors"]


def test_bench_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()


def test_entry_matches_jax_entry():
    """One V-cycle of the port's entry() on the CPU against the JAX
    __graft_entry__.entry(well=False), both float32 on the same inputs:
    within 1e-5 of max|z|."""
    fn, args = entry(device="cpu")
    hier, b, z0 = args
    assert b.dtype == torch.float32 and b.device.type == "cpu" and not z0.any()
    z = fn(*args).numpy()
    jfn, jargs = _root_module("__graft_entry__").entry(well=False)
    jz = np.asarray(jfn(*jargs))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jargs[1]))
    assert z.dtype == np.float32 and z.shape == jz.shape and np.isfinite(z).all()
    assert np.abs(z - jz).max() <= 1e-5 * np.abs(jz).max()
