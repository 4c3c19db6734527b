"""The port's region profiler, host allocator pooling and package exports
against the JAX package's.

- ``profile_region`` accumulates count and time per name, and the report
  has the JAX report's header and rows (the same registry code);
- ``trace=True`` shows up as a span of that name in a CPU
  ``torch.profiler`` trace;
- the three sites the JAX package profiles open their regions in the
  port too (``SSP: decimate``, ``MG: total VCycle``, ``MG: refresh+solve``);
- ``pool_host_allocations`` honours the JAX package's opt-out variable;
- the package exports ``get_prolong``, ``get_prolong_block`` and
  ``extend_hierarchy`` as the JAX package does.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import torch

from surface_multigrid_code_tpu.utils import profiler as jprof

import surface_multigrid_code_torch as tpkg
from surface_multigrid_code_torch.utils import profiler as tprof

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _fill(prof):
    prof.profiler_reset()
    for _ in range(3):
        with prof.profile_region("alpha"):
            time.sleep(0.002)
    with prof.profile_region("a much longer region name"):
        pass
    return prof.profiler_report()


def test_regions_accumulate_and_report_like_jax():
    ours, theirs = _fill(tprof), _fill(jprof)
    node = tprof._REGISTRY._nodes["alpha"]
    assert node.count == 3 and node.elapsed_s >= 0.006
    lo, lj = ours.splitlines(), theirs.splitlines()
    assert lo[0] == lj[0] and lo[0].split() == ["region", "count", "elapsed_s", "us/call"]
    assert len(lo) == len(lj) == 3
    assert [r.split()[0] for r in lo[1:]] == [r.split()[0] for r in lj[1:]] == ["alpha", "a"]
    assert [len(r) for r in lo] == [len(r) for r in lj]
    tprof.profiler_reset()
    assert tprof.profiler_report() == ""


def test_trace_region_is_a_torch_profiler_span():
    tprof.profiler_reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tprof.profile_region("port: traced region", trace=True):
            torch.ones(8).sum()
        with tprof.profile_region("port: untraced region"):
            torch.ones(8).sum()
    names = {e.key for e in prof.key_averages()}
    assert "port: traced region" in names
    assert "port: untraced region" not in names
    assert tprof._REGISTRY._nodes["port: traced region"].count == 1


def test_profiled_sites():
    from surface_multigrid_code_torch import (
        min_quad_with_fixed_mg_precompute,
        min_quad_with_fixed_mg_solve,
    )
    from surface_multigrid_code_torch.ops.laplacian import cotmatrix, massmatrix
    from surface_multigrid_code_torch.solver.refresh import RefreshableMGSolver
    from surface_multigrid_code_torch.ssp.decimate import SSP_decimate
    from surface_multigrid_code_torch.utils.synthetic import icosphere

    tprof.profiler_reset()
    V, F = icosphere(2)
    assert SSP_decimate(V, F, F.shape[0] // 4)[0]
    mg = tpkg.mg_precompute(V, F, min_coarsest_nv=40, verbose=False)
    A = (massmatrix(V, F) - 0.01 * cotmatrix(V, F)).tocsr()
    data = min_quad_with_fixed_mg_precompute(A, None, mg, dtype=torch.float64, device="cpu")
    b = massmatrix(V, F) @ V[:, 0]
    min_quad_with_fixed_mg_solve(data, b)
    RefreshableMGSolver(mg, A, dtype=torch.float64, device="cpu").solve(A.data, b)
    nodes = tprof._REGISTRY._nodes
    for name in ("SSP: decimate", "MG: total VCycle", "MG: refresh+solve"):
        assert nodes[name].count >= 1, name


def test_host_pooling_opt_out_and_exports():
    from surface_multigrid_code_torch.solver import hierarchy

    assert tpkg.get_prolong is hierarchy.get_prolong
    assert tpkg.get_prolong_block is hierarchy.get_prolong_block
    assert tpkg.extend_hierarchy is hierarchy.extend_hierarchy
    assert {"get_prolong", "get_prolong_block", "extend_hierarchy"} <= set(tpkg.__all__)
    code = ("import surface_multigrid_code_torch.utils.hostmem as h; "
            "print(h._applied, h.pool_host_allocations())")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = {}
    for opt_out in ("", "1"):
        env["SMC_TPU_NO_MALLOC_POOL"] = opt_out
        run = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=120)
        assert run.returncode == 0, run.stderr
        out[opt_out] = run.stdout.split()
    # importing the package applies the pooling (glibc), unless opted out
    assert out[""] == ["True", "True"]
    assert out["1"] == ["False", "False"]
