"""The port's region profiler, host allocator pooling and package exports
against the JAX package's.

- ``profile_region`` accumulates count and time per name, and the report
  has the JAX report's header and rows (the same registry code);
- ``trace=True`` shows up as a span of that name in a CPU
  ``torch.profiler`` trace, and opens none while no session records;
- the three sites the JAX package profiles open their regions in the
  port too (``SSP: decimate``, ``MG: total VCycle``, ``MG: refresh+solve``);
- the hot-path ``span`` and the ``smg.spmv`` counter record nothing
  without a session; under one, a ``solve_loop`` fills ``smg.solve``,
  ``smg.test``, ``smg.cycle`` and ``smg.level.<l>`` with the counts of its
  loop, nested on the profiler's timeline, and its answer is bit for bit
  the answer without a session;
- the ``smg.permute`` counter takes one entry a solve on an ordered
  hierarchy and none on one in the caller's order;
- the precompute's ``smg.precompute`` region holds the phases that ran,
  ``.ordering`` among them;
- the benchmark's readers of those entries (``portbench/metrics/``);
- ``pool_host_allocations`` honours the JAX package's opt-out variable;
- the package exports ``get_prolong``, ``get_prolong_block`` and
  ``extend_hierarchy`` as the JAX package does.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

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


def test_session_flag_is_the_autograd_module_boolean():
    """``span``'s switch: a torch upgrade that drops or renames the
    boolean fails here."""
    import torch.autograd.profiler as autograd_profiler

    assert autograd_profiler._is_profiler_enabled is False
    assert tprof._autograd is autograd_profiler
    with profile(activities=[ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled is True and tprof.recording()
    assert autograd_profiler._is_profiler_enabled is False and not tprof.recording()


def test_fast_annotation_is_an_event_of_the_session():
    """``span``'s annotation: a torch upgrade that drops PyTorch's
    ``_RecordFunctionFast`` fails here; its events nest in the host tree."""
    from torch._C._profiler import _RecordFunctionFast

    assert tprof._RecordFunctionFast is _RecordFunctionFast
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with _RecordFunctionFast("smg.outer"), _RecordFunctionFast("smg.inner"):
            torch.ones(3).sum()
    parent = {e.name: e.cpu_parent.name if e.cpu_parent else None for e in prof.events()
              if e.name.startswith("smg.")}
    assert parent == {"smg.outer": None, "smg.inner": "smg.outer"}


def test_spans_only_while_a_session_records(monkeypatch):
    opened = []
    real_rf, real_fast = tprof._autograd.record_function, tprof._RecordFunctionFast
    monkeypatch.setattr(tprof._autograd, "record_function",
                        lambda name, *a: opened.append(name) or real_rf(name, *a))
    monkeypatch.setattr(tprof, "_RecordFunctionFast",
                        lambda name: opened.append(name) or real_fast(name))
    ours = {"smg.x", "smg.y", "port: region"}

    def run():
        with tprof.span("smg.x"):
            if tprof.recording():  # a counter, as ``fused_spmv`` writes one
                tprof.record("smg.y", 0.0)
        with tprof.profile_region("port: region", trace=True):
            pass

    tprof.profiler_reset()
    run()
    assert [n for n in opened if n in ours] == []
    assert set(tprof.profiler_snapshot()) == {"port: region"}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    assert [n for n in opened if n in ours] == ["smg.x", "port: region"]
    snap = tprof.profiler_snapshot()
    assert {n: c for n, (c, _) in snap.items()} == {"smg.x": 1, "smg.y": 1, "port: region": 2}
    names = {e.key for e in prof.key_averages()}
    assert {"smg.x", "port: region"} <= names and "smg.y" not in names


@pytest.fixture(scope="module")
def small_system():
    """icosphere(2) with its SSP hierarchy, A = M - 0.01 L and B = M V."""
    from surface_multigrid_code_torch.ops.laplacian import cotmatrix, massmatrix
    from surface_multigrid_code_torch.utils.synthetic import icosphere

    V, F = icosphere(2)
    mg = tpkg.mg_precompute(V, F, min_coarsest_nv=40, verbose=False)
    M = massmatrix(V, F)
    return mg, (M - 0.01 * cotmatrix(V, F)).tocsr(), np.asarray(M @ V)


def _precompute(small_system, smoother, known=None):
    from surface_multigrid_code_torch import min_quad_with_fixed_mg_precompute
    from surface_multigrid_code_torch.config import SolveConfig

    mg, A, _ = small_system
    cfg = SolveConfig(smoother=smoother)
    return min_quad_with_fixed_mg_precompute(A, known, mg, cfg, dtype=torch.float64,
                                             device="cpu"), cfg


def _ancestors(event):
    while event.cpu_parent is not None:
        event = event.cpu_parent
        if event.name.startswith("smg."):
            yield event.name


@pytest.mark.parametrize("smoother", ["jacobi", "multicolor_gs"])
def test_solve_loop_spans(small_system, smoother):
    from surface_multigrid_code_torch.ops.spmv import fused_spmv_plain
    from surface_multigrid_code_torch.solver.vcycle import solve_loop

    data, cfg = _precompute(small_system, smoother)
    B = torch.as_tensor(small_system[2])
    tol, max_iter = 1e-9 * float(torch.linalg.norm(B)), 40

    def solve():
        calls = fused_spmv_plain.calls
        z, r_his, k = solve_loop(data.hier, B, torch.zeros_like(B), tol, max_iter, cfg)
        return z, r_his, k, fused_spmv_plain.calls - calls

    tprof.profiler_reset()
    z0, r0, k0, calls0 = solve()
    assert tprof.profiler_snapshot() == {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        z1, r1, k1, calls1 = solve()
    assert torch.equal(z1, z0) and torch.equal(r1, r0) and (k1, calls1) == (k0, calls0)
    assert 3 <= k1 < max_iter
    assert data.hier.perm is not None
    levels = [f"smg.level.{lv}" for lv in range(data.hier.n_levels)]
    counts = {n: c for n, (c, _) in tprof.profiler_snapshot().items()}
    want = {"smg.solve": 1, "smg.test": k1, "smg.cycle": k1 - 1, "smg.spmv": calls1,
            "smg.permute": 1, **{n: k1 - 1 for n in levels}}
    assert counts == want
    # on the profiler's timeline: every span but the counters, nested
    traced = {e.key: e.count for e in prof.key_averages() if e.key.startswith("smg.")}
    assert traced == {n: c for n, c in want.items() if n not in ("smg.spmv", "smg.permute")}
    seen = set()
    for e in prof.events():
        if e.name.startswith("smg.level."):
            lv = int(e.name.rsplit(".", 1)[1])
            up = [f"smg.level.{m}" for m in range(lv - 1, -1, -1)] + ["smg.cycle", "smg.solve"]
            assert list(_ancestors(e)) == up
            seen.add(e.name)
        elif e.name in ("smg.cycle", "smg.test"):
            assert list(_ancestors(e)) == ["smg.solve"]
    assert seen == set(levels)


@pytest.mark.parametrize("smoother, constrained", [
    ("jacobi", False), ("multicolor_gs", False), ("multicolor_gs", True)])
def test_precompute_phases(small_system, smoother, constrained):
    tprof.profiler_reset()
    _precompute(small_system, smoother, np.arange(0, 40, 7) if constrained else None)
    snap = tprof.profiler_snapshot()
    count, total = snap.pop("smg.precompute")
    phases = {"symmetry", "galerkin", "device_build", "coarse_inverse", "ordering"}
    if smoother == "multicolor_gs":
        phases.add("coloring")
    assert set(snap) == {f"smg.precompute.{p}" for p in phases}
    assert count == 1 and all(c == 1 for c, _ in snap.values())
    assert sum(t for _, t in snap.values()) <= total


@pytest.mark.parametrize("ordered", [True, False], ids=["ordered", "given_order"])
def test_permute_counts_a_solve_on_an_ordered_hierarchy(small_system, ordered):
    """Two solves under a session: two ``smg.permute`` entries on the
    precompute's ordered hierarchy, none on ``build_device_hierarchy``'s
    from the same operators; none without a session."""
    from surface_multigrid_code_torch.config import SmootherType
    from surface_multigrid_code_torch.solver.vcycle import build_device_hierarchy, solve_loop

    data, cfg = _precompute(small_system, SmootherType.JACOBI)
    mg = small_system[0]
    hier = data.hier if ordered else build_device_hierarchy(
        [lv.A for lv in mg], [lv.P for lv in mg[1:]], cfg, device="cpu", dtype=torch.float64)
    assert (hier.perm is not None) == ordered
    B = torch.as_tensor(small_system[2])
    tprof.profiler_reset()
    solve_loop(hier, B, torch.zeros_like(B), 1e-9, 20, cfg)
    assert "smg.permute" not in tprof.profiler_snapshot()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            solve_loop(hier, B, torch.zeros_like(B), 1e-9, 20, cfg)
    count, seconds = tprof.profiler_snapshot().get("smg.permute", (0, 0.0))
    assert count == (2 if ordered else 0) and seconds >= 0.0


@pytest.mark.parametrize("metric, entry, planted, reading", [
    ("enqueue_ms_per_cycle.solve", "smg.cycle", (3, 0.0045), 1.5),
    ("launch_host_us.solve", "smg.spmv", (130, 0.0039), 30.0),
    ("precompute_s", "smg.precompute", (1, 7.25), 7.25),
])
def test_benchmark_readers(monkeypatch, metric, entry, planted, reading):
    """Each reader on a planted snapshot, on an empty one, and on a
    program that has no snapshot to read."""
    from portbench.run import load_module

    read = load_module("metrics", metric).read
    monkeypatch.setattr(tprof, "profiler_snapshot",
                        lambda: {entry: planted, "smg.other": (2, 1.0)})
    assert read({}) == pytest.approx(reading)
    monkeypatch.setattr(tprof, "profiler_snapshot", lambda: {})
    assert read({}) is None
    monkeypatch.delattr(tprof, "profiler_snapshot")
    assert read({}) is None
