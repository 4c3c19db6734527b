"""The port's spans on the profiler's clock, on the card (``card``: skips without one).

A traced ``solve_loop`` on the icosphere(7) subdivision system
(``entry.system(7)``, Jacobi, float64), at one and at three columns (K1
and K2). Every K1/K2 kernel of the trace is linked to its launch call by
the profiler's correlation id, and:

- the kernel starts no earlier than its launch call, less the skew the
  profiler's mapping of the device's clock onto the host's may leave
  (``CLOCK_SKEW_US``);
- every launch lies inside its solve's ``smg.solve`` span; those inside a
  ``smg.cycle`` lie inside a ``smg.level.<l>`` span, 7 a cycle on every
  level above the coarsest (2 + 2 sweeps, the residual, Pᵀ, P), and the
  others are the residual tests, one a test.

It prints one JSON line: the launches linked, and the smallest and median
launch-to-start offsets in µs. Run it on the card without the JAX
package's test settings:

    python -m pytest --noconftest -p no:cacheprovider -q -s -m card tests/test_torch_card_clock.py
"""

from __future__ import annotations

import json
from collections import Counter
from statistics import median

import pytest
import torch

ORDER = 7
LAUNCHES_A_LEVEL = 7
# The profiler maps CUPTI's device timestamps onto the host's clock, and the
# mapping can slip: in four traced runs of six on an H100 every kernel began
# 5.6 us or more after its launch call; in the other two, kernels began up
# to 81 us (one kernel) and 57 us (most of them) before it.
CLOCK_SKEW_US = 150.0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: the clock check needs one")
    return torch.device("cuda", 0)


def _innermost(spans, t0, t1, prefix):
    """The shortest span named ``prefix...`` that holds [t0, t1]."""
    inside = [(e - s, name) for s, e, name in spans
              if name.startswith(prefix) and s <= t0 and t1 <= e]
    return min(inside)[1] if inside else None


@pytest.mark.card
def test_launches_inside_level_spans(card, tmp_path):
    from surface_multigrid_code_torch.config import SmootherType, SolveConfig
    from surface_multigrid_code_torch.entry import system
    from surface_multigrid_code_torch.ops.spmv import fused_spmv
    from surface_multigrid_code_torch.solver.vcycle import build_device_hierarchy, solve_loop

    As, Ps, rhs = system(ORDER)
    cfg = SolveConfig(smoother=SmootherType.JACOBI)
    hier = build_device_hierarchy(As, Ps, cfg=cfg, device=card, dtype=torch.float64)
    b1 = torch.as_tensor(rhs, device=card, dtype=torch.float64)
    rhs_sets = [b1, torch.stack([b1, -2.0 * b1, b1 * b1], 1).contiguous()]
    tols = [1e-9 * float(torch.linalg.norm(b)) for b in rhs_sets]

    def solves():
        return [solve_loop(hier, b, torch.zeros_like(b), tol, 20, cfg)[2]
                for b, tol in zip(rhs_sets, tols)]

    solves()
    torch.cuda.synchronize(card)
    launches = fused_spmv.launches
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        ks = solves()
        torch.cuda.synchronize(card)
    launches = fused_spmv.launches - launches
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]

    kernels = sorted((e for e in events
                      if e.get("cat") == "kernel" and "spmv_fused" in e["name"]),
                     key=lambda e: e["ts"])
    calls = {e["args"]["correlation"]: e for e in events
             if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {})}
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
             if e.get("cat") in ("cpu_op", "user_annotation") and e["name"].startswith("smg.")]
    assert len(kernels) == launches > 0

    # the launch calls in the kernels' order (one stream), each linked
    call_of = [calls.get(k["args"].get("correlation")) for k in kernels]
    assert all(c is not None for c in call_of), "a K1/K2 kernel has no linked launch call"
    assert [c["ts"] for c in call_of] == sorted(c["ts"] for c in call_of)

    offsets, after_sync, per_level, tests = [], [], Counter(), 0
    test_ends = sorted(e for s, e, name in spans if name == "smg.test")
    for k, call in zip(kernels, call_of):
        t0, t1 = call["ts"], call["ts"] + call["dur"]
        offsets.append(k["ts"] - t0)
        assert _innermost(spans, t0, t1, "smg.solve") is not None
        if _innermost(spans, t0, t1, "smg.cycle") is None:
            tests += 1
            continue
        level = _innermost(spans, t0, t1, "smg.level.")
        assert level is not None, f"a launch at {t0} in a cycle lies in no level span"
        per_level[level] += 1
    # the first K1/K2 launch after each residual test, whose sync left the card idle
    for end in test_ends:
        first = next((o for o, c in zip(offsets, call_of) if c["ts"] >= end), None)
        if first is not None:
            after_sync.append(first)

    assert max(ks) < 20  # each solve converged: k - 1 cycles
    cycles = sum(k - 1 for k in ks)
    assert tests == sum(ks)
    assert per_level == {f"smg.level.{lv}": LAUNCHES_A_LEVEL * cycles
                         for lv in range(hier.n_levels - 1)}
    print(json.dumps({"card": torch.cuda.get_device_name(card), "order": ORDER,
                      "residuals": ks, "kernels": len(kernels), "linked": len(offsets),
                      "launch_to_start_us": {"min": min(offsets), "median": median(offsets),
                                             "max": max(offsets),
                                             "before_launch": sum(o < 0 for o in offsets)},
                      "after_sync_us": {"min": min(after_sync), "median": median(after_sync),
                                        "max": max(after_sync), "n": len(after_sync)}}))
    assert min(offsets) >= -CLOCK_SKEW_US
