"""The port's benchmark: ``python -m surface_multigrid_code_torch bench [--device cpu]``.

The counterpart of the repository's ``bench.py`` (the JAX package on a
TPU), on the same operators: A = M - 0.01 L on an icosphere, rhs = M V[:, 0],
Galerkin coarse operators, the Jacobi smoother, float32 on the card. It
prints one JSON line with ``bench.py``'s ``metric``, ``value`` and ``unit``:

- the headline, ``icosphere(9)`` (2,621,442 vertices), whose finest
  operator (~210 MB a SpMV) does not fit in the card's L2: the SSP
  hierarchy, the Galerkin products and the induced-RCM ordering of
  ``solver/ordering.py`` built on the host (the SSP hierarchy cached in
  ``build/`` with ``save_hierarchy``), then chained V-cycles timed with
  CUDA events at two cycle counts (the slope; u is normalised after each
  cycle). Beside the time: Gnnz/s, the bytes of a cycle and their bound at
  the HBM rate (``utils/bounds``), the device time and operations of one
  profiled cycle, the launches a cycle, the levels and the host build
  times;
- the detail, ``icosphere(7)`` through the public precompute, timed the
  same way, with the residual reduction per cycle of ``solve_loop`` over
  8 cycles;
- ``balloon_step_ms``: one implicit-Euler step of the BSR balloon on
  bunny_15K at the reference's pressure 1e6 from rest, the best of 3.

Every figure has its check beside it: each solve's residual of the
returned z on the card against the host's float64 residual, a residual
that falls, the balloon step's max|disp| against the host float64 direct
step (relative gap at most ``BALLOON_GAP``) with no rejected Newton
iteration. A failed check prints the line with ``"ok": false`` and exits
1; a failed build or launch raises. There is no fallback: without a card
the default device raises. With ``--device cpu`` it runs ``bench.py``'s
small case off the TPU, icosphere(4) in float64, and skips the headline
and the balloon (``detail.skipped`` says so).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

METRIC = "vcycle_smoother_spmv_throughput"
HEADLINE_ORDER = 9
DETAIL_ORDER = 7
CPU_ORDER = 4
# Chained V-cycles timed at two counts, the best of REPS runs each; the
# time of a cycle is the slope (bench.py:255-275).
CHAIN = (8, 24)
REPS = 3
# solve_loop's cycles for the residual history (bench.py:211).
RESID_CYCLES = 8
# A cycle must at least halve the residual on average (multigrid grade is
# < 0.2 a cycle; PERF.md).
RESID_RATE = 0.5
# The balloon of bench.py:305-346: bunny_15K, the reference's shell and
# inflation pressure, BsrBalloonStepper at dt 1e-3 and mg_tolerance 2e-1.
BALLOON_MESH = "bunny_15K_init"
BALLOON = {"young": 6e6, "poisson": 0.5 - 1e-3, "thickness": 1e-1, "material": "neohookean",
           "pressure": 1e6, "dt": 1e-3, "mg_tolerance": 2e-1}
BALLOON_STEPS = 3
# PERF.md section 2: the step's max|disp| against the host f64 direct step.
BALLOON_GAP = 0.1
CACHE_DIR = Path(__file__).resolve().parent / "build"


def card() -> dict:
    """The card as ``nvidia-smi`` names it, with its power limit."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in out.rsplit(",", 1))
    return {"name": name, "power_limit": limit, "nvidia_smi": out}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def ico_hierarchy(order: int, cache_dir=CACHE_DIR):
    """icosphere(order) and its SSP hierarchy: (V, F, mg, times). The
    hierarchy is loaded from ``cache_dir`` when a run saved it there
    (``save_hierarchy``; the file names the SSP engine's build hash), else
    built by ``mg_precompute`` and saved; ``cache_dir`` None builds it every
    time. ``times``: host seconds of each part, and whether the cache was
    loaded."""
    from surface_multigrid_code_torch.solver.hierarchy import (
        load_hierarchy,
        mg_precompute,
        save_hierarchy,
    )
    from surface_multigrid_code_torch.ssp._native import _source_hash
    from surface_multigrid_code_torch.utils.synthetic import icosphere

    times = {}
    t0 = time.perf_counter()
    V, F = icosphere(order)
    times["icosphere_s"] = time.perf_counter() - t0
    path = None if cache_dir is None else Path(cache_dir) / f"ico{order}-mg-{_source_hash()}.npz"
    t0 = time.perf_counter()
    times["cache_loaded"] = path is not None and path.exists()
    if times["cache_loaded"]:
        mg = load_hierarchy(path)
        times["cache_load_s"] = time.perf_counter() - t0
    else:
        mg = mg_precompute(V, F, verbose=False)
        times["ssp_s"] = time.perf_counter() - t0
        if path is not None:
            t0 = time.perf_counter()
            path.parent.mkdir(parents=True, exist_ok=True)
            tmp = path.with_name(f"{path.stem}.tmp{time.time_ns()}.npz")
            save_hierarchy(tmp, mg)
            tmp.replace(path)
            times["cache_save_s"] = time.perf_counter() - t0
    return V, F, mg, times


def ico_system(V, F):
    """A = M - 0.01 L and rhs = M V[:, 0] (bench.py:170-174)."""
    from surface_multigrid_code_torch.ops.laplacian import cotmatrix, massmatrix

    M = massmatrix(V, F)
    return (M - 0.01 * cotmatrix(V, F)).tocsr(), np.asarray(M @ V[:, 0])


def ico_finest(order: int):
    """The finest operator of ``ico_operators(order)`` (A_0 in the RCM
    ordering) alone, without the hierarchy."""
    from surface_multigrid_code_torch.solver.ordering import finest_rcm
    from surface_multigrid_code_torch.utils.synthetic import icosphere

    A, _ = ico_system(*icosphere(order))
    perm = finest_rcm(A)
    return A[perm][:, perm].tocsr()


def ico_operators(order: int, cache_dir=CACHE_DIR):
    """The headline's system on icosphere(order): (As, Ps, rhs, times):
    ``ico_hierarchy``, ``ico_system``, the Galerkin products P^T A P and
    every level in the induced-RCM ordering (rhs with it), the ordering
    of the JAX package's headline (benchmarks/probes/ico_ops_cache.py)."""
    from surface_multigrid_code_torch.solver.ordering import (
        finest_rcm,
        induced_orderings,
        permute_hierarchy,
    )

    V, F, mg, times = ico_hierarchy(order, cache_dir)
    t0 = time.perf_counter()
    A, rhs = ico_system(V, F)
    times["operator_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    Ps = [mg[lv].P_full.tocsr() for lv in range(1, len(mg))]
    As = [A]
    for P in Ps:
        As.append((P.T @ As[-1] @ P).tocsr())
    times["galerkin_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    perms = induced_orderings(finest_rcm(As[0]), Ps)
    As, Ps = permute_hierarchy(As, Ps, perms)
    times["ordering_s"] = time.perf_counter() - t0
    return As, Ps, rhs[perms[0]], times


def nnz_per_cycle(As, Ps) -> int:
    """Nonzeros a V-cycle touches (bench.py:124 ``_nnz_per_cycle``): 2 + 2
    smoother sweeps and the residual per level above the coarsest, the
    restriction and the prolongation per P."""
    L = len(As)
    return sum(5 * int(As[lv].nnz) for lv in range(L - 1)) + sum(2 * int(P.nnz) for P in Ps)


def cycle_bytes(As, Ps, itemsize: int) -> dict:
    """Bytes a timed cycle must move (each input read once, each output
    written once, ``utils/bounds.spmv_bytes`` for every fused SpMV): per
    level above the coarsest 4 Jacobi sweeps (axpby) and the residual on
    A_l, the restriction by P^T and the prolongation-and-add by P; the
    coarse dense correction (coarse_inv, b, u in; u out) and its add; the
    zero guess of each coarser level; the copy of u the cycle starts from;
    and the normalisation of u after the cycle (u * u, its mean, u / norm).
    Returns {"spmv", "coarse", "vectors", "total"} and the SpMV operations."""
    from surface_multigrid_code_torch.utils.bounds import spmv_bytes

    spmv = flops = 0
    for lv in range(len(As) - 1):
        for epi, times in (("axpby", 4), ("resid", 1)):
            b, f = spmv_bytes(As[lv], 1, epi, itemsize=itemsize)
            spmv, flops = spmv + times * b, flops + times * f
        P = Ps[lv].tocsr()
        for H, epi in ((P.T.tocsr(), None), (P, "add")):
            b, f = spmv_bytes(H, 1, epi, itemsize=itemsize)
            spmv, flops = spmv + b, flops + f
    nc, n0 = As[-1].shape[0], As[0].shape[0]
    coarse = itemsize * (nc * nc + 2 * nc + 3 * nc)
    vectors = itemsize * (sum(A.shape[0] for A in As[1:]) + 2 * n0 + 5 * n0)
    return {"spmv": spmv, "coarse": coarse, "vectors": vectors,
            "total": spmv + coarse + vectors}, flops + 2 * nc * nc


def chained_ms(cycle, b, dev):
    """Per-cycle time of chained calls ``u = cycle(u)`` from u = 0: runs of
    CHAIN[0] and CHAIN[1] cycles, the best of REPS each, timed by CUDA
    events around the run (the host clock on the CPU); the slope between
    the two. Beside it the host's enqueue time per cycle, the slope of the
    host clock around the same loops before they synchronise: near the
    cycle's time the host sets the pace, well below it the device does.
    Returns (ms a cycle, host enqueue ms a cycle, {count: best ms})."""
    def run(k):
        u = torch.zeros_like(b)
        _sync(dev)
        e0, e1 = ((torch.cuda.Event(enable_timing=True) for _ in range(2))
                  if dev.type == "cuda" else (None, None))
        if e0 is not None:
            e0.record()
        t0 = time.perf_counter()
        for _ in range(k):
            u = cycle(u)
        host = 1e3 * (time.perf_counter() - t0)
        if e1 is not None:
            e1.record()
        _sync(dev)
        ms = e0.elapsed_time(e1) if e0 is not None else 1e3 * (time.perf_counter() - t0)
        if not bool(torch.isfinite(u).all()):
            raise RuntimeError("a chained V-cycle gave non-finite values")
        return ms, host

    run(1)
    best = {k: min(run(k) for _ in range(REPS)) for k in CHAIN}
    span = CHAIN[1] - CHAIN[0]
    return ((best[CHAIN[1]][0] - best[CHAIN[0]][0]) / span,
            (best[CHAIN[1]][1] - best[CHAIN[0]][1]) / span, {k: v[0] for k, v in best.items()})


def profiled(fn, dev, sessions=3):
    """One profiler session of fn on the card: device busy ms (the kernels'
    and copies' summed durations), device operations recorded and the
    call's wall between CUDA events (inflated by the profiler). A session
    that records no device event is taken again (up to ``sessions``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize(dev)
    for _ in range(sessions):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize(dev)
        ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if ev:
            busy = sum(e.time_range.elapsed_us() for e in ev) / 1e3
            wall = e0.elapsed_time(e1)
            return {"device_busy_ms": busy, "device_ops": len(ev), "profiled_ms": wall}
        time.sleep(1.0)
    raise RuntimeError(f"the profiler recorded no device event in {sessions} sessions")


def kernel_counts() -> dict:
    """{kernel: its wrapper's launches} and {plain version: its calls}."""
    from surface_multigrid_code_torch.ops.bsr_spmv import fused_bsr_spmv, fused_bsr_spmv_plain
    from surface_multigrid_code_torch.ops.psd import ns_sign_apply, ns_sign_apply_plain
    from surface_multigrid_code_torch.ops.spmv import fused_spmv, fused_spmv_plain

    return ({"spmv_fused": fused_spmv.launches - fused_spmv.planes_launches,
             "spmv_fused_planes": fused_spmv.planes_launches,
             "bsr_spmv": fused_bsr_spmv.launches, "ns_sign_apply": ns_sign_apply.launches},
            {f.__name__: f.calls for f in (fused_spmv_plain, fused_bsr_spmv_plain,
                                             ns_sign_apply_plain)})


def residual_check(hier, A, rhs, cfg, dev, dtype) -> dict:
    """``solve_loop`` for RESID_CYCLES cycles from z = 0 (tolerance 0): its
    residual history and reduction per cycle; the residual of the returned
    z as the loop records it (on the device, in the hierarchy's type)
    against the host's float64 residual of the same z, within the rounding
    of that type (``chip_smoke.solve_checked``'s bound)."""
    from surface_multigrid_code_torch.solver.vcycle import _residual_norm, solve_loop

    b = torch.as_tensor(rhs, dtype=torch.float64).to(dev, dtype)
    z, r_his, k = solve_loop(hier, b, torch.zeros_like(b), 0.0, RESID_CYCLES, cfg)
    r_his = [float(r) for r in r_his[:k].cpu()]
    r_dev = float(_residual_norm(hier.levels[0].A, z, b))
    zh = z.double().cpu().numpy()
    b64 = np.asarray(b.double().cpu())
    r_host = float(np.linalg.norm(b64 - A @ zh))
    scale = float(np.linalg.norm(np.abs(b64) + abs(A) @ np.abs(zh)))
    eps = float(torch.finfo(dtype).eps)
    bound = (int(np.diff(A.indptr).max()) + 2) * eps * scale + 1e-5 * r_host
    rate = (r_his[-1] / r_his[0]) ** (1.0 / (len(r_his) - 1))
    finite = bool(np.isfinite(zh).all()) and all(np.isfinite(r_his))
    return {"r_his": r_his, "residual_reduction_per_cycle": rate,
            "r_final_device": r_dev, "r_final_host_f64": r_host, "bound": bound,
            "ok": finite and abs(r_dev - r_host) <= bound and rate < RESID_RATE}


def vcycle_record(hier, As, Ps, rhs, dev, host_times, mesh) -> dict:
    """The chained V-cycle time of ``hier`` (built on dev from As, Ps)
    and what goes with it (see the module docstring), and its residual
    check."""
    from surface_multigrid_code_torch.config import SmootherType, SolveConfig
    from surface_multigrid_code_torch.ops.spmv import fused_spmv
    from surface_multigrid_code_torch.solver.vcycle import vcycle
    from surface_multigrid_code_torch.utils.bounds import bound_ms

    cfg = SolveConfig(smoother=SmootherType.JACOBI)
    dtype = hier.levels[0].diag.dtype
    b = torch.as_tensor(rhs, dtype=torch.float64).to(dev, dtype)

    def cycle(u):
        u = vcycle(hier, b, u, cfg)
        return u / torch.sqrt(torch.mean(u * u) + 1e-30)

    t_cycle, t_host, chain = chained_ms(cycle, b, dev)
    nnz = nnz_per_cycle(As, Ps)
    nbytes, flops = cycle_bytes(As, Ps, torch.finfo(dtype).bits // 8)
    rec = {"mesh": mesh, "n": int(As[0].shape[0]),
           "levels": [int(A.shape[0]) for A in As], "dtype": str(dtype)[6:],
           "smoother": "jacobi", "t_vcycle_ms": t_cycle, "host_enqueue_ms": t_host,
           "chain_ms": chain,
           "nnz_per_cycle": nnz, "gnnz_per_s": nnz / t_cycle / 1e6, "bytes_per_cycle": nbytes}
    if dev.type == "cuda":
        bms, by = bound_ms(nbytes["total"], flops)
        u0 = torch.zeros_like(b)
        before = fused_spmv.launches
        cycle(u0)
        launches = fused_spmv.launches - before
        prof = profiled(lambda: cycle(u0), dev)
        rec.update({"bound_ms": bms, "bound_by": by, "bound_share": bms / t_cycle,
                    "hand_kernel_launches_per_cycle": launches, **prof})
    rec["host_s"] = host_times
    rec["check"] = residual_check(hier, As[0], rhs, cfg, dev, dtype)
    return rec


def headline(dev, cache_dir) -> dict:
    """icosphere(9), induced-RCM ordered, float32 on the card."""
    from surface_multigrid_code_torch.config import SmootherType, SolveConfig
    from surface_multigrid_code_torch.solver.vcycle import build_device_hierarchy

    As, Ps, rhs, times = ico_operators(HEADLINE_ORDER, cache_dir)
    t0 = time.perf_counter()
    hier = build_device_hierarchy(As, Ps, SolveConfig(smoother=SmootherType.JACOBI),
                                  device=dev, dtype=torch.float32)
    _sync(dev)
    times["device_build_s"] = time.perf_counter() - t0
    rec = vcycle_record(hier, As, Ps, rhs, dev, times,
                        f"icosphere({HEADLINE_ORDER}), induced-RCM ordering")
    rec["faces"] = 20 * 4 ** HEADLINE_ORDER
    return rec


def detail(order, dev, dtype, cache_dir) -> dict:
    """icosphere(order) through the public precompute (the Galerkin
    products, the coarsest diagonal shifted; no reordering), timed as the
    headline."""
    from surface_multigrid_code_torch import min_quad_with_fixed_mg_precompute
    from surface_multigrid_code_torch.config import SmootherType, SolveConfig

    V, F, mg, times = ico_hierarchy(order, cache_dir)
    A, rhs = ico_system(V, F)
    t0 = time.perf_counter()
    data = min_quad_with_fixed_mg_precompute(
        A, None, mg, SolveConfig(smoother=SmootherType.JACOBI), device=dev, dtype=dtype)
    _sync(dev)
    times["precompute_s"] = time.perf_counter() - t0
    As = [lv.A for lv in mg]
    Ps = [mg[lv].P for lv in range(1, len(mg))]
    return vcycle_record(data.hier, As, Ps, rhs, dev, times, f"icosphere({order})")


def balloon(dev) -> dict:
    """One BSR balloon step on bunny_15K from rest, the best of
    BALLOON_STEPS (after one that warms up), held to the host f64 direct
    step (psd_project=True) within BALLOON_GAP, with no rejected Newton
    iteration."""
    from surface_multigrid_code_torch import mg_precompute
    from surface_multigrid_code_torch.models.balloon import (
        BsrBalloonStepper,
        implicit_euler_balloon_direct,
        inflation_force,
        lumped_mass_matrix,
    )
    from surface_multigrid_code_torch.models.shell import ShellEnergy, lame_parameters
    from surface_multigrid_code_torch.utils.obj_io import read_obj
    from surface_multigrid_code_torch.utils.paths import mesh_path

    c = BALLOON
    V, F = read_obj(mesh_path(BALLOON_MESH))
    t0 = time.perf_counter()
    mg = mg_precompute(V, F, verbose=False)
    al, be = lame_parameters(c["young"], c["poisson"])
    shell = ShellEnergy(V, F, c["thickness"], al, be, c["material"], device=dev)
    M = 1000.0 * lumped_mass_matrix(V, F)
    stepper = BsrBalloonStepper(shell, M, mg, c["dt"], mg_tolerance=c["mg_tolerance"])
    setup_s = time.perf_counter() - t0
    fExt = inflation_force(V, F, c["pressure"])
    qd0 = np.zeros(V.size)
    walls, rejects = [], []
    for _ in range(BALLOON_STEPS + 1):
        _sync(dev)
        t0 = time.perf_counter()
        pos, _qd = stepper.step(V, qd0, fExt)
        _sync(dev)
        walls.append(1e3 * (time.perf_counter() - t0))
        rejects.append(int(stepper.last_rejected))
    t0 = time.perf_counter()
    direct, _ = implicit_euler_balloon_direct(shell, M, V, qd0, fExt, c["dt"], verbose=False,
                                              psd_project=True)
    direct_s = time.perf_counter() - t0
    disp = float(np.abs(np.asarray(pos) - V).max())
    d_disp = float(np.abs(direct - V).max())
    gap = abs(disp - d_disp) / d_disp
    return {"mesh": BALLOON_MESH, "n": int(V.shape[0]), "levels": [int(lv.V.shape[0]) for lv in mg],
            **c, "step_ms": min(walls[1:]), "step_walls_ms": walls, "setup_s": setup_s,
            "max_disp": disp, "direct_max_disp": d_disp, "gap": gap, "gap_limit": BALLOON_GAP,
            "rejects": rejects, "direct_s": direct_s,
            "ok": bool(np.isfinite(np.asarray(pos)).all()) and gap <= BALLOON_GAP
            and not any(rejects)}


def run(device="cuda", cache_dir=CACHE_DIR) -> dict:
    """The bench's record (the JSON line's object)."""
    from surface_multigrid_code_torch.utils.device import resolve_device

    dev = resolve_device(device)
    t_start = time.perf_counter()
    launches0, plain0 = kernel_counts()
    if dev.type == "cuda":
        from surface_multigrid_code_torch._build import load_library

        load_library()
        where = {"platform": "cuda", **card(), "torch": torch.__version__,
                 "cuda": torch.version.cuda}
        head = headline(dev, cache_dir)
        det = detail(DETAIL_ORDER, dev, torch.float32, cache_dir)
        bal = balloon(dev)
        skipped = []
    else:
        where = {"platform": "cpu", "torch": torch.__version__}
        head, bal = None, None
        det = detail(CPU_ORDER, dev, torch.float64, cache_dir)
        skipped = [f"headline icosphere({HEADLINE_ORDER})", "balloon_step_ms",
                   "bound, profiled cycle and launches (the card's)"]
    launches1, plain1 = kernel_counts()
    checks = {"detail_residual": det["check"]["ok"]}
    if head is not None:
        checks["headline_residual"] = head["check"]["ok"]
        checks["balloon_vs_direct"] = bal["ok"]
    main = head if head is not None else det
    return {
        "metric": METRIC,
        "value": main["gnnz_per_s"],
        "unit": "Gnnz/s",
        "ok": all(checks.values()),
        "detail": {
            "device": where,
            "regime": "hbm_bound" if head is not None else "cpu_small",
            "headline": head,
            "vcycle_detail": det,
            "balloon_step_ms": None if bal is None else bal["step_ms"],
            "balloon": bal,
            "checks": checks,
            "skipped": skipped,
            "launches": {k: launches1[k] - launches0[k] for k in launches1},
            "plain_calls": {k: plain1[k] - plain0[k] for k in plain1},
            "wall_s": time.perf_counter() - t_start,
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="surface_multigrid_code_torch bench",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="the card (cuda, the default) or cpu")
    ap.add_argument("--cache-dir", default=str(CACHE_DIR),
                    help="where the SSP hierarchies are cached ('' builds them every run)")
    args = ap.parse_args(argv)
    rec = run(args.device, args.cache_dir or None)
    print(json.dumps(rec), flush=True)
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
