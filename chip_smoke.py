#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``surface_multigrid_code_torch``) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA card, ``nvcc`` and ``g++``, no network and no JAX. It
builds the port's kernels from ``surface_multigrid_code_torch/csrc``, holds
each against its plain PyTorch version on the card, and drives the port's
two paths through their public entry points:

- the static solve (SSP hierarchy -> precompute -> multigrid solve) at
  icosphere(7) size, then the constrained, multi-column and
  iterative-refinement solve shapes;
- mean-curvature flow (``MCFStepper``, example 05's recipe, f32): 20
  steps on bunny, each held to a host f64 flow, and 3 steps each on ogre
  and the midpoint-subdivided ogre, every step converged;
- the balloon (``models.balloon.run_balloon``, example 06 at its
  defaults) for 3 steps on bunny_15K and 1 step on the midpoint-subdivided
  bunny, held against the host sparse-LU oracle, and one step of its
  scalar cross-check (``solver="scalar"``) on bunny_15K.

Each path runs with the kernels' launch counts set to 0 just before it
and read just after: it must have launched its kernels, and no plain
version; then K1/K2 are held to their plain versions at the path's own
shapes. It times V-cycles, MCF and balloon steps and kernels against the
plain versions (the MCF and balloon timings each in a child process,
``--child mcf|balloon``; every profiler reading is held to CUDA-event
times), and ends with

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}

Any failure raises, so the exit code is non-zero and that line is not
printed. Without a CUDA device it fails at once.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import torch

EPIS = (None, "axpby", "resid", "add", "resid_scaled")
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
KERNELS = {
    # name: file:line of the TPU kernel it replaces (K1: one column, K2: C)
    "spmv_fused": "surface_multigrid_code_tpu/ops/well.py:871",
    "spmv_fused_planes": "surface_multigrid_code_tpu/ops/well.py:1598",
}
SOURCE = "surface_multigrid_code_torch/csrc/spmv.cu"
BLOCK_KERNELS = {
    # name: (source, file:line of the TPU kernel it replaces)
    "bsr_spmv": ("surface_multigrid_code_torch/csrc/bsr_spmv.cu",
                 "surface_multigrid_code_tpu/ops/well.py:1222"),
    "ns_sign_apply": ("surface_multigrid_code_torch/csrc/psd.cu",
                      "surface_multigrid_code_tpu/ops/psd.py:82"),
}
# Balloon: example 06 at the run_balloon defaults; the oracle gaps allowed
# between the multigrid and the direct f64 step (max|disp|, relative): the
# tol-2e-1 multigrid direction is least accurate in the first step.
BALLOON_MESH = "bunny_15K_init"
BALLOON_STEPS = 3
ORACLE_GAP = (0.1, 0.05, 0.05)
# MCF: example 05's recipe (hierarchy ratio 0.25, min_coarsest_nv 500,
# dec_type 1; delta 0.01, tol 5e-7, f32, multicolor GS) as (mesh,
# midpoint-subdivided, steps, held to the host f64 flow). MCF_EXACT_GAP
# bounds max|U_card - U_exact| at every step: 8x the 6.3e-6 the JAX
# package reads in f32 on the CPU over 20 bunny steps.
MCF_MESHES = (("bunny", False, 20, True), ("ogre", False, 3, False),
              ("ogre", True, 3, False))
MCF_TOL = 5e-7
MCF_EXACT_GAP = 5e-5
MCF_TIMED_STEPS = 6  # CUDA events around each; step 0 warms up
# The profiler's checks. A kernel's mean time per recorded launch t is
# held to its back-to-back time per call b (burst_ms: the kernel plus the
# gap to the next launch, 1.02-1.24 us on the H100 at every shape timed):
# PROFILER_BAND[0] * b - LAUNCH_GAP_MS <= t <= PROFILER_BAND[1] * b, which
# a reading at half the kernel's time fails at every shape. A profiled
# step must have recorded at least STEP_RECORDED of each hand kernel's
# counted launches.
PROFILER_BAND = (0.9, 1.15)
LAUNCH_GAP_MS = 1.5e-3
STEP_RECORDED = 0.9
CHILD_RESULT = "child result: "
# Relative tolerance of the plain f32 ico solves. Their f32 residual floor
# is about 1.5e-5 ||b||: ||b - Az|| is a strongly cancelling difference
# (|A||z| is ~1000x the residual scale). 1e-4 ||b|| sits above that floor;
# tighter tolerances are the refinement path's, run in phase 5.
REL_TOL = 1e-4
# Peaks of one H100 SXM (NVIDIA's data sheet) for the bounds: HBM3 bytes
# per second, and float32 and float64 operations per second outside the
# tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
F64_FLOPS_PER_S = 34e12


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def kernel_name(C: int) -> str:
    return "spmv_fused" if C == 1 else "spmv_fused_planes"


# ---------------------------------------------------------------- systems

def ico_system(depth: int):
    """The bench.py system: A = M - 0.01 L on icosphere(depth), b = M @ x."""
    from surface_multigrid_code_torch import mg_precompute
    from surface_multigrid_code_torch.ops.laplacian import cotmatrix, massmatrix
    from surface_multigrid_code_torch.utils.synthetic import icosphere

    V, F = icosphere(depth)
    t0 = time.perf_counter()
    mg = mg_precompute(V, F, verbose=False)
    t_mg = time.perf_counter() - t0
    M = massmatrix(V, F)
    A = (M - 0.01 * cotmatrix(V, F)).tocsr()
    return V, F, mg, A, M, t_mg


# ---------------------------------------------------------------- phase 3

def empty_every_fifth(S):
    """S with every fifth row emptied (rows 0, 5, 10, ... store no nonzero)."""
    import scipy.sparse as sp

    keep = (np.arange(S.shape[0]) % 5 != 0).astype(np.float64)
    E = (sp.diags(keep) @ S).tocsr()
    E.eliminate_zeros()
    return E


def spmv_operators(A, mg):
    """The ico system's operators at every level (A_l the Galerkin
    products, P_l and PT_l); A_0 with every fifth row emptied (launched one
    thread per row); and the last smoothed level cut to an odd row count,
    alone and with every fifth row emptied (launched 32 lanes per row, and
    in check_kernels at every width). Returns (operators, label of the odd cut)."""
    ops, Al = {"A_0": A}, A
    for l in range(1, len(mg)):
        P = mg[l].P_full.tocsr()
        Al = (P.T @ Al @ P).tocsr()
        ops.update({f"A_{l}": Al, f"P_{l}": P, f"PT_{l}": P.T.tocsr()})
    ops["A_0 with empty rows"] = empty_every_fifth(A)
    small = ops[f"A_{len(mg) - 2}"]
    k = small.shape[0] - 1 + small.shape[0] % 2
    odd = f"A_{len(mg) - 2}[:{k}]"
    ops[odd] = small[:k].tocsr()
    ops[f"{odd} with empty rows"] = empty_every_fifth(ops[odd])
    return ops, odd


def check_spmv(S, label, dev, errs, rng, Cs=(1, 2, 3, 4, 5), epis=EPIS, rows=None,
               lanes=None):
    """K1/K2 against the plain version on the host operator S, f32 and f64,
    for each C and epilogue; with ``rows`` one in-place GS color update
    (axpby, s = 1/diag). ``lanes`` forces the sub-warp width. Returns the
    number of cases."""
    from surface_multigrid_code_torch.ops.sparse import csr_from_scipy
    from surface_multigrid_code_torch.ops.spmv import fused_spmv, fused_spmv_plain

    n, m = S.shape
    n_cases = 0
    for dt in (torch.float32, torch.float64):
        def t(a):
            return torch.as_tensor(a).to(dev, dt)

        Sd = csr_from_scipy(S, dev, dt)
        if lanes is not None:
            Sd.lanes = lanes
        s = t(1.0 / S.diagonal()) if rows is not None else t(rng.uniform(0.5, 2.0, n))
        r = None if rows is None else torch.as_tensor(rows, device=dev)
        for C in Cs:
            shp = (n,) if C == 1 else (n, C)
            x = t(rng.standard_normal((m,) if C == 1 else (m, C)))
            u, b = t(rng.standard_normal(shp)), t(rng.standard_normal(shp))
            n_out = n if rows is None else len(rows)
            what = f"{label} ({n_out} rows) C={C} {dt}"
            if r is not None:
                uk, up = u.clone(), u.clone()
                fused_spmv(Sd, uk, epi="axpby", u=uk, b=b, s=s, rows=r, out=uk)
                fused_spmv_plain(Sd, up, epi="axpby", u=up, b=b, s=s, rows=r, out=up)
                _compare(uk, up, dt, f"{what} in place, lanes {fused_spmv.last_lanes}",
                         errs, kernel_name(C))
                n_cases += 1
            for epi in epis if r is None else ():
                kw = dict(epi=epi, b=b, u=u, s=s, escale=2.0 / 3.0)
                _compare(fused_spmv(Sd, x, **kw), fused_spmv_plain(Sd, x, **kw), dt,
                         f"{what} epi={epi}, lanes {fused_spmv.last_lanes}", errs,
                         kernel_name(C))
                n_cases += 1
            if lanes is not None and dev.type == "cuda" and fused_spmv.last_lanes != lanes:
                raise RuntimeError(f"{what}: launched at {fused_spmv.last_lanes} lanes, "
                                   f"not the forced {lanes}")
    return n_cases


def check_kernels(A, mg, dev, seed=0):
    """Phase 3 (K1/K2), kernel vs plain version on the same device inputs:
    every epilogue, C in 1..5, f32 and f64, on A_l, P_l and PT_l of every
    ico level and on operators with empty rows; the largest GS color of
    every smoothed level, in place; at every forced lanes value, the last
    smoothed level cut to an odd row count (alone and with empty rows) and
    a color of it of odd size, so that every width up to 16 runs a ragged
    last warp. Returns {kernel name: max abs error}."""
    from surface_multigrid_code_torch.ops.smoothers import color_groups, greedy_coloring
    from surface_multigrid_code_torch.ops.spmv import fused_spmv

    rng = np.random.default_rng(seed)
    ops, odd = spmv_operators(A, mg)
    errs = {name: 0.0 for name in KERNELS}
    before = fused_spmv.launches
    n_cases = 0
    for label, S in ops.items():
        n_cases += check_spmv(S, label, dev, errs, rng)
    colors = {}
    for l in range(len(mg) - 1):  # the coarsest level is a dense solve
        S = ops[f"A_{l}"]
        colors[l] = max(color_groups(greedy_coloring(S)), key=len)
        n_cases += check_spmv(S, f"A_{l} largest GS color", dev, errs, rng, rows=colors[l])
    small = len(mg) - 2  # the last smoothed level (A_3 at ico7) takes any width
    color = colors[small][: len(colors[small]) - 1 + len(colors[small]) % 2]
    for lanes in (1, 2, 4, 8, 16, 32):
        n_cases += check_spmv(ops[odd], f"{odd} forced", dev, errs, rng,
                              Cs=(1, 3, 5), epis=(None, "axpby"), lanes=lanes)
        n_cases += check_spmv(ops[f"{odd} with empty rows"], f"{odd} with empty rows forced",
                              dev, errs, rng, Cs=(1, 3), epis=(None, "axpby"), lanes=lanes)
        n_cases += check_spmv(ops[f"A_{small}"], f"A_{small} GS color forced", dev,
                              errs, rng, Cs=(1, 3), rows=color, lanes=lanes)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        if fused_spmv.launches <= before:
            raise RuntimeError("fused_spmv.launches did not grow")
    log(f"phase 3: K1/K2 {n_cases} kernel-vs-plain cases agree on {len(ops)} operators, "
        f"{len(colors)} GS colors and 6 forced lanes values; max abs err {errs}")
    return errs


def _compare(y, ref, dt, what, errs, name):
    if y.shape != ref.shape:
        raise RuntimeError(f"{what}: shape {tuple(y.shape)} != {tuple(ref.shape)}")
    if not bool(torch.isfinite(y).all()):
        raise RuntimeError(f"{what}: non-finite output")
    err = float((y - ref).abs().max())
    scale = float(ref.abs().max())
    if err > TOL[dt] * scale:
        raise RuntimeError(f"{what}: max|d| {err:.3e} > {TOL[dt]:g} * max|y| {scale:.3e}")
    errs[name] = max(errs.get(name, 0.0), err)


# ---------------------------------------------------------------- phases 4, 5

def solve_checked(data, B, what, tol, *, A_host, eps=1.2e-7, known=None,
                  known_val=None, z0=None, median_rate=None):
    """Solve, then hold the result to the system on the host in f64.

    The residual the solve recorded last must match the host's f64 residual
    of the returned z to within the rounding of the dtype it was computed
    in (eps: f32 for plain solves, f64 for refined ones)."""
    from surface_multigrid_code_torch import min_quad_with_fixed_mg_solve

    t0 = time.perf_counter()
    z, r_his, ok = min_quad_with_fixed_mg_solve(
        data, B, known_val=known_val, z0=z0, tolerance=tol, max_iter=20)
    secs = time.perf_counter() - t0
    if not ok:
        raise RuntimeError(f"{what}: not converged: {r_his}")
    if z.shape != np.shape(B) or not np.isfinite(z).all():
        raise RuntimeError(f"{what}: bad solution shape or non-finite values")
    rates = [r_his[i + 1] / r_his[i] for i in range(len(r_his) - 1)]
    if median_rate is not None and not np.median(rates) < median_rate:
        raise RuntimeError(f"{what}: median reduction {np.median(rates):.3f} >= {median_rate}")
    # host f64 residual of the returned z against the last recorded one
    if known is not None:
        unknown = np.setdiff1d(np.arange(A_host.shape[0]), known)
        if not np.array_equal(z[known], known_val):
            raise RuntimeError(f"{what}: known values not kept")
        Auu = A_host[unknown][:, unknown]
        rhs = np.asarray(B)[unknown] - A_host[unknown][:, known] @ known_val
        zu = z[unknown]
    else:
        Auu, rhs, zu = A_host, np.asarray(B), z
    r_host = float(np.linalg.norm(rhs - Auu @ zu))
    scale = float(np.linalg.norm(np.abs(rhs) + abs(Auu) @ np.abs(zu)))
    width = int(np.diff(Auu.tocsr().indptr).max())
    bound = (width + 2) * eps * scale + 1e-5 * r_host
    if abs(r_host - r_his[-1]) > bound:
        raise RuntimeError(
            f"{what}: host residual {r_host:.6e} vs last r_his {r_his[-1]:.6e} (bound {bound:.2e})")
    log(f"{what}: {len(r_his)} residuals, {r_his[0]:.4e} -> {r_his[-1]:.4e} "
        f"(host f64 {r_host:.4e}); median rate {np.median(rates) if rates else 0:.4f}; {secs:.3f} s")
    return z, r_his


def main_path(depth, V, mg, A, M, dev):
    """Phase 4: the ico system solved through the public entry points."""
    from surface_multigrid_code_torch import SolveConfig, min_quad_with_fixed_mg_precompute
    from surface_multigrid_code_torch.config import SmootherType

    b = np.asarray(M @ V[:, 0])
    tol = REL_TOL * float(np.linalg.norm(b))
    datas = {}
    for sm in (SmootherType.JACOBI, SmootherType.MULTICOLOR_GS):
        t0 = time.perf_counter()
        data = min_quad_with_fixed_mg_precompute(
            A, None, copy.deepcopy(mg), SolveConfig(smoother=sm), device=dev)
        log(f"phase 4: ico{depth} precompute ({sm.value}): {time.perf_counter() - t0:.3f} s, "
            f"levels {[lv.diag.shape[0] for lv in data.hier.levels]}")
        solve_checked(data, b, f"phase 4: ico{depth} {sm.value} f32", tol,
                      A_host=A, median_rate=0.3)
        datas[sm] = data
    return datas


def ogre_system(dev):
    """ex03 shape: ogre, boundary known (zero), A = -L, B = M 1 with B(b) = 0.
    Returns (solver data, A, known, B); its PT has the hub rows."""
    from surface_multigrid_code_torch import mg_precompute, min_quad_with_fixed_mg_precompute
    from surface_multigrid_code_torch.ops.laplacian import cotmatrix, massmatrix
    from surface_multigrid_code_torch.utils.mesh import boundary_vertices, normalize_unit_area
    from surface_multigrid_code_torch.utils.obj_io import read_obj
    from surface_multigrid_code_torch.utils.paths import mesh_path

    Vo, Fo = read_obj(mesh_path("ogre"))
    Vo = normalize_unit_area(Vo, Fo)
    mg_o = mg_precompute(Vo, Fo, verbose=False)
    Ao = (-cotmatrix(Vo, Fo)).tocsr()
    bo = boundary_vertices(Fo)
    Bo = np.asarray(massmatrix(Vo, Fo) @ np.ones(Vo.shape[0]))
    Bo[bo] = 0.0
    return min_quad_with_fixed_mg_precompute(Ao, bo, mg_o, device=dev), Ao, bo, Bo


def other_shapes(depth, V, A, M, gs_data, dev):
    """Phase 5: constrained ogre (ex03), [n, 3] right-hand side, ex04 with
    refinement. Returns the ogre's solver data (its PT has the hub rows)."""
    from surface_multigrid_code_torch import mg_precompute, min_quad_with_fixed_mg_precompute
    from surface_multigrid_code_torch.ops.laplacian import cotmatrix, massmatrix
    from surface_multigrid_code_torch.utils.mesh import normalize_unit_area
    from surface_multigrid_code_torch.utils.obj_io import read_obj
    from surface_multigrid_code_torch.utils.paths import mesh_path

    data_o, Ao, bo, Bo = ogre_system(dev)
    hub = max(int(np.diff(lv.PT.indptr.cpu().numpy()).max())
              for lv in data_o.hier.levels[1:])
    log(f"phase 5: ogre |V| {Ao.shape[0]}, {bo.size} known, widest PT row {hub}")
    solve_checked(data_o, Bo, "phase 5: ogre constrained f32", 1e-3, A_host=Ao,
                  known=bo, known_val=np.zeros(bo.size))

    # [n, 3] right-hand side on the ico system (multi-column kernel)
    B3 = np.asarray(M @ V)
    solve_checked(gs_data, B3, f"phase 5: ico{depth} [n,3] multicolor_gs f32",
                  REL_TOL * float(np.linalg.norm(B3)), A_host=A, median_rate=0.3)

    # ex04 shape: bunny, vertices nearest the hilbert_cube_known markers
    # known, random z0, tol 1e-10 -> f32 hierarchy with f64 refinement
    Vb, Fb = read_obj(mesh_path("bunny"))
    Vk, _ = read_obj(mesh_path("hilbert_cube_known"))
    kb = np.unique(((Vb[None, :, :] - Vk[:, None, :]) ** 2).sum(-1).argmin(axis=1))
    Vb = normalize_unit_area(Vb, Fb)
    mg_b = mg_precompute(Vb, Fb, verbose=False)
    Ab = (-cotmatrix(Vb, Fb)).tocsr()
    Bb = np.asarray(massmatrix(Vb, Fb) @ np.ones(Vb.shape[0]))
    Bb[kb] = 0.0
    z0 = np.random.default_rng(0).uniform(-1, 1, Vb.shape[0])
    data_b = min_quad_with_fixed_mg_precompute(Ab, kb, mg_b, device=dev)
    if data_b.A64 is None:
        raise RuntimeError("f32 precompute built no f64 finest operator")
    solve_checked(data_b, Bb, "phase 5: ex04 bunny tol 1e-10 (refinement)", 1e-10,
                  A_host=Ab, eps=2.3e-16, known=kb, known_val=np.zeros(kb.size), z0=z0)
    return data_o


# ---------------------------------------------------------------- phase 6

@contextlib.contextmanager
def plain_spmv():
    """Route the V-cycle's SpMV calls to the plain version (timing only)."""
    from surface_multigrid_code_torch.ops import smoothers, spmv
    from surface_multigrid_code_torch.solver import vcycle as vc

    saved = (smoothers.fused_spmv, vc.fused_spmv)
    smoothers.fused_spmv = vc.fused_spmv = spmv.fused_spmv_plain
    try:
        yield
    finally:
        smoothers.fused_spmv, vc.fused_spmv = saved


def cuda_ms(fn, reps, warmup=3):
    """Per-call time of fn between CUDA events around reps back-to-back
    calls: the host's enqueue time where that is longer than the device's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def device_ms(fn, reps, kernel=None, counts=None):
    """One profiler session of reps calls of fn. Returns a record: "ms",
    the device time per call: without ``kernel`` the summed durations of
    the kernels and copies recorded, over reps; with ``kernel`` (a
    substring of the name of the one kernel a call of fn launches) the
    mean duration of its recorded launches. "events": device events
    recorded per call; "wall_ms": the session's time per call between
    CUDA events around the reps calls (the same sample). With ``counts``
    ({kernel name substring: () -> the wrapper's launch count}):
    "counted", the launches of each in the session, and "recorded", the
    events of that name the profiler kept. The profiler was seen to drop
    some events of a session (17 of 20 launches, every session of one
    call), so a sum over reps undercounts where the mean of a named kernel
    does not."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    counts = counts or {}
    fn()
    torch.cuda.synchronize()
    for attempt in range(8):  # a session now and then records no device event
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            before = {k: c() for k, c in counts.items()}
            e0.record()
            for _ in range(reps):
                fn()
            e1.record()
            torch.cuda.synchronize()
            counted = {k: c() - before[k] for k, c in counts.items()}
        dev_ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        ev = [e for e in dev_ev if kernel is None or kernel in e.name]
        if ev:
            total = sum(e.time_range.elapsed_us() for e in ev) / 1e3
            return {"ms": total / reps if kernel is None else total / len(ev),
                    "events": len(dev_ev) / reps, "wall_ms": e0.elapsed_time(e1) / reps,
                    "counted": counted,
                    "recorded": {k: sum(k in e.name for e in dev_ev) for k in counts}}
        log(f"  profiler session {attempt} recorded no device event"
            + ("" if kernel is None else f" named {kernel}") + "; again")
        time.sleep(1.0)
    raise RuntimeError("the profiler recorded no device event in 8 sessions")


def burst_ms(fn, reps):
    """Per-call device time of fn from CUDA events around reps calls queued
    behind a spin kernel (``torch.cuda._sleep``), so that the card runs
    them back to back however long the host takes per call: each call's
    kernels plus the gaps between launches. The spin is lengthened until
    the host has queued every call before it ends."""
    fn()
    torch.cuda.synchronize()
    cycles = 20_000_000
    for _ in range(4):
        ea, e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        ea.record()
        torch.cuda._sleep(cycles)
        e0.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = 1e3 * (time.perf_counter() - t0)
        e1.record()
        torch.cuda.synchronize()
        if host_ms < 0.8 * ea.elapsed_time(e0):
            return e0.elapsed_time(e1) / reps
        cycles *= 4
    raise RuntimeError("the calls could not be queued behind the spin kernel")


def checked_kernel_ms(fn, reps, kernel, what):
    """The profiler's mean time of the named kernel over reps calls of fn,
    held to the back-to-back event time per call (burst_ms) of the same
    calls (PROFILER_BAND, LAUNCH_GAP_MS), or the run fails (a session that
    misreads the kernel). Returns (profiler ms, burst ms)."""
    rec = device_ms(fn, reps, kernel)
    burst = burst_ms(fn, reps)
    lo, hi = PROFILER_BAND[0] * burst - LAUNCH_GAP_MS, PROFILER_BAND[1] * burst
    if not lo <= rec["ms"] <= hi:
        raise RuntimeError(f"{what}: the profiler reads {kernel} at {1e3 * rec['ms']:.3f} us a "
                           f"launch, back-to-back calls take {1e3 * burst:.3f} us: outside "
                           f"[{1e3 * lo:.3f}, {1e3 * hi:.3f}] us")
    return rec["ms"], burst


def checked_step(fn, counts, what, reps=1):
    """A profiled run of fn (a whole step or cycle): device_ms(fn, reps,
    counts=counts). Each hand kernel of ``counts`` must have at least
    STEP_RECORDED of its launches recorded, or the run fails (a session
    that dropped the step's events would read its device time low)."""
    rec = device_ms(fn, reps, counts=counts)
    for name, n in rec["counted"].items():
        if rec["recorded"][name] < STEP_RECORDED * n:
            raise RuntimeError(f"{what}: the profiler recorded {rec['recorded'][name]} of {n} "
                               f"launches of {name}")
    return rec


def in_turns(run, plain_ctx):
    """run() with the kernels and with the plain version, in the order
    plain, kernel, kernel, plain; returns the medians of each."""
    res = {"kernel": [], "plain": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        with plain_ctx() if which == "plain" else contextlib.nullcontext():
            res[which].append(run())
    return {k: float(np.median(v)) for k, v in res.items()}, res


def timings(depth, V, M, datas, dev):
    """Phase 6: V-cycle times, kernel vs plain, in turns."""
    from surface_multigrid_code_torch.ops.spmv import fused_spmv
    from surface_multigrid_code_torch.solver.vcycle import vcycle

    b = torch.as_tensor(np.asarray(M @ V[:, 0]), dtype=torch.float32, device=dev)
    vc = {}
    for sm, data in datas.items():
        z = torch.zeros_like(b)

        def chain(n=10):
            u = z
            for _ in range(n):
                u = vcycle(data.hier, b, u, data.cfg)

        wall, raw = in_turns(lambda: cuda_ms(chain, 3) / 10, plain_spmv)
        prof = checked_step(lambda: vcycle(data.hier, b, z, data.cfg),
                            {"spmv_fused_kernel": lambda: fused_spmv.launches},
                            f"ico{depth} V-cycle ({sm.value})", reps=5)
        busy, n_dev = prof["ms"], prof["events"]
        with plain_spmv():
            busy_p = device_ms(lambda: vcycle(data.hier, b, z, data.cfg), 5)["ms"]
        vc[sm.value] = {
            "ms": wall["kernel"], "plain_ms": wall["plain"],
            "device_ms": busy, "plain_device_ms": busy_p, "device_ops": n_dev,
            "profiled_wall_ms": prof["wall_ms"], "idle_share": 1.0 - busy / prof["wall_ms"],
        }
        log(f"phase 6: ico{depth} V-cycle ({sm.value}, f32): wall kernels {raw['kernel']} ms, "
            f"plain {raw['plain']} ms; device busy {busy:.4f} ms ({n_dev:.0f} device ops, "
            f"K1/K2 launches recorded {prof['recorded']} of {prof['counted']}) in "
            f"{prof['wall_ms']:.4f} ms, plain {busy_p:.4f} ms")
    return vc


def host_csr(S):
    """A device CSRMatrix as a scipy CSR on the host."""
    import scipy.sparse as sp

    return sp.csr_matrix((S.data.double().cpu().numpy(), S.indices.cpu().numpy(),
                          S.indptr.cpu().numpy()), shape=S.shape)


def bound_ms(nbytes, flops, f64=False):
    """The least time the card could take: bytes over the HBM rate or
    operations over the CUDA cores' f32 (or f64) peak, whichever is larger."""
    peak = F64_FLOPS_PER_S if f64 else F32_FLOPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def spmv_bytes(H, C, epi, rows=None, itemsize=4):
    """Bytes one fused SpMV must move, each input read once and each output
    written once: the rows' index range (and row ids), their nonzeros'
    indices and values, the x rows they gather, the epilogue operands and
    y. With a row subset the update is in place: u is x, and its rows are
    among the gathered ones (every row stores its diagonal)."""
    sub = H if rows is None else H[rows]
    n_out = sub.shape[0]
    per = n_out * C * itemsize
    nbytes = 4 * (H.shape[0] + 1) if rows is None else 12 * n_out
    nbytes += sub.nnz * (4 + itemsize) + np.unique(sub.indices).size * C * itemsize + per
    ops = {None: "", "axpby": "ubs", "resid": "b", "add": "u", "resid_scaled": "bs"}[epi]
    nbytes += per * (("b" in ops) + ("u" in ops and rows is None)) + ("s" in ops) * n_out * itemsize
    return nbytes, 2 * sub.nnz * C


def spmv_cases(gs_hier, ogre_hier, dev):
    """The K1/K2 shapes of the static path: (label, operator, C, epi, rows, s)."""
    from surface_multigrid_code_torch.ops.sparse import csr_from_scipy

    lv = gs_hier.levels
    smoothed = range(len(lv) - 1)  # the coarsest level is a dense solve
    cases = []
    for l in smoothed:
        cases.append((f"A_{l} axpby", lv[l].A, 1, "axpby", None, lv[l].dinv))
    for l in smoothed:
        g = max(lv[l].groups, key=lambda r: r.shape[0])
        cases.append((f"A_{l} largest GS color, in place", lv[l].A, 1, "axpby", g, lv[l].dinv))
    for l in range(1, len(lv)):
        cases.append((f"P_{l} add", lv[l].P, 1, "add", None, None))
        cases.append((f"PT_{l}", lv[l].PT, 1, None, None, None))
    hub = max(range(1, len(ogre_hier.levels)),
              key=lambda l: int(ogre_hier.levels[l].PT.indptr.diff().max()))
    cases.append((f"ogre constrained PT_{hub} (hub rows)", ogre_hier.levels[hub].PT, 1,
                  None, None, None))
    for l in smoothed[:2]:
        cases.append((f"A_{l} axpby C=3", lv[l].A, 3, "axpby", None, lv[l].dinv))
    floor = csr_from_scipy(host_csr(lv[0].A)[:32], dev)
    cases.append(("launch floor: A_0[:32] axpby", floor, 1, "axpby", None, lv[0].dinv[:32]))
    return cases


def shape_inputs(k, case, dev):
    """Seeded inputs of spmv_cases()[k] = case: (the operator as a host CSR,
    x, the fused_spmv keywords, the host row ids or None). With a row
    subset the update is in place: x, u and out are one buffer."""
    _, S, C, epi, rows, s = case
    n, m = S.shape
    g = torch.Generator(device=dev).manual_seed(100 + k)

    def rnd(r):
        return torch.randn((r,) if C == 1 else (r, C), device=dev, generator=g)

    x, u, b = rnd(m), rnd(n), rnd(n)
    if s is None:
        s = torch.rand(n, device=dev, generator=g) + 0.5
    kw = dict(epi=epi, u=u, b=b, s=s, escale=2.0 / 3.0)
    if rows is None:
        return host_csr(S), x, kw, None
    kw.update(rows=rows, out=u)
    return host_csr(S), u, kw, rows.cpu().numpy()


def spmv_shapes(cases, dev, reps=20):
    """Phase 6: K1/K2 at every shape of the static path. Per shape: device
    time (profiler) and per-call time (events) of the kernel and of one
    cuSPARSE call of the same SpMV (``torch.sparse_csr_tensor @ x``, on a
    CSR of the same rows built outside the timed region; a yardstick the
    port never calls), in turns kernel, library, library, kernel; the
    plain version too at the A_0 shapes. Returns one record per shape."""
    from surface_multigrid_code_torch.ops.spmv import fused_spmv, fused_spmv_plain

    out = []
    for k, case in enumerate(cases):
        label, S, C, epi, rows, _ = case
        H, x, kw, host_rows = shape_inputs(k, case, dev)
        L = H if rows is None else H[host_rows]
        lib_A = torch.sparse_csr_tensor(
            torch.as_tensor(L.indptr, dtype=torch.int32, device=dev),
            torch.as_tensor(L.indices, dtype=torch.int32, device=dev),
            torch.as_tensor(L.data, dtype=torch.float32, device=dev), size=L.shape)
        fns = {"kernel": lambda: fused_spmv(S, x, **kw), "library": lambda: lib_A @ x}
        fns["kernel"]()
        lanes = fused_spmv.last_lanes
        turns = ["kernel", "library", "library", "kernel"]
        if label.startswith("A_0 axpby"):
            fns["plain"] = lambda: fused_spmv_plain(S, x, **kw)
            turns = ["plain", *turns, "plain"]
        dev_ms, call_ms, burst = timed_turns(fns, turns, reps, {"kernel": "spmv_fused_kernel"},
                                             label)
        nbytes, flops = spmv_bytes(H, C, epi, host_rows)
        bms, by = bound_ms(nbytes, flops)
        rec = {"shape": label, "C": C, "rows": int(L.shape[0]), "nnz": int(L.nnz),
               "max_row": int(np.diff(L.indptr).max()) if L.shape[0] else 0,
               "row_lanes": S.lanes, "lanes": lanes,
               "bytes": int(nbytes),
               "bound_ms": bms, "bound_by": by,
               "kernel_burst_ms": float(np.median(burst["kernel"]))}
        for w in fns:
            rec[f"{w}_ms"] = float(np.median(dev_ms[w]))
            rec[f"{w}_call_ms"] = float(np.median(call_ms[w]))
        out.append(rec)
        log(f"phase 6: {kernel_name(C)} {label}: {rec['rows']} rows, {rec['nnz']} nnz "
            f"(max row {rec['max_row']}), lanes {rec['lanes']} of {rec['row_lanes']}; "
            f"bound {1e3 * bms:.3f} us "
            f"({nbytes} B); device kernel {[1e3 * t for t in dev_ms['kernel']]} us, "
            f"cuSPARSE {[1e3 * t for t in dev_ms['library']]} us"
            + (f", plain {[1e3 * t for t in dev_ms['plain']]} us" if "plain" in fns else "")
            + f"; back to back {[1e3 * t for t in burst['kernel']]} us"
            + f"; per call kernel {1e3 * rec['kernel_call_ms']:.2f} us, cuSPARSE "
            f"{1e3 * rec['library_call_ms']:.2f} us")
    return out


# ---------------------------------------------------------------- balloon

def balloon_defaults() -> dict:
    """The keyword defaults of the port's run_balloon (example 06 settings)."""
    import inspect

    from surface_multigrid_code_torch.models.balloon import run_balloon

    return {k: p.default for k, p in inspect.signature(run_balloon).parameters.items()
            if p.default is not inspect.Parameter.empty}


def balloon_shell(V, F, dev):
    """The example-06 shell (float64 on dev) and 3-expanded lumped mass."""
    from surface_multigrid_code_torch.models.balloon import lumped_mass_matrix
    from surface_multigrid_code_torch.models.shell import ShellEnergy, lame_parameters

    d = balloon_defaults()
    al, be = lame_parameters(d["young"], d["poisson"])
    shell = ShellEnergy(V, F, d["thickness"], al, be, d["material"], device=dev)
    return shell, 1000.0 * lumped_mass_matrix(V, F)


def block_hessian(stepper, pos, dev):
    """The stepper's assembled block Hessian (M + dt^2 K, PSD-projected) at pos."""
    from surface_multigrid_code_torch.models.shell import psd_project_blocks

    x = torch.as_tensor(np.asarray(pos).reshape(-1), device=dev).to(stepper.dtype)
    H = [psd_project_blocks(h) for h in stepper._face_blocks(x, stepper._face9(x))]
    return stepper._assemble(H)


def bsr_subset(A, n, empty_fifth=False):
    """The first n block rows of the BSRMatrix A; with empty_fifth, rows 0,
    5, 10, ... keep no block. Columns are kept."""
    from surface_multigrid_code_torch.ops.sparse import BSRMatrix

    indptr = A.indptr.cpu().numpy().astype(np.int64)
    counts = np.diff(indptr[: n + 1])
    keep_row = np.ones(n, dtype=bool)
    if empty_fifth:
        keep_row[::5] = False
    sel = np.flatnonzero(np.repeat(keep_row, counts))
    new_ptr = np.concatenate([[0], np.cumsum(counts * keep_row)])
    sel_t = torch.as_tensor(sel, device=A.indices.device)
    return BSRMatrix(torch.as_tensor(new_ptr.astype(np.int32), device=A.indptr.device),
                     A.indices[sel_t].contiguous(), A.blocks[sel_t].contiguous(), A.n_cols)


def check_bsr(A, label, dev, errs, rng, lanes=None):
    """K3 against the plain version on the block operator A (any dtype on
    dev), f32 and f64, every epilogue; ``lanes`` forces the sub-warp width.
    Returns (number of cases, the lanes launched)."""
    from surface_multigrid_code_torch.ops.bsr_spmv import fused_bsr_spmv, fused_bsr_spmv_plain
    from surface_multigrid_code_torch.ops.sparse import BSRMatrix

    n, m = A.n_rows, A.n_cols
    n_cases = 0
    for dt in (torch.float32, torch.float64):
        Ad = BSRMatrix(A.indptr, A.indices, A.blocks.to(dt).contiguous(), m)
        if lanes is not None:
            Ad.lanes = lanes
        x = torch.as_tensor(rng.standard_normal((m, 3)), device=dev).to(dt)
        u, b = (torch.as_tensor(rng.standard_normal((n, 3)), device=dev).to(dt)
                for _ in range(2))
        s = torch.as_tensor(rng.uniform(0.5, 2.0, (n, 3)), device=dev).to(dt)
        for epi in EPIS:
            kw = dict(b=b, u=u, s=s, escale=2.0 / 3.0)
            y = fused_bsr_spmv(Ad, x, epi, **kw)
            what = (f"bsr {label} ({n} rows, {Ad.nnz} blocks) epi={epi} {dt}, "
                    f"lanes {fused_bsr_spmv.last_lanes}")
            _compare(y, fused_bsr_spmv_plain(Ad, x, epi, **kw), dt, what, errs, "bsr_spmv")
            if lanes is not None and dev.type == "cuda" and fused_bsr_spmv.last_lanes != lanes:
                raise RuntimeError(f"{what}: not the forced {lanes} lanes")
            n_cases += 1
    return n_cases, fused_bsr_spmv.last_lanes


def check_block_kernels(V, F, mg, dev, seed=1):
    """Phase 3 (K3): kernel against plain version, every epilogue, f32 and
    f64, on every level of the bunny_15K balloon hierarchy (the block
    Hessian at the rest pose and its Galerkin levels); then at every
    forced width the coarsest level cut to an odd number of rows, alone
    and with every fifth row emptied, so that every width below 32 runs a
    ragged last warp and empty rows. Returns {"bsr_spmv": max abs error}."""
    from surface_multigrid_code_torch.models.balloon import BsrBalloonStepper

    shell, M = balloon_shell(V, F, dev)
    stepper = BsrBalloonStepper(shell, M, mg, balloon_defaults()["dt"], dtype=torch.float64)
    hier = stepper.solver.refresh(block_hessian(stepper, V, dev))
    rng = np.random.default_rng(seed)
    errs, n_cases, widths = {}, 0, []
    for lv, level in enumerate(hier.levels):
        n, got = check_bsr(level.A, f"level {lv}", dev, errs, rng)
        n_cases += n
        widths.append(f"{level.A.n_rows} rows, {level.A.nnz} blocks: {level.A.lanes} -> {got}")
    coarse = hier.levels[-1].A
    k = coarse.n_rows - 1 + coarse.n_rows % 2
    cuts = {f"coarsest[:{k}]": bsr_subset(coarse, k),
            f"coarsest[:{k}] with empty rows": bsr_subset(coarse, k, empty_fifth=True)}
    for lanes in (1, 2, 4, 8, 16, 32):
        for label, A in cuts.items():
            n_cases += check_bsr(A, f"{label} forced", dev, errs, rng, lanes=lanes)[0]
    torch.cuda.synchronize(dev)
    log(f"phase 3: K3 {n_cases} kernel-vs-plain cases agree on all {hier.n_levels} bunny_15K "
        f"levels (lanes operator -> launch: {widths}) and at 6 forced widths on the "
        f"coarsest cut to {k} rows, alone and with every fifth row empty; "
        f"max abs err {errs['bsr_spmv']:.3e}")
    return errs


def scaled_blocks(H):
    """The blocks psd_project_blocks hands to the sign kernel: Hs / inf-norm."""
    Hs = 0.5 * (H + H.transpose(-1, -2))
    s = Hs.abs().sum(dim=-1).amax(dim=-1).clamp_min(1e-30)
    return (Hs / s[:, None, None]).contiguous()


# eigenvalues at the edges of the Newton-Schulz schedule's range, and the
# limits there on (1/2) Y: 2.5-3x the worst sound reading (the plain
# version on the H100 and on the CPU, and the kernel before and after its
# register body, kernel_ab.py psd on the H100) of the largest distance to
# the exact f64 eigen-projection U max(L, 0) U^T (1.9e-5 in f32, 3.9e-14
# in f64) and of the least eigenvalue (-8.1e-8 in f32, -1.0e-15 in f64)
EDGE_EIGS = (-1.5e-3, 1.5e-3, -1e-2, 1e-2, 1.4)
EDGE_DIST = {torch.float32: 5e-5, torch.float64: 1e-13}
EDGE_LEAST = {torch.float32: 2e-7, torch.float64: 2.5e-15}


def edge_blocks(m, d, seed):
    """m symmetric d x d blocks U diag(lam) U^T with every eigenvalue in
    EDGE_EIGS (each block holds all of them), and their exact PSD parts."""
    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.standard_normal((m, d, d)))
    lam = rng.choice(np.array(EDGE_EIGS), size=(m, d))
    lam[:, :len(EDGE_EIGS)] = EDGE_EIGS
    X = np.einsum("mij,mj,mkj->mik", U, lam, U)
    P = np.einsum("mij,mj,mkj->mik", U, np.maximum(lam, 0.0), U)
    return 0.5 * (X + X.transpose(0, 2, 1)), P


def check_sign_kernel(V, F, pos, dev, seed=2):
    """Phase 3 (K4), at the pressure-1e6 pose the balloon reached, f32 and
    f64, kernel against plain version: the 31,604 real 9x9 face Hessians,
    the real 18x18 bending Hessians of the same pose, random symmetric
    18x18 blocks; and blocks with eigenvalues at the schedule's edges,
    where the kernel's and the plain version's (1/2) Y
    are each held against the exact f64 eigen-projection (least eigenvalue
    and distance computed on the host: cuSOLVER's batched eigvalsh refuses
    31,604 blocks), and the two against each other at TOL in f64 only.
    Returns ({"ns_sign_apply": max abs err of the TOL-held cases},
    {edge case: distances})."""
    from surface_multigrid_code_torch.models.shell import ShellEnergy, lame_parameters
    from surface_multigrid_code_torch.ops.psd import ns_sign_apply, ns_sign_apply_plain

    d_ = balloon_defaults()
    al, be = lame_parameters(d_["young"], d_["poisson"])
    shell = ShellEnergy(V, F, d_["thickness"], al, be, d_["material"], bending=True, device=dev)
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((4096, 18, 18))
    edges = {d: edge_blocks(4096, d, seed + d) for d in (9, 18)}
    errs, n_neg, n_cases, edge = {}, 0, 0, {}
    for dt in (torch.float32, torch.float64):
        xv = torch.as_tensor(np.asarray(pos), device=dev).to(dt)
        x9 = xv[shell.Ft].reshape(-1, 9)
        opp, mask, bbars = shell.bend_state(dt)
        x18 = torch.cat([x9, xv[opp].reshape(-1, 9)], dim=1)
        X9 = scaled_blocks(shell.face_hess(x9, shell.abars.to(dt)))
        X18 = scaled_blocks(shell.face_hess_bend(x18, shell.abars.to(dt), bbars, mask))
        # (blocks, what, exact PSD part for the edge sets)
        cases = [(X9, f"{X9.shape[0]} face Hessians 9x9", None),
                 (X18, f"{X18.shape[0]} bending Hessians 18x18", None),
                 (scaled_blocks(torch.as_tensor(B, device=dev).to(dt)), "4096 random 18x18", None)]
        for d, (E, P) in edges.items():
            cases.append((torch.as_tensor(E, device=dev).to(dt).contiguous(),
                          f"4096 {d}x{d} with eigenvalues at {EDGE_EIGS}", P))
        for X, what, P in cases:
            Y = ns_sign_apply(X)
            ref = ns_sign_apply_plain(X)
            label = f"K4 {what} {dt}"
            if P is None or dt == torch.float64:
                _compare(Y, ref, dt, label, errs, "ns_sign_apply")
                n_cases += 1
            if P is None:
                continue
            # the edge set: kernel and plain version each held against the
            # exact projection; in f32 the two are not held to each other at
            # TOL (the growth cubics amplify their different rounding at the
            # schedule's edges), their distance is reported
            rec = {"kernel_vs_plain": float((Y - ref).abs().max()),
                   "max_abs_y": float(ref.abs().max())}
            for who, Z in (("kernel", Y), ("plain", ref)):
                half = 0.5 * Z.double().cpu().numpy()
                least = float(np.linalg.eigvalsh(0.5 * (half + half.transpose(0, 2, 1))).min())
                dist = float(np.abs(half - P).max())
                rec[who] = {"least_eig": least, "distance": dist}
                if not (dist <= EDGE_DIST[dt] and least >= -EDGE_LEAST[dt]):
                    raise RuntimeError(f"{label}: the {who} is {dist:.3e} off the eigen-projection "
                                       f"(limit {EDGE_DIST[dt]:g}), least eigenvalue {least:.3e} "
                                       f"(limit {-EDGE_LEAST[dt]:g})")
            edge[f"{X.shape[1]}x{X.shape[1]} {str(dt)[6:]}"] = rec
            log(f"phase 3: {label}: max|kernel - plain| {rec['kernel_vs_plain']:.3e} "
                f"(max|y| {rec['max_abs_y']:.3e}); least eigenvalue of Y/2 and max distance to "
                f"the f64 eigen-projection: kernel {rec['kernel']}, plain {rec['plain']} "
                f"(limits {-EDGE_LEAST[dt]:g}, {EDGE_DIST[dt]:g})")
        # counted on the host: cuSOLVER's batched eigvalsh refuses 31,604 blocks
        n_neg = int((torch.linalg.eigvalsh(X9.double().cpu()).min(dim=1).values < -1e-4).sum())
    torch.cuda.synchronize(dev)
    log(f"phase 3: K4 {n_cases} kernel-vs-plain cases agree on the step-{BALLOON_STEPS} pose "
        f"({n_neg} of {F.shape[0]} scaled face blocks have an eigenvalue below -1e-4), "
        f"random 18x18 and edge-eigenvalue blocks; max abs err {errs['ns_sign_apply']:.3e}")
    return errs, edge


def balloon_path(V, F, mg, dev):
    """Phase 7: run_balloon at its defaults on bunny_15K for BALLOON_STEPS
    steps and on the midpoint-subdivided bunny for 1 step, f32 on the card.
    Returns (positions, stats, summary)."""
    from surface_multigrid_code_torch import mg_precompute
    from surface_multigrid_code_torch.models.balloon import run_balloon
    from surface_multigrid_code_torch.utils.synthetic import midpoint_subdivide

    stats, positions, walls = [], [], []
    it = run_balloon(V, F, n_steps=BALLOON_STEPS, mg=mg, device=dev, stats=stats,
                     verbose=False)
    t0 = time.perf_counter()
    for pos in it:
        positions.append(pos)
        walls.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
    if len(stats) != BALLOON_STEPS or not all(isinstance(s["last_rejected"], int) for s in stats):
        raise RuntimeError("last_rejected was not recorded for every step")
    for k, (pos, st) in enumerate(zip(positions, stats)):
        if pos.shape != V.shape or not np.isfinite(pos).all() or not np.isfinite(st["qdot"]).all():
            raise RuntimeError(f"balloon step {k}: bad shape or non-finite state")
        log(f"phase 7: bunny_15K step {k}: max|disp| {np.abs(pos - V).max():.6f}, "
            f"rejects {st['last_rejected']}, residuals per Newton solve "
            f"{[r['residuals'] for r in st['newton']]}, unconverged solves "
            f"{sum(not r['converged'] for r in st['newton'])}, alphas "
            f"{sorted(set(r['alpha'] for r in st['newton']))}, wall {walls[k]:.3f} s")

    V2, F2, _ = midpoint_subdivide(V, F)
    t0 = time.perf_counter()
    mg2 = mg_precompute(V2, F2, verbose=False)
    t_mg2 = time.perf_counter() - t0
    stats2 = []
    t0 = time.perf_counter()
    (pos2,) = list(run_balloon(V2, F2, n_steps=1, mg=mg2, device=dev, stats=stats2,
                               verbose=False))
    wall2 = time.perf_counter() - t0
    if not np.isfinite(pos2).all() or not isinstance(stats2[0]["last_rejected"], int):
        raise RuntimeError("subdivided bunny step: non-finite state or no reject count")
    log(f"phase 7: subdivided bunny |V| {V2.shape[0]} |F| {F2.shape[0]} "
        f"({3 * V2.shape[0]} DOFs; mg_precompute {t_mg2:.2f} s, levels "
        f"{[lv.V.shape[0] for lv in mg2]}): max|disp| {np.abs(pos2 - V2).max():.6f}, "
        f"rejects {stats2[0]['last_rejected']}, residuals per Newton solve "
        f"{[r['residuals'] for r in stats2[0]['newton']]}, unconverged solves "
        f"{sum(not r['converged'] for r in stats2[0]['newton'])}, alphas "
        f"{[r['alpha'] for r in stats2[0]['newton']]}, wall {wall2:.3f} s")
    summary = {
        "max_disp": [float(np.abs(p - V).max()) for p in positions],
        "rejects": [s["last_rejected"] for s in stats],
        "first_step_wall_s": walls[0],
        "subdiv": {"nv": int(V2.shape[0]), "nf": int(F2.shape[0]),
                   "max_disp": float(np.abs(pos2 - V2).max()),
                   "rejects": stats2[0]["last_rejected"], "wall_s": wall2},
    }
    return positions, stats, summary


def balloon_oracle(V, F, positions, stats, dev):
    """Phase 8: every step's max|disp| against the direct f64 step (host
    splu, psd_project=True) run from the same state. Returns (the gaps,
    the direct steps' max|disp|)."""
    from surface_multigrid_code_torch.models.balloon import (
        implicit_euler_balloon_direct,
        inflation_force,
    )

    d = balloon_defaults()
    shell, M = balloon_shell(V, F, dev)
    cur, qd = V.copy(), np.zeros(V.size)
    gaps, direct = [], []
    for k in range(BALLOON_STEPS):
        t0 = time.perf_counter()
        fExt = inflation_force(cur, F, d["pressure"])
        pd, _ = implicit_euler_balloon_direct(shell, M, cur, qd, fExt, d["dt"],
                                              n_newton=d["n_newton"], verbose=False,
                                              psd_project=True)
        mg_disp = float(np.abs(positions[k] - V).max())
        d_disp = float(np.abs(pd - V).max())
        gap = abs(mg_disp - d_disp) / d_disp
        gaps.append(gap)
        direct.append(d_disp)
        log(f"phase 8: step {k}: max|disp| multigrid {mg_disp:.6f}, direct f64 "
            f"{d_disp:.6f}, relative gap {gap:.4f} (limit {ORACLE_GAP[k]}); "
            f"{time.perf_counter() - t0:.1f} s")
        if not gap <= ORACLE_GAP[k]:
            raise RuntimeError(f"balloon step {k}: gap {gap:.4f} to the direct step "
                               f"above {ORACLE_GAP[k]}")
        cur, qd = positions[k], stats[k]["qdot"]
    return gaps, direct


def balloon_timings(V, F, mg, cur, qd, dev):
    """Phase 9 (a process of its own, see run_child): K3 and K4 at every
    shape of the step (bsr_shapes, sign_shapes); ms per balloon step on
    bunny_15K (f32) from the state (cur, qd), split per Newton iteration
    into its phases; the device busy time and idle share of one profiled
    step. Returns (balloon record, {kernel: main-shape times}, K3 records,
    K4 records)."""
    from surface_multigrid_code_torch.models.balloon import (
        PHASES,
        BsrBalloonStepper,
        inflation_force,
    )
    from surface_multigrid_code_torch.ops.bsr_spmv import fused_bsr_spmv
    from surface_multigrid_code_torch.ops.psd import ns_sign_apply
    from surface_multigrid_code_torch.ops.spmv import fused_spmv

    d = balloon_defaults()
    shell, M = balloon_shell(V, F, dev)
    stepper = BsrBalloonStepper(shell, M, mg, d["dt"], mg_tolerance=d["mg_tolerance"],
                                n_newton=d["n_newton"])
    fExt = inflation_force(cur, F, d["pressure"])

    # the kernels at the step's shapes, timed before the step's profiler
    # session of ~11K device events: sessions after it were seen to record
    # no device event
    hier = stepper.solver.refresh(block_hessian(stepper, cur, dev))
    x9 = torch.as_tensor(np.asarray(cur)[F].reshape(-1, 9), device=dev, dtype=stepper.dtype)
    X = scaled_blocks(shell.face_hess(x9, stepper.abars))
    shapes = bsr_shapes(hier, dev)
    signs = sign_shapes(X, dev)
    ker = {}
    for name, rec in (("bsr_spmv", shapes[0]), ("ns_sign_apply", signs[0])):
        ker[name] = {"kernel": rec["kernel_ms"], "plain": rec["plain_ms"],
                     "kernel_call": rec["kernel_call_ms"], "plain_call": rec["plain_call_ms"],
                     "bound": rec["bound_ms"], "bound_by": rec["bound_by"],
                     "library": rec.get("library_ms")}

    def one_step():
        stepper.step(cur, qd, fExt)

    one_step()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    step_ms = float(np.median(walls))
    stepper.timed = True
    one_step()
    stepper.timed = False
    newton = [{"residuals": r["residuals"], **{p: r[p] * 1e3 for p in PHASES}}
              for r in stepper.last_newton]
    tot = {p: sum(r[p] for r in newton) for p in PHASES}
    prof = checked_step(one_step, {"spmv_fused_kernel": lambda: fused_spmv.launches,
                                   "bsr_spmv_kernel": lambda: fused_bsr_spmv.launches,
                                   "ns_sign_apply": lambda: ns_sign_apply.launches},
                        "bunny_15K balloon step")
    busy, n_dev = prof["ms"], prof["events"]
    idle = 1.0 - busy / prof["wall_ms"]
    log(f"phase 9: bunny_15K balloon step (f32, {stepper.solver.plans[0].n} V, "
        f"{len(stepper.solver.plans)} levels): {walls} ms wall; per step by phase "
        f"(ms, timed run with a sync per phase) {tot}; residuals per Newton solve "
        f"{[r['residuals'] for r in newton]}; profiled step: device busy {busy:.3f} ms over "
        f"{n_dev:.0f} device ops (hand-kernel launches recorded {prof['recorded']} of "
        f"{prof['counted']}) in {prof['wall_ms']:.3f} ms, idle share {idle:.4f}")
    bal = {"step_ms": step_ms, "step_walls_ms": walls, "device_ms": busy,
           "device_ops": n_dev, "profiled_step_ms": prof["wall_ms"], "idle_share": idle,
           "phase_ms": tot, "newton": newton}
    return bal, ker, shapes, signs


def bsr_bytes(A, epi, itemsize=4):
    """Bytes one fused block SpMV must move, each input read once and each
    output written once: indptr, the blocks' indices and values, the x rows
    they gather, the epilogue operands ([n, 3] each) and y."""
    n = A.n_rows
    per = 3 * n * itemsize
    cols = int(torch.unique(A.indices).numel())
    nbytes = 4 * (n + 1) + A.nnz * (4 + 9 * itemsize) + 3 * cols * itemsize + per
    nbytes += per * len({None: "", "axpby": "ubs", "resid": "b", "add": "u",
                         "resid_scaled": "bs"}[epi])
    return nbytes, 18 * A.nnz


def timed_turns(fns, turns, reps, kernels, label):
    """Device time (profiler) and per-call time (events) of each of fns,
    one measurement of reps calls per entry of turns. ``kernels`` maps the
    fns that launch one hand kernel a call to its name: those are timed by
    that kernel's recorded launches and held to their back-to-back time
    (checked_kernel_ms). Returns ({name: [device ms per turn]}, {name:
    [call ms per turn]}, {name: [back-to-back ms per turn]})."""
    dev_ms, call_ms, burst = ({w: [] for w in fns} for _ in range(3))
    for w in turns:
        if w in kernels:
            d, b = checked_kernel_ms(fns[w], reps, kernels[w], f"{label} ({w})")
            burst[w].append(b)
        else:
            d = device_ms(fns[w], reps)["ms"]
        dev_ms[w].append(d)
        call_ms[w].append(cuda_ms(fns[w], reps))
    return dev_ms, call_ms, burst


def bsr_shapes(hier, dev, reps=20):
    """Phase 9: K3 at every shape of the balloon path, f32: every level K3
    runs on (all but the dense coarsest) with each epilogue the path uses
    (resid_scaled: Chebyshev; axpby: Jacobi; resid: the V-cycle's and the
    solve loop's residual; None: the power iteration). Per shape: device
    time (profiler) and per-call time (events) of the kernel and of one
    cuSPARSE bsrmv of the same product (``torch.sparse_bsr_tensor @ x``,
    without the epilogue; a yardstick the port never calls), in turns
    kernel, library, library, kernel; the plain version too at level-0
    resid_scaled, the first record. Returns one record per shape."""
    from surface_multigrid_code_torch.ops.bsr_spmv import fused_bsr_spmv, fused_bsr_spmv_plain

    out = []
    g = torch.Generator(device=dev).manual_seed(5)
    for lv, level in enumerate(hier.levels[:-1]):
        A = level.A
        x = torch.randn((A.n_cols, 3), device=dev, generator=g, dtype=A.blocks.dtype)
        u, b = (torch.randn((A.n_rows, 3), device=dev, generator=g, dtype=A.blocks.dtype)
                for _ in range(2))
        lib_A = torch.sparse_bsr_tensor(A.indptr, A.indices, A.blocks,
                                        size=(3 * A.n_rows, 3 * A.n_cols))
        xf = x.reshape(-1)
        for epi in ("resid_scaled", "axpby", "resid", None):
            kw = dict(b=b, u=u, s=level.dinv, escale=2.0 / 3.0)
            fns = {"kernel": lambda: fused_bsr_spmv(A, x, epi, **kw),
                   "library": lambda: lib_A @ xf}
            fns["kernel"]()
            lanes = fused_bsr_spmv.last_lanes
            turns = ["kernel", "library", "library", "kernel"]
            if not out:
                fns["plain"] = lambda: fused_bsr_spmv_plain(A, x, epi, **kw)
                turns = ["plain", *turns, "plain"]
            dev_ms, call_ms, burst = timed_turns(fns, turns, reps, {"kernel": "bsr_spmv_kernel"},
                                                 f"bsr_spmv level {lv} {epi}")
            nbytes, flops = bsr_bytes(A, epi)
            bms, by = bound_ms(nbytes, flops)
            counts = A.indptr.diff()
            rec = {"shape": f"level {lv} {epi}", "level": lv, "epi": epi,
                   "rows": A.n_rows, "blocks": A.nnz, "max_row": int(counts.max()),
                   "row_lanes": A.lanes, "lanes": lanes, "bytes": int(nbytes),
                   "bound_ms": bms, "bound_by": by,
                   "kernel_turns_ms": dev_ms["kernel"], "library_turns_ms": dev_ms["library"],
                   "kernel_burst_ms": float(np.median(burst["kernel"]))}
            for w in fns:
                rec[f"{w}_ms"] = float(np.median(dev_ms[w]))
                rec[f"{w}_call_ms"] = float(np.median(call_ms[w]))
            out.append(rec)
            log(f"phase 9: bsr_spmv level {lv} {epi}: {A.n_rows} rows, {A.nnz} blocks (max row "
                f"{rec['max_row']}), lanes {lanes} of {A.lanes}; bound {1e3 * bms:.3f} us "
                f"({nbytes} B); device kernel {[1e3 * t for t in dev_ms['kernel']]} us, "
                f"cuSPARSE bsrmv {[1e3 * t for t in dev_ms['library']]} us"
                + (f", plain {[1e3 * t for t in dev_ms['plain']]} us" if "plain" in fns else "")
                + f"; back to back {[1e3 * t for t in burst['kernel']]} us"
                + f"; per call kernel {1e3 * rec['kernel_call_ms']:.2f} us, cuSPARSE "
                f"{1e3 * rec['library_call_ms']:.2f} us")
    return out


def sign_shapes(X9, dev, reps=20):
    """Phase 9: K4 at each (d, dtype) it runs in, on as many blocks as the
    step has faces: 9x9 f32 (the balloon's face Hessians at the step's
    pose: the register body), 9x9 f64 and 18x18 (random symmetric) f32 and
    f64 (the shared-memory body). Device time (profiler) and per-call time
    (events) in two interleaved turns, the plain version beside the first
    (9x9 f32) before and after them. Returns one record per case, that one
    first."""
    from surface_multigrid_code_torch.ops.psd import NS_SCHEDULE, ns_sign_apply, ns_sign_apply_plain

    m = X9.shape[0]
    g = torch.Generator(device=dev).manual_seed(6)
    R = scaled_blocks(torch.randn((m, 18, 18), device=dev, generator=g, dtype=torch.float64))
    cases = {"9x9 float32": X9, "9x9 float64": X9.double(), "18x18 float32": R.float(),
             "18x18 float64": R}
    fns = {k: (lambda X=X: ns_sign_apply(X)) for k, X in cases.items()}
    fns["plain"] = lambda: ns_sign_apply_plain(X9)
    first = next(iter(cases))
    turns = ["plain", *cases, *cases, "plain"]
    dev_ms, call_ms, burst = timed_turns(fns, turns, reps, dict.fromkeys(cases, "ns_sign_apply"),
                                         "ns_sign_apply")
    out = []
    for k, X in cases.items():
        d, isz = X.shape[1], X.element_size()
        # every iterate is a polynomial in the symmetric block, so each of
        # the 2 * steps + 1 products is symmetric: d(d+1)/2 entries of d MACs
        flops = m * (2 * len(NS_SCHEDULE) + 1) * d * d * (d + 1)
        bms, by = bound_ms(2 * m * d * d * isz, flops, f64=isz == 8)
        rec = {"shape": k, "blocks": m, "d": d,
               "bytes": 2 * m * d * d * isz, "flops": flops, "bound_ms": bms, "bound_by": by,
               "kernel_turns_ms": dev_ms[k], "kernel_ms": float(np.median(dev_ms[k])),
               "kernel_call_ms": float(np.median(call_ms[k])), "library_ms": None,
               "kernel_burst_ms": float(np.median(burst[k]))}
        if k == first:
            rec.update(plain_ms=float(np.median(dev_ms["plain"])),
                       plain_call_ms=float(np.median(call_ms["plain"])))
        out.append(rec)
        log(f"phase 9: ns_sign_apply {k} ({m} blocks): bound "
            f"{1e3 * bms:.3f} us ({by}); device {[1e3 * t for t in dev_ms[k]]} us"
            + (f", plain {[1e3 * t for t in dev_ms['plain']]} us" if k == first else "")
            + f"; back to back {[1e3 * t for t in burst[k]]} us"
            + f"; per call {1e3 * rec['kernel_call_ms']:.2f} us")
    return out


# ---------------------------------------------------------------- MCF

def mcf_label(name, subdivide):
    return ("subdivided " if subdivide else "") + name


def mcf_mesh(name, subdivide):
    """Example 05's input: the mesh (midpoint-subdivided when asked) at unit
    area, and its hierarchy by the example's recipe. Returns (V, F, mg,
    host seconds of mg_precompute)."""
    from surface_multigrid_code_torch import mg_precompute
    from surface_multigrid_code_torch.config import DecimationType
    from surface_multigrid_code_torch.utils.mesh import normalize_unit_area
    from surface_multigrid_code_torch.utils.obj_io import read_obj
    from surface_multigrid_code_torch.utils.paths import mesh_path
    from surface_multigrid_code_torch.utils.synthetic import midpoint_subdivide

    V, F = read_obj(mesh_path(name))
    if subdivide:
        V, F, _ = midpoint_subdivide(V, F)
    V = normalize_unit_area(V, F)
    t0 = time.perf_counter()
    mg = mg_precompute(V, F, ratio=0.25, min_coarsest_nv=500,
                       dec_type=DecimationType.MIDPOINT, verbose=False)
    return V, F, mg, time.perf_counter() - t0


def mcf_exact(V, F, n_steps, delta=0.01):
    """The host f64 flow: per step a direct solve of (M - delta L) U =
    M U_pre (M the barycentric mass of U_pre, L of the original mesh),
    then normalize_unit_area. Returns U after each step."""
    from scipy.sparse.linalg import splu

    from surface_multigrid_code_torch.ops.laplacian import cotmatrix, massmatrix
    from surface_multigrid_code_torch.utils.mesh import normalize_unit_area

    L = cotmatrix(V, F)
    U, out = V, []
    for _ in range(n_steps):
        M = massmatrix(U, F, kind="barycentric")
        U = normalize_unit_area(splu((M - delta * L).tocsc()).solve(M @ U), F)
        out.append(U)
    return out


def mcf_path(meshes, dev):
    """Phase 10: MCFStepper.step (f32 on the card) on each of meshes
    (MCF_MESHES' form); every step must converge to MCF_TOL within 20
    cycles, with finite values at unit area, and the flows marked so must
    stay within MCF_EXACT_GAP of the host f64 flow at every step. Returns
    ({label: record}, {label: (V, stepper)})."""
    from surface_multigrid_code_torch import MCFStepper
    from surface_multigrid_code_torch.utils.mesh import doublearea

    out, steppers = {}, {}
    for name, subdivide, n_steps, exact in meshes:
        label = mcf_label(name, subdivide)
        V, F, mg, t_mg = mcf_mesh(name, subdivide)
        t0 = time.perf_counter()
        stepper = MCFStepper(V, F, mg, device=dev)
        t_setup = time.perf_counter() - t0
        ref = mcf_exact(V, F, n_steps) if exact else None
        levels = [lv.V.shape[0] for lv in mg]
        log(f"phase 10: MCF {label} |V| {V.shape[0]} |F| {F.shape[0]}, levels {levels} "
            f"(mg_precompute {t_mg:.2f} s, stepper {t_setup:.2f} s), "
            f"GS colors {[len(g) for g in stepper.solver.groups]}")
        U, steps = V, []
        for k in range(n_steps):
            t0 = time.perf_counter()
            U, r_his, ok = stepper.step(U)
            rec = {"cycles": len(r_his) - 1, "final_residual": r_his[-1],
                   "wall_s": time.perf_counter() - t0}
            if not ok:
                raise RuntimeError(f"MCF {label} step {k}: not converged to {MCF_TOL} "
                                   f"in {stepper.max_iter} cycles: {r_his}")
            area = doublearea(U, F).sum() / 2.0
            if U.shape != V.shape or not np.isfinite(U).all() or abs(area - 1.0) > 1e-4:
                raise RuntimeError(f"MCF {label} step {k}: bad shape, non-finite values "
                                   f"or area {area}")
            if ref is not None:
                rec["max_err_exact"] = float(np.abs(U - ref[k]).max())
                if not rec["max_err_exact"] <= MCF_EXACT_GAP:
                    raise RuntimeError(f"MCF {label} step {k}: max|U - U_exact| "
                                       f"{rec['max_err_exact']:.3e} > {MCF_EXACT_GAP}")
            steps.append(rec)
            log(f"phase 10: MCF {label} step {k}: {rec['cycles']} cycles, residuals "
                f"{r_his[0]:.4e} -> {r_his[-1]:.4e}"
                + (f", max|U - U_exact| {rec['max_err_exact']:.3e}" if ref is not None else "")
                + f", wall {rec['wall_s']:.3f} s")
        out[label] = {"nv": int(V.shape[0]), "nf": int(F.shape[0]), "levels": levels,
                      "mg_precompute_s": t_mg, "setup_s": t_setup, "steps": steps}
        steppers[label] = (V, stepper)
    return out, steppers


def check_hierarchy(hier, label, dev, errs, rng, Cs):
    """K1/K2 against the plain version at a path's own shapes: every
    level's A, P and PT of the refreshed device hierarchy hier, for each C
    of Cs, every epilogue, f32 and f64; the largest GS color of every
    smoothed level in place. Returns the number of cases."""
    n_cases = 0
    for lv, level in enumerate(hier.levels):
        A = host_csr(level.A)
        ops = {f"A_{lv}": A}
        if lv:
            ops.update({f"P_{lv}": host_csr(level.P), f"PT_{lv}": host_csr(level.PT)})
        for name, S in ops.items():
            n_cases += check_spmv(S, f"{label} {name}", dev, errs, rng, Cs=Cs)
        if level.n_groups:
            g = max(level.groups, key=len).cpu().numpy()
            n_cases += check_spmv(A, f"{label} A_{lv} largest GS color", dev, errs, rng,
                                  Cs=Cs, rows=g)
    return n_cases


def check_mcf_kernels(steppers, dev, errs, seed=7):
    """Phase 10: K1/K2 against the plain version on each MCF stepper's
    hierarchy refreshed at its rest mesh (check_hierarchy, C = 1 and 3)."""
    rng = np.random.default_rng(seed)
    n_cases = 0
    for label, (V, st) in steppers.items():
        U = torch.as_tensor(V, dtype=st.dtype, device=dev)
        hier = st.solver.refresh(st.values(U)[0])
        n_cases += check_hierarchy(hier, f"MCF {label}", dev, errs, rng, Cs=(1, 3))
    torch.cuda.synchronize(dev)
    log(f"phase 10: K1/K2 {n_cases} kernel-vs-plain cases agree on every level and largest "
        f"GS color of the {len(steppers)} MCF hierarchies; max abs err {errs}")


def mcf_timings(dev):
    """Phase 11 (a process of its own, see run_child): the MCF steppers of
    MCF_MESHES built anew; K2 at the subdivided ogre's level-0 largest GS
    color (C = 3, in place; spmv_shapes); then per mesh the ms per MCF step
    (CUDA events around step_device, median of steps 1-5 of a flow from
    V), the device busy time of one profiled step and its idle share
    against that step's own event time, and the split by phase of one more
    step (a sync per phase). Returns ({label: record}, the K2 shape
    record)."""
    from surface_multigrid_code_torch import MCFStepper
    from surface_multigrid_code_torch.models.mcf import PHASES
    from surface_multigrid_code_torch.ops.spmv import fused_spmv

    steppers = {}
    for name, subdivide, _n, _exact in MCF_MESHES:
        V, F, mg, _t = mcf_mesh(name, subdivide)
        steppers[mcf_label(name, subdivide)] = (V, MCFStepper(V, F, mg, device=dev))
    V, st = steppers[mcf_label("ogre", True)]
    U = torch.as_tensor(V, dtype=st.dtype, device=dev)
    lv0 = st.solver.refresh(st.values(U)[0]).levels[0]
    g = max(lv0.groups, key=lambda r: r.shape[0])
    (k2,) = spmv_shapes([("MCF subdivided ogre A_0 largest GS color C=3, in place", lv0.A, 3,
                          "axpby", g, lv0.dinv)], dev)
    out = {}
    for label, (V, st) in steppers.items():
        U = torch.as_tensor(V, dtype=st.dtype, device=dev)
        ms, cycles = [], []
        for _ in range(MCF_TIMED_STEPS):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            U, _r, k = st.step_device(U)
            e1.record()
            torch.cuda.synchronize()
            ms.append(e0.elapsed_time(e1))
            cycles.append(k - 1)
        step_ms = float(np.median(ms[1:]))
        prof = checked_step(lambda: st.step_device(U),
                            {"spmv_fused_kernel": lambda: fused_spmv.launches},
                            f"MCF {label} step")
        busy, idle = prof["ms"], 1.0 - prof["ms"] / prof["wall_ms"]
        st.timed = True
        n0 = fused_spmv.planes_launches
        _U, _r, k = st.step_device(U)
        launches = fused_spmv.planes_launches - n0
        st.timed = False
        phases = {p: 1e3 * st.last_phases[p] for p in PHASES}
        out[label] = {"step_ms": step_ms, "step_event_ms": ms, "cycles": cycles,
                      "device_ms": busy, "device_ops": prof["events"],
                      "profiled_step_ms": prof["wall_ms"], "idle_share": idle,
                      "phase_ms": phases, "k2_launches": {"cycles": k - 1, "launches": launches}}
        log(f"phase 11: MCF {label} step (f32): {ms} ms (events; median of steps 1-5 "
            f"{step_ms:.3f}), cycles {cycles}; profiled step: device busy {busy:.3f} ms over "
            f"{prof['events']:.0f} device ops (K2 launches recorded {prof['recorded']} of "
            f"{prof['counted']}) in {prof['wall_ms']:.3f} ms, idle share {idle:.4f}; by phase "
            f"(ms, a sync per phase, {k - 1} cycles, {launches} K2 launches) {phases}")
    return out, k2


@contextlib.contextmanager
def timed_newton_solver(made):
    """Within the block, run_balloon builds its BalloonNewtonSolver as a
    subclass that appends each instance to ``made``, with ``setup_s`` (host
    seconds of its construction, closed by a device sync) and ``ready``
    (the host clock when it was done)."""
    from surface_multigrid_code_torch.models import balloon

    base = balloon.BalloonNewtonSolver

    class Timed(base):
        def __init__(self, *args, **kwargs):
            t0 = time.perf_counter()
            super().__init__(*args, **kwargs)
            torch.cuda.synchronize()
            self.ready = time.perf_counter()
            self.setup_s = self.ready - t0
            made.append(self)

    balloon.BalloonNewtonSolver = Timed
    try:
        yield
    finally:
        balloon.BalloonNewtonSolver = base


def scalar_balloon(V, F, direct_disp, dev):
    """Phase 12: one run_balloon(solver="scalar") step on bunny_15K at the
    defaults from rest (the 3-expanded hierarchy of mg_precompute_block,
    multicolor GS, f32 on the card), its max|disp| held to the direct f64
    step from rest within ORACLE_GAP[0]; the solver's set-up and the step
    timed on the host clock (timed_newton_solver; the step from the
    solver's end to the yielded positions). Returns (its record, the
    step's BalloonNewtonSolver)."""
    from surface_multigrid_code_torch import mg_precompute_block
    from surface_multigrid_code_torch.models.balloon import run_balloon

    t0 = time.perf_counter()
    mg = mg_precompute_block(V, F, verbose=False)
    t_mg = time.perf_counter() - t0
    stats, made = [], []
    with timed_newton_solver(made):
        (pos,) = list(run_balloon(V, F, n_steps=1, mg=mg, solver="scalar", device=dev,
                                  stats=stats, verbose=False))
    step_s = time.perf_counter() - made[0].ready
    ns = made[0]
    disp = float(np.abs(pos - V).max())
    gap = abs(disp - direct_disp) / direct_disp
    newton = stats[0]["newton"]
    log(f"phase 12: scalar balloon bunny_15K ({3 * V.shape[0]} DOFs, {ns.pattern.nnz} nnz, "
        f"levels {[lv.P_full.shape[1] for lv in mg[1:]]} coarse DOFs, GS colors "
        f"{[len(g) for g in ns.solver.groups]}; mg_precompute_block {t_mg:.2f} s): max|disp| "
        f"{disp:.6f}, direct f64 {direct_disp:.6f}, relative gap {gap:.4f} (limit "
        f"{ORACLE_GAP[0]}); rejects {stats[0]['last_rejected']}, residuals per Newton solve "
        f"{[r['residuals'] for r in newton]}, unconverged solves "
        f"{sum(not r['converged'] for r in newton)}, alphas "
        f"{sorted(set(r['alpha'] for r in newton))}; set-up {ns.setup_s:.3f} s, step "
        f"{step_s:.3f} s")
    if pos.shape != V.shape or not np.isfinite(pos).all():
        raise RuntimeError("scalar balloon step: bad shape or non-finite positions")
    if not gap <= ORACLE_GAP[0]:
        raise RuntimeError(f"scalar balloon step: gap {gap:.4f} to the direct step above "
                           f"{ORACLE_GAP[0]}")
    return {"max_disp": disp, "direct_max_disp": direct_disp, "oracle_gap": gap,
            "rejects": stats[0]["last_rejected"],
            "residuals": [r["residuals"] for r in newton], "mg_precompute_block_s": t_mg,
            "setup_s": ns.setup_s, "step_s": step_s}, ns


def check_scalar_kernels(ns, V, dev, errs, seed=8):
    """Phase 12: K1 against the plain version on the scalar balloon's
    3-expanded hierarchy refreshed at the rest pose (check_hierarchy, C =
    1, the path's)."""
    hier = ns.solver.refresh(ns.hessian_values(V.reshape(-1), balloon_defaults()["dt"]))
    n_cases = check_hierarchy(hier, "scalar balloon", dev, errs, np.random.default_rng(seed),
                              Cs=(1,))
    torch.cuda.synchronize(dev)
    log(f"phase 12: K1 {n_cases} kernel-vs-plain cases agree on every level and largest GS "
        f"color of the scalar balloon's hierarchy; max abs err {errs}")


def run_child(phase, state):
    """Run a timing phase in a process of its own (``python3 chip_smoke.py
    --child phase``, state pickled on its standard input), so that no
    earlier profiler session of this process shares its profiler: after a
    session of thousands of device events, later sessions of the same
    process were seen to record none or to read a kernel at half its
    time. Relays its log; returns its result (a JSON line tagged
    CHILD_RESULT)."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", phase],
                          input=pickle.dumps(state), capture_output=True, timeout=900)
    result = None
    for line in proc.stdout.decode().splitlines():
        if line.startswith(CHILD_RESULT):
            result = json.loads(line[len(CHILD_RESULT):])
        else:
            log(line)
    sys.stderr.write(proc.stderr.decode())
    if proc.returncode != 0 or result is None:
        raise RuntimeError(f"the {phase} process exited {proc.returncode}")
    return result


def child(phase) -> int:
    """The body of ``--child phase``: phase 11 ("mcf") or phase 9
    ("balloon", from the state on standard input)."""
    state = pickle.load(sys.stdin.buffer)
    dev = torch.device("cuda", 0)
    from surface_multigrid_code_torch import _build, mg_precompute
    from surface_multigrid_code_torch.utils.obj_io import read_obj
    from surface_multigrid_code_torch.utils.paths import mesh_path

    _build.load_library()
    if phase == "mcf":
        result = mcf_timings(dev)
    else:
        Vb, Fb = read_obj(mesh_path(BALLOON_MESH))
        result = balloon_timings(Vb, Fb, mg_precompute(Vb, Fb, verbose=False), state["pos"],
                                 state["qdot"], dev)
    print(CHILD_RESULT + json.dumps(result), flush=True)
    return 0


# ---------------------------------------------------------------- main

def ptxas_functions(report):
    """Per kernel of the build's ``-Xptxas -v`` report (lines): {mangled
    name: {"registers", "spill_stores", "spill_loads", "stack"}} in bytes."""
    import re

    out, name = {}, None
    for line in report:
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out



def main() -> int:
    depth = 7
    # phase 1: device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs only on a GPU")
    dev = torch.device("cuda", 0)
    card = card_line()
    log(card)
    log(f"phase 1: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    # phase 2: build
    from surface_multigrid_code_torch import _build
    from surface_multigrid_code_torch.config import SmootherType
    from surface_multigrid_code_torch.ops.spmv import fused_spmv, fused_spmv_plain

    t0 = time.perf_counter()
    path = _build.library_path()
    _build.load_library()
    log(f"phase 2: built {path.name} in {time.perf_counter() - t0:.2f} s")
    report = path.with_suffix(".log").read_text().splitlines()
    regs = [int(w.split()[0]) for line in report if "registers" in line
            for w in line.split("Used ")[1:]]
    spills = [line.strip() for line in report
              if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line]
    log(f"  ptxas: {len(regs)} kernels, at most {max(regs)} registers a thread; "
        f"spills: {spills or 'none'}")
    sign_regs = {name: rep for name, rep in ptxas_functions(report).items()
                 if "ns_sign_apply" in name}
    for name, rep in sign_regs.items():
        log(f"  ptxas {name}: {rep}")

    V, F, mg, A, M, t_mg = ico_system(depth)
    log(f"host: ico{depth} |V| {V.shape[0]} |F| {F.shape[0]}, mg_precompute {t_mg:.2f} s, "
        f"levels {[lv.V.shape[0] for lv in mg]}")

    # phase 3: kernels against their plain versions (K4 follows phase 7,
    # at the pose the balloon reaches)
    from surface_multigrid_code_torch import mg_precompute
    from surface_multigrid_code_torch.ops.bsr_spmv import fused_bsr_spmv, fused_bsr_spmv_plain
    from surface_multigrid_code_torch.ops.psd import ns_sign_apply, ns_sign_apply_plain
    from surface_multigrid_code_torch.utils.obj_io import read_obj
    from surface_multigrid_code_torch.utils.paths import mesh_path

    errs = check_kernels(A, mg, dev)
    Vb, Fb = read_obj(mesh_path(BALLOON_MESH))
    t0 = time.perf_counter()
    mg_b = mg_precompute(Vb, Fb, verbose=False)
    log(f"host: {BALLOON_MESH} |V| {Vb.shape[0]} |F| {Fb.shape[0]}, mg_precompute "
        f"{time.perf_counter() - t0:.2f} s, levels {[lv.V.shape[0] for lv in mg_b]}")
    errs.update(check_block_kernels(Vb, Fb, mg_b, dev))

    counters = {
        "spmv_fused": lambda: fused_spmv.launches - fused_spmv.planes_launches,
        "spmv_fused_planes": lambda: fused_spmv.planes_launches,
        "bsr_spmv": lambda: fused_bsr_spmv.launches,
        "ns_sign_apply": lambda: ns_sign_apply.launches,
    }
    plains = (fused_spmv_plain, fused_bsr_spmv_plain, ns_sign_apply_plain)

    def reset_counts():
        fused_spmv.launches = fused_spmv.planes_launches = 0
        fused_bsr_spmv.launches = ns_sign_apply.launches = 0
        for f in plains:
            f.calls = 0

    def read_counts(what, needed):
        torch.cuda.synchronize()
        got = {name: fn() for name, fn in counters.items()}
        calls = {f.__name__: f.calls for f in plains}
        log(f"{what}: launches {got}, plain calls {calls}")
        if any(calls.values()):
            raise RuntimeError(f"a plain version ran on the main path ({what})")
        for name in needed:
            if got[name] <= 0:
                raise RuntimeError(f"kernel {name} was not launched on the main path ({what})")
        return got

    # phases 4 and 5: the static solve and its other shapes, counted
    reset_counts()
    datas = main_path(depth, V, mg, A, M, dev)
    ogre = other_shapes(depth, V, A, M, datas[SmootherType.MULTICOLOR_GS], dev)
    static = read_counts("phases 4-5", ("spmv_fused", "spmv_fused_planes"))
    hub = max((lv.PT for lv in ogre.hier.levels[1:]), key=lambda S: int(S.indptr.diff().max()))
    n_hub = check_spmv(host_csr(hub), "ogre constrained PT (hub rows)", dev, errs,
                       np.random.default_rng(3))
    log(f"phase 3: K1/K2 {n_hub} kernel-vs-plain cases agree on the ogre PT with rows of "
        f"{int(hub.indptr.diff().max())} (lanes {fused_spmv.last_lanes}); "
        f"max abs err {errs}")

    # phase 6: timing
    vc = timings(depth, V, M, datas, dev)
    shapes = spmv_shapes(spmv_cases(datas[SmootherType.MULTICOLOR_GS].hier, ogre.hier, dev), dev)
    ker = {}
    for rec in shapes:
        if rec["shape"].startswith("A_0 axpby"):
            ker[kernel_name(rec["C"])] = {
                "kernel": rec["kernel_ms"], "plain": rec["plain_ms"],
                "kernel_call": rec["kernel_call_ms"], "plain_call": rec["plain_call_ms"],
                "bound": rec["bound_ms"], "bound_by": rec["bound_by"],
                "library": rec["library_ms"]}

    # phase 10: MCF (example 05), counted, then K1/K2 at its shapes; phase
    # 11 times it in a process of its own
    reset_counts()
    mcf, mcf_steppers = mcf_path(MCF_MESHES, dev)
    mcf_counts = read_counts("phase 10", ("spmv_fused_planes",))
    check_mcf_kernels(mcf_steppers, dev, errs)
    del mcf_steppers
    mcf_t, k2_mcf = run_child("mcf", {})
    shapes.append(k2_mcf)

    # phase 7: the balloon path, counted
    reset_counts()
    positions, stats, bsum = balloon_path(Vb, Fb, mg_b, dev)
    balloon = read_counts("phase 7", ("spmv_fused_planes", "bsr_spmv", "ns_sign_apply"))
    k4_errs, edge = check_sign_kernel(Vb, Fb, positions[-1], dev)
    errs.update(k4_errs)

    # phase 8: the balloon against the direct f64 oracle
    bsum["oracle_gap"], direct = balloon_oracle(Vb, Fb, positions, stats, dev)

    # phase 12: the balloon's scalar cross-check, counted, then K1 at its shapes
    reset_counts()
    scalar, ns = scalar_balloon(Vb, Fb, direct[0], dev)
    scalar["launches"] = read_counts("phase 12", ("spmv_fused", "ns_sign_apply"))
    check_scalar_kernels(ns, Vb, dev, errs)
    bsum["scalar"] = scalar
    del ns
    launches = {name: static[name] + mcf_counts[name] + balloon[name]
                + scalar["launches"][name] for name in counters}

    # phase 9: balloon and K3/K4 timing, in a process of its own
    bal, bker, bshapes, signs = run_child("balloon", {"pos": positions[-1],
                                                      "qdot": stats[-1]["qdot"]})
    ker.update(bker)

    log(card)
    log(json.dumps({"spmv_shapes": shapes, "mesh": f"icosphere({depth})", "dtype": "float32"}))
    log(json.dumps({"vcycle": vc, "mesh": f"icosphere({depth})", "dtype": "float32"}))
    log(json.dumps({"balloon": {**bsum, **bal}, "mesh": BALLOON_MESH, "dtype": "float32",
                    "launches": balloon}))
    log(json.dumps({"bsr_shapes": bshapes, "mesh": BALLOON_MESH, "dtype": "float32"}))
    log(json.dumps({"mcf": {label: {**rec, **mcf_t[label]} for label, rec in mcf.items()},
                    "dtype": "float32", "tol": MCF_TOL, "exact_gap": MCF_EXACT_GAP,
                    "launches": mcf_counts, "k2_color_shape": k2_mcf}))
    log(json.dumps({"sign_shapes": signs, "mesh": BALLOON_MESH, "ptxas": sign_regs,
                    "edge_eigs": {"eigenvalues": EDGE_EIGS, "least_eig_and_distance": edge}}))
    # ms / plain_ms / library_ms: device time per call (profiler, L2 warm:
    # back-to-back calls on inputs that fit in L2), at ico7 level-0 A (K1,
    # K2), the bunny_15K level-0 block Hessian (K3) and its 31,604 face
    # blocks (K4); call_ms / plain_call_ms: per call between CUDA events over
    # back-to-back calls, host included; bound_ms: from this run's shapes at
    # the H100's HBM and f32 peaks; launches: the counted paths together
    # (phases 4-5, 10, 7 and 12)
    sources = {**{n: (SOURCE, rep) for n, rep in KERNELS.items()}, **BLOCK_KERNELS}
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": ker[name]["kernel"], "plain_ms": ker[name]["plain"],
         "bound_ms": ker[name]["bound"], "bound_by": ker[name]["bound_by"],
         "library_ms": ker[name]["library"],
         "call_ms": ker[name]["kernel_call"], "plain_call_ms": ker[name]["plain_call"]}
        for name, (src, rep) in sources.items()
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        sys.exit(child(sys.argv[2]))
    sys.exit(main())
