#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``surface_multigrid_code_torch``) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA card, ``nvcc`` and ``g++``, no network and no JAX. It
builds the port's kernels from ``surface_multigrid_code_torch/csrc``, holds
each against its plain PyTorch version on the card, and drives the port's
paths through their public entry points:

- the static solve (SSP hierarchy -> precompute -> multigrid solve) at
  icosphere(7) size, then the constrained, multi-column and
  iterative-refinement solve shapes;
- mean-curvature flow (``MCFStepper``, example 05's recipe, f32): 20
  steps on bunny, each held to a host f64 flow, and 3 steps each on ogre
  and the midpoint-subdivided ogre, every step converged;
- the balloon (``models.balloon.run_balloon``, example 06 at its
  defaults) for 25 steps on bunny_15K, steps 0-18 held to the JAX
  package's recorded trajectory (``benchmarks/BALLOON_TRAJ_r5.json``),
  steps 0-2, 19 and 24 to the host sparse-LU oracle, and 1 step on the
  midpoint-subdivided bunny; one step of its scalar cross-check
  (``solver="scalar"``) on bunny_15K, and 3 steps of
  ``DeviceBalloonStepper`` on the same hierarchy (phase 17); 10 steps
  on bunny_15K subdivided twice, 252,834 vertices (phase 18, a child
  process), with the first Newton direction held in f64 on the host;
- point queries (``query.device``, K5): 10K, 100K and 1M points walked
  fine -> coarse on the icosphere(7) log of 161,280 records, held to the
  host walk and walked back; examples 07-09 on bunny against
  ``data/golden``; K5 held bit for bit to its plain version on that log
  and on a copy with one record's parameterisations NaN (the no-win
  path), both directions, f32 and f64, on a copy packed with every record
  above MIXED_MAX_RECORD vertices or faces left unpacked, and on the drum
  log (records of 303 vertices, beyond the packed walk's bytes), there
  also against the host walk; the public call at 1M by part;
- the bench (phase 19): ``python -m surface_multigrid_code_torch bench``
  in a process of its own (the icosphere(9) V-cycle, the icosphere(7)
  one, the bunny_15K balloon step, each with its check; on a machine
  without its cache it builds the ico9 SSP hierarchy, ~2 min, and saves
  it, so phase 20 loads it), and
  ``entry()``'s V-cycle; then K1/K2 at the bench's icosphere(9) shapes,
  held to the plain version and timed beside cuSPARSE (phase 20, a
  process of its own);
- the probes (``surface_multigrid_code_torch/probes/``, the counterparts
  of ``benchmarks/probes/``' Pallas probes; on no path of the port):
  phase 20's process also runs the K1 probes (``bf16_values``,
  ``staged_spmv``, ``band_spmv``) on ico9's A_0, then on ico7's, the band
  also on ico6's; phase 21, a process of its own, runs the K4 probes
  (``psd_precision`` on random, bunny_15K face and edge blocks,
  ``psd_stages`` at 31,608 and 505,664 blocks). Each probe's kernels are
  counted around its measurement and held to their plain versions, and
  each prints its JSON line;
- persistence and the CLI: the ico7 and bunny_15K device hierarchies
  through ``save_device_hierarchy`` / ``load_device_hierarchy`` (bitwise,
  the same solve), the host hierarchy npz, and ``cli.main`` running
  ``solve``, ``mcf`` and ``remesh``;
- the sharded paths (``parallel/``, phase 15) on a pool of 4 gloo ranks
  that share the card: the static solve at ico7 on 1, 2 and 4 ranks
  (Jacobi, Chebyshev; [n, 3] on 4), ``ShardedMCFStepper`` on ogre and the
  subdivided ogre (3 steps) and ``ShardedBalloonNewton`` on bunny_15K (the
  Newton direction at rest in f64 and f32, one f64 step), each held to its
  single-device counterpart, and K1/K2 held to the plain version at every
  rank's own operators;
- phase 16, on the same ranks: the band-segment backend
  (``WellHaloHierarchy``: the static ico7 solve on 2 and 4 ranks, Jacobi
  and Chebyshev, [n, 3] on 4; ``ShardedMCFStepper`` and
  ``ShardedBalloonNewton`` with ``backend="well"``, the sharded value
  refresh) and the GSPMD layout (``sharded_solve`` on 4), each held to
  its single-device counterpart and to phase 15's run, and K1/K2 held to
  the plain version at every rank's operators and G_l maps.

Each path runs with the kernels' launch counts set to 0 just before it
and read just after: it must have launched its kernels, and no plain
version; then K1/K2 are held to their plain versions at the path's own
shapes, and K5 to its plain version and the host walk. It times V-cycles, MCF and balloon steps and kernels against the
plain versions (the MCF and balloon timings each in a child process,
``--child mcf|balloon``, phase 18 in one, ``--child balloon-large``,
phase 20, ``--child ico9``, and phase 21, ``--child k4-probes``);
every profiler reading is held to CUDA-event times), and ends with

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}

Any failure raises, so the exit code is non-zero and that line is not
printed. Without a CUDA device it fails at once.

Three opt-in runs print their own records instead: ``--gloo-p2p`` (do
gloo's point-to-point operations take CUDA tensors), ``--nccl`` (on a
machine with 4 cards: phase 16's static ico7 solve with one rank per
card over NCCL) and ``--trajectory`` (the 25-step bunny_15K balloon in
f32, in f64 and with the direct f64 solver, against the JAX package's
record: phase 7's bars, about 11 min).
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# The bounds count as the package's bench counts (the H100's peaks).
from surface_multigrid_code_torch.utils.bounds import bound_ms, spmv_bytes
from surface_multigrid_code_torch.utils.timing import (
    cuda_ms,
    device_ms,
    in_turns,
    queued_ms,
    timed_turns,
)

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
QUERY_KERNEL = ("surface_multigrid_code_torch/csrc/query_walk.cu",
                "surface_multigrid_code_tpu/query/device.py:123 (XLA while_loop; no Pallas kernel)")
# The probes' kernels (probes/, phases 20-21): name: (source, the TPU
# kernel whose question it answers)
PROBE_KERNELS = {
    "ns_sign_apply_tc_tf32": ("surface_multigrid_code_torch/csrc/psd_probe.cu",
                              "benchmarks/probes/probe_psd_precision.py:30"),
    "ns_sign_apply_tc_3xtf32": ("surface_multigrid_code_torch/csrc/psd_probe.cu",
                                "benchmarks/probes/probe_psd_precision.py:30"),
    "ns_sign_copy": ("surface_multigrid_code_torch/csrc/psd.cu",
                     "benchmarks/probes/probe_psd_stages.py:19"),
    "spmv_bf16_values": ("surface_multigrid_code_torch/csrc/spmv_probe.cu",
                         "benchmarks/probes/probe_bf16_chain.py:34"),
    "spmv_staged": ("surface_multigrid_code_torch/csrc/spmv_probe.cu",
                    "benchmarks/probes/probe_dbuf.py:33"),
    "band_spmv_tc": ("surface_multigrid_code_torch/csrc/spmv_probe.cu",
                     "benchmarks/probes/probe_mxu_band.py:44"),
}
# Phase 20's K1 probes: (module, orders of the operators, label); ico9's is
# phase 20's own A_0, ico7's and ico6's come from bench.ico_operators
K1_PROBES = (("bf16_values", (9, 7), "ico{k} A_0 axpby"),
             ("staged_spmv", (9, 7), "ico{k} A_0 axpby"),
             ("band_spmv", (9, 7, 6), "ico{k} A_0"))
# Phase 21: psd_precision's edge set, 9x9 blocks with every eigenvalue in
# EDGE_EIGS (as given, no scaling)
PROBE_EDGE_BLOCKS = 4096
# Balloon: example 06 at the run_balloon defaults; the oracle gaps allowed
# between the multigrid and the direct f64 step (max|disp|, relative): the
# tol-2e-1 multigrid direction is least accurate in the first step.
BALLOON_MESH = "bunny_15K_init"
BALLOON_STEPS = 3
ORACLE_GAP = (0.1, 0.05, 0.05)
# Phase 7 runs the balloon as long as the JAX package's recorded
# trajectory (benchmarks/BALLOON_TRAJ_r5.json, bunny_15K at pressure 1e6,
# taken on a TPU v5e) and holds the max|disp| of steps 0 to TRAJ_HELD - 1
# to it: relative gap at most TRAJ_GAP[k], the last entry from that step
# on. Against the direct f64 step from the same state the record's
# multigrid read 0.041 / 0.021 and then <= 0.0014, the port's 0.046 /
# 0.004 / 0.0002, on either side of the direct step. On the H100 the
# direct f64 trajectory from rest (host splu, the reference's direct
# solver) left the record by 0.0307 at step 9 and by 0.0348-0.1585 at
# steps 19-24, while the port's multigrid stayed within 0.0028 of it from
# step 2 on: hence 0.04 from step 2, and steps LATE_ORACLE_STEPS (past the
# record's reach) held instead to the direct f64 step from the port's own
# state, within LATE_ORACLE_GAP (read: 1.6e-8 to 3.0e-7). Phase 8's direct
# step 0 is held to the record's within TRAJ_DIRECT_GAP. The readings:
# ``python3 chip_smoke.py --trajectory``.
TRAJ_RECORD = "benchmarks/BALLOON_TRAJ_r5.json"
TRAJ_STEPS = 25
TRAJ_HELD = 19
TRAJ_GAP = (0.10, 0.10, 0.04)
TRAJ_DIRECT_GAP = 0.01
LATE_ORACLE_STEPS = (19, 24)
LATE_ORACLE_GAP = 1e-3
# Phase 17 (DeviceBalloonStepper on phase 12's block hierarchy): steps,
# steps 1-2's max|disp| against phase 7's BSR steps (relative), step 0's
# positions against phase 12's scalar step (times its max|disp|)
DEVICE_STEPS = 3
DEVICE_BSR_GAP = 0.05
DEVICE_SCALAR_GAP = 0.05
# Phase 18: bunny_15K midpoint-subdivided twice, run_balloon for
# LARGE_STEPS steps; step 0's first Newton direction held on the host in
# f64 to mg_tolerance + LARGE_RESID_REL ||g|| when its solve converged,
# and always to the card's last recorded residual within LARGE_RESID_AGREE
# relative (the loop records each residual before its cycle, so after
# max_cycles the last entry precedes the last cycle: the card read 0.512
# there and the host 0.498 after it)
LARGE_SIZE = (252_834, 505_664)
LARGE_STEPS = 10
LARGE_RESID_REL = 1e-3
LARGE_RESID_AGREE = 0.1
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
# The profiler's check of a step (a kernel's is utils.timing's
# PROFILER_BAND): a profiled step must have recorded at least
# STEP_RECORDED of each hand kernel's counted launches.
STEP_RECORDED = 0.9
CHILD_RESULT = "child result: "
# Relative tolerance of the plain f32 ico solves. Their f32 residual floor
# is about 1.5e-5 ||b||: ||b - Az|| is a strongly cancelling difference
# (|A||z| is ~1000x the residual scale). 1e-4 ||b|| sits above that floor;
# tighter tolerances are the refinement path's, run in phase 5.
REL_TOL = 1e-4
# Queries (phase 13): the log of benchmarks/query_bench.py:33-34,
# icosphere(QUERY_DEPTH) decimated with dec_type 1 to F/64 faces (161,280
# records), walked fine -> coarse at QUERY_COUNTS random points. QUERY_BAR
# is tests/test_query_device.py:47-48 (the position error against the host
# walk: median below 1e-6, at least 99% within 1e-3); ROUND_TRIP_BAR
# :96-105 (f2c then c2f back to the start, relative to the mesh scale).
# QUERY_LIMITS[(against, dtype)] holds K5 at QUERY_CHECK_N queries, both
# directions, against its plain version and (f64) the host walk: (the
# largest position error, the least share of queries on the same vertex
# and face ids), 2.5-3x the worst reading of the first H100 run: K5 and
# the plain version round the same operations in the same order and
# agreed bit for bit (0, 1.0) in f32 and f64; against the host walk, which
# the compiler may contract into FMAs, the f64 K5 read 9.23e-16 and 1.0.
QUERY_DEPTH = 7
QUERY_COUNTS = (10_000, 100_000, 1_000_000)
QUERY_CHECK_N = 100_000
QUERY_BAR = (1e-6, 1e-3, 0.99)
ROUND_TRIP_BAR = (5e-3, 5e-2, 0.99)
QUERY_LIMITS = {("plain", torch.float32): (0.0, 1.0), ("plain", torch.float64): (0.0, 1.0),
                ("host", torch.float64): (2.5e-15, 1.0)}
# The no-win log's NaN record, counted from the end: late, so that ~0.1%
# of random queries walk through it, with records after it to go on to.
NO_WIN_BACK = 2000
# Phase 13 also packs the log with records of more than MIXED_MAX_RECORD
# vertices or faces left unpacked (about half of them), so that K5 steps
# between packed and unpacked records all the time; and walks the drum
# (``utils.synthetic.drum``, DRUM_N = 300, qslim to 600 faces: records of up
# to 303 vertices, unpacked at the packed walk's own limit). Against the host walk
# the drum's walks are held to DRUM_LIMITS[dtype] (the largest position
# error, the drum's radius being 1; the least share of queries on the
# host's ids), the bars of tests/test_torch_query.py: in float32 a few
# walks take another face near ties on the drum's sliver fans; in float64
# the ids are the host's, and the positions differ by the host's rounding
# on those slivers (up to ~3e-12 on the CPU).
MIXED_MAX_RECORD = 9
DRUM_N = 300
DRUM_FACES = 600
DRUM_LIMITS = {torch.float32: (1e-2, 0.98), torch.float64: (1e-9, 1.0)}
# Phases 19-20: the bench (its own checks decide its exit code); entry()'s
# V-cycle against the same cycle on the plain versions, relative to max|z|.
BENCH_TIMEOUT = 900
ENTRY_TOL = 1e-4
# Examples 08 / 09 as (tag, dec_type, seed, subdivisions), bunny to 500 faces
EXAMPLES = (("ex08", 1, None, 2), ("ex09", 0, 10, 3))


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


def chain_ms(chain, ctx):
    """ms per V-cycle of chain() (10 cycles) under the context ctx (the
    kernels, or plain_spmv), between CUDA events over 3 chains."""
    with ctx():
        return cuda_ms(chain, 3) / 10


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

        raw = in_turns({"plain": plain_spmv, "kernel": contextlib.nullcontext},
                       ("plain", "kernel", "kernel", "plain"), lambda ctx: chain_ms(chain, ctx))
        wall = {k: float(np.median(v)) for k, v in raw.items()}
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


def spmv_shapes(cases, dev, reps=20, phase="phase 6"):
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
        log(f"{phase}: {kernel_name(C)} {label}: {rec['rows']} rows, {rec['nnz']} nnz "
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


def trajectory_record() -> dict:
    """The JAX package's recorded 25-step bunny_15K trajectory (TRAJ_RECORD)."""
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), TRAJ_RECORD)) as f:
        return json.load(f)


def balloon_path(V, F, mg, dev):
    """Phase 7: run_balloon at its defaults on bunny_15K for TRAJ_STEPS
    steps, each finite with no rejected Newton iteration, the max|disp| of
    the first TRAJ_HELD within TRAJ_GAP of the recorded trajectory (the
    later ones are held by phase 8), and on the midpoint-subdivided bunny
    for 1 step, f32 on the card. Returns (positions, stats, summary)."""
    from surface_multigrid_code_torch import mg_precompute
    from surface_multigrid_code_torch.models.balloon import run_balloon
    from surface_multigrid_code_torch.utils.synthetic import midpoint_subdivide

    record = trajectory_record()["max_disp_per_step"]
    stats, positions, walls = [], [], []
    it = run_balloon(V, F, n_steps=TRAJ_STEPS, mg=mg, device=dev, stats=stats, verbose=False)
    t0 = time.perf_counter()
    for pos in it:
        positions.append(pos)
        walls.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
    if len(stats) != TRAJ_STEPS or not all(isinstance(s["last_rejected"], int) for s in stats):
        raise RuntimeError("last_rejected was not recorded for every step")
    gaps, fails = [], []
    for k, (pos, st) in enumerate(zip(positions, stats)):
        if pos.shape != V.shape or not np.isfinite(pos).all() or not np.isfinite(st["qdot"]).all():
            raise RuntimeError(f"balloon step {k}: bad shape or non-finite state")
        disp = float(np.abs(pos - V).max())
        gap = abs(disp - record[k]) / record[k]
        bar = TRAJ_GAP[min(k, len(TRAJ_GAP) - 1)] if k < TRAJ_HELD else float("inf")
        gaps.append(gap)
        log(f"phase 7: bunny_15K step {k}: max|disp| {disp:.6f}, recorded {record[k]:.5f}, "
            f"relative gap {gap:.4f} (limit {bar if k < TRAJ_HELD else 'none: phase 8'}), "
            f"rejects {st['last_rejected']}, residuals "
            f"per Newton solve {[r['residuals'] for r in st['newton']]}, unconverged solves "
            f"{sum(not r['converged'] for r in st['newton'])}, alphas "
            f"{sorted(set(r['alpha'] for r in st['newton']))}, wall {walls[k]:.3f} s")
        if st["last_rejected"] or not gap <= bar:
            fails.append(f"step {k}: {st['last_rejected']} rejects, gap {gap:.4f} (limit {bar})")
    if fails:
        raise RuntimeError(f"phase 7: the trajectory misses the record: {fails}")

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
        "record_gap": gaps,
        "first_step_wall_s": walls[0],
        "step_walls_s": walls,
        "subdiv": {"nv": int(V2.shape[0]), "nf": int(F2.shape[0]),
                   "max_disp": float(np.abs(pos2 - V2).max()),
                   "rejects": stats2[0]["last_rejected"], "wall_s": wall2},
    }
    return positions, stats, summary


def balloon_oracle(V, F, positions, stats, dev):
    """Phase 8: the max|disp| of the first BALLOON_STEPS steps and of steps
    LATE_ORACLE_STEPS against the direct f64 step (host splu,
    psd_project=True) run from the same state (within ORACLE_GAP[k] and
    LATE_ORACLE_GAP); step 0 (from rest, as the record's) also against the
    recorded direct step within TRAJ_DIRECT_GAP. Returns (the first steps'
    gaps, their direct max|disp|, step 0's gap to the record, the late
    steps' gaps)."""
    from surface_multigrid_code_torch.models.balloon import (
        implicit_euler_balloon_direct,
        inflation_force,
    )

    d = balloon_defaults()
    shell, M = balloon_shell(V, F, dev)
    gaps, direct, late = [], [], []
    for k in (*range(BALLOON_STEPS), *LATE_ORACLE_STEPS):
        t0 = time.perf_counter()
        cur, qd = (V, np.zeros(V.size)) if k == 0 else (positions[k - 1], stats[k - 1]["qdot"])
        fExt = inflation_force(cur, F, d["pressure"])
        pd, _ = implicit_euler_balloon_direct(shell, M, cur, qd, fExt, d["dt"],
                                              n_newton=d["n_newton"], verbose=False,
                                              psd_project=True)
        mg_disp = float(np.abs(positions[k] - V).max())
        d_disp = float(np.abs(pd - V).max())
        gap = abs(mg_disp - d_disp) / d_disp
        bar = ORACLE_GAP[k] if k < BALLOON_STEPS else LATE_ORACLE_GAP
        if k < BALLOON_STEPS:
            gaps.append(gap)
            direct.append(d_disp)
        else:
            late.append(gap)
        log(f"phase 8: step {k}: max|disp| multigrid {mg_disp:.6f}, direct f64 "
            f"{d_disp:.6f}, relative gap {gap:.4g} (limit {bar}); "
            f"{time.perf_counter() - t0:.1f} s")
        if not gap <= bar:
            raise RuntimeError(f"balloon step {k}: gap {gap:.4g} to the direct step above {bar}")
    rec0 = trajectory_record()["direct_max_disp_first_steps"][0]
    gap0 = abs(direct[0] - rec0) / rec0
    log(f"phase 8: direct f64 step 0 max|disp| {direct[0]:.6f}, recorded {rec0:.5f} (the JAX "
        f"package's), relative gap {gap0:.4f} (limit {TRAJ_DIRECT_GAP})")
    if not gap0 <= TRAJ_DIRECT_GAP:
        raise RuntimeError(f"direct step 0: gap {gap0:.4f} to the record above {TRAJ_DIRECT_GAP}")
    return gaps, direct, gap0, late


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


def bsr_shapes(hier, dev, reps=20, phase="phase 9"):
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
            log(f"{phase}: bsr_spmv level {lv} {epi}: {A.n_rows} rows, {A.nnz} blocks (max row "
                f"{rec['max_row']}), lanes {lanes} of {A.lanes}; bound {1e3 * bms:.3f} us "
                f"({nbytes} B); device kernel {[1e3 * t for t in dev_ms['kernel']]} us, "
                f"cuSPARSE bsrmv {[1e3 * t for t in dev_ms['library']]} us"
                + (f", plain {[1e3 * t for t in dev_ms['plain']]} us" if "plain" in fns else "")
                + f"; back to back {[1e3 * t for t in burst['kernel']]} us"
                + f"; per call kernel {1e3 * rec['kernel_call_ms']:.2f} us, cuSPARSE "
                f"{1e3 * rec['library_call_ms']:.2f} us")
    return out


def sign_shapes(X9, dev, reps=20, phase="phase 9"):
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
        log(f"{phase}: ns_sign_apply {k} ({m} blocks): bound "
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
    ({label: record}, {label: (V, stepper)}, {label: (V, F, mg)})."""
    from surface_multigrid_code_torch import MCFStepper
    from surface_multigrid_code_torch.utils.mesh import doublearea

    out, steppers, hosts = {}, {}, {}
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
        hosts[label] = (V, F, mg)
    return out, steppers, hosts


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
    step's BalloonNewtonSolver, the block hierarchy, the positions)."""
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
            "setup_s": ns.setup_s, "step_s": step_s}, ns, mg, pos


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


def host_syncs(fn):
    """fn() with torch's sync debug mode at "warn"; returns (its result,
    the number of synchronizing operations it warned about)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def device_stepper(V, F, mg, direct_disp, bsr_positions, scalar_pos, dev):
    """Phase 17: DeviceBalloonStepper on bunny_15K at example 06's defaults,
    f32 on the card, on phase 12's block hierarchy ``mg`` with phase 12's
    smoother (multicolor GS), DEVICE_STEPS steps from rest: every step
    finite with no rejected Newton iteration; step 0's max|disp| within
    ORACLE_GAP[0] of phase 8's direct f64 step from rest; its positions
    within DEVICE_SCALAR_GAP max|disp| of phase 12's host-orchestrated
    step (``scalar_pos``); steps 1-2's max|disp| within DEVICE_BSR_GAP of
    phase 7's. Times the stepper's set-up and each step (host clock, closed
    by a device sync). Then one step from rest with the class's default
    smoother (Chebyshev, its bounds from the refresh), held like step 0 to
    the direct step within ORACLE_GAP[0] with no reject. Returns (its
    record, the multicolor-GS stepper)."""
    from surface_multigrid_code_torch.config import SmootherType, SolveConfig
    from surface_multigrid_code_torch.models.balloon import DeviceBalloonStepper, inflation_force

    d = balloon_defaults()
    shell, M = balloon_shell(V, F, dev)
    t0 = time.perf_counter()
    stepper = DeviceBalloonStepper(shell, M, mg, d["dt"], mg_tolerance=d["mg_tolerance"],
                                   n_newton=d["n_newton"],
                                   cfg=SolveConfig(smoother=SmootherType.MULTICOLOR_GS))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cur, qd = V.copy(), np.zeros(V.size)
    disps, walls, newton, fails = [], [], [], []
    for k in range(DEVICE_STEPS):
        fExt = inflation_force(cur, F, d["pressure"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cur, qd = stepper.step(cur, qd, fExt)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if cur.shape != V.shape or not np.isfinite(cur).all() or not np.isfinite(qd).all():
            raise RuntimeError(f"phase 17 step {k}: bad shape or non-finite state")
        disps.append(float(np.abs(cur - V).max()))
        newton.append([r["residuals"] for r in stepper.last_newton])
        if k == 0:
            ref, bar = direct_disp, ORACLE_GAP[0]
            pos_gap = float(np.abs(cur - scalar_pos).max() / np.abs(scalar_pos - V).max())
            if not pos_gap <= DEVICE_SCALAR_GAP:
                fails.append(f"step 0 positions {pos_gap:.4f} max|disp| off phase 12's "
                             f"(limit {DEVICE_SCALAR_GAP})")
        else:
            ref, bar = float(np.abs(bsr_positions[k] - V).max()), DEVICE_BSR_GAP
        gap = abs(disps[k] - ref) / ref
        log(f"phase 17: step {k}: max|disp| {disps[k]:.6f}, against "
            f"{'the direct f64 step' if k == 0 else 'phase 7'} {ref:.6f}: relative gap "
            f"{gap:.4f} (limit {bar}); rejects {stepper.last_rejected}, residuals per Newton "
            f"solve {newton[-1]}, wall {walls[-1]:.3f} s")
        if stepper.last_rejected or not gap <= bar:
            fails.append(f"step {k}: {stepper.last_rejected} rejects, gap {gap:.4f} (limit {bar})")
    step_s = float(np.median(walls[1:]))
    log(f"phase 17: DeviceBalloonStepper bunny_15K ({3 * V.shape[0]} DOFs, GS colors "
        f"{[len(g) for g in stepper.solver.groups]}): set-up {setup_s:.3f} s, step walls "
        f"{walls} s (median of steps 1-{DEVICE_STEPS - 1}: {step_s:.3f} s); step 0 positions "
        f"{pos_gap:.4f} max|disp| from phase 12's")

    # the default smoother, one step from rest
    t0 = time.perf_counter()
    cheb = DeviceBalloonStepper(shell, M, mg, d["dt"], mg_tolerance=d["mg_tolerance"],
                                n_newton=d["n_newton"])
    torch.cuda.synchronize()
    cheb_setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    cur, qd = cheb.step(V.copy(), np.zeros(V.size), inflation_force(V, F, d["pressure"]))
    torch.cuda.synchronize()
    cheb_wall = time.perf_counter() - t0
    if not np.isfinite(cur).all() or not np.isfinite(qd).all():
        raise RuntimeError("phase 17 Chebyshev step: non-finite state")
    cheb_disp = float(np.abs(cur - V).max())
    cheb_gap = abs(cheb_disp - direct_disp) / direct_disp
    cheb_res = [r["residuals"] for r in cheb.last_newton]
    log(f"phase 17: DeviceBalloonStepper default smoother ({cheb.cfg.smoother.value}) "
        f"step 0: max|disp| {cheb_disp:.6f}, against the direct f64 step {direct_disp:.6f}: "
        f"relative gap {cheb_gap:.4f} (limit {ORACLE_GAP[0]}); rejects {cheb.last_rejected}, "
        f"residuals per Newton solve {cheb_res}; set-up {cheb_setup:.3f} s, wall "
        f"{cheb_wall:.3f} s")
    if cheb.last_rejected or not cheb_gap <= ORACLE_GAP[0]:
        fails.append(f"Chebyshev step 0: {cheb.last_rejected} rejects, gap {cheb_gap:.4f} "
                     f"(limit {ORACLE_GAP[0]})")
    if fails:
        raise RuntimeError(f"phase 17: {fails}")
    return {"max_disp": disps, "step_walls_s": walls, "step_s": step_s, "setup_s": setup_s,
            "scalar_pos_gap": pos_gap, "residuals": newton,
            "chebyshev": {"max_disp": cheb_disp, "oracle_gap": cheb_gap,
                          "rejects": cheb.last_rejected, "residuals": cheb_res,
                          "setup_s": cheb_setup, "step_s": cheb_wall}}, stepper


def step_syncs(stepper, V, F, mg):
    """Phase 17: the host syncs of one DeviceBalloonStepper step and of one
    implicit_euler_mg_balloon step with the stepper's own newton_solver,
    both from rest (torch's sync debug mode, host_syncs)."""
    from surface_multigrid_code_torch.models.balloon import (
        implicit_euler_mg_balloon,
        inflation_force,
        lumped_mass_matrix,
    )

    d = balloon_defaults()
    fExt = inflation_force(V, F, d["pressure"])
    q0 = np.zeros(V.size)
    _, n_dev = host_syncs(lambda: stepper.step(V.copy(), q0, fExt))
    cycles = sum(r["residuals"] for r in stepper.last_newton)
    M = 1000.0 * lumped_mass_matrix(V, F)
    _, n_host = host_syncs(lambda: implicit_euler_mg_balloon(
        stepper.shell, M, V.copy(), q0, fExt, d["dt"], mg,
        mg_tolerance=d["mg_tolerance"], n_newton=d["n_newton"],
        newton_solver=stepper.newton_solver, verbose=False))
    log(f"phase 17: host syncs a step from rest: DeviceBalloonStepper {n_dev} ({cycles} "
        f"residuals recorded over {d['n_newton']} Newton solves), implicit_euler_mg_balloon "
        f"{n_host}")
    return {"device_stepper": n_dev, "residuals": cycles, "implicit_euler_mg_balloon": n_host}


def large_balloon(dev):
    """Phase 18 (a process of its own, see run_child): bunny_15K
    midpoint-subdivided twice (LARGE_SIZE), mg_precompute, and
    run_balloon(solver="bsr") at the defaults, f32, for LARGE_STEPS steps,
    its launches counted: every step finite, max|disp| growing; rejects
    recorded. Then a BsrBalloonStepper built as run_balloon builds it
    (its set-up timed) for the rest. Step 0's first Newton system (the
    Hessian at rest, g = -dt (G + fExt)) solved on the card by
    bsr_solve_loop as the stepper solves it, and held on the host in f64:
    ||g - H dx|| within LARGE_RESID_AGREE of the card's last recorded
    residual, and at most mg_tolerance + LARGE_RESID_REL ||g|| when the
    solve converged. One step timed by phase, one profiled (idle share),
    the peak device memory of the run. K3 against its plain version on
    every level of the hierarchy refreshed at the last state, K2 on its
    P/PT at C = 3 and K4 on its face blocks, f32 and f64 at TOL; then K3
    at level 0 (bsr_shapes) and K4 at the face count (sign_shapes) timed.
    Returns its record."""
    import types

    import scipy.sparse as sp

    from surface_multigrid_code_torch import mg_precompute
    from surface_multigrid_code_torch.models import balloon
    from surface_multigrid_code_torch.ops.bsr_spmv import fused_bsr_spmv
    from surface_multigrid_code_torch.ops.psd import ns_sign_apply, ns_sign_apply_plain
    from surface_multigrid_code_torch.ops.spmv import fused_spmv
    from surface_multigrid_code_torch.solver.bsr import bsr_solve_loop
    from surface_multigrid_code_torch.utils.obj_io import read_obj
    from surface_multigrid_code_torch.utils.paths import mesh_path
    from surface_multigrid_code_torch.utils.synthetic import midpoint_subdivide

    t_phase = time.perf_counter()
    V, F = read_obj(mesh_path(BALLOON_MESH))
    for _ in range(2):
        V, F, _ = midpoint_subdivide(V, F)
    if (V.shape[0], F.shape[0]) != LARGE_SIZE:
        raise RuntimeError(f"phase 18: subdivided bunny has {V.shape[0]} V, {F.shape[0]} F, "
                           f"not {LARGE_SIZE}")
    t0 = time.perf_counter()
    mg = mg_precompute(V, F, verbose=False)
    t_mg = time.perf_counter() - t0
    log(f"phase 18: |V| {V.shape[0]} |F| {F.shape[0]} ({3 * V.shape[0]} DOFs), mg_precompute "
        f"{t_mg:.2f} s, levels {[lv.V.shape[0] for lv in mg]}")

    torch.cuda.reset_peak_memory_stats()
    stats, positions, walls = [], [], []
    reset_counts()
    it = balloon.run_balloon(V, F, n_steps=LARGE_STEPS, mg=mg, device=dev, stats=stats,
                             verbose=False)
    t0 = time.perf_counter()
    for pos in it:
        positions.append(pos)
        walls.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
    del it
    launches = read_counts("phase 18", ("spmv_fused_planes", "bsr_spmv", "ns_sign_apply"))
    peak = torch.cuda.max_memory_allocated()
    disps = []
    for k, (pos, st) in enumerate(zip(positions, stats)):
        if not np.isfinite(pos).all() or not np.isfinite(st["qdot"]).all():
            raise RuntimeError(f"phase 18 step {k}: non-finite state")
        disps.append(float(np.abs(pos - V).max()))
        log(f"phase 18: step {k}: max|disp| {disps[k]:.6f}, rejects {st['last_rejected']}, "
            f"residuals per Newton solve {[r['residuals'] for r in st['newton']]}, unconverged "
            f"solves {sum(not r['converged'] for r in st['newton'])}, alphas "
            f"{sorted(set(r['alpha'] for r in st['newton']))}, wall {walls[k]:.3f} s")
    if len(disps) != LARGE_STEPS or not all(b > a for a, b in zip(disps, disps[1:])):
        raise RuntimeError(f"phase 18: max|disp| does not grow step by step: {disps}")

    d = balloon_defaults()
    shell, M = balloon_shell(V, F, dev)
    t0 = time.perf_counter()
    stepper = balloon.BsrBalloonStepper(shell, M, mg, d["dt"], mg_tolerance=d["mg_tolerance"],
                                        n_newton=d["n_newton"], dtype=d["dtype"],
                                        coarsest_nv=d["coarsest_nv"])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # step 0's first Newton system, solved on the card and held in f64 on the host
    nv = V.shape[0]
    vals = block_hessian(stepper, V, dev)
    g = torch.as_tensor(-d["dt"] * (shell.gradient(V.reshape(-1))
                                    + balloon.inflation_force(V, F, d["pressure"]).reshape(-1)),
                        device=dev).to(stepper.dtype)
    dx, r_his, k = bsr_solve_loop(stepper.solver.refresh(vals), g.reshape(nv, 3),
                                  torch.zeros((nv, 3), dtype=stepper.dtype, device=dev),
                                  stepper.mg_tolerance, stepper.max_cycles, stepper.cfg)
    pat = stepper.pattern
    H = sp.bsr_matrix((vals.double().cpu().numpy(), pat.indices, pat.indptr),
                      shape=(3 * nv, 3 * nv))
    g64 = g.double().cpu().numpy()
    r_his = r_his[:k].double().cpu().tolist()
    resid = float(np.linalg.norm(g64 - H @ dx.reshape(-1).double().cpu().numpy()))
    g_norm = float(np.linalg.norm(g64))
    converged = k < stepper.max_cycles or r_his[-1] < stepper.mg_tolerance
    bar = stepper.mg_tolerance + LARGE_RESID_REL * g_norm
    agree = abs(resid - r_his[-1]) / r_his[-1]
    path_k = stats[0]["newton"][0]["residuals"]
    log(f"phase 18: step 0 Newton 0: ||g|| {g_norm:.6e}, the card's residuals {r_his} "
        f"({k} recorded; run_balloon's step 0 recorded {path_k}), converged {converged}; f64 "
        f"on the host ||g - H dx|| {resid:.6e}: {agree:.4f} relative from the card's last "
        f"(limit {LARGE_RESID_AGREE}), limit {bar:.6e} when converged")
    if not agree <= LARGE_RESID_AGREE:
        raise RuntimeError(f"phase 18: the first direction's f64 residual {resid:.3e} is "
                           f"{agree:.3f} relative off the card's {r_his[-1]:.3e}")
    if converged and not resid <= bar:
        raise RuntimeError(f"phase 18: the first direction's f64 residual {resid:.3e} > {bar:.3e}")
    del vals, H, dx

    # one step by phase and one profiled, from the last state
    cur, qd = positions[-1], stats[-1]["qdot"]
    fExt = balloon.inflation_force(cur, F, d["pressure"])
    stepper.timed = True
    stepper.step(cur, qd, fExt)
    stepper.timed = False
    phase_ms = {p: 1e3 * sum(r[p] for r in stepper.last_newton) for p in balloon.PHASES}
    prof = checked_step(lambda: stepper.step(cur, qd, fExt),
                        {"spmv_fused_kernel": lambda: fused_spmv.launches,
                         "bsr_spmv_kernel": lambda: fused_bsr_spmv.launches,
                         "ns_sign_apply": lambda: ns_sign_apply.launches},
                        "phase 18 balloon step")
    idle = 1.0 - prof["ms"] / prof["wall_ms"]
    log(f"phase 18: step {LARGE_STEPS} by phase (ms, a sync per phase) {phase_ms}; profiled "
        f"step: device busy {prof['ms']:.3f} ms over {prof['events']:.0f} device ops in "
        f"{prof['wall_ms']:.3f} ms, idle share {idle:.4f}; peak device memory of the "
        f"{LARGE_STEPS} steps {peak / 2**30:.3f} GiB; stepper set-up {setup_s:.2f} s")

    # K3, K2 and K4 against their plain versions at this size, then timed
    hier = stepper.solver.refresh(block_hessian(stepper, cur, dev))
    x9 = torch.as_tensor(np.asarray(cur)[F].reshape(-1, 9), device=dev, dtype=stepper.dtype)
    X = scaled_blocks(shell.face_hess(x9, stepper.abars))
    errs, n_cases = {}, 0
    rng = np.random.default_rng(9)
    for lv, level in enumerate(hier.levels):
        n_cases += check_bsr(level.A, f"phase 18 level {lv}", dev, errs, rng)[0]
        if lv:
            for name, S in (("P", level.P), ("PT", level.PT)):
                n_cases += check_spmv(host_csr(S), f"phase 18 {name}_{lv}", dev, errs, rng,
                                      Cs=(3,))
    for Xd in (X, X.double()):
        _compare(ns_sign_apply(Xd), ns_sign_apply_plain(Xd), Xd.dtype,
                 f"K4 phase 18 {Xd.shape[0]} face Hessians 9x9 {Xd.dtype}", errs,
                 "ns_sign_apply")
        n_cases += 1
    torch.cuda.synchronize(dev)
    log(f"phase 18: {n_cases} kernel-vs-plain cases agree: K3 on all {hier.n_levels} levels "
        f"({[lv.A.n_rows for lv in hier.levels]} block rows, "
        f"{[lv.A.nnz for lv in hier.levels]} blocks), K2 on every P/PT at C = 3, K4 on "
        f"{X.shape[0]} face blocks; max abs err {errs}")
    bshapes = bsr_shapes(types.SimpleNamespace(levels=hier.levels[:2]), dev, phase="phase 18")
    signs = sign_shapes(X, dev, phase="phase 18")
    wall = time.perf_counter() - t_phase
    log(f"phase 18: {wall:.1f} s")
    return {"nv": int(nv), "nf": int(F.shape[0]), "levels": [int(lv.V.shape[0]) for lv in mg],
            "mg_precompute_s": t_mg, "setup_s": setup_s, "max_disp": disps,
            "rejects": [s["last_rejected"] for s in stats],
            "residuals": [[r["residuals"] for r in s["newton"]] for s in stats],
            "step_walls_s": walls, "phase_ms": phase_ms, "device_ms": prof["ms"],
            "device_ops": prof["events"], "profiled_step_ms": prof["wall_ms"],
            "idle_share": idle, "peak_bytes": int(peak),
            "first_direction": {"g_norm": g_norm, "resid_f64": resid, "limit": bar,
                                "agree": agree, "converged": bool(converged), "r_his": r_his,
                                "path_residuals": path_k},
            "launches": launches, "errs": errs, "kernel_cases": n_cases,
            "bsr_shapes": bshapes, "sign_shapes": signs, "wall_s": wall}


def kernel_counters():
    """{kernel: () -> its wrapper's launch count} of every hand kernel."""
    from surface_multigrid_code_torch.ops.bsr_spmv import fused_bsr_spmv
    from surface_multigrid_code_torch.ops.psd import ns_sign_apply
    from surface_multigrid_code_torch.ops.spmv import fused_spmv
    from surface_multigrid_code_torch.query.device import query_walk

    return {
        "spmv_fused": lambda: fused_spmv.launches - fused_spmv.planes_launches,
        "spmv_fused_planes": lambda: fused_spmv.planes_launches,
        "bsr_spmv": lambda: fused_bsr_spmv.launches,
        "ns_sign_apply": lambda: ns_sign_apply.launches,
        "query_walk": lambda: query_walk.launches,
    }


def plain_versions():
    from surface_multigrid_code_torch.ops.bsr_spmv import fused_bsr_spmv_plain
    from surface_multigrid_code_torch.ops.psd import ns_sign_apply_plain
    from surface_multigrid_code_torch.ops.spmv import fused_spmv_plain
    from surface_multigrid_code_torch.query.device import query_walk_plain

    return (fused_spmv_plain, fused_bsr_spmv_plain, ns_sign_apply_plain, query_walk_plain)


def reset_counts():
    """Set every kernel's launch count and every plain version's call count to 0."""
    from surface_multigrid_code_torch.ops.bsr_spmv import fused_bsr_spmv
    from surface_multigrid_code_torch.ops.psd import ns_sign_apply
    from surface_multigrid_code_torch.ops.spmv import fused_spmv
    from surface_multigrid_code_torch.query.device import query_walk

    fused_spmv.launches = fused_spmv.planes_launches = 0
    fused_bsr_spmv.launches = ns_sign_apply.launches = query_walk.launches = 0
    for f in plain_versions():
        f.calls = 0


def read_counts(what, needed):
    """The launches since reset_counts; fails if a plain version ran or a
    kernel of ``needed`` was not launched."""
    torch.cuda.synchronize()
    got = {name: fn() for name, fn in kernel_counters().items()}
    calls = {f.__name__: f.calls for f in plain_versions()}
    log(f"{what}: launches {got}, plain calls {calls}")
    if any(calls.values()):
        raise RuntimeError(f"a plain version ran on the main path ({what})")
    for name in needed:
        if got[name] <= 0:
            raise RuntimeError(f"kernel {name} was not launched on the main path ({what})")
    return got


def probe_counters():
    """{probe kernel: () -> its wrapper's launch count}."""
    from surface_multigrid_code_torch.probes import (
        band_spmv,
        bf16_values,
        psd_precision,
        psd_stages,
        staged_spmv,
    )

    tc = psd_precision.ns_sign_apply_tc
    return {
        "ns_sign_apply_tc_tf32": lambda: tc.launches_by_passes[1],
        "ns_sign_apply_tc_3xtf32": lambda: tc.launches_by_passes[3],
        "ns_sign_copy": lambda: psd_stages.ns_sign_copy.launches,
        "spmv_bf16_values": lambda: bf16_values.spmv_bf16_values.launches,
        "spmv_staged": lambda: staged_spmv.spmv_staged.launches,
        "band_spmv_tc": lambda: band_spmv.band_spmv_tc.launches,
    }


def reset_probe_counts():
    """Set every probe kernel's launch count to 0."""
    from surface_multigrid_code_torch.probes import (
        band_spmv,
        bf16_values,
        psd_precision,
        psd_stages,
        staged_spmv,
    )

    tc = psd_precision.ns_sign_apply_tc
    tc.launches, tc.launches_by_passes = 0, dict.fromkeys(tc.launches_by_passes, 0)
    for f in (psd_stages.ns_sign_copy, bf16_values.spmv_bf16_values, staged_spmv.spmv_staged,
              band_spmv.band_spmv_tc):
        f.launches = 0


def read_probe_counts(what, needed):
    """The probe kernels' launches since reset_probe_counts; fails if a
    kernel of ``needed`` was not launched. (A probe times its plain
    version beside its kernel, so plain calls are allowed here.)"""
    torch.cuda.synchronize()
    got = {name: fn() for name, fn in probe_counters().items()}
    log(f"{what}: probe launches {got}")
    for name in needed:
        if got[name] <= 0:
            raise RuntimeError(f"probe kernel {name} was not launched ({what})")
    return got


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
    """The body of ``--child phase``: phase 11 ("mcf"), phase 18
    ("balloon-large"), phase 20 ("ico9"), phase 21 ("k4-probes", from the
    state on standard input) or phase 9 ("balloon", from the state)."""
    state = pickle.load(sys.stdin.buffer)
    dev = torch.device("cuda", 0)
    from surface_multigrid_code_torch import _build, mg_precompute
    from surface_multigrid_code_torch.utils.obj_io import read_obj
    from surface_multigrid_code_torch.utils.paths import mesh_path

    _build.load_library()
    if phase == "mcf":
        result = mcf_timings(dev)
    elif phase == "ico9":
        result = ico9_kernels(dev)
    elif phase == "k4-probes":
        result = k4_probes(state["pos"], dev)
    elif phase == "balloon-large":
        result = large_balloon(dev)
    else:
        Vb, Fb = read_obj(mesh_path(BALLOON_MESH))
        result = balloon_timings(Vb, Fb, mg_precompute(Vb, Fb, verbose=False), state["pos"],
                                 state["qdot"], dev)
    print(CHILD_RESULT + json.dumps(result), flush=True)
    return 0


# ---------------------------------------------------------------- phases 19-20

def bench_path():
    """Phase 19: ``python -m surface_multigrid_code_torch bench`` (the
    port's bench: the icosphere(9) headline, the icosphere(7) detail, the
    bunny_15K balloon step) in a process of its own, as a user runs it. Its
    JSON line must parse, every check in it must have passed, its
    headline must be icosphere(9), and its run must have launched K1-K4
    and no plain version (its own counts, from the start of its run to the
    end). Returns (the line's object, the phase's wall in s)."""
    from surface_multigrid_code_torch import bench

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "surface_multigrid_code_torch", "bench"],
                          cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                          text=True, timeout=BENCH_TIMEOUT)
    wall = time.perf_counter() - t0
    sys.stderr.write(proc.stderr)
    lines = proc.stdout.strip().splitlines()
    if not lines:
        raise RuntimeError(f"phase 19: the bench exited {proc.returncode} and printed no line")
    log(f"phase 19: the bench's line ({wall:.1f} s, exit {proc.returncode}): {lines[-1]}")
    rec = json.loads(lines[-1])
    d = rec["detail"]
    if proc.returncode != 0 or not rec["ok"] or not d["checks"] or not all(d["checks"].values()):
        raise RuntimeError(f"phase 19: the bench failed (exit {proc.returncode}): "
                           f"checks {d['checks']}")
    n9 = 10 * 4 ** bench.HEADLINE_ORDER + 2
    if d["headline"]["n"] != n9 or rec["value"] != d["headline"]["gnnz_per_s"]:
        raise RuntimeError(f"phase 19: the headline is not icosphere(9) ({n9} vertices)")
    if min(d["launches"].values()) <= 0 or any(d["plain_calls"].values()):
        raise RuntimeError(f"phase 19: the bench launched {d['launches']}, plain calls "
                           f"{d['plain_calls']}")
    return rec, wall


def entry_path(dev):
    """Phase 19: ``entry.entry()``'s V-cycle on the card, counted, against
    the same cycle on the plain versions within ENTRY_TOL of max|z|."""
    from surface_multigrid_code_torch.entry import entry

    reset_counts()
    fn, args = entry()
    z = fn(*args)
    counts = read_counts("phase 19: entry()", ("spmv_fused",))
    with plain_spmv():
        zp = fn(*args)
    err, scale = float((z - zp).abs().max()), float(zp.abs().max())
    log(f"phase 19: entry() V-cycle on {args[1].shape[0]} rows: max|z - plain| {err:.3e}, "
        f"max|z| {scale:.3e}")
    if not bool(torch.isfinite(z).all()) or err > ENTRY_TOL * scale:
        raise RuntimeError(f"phase 19: entry() differs from its plain cycle by {err:.3e}")
    return {"launches": counts, "max_abs_err": err, "max_abs_z": scale}


def ico9_kernels(dev):
    """Phase 20 (a process of its own, see run_child): K1/K2 at the shapes
    of the bench's icosphere(9) cycle, the first out of the 50 MB L2 (A_0
    ~210 MB): A_0 (axpby, resid), the largest P (add) and Pᵀ, C = 1 and
    3 (K2), f32 and f64, held to the plain version at TOL; then timed
    beside cuSPARSE (spmv_shapes) at A_0 axpby (C = 1 and 3), P_1 add and
    PT_1. The operators are the bench's, its hierarchy loaded from the
    cache phase 19 saved. Returns {"errs", "shapes", "host_s"}."""
    from surface_multigrid_code_torch import bench
    from surface_multigrid_code_torch.ops.sparse import csr_from_scipy

    As, Ps, _rhs, times = bench.ico_operators(bench.HEADLINE_ORDER)
    log(f"phase 20: icosphere({bench.HEADLINE_ORDER}) operators on the host: {times}")
    A0, P1 = As[0], Ps[0]
    PT1 = P1.T.tocsr()
    errs, rng = {}, np.random.default_rng(20)
    n = check_spmv(A0, "ico9 A_0", dev, errs, rng, Cs=(1, 3), epis=("axpby", "resid"))
    n += check_spmv(P1, "ico9 P_1", dev, errs, rng, Cs=(1, 3), epis=("add",))
    n += check_spmv(PT1, "ico9 PT_1", dev, errs, rng, Cs=(1, 3), epis=(None,))
    log(f"phase 20: K1/K2 {n} kernel-vs-plain cases agree at ico9 shapes; max abs err {errs}")
    S = {name: csr_from_scipy(M, dev, torch.float32) for name, M in
         (("A", A0), ("P", P1), ("PT", PT1))}
    dinv = torch.as_tensor(1.0 / A0.diagonal(), dtype=torch.float32, device=dev)
    cases = [("A_0 axpby, ico9", S["A"], 1, "axpby", None, dinv),
             ("A_0 axpby C=3, ico9", S["A"], 3, "axpby", None, dinv),
             ("P_1 add, ico9", S["P"], 1, "add", None, None),
             ("PT_1, ico9", S["PT"], 1, None, None, None)]
    shapes = spmv_shapes(cases, dev, phase="phase 20")
    del S, dinv, P1, PT1
    return {"errs": errs, "shapes": shapes, "host_s": times, "probes": k1_probes(A0, dev)}


def k1_probes(A9, dev):
    """Phase 20, after K1/K2: the three K1 probes (K1_PROBES: bf16 values,
    x staged by chunk, the band on tensor cores) on ico9's A_0 (``A9``),
    then on ico7's, and the band also on ico6's (``bench.ico_operators``).
    Each operator's measurement runs with the probe kernels' counts set to
    0 just before it and read just after (its kernel must have launched,
    unless the probe skipped the operator); then the probe holds its
    kernel to its plain version. Logs each probe's JSON line; returns
    {probe: line}."""
    import importlib

    from surface_multigrid_code_torch import bench
    from surface_multigrid_code_torch.probes._common import device_record

    t0 = time.perf_counter()
    ops = {9: A9}
    for k in sorted({k for _, orders, _ in K1_PROBES for k in orders} - {9}):
        ops[k] = bench.ico_operators(k)[0][0]
    log(f"phase 20: probe operators {sorted(ops)} in {time.perf_counter() - t0:.1f} s")
    kernel = {"bf16_values": "spmv_bf16_values", "staged_spmv": "spmv_staged",
              "band_spmv": "band_spmv_tc"}
    out = {}
    for name, orders, label in K1_PROBES:
        mod = importlib.import_module(f"surface_multigrid_code_torch.probes.{name}")
        runs = []
        for k in orders:
            t1 = time.perf_counter()
            p = mod.prepare(ops[k], dev, label.format(k=k))
            reset_probe_counts()
            rec = mod.measure(p, dev)
            rec["launches"] = read_probe_counts(
                f"phase 20: {name} {label.format(k=k)}",
                () if "skipped" in rec else (kernel[name],))
            rec["check"] = mod.check(p)
            rec["wall_s"] = time.perf_counter() - t1
            del p
            runs.append(rec)
        out[name] = {"probe": name, "device": device_record(dev), "seed": 0, "runs": runs}
        log(json.dumps(out[name]))
    log(f"phase 20: K1 probes in {time.perf_counter() - t0:.1f} s")
    return out


def face_hessians(V, F, pos, dev):
    """The balloon shell's 9x9 f32 face Hessians at pos, symmetrised, not
    scaled (numpy): psd_precision scales and clamps them itself."""
    shell, _ = balloon_shell(V, F, dev)
    x9 = torch.as_tensor(np.asarray(pos), device=dev).float()[shell.Ft].reshape(-1, 9)
    H = shell.face_hess(x9, shell.abars.float())
    return (0.5 * (H + H.transpose(-1, -2))).cpu().numpy()


def k4_probes(pos, dev):
    """Phase 21 (a process of its own, see run_child): the two K4 probes.
    psd_precision on its 31,608 random blocks (timed), on bunny_15K's face
    Hessians at the balloon's step-3 pose ``pos`` (scaled and clamped as
    the probe does) and on PROBE_EDGE_BLOCKS edge blocks (as given);
    psd_stages at each of its block counts. Each measurement runs with
    the probe kernels' counts set to 0 just before it and read just after;
    then the kernels are held to their plain versions. Logs each probe's
    JSON line; returns {probe: line}."""
    from surface_multigrid_code_torch.probes import psd_precision, psd_stages
    from surface_multigrid_code_torch.probes._common import device_record
    from surface_multigrid_code_torch.utils.obj_io import read_obj
    from surface_multigrid_code_torch.utils.paths import mesh_path

    t0 = time.perf_counter()
    Vb, Fb = read_obj(mesh_path(BALLOON_MESH))
    sets = {"random": (psd_precision.random_blocks(psd_precision.BLOCKS, 0), True),
            f"{BALLOON_MESH} face Hessians": (face_hessians(Vb, Fb, pos, dev), True),
            "edge": (edge_blocks(PROBE_EDGE_BLOCKS, 9, 21)[0].astype(np.float32), False)}
    inputs = {}
    for label, (H, scale) in sets.items():
        p = psd_precision.prepare(H, dev, scale)
        reset_probe_counts()
        rec = psd_precision.measure(p, dev, timed=label == "random")
        rec["launches"] = read_probe_counts(f"phase 21: psd_precision {label}",
                                            ("ns_sign_apply_tc_tf32", "ns_sign_apply_tc_3xtf32"))
        rec["tc_checks"] = psd_precision.check_tc(p)
        inputs[label] = rec
    prec = {"probe": "psd_precision", "device": device_record(dev), "seed": 0, "inputs": inputs}
    log(json.dumps(prec))
    runs = []
    for m in psd_stages.BLOCKS:
        X = psd_stages.blocks_on(m, dev)
        reset_probe_counts()
        rec = psd_stages.measure(X, dev)
        rec["launches"] = read_probe_counts(f"phase 21: psd_stages {m} blocks", ("ns_sign_copy",))
        rec["checks"] = psd_stages.check_stages(X)
        runs.append(rec)
    stages = {"probe": "psd_stages", "device": device_record(dev), "seed": 0, "runs": runs}
    log(json.dumps(stages))
    log(f"phase 21: K4 probes in {time.perf_counter() - t0:.1f} s")
    return {"psd_precision": prec, "psd_stages": stages}


def probe_rows(k1, k4):
    """The probe kernels' rows of the kernels line from phases 20-21: per
    kernel its launches (summed over the counted measurements), its
    largest error against its plain version, and the times and bound of
    one shape: the random blocks (ns_sign_apply_tc), 31,608 blocks (the
    copy), ico9's A_0 (bf16 values, staged x) and ico7's A_0 in bf16 at
    nc = 128 (the band)."""
    prec, stages = k4["psd_precision"]["inputs"], k4["psd_stages"]["runs"]
    rows = {}
    for name, passes, variant in (("ns_sign_apply_tc_tf32", 1, "tf32"),
                                  ("ns_sign_apply_tc_3xtf32", 3, "3xtf32")):
        v = prec["random"]["variants"][variant]
        rows[name] = {
            "launches": sum(r["launches"][name] for r in prec.values()),
            "max_abs_err": max(c["max_abs_err"] for r in prec.values()
                               for k, c in r["tc_checks"].items()
                               if k.startswith(f"passes{passes}_steps")),
            "kernel": v["ms"], "plain": v["plain_ms"], "bound": v["bound_ms"],
            "bound_by": v["bound_by"], "library": None, "kernel_call": v["call_ms"],
            "plain_call": v["plain_call_ms"]}
    copy = stages[0]["stages"]["copy"]
    rows["ns_sign_copy"] = {
        "launches": sum(r["launches"]["ns_sign_copy"] for r in stages),
        "max_abs_err": max(r["checks"]["copy"]["max_abs_err"] for r in stages),
        "kernel": copy["ms"], "plain": copy["plain_ms"], "bound": copy["bound_ms"],
        "bound_by": copy["bound_by"], "library": copy["library_ms"],
        "kernel_call": copy["call_ms"], "plain_call": copy["plain_call_ms"]}
    bf16, staged = k1["bf16_values"]["runs"], k1["staged_spmv"]["runs"]
    rows["spmv_bf16_values"] = {
        "launches": sum(r["launches"]["spmv_bf16_values"] for r in bf16),
        "max_abs_err": max(r["check"]["max_abs_err"] for r in bf16),
        "kernel": bf16[0]["ms_bf16"], "plain": bf16[0]["plain_ms"],
        "bound": bf16[0]["bound_ms_bf16"], "bound_by": bf16[0]["bound_by_bf16"],
        "library": None, "kernel_call": bf16[0]["call_ms_bf16"],
        "plain_call": bf16[0]["plain_call_ms"]}
    rows["spmv_staged"] = {
        "launches": sum(r["launches"]["spmv_staged"] for r in staged),
        "max_abs_err": max(r["check"]["max_abs_err"] for r in staged),
        "kernel": staged[0]["ms"], "plain": staged[0]["plain_ms"], "bound": staged[0]["bound_ms"],
        "bound_by": staged[0]["bound_by"], "library": staged[0]["library_ms"],
        "kernel_call": staged[0]["call_ms"], "plain_call": staged[0]["plain_call_ms"]}
    band = [r for r in k1["band_spmv"]["runs"] if "skipped" not in r]
    case = next(c for c in band[0]["cases"] if c["band"] == "bfloat16" and c["nc"] == 128)
    rows["band_spmv_tc"] = {
        "launches": sum(r["launches"]["band_spmv_tc"] for r in k1["band_spmv"]["runs"]),
        "max_abs_err": max(c["max_abs_err"] for r in band for c in r["check"].values()),
        "kernel": case["ms"], "plain": case["plain_ms"], "bound": case["bound_ms"],
        "bound_by": case["bound_by"], "library": case["library_ms"],
        "kernel_call": case["call_ms"], "plain_call": case["plain_call_ms"]}
    return rows




# ---------------------------------------------------------------- phase 13

def query_system(depth):
    """The query log of benchmarks/query_bench.py:33-34: icosphere(depth)
    decimated with dec_type 1 to F/64 faces (161,280 records at depth 7)."""
    from surface_multigrid_code_torch import SSP_decimate
    from surface_multigrid_code_torch.utils.synthetic import icosphere

    V, F = icosphere(depth)
    t0 = time.perf_counter()
    ok, Vc, Fc, _IMF, _IM, qlog = SSP_decimate(V, F, max(320, F.shape[0] // 64), 1)
    if not ok:
        raise RuntimeError(f"icosphere({depth}) decimation failed")
    return V, F, Vc, Fc, qlog, time.perf_counter() - t0


def random_queries(F, n, seed):
    """n points uniform over the faces of F: (BC, BF, FIdx)."""
    rng = np.random.default_rng(seed)
    fids = rng.integers(0, F.shape[0], n)
    return rng.dirichlet(np.ones(3), n), F[fids], fids


def positions(BC, BF, Vtab):
    return (np.asarray(BC)[:, :, None] * Vtab[np.asarray(BF)]).sum(1)


def held_to(p, ref, bar, what, scale=1.0):
    """The position error |p - ref| / scale held to a bar (median, distance,
    share): the median below bar[0], at least bar[2] of the points within
    bar[1]. Returns the readings."""
    err = np.linalg.norm(p - ref, axis=1) / scale
    rec = {"median": float(np.median(err)), "within": float((err < bar[1]).mean()),
           "max": float(err.max())}
    if not (rec["median"] < bar[0] and rec["within"] >= bar[2]):
        raise RuntimeError(f"{what}: position error {rec} misses the bar {bar}")
    return rec


def query_path(V, F, Vc, Fc, qlog, dev):
    """Phase 13 (counted): fine -> coarse through query_fine_to_coarse_device
    (K5, f32) at each of QUERY_COUNTS, held to the host walk at QUERY_BAR
    and walked back to the start (query_coarse_to_fine_device) at
    ROUND_TRIP_BAR; the host walk's and the device call's wall times; then
    examples 07-09. Returns ({n: record}, {example: record})."""
    from surface_multigrid_code_torch import query_fine_to_coarse
    from surface_multigrid_code_torch.query.device import (
        device_log,
        query_coarse_to_fine_device,
        query_fine_to_coarse_device,
    )

    t0 = time.perf_counter()
    dlog = device_log(qlog, dev)
    log(f"phase 13: device_log of {dlog.n_collapse} records in {time.perf_counter() - t0:.3f} s, "
        f"of which the packed walk tables {dlog.pack_s:.3f} s; packed blocks f2c "
        f"{dlog.fwd.nbytes} B, c2f {dlog.bwd.nbytes} B (CSR arrays "
        f"{sum(t.numel() * t.element_size() for t in dlog.tensors().values()) - dlog.fwd.nbytes - dlog.bwd.nbytes} B)")
    scale = float(np.linalg.norm(V.max(0) - V.min(0)))
    warm = random_queries(F, 1000, seed=0)
    query_fine_to_coarse_device(dlog, *warm)
    out = {}
    for n in QUERY_COUNTS:
        q = random_queries(F, n, seed=n)
        t0 = time.perf_counter()
        h = query_fine_to_coarse(qlog, *q)
        host_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        d = query_fine_to_coarse_device(dlog, *q)
        dev_s = time.perf_counter() - t0
        if d[0].shape != (n, 3) or not np.isfinite(d[0]).all():
            raise RuntimeError(f"phase 13: {n} queries: bad shape or non-finite barycentrics")
        vs_host = held_to(positions(*d[:2], Vc), positions(*h[:2], Vc), QUERY_BAR,
                          f"phase 13: {n} queries f2c against the host walk")
        back = query_coarse_to_fine_device(dlog, *d)
        trip = held_to(positions(*back[:2], V), positions(*q[:2], V), ROUND_TRIP_BAR,
                       f"phase 13: {n} queries f2c -> c2f", scale)
        out[n] = {"host_walk_s": host_s, "device_call_s": dev_s, "vs_host": vs_host,
                  "same_face": float((d[2] == h[2]).mean()), "round_trip": trip}
        log(f"phase 13: {n} queries f2c: host walk {host_s:.4f} s, device call (transfers "
            f"included) {dev_s:.4f} s; position error against the host walk {vs_host}, "
            f"same coarse face {out[n]['same_face']:.6f}; round trip (of the mesh scale) {trip}")
    return out, examples_path(dev)


def golden(name):
    from surface_multigrid_code_torch.utils.obj_io import read_obj

    return read_obj(os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "golden",
                                 f"{name}.obj"))


def examples_path(dev):
    """Examples 07-09 on bunny through query_coarse_to_fine_device (K5,
    f32), against data/golden: ex07's coarse mesh and its coarse vertices
    mapped onto the fine surface (qslim, 1000 faces), ex08 (500 faces,
    dec 1, 2 subdivisions) and ex09 (dec 0, seed 10, 3 subdivisions).
    Connectivity must be exact; vertices meet QUERY_BAR relative to the
    mesh scale."""
    from surface_multigrid_code_torch import SSP_decimate
    from surface_multigrid_code_torch.query.device import device_log, query_coarse_to_fine_device
    from surface_multigrid_code_torch.solver.hierarchy import _seed_corner_barycentrics
    from surface_multigrid_code_torch.utils.obj_io import read_obj
    from surface_multigrid_code_torch.utils.paths import mesh_path
    from surface_multigrid_code_torch.utils.upsample import upsample_barycentric

    VO, FO = read_obj(mesh_path("bunny"))
    scale = float(np.linalg.norm(VO.max(0) - VO.min(0)))
    out = {}
    ok, V, F, _, _, qlog = SSP_decimate(VO, FO, 1000, 0)
    Vg, Fg = golden("ex07_coarse")
    if not ok or not np.array_equal(F, Fg) or not np.allclose(V, Vg, atol=1e-5 * scale):
        raise RuntimeError("phase 13: ex07's coarse mesh differs from data/golden")
    d = query_coarse_to_fine_device(device_log(qlog, dev), *_seed_corner_barycentrics(V.shape[0], F))
    out["ex07"] = held_to(positions(*d[:2], VO), golden("ex07_points")[0], QUERY_BAR,
                          "phase 13: ex07 points", scale)
    for tag, dec_type, seed, nsub in EXAMPLES:
        ok, V, F, _, _, qlog = SSP_decimate(VO, FO, 500, dec_type, seed=seed)
        BC, BF, FIdx, faces = upsample_barycentric(V, F, nsub)
        d = query_coarse_to_fine_device(device_log(qlog, dev), BC, BF, FIdx)
        SV = positions(*d[:2], VO)
        for it, Fk in enumerate(faces):
            Vg, Fg = golden(f"{tag}_output_s{it}")
            if not ok or not np.array_equal(Fk, Fg):
                raise RuntimeError(f"phase 13: {tag} s{it}: connectivity differs from data/golden")
            out[f"{tag}_s{it}"] = held_to(SV[: Fk.max() + 1], Vg, QUERY_BAR,
                                          f"phase 13: {tag} s{it} vertices", scale)
    log(f"phase 13: examples 07-09 through the device walk match data/golden (connectivity "
        f"exact; vertex error of the mesh scale {out})")
    return out


def walk_inputs(F, Fc, qlog, n, forward, dev, dtype):
    """n random queries in working-mesh ids as the walk takes them: on the
    fine mesh (forward) or the coarse mesh, mapped through IM / IMF."""
    if forward:
        BC, BF, FIdx = random_queries(F, n, seed=n + 1)
    else:
        BC, BF, FIdx = random_queries(Fc, n, seed=n + 2)
        BF, FIdx = qlog["IM"][BF], qlog["IMF"][FIdx]
    return (torch.as_tensor(BC).to(device=dev, dtype=dtype),
            torch.as_tensor(BF).to(device=dev, dtype=torch.int32),
            torch.as_tensor(FIdx).to(device=dev, dtype=torch.int32))


def walked(fn, dlog, forward, inputs, **kw):
    """fn (query_walk or its plain version) on copies of the inputs."""
    BC, BF, FIdx = (t.clone() for t in inputs)
    fn(dlog, forward, BC, BF, FIdx, **kw)
    return BC, BF, FIdx


def walk_compare(a, b, dest):
    """Two walks' results (BC, BF, FIdx in working ids): max |BC
    difference|, share of equal (BF, FIdx), position error of the second
    against the first (dest maps (BC, BF) to positions)."""
    a = [t.cpu().numpy() for t in a]
    b = [t.cpu().numpy() for t in b]
    same = (a[1] == b[1]).all(1) & (a[2] == b[2])
    err = np.linalg.norm(dest(a[0], a[1]) - dest(b[0], b[1]), axis=1)
    return {"max_bc_diff": float(np.abs(a[0].astype(np.float64) - b[0]).max()),
            "same_ids": float(same.mean()), "max_pos_err": float(err.max()),
            "median_pos_err": float(np.median(err))}


def no_win_log(qlog, r):
    """A copy of the log whose record r has NaN parameterisations: no face
    of r wins in either direction, so each walk through r keeps its point
    there and goes on from the same face (K5's search path)."""
    out = dict(qlog)
    for k in ("uv_pre", "uv_post"):
        a = np.array(qlog[k], dtype=np.float64)
        a[qlog["voff"][r]:qlog["voff"][r + 1]] = np.nan
        out[k] = a
    return out


def check_query_kernel(V, F, Vc, Fc, qlog, dev):
    """Phase 13: K5 against its plain version on the card, f32 and f64,
    both directions, at QUERY_CHECK_N queries, and the f64 K5 against the
    host walk (which runs in f64), on the log and on its no-win copy
    (record NO_WIN_BACK from the end NaN; the walks through it must
    differ from the clean log's). Each is held to QUERY_LIMITS. Returns
    the largest |BC difference| from the plain version and the records."""
    from surface_multigrid_code_torch.query.device import device_log, query_walk, query_walk_plain
    from surface_multigrid_code_torch.ssp import _native

    # working ids -> positions: coarse vertices where they are coarse (a
    # walk through the no-win record may end on one that is not)
    Vw = np.array(V, dtype=np.float64)
    Vw[qlog["IM"]] = Vc
    dests = {True: (lambda bc, bf: positions(bc, bf, Vw)),
             False: (lambda bc, bf: positions(bc, bf, V))}
    r = qlog["voff"].shape[0] - 1 - NO_WIN_BACK
    mixed = f" unpacked above {MIXED_MAX_RECORD}"
    logs = {"": qlog, " no-win": no_win_log(qlog, r), mixed: qlog}
    worst, recs = 0.0, {}
    for dt in (torch.float32, torch.float64):
        clean = {}
        for tag, lg in logs.items():
            with max_record(MIXED_MAX_RECORD if tag == mixed else None):
                dlog = device_log(lg, dev, dt)
            if tag == mixed:
                unpacked = int((dlog.fwd.rec[:, 0] < 0).sum())
                log(f"phase 13: {unpacked} of {dlog.n_collapse} records left unpacked "
                    f"(MAX_RECORD {MIXED_MAX_RECORD})")
                if not 0 < unpacked < dlog.n_collapse:
                    raise RuntimeError("phase 13: the mixed log packs all or none of its records")
            for forward in (True, False):
                inputs = walk_inputs(F, Fc, qlog, QUERY_CHECK_N, forward, dev, dt)
                k = walked(query_walk, dlog, forward, inputs)
                checks = {"plain": walk_compare(walked(query_walk_plain, dlog, forward, inputs),
                                                k, dests[forward])}
                if dt == torch.float64:
                    host = _native.query_walk(lg, forward, *(t.cpu().numpy() for t in inputs))
                    checks["host"] = walk_compare(tuple(torch.as_tensor(h) for h in host), k,
                                                  dests[forward])
                label = f"{'f2c' if forward else 'c2f'} {str(dt)[6:]}{tag}"
                for against, rec in checks.items():
                    limit = QUERY_LIMITS[(against, dt)]
                    log(f"phase 13: K5 {label} against the {against} walk, {QUERY_CHECK_N} "
                        f"queries: {rec} (limits {limit})")
                    if rec["max_pos_err"] > limit[0] or rec["same_ids"] < limit[1]:
                        raise RuntimeError(f"K5 {label} disagrees with the {against} walk: {rec}")
                if tag == mixed:
                    if not all(bool(torch.equal(a, b)) for a, b in zip(k, clean[forward])):
                        raise RuntimeError(f"K5 {label}: not bit for bit the packed log's walk")
                elif tag:
                    moved = [(a != b).reshape(a.shape[0], -1).any(1)
                             for a, b in zip(k, clean[forward])]
                    checks["through_record"] = int((moved[0] | moved[1] | moved[2]).sum())
                    log(f"phase 13: K5 {label}: {checks['through_record']} of {QUERY_CHECK_N} "
                        f"queries walked through the NaN record {r}")
                    if checks["through_record"] == 0:
                        raise RuntimeError(f"K5 {label}: no query reached the NaN record")
                else:
                    clean[forward] = k
                worst = max(worst, checks["plain"]["max_bc_diff"])
                recs[label] = checks
    return worst, recs


@contextlib.contextmanager
def max_record(n):
    """Pack with ``query.device.MAX_RECORD`` = n inside (n None: as it is)."""
    from surface_multigrid_code_torch.query import device as qd

    saved = qd.MAX_RECORD
    qd.MAX_RECORD = saved if n is None else n
    try:
        yield
    finally:
        qd.MAX_RECORD = saved


def check_drum(dev):
    """Phase 13: the drum log (records beyond a byte, unpacked): K5 bit for
    bit its plain version, f32 and f64, both directions, at QUERY_CHECK_N
    queries, and against the host walk within DRUM_LIMITS. Returns (largest |BC difference| from the plain
    version, the records)."""
    from surface_multigrid_code_torch import SSP_decimate
    from surface_multigrid_code_torch.query.device import device_log, query_walk, query_walk_plain
    from surface_multigrid_code_torch.ssp import _native
    from surface_multigrid_code_torch.utils.synthetic import drum

    V, F = drum(DRUM_N)
    ok, Vc, Fc, _IMF, _IM, dlg = SSP_decimate(V, F, DRUM_FACES, 0)
    largest = int(np.diff(dlg["voff"]).max())
    if not ok or largest <= 255:
        raise RuntimeError(f"phase 13: the drum's largest record has {largest} vertices")
    Vw = np.array(V, dtype=np.float64)
    Vw[dlg["IM"]] = Vc
    dests = {True: (lambda bc, bf: positions(bc, bf, Vw)),
             False: (lambda bc, bf: positions(bc, bf, V))}
    worst, recs = 0.0, {}
    for dt in (torch.float32, torch.float64):
        dlog = device_log(dlg, dev, dt)
        for forward in (True, False):
            label = f"drum {'f2c' if forward else 'c2f'} {str(dt)[6:]}"
            unpacked = torch.nonzero(dlog.packed(forward).rec[:, 0] < 0).flatten().tolist()
            inputs = walk_inputs(F, Fc, dlg, QUERY_CHECK_N, forward, dev, dt)
            k = walked(query_walk, dlog, forward, inputs)
            plain = walked(query_walk_plain, dlog, forward, inputs)
            host = _native.query_walk(dlg, forward, *(t.cpu().numpy() for t in inputs))
            rec = {"unpacked": unpacked,
                   "plain": walk_compare(plain, k, dests[forward]),
                   "host": walk_compare(tuple(torch.as_tensor(h) for h in host), k,
                                        dests[forward])}
            log(f"phase 13: K5 {label} ({largest}-vertex records, unpacked {unpacked}), "
                f"{QUERY_CHECK_N} queries: {rec}")
            if not all(bool(torch.equal(a, b)) for a, b in zip(k, plain)):
                raise RuntimeError(f"K5 {label}: not bit for bit the plain walk")
            pos, same = DRUM_LIMITS[dt]
            if rec["host"]["same_ids"] < same or rec["host"]["max_pos_err"] > pos:
                raise RuntimeError(f"K5 {label} disagrees with the host walk: {rec['host']}")
            if not unpacked:
                raise RuntimeError(f"phase 13: the {label} log packs every record")
            worst = max(worst, rec["plain"]["max_bc_diff"])
            recs[label] = rec
    return worst, recs


def walk_bytes(qlog, stats, forward, n, itemsize):
    """Bytes a walk must move, each read once: the query arrays in and out,
    and of what the walk visited (``stats`` of query_walk_plain) the
    records' offsets, vertex ids, both parameterisations and destination
    faces, and the faces' dim_dat ranges with their offsets. Operations:
    per step the query point (6) and per face tested the barycentrics (28),
    a renormalisation per step (5)."""
    rec = np.flatnonzero(stats["records"].cpu().numpy())
    faces = np.flatnonzero(stats["faces"].cpu().numpy())
    foff = qlog["foff_post" if forward else "foff_pre"]
    nv = np.diff(qlog["voff"])[rec]
    nf = np.diff(foff)[rec]
    offsets = 2 * np.union1d(rec, rec + 1).size + np.union1d(faces, faces + 1).size
    nbytes = (4 * offsets + (4 + 4 * itemsize) * int(nv.sum()) + 16 * int(nf.sum())
              + 4 * int(np.diff(qlog["dim_off"])[faces].sum())
              + 2 * n * (3 * itemsize + 16))
    return nbytes, 11 * stats["steps"] + 28 * stats["tested"]


def query_timings(F, Fc, qlog, host, dev, reps=5):
    """Phase 13: K5 (f32, fine -> coarse) at each of QUERY_COUNTS by CUDA
    events (queued_ms), its bound from the steps and bytes the plain
    version counts on the same queries, and the plain version's wall time
    per call at QUERY_CHECK_N. host: phase 13's host-walk times."""
    from surface_multigrid_code_torch.query.device import (
        device_log,
        launch_shape,
        query_walk,
        query_walk_plain,
    )

    dlog = device_log(qlog, dev)
    out = {}
    for n in QUERY_COUNTS:
        inputs = walk_inputs(F, Fc, qlog, n, True, dev, torch.float32)
        work = [t.clone() for t in inputs]

        def prep():
            for w, t in zip(work, inputs):
                w.copy_(t)

        ms = queued_ms(prep, lambda: query_walk(dlog, True, *work), reps)
        stats = {}
        walked(query_walk_plain, dlog, True, inputs, stats=stats)
        nbytes, ops = walk_bytes(qlog, stats, True, n, 4)
        bound, by = bound_ms(nbytes, ops)
        per_query = stats["query_steps"].cpu().numpy()
        rec = {"ms": ms, "bound_ms": bound, "bound_by": by, "bytes": nbytes, "ops": ops,
               "steps": stats["steps"], "records_visited": int(stats["records"].sum()),
               "steps_mean": float(per_query.mean()), "steps_max": int(per_query.max()),
               "warp_efficiency": warp_efficiency(per_query),
               "host_walk_ms": 1e3 * host[n]["host_walk_s"],
               "device_call_ms": 1e3 * host[n]["device_call_s"]}
        if n == QUERY_CHECK_N:
            t0 = time.perf_counter()
            walked(query_walk_plain, dlog, True, inputs)
            torch.cuda.synchronize()
            rec["plain_ms"] = 1e3 * (time.perf_counter() - t0)
        out[n] = rec
        log(f"phase 13: K5 f2c {n} queries: {ms:.4f} ms (events), bound {bound:.4f} ms ({by}: "
            f"{nbytes} B, {stats['steps']} steps, {rec['records_visited']} of "
            f"{dlog.n_collapse} records), host walk {rec['host_walk_ms']:.3f} ms"
            + (f", plain {rec['plain_ms']:.3f} ms" if "plain_ms" in rec else "")
            + f"; steps a query mean {rec['steps_mean']:.3f}, max {rec['steps_max']}, warp "
            f"efficiency {rec['warp_efficiency']:.4f}")
    threads, smem = launch_shape(dlog.fwd.chunks)
    out["launch"] = {"threads": threads, "shared_bytes": smem, "chunks": dlog.fwd.chunks}
    log(f"phase 13: K5 f32 f2c launch: {threads} threads a block, {smem} B of dynamic shared "
        f"memory a block ({dlog.fwd.chunks} chunks of 16 B a thread)")
    return out


def warp_efficiency(steps):
    """Sum of the queries' steps over the sum, per warp of 32 consecutive
    queries, of 32 times its longest walk: the share of a warp's thread
    steps that walk."""
    steps = np.concatenate([steps, np.zeros(-len(steps) % 32, dtype=steps.dtype)])
    return float(steps.sum() / (32 * steps.reshape(-1, 32).max(1)).sum())


def f2c_narrow(dlog, BC, BF, FIdx, parts):
    """query_fine_to_coarse_device with the narrow types (float32, int32)
    sent across and widened on the host with numpy, timed by the same
    parts ("d2h", then "widen")."""
    from surface_multigrid_code_torch.query.device import _I32, _Parts, _queries, query_walk

    clock = _Parts(parts, dlog.device)
    queries = _queries(dlog, BC, BF, FIdx, _I32.max, dlog.dim_off.shape[0] - 1, clock)
    BC, BF, FIdx = query_walk(dlog, True, *queries)
    clock.mark("walk")
    BF, FIdx = dlog.im_fwd[BF], dlog.FIM[FIdx]
    clock.mark("id_maps")
    BC, BF, FIdx = (t.cpu().numpy() for t in (BC, BF, FIdx))
    clock.mark("d2h")
    out = BC.astype(np.float64), BF.astype(np.int64), FIdx.astype(np.int64)
    clock.mark("widen")
    return out


def public_call_parts(F, qlog, dev, n=QUERY_COUNTS[-1]):
    """Phase 13: query_fine_to_coarse_device at n queries by part
    (validation, H2D, walk, id maps, D2H with the widening on the card)
    against the same call with the narrow types across and numpy widening
    them on the host (f2c_narrow), in turns port, narrow, narrow, port;
    the results must be bitwise equal. Returns {"port"|"narrow": {part:
    median seconds}}."""
    from surface_multigrid_code_torch.query.device import device_log, query_fine_to_coarse_device

    dlog = device_log(qlog, dev)
    q = random_queries(F, n, seed=n)
    fns = {"port": (lambda parts: query_fine_to_coarse_device(dlog, *q, parts=parts)),
           "narrow": (lambda parts: f2c_narrow(dlog, *q, parts))}
    fns["port"](None)
    runs, outs = {k: [] for k in fns}, {}
    for name in ("port", "narrow", "narrow", "port"):
        parts = {}
        t0 = time.perf_counter()
        outs[name] = fns[name](parts)
        parts["total"] = time.perf_counter() - t0
        runs[name].append(parts)
    for a, b in zip(outs["port"], outs["narrow"]):
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise RuntimeError("phase 13: the narrow D2H changed query_fine_to_coarse_device's "
                               "result")
    out = {name: {k: float(np.median([p[k] for p in ps])) for k in ps[0]}
           for name, ps in runs.items()}
    for name, rec in out.items():
        log(f"phase 13: query_fine_to_coarse_device {n} queries, {name}: "
            + ", ".join(f"{k} {1e3 * v:.3f} ms" for k, v in rec.items()))
    return out


# ---------------------------------------------------------------- phase 14

def same_module(a, b, what):
    """Every buffer of two modules bitwise equal, with its dtype and
    device, and their lanes, n_cols, lam_max and n_groups."""
    sa, sb = a.state_dict(), b.state_dict()
    if list(sa) != list(sb):
        raise RuntimeError(f"{what}: the loaded buffers differ in name")
    for k in sa:
        if sa[k].dtype != sb[k].dtype or sa[k].device != sb[k].device \
                or not torch.equal(sa[k], sb[k]):
            raise RuntimeError(f"{what}: {k} differs after the round trip")
    for (na, ma), (_, mb) in zip(a.named_modules(), b.named_modules()):
        for attr in ("lanes", "n_cols", "lam_max", "n_groups"):
            if getattr(ma, attr, None) != getattr(mb, attr, None):
                raise RuntimeError(f"{what}: {na}.{attr} differs after the round trip")
    return len(sa)


def persistence_path(jacobi, V, F, mg, A, M, Vb, Fb, mg_b, tmp, dev):
    """Phase 14: the ico7 Jacobi DeviceHierarchy and the bunny_15K
    BsrHierarchy (block Hessian at rest, f32) through save_device_hierarchy
    / load_device_hierarchy on the card: every tensor bitwise with its
    dtype, and one solve each with bitwise the same residuals; then the
    ico7 host hierarchy through save_hierarchy / load_hierarchy solves as
    the one it was written from."""
    from surface_multigrid_code_torch import (
        load_device_hierarchy,
        load_hierarchy,
        min_quad_with_fixed_mg_precompute,
        min_quad_with_fixed_mg_solve,
        save_device_hierarchy,
        save_hierarchy,
    )
    from surface_multigrid_code_torch.models.balloon import BsrBalloonStepper
    from surface_multigrid_code_torch.solver.bsr import bsr_solve_loop
    from surface_multigrid_code_torch.solver.vcycle import solve_loop

    out = {}
    b = np.asarray(M @ V[:, 0])
    rhs = torch.as_tensor(b, dtype=torch.float32, device=dev)
    shell, Mb = balloon_shell(Vb, Fb, dev)
    stepper = BsrBalloonStepper(shell, Mb, mg_b, balloon_defaults()["dt"], dtype=torch.float32)
    bsr = stepper.solver.refresh(block_hessian(stepper, Vb, dev))
    rhs_b = torch.as_tensor(np.random.default_rng(9).standard_normal((Vb.shape[0], 3)),
                            dtype=torch.float32, device=dev)
    cases = {
        "ico7 Jacobi DeviceHierarchy": (jacobi.hier, lambda h: solve_loop(
            h, rhs, torch.zeros_like(rhs), REL_TOL * float(np.linalg.norm(b)), 20, jacobi.cfg)),
        "bunny_15K BsrHierarchy": (bsr, lambda h: bsr_solve_loop(
            h, rhs_b, torch.zeros_like(rhs_b), 1e-4 * float(rhs_b.norm()), 20,
            stepper.solver.cfg)),
    }
    for what, (hier, solve) in cases.items():
        path = os.path.join(tmp, "hier.pt")
        t0 = time.perf_counter()
        save_device_hierarchy(path, hier)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = load_device_hierarchy(path, dev)
        t_load = time.perf_counter() - t0
        n_buf = same_module(hier, got, what)
        (z0, r0, k0), (z1, r1, k1) = solve(hier), solve(got)
        if k0 != k1 or k0 < 2 or not torch.equal(r0, r1) or not torch.equal(z0, z1):
            raise RuntimeError(f"{what}: the loaded hierarchy solves differently: "
                               f"{r0[:k0].tolist()} / {r1[:k1].tolist()}")
        out[what] = {"buffers": n_buf, "bytes": os.path.getsize(path), "save_s": t_save,
                     "load_s": t_load, "residuals": r0[:k0].tolist()}
        log(f"phase 14: {what}: {n_buf} tensors round-trip bitwise ({out[what]['bytes']} B, "
            f"save {t_save:.3f} s, load {t_load:.3f} s); the same {k0} residuals "
            f"{r0[0].item():.4e} -> {r0[k0 - 1].item():.4e}")
    path = os.path.join(tmp, "mg.npz")
    save_hierarchy(path, mg)
    t0 = time.perf_counter()
    data = min_quad_with_fixed_mg_precompute(A, None, load_hierarchy(path), jacobi.cfg, device=dev)
    t_pre = time.perf_counter() - t0
    tol = REL_TOL * float(np.linalg.norm(b))
    (z0, r0, ok0), (z1, r1, ok1) = (min_quad_with_fixed_mg_solve(d, b, tolerance=tol)
                                    for d in (jacobi, data))
    if not (ok0 and ok1 and r0 == r1 and np.array_equal(z0, z1)):
        raise RuntimeError(f"phase 14: the loaded host hierarchy solves differently: {r0} / {r1}")
    out["ico7 host hierarchy"] = {"bytes": os.path.getsize(path), "precompute_s": t_pre,
                                  "residuals": r0}
    log(f"phase 14: ico7 host hierarchy through save_hierarchy / load_hierarchy "
        f"({out['ico7 host hierarchy']['bytes']} B): precompute {t_pre:.3f} s, the same "
        f"{len(r0)} residuals")
    return out


def cli_path(tmp):
    """Phase 14: the CLI in process on the card: solve on ogre, mcf for 2
    steps on bunny, remesh with example 08's arguments (files held to
    data/golden as tests/test_golden_remesh.py holds them)."""
    from surface_multigrid_code_torch import cli
    from surface_multigrid_code_torch.utils.obj_io import read_obj
    from surface_multigrid_code_torch.utils.paths import mesh_path

    out = {}
    t0 = time.perf_counter()
    cli.main(["solve", mesh_path("ogre"), "-o", os.path.join(tmp, "z.npz")])
    with np.load(os.path.join(tmp, "z.npz")) as z:
        if not (np.isfinite(z["z"]).all() and z["r_his"][-1] <= 1e-3):
            raise RuntimeError(f"phase 14: CLI solve did not converge: {z['r_his']}")
        out["solve"] = {"residuals": z["r_his"].tolist(), "s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    cli.main(["mcf", mesh_path("bunny"), "--steps", "2", "-o", os.path.join(tmp, "mcf.obj")])
    U, Fu = read_obj(os.path.join(tmp, "mcf.obj"))
    V0, F0 = read_obj(mesh_path("bunny"))
    if U.shape != V0.shape or not np.array_equal(Fu, F0) or not np.isfinite(U).all():
        raise RuntimeError("phase 14: CLI mcf wrote a bad mesh")
    out["mcf"] = {"s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    prefix = os.path.join(tmp, "rm")
    cli.main(["remesh", mesh_path("bunny"), "-t", "500", "-d", "1", "-n", "2", "-o", prefix])
    for it in range(3):
        (Vr, Fr), (Vg, Fg) = read_obj(f"{prefix}_s{it}.obj"), golden(f"ex08_output_s{it}")
        if not np.array_equal(Fr, Fg) or not np.allclose(Vr, Vg, atol=1e-5 * np.abs(Vg).max()):
            raise RuntimeError(f"phase 14: CLI remesh s{it} differs from data/golden")
    out["remesh"] = {"s": time.perf_counter() - t0}
    log(f"phase 14: CLI solve (ogre, residuals {out['solve']['residuals']}), mcf (bunny, 2 "
        f"steps) and remesh (ex08, = data/golden) on the card: "
        f"{ {k: round(v['s'], 3) for k, v in out.items()} } s")
    return out


# ---------------------------------------------------------------- phase 15
# The sharded paths (parallel/): the ranks of one RankPool share the one
# card over gloo (NCCL takes one rank per card), so their walls say
# nothing about scaling. A sharded residual history is held to the
# single-device one at SHARDED_RTOL, the bar of the JAX package's dryrun
# (__graft_entry__.py:200, 237-242): f32 sums in other orders, so a
# residual at the tolerance may stop one cycle apart and the common prefix
# is compared. An entry ||b - A z|| is a cancelling difference of terms
# of the size of ||b|| (REL_TOL's note: its f32 floor is 1.5e-5 ||b||),
# so two orders also differ by their f32 rounding whatever the entry's own
# size: up to 1.1e-6 ||b|| on the static solve and 2.6e-6 ||b|| on an MCF
# step on the H100. Entries are held within SHARDED_FLOOR ||b||. The
# balloon's Newton direction at rest is held in f64 at
# BALLOON_DIRECTION_GAP (relative max|dx - dx_single|), both solves run to
# BALLOON_DIRECTION_TOL[dtype] * ||g|| (in f32 1e-5, above its floor) or
# the balloon's 20 cycles; one f64 implicit-Euler step (example 06's
# defaults) at BALLOON_STEP_GAP of max|disp|.
SHARDED_RANKS = (1, 2, 4)
SHARDED_RTOL = 1e-4
SHARDED_FLOOR = 1.5e-5
MCF_SHARDED = (("ogre", False), ("ogre", True))
MCF_SHARDED_STEPS = 3
BALLOON_DIRECTION_TOL = {"f64": 1e-10, "f32": 1e-5}
BALLOON_DIRECTION_GAP = 1e-8
BALLOON_STEP_GAP = 1e-6


def rank_counts():
    """This process's hand-kernel launches and plain-version calls."""
    from surface_multigrid_code_torch.ops.psd import ns_sign_apply, ns_sign_apply_plain
    from surface_multigrid_code_torch.ops.spmv import fused_spmv, fused_spmv_plain

    sync()
    return {"spmv_fused": fused_spmv.launches - fused_spmv.planes_launches,
            "spmv_fused_planes": fused_spmv.planes_launches,
            "ns_sign_apply": ns_sign_apply.launches,
            "plain_calls": fused_spmv_plain.calls + ns_sign_apply_plain.calls}


def reset_rank_counts():
    from surface_multigrid_code_torch.ops.psd import ns_sign_apply, ns_sign_apply_plain
    from surface_multigrid_code_torch.ops.spmv import fused_spmv, fused_spmv_plain

    sync()
    fused_spmv.launches = fused_spmv.planes_launches = ns_sign_apply.launches = 0
    fused_spmv_plain.calls = ns_sign_apply_plain.calls = 0


def sync():
    """A device sync on the card (a rank on the CPU, in a rehearsal, has none)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def timed(fn):
    """(fn(), host seconds closed by a device sync)."""
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def check_rank_csr(S, label, dev, errs, rng, Cs=(1, 3), epis=EPIS):
    """K1/K2 against the plain version on a rank's own operator S (its CSR
    as built: local column ids in the global order), f32 and f64, each
    epilogue of epis, each C of Cs. Returns the number of cases."""
    from surface_multigrid_code_torch.ops.sparse import CSRMatrix
    from surface_multigrid_code_torch.ops.spmv import fused_spmv, fused_spmv_plain

    n, m = S.shape
    cases = 0
    for dt in (torch.float32, torch.float64):
        def t(a):
            return torch.as_tensor(a).to(dev, dt)

        Sd = CSRMatrix(S.indptr, S.indices, S.data.to(dt), m)
        s = t(rng.uniform(0.5, 2.0, n))
        for C in Cs:
            shp = (n,) if C == 1 else (n, C)
            x = t(rng.standard_normal((m,) if C == 1 else (m, C)))
            u, b = t(rng.standard_normal(shp)), t(rng.standard_normal(shp))
            for epi in epis:
                kw = dict(epi=epi, b=b, u=u, s=s, escale=2.0 / 3.0)
                _compare(fused_spmv(Sd, x, **kw), fused_spmv_plain(Sd, x, **kw), dt,
                         f"{label} ({n} x {m}) C={C} {dt} epi={epi}, lanes "
                         f"{fused_spmv.last_lanes}", errs, kernel_name(C))
                cases += 1
    return cases


def rank_static(group, dev, As, Ps, smoother, rhs, tol, check, backend="halo"):
    """A rank of the static sharded solve (f32) on ``backend``: "halo"
    (``HaloHierarchy``, phase 15), "well" (``WellHaloHierarchy``) or "spmd"
    (``build_sharded_hierarchy`` / ``sharded_solve``): build, solve
    counted, one more V-cycle for the bytes each level sends and the
    collectives it makes; with ``check``, K1/K2 on every operator of this
    rank against the plain version."""
    import collections

    from surface_multigrid_code_torch.config import SmootherType, SolveConfig
    from surface_multigrid_code_torch.parallel.halo import HaloHierarchy
    from surface_multigrid_code_torch.parallel.spmd import build_sharded_hierarchy, sharded_solve
    from surface_multigrid_code_torch.parallel.wellhalo import WellHaloHierarchy

    cfg = SolveConfig(smoother=SmootherType(smoother))
    make = {"halo": lambda: (HaloHierarchy(As, Ps, cfg, torch.float32, dev, group), None),
            "well": lambda: (WellHaloHierarchy(As, Ps, cfg, torch.float32, dev, group), None),
            "spmd": lambda: build_sharded_hierarchy(As, Ps, cfg, torch.float32, dev, group)}
    (h, sizes), build_s = timed(make[backend])
    reset_rank_counts()
    if backend == "spmd":
        (z, r_his, _), solve_s = timed(lambda: sharded_solve(h, sizes, rhs, tolerance=tol,
                                                             max_iter=20))
        ok = r_his[-1] <= tol
    else:
        (z, r_his, ok), solve_s = timed(lambda: h.solve(rhs, tolerance=tol, max_iter=20))
    counts = rank_counts()
    h.sent_bytes = [0] * len(h.levels)
    b = h.local_rows(rhs)
    before = collections.Counter(h.comm.counts)
    h.vcycle(b, torch.zeros_like(b))
    C = 1 if rhs.ndim == 1 else rhs.shape[1]
    levels = []
    for lv, nb in zip(h.levels, h.sent_bytes):
        rec = {"R": lv.R, "nnz": int(lv.A.data.shape[0]), "pt_cols": lv.pt_cols,
               "bytes_per_cycle": nb}
        if backend == "halo":
            rec["S"] = lv.S
        else:
            rec.update(lo=lv.lo, hi=lv.hi, mode=lv.mode,
                       bytes_per_exchange=h.exchange_bytes(len(levels), 4, C))
        levels.append(rec)
    rec = {"rank": h.rank, "ranks": h.D, "backend": h.comm.backend, "device": str(dev),
           "build_s": build_s, "solve_s": solve_s, "residuals": r_his, "converged": ok,
           "counts": counts, "levels": levels,
           "collectives_per_cycle": dict(h.comm.counts - before)}
    if check:
        errs, rng, cases = {}, np.random.default_rng(100 + h.rank), 0
        for lv, level in enumerate(h.levels):
            cases += check_rank_csr(level.A, f"rank {h.rank} A_{lv}", dev, errs, rng)
            if level.P is not None:
                cases += check_rank_csr(level.P, f"rank {h.rank} P_{lv}", dev, errs, rng)
                cases += check_rank_csr(level.PT, f"rank {h.rank} PT_{lv}"
                                        + (" column-partitioned" if level.pt_cols else ""),
                                        dev, errs, rng)
        sync()
        rec.update(errs=errs, cases=cases)
    if h.rank == 0:
        rec["z"] = z
    return rec


def refresh_ms(h, vals, reps=3):
    """The least of reps host times of h.refresh(vals), closed by a sync."""
    return min(1e3 * timed(lambda: h.refresh(vals))[1] for _ in range(reps))


def check_chain(h, dev, seed):
    """K1 against the plain version on this rank's G_l of a WellHaloHierarchy
    with refresh (the only epilogue the chain uses: none, one column)."""
    errs, rng, cases = {}, np.random.default_rng(seed + h.rank), 0
    for lv, ch in enumerate(h._refresh["chain"]):
        cases += check_rank_csr(ch["G"], f"rank {h.rank} G_{lv + 1}", dev, errs, rng, Cs=(1,),
                                epis=(None,))
    sync()
    return errs, cases


def chain_shapes(h):
    """Per G_l of this rank: rows, columns, nnz, longest row, exchange, and
    the bound of its K1 launch (spmv_bytes in the chain's type)."""
    out = []
    for ch in h._refresh["chain"]:
        G = ch["G"]
        nbytes, flops = spmv_bytes(host_csr(G), 1, None, itemsize=G.data.element_size())
        out.append({"rows": G.n_rows, "cols": G.n_cols, "nnz": int(G.data.shape[0]),
                    "max_row": int(G.indptr.diff().max()) if G.n_rows else 0,
                    "lo": ch["lo"], "hi": ch["hi"], "replicated": ch["rep"],
                    "bytes": nbytes, "bound_ms": bound_ms(nbytes, flops,
                                                          G.data.dtype == torch.float64)[0]})
    return out


def rank_mcf(group, dev, V, F, mg, n_steps, backend="halo", check=False):
    """A rank of ShardedMCFStepper (Jacobi, f32) on ``backend``: n_steps
    steps from V, then the refresh of the last step's values timed; with
    ``check`` (backend "well"), K1 on every G_l of this rank."""
    from surface_multigrid_code_torch.config import SmootherType, SolveConfig
    from surface_multigrid_code_torch.parallel.mcf import ShardedMCFStepper, _barycentric_mass

    st, build_s = timed(lambda: ShardedMCFStepper(
        V, F, mg, cfg=SolveConfig(smoother=SmootherType.JACOBI), dtype=torch.float32,
        device=dev, group=group, backend=backend))
    reset_rank_counts()
    U, steps = V, []
    for _ in range(n_steps):
        (U, r_his, ok), wall = timed(lambda: st.step(U))
        steps.append({"residuals": r_his, "converged": ok, "wall_s": wall,
                      "U": U if st.halo.rank == 0 else None})
    counts = rank_counts()
    vals = st._L_vals.copy()
    vals[st._diag_slots] += _barycentric_mass(U, st.F)
    h = st.halo
    rec = {"rank": h.rank, "backend": h.comm.backend, "build_s": build_s,
           "counts": counts, "steps": steps, "refresh_ms": refresh_ms(h, vals),
           "levels": [(lv.R, lv.S, lv.pt_cols) if backend == "halo"
                      else (lv.R, lv.lo, lv.hi, lv.mode) for lv in h.levels]}
    if backend == "well":
        rec["chain"] = chain_shapes(h)
    if check:
        rec["errs"], rec["cases"] = check_chain(h, dev, 300)
    return rec


def rank_balloon(group, dev, V, F, mg, g_rel_tol, backend="halo", dtypes=("f64", "f32"),
                 check=False):
    """A rank of ShardedBalloonNewton on ``backend`` at example 06's
    defaults: the Newton direction at rest in each of dtypes (solved to
    g_rel_tol[dtype] * ||g|| or 20 cycles) and the refresh of its values
    timed, then one f64 implicit_euler_mg_balloon_sharded step from rest;
    with ``check`` (backend "well"), K1 on every G_l of this rank (f64
    solver's chain)."""
    from surface_multigrid_code_torch.models.balloon import inflation_force
    from surface_multigrid_code_torch.parallel.balloon import (
        ShardedBalloonNewton,
        implicit_euler_mg_balloon_sharded,
    )

    d = balloon_defaults()
    dt = d["dt"]
    shell, M = balloon_shell(V, F, dev)
    fExt = inflation_force(V, F, d["pressure"])
    g = -(dt * shell.gradient(V.reshape(-1)) + dt * fExt)
    out = {}
    for name in dtypes:
        dtype = {"f64": torch.float64, "f32": torch.float32}[name]
        ns, build_s = timed(lambda: ShardedBalloonNewton(shell, M, mg, dt, dtype=dtype,
                                                         group=group, backend=backend))
        reset_rank_counts()
        vals = ns.hessian_values(V.reshape(-1), dt)
        (dx, r_his, ok), solve_s = timed(lambda: ns.solve(
            vals, g, tolerance=g_rel_tol[name] * float(np.linalg.norm(g)), max_iter=20))
        rec = {"build_s": build_s, "solve_s": solve_s, "residuals": r_his, "converged": ok,
               "counts": rank_counts(), "dx": dx if ns.halo.rank == 0 else None,
               "refresh_ms": refresh_ms(ns.halo, vals)}
        if backend == "well":
            rec["chain"] = chain_shapes(ns.halo)
        if check and name == "f64":
            rec["errs"], rec["cases"] = check_chain(ns.halo, dev, 400)
        if name == "f64":
            reset_rank_counts()
            (pos, _, _), step_s = timed(lambda: implicit_euler_mg_balloon_sharded(
                shell, M, V.copy(), np.zeros(3 * V.shape[0]), fExt, dt, mg, group,
                mg_tolerance=d["mg_tolerance"], n_newton=d["n_newton"], newton_solver=ns,
                verbose=False, backend=backend))
            rec.update(step_s=step_s, step_counts=rank_counts(), newton=ns.last_newton,
                       pos=pos if ns.halo.rank == 0 else None)
        out[name] = rec
        who = {"rank": ns.halo.comm.rank, "backend": ns.halo.comm.backend}
        del ns
    return {**who, "by_dtype": out}


def rank_ready(group, dev):
    """Load the kernel library on a rank (the parent has built it)."""
    from surface_multigrid_code_torch import _build

    if dev.type == "cuda":
        _build.load_library()


def rank_collectives(group, dev, sizes, reps, names=("exchange", "allreduce_sum")):
    """Host seconds per call of each of names: Comm.exchange (publishing n
    floats of a CUDA tensor), Comm.allreduce_sum (n floats), Comm.shift (n
    floats to each neighbour), for n in sizes, each over reps calls after a
    warm-up, closed by a device sync."""
    from surface_multigrid_code_torch.parallel.comm import Comm

    comm, out = Comm(group), {}
    for n in sizes:
        x = torch.ones(n, dtype=torch.float32, device=dev)
        send = torch.arange(n, device=dev)
        fns = {"exchange": lambda: comm.exchange(x, send),
               "allreduce_sum": lambda: comm.allreduce_sum(x.clone()),
               "shift": lambda: comm.shift(x, n, n)}
        for name, fn in ((k, fns[k]) for k in names):
            for _ in range(5):
                fn()
            _, wall = timed(lambda: [fn() for _ in range(reps)])
            out[f"{name} {n}"] = wall / reps
    return out


def add_counts(total, counts):
    """Add each record of counts (name -> count) into total."""
    for c in counts:
        for k, v in c.items():
            total[k] = total.get(k, 0) + v


def held_history(r, ref, b_norm, what):
    """A sharded residual history against the single-device one: cycle
    counts within 1, the common prefix within SHARDED_RTOL (and
    SHARDED_FLOOR). Returns the largest relative gap."""
    m = min(len(r), len(ref))
    if abs(len(r) - len(ref)) > 1 or not np.allclose(
            r[:m], ref[:m], rtol=SHARDED_RTOL, atol=SHARDED_FLOOR * b_norm):
        raise RuntimeError(f"{what}: sharded residuals {r} against single-device {ref}")
    return max(abs(a / b - 1.0) for a, b in zip(r[:m], ref[:m]))


def ranks_held(recs, what, kernels):
    """Every rank launched each kernel of ``kernels`` and no plain version."""
    for rec in recs:
        c = rec["counts"]
        if c["plain_calls"]:
            raise RuntimeError(f"{what}: rank {rec['rank']} called a plain version {c}")
        for k in kernels:
            if c[k] <= 0:
                raise RuntimeError(f"{what}: rank {rec['rank']} launched no {k}: {c}")
    return [rec["counts"] for rec in recs]


def ico_chain(mg, A):
    """bench.py's operators at ico7: the Galerkin chain of A over the SSP
    prolongations (scipy's numeric product), and the prolongations."""
    Ps = [lv.P_full.tocsr() for lv in mg[1:]]
    As = [A]
    for P in Ps:
        As.append((P.T @ As[-1] @ P).tocsr())
    return As, Ps


def sharded_static(pool, V, mg, A, M, dev):
    """Phase 15a: the static solve (bench.py's operators at ico7) on D =
    1, 2, 4 ranks, Jacobi and Chebyshev, and [n, 3] on 4 ranks (Jacobi),
    each held to the single-device solve_loop on the same hierarchy."""
    from surface_multigrid_code_torch.config import SmootherType, SolveConfig
    from surface_multigrid_code_torch.solver.vcycle import build_device_hierarchy, solve_loop

    As, Ps = ico_chain(mg, A)
    b = np.asarray(M @ V[:, 0])
    runs = [(sm, D, b) for sm in ("jacobi", "chebyshev") for D in SHARDED_RANKS]
    runs.append(("jacobi", 4, np.stack([b, -2.0 * b, 0.5 * b], axis=1)))
    out, launches, errs = [], {}, {}
    for sm, D, rhs in runs:
        C = 1 if rhs.ndim == 1 else rhs.shape[1]
        tol = REL_TOL * float(np.linalg.norm(rhs))
        cfg = SolveConfig(smoother=SmootherType(sm))
        hier = build_device_hierarchy(As, Ps, cfg, device=dev, dtype=torch.float32)
        rt = torch.as_tensor(rhs, dtype=torch.float32, device=dev)
        _, ref_r, k = solve_loop(hier, rt, torch.zeros_like(rt), tol, 20, cfg)
        ref = [float(r) for r in ref_r[:k].cpu()]
        check = sm == "jacobi" and D == 4 and C == 1
        recs = pool.run(rank_static, D, As, Ps, sm, rhs, tol, check)
        what = f"phase 15: ico7 {sm} C={C} on {D} ranks"
        counts = ranks_held(recs, what, (kernel_name(C),))
        gap = held_history(recs[0]["residuals"], ref, float(np.linalg.norm(rhs)), what)
        z = recs[0]["z"]
        res = float(np.linalg.norm(A @ z - rhs))
        if z.shape != rhs.shape or not np.isfinite(z).all() or not res <= 2 * tol:
            raise RuntimeError(f"{what}: bad solution (residual {res:.3e}, tol {tol:.3e})")
        add_counts(launches, counts)
        rec = {"smoother": sm, "ranks": D, "C": C, "backend": recs[0]["backend"],
               "residuals": recs[0]["residuals"], "single_device": ref,
               "max_rel_gap": gap, "host_residual": res, "launches_per_rank": counts,
               "build_s": [r["build_s"] for r in recs], "solve_s": [r["solve_s"] for r in recs],
               "levels": recs[0]["levels"],
               "bytes_per_cycle": [[lv["bytes_per_cycle"] for lv in r["levels"]] for r in recs],
               "collectives_per_cycle": recs[0]["collectives_per_cycle"]}
        if check:
            for r in recs:
                for name, e in r["errs"].items():
                    errs[name] = max(errs.get(name, 0.0), e)
            rec["kernel_cases"] = sum(r["cases"] for r in recs)
        out.append(rec)
        log(f"{what} ({rec['backend']}, {D} ranks sharing one card, walls no measure of "
            f"scaling): residuals "
            f"{rec['residuals'][0]:.4e} -> {rec['residuals'][-1]:.4e} in "
            f"{len(rec['residuals'])}, single-device {len(ref)}, largest relative gap "
            f"{gap:.2e}; solve wall {max(rec['solve_s']):.3f} s, build "
            f"{max(rec['build_s']):.2f} s; K1/K2 launches per rank {counts}")
        if D > 1 and C == 1 and sm == "jacobi":
            for lv, level in enumerate(rec["levels"]):
                log(f"phase 15: ico7 {D} ranks level {lv}: R {level['R']}, S {level['S']}, "
                    f"restriction {'columns' if level['pt_cols'] else 'rows'}, bytes sent per "
                    f"V-cycle by rank {[bs[lv] for bs in rec['bytes_per_cycle']]}")
        if check:
            log(f"phase 15: K1/K2 {rec['kernel_cases']} kernel-vs-plain cases agree on every "
                f"rank's A, P and PT of ico7 on 4 ranks (row- and column-partitioned PT); "
                f"max abs err {errs}")
    return out, launches, errs


def sharded_mcf(pool, meshes, dev, backend="halo", phase="phase 15"):
    """Phase 15b (16b with backend "well"): ShardedMCFStepper (Jacobi, f32)
    on 4 ranks, MCF_SHARDED_STEPS steps, each held to one step of the
    single-device MCFStepper with Jacobi from the same input (the sharded
    flow's previous step): in f32 Jacobi does not reach the tolerance in
    20 cycles on these meshes, and two flows apart by that much would not
    solve the same system from the second step on. With "well", K1 is
    held to its plain version on every rank's G_l. Returns ({label:
    record}, launches summed over the ranks, K1 max abs errors)."""
    from surface_multigrid_code_torch import MCFStepper
    from surface_multigrid_code_torch.config import SmootherType, SolveConfig
    from surface_multigrid_code_torch.parallel.mcf import _barycentric_mass

    well = backend == "well"
    out, launches, errs = {}, {}, {}
    for name, subdivide in MCF_SHARDED:
        label = mcf_label(name, subdivide)
        V, F, mg = meshes[label]
        recs = pool.run(rank_mcf, 4, V, F, mg, MCF_SHARDED_STEPS, backend, well)
        what = f"{phase}: sharded MCF {label}" + (" (well)" if well else "")
        log(f"{what}: build s per rank {[r['build_s'] for r in recs]}, refresh ms per rank "
            f"{[r['refresh_ms'] for r in recs]}, levels (rank 0) {recs[0]['levels']}"
            + (f", G_l (rank 0) {recs[0]['chain']}" if well else ""))
        single = MCFStepper(V, F, mg, cfg=SolveConfig(smoother=SmootherType.JACOBI),
                            device=dev)
        inputs = [V] + [st["U"] for st in recs[0]["steps"][:-1]]
        ref = [single.step(U) for U in inputs]
        counts = ranks_held(recs, what, ("spmv_fused_planes",) + (("spmv_fused",) if well
                                                                    else ()))
        add_counts(launches, counts)
        steps = []
        for k, (rs, (U1, r1, ok1)) in enumerate(zip(recs[0]["steps"], ref)):
            b_norm = float(np.linalg.norm(_barycentric_mass(inputs[k], F)[:, None] * inputs[k]))
            gap = held_history(rs["residuals"], r1, b_norm, f"{what} step {k}")
            du = float(np.abs(rs["U"] - U1).max())
            if not np.isfinite(rs["U"]).all():
                raise RuntimeError(f"{what} step {k}: non-finite positions")
            steps.append({"cycles": len(rs["residuals"]) - 1,
                          "single_cycles": len(r1) - 1, "converged": rs["converged"],
                          "single_converged": ok1, "max_rel_gap": gap, "max_dU": du,
                          "wall_s": [r["steps"][k]["wall_s"] for r in recs]})
            log(f"{what} step {k} ({recs[0]['backend']}, 4 ranks sharing one card): "
                f"{steps[-1]['cycles']} cycles (single-device {steps[-1]['single_cycles']}), "
                f"residuals {rs['residuals'][0]:.4e} -> {rs['residuals'][-1]:.4e}, converged "
                f"{rs['converged']} / {ok1}, largest relative gap {gap:.2e}, max|dU| {du:.3e}; "
                f"step wall {max(steps[-1]['wall_s']):.3f} s")
        out[label] = {"nv": int(V.shape[0]), "levels": recs[0]["levels"], "steps": steps,
                      "launches_per_rank": counts, "build_s": [r["build_s"] for r in recs],
                      "refresh_ms": [r["refresh_ms"] for r in recs]}
        if well:
            out[label]["chain"] = [r["chain"] for r in recs]
            for r in recs:
                for k, e in r["errs"].items():
                    errs[k] = max(errs.get(k, 0.0), e)
            out[label]["kernel_cases"] = sum(r["cases"] for r in recs)
    return out, launches, errs


def balloon_refs(V, F, mg, dev):
    """The single-device counterparts of phases 15c and 16c at example
    06's defaults: the Newton direction at rest (BalloonNewtonSolver,
    Chebyshev) in f64 and f32, and one f64 implicit_euler_mg_balloon step."""
    from surface_multigrid_code_torch.config import SmootherType, SolveConfig
    from surface_multigrid_code_torch.models.balloon import (
        BalloonNewtonSolver,
        implicit_euler_mg_balloon,
        inflation_force,
    )

    d = balloon_defaults()
    dt = d["dt"]
    shell, M = balloon_shell(V, F, dev)
    fExt = inflation_force(V, F, d["pressure"])
    g = -(dt * shell.gradient(V.reshape(-1)) + dt * fExt)
    cfg = SolveConfig(smoother=SmootherType.CHEBYSHEV)
    ref = {}
    for name, dtype in (("f64", torch.float64), ("f32", torch.float32)):
        ns = BalloonNewtonSolver(shell, M, mg, cfg=cfg, dtype=dtype)
        vals = ns.hessian_values(V.reshape(-1), dt)
        ref[name] = ns.solver.solve(vals, g, tolerance=BALLOON_DIRECTION_TOL[name]
                                    * float(np.linalg.norm(g)), max_iter=20)
        if name == "f64":
            pos1, _, _ = implicit_euler_mg_balloon(
                shell, M, V.copy(), np.zeros(3 * V.shape[0]), fExt, dt, mg,
                mg_tolerance=d["mg_tolerance"], n_newton=d["n_newton"], newton_solver=ns,
                verbose=False)
            ref["step"] = (pos1, ns.last_newton)
        del ns
    return ref


def sharded_balloon(pool, V, F, mg, dev, ref, backend="halo", dtypes=("f64", "f32"),
                    gaps=(BALLOON_DIRECTION_GAP, BALLOON_STEP_GAP), phase="phase 15"):
    """Phase 15c (16c with backend "well"): ShardedBalloonNewton on 4
    ranks at example 06's defaults on bunny_15K: the Newton direction at
    rest against the single-device one of ``ref`` (``balloon_refs``) in
    f64 (held at gaps[0]) and, where dtypes has it, f32 (reported); then
    one f64 sharded step against the single-device step (held at gaps[1]),
    0 rejected iterations in both. With "well", K1 is held to its plain
    version on every rank's G_l. Returns (record, launches summed over the
    ranks, K1 max abs errors)."""
    well = backend == "well"
    recs = pool.run(rank_balloon, 4, V, F, mg, BALLOON_DIRECTION_TOL, backend, dtypes, well)
    what = f"{phase}: sharded balloon bunny_15K" + (" (well)" if well else "")
    out, launches, errs = {"dofs": 3 * int(V.shape[0])}, {}, {}
    for name in dtypes:
        per = [dict(r["by_dtype"][name], rank=r["rank"]) for r in recs]
        log(f"{what} {name}: build s per rank {[p['build_s'] for p in per]}, refresh ms per "
            f"rank {[p['refresh_ms'] for p in per]}"
            + (f", G_l (rank 0) {per[0]['chain']}" if well else ""))
        counts = ranks_held(per, f"{what} {name} direction", ("spmv_fused", "ns_sign_apply"))
        dx, r_his = per[0]["dx"], per[0]["residuals"]
        dx1, r1, _ = ref[name]
        gap = float(np.abs(dx - dx1).max() / np.abs(dx1).max())
        out[name] = {"cycles": len(r_his) - 1, "single_cycles": len(r1) - 1,
                     "residuals": r_his, "single_residuals": r1, "rel_gap": gap,
                     "launches_per_rank": counts, "solve_s": [p["solve_s"] for p in per],
                     "build_s": [p["build_s"] for p in per],
                     "refresh_ms": [p["refresh_ms"] for p in per]}
        if well:
            out[name]["chain"] = [p["chain"] for p in per]
        if "errs" in per[0]:
            for p in per:
                for k, e in p["errs"].items():
                    errs[k] = max(errs.get(k, 0.0), e)
            out[name]["kernel_cases"] = sum(p["cases"] for p in per)
        log(f"{what} {name} Newton direction at rest ({recs[0]['backend']}, 4 ranks sharing "
            f"one card): {len(r_his) - 1} cycles (single-device {len(r1) - 1}), residuals "
            f"{r_his[0]:.4e} -> {r_his[-1]:.4e}, relative max|dx - dx_single| {gap:.3e}; "
            f"solve wall {max(out[name]['solve_s']):.3f} s")
        add_counts(launches, counts)
        if name == "f64" and not gap <= gaps[0]:
            raise RuntimeError(f"{what}: f64 direction gap {gap:.3e} > {gaps[0]}")
    per = [dict(r["by_dtype"]["f64"], rank=r["rank"], counts=r["by_dtype"]["f64"]["step_counts"])
           for r in recs]
    counts = ranks_held(per, f"{what} step", ("spmv_fused", "ns_sign_apply"))
    add_counts(launches, counts)
    pos, newton = per[0]["pos"], per[0]["newton"]
    pos1, newton1 = ref["step"]
    disp = float(np.abs(pos1 - V).max())
    gap = float(np.abs(pos - pos1).max()) / disp
    rejected = [sum(not r["found"] for r in nw) for nw in (newton, newton1)]
    out["step"] = {"max_disp": disp, "rel_gap": gap, "rejected": rejected,
                   "residuals": [r["residuals"] for r in newton],
                   "single_residuals": [r["residuals"] for r in newton1],
                   "launches_per_rank": counts, "step_s": [p["step_s"] for p in per]}
    log(f"{what}: one f64 implicit-Euler step: max|disp| {disp:.6f}, relative gap to the "
        f"single-device step {gap:.3e}, rejected {rejected}, residuals per Newton solve "
        f"{out['step']['residuals']} (single-device {out['step']['single_residuals']}); "
        f"step wall {max(out['step']['step_s']):.3f} s (4 ranks sharing one card)")
    if not np.isfinite(pos).all() or any(rejected) or not gap <= gaps[1]:
        raise RuntimeError(f"{what}: step gap {gap:.3e} (limit {gaps[1]}), "
                           f"rejected {rejected}")
    return out, launches, errs


def sharded_pool(dev):
    """The RankPool of phase 15: 4 gloo ranks on dev's type of device
    (the card: all four share it), started ahead of the phase."""
    from surface_multigrid_code_torch.parallel.comm import RankPool

    return RankPool(max(SHARDED_RANKS), "gloo", dev.type)


def sharded_path(pool, V, mg, A, M, mcf_meshes, Vb, Fb, mg_b, dev):
    """Phase 15: the sharded paths on the 4 ranks of ``pool`` (D = 1 and 2
    on its subgroups). Returns ({"static", "mcf", "balloon", ...}, K1/K2/K4
    launches summed over the ranks, K1/K2 max abs errors of the rank
    checks)."""
    t0 = time.perf_counter()
    pool.run(rank_ready, max(SHARDED_RANKS))
    t_pool = time.perf_counter() - t0
    collectives = {}
    for D in SHARDED_RANKS[1:]:
        collectives[D] = pool.run(rank_collectives, D, (64, 4096, 65536), 100)[0]
        log(f"phase 15: gloo on CUDA tensors, {D} ranks sharing one card, ms per call: "
            + ", ".join(f"{k} {1e3 * v:.3f}" for k, v in collectives[D].items()))
    static, launches, errs = sharded_static(pool, V, mg, A, M, dev)
    mcf, l2, _ = sharded_mcf(pool, mcf_meshes, dev)
    refs = balloon_refs(Vb, Fb, mg_b, dev)
    balloon, l3, _ = sharded_balloon(pool, Vb, Fb, mg_b, dev, refs)
    add_counts(launches, (l2, l3))
    wall = time.perf_counter() - t0
    log(f"phase 15: {wall:.1f} s (the pool of 4 gloo ranks on one card, started before phase "
        f"14, ready {t_pool:.1f} s into it); "
        f"launches summed over ranks {launches}")
    return {"static": static, "mcf": mcf, "balloon": balloon, "wall_s": wall,
            "pool_start_s": t_pool, "collectives_s": collectives,
            "note": "D ranks share one card over gloo; the walls say nothing about scaling"}, \
        launches, errs, refs


# ---------------------------------------------------------------- phase 16
# The band-segment halo hierarchy (parallel/wellhalo.py, the JAX package's
# default multi-device backend) and the GSPMD layout (parallel/spmd.py) on
# phase 15's pool. Each static run is held to the single-device solve and
# to phase 15's HaloHierarchy run of the same (smoother, D, C) by phase
# 15's bars (held_history); the MCF steps as in phase 15; the balloon's
# f64 direction at rest at WELL_DIRECTION_GAP of the single-device one and
# its f64 step at WELL_STEP_GAP of max|disp| (one algorithm: the sharded
# refresh sums in another order, its Chebyshev bound is the same power
# iteration), 0 rejects. K1 is held to its plain version on every rank's
# G_l of the MCF and balloon chains, and K1/K2 on every rank's A, P and Pᵀ
# of the D = 4 Jacobi and spmd runs.
WELL_RANKS = (2, 4)
WELL_DIRECTION_GAP = 1e-12
WELL_STEP_GAP = 1e-10
SHIFT_SIZES = (64, 4096, 65536)


def well_static(pool, V, mg, A, M, p15):
    """Phase 16a: WellHaloHierarchy on D = 2 and 4 ranks (Jacobi,
    Chebyshev), [n, 3] on 4 (Jacobi), and sharded_solve (spmd, Jacobi) on
    4, each held to the single-device solve and to phase 15's run (the
    records ``p15``)."""
    As, Ps = ico_chain(mg, A)
    b = np.asarray(M @ V[:, 0])
    runs = [("well", sm, D, b) for sm in ("jacobi", "chebyshev") for D in WELL_RANKS]
    runs += [("well", "jacobi", 4, np.stack([b, -2.0 * b, 0.5 * b], axis=1)),
             ("spmd", "jacobi", 4, b)]
    by_key = {(r["smoother"], r["ranks"], r["C"]): r for r in p15}
    out, launches, errs = [], {}, {}
    for backend, sm, D, rhs in runs:
        C = 1 if rhs.ndim == 1 else rhs.shape[1]
        b_norm = float(np.linalg.norm(rhs))
        tol = REL_TOL * b_norm
        check = backend == "spmd" or (sm == "jacobi" and D == 4 and C == 1)
        recs = pool.run(rank_static, D, As, Ps, sm, rhs, tol, check, backend)
        what = f"phase 16: ico7 {backend} {sm} C={C} on {D} ranks"
        ref = by_key[sm, D, C]
        r_his = recs[0]["residuals"]
        rec = {"backend": backend, "smoother": sm, "ranks": D, "C": C, "residuals": r_his,
               "single_device": ref["single_device"], "phase15": ref["residuals"],
               "build_s": [r["build_s"] for r in recs], "solve_s": [r["solve_s"] for r in recs],
               "phase15_solve_s": ref["solve_s"], "levels": recs[0]["levels"],
               "bytes_per_exchange": [[lv["bytes_per_exchange"] for lv in r["levels"]]
                                      for r in recs],
               "bytes_per_cycle": [[lv["bytes_per_cycle"] for lv in r["levels"]] for r in recs],
               "collectives_per_cycle": recs[0]["collectives_per_cycle"],
               "phase15_collectives_per_cycle": ref["collectives_per_cycle"]}
        # what the run sent and how long it took, before its checks
        log(f"{what} ({recs[0]['backend']}, {D} ranks sharing one card): residuals "
            f"{r_his[0]:.4e} -> {r_his[-1]:.4e} in {len(r_his)}, single-device "
            f"{len(ref['single_device'])}, phase 15 {len(ref['residuals'])}; solve wall "
            f"{max(rec['solve_s']):.3f} s (phase 15 {max(ref['solve_s']):.3f} s), build "
            f"{max(rec['build_s']):.2f} s a rank")
        if C == 1 and sm == "jacobi":
            log(f"{what}: collectives per V-cycle {rec['collectives_per_cycle']} (phase 15 "
                f"{rec['phase15_collectives_per_cycle']})")
            for lv, level in enumerate(rec["levels"]):
                log(f"{what} level {lv}: R {level['R']}, {level['mode']}, lo {level['lo']} "
                    f"hi {level['hi']}, bytes per exchange by rank "
                    f"{[bs[lv] for bs in rec['bytes_per_exchange']]}, per V-cycle "
                    f"{[bs[lv] for bs in rec['bytes_per_cycle']]}")
        counts = ranks_held(recs, what, (kernel_name(C),))
        gap = held_history(r_his, ref["single_device"], b_norm, f"{what} (one device)")
        gap15 = held_history(r_his, ref["residuals"], b_norm, f"{what} (phase 15)")
        z = recs[0]["z"]
        res = float(np.linalg.norm(A @ z - rhs))
        if z.shape != rhs.shape or not np.isfinite(z).all() or not res <= 2 * tol:
            raise RuntimeError(f"{what}: bad solution (residual {res:.3e}, tol {tol:.3e})")
        add_counts(launches, counts)
        rec.update(max_rel_gap=gap, max_rel_gap_phase15=gap15, host_residual=res,
                   launches_per_rank=counts)
        log(f"{what}: largest relative gap {gap:.2e} (one device), {gap15:.2e} (phase 15); "
            f"K1/K2 launches per rank {counts}")
        if check:
            for r in recs:
                for name, e in r["errs"].items():
                    errs[name] = max(errs.get(name, 0.0), e)
            rec["kernel_cases"] = sum(r["cases"] for r in recs)
            log(f"{what}: K1/K2 {rec['kernel_cases']} kernel-vs-plain cases agree on every "
                f"rank's A, P and PT; max abs err {errs}")
        out.append(rec)
    return out, launches, errs


def well_path(pool, V, mg, A, M, mcf_meshes, Vb, Fb, mg_b, dev, p15, refs):
    """Phase 16: the "well" backend and spmd on phase 15's pool (module
    comment above). Returns (record, K1/K2/K4 launches summed over the
    ranks, K1/K2 max abs errors)."""
    t0 = time.perf_counter()
    shift = {}
    for D in WELL_RANKS:
        shift[D] = pool.run(rank_collectives, D, SHIFT_SIZES, 100, ("shift",))[0]
        log(f"phase 16: gloo on CUDA tensors (segments staged through the host), {D} ranks "
            "sharing one card, ms per call: "
            + ", ".join(f"{k} {1e3 * v:.3f} (exchange "
                        f"{1e3 * p15['collectives_s'][D][k.replace('shift', 'exchange')]:.3f})"
                        for k, v in shift[D].items()))
    static, launches, errs = well_static(pool, V, mg, A, M, p15["static"])
    mcf, l2, e2 = sharded_mcf(pool, mcf_meshes, dev, "well", "phase 16")
    for label, rec in mcf.items():
        log(f"phase 16: sharded MCF {label} (well): refresh ms per rank {rec['refresh_ms']} "
            f"(phase 15, replicated: {p15['mcf'][label]['refresh_ms']}); build s per rank "
            f"{rec['build_s']} (phase 15 {p15['mcf'][label]['build_s']}); K1 "
            f"{rec['kernel_cases']} kernel-vs-plain cases agree on every rank's G_l")
    balloon, l3, e3 = sharded_balloon(pool, Vb, Fb, mg_b, dev, refs, "well", ("f64",),
                                      (WELL_DIRECTION_GAP, WELL_STEP_GAP), "phase 16")
    f64, f64_15 = balloon["f64"], p15["balloon"]["f64"]
    log(f"phase 16: sharded balloon bunny_15K (well, f64): refresh ms per rank "
        f"{f64['refresh_ms']} (phase 15, replicated: {f64_15['refresh_ms']}); build s per "
        f"rank {f64['build_s']} (phase 15 {f64_15['build_s']}); K1 {f64['kernel_cases']} "
        f"kernel-vs-plain cases agree on every rank's G_l")
    add_counts(launches, (l2, l3))
    for e in (e2, e3):
        for name, v in e.items():
            errs[name] = max(errs.get(name, 0.0), v)
    wall = time.perf_counter() - t0
    log(f"phase 16: {wall:.1f} s; launches summed over ranks {launches}; K1/K2 max abs err "
        f"{errs}")
    return {"static": static, "mcf": mcf, "balloon": balloon, "wall_s": wall,
            "shift_s": shift,
            "note": "D ranks share one card over gloo; the walls say nothing about scaling"}, \
        launches, errs


# ------------------------------------------- opt-in runs: --gloo-p2p, --nccl
def rank_p2p(dev, n):
    """A rank of the gloo point-to-point probe: rank 0 sends n floats of a
    tensor on its device to rank 1 (isend / irecv in one batch); rank 1
    returns whether what arrived in its tensor on the device is what was
    sent."""
    import torch.distributed as dist

    rank = dist.get_rank()
    x = torch.arange(n, dtype=torch.float32, device=dev) + 1.0
    buf = torch.zeros(n, dtype=torch.float32, device=dev)
    op = (dist.P2POp(dist.isend, x, 1) if rank == 0 else dist.P2POp(dist.irecv, buf, 0))
    for req in dist.batch_isend_irecv([op]):
        req.wait()
    sync()
    return bool(torch.equal(buf, x)) if rank == 1 else None


def gloo_p2p() -> int:
    """``python3 chip_smoke.py --gloo-p2p``: do gloo's point-to-point
    operations take CUDA tensors? (``Comm.shift`` stages its segments
    through host memory under gloo because they are documented for CPU
    tensors only.) Two gloo ranks on the card in processes of their own;
    prints what happened: the data arrived, arrived wrong, a rank raised,
    or the ranks gave no result in 60 s."""
    from surface_multigrid_code_torch.parallel.comm import spawn_ranks

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    log(card_line())
    with tempfile.TemporaryDirectory() as tmp:
        ranks = spawn_ranks(rank_p2p, 2, "gloo", "cuda", os.path.join(tmp, "rendezvous"), 4096)
        try:
            got = ranks.join(timeout=60)[1]
            verdict = "arrived intact" if got else "arrived wrong"
        except RuntimeError as e:  # the probe's answer, not a check
            verdict = "failed: " + str(e).strip().splitlines()[-1]
    log(json.dumps({"gloo_p2p_cuda": verdict, "floats": 4096}))
    return 0


def trajectory_run() -> int:
    """``python3 chip_smoke.py --trajectory``: the bunny_15K balloon at
    example 06's defaults for TRAJ_STEPS steps three ways, each step's
    max|disp| against the JAX package's record (TRAJ_RECORD): run_balloon
    (the BSR multigrid) in f32 and in f64 on the card, and the direct f64
    trajectory from rest (``implicit_euler_balloon_direct``, host splu,
    PSD-projected; about 15 s a step); then the direct step from the f32
    run's own state at a few steps. The evidence behind TRAJ_GAP,
    TRAJ_HELD and LATE_ORACLE_STEPS; prints a ``trajectory`` JSON line."""
    from surface_multigrid_code_torch import _build, mg_precompute
    from surface_multigrid_code_torch.models.balloon import (
        implicit_euler_balloon_direct,
        inflation_force,
        run_balloon,
    )
    from surface_multigrid_code_torch.utils.obj_io import read_obj
    from surface_multigrid_code_torch.utils.paths import mesh_path

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    dev = torch.device("cuda", 0)
    log(card_line())
    _build.load_library()
    V, F = read_obj(mesh_path(BALLOON_MESH))
    record = trajectory_record()["max_disp_per_step"]
    mg = mg_precompute(V, F, verbose=False)
    d = balloon_defaults()
    shell, M = balloon_shell(V, F, dev)

    def direct_step(cur, qd):
        return implicit_euler_balloon_direct(
            shell, M, cur, qd, inflation_force(cur, F, d["pressure"]), d["dt"],
            n_newton=d["n_newton"], verbose=False, psd_project=True)

    out, states = {"record": record}, None
    for name, dtype in (("multigrid_f32", torch.float32), ("multigrid_f64", torch.float64)):
        stats = []
        pos = list(run_balloon(V, F, n_steps=TRAJ_STEPS, mg=mg, device=dev, stats=stats,
                               verbose=False, dtype=dtype))
        out[name] = [float(np.abs(p - V).max()) for p in pos]
        out[name + "_rejects"] = [s["last_rejected"] for s in stats]
        states = states or [(p, s["qdot"]) for p, s in zip(pos, stats)]
    cur, qd, direct = V, np.zeros(V.size), []
    for k in range(TRAJ_STEPS):
        cur, qd = direct_step(cur, qd)
        direct.append(float(np.abs(cur - V).max()))
        log(f"step {k}: max|disp| direct f64 {direct[k]:.6f}, against the record "
            f"{record[k]:.5f}: {(direct[k] - record[k]) / record[k]:+.4f}; multigrid f32 "
            f"{out['multigrid_f32'][k]:.6f}: {(out['multigrid_f32'][k] - record[k]) / record[k]:+.4f}"
            f" to the record, {(out['multigrid_f32'][k] - direct[k]) / direct[k]:+.4f} to the "
            f"direct; multigrid f64 {out['multigrid_f64'][k]:.6f}")
    out["direct"] = direct
    out["direct_from_multigrid_state"] = {}
    for k in (9, *LATE_ORACLE_STEPS):
        pd, _ = direct_step(*states[k - 1])
        dd = float(np.abs(pd - V).max())
        out["direct_from_multigrid_state"][k] = dd
        log(f"step {k} from the f32 multigrid's state {k - 1}: direct f64 {dd:.6f}, multigrid "
            f"{out['multigrid_f32'][k]:.6f} ({(out['multigrid_f32'][k] - dd) / dd:+.2e})")
    log(json.dumps({"trajectory": out, "mesh": BALLOON_MESH}))
    return 0


def nccl_run() -> int:
    """``python3 chip_smoke.py --nccl`` on a machine with 4 cards: phase
    16's static ico7 solve with one rank per card over NCCL
    (``ranks_static``)."""
    from surface_multigrid_code_torch import _build

    if torch.cuda.device_count() < 4:
        raise RuntimeError(f"--nccl needs 4 cards, found {torch.cuda.device_count()}")
    log(card_line())
    _build.load_library()
    V, F, mg, A, M, t_mg = ico_system(7)
    out = ranks_static(V, mg, A, M, "nccl", torch.device("cuda", 0))
    log(json.dumps({"nccl": out}))
    return 0


def ranks_static(V, mg, A, M, backend, dev):
    """The collectives (shift / exchange / allreduce ms on 2 and 4 ranks),
    then the static solve with HaloHierarchy, WellHaloHierarchy and spmd on
    2 and 4 ranks (Jacobi) and WellHaloHierarchy (Chebyshev), on a pool of
    4 ranks over ``backend`` on dev's type of device (``cuda``: one rank a
    card), each held to the single-device solve on dev by phase 15's bars.
    Returns the records."""
    from surface_multigrid_code_torch.config import SmootherType, SolveConfig
    from surface_multigrid_code_torch.parallel.comm import RankPool
    from surface_multigrid_code_torch.solver.vcycle import build_device_hierarchy, solve_loop

    As, Ps = ico_chain(mg, A)
    b = np.asarray(M @ V[:, 0])
    b_norm = float(np.linalg.norm(b))
    tol = REL_TOL * b_norm
    single = {}
    for sm in ("jacobi", "chebyshev"):
        cfg = SolveConfig(smoother=SmootherType(sm))
        hier = build_device_hierarchy(As, Ps, cfg, device=dev, dtype=torch.float32)
        rt = torch.as_tensor(b, dtype=torch.float32, device=dev)
        solve_loop(hier, rt, torch.zeros_like(rt), tol, 20, cfg)
        (_, r, k), wall = timed(lambda: solve_loop(hier, rt, torch.zeros_like(rt), tol, 20, cfg))
        single[sm] = ([float(x) for x in r[:k].cpu()], wall)
    out = {"single_device": single, "runs": [], "collectives_s": {}}
    with RankPool(4, backend, dev.type) as pool:
        pool.run(rank_ready, 4)
        for D in WELL_RANKS:
            c = pool.run(rank_collectives, D, SHIFT_SIZES, 100,
                         ("exchange", "allreduce_sum", "shift"))[0]
            out["collectives_s"][D] = c
            log(f"{backend}: {D} ranks, ms per call: "
                + ", ".join(f"{k} {1e3 * v:.3f}" for k, v in c.items()))
        runs = [(kind, "jacobi", D) for kind in ("halo", "well", "spmd") for D in WELL_RANKS]
        runs += [("well", "chebyshev", D) for D in WELL_RANKS]
        for kind, sm, D in runs:
            recs = pool.run(rank_static, D, As, Ps, sm, b, tol, False, kind)
            what = f"{backend}: ico7 {kind} {sm} on {D} ranks"
            ranks_held(recs, what, ("spmv_fused",))
            r_his = recs[0]["residuals"]
            gap = held_history(r_his, single[sm][0], b_norm, what)
            res = float(np.linalg.norm(A @ recs[0]["z"] - b))
            if not res <= 2 * tol:
                raise RuntimeError(f"{what}: residual {res:.3e}, tol {tol:.3e}")
            rec = {"backend": kind, "smoother": sm, "ranks": D, "residuals": r_his,
                   "max_rel_gap": gap, "solve_s": [r["solve_s"] for r in recs],
                   "build_s": [r["build_s"] for r in recs],
                   "collectives_per_cycle": recs[0]["collectives_per_cycle"],
                   "bytes_per_cycle": [[lv["bytes_per_cycle"] for lv in r["levels"]]
                                       for r in recs]}
            out["runs"].append(rec)
            log(f"{what} ({recs[0]['backend']}): {len(r_his)} residuals (single-device "
                f"{len(single[sm][0])}), largest relative gap {gap:.2e}; solve wall "
                f"{max(rec['solve_s']):.4f} s (single-device {single[sm][1]:.4f} s); "
                f"collectives per V-cycle {rec['collectives_per_cycle']}")
    return out


# ---------------------------------------------------------------- main

def ptxas_functions(report):
    """Per kernel of the build's ``-Xptxas -v`` report (lines): {mangled
    name: {"registers", "spill_stores", "spill_loads", "stack",
    "static_smem"}} in bytes (K5's shared memory is dynamic: phase 13
    prints it)."""
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
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            out[name]["static_smem"] = int(m.group(1))
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
    from surface_multigrid_code_torch.ops.spmv import fused_spmv

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
    walk_regs = {name: rep for name, rep in ptxas_functions(report).items()
                 if "query_walk" in name}
    for name, rep in {**sign_regs, **walk_regs}.items():
        log(f"  ptxas {name}: {rep}")

    V, F, mg, A, M, t_mg = ico_system(depth)
    log(f"host: ico{depth} |V| {V.shape[0]} |F| {F.shape[0]}, mg_precompute {t_mg:.2f} s, "
        f"levels {[lv.V.shape[0] for lv in mg]}")

    # phase 3: kernels against their plain versions (K4 follows phase 7,
    # at the pose the balloon reaches)
    from surface_multigrid_code_torch import mg_precompute
    from surface_multigrid_code_torch.utils.obj_io import read_obj
    from surface_multigrid_code_torch.utils.paths import mesh_path

    errs = check_kernels(A, mg, dev)
    Vb, Fb = read_obj(mesh_path(BALLOON_MESH))
    t0 = time.perf_counter()
    mg_b = mg_precompute(Vb, Fb, verbose=False)
    log(f"host: {BALLOON_MESH} |V| {Vb.shape[0]} |F| {Fb.shape[0]}, mg_precompute "
        f"{time.perf_counter() - t0:.2f} s, levels {[lv.V.shape[0] for lv in mg_b]}")
    errs.update(check_block_kernels(Vb, Fb, mg_b, dev))

    counters = kernel_counters()

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
    mcf, mcf_steppers, mcf_meshes = mcf_path(MCF_MESHES, dev)
    mcf_counts = read_counts("phase 10", ("spmv_fused_planes",))
    check_mcf_kernels(mcf_steppers, dev, errs)
    del mcf_steppers
    mcf_t, k2_mcf = run_child("mcf", {})
    shapes.append(k2_mcf)

    # phase 7: the balloon path, counted
    reset_counts()
    positions, stats, bsum = balloon_path(Vb, Fb, mg_b, dev)
    balloon = read_counts("phase 7", ("spmv_fused_planes", "bsr_spmv", "ns_sign_apply"))
    k4_errs, edge = check_sign_kernel(Vb, Fb, positions[BALLOON_STEPS - 1], dev)
    errs.update(k4_errs)

    # phase 8: the balloon against the direct f64 oracle
    bsum["oracle_gap"], direct, bsum["direct_record_gap"], bsum["late_oracle_gap"] = (
        balloon_oracle(Vb, Fb, positions, stats, dev))

    # phase 12: the balloon's scalar cross-check, counted, then K1 at its shapes
    reset_counts()
    scalar, ns, mg_block, scalar_pos = scalar_balloon(Vb, Fb, direct[0], dev)
    scalar["launches"] = read_counts("phase 12", ("spmv_fused", "ns_sign_apply"))
    check_scalar_kernels(ns, Vb, dev, errs)
    bsum["scalar"] = scalar
    del ns

    # phase 17: DeviceBalloonStepper on phase 12's hierarchy, counted; then
    # its host syncs a step
    reset_counts()
    dstep, stepper = device_stepper(Vb, Fb, mg_block, direct[0], positions, scalar_pos, dev)
    dstep["launches"] = read_counts("phase 17", ("spmv_fused", "ns_sign_apply"))
    dstep["syncs"] = step_syncs(stepper, Vb, Fb, mg_block)
    del stepper
    launches = {name: static[name] + mcf_counts[name] + balloon[name]
                + scalar["launches"][name] + dstep["launches"][name] for name in counters}

    # phase 9: balloon and K3/K4 timing, in a process of its own
    bal, bker, bshapes, signs = run_child("balloon", {
        "pos": positions[BALLOON_STEPS - 1], "qdot": stats[BALLOON_STEPS - 1]["qdot"]})
    ker.update(bker)

    # phase 18: the balloon at 252,834 vertices, counted in a process of its own
    large = run_child("balloon-large", {})
    for name, n in large["launches"].items():
        launches[name] += n
    for name, e in large["errs"].items():
        errs[name] = max(errs.get(name, 0.0), e)

    # phase 13: queries (K5), counted, then K5 against its plain version
    # and the host walk, and timed
    Vq, Fq, Vqc, Fqc, qlog, t_dec = query_system(QUERY_DEPTH)
    log(f"host: ico{QUERY_DEPTH} |F| {Fq.shape[0]} decimated to |F| {Fqc.shape[0]} in "
        f"{t_dec:.2f} s: {qlog['voff'].shape[0] - 1} collapse records")
    t13 = time.perf_counter()
    reset_counts()
    queries, examples = query_path(Vq, Fq, Vqc, Fqc, qlog, dev)
    launches["query_walk"] = read_counts("phase 13", ("query_walk",))["query_walk"]
    errs["query_walk"], walk_checks = check_query_kernel(Vq, Fq, Vqc, Fqc, qlog, dev)
    drum_err, walk_checks["drum"] = check_drum(dev)
    errs["query_walk"] = max(errs["query_walk"], drum_err)
    walk_t = query_timings(Fq, Fqc, qlog, queries, dev)
    walk_t["public_call"] = public_call_parts(Fq, qlog, dev)
    del qlog
    ker["query_walk"] = {"kernel": walk_t[QUERY_CHECK_N]["ms"],
                         "plain": walk_t[QUERY_CHECK_N]["plain_ms"],
                         "bound": walk_t[QUERY_CHECK_N]["bound_ms"],
                         "bound_by": walk_t[QUERY_CHECK_N]["bound_by"], "library": None,
                         "kernel_call": 1e3 * queries[QUERY_CHECK_N]["device_call_s"],
                         "plain_call": walk_t[QUERY_CHECK_N]["plain_ms"]}
    t13 = time.perf_counter() - t13

    # the ranks of phase 15 start up while phase 14 runs
    pool = sharded_pool(dev)

    # phase 14: persistence and the CLI on the card, counted
    t14 = time.perf_counter()
    reset_counts()
    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".scratch")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        persisted = persistence_path(datas[SmootherType.JACOBI], V, F, mg, A, M, Vb, Fb, mg_b,
                                     tmp, dev)
        clis = cli_path(tmp)
    p14 = read_counts("phase 14", ("spmv_fused", "spmv_fused_planes", "bsr_spmv"))
    for name in ("spmv_fused", "spmv_fused_planes", "bsr_spmv"):
        launches[name] += p14[name]
    t14 = time.perf_counter() - t14
    log(f"phases 13-14: {t13:.1f} s, {t14:.1f} s")

    # phase 19: the bench, as a user runs it, in a process of its own (its
    # launches are its own counts; it builds and caches the ico9
    # hierarchy), and entry()'s V-cycle, counted; phase 20:
    # K1/K2 at the bench's ico9 shapes, in a process of its own
    bench_rec, bench_wall = bench_path()
    for name, n in bench_rec["detail"]["launches"].items():
        launches[name] += n
    entry_rec = entry_path(dev)
    launches["spmv_fused"] += entry_rec["launches"]["spmv_fused"]
    t20 = time.perf_counter()
    ico9 = run_child("ico9", {})
    for name, e in ico9["errs"].items():
        errs[name] = max(errs[name], e)
    t20 = time.perf_counter() - t20

    # phase 21: the K4 probes (psd_precision, psd_stages), in a process of
    # its own; phase 20's child ran the K1 probes
    t21 = time.perf_counter()
    k4p = run_child("k4-probes", {"pos": positions[BALLOON_STEPS - 1]})
    t21 = time.perf_counter() - t21
    probes = probe_rows(ico9["probes"], k4p)
    log(f"phases 20-21: {t20:.1f} s, {t21:.1f} s")

    # phase 15: the sharded paths, on ranks that share the card; each rank
    # sets its counts to 0 just before its path and reads them just after
    with pool:
        sharded, sh_launches, sh_errs, refs = sharded_path(pool, V, mg, A, M, mcf_meshes, Vb,
                                                           Fb, mg_block, dev)
        # phase 16: the band-segment backend and spmd, on the same ranks
        well, w_launches, w_errs = well_path(pool, V, mg, A, M, mcf_meshes, Vb, Fb, mg_block,
                                             dev, sharded, refs)
    del mcf_meshes, mg_block, refs
    for counts, errors in ((sh_launches, sh_errs), (w_launches, w_errs)):
        for name, n in counts.items():
            if name in launches:
                launches[name] += n
        for name, e in errors.items():
            errs[name] = max(errs[name], e)

    log(card)
    log(json.dumps({"spmv_shapes": shapes, "mesh": f"icosphere({depth})", "dtype": "float32"}))
    log(json.dumps({"vcycle": vc, "mesh": f"icosphere({depth})", "dtype": "float32"}))
    log(json.dumps({"balloon": {**bsum, **bal}, "mesh": BALLOON_MESH, "dtype": "float32",
                    "launches": balloon}))
    log(json.dumps({"bsr_shapes": bshapes, "mesh": BALLOON_MESH, "dtype": "float32"}))
    log(json.dumps({"device_stepper": dstep, "mesh": BALLOON_MESH, "dtype": "float32",
                    "smoother": "multicolor_gs"}))
    log(json.dumps({"balloon_large": large, "mesh": f"{BALLOON_MESH} midpoint-subdivided twice",
                    "dtype": "float32"}))
    log(json.dumps({"mcf": {label: {**rec, **mcf_t[label]} for label, rec in mcf.items()},
                    "dtype": "float32", "tol": MCF_TOL, "exact_gap": MCF_EXACT_GAP,
                    "launches": mcf_counts, "k2_color_shape": k2_mcf}))
    log(json.dumps({"sign_shapes": signs, "mesh": BALLOON_MESH, "ptxas": sign_regs,
                    "edge_eigs": {"eigenvalues": EDGE_EIGS, "least_eig_and_distance": edge}}))
    log(json.dumps({"queries": {"by_n": queries, "k5": walk_t, "checks": walk_checks,
                                "examples": examples, "ptxas": walk_regs},
                    "mesh": f"icosphere({QUERY_DEPTH}) to F/64, dec_type 1", "dtype": "float32"}))
    log(json.dumps({"persistence": persisted, "cli": clis}))
    log(json.dumps({"bench": bench_rec, "bench_wall_s": bench_wall, "entry": entry_rec}))
    log(json.dumps({"spmv_shapes_ico9": ico9["shapes"], "mesh": "icosphere(9), induced-RCM",
                    "dtype": "float32", "host_s": ico9["host_s"]}))
    log(json.dumps({"sharded": sharded, "dtype": "float32 (the balloon direction and step: "
                    "float64 and float32)", "launches": sh_launches}))
    log(json.dumps({"well": well, "dtype": "float32 (the balloon direction and step: "
                    "float64)", "launches": w_launches}))
    # ms / plain_ms / library_ms: device time per call (profiler, L2 warm:
    # back-to-back calls on inputs that fit in L2), at ico7 level-0 A (K1,
    # K2), the bunny_15K level-0 block Hessian (K3) and its 31,604 face
    # blocks (K4); call_ms / plain_call_ms: per call between CUDA events over
    # back-to-back calls, host included; bound_ms: from this run's shapes at
    # the H100's HBM and f32 peaks; launches: the counted paths together
    # (phases 4-5, 10, 7, 12, 17, 18, 13 and 14, and every rank of phases
    # 15 and 16). query_walk (K5): ms is the
    # kernel's CUDA-event time at QUERY_CHECK_N f2c queries, plain_ms and
    # plain_call_ms the plain version's wall per call there, call_ms the
    # wall of query_fine_to_coarse_device (transfers included)
    #
    # The probe kernels (phases 20-21; on no path of the port): launches
    # from the probes' counted measurements; the times as above (utils.
    # timing, medians over the probe's turns), at the shape probe_rows
    # names: L2 warm except ico9's A_0 (bf16 values, staged x); bound_ms
    # at the TF32 and bf16 tensor-core peaks for the tensor-core kernels
    sources = {**{n: (SOURCE, rep) for n, rep in KERNELS.items()}, **BLOCK_KERNELS,
               "query_walk": QUERY_KERNEL}
    rows = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": ker[name]["kernel"], "plain_ms": ker[name]["plain"],
         "bound_ms": ker[name]["bound"], "bound_by": ker[name]["bound_by"],
         "library_ms": ker[name]["library"],
         "call_ms": ker[name]["kernel_call"], "plain_call_ms": ker[name]["plain_call"]}
        for name, (src, rep) in sources.items()
    ]
    rows += [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": probes[name]["launches"], "max_abs_err": probes[name]["max_abs_err"],
         "ms": probes[name]["kernel"], "plain_ms": probes[name]["plain"],
         "bound_ms": probes[name]["bound"], "bound_by": probes[name]["bound_by"],
         "library_ms": probes[name]["library"], "call_ms": probes[name]["kernel_call"],
         "plain_call_ms": probes[name]["plain_call"]}
        for name, (src, rep) in PROBE_KERNELS.items()
    ]
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        sys.exit(child(sys.argv[2]))
    if sys.argv[1:2] == ["--gloo-p2p"]:
        sys.exit(gloo_p2p())
    if sys.argv[1:2] == ["--nccl"]:
        sys.exit(nccl_run())
    if sys.argv[1:2] == ["--trajectory"]:
        sys.exit(trajectory_run())
    sys.exit(main())
