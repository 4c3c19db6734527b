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
- the balloon (``models.balloon.run_balloon``, example 06 at its
  defaults) for 3 steps on bunny_15K and 1 step on the midpoint-subdivided
  bunny, held against the host sparse-LU oracle.

It times V-cycles, balloon steps and kernels against the plain versions,
and ends with

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}

Any failure raises, so the exit code is non-zero and that line is not
printed. Without a CUDA device it fails at once.
"""

from __future__ import annotations

import contextlib
import copy
import json
import subprocess
import sys
import time

import numpy as np
import torch

EPIS = (None, "axpby", "resid", "add", "resid_scaled")
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
KERNELS = {
    # name: (C of its calls, file:line of the TPU kernel it replaces)
    "spmv_fused": (1, "surface_multigrid_code_tpu/ops/well.py:871"),
    "spmv_fused_planes": (3, "surface_multigrid_code_tpu/ops/well.py:1598"),
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
# Relative tolerance of the plain f32 ico solves. Their f32 residual floor
# is about 1.5e-5 ||b||: ||b - Az|| is a strongly cancelling difference
# (|A||z| is ~1000x the residual scale). 1e-4 ||b|| sits above that floor;
# tighter tolerances are the refinement path's, run in phase 5.
REL_TOL = 1e-4


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

def check_kernels(A, P, dev, seed=0):
    """Every epilogue, C in {1, 3}, f32 and f64, on A, P and PT, plus a GS
    color-subset call: kernel vs plain version on the same device inputs.
    Returns {kernel name: max abs error}."""
    from surface_multigrid_code_torch.ops.smoothers import color_groups, greedy_coloring
    from surface_multigrid_code_torch.ops.sparse import csr_from_scipy
    from surface_multigrid_code_torch.ops.spmv import fused_spmv, fused_spmv_plain

    rng = np.random.default_rng(seed)
    ops = {"A": A, "P": P, "PT": P.T.tocsr()}
    errs = {name: 0.0 for name in KERNELS}
    n_cases = 0
    before = fused_spmv.launches
    for dt in (torch.float32, torch.float64):
        def t(a):
            return torch.as_tensor(a).to(dev, dt)

        for name, S in ops.items():
            Sd = csr_from_scipy(S, dev, dt)
            n, m = S.shape
            s = t(1.0 / A.diagonal()) if name == "A" else t(rng.uniform(0.5, 2.0, n))
            for C in (1, 3):
                shp = (n,) if C == 1 else (n, C)
                x = t(rng.standard_normal((m,) if C == 1 else (m, C)))
                u, b = t(rng.standard_normal(shp)), t(rng.standard_normal(shp))
                for epi in EPIS:
                    kw = dict(epi=epi, b=b, u=u, s=s, escale=2.0 / 3.0)
                    y = fused_spmv(Sd, x, **kw)
                    ref = fused_spmv_plain(Sd, x, **kw)
                    _compare(y, ref, dt, f"{name} C={C} epi={epi} {dt}", errs,
                             kernel_name(C))
                    n_cases += 1
        # one GS color-subset update, in place, per column count
        Ad = csr_from_scipy(A, dev, dt)
        dinv = t(1.0 / A.diagonal())
        rows = torch.as_tensor(color_groups(greedy_coloring(A))[0], device=dev)
        for C in (1, 3):
            shp = (A.shape[0],) if C == 1 else (A.shape[0], C)
            u0, b = t(rng.standard_normal(shp)), t(rng.standard_normal(shp))
            uk, up = u0.clone(), u0.clone()
            fused_spmv(Ad, uk, epi="axpby", u=uk, b=b, s=dinv, rows=rows, out=uk)
            fused_spmv_plain(Ad, up, epi="axpby", u=up, b=b, s=dinv, rows=rows, out=up)
            _compare(uk, up, dt, f"GS rows C={C} {dt}", errs, kernel_name(C))
            n_cases += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        if fused_spmv.launches <= before:
            raise RuntimeError("fused_spmv.launches did not grow")
    log(f"phase 3: {n_cases} kernel-vs-plain cases agree; max abs err {errs}")
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


def other_shapes(depth, V, A, M, gs_data, dev):
    """Phase 5: constrained ogre (ex03), [n, 3] right-hand side, ex04 with refinement."""
    from surface_multigrid_code_torch import mg_precompute, min_quad_with_fixed_mg_precompute
    from surface_multigrid_code_torch.ops.laplacian import cotmatrix, massmatrix
    from surface_multigrid_code_torch.utils.mesh import boundary_vertices, normalize_unit_area
    from surface_multigrid_code_torch.utils.obj_io import read_obj
    from surface_multigrid_code_torch.utils.paths import mesh_path

    # ex03 shape: ogre, boundary known (zero), A = -L, B = M 1 with B(b) = 0
    Vo, Fo = read_obj(mesh_path("ogre"))
    Vo = normalize_unit_area(Vo, Fo)
    mg_o = mg_precompute(Vo, Fo, verbose=False)
    Ao = (-cotmatrix(Vo, Fo)).tocsr()
    bo = boundary_vertices(Fo)
    Bo = np.asarray(massmatrix(Vo, Fo) @ np.ones(Vo.shape[0]))
    Bo[bo] = 0.0
    data_o = min_quad_with_fixed_mg_precompute(Ao, bo, mg_o, device=dev)
    hub = max(int(np.diff(lv.PT.indptr.cpu().numpy()).max())
              for lv in data_o.hier.levels[1:])
    log(f"phase 5: ogre |V| {Vo.shape[0]}, {bo.size} known, widest PT row {hub}")
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


def device_ms(fn, reps):
    """Per-call device time of fn: the summed durations of the kernels and
    copies the profiler records over reps calls, and their count per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not ev:
        raise RuntimeError("the profiler recorded no device activity")
    return sum(e.time_range.elapsed_us() for e in ev) / reps / 1e3, len(ev) / reps


def in_turns(run, plain_ctx):
    """run() with the kernels and with the plain version, in the order
    plain, kernel, kernel, plain; returns the medians of each."""
    res = {"kernel": [], "plain": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        with plain_ctx() if which == "plain" else contextlib.nullcontext():
            res[which].append(run())
    return {k: float(np.median(v)) for k, v in res.items()}, res


def timings(depth, V, A, M, datas, dev):
    """Phase 6: V-cycle and per-kernel times, kernel vs plain, in turns."""
    from surface_multigrid_code_torch.ops.sparse import csr_from_scipy
    from surface_multigrid_code_torch.ops.spmv import fused_spmv, fused_spmv_plain
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
        busy, n_dev = device_ms(lambda: vcycle(data.hier, b, z, data.cfg), 5)
        with plain_spmv():
            busy_p, _ = device_ms(lambda: vcycle(data.hier, b, z, data.cfg), 5)
        vc[sm.value] = {
            "ms": wall["kernel"], "plain_ms": wall["plain"],
            "device_ms": busy, "plain_device_ms": busy_p,
            "device_ops": n_dev, "idle_share": 1.0 - busy / wall["kernel"],
        }
        log(f"phase 6: ico{depth} V-cycle ({sm.value}, f32): wall kernels {raw['kernel']} ms, "
            f"plain {raw['plain']} ms; device busy {busy:.4f} ms ({n_dev:.0f} device ops), "
            f"plain {busy_p:.4f} ms")

    Ad = csr_from_scipy(A, dev, torch.float32)
    dinv = torch.as_tensor(1.0 / A.diagonal(), dtype=torch.float32, device=dev)
    ker = {}
    for name, (C, _) in KERNELS.items():
        shp = (A.shape[0],) if C == 1 else (A.shape[0], C)
        g = torch.Generator(device=dev).manual_seed(C)
        x, u, bb = (torch.randn(shp, device=dev, generator=g) for _ in range(3))
        kw = dict(epi="axpby", u=u, b=bb, s=dinv, escale=2.0 / 3.0)
        res = {}
        for which, f in (("kernel", fused_spmv), ("plain", fused_spmv_plain)):
            res[which] = device_ms(lambda: f(Ad, x, **kw), 50)[0]
            res[which + "_call"] = cuda_ms(lambda: f(Ad, x, **kw), 50)
        ker[name] = res
        log(f"phase 6: {name} (axpby, f32, ico{depth} level-0 A, C={C}): device "
            f"{res['kernel']:.5f} ms vs plain {res['plain']:.5f} ms; per call "
            f"{res['kernel_call']:.5f} vs {res['plain_call']:.5f} ms")
    return vc, ker


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


def check_block_kernels(V, F, mg, dev, seed=1):
    """Phase 3 (K3): every epilogue in f32 and f64 on the bunny_15K level-0
    block Hessian at the rest pose and on its second Galerkin level, kernel
    against plain version. Returns {"bsr_spmv": max abs error}."""
    from surface_multigrid_code_torch.models.balloon import BsrBalloonStepper
    from surface_multigrid_code_torch.ops.bsr_spmv import fused_bsr_spmv, fused_bsr_spmv_plain
    from surface_multigrid_code_torch.ops.sparse import BSRMatrix

    shell, M = balloon_shell(V, F, dev)
    stepper = BsrBalloonStepper(shell, M, mg, balloon_defaults()["dt"], dtype=torch.float64)
    hier = stepper.solver.refresh(block_hessian(stepper, V, dev))
    rng = np.random.default_rng(seed)
    errs, n_cases = {}, 0
    for lv in (0, 2):
        level = hier.levels[lv]
        for dt in (torch.float32, torch.float64):
            A = BSRMatrix(level.A.indptr, level.A.indices,
                          level.A.blocks.to(dt).contiguous(), level.A.n_cols)
            n = A.n_rows
            x, u, b = (torch.as_tensor(rng.standard_normal((n, 3)), device=dev).to(dt)
                       for _ in range(3))
            s = level.dinv.to(dt).contiguous()
            for epi in EPIS:
                kw = dict(b=b, u=u, s=s, escale=2.0 / 3.0)
                y = fused_bsr_spmv(A, x, epi, **kw)
                ref = fused_bsr_spmv_plain(A, x, epi, **kw)
                _compare(y, ref, dt, f"bsr level {lv} ({n} rows, {A.nnz} blocks) "
                         f"epi={epi} {dt}", errs, "bsr_spmv")
                n_cases += 1
    torch.cuda.synchronize(dev)
    log(f"phase 3: K3 {n_cases} kernel-vs-plain cases agree on bunny_15K levels 0 "
        f"({hier.levels[0].A.n_rows} rows) and 2 ({hier.levels[2].A.n_rows} rows); "
        f"max abs err {errs['bsr_spmv']:.3e}")
    return errs


def scaled_blocks(H):
    """The blocks psd_project_blocks hands to the sign kernel: Hs / inf-norm."""
    Hs = 0.5 * (H + H.transpose(-1, -2))
    s = Hs.abs().sum(dim=-1).amax(dim=-1).clamp_min(1e-30)
    return (Hs / s[:, None, None]).contiguous()


def check_sign_kernel(V, F, pos, dev, seed=2):
    """Phase 3 (K4), at the pressure-1e6 pose the balloon reached: the
    31,604 real 9x9 face Hessians and random symmetric 18x18 blocks, f32 and
    f64, kernel against plain version. Returns {"ns_sign_apply": max abs err}."""
    from surface_multigrid_code_torch.ops.psd import ns_sign_apply, ns_sign_apply_plain

    shell, _ = balloon_shell(V, F, dev)
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((4096, 18, 18))
    errs, n_neg = {}, 0
    for dt in (torch.float32, torch.float64):
        x9 = torch.as_tensor(np.asarray(pos)[F].reshape(-1, 9), device=dev).to(dt)
        X9 = scaled_blocks(shell.face_hess(x9, shell.abars.to(dt)))
        X18 = scaled_blocks(torch.as_tensor(B, device=dev).to(dt))
        for X, what in ((X9, f"{X9.shape[0]} face Hessians 9x9"), (X18, "4096 random 18x18")):
            Y = ns_sign_apply(X)
            ref = ns_sign_apply_plain(X)
            _compare(Y, ref, dt, f"K4 {what} {dt}", errs, "ns_sign_apply")
        # counted on the host: cuSOLVER's batched eigvalsh refuses 31,604 blocks
        n_neg = int((torch.linalg.eigvalsh(X9.double().cpu()).min(dim=1).values < -1e-4).sum())
    torch.cuda.synchronize(dev)
    log(f"phase 3: K4 kernel-vs-plain agree on the step-{BALLOON_STEPS} pose "
        f"({n_neg} of {F.shape[0]} scaled face blocks have an eigenvalue below -1e-4) "
        f"and on random 18x18 blocks; max abs err {errs['ns_sign_apply']:.3e}")
    return errs


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
    splu, psd_project=True) run from the same state. Returns the gaps."""
    from surface_multigrid_code_torch.models.balloon import (
        implicit_euler_balloon_direct,
        inflation_force,
    )

    d = balloon_defaults()
    shell, M = balloon_shell(V, F, dev)
    cur, qd = V.copy(), np.zeros(V.size)
    gaps = []
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
        log(f"phase 8: step {k}: max|disp| multigrid {mg_disp:.6f}, direct f64 "
            f"{d_disp:.6f}, relative gap {gap:.4f} (limit {ORACLE_GAP[k]}); "
            f"{time.perf_counter() - t0:.1f} s")
        if not gap <= ORACLE_GAP[k]:
            raise RuntimeError(f"balloon step {k}: gap {gap:.4f} to the direct step "
                               f"above {ORACLE_GAP[k]}")
        cur, qd = positions[k], stats[k]["qdot"]
    return gaps


def balloon_timings(V, F, mg, positions, stats, dev):
    """Phase 9: ms per balloon step on bunny_15K (f32) from the last state,
    split per Newton iteration into its phases; the device idle share of a
    step; K3 and K4 against their plain versions at the step's shapes."""
    from surface_multigrid_code_torch.models.balloon import (
        PHASES,
        BsrBalloonStepper,
        inflation_force,
    )
    from surface_multigrid_code_torch.ops.bsr_spmv import fused_bsr_spmv, fused_bsr_spmv_plain
    from surface_multigrid_code_torch.ops.psd import ns_sign_apply, ns_sign_apply_plain

    d = balloon_defaults()
    shell, M = balloon_shell(V, F, dev)
    stepper = BsrBalloonStepper(shell, M, mg, d["dt"], mg_tolerance=d["mg_tolerance"],
                                n_newton=d["n_newton"])
    cur, qd = positions[-1], stats[-1]["qdot"]
    fExt = inflation_force(cur, F, d["pressure"])

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
    busy, n_dev = device_ms(one_step, 1)
    idle = 1.0 - busy / step_ms
    log(f"phase 9: bunny_15K balloon step (f32, {stepper.solver.plans[0].n} V, "
        f"{len(stepper.solver.plans)} levels): {walls} ms wall; per step by phase "
        f"(ms, timed run with a sync per phase) {tot}; residuals per Newton solve "
        f"{[r['residuals'] for r in newton]}; device busy {busy:.3f} ms over {n_dev:.0f} "
        f"device ops, idle share {idle:.4f}")

    # the kernels at the step's shapes, in turns plain, kernel, kernel, plain
    vals = block_hessian(stepper, cur, dev)
    lv0 = stepper.solver.refresh(vals).levels[0]
    g = torch.Generator(device=dev).manual_seed(5)
    x, b = (torch.randn((lv0.A.n_rows, 3), device=dev, generator=g) for _ in range(2))
    x9 = torch.as_tensor(np.asarray(cur)[F].reshape(-1, 9), device=dev, dtype=torch.float32)
    X = scaled_blocks(shell.face_hess(x9, stepper.abars))
    calls = {
        "bsr_spmv": (lambda: fused_bsr_spmv(lv0.A, x, "resid_scaled", b=b, s=lv0.dinv),
                     lambda: fused_bsr_spmv_plain(lv0.A, x, "resid_scaled", b=b, s=lv0.dinv),
                     f"resid_scaled, level-0 block Hessian {lv0.A.n_rows} rows, "
                     f"{lv0.A.nnz} blocks"),
        "ns_sign_apply": (lambda: ns_sign_apply(X), lambda: ns_sign_apply_plain(X),
                          f"{X.shape[0]} blocks 9x9"),
    }
    ker = {}
    for name, (kern, plain, what) in calls.items():
        res = {"kernel": [], "plain": [], "kernel_call": [], "plain_call": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            fn = kern if which == "kernel" else plain
            res[which].append(device_ms(fn, 20)[0])
            res[which + "_call"].append(cuda_ms(fn, 20))
        ker[name] = {k: float(np.median(v)) for k, v in res.items()}
        log(f"phase 9: {name} (f32, {what}): device {res['kernel']} ms vs plain "
            f"{res['plain']} ms; per call {res['kernel_call']} vs {res['plain_call']} ms")
    bal = {"step_ms": step_ms, "step_walls_ms": walls, "device_ms": busy,
           "device_ops": n_dev, "idle_share": idle, "phase_ms": tot, "newton": newton}
    return bal, ker


# ---------------------------------------------------------------- main

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
    for line in path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

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

    errs = check_kernels(A, mg[1].P_full.tocsr(), dev)
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
    other_shapes(depth, V, A, M, datas[SmootherType.MULTICOLOR_GS], dev)
    static = read_counts("phases 4-5", ("spmv_fused", "spmv_fused_planes"))

    # phase 6: timing
    vc, ker = timings(depth, V, A, M, datas, dev)

    # phase 7: the balloon path, counted
    reset_counts()
    positions, stats, bsum = balloon_path(Vb, Fb, mg_b, dev)
    balloon = read_counts("phase 7", ("spmv_fused_planes", "bsr_spmv", "ns_sign_apply"))
    launches = {name: static[name] + balloon[name] for name in counters}
    errs.update(check_sign_kernel(Vb, Fb, positions[-1], dev))

    # phase 8: the balloon against the direct f64 oracle
    bsum["oracle_gap"] = balloon_oracle(Vb, Fb, positions, stats, dev)

    # phase 9: balloon and K3/K4 timing
    bal, bker = balloon_timings(Vb, Fb, mg_b, positions, stats, dev)
    ker.update(bker)

    log(card)
    log(json.dumps({"vcycle": vc, "mesh": f"icosphere({depth})", "dtype": "float32"}))
    log(json.dumps({"balloon": {**bsum, **bal}, "mesh": BALLOON_MESH, "dtype": "float32",
                    "launches": balloon}))
    # ms / plain_ms: device time per call (profiler); call_ms / plain_call_ms:
    # per call between CUDA events over back-to-back calls, host included;
    # launches: phases 4-5 and 7 together
    sources = {**{n: (SOURCE, rep) for n, (_, rep) in KERNELS.items()}, **BLOCK_KERNELS}
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": ker[name]["kernel"], "plain_ms": ker[name]["plain"],
         "call_ms": ker[name]["kernel_call"], "plain_call_ms": ker[name]["plain_call"]}
        for name, (src, rep) in sources.items()
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
