#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``surface_multigrid_code_torch``) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA card, ``nvcc`` and ``g++``, no network and no JAX. It
builds the port's kernels from ``surface_multigrid_code_torch/csrc``, holds
each against its plain PyTorch version on the card, drives the main path
(SSP hierarchy -> precompute -> multigrid solve) at icosphere(7) size,
runs the constrained, multi-column and iterative-refinement solve shapes,
times V-cycles and kernels against the plain version, and ends with

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
                    _compare(y, ref, dt, f"{name} C={C} epi={epi} {dt}", errs, C)
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
            _compare(uk, up, dt, f"GS rows C={C} {dt}", errs, C)
            n_cases += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        if fused_spmv.launches <= before:
            raise RuntimeError("fused_spmv.launches did not grow")
    log(f"phase 3: {n_cases} kernel-vs-plain cases agree; max abs err {errs}")
    return errs


def _compare(y, ref, dt, what, errs, C):
    if y.shape != ref.shape:
        raise RuntimeError(f"{what}: shape {tuple(y.shape)} != {tuple(ref.shape)}")
    if not bool(torch.isfinite(y).all()):
        raise RuntimeError(f"{what}: non-finite output")
    err = float((y - ref).abs().max())
    scale = float(ref.abs().max())
    if err > TOL[dt] * scale:
        raise RuntimeError(f"{what}: max|d| {err:.3e} > {TOL[dt]:g} * max|y| {scale:.3e}")
    errs[kernel_name(C)] = max(errs[kernel_name(C)], err)


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

    # phase 3: kernels against their plain versions
    errs = check_kernels(A, mg[1].P_full.tocsr(), dev)

    # phases 4 and 5: the main path and the other solve shapes, counted
    fused_spmv.launches = 0
    fused_spmv.planes_launches = 0
    fused_spmv_plain.calls = 0
    datas = main_path(depth, V, mg, A, M, dev)
    other_shapes(depth, V, A, M, datas[SmootherType.MULTICOLOR_GS], dev)
    torch.cuda.synchronize()
    launches = {
        "spmv_fused": fused_spmv.launches - fused_spmv.planes_launches,
        "spmv_fused_planes": fused_spmv.planes_launches,
    }
    log(f"phases 4-5: launches {launches}, plain calls {fused_spmv_plain.calls}")
    if fused_spmv_plain.calls != 0:
        raise RuntimeError("the plain version ran on the main path")
    for name, n in launches.items():
        if n <= 0:
            raise RuntimeError(f"kernel {name} was not launched on the main path")

    # phase 6: timing
    vc, ker = timings(depth, V, A, M, datas, dev)

    log(card)
    log(json.dumps({"vcycle": vc, "mesh": f"icosphere({depth})", "dtype": "float32"}))
    # ms / plain_ms: device time per call (profiler); call_ms / plain_call_ms:
    # per call between CUDA events over back-to-back calls, host included
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": rep,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": ker[name]["kernel"], "plain_ms": ker[name]["plain"],
         "call_ms": ker[name]["kernel_call"], "plain_call_ms": ker[name]["plain_call"]}
        for name, (_, rep) in KERNELS.items()
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
