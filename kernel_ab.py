#!/usr/bin/env python3
"""A/B checks and timing of versions of one kernel source on one GPU.

Run from the repository root:

    python3 kernel_ab.py spmv|bsr|psd|psd_tc|query|band|staged NAME=FILE.cu [NAME=FILE.cu ...] [--reps N]

Each FILE is a version of one source of ``surface_multigrid_code_torch/csrc/``
(``spmv.cu`` for K1/K2, ``bsr_spmv.cu`` for K3, ``psd.cu`` for K4,
``psd_probe.cu`` for K4 on tensor cores, ``query_walk.cu`` for K5,
``spmv_probe.cu`` for the band and staged probe kernels): the
checkout's, or one taken from an earlier commit with
``git show REV:surface_multigrid_code_torch/csrc/FILE > OUT``. Each is
compiled by nvcc with the port's flags (and ``csrc/`` on the include path,
for ``spmv_fused.cuh``) into a library of its own. Every
version's output is held against the plain version at ``chip_smoke.TOL``;
then the versions are timed on the same inputs (and, for the SpMVs, the
same launch plan, ``ops.spmv.launch_lanes``) in turns A B ... B A, device
time per call from the profiler (kernel events only), L2 warm.

- ``spmv``: every K1/K2 shape of the static path (``chip_smoke.spmv_cases``:
  ico7 levels, the largest GS colors, P and PT, the constrained ogre's hub
  PT, C = 3, the 32-row launch floor); ico7's level-0 A is also timed with
  the L2 flushed (a 256 MB read) before every call, the time its bound at
  the HBM rate speaks of.
- ``bsr``: every K3 shape of the balloon path (the bunny_15K block Hessian
  at the rest pose, refreshed by the card's f32 stepper: every level but
  the dense coarsest, with the epilogues ``resid_scaled`` and ``None``).
- ``psd``: first the blocks with eigenvalues at the schedule's edges
  (``chip_smoke.edge_blocks``, 9x9 and 18x18, f32 and f64): each version's
  and the plain version's least eigenvalue of (1/2) Y and largest distance
  to the exact f64 eigen-projection, and each version's distance to the
  plain version (held at TOL only in f64); then, at each of
  ``BLOCK_COUNTS`` (bunny_15K's faces, and those of bunny_15K subdivided
  twice), the time per call on bunny_15K's face Hessians at the rest pose
  (9x9, repeated to the count) and on as many random symmetric 18x18
  blocks, f32 and f64, each beside its bound (``chip_smoke.sign_bound``).
- ``psd_tc``: ``ns_sign_apply_tc`` on ``psd_precision``'s 31,608 random
  blocks (``random_blocks(31_608, 0)``, scaled): each version held to
  ``ns_sign_apply_tc_plain`` by ``psd_precision.check_tc`` (elementwise
  at 0 and 1 steps within ``tc_tolerance``, the full schedule's metrics
  within ``FULL_FACTOR``), then timed in turns at 1 and 3 passes on the
  full schedule, with K4 (the checkout's ``ns_sign_apply``, f32) in the
  same turns: the profiler's mean launch time, held to the back-to-back
  event time (``utils.timing.checked_kernel_ms``), beside the function's
  bound and the tile bounds of this design and of the 16^3 one before.
- ``query``: the f2c walk (f32) at each of ``chip_smoke.QUERY_COUNTS`` on
  phase 13's log (icosphere(7) to F/64, 161,280 records): each version's
  result against the plain version at ``QUERY_LIMITS`` (bit for bit),
  then its time per call by CUDA events (``utils.timing.queued_ms``, the
  calls queued behind a spin kernel) in turns; then the walk alone on the
  queries sorted by start face, and the sort, the walk and the unpermute
  together (the JAX package's ``_query_chunked`` order), against the
  unsorted walk.
- ``band``: ``band_spmv_tc`` on the RCM-ordered A_0 of ico7 and ico6
  (``bench.ico_finest``), bf16 and f32 bands, nc = 128 and 3. A version
  with tile lists (``const int* tile_ptr``) runs both lists ("skip",
  "dense") of ``probes.band_spmv.band_layout``; an earlier one its dense
  band of 256-row blocks, laid out as it was (``parent_band``). Each is
  held to ``band_spmv_tc_plain`` within ``band_tolerance``, then timed by
  CUDA events around back-to-back calls behind a spin
  (``utils.timing.burst_ms``: a call's launches, the X cast pass
  included), with the profiler's time of the cast and the product beside.
- ``staged``: ``spmv_staged`` on the RCM-ordered A_0 of ico9 and ico7,
  axpby. A version with the ring (``const void* table``) runs the ring
  plan with the operator streamed and staged (``stage_a``), and a narrow
  ring with wide chunks; an earlier one its double-buffered windows of
  8,192 floats (``parent_staged``) and half the widest window. Each is
  held to K1's plain version at ``chip_smoke.TOL`` x max|y|, then timed
  by the profiler's mean launch time.

A version whose SpMV entry points take no ``lanes`` argument (one thread
per row, as in earlier commits) is called without it; a K5 version whose
entry points take no packed blocks (``const void* pack``: the CSR walk of
earlier commits) is called with the CSR arrays. Prints one line per
shape, the card's name and power limit, and a JSON line ``{"<kernel>_ab":
...}``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from surface_multigrid_code_torch.utils import timing

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
EPI_CODE = {None: 0, "axpby": 1, "resid": 2, "add": 3, "resid_scaled": 4}
# K4's block counts (psd): bunny_15K's faces and chip_smoke.LARGE_SIZE's
BLOCK_COUNTS = (31_604, cs.LARGE_SIZE[1])


def signatures(kernel, lanes):
    """{entry point: argtypes} of a version of the kernel's source; ``lanes``:
    whether its SpMV entry points take a lanes argument (K5: 0 for the CSR
    walk, 1 for the packed blocks, 2 for the packed blocks and the CSR
    parameterisations of unpacked records)."""
    ln = [_I] * lanes
    if kernel == "query":
        walk = {0: [_P] * 12 + [_I] * 3 + [_P], 1: [_P] * 9 + [_I] * 5 + [_P],
                2: [_P] * 12 + [_I] * 6 + [_P]}[lanes]
        return {"smg_query_walk_f32": walk, "smg_query_walk_f64": walk}
    if kernel == "spmv":
        return {"smg_spmv_fused_f32": [_P] * 8 + [_D, _P, _I] + ln + [_I, _P],
                "smg_spmv_fused_planes_f32": [_P] * 8 + [_D, _P, _I, _I] + ln + [_I, _P]}
    if kernel == "bsr":
        return {"smg_bsr_spmv_f32": [_P] * 8 + [_D, _I] + ln + [_I, _P]}
    if kernel == "band":
        from surface_multigrid_code_torch._build import SIGNATURES

        return {"smg_band_spmv_tc": SIGNATURES["smg_band_spmv_tc"] if lanes else
                [_P] * 4 + [_I] * 5 + [_P]}
    if kernel == "staged":
        from surface_multigrid_code_torch._build import SIGNATURES

        return {"smg_spmv_staged_f32": SIGNATURES["smg_spmv_staged_f32"] if lanes else
                [_P] * 8 + [_D, _P, _P] + [_I] * 6 + [_P]}
    if kernel == "psd_tc":
        from surface_multigrid_code_torch._build import SIGNATURES

        return {"smg_ns_sign_apply_tc_f32": SIGNATURES["smg_ns_sign_apply_tc_f32"]}
    sign = [_P, _P, _I, _I, _P, _I, _P]
    return {"smg_ns_sign_apply_f32": sign, "smg_ns_sign_apply_f64": sign}


# the profiler's name of each kernel's launches
EVENT = {"spmv": "spmv", "bsr": "bsr_spmv", "psd": "ns_sign_apply", "band": "band_",
         "staged": "spmv_staged", "psd_tc": "ns_sign_apply_tc"}
# the text of a source whose entry points take the variant's argument (psd_tc:
# none; the text marks this design's bulk-copied chunks)
VARIANT = {"spmv": "int lanes", "bsr": "int lanes", "psd": "int lanes",
           "query": "const void* pack", "band": "const int* tile_ptr",
           "staged": "const void* table", "psd_tc": "cp.async.bulk"}


def build(kernel, versions):
    """Compile every version at once; returns {name: (library, takes lanes)}."""
    from surface_multigrid_code_torch._build import BUILD_DIR, NVCC_FLAGS, SOURCES, _nvcc

    out_dir = BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in versions.items():
        so = out_dir / f"lib{kernel}_{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-I", str(SOURCES[0].parent), "-shared", "-o", str(so),
             str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {versions[name]}:\n{err}")
        for fn, rep in cs.ptxas_functions(err.splitlines()).items():
            if EVENT.get(kernel, "query_walk") in fn:
                cs.log(f"{name}: ptxas {fn}: {rep}")
        text = Path(versions[name]).read_text()
        lanes = VARIANT[kernel] in text
        if kernel == "query":
            lanes += "const void* uv_src" in text
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in signatures(kernel, lanes).items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = (lib, lanes)
    return libs


def launcher(fn, args, out):
    """A function that runs one launch of fn(*args, stream) and returns out."""
    def run():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return out
    return run


def spmv_caller(lib, takes_lanes, S, x, kw, lanes):
    """One launch of this library's K1/K2 on the case."""
    rows, out = kw.get("rows"), kw.get("out")
    if out is None:
        out = torch.empty((S.n_rows, *x.shape[1:]), dtype=x.dtype, device=x.device)
    n_out = S.n_rows if rows is None else rows.shape[0]
    ptr = (lambda t: None if t is None else t.data_ptr())
    args = [S.indptr.data_ptr(), S.indices.data_ptr(), S.data.data_ptr(), x.data_ptr(),
            out.data_ptr(), ptr(kw["u"]), ptr(kw["b"]), ptr(kw["s"]), kw["escale"],
            ptr(rows), n_out]
    if x.ndim == 2:
        args.append(x.shape[1])
    args += [lanes] * takes_lanes + [EPI_CODE[kw["epi"]]]
    fn = lib.smg_spmv_fused_f32 if x.ndim == 1 else lib.smg_spmv_fused_planes_f32
    return launcher(fn, args, out)


def bsr_caller(lib, takes_lanes, A, x, kw, lanes):
    """One launch of this library's K3 on the case."""
    out = torch.empty((A.n_rows, 3), dtype=x.dtype, device=x.device)
    ptr = (lambda t: None if t is None else t.data_ptr())
    args = [A.indptr.data_ptr(), A.indices.data_ptr(), A.blocks.data_ptr(), x.data_ptr(),
            out.data_ptr(), ptr(kw.get("u")), ptr(kw.get("b")), ptr(kw.get("s")),
            kw["escale"], A.n_rows, *[lanes] * takes_lanes, EPI_CODE[kw["epi"]]]
    return launcher(lib.smg_bsr_spmv_f32, args, out)


def psd_caller(lib, X, coeffs):
    """One launch of this library's K4 on the blocks X."""
    from surface_multigrid_code_torch.ops.psd import NS_SCHEDULE

    Y = torch.empty_like(X)
    fn = lib.smg_ns_sign_apply_f32 if X.dtype == torch.float32 else lib.smg_ns_sign_apply_f64
    args = [X.data_ptr(), Y.data_ptr(), X.shape[0], X.shape[1],
            ctypes.cast(coeffs, ctypes.c_void_p), len(NS_SCHEDULE)]
    return launcher(fn, args, Y)


def query_caller(lib, packed, dlog, work):
    """One launch of this library's K5, f2c, on the tensors ``work`` (in place)."""
    from surface_multigrid_code_torch.query.device import launch_shape

    BC, BF, FIdx = work
    fn = lib.smg_query_walk_f32 if BC.dtype == torch.float32 else lib.smg_query_walk_f64
    p = (lambda t: t.data_ptr())
    if packed == 2:
        threads, smem = launch_shape(dlog.fwd.chunks)
        args = [p(dlog.subset), p(dlog.fidx_post), p(dlog.dim_off), p(dlog.dim_dat),
                p(dlog.fwd.rec), p(dlog.fwd.pack), p(dlog.uv_pre), p(dlog.uv_post),
                p(dlog.fuv_post), p(BC), p(BF), p(FIdx), BC.shape[0], dlog.n_collapse,
                dlog.subset.shape[0], 1, threads, smem]
    elif packed:
        threads, smem = launch_shape(dlog.fwd.chunks)
        args = [p(dlog.subset), p(dlog.fidx_post), p(dlog.dim_off), p(dlog.dim_dat),
                p(dlog.fwd.rec), p(dlog.fwd.pack), p(BC), p(BF), p(FIdx), BC.shape[0],
                dlog.n_collapse, 1, threads, smem]
    else:
        uv_src, uv_dst, foff, fuv, fidx = dlog.side(True)
        args = [p(dlog.voff), p(dlog.subset), p(uv_src), p(uv_dst), p(foff), p(fuv), p(fidx),
                p(dlog.dim_off), p(dlog.dim_dat), p(BC), p(BF), p(FIdx), BC.shape[0],
                dlog.n_collapse, 1]
    return launcher(fn, args, work)


def query_ab(libs, dev, reps):
    from surface_multigrid_code_torch.query.device import device_log, query_walk_plain

    _V, F, Vc, Fc, qlog, _ = cs.query_system(cs.QUERY_DEPTH)
    dlog = device_log(qlog, dev)
    im_fwd = dlog.im_fwd.cpu().numpy()
    dest = (lambda bc, bf: cs.positions(bc, im_fwd[bf], Vc))
    limit = cs.QUERY_LIMITS[("plain", torch.float32)]
    recs = []
    for n in cs.QUERY_COUNTS:
        inputs = cs.walk_inputs(F, Fc, qlog, n, True, dev, torch.float32)
        ref = cs.walked(query_walk_plain, dlog, True, inputs)
        work = [t.clone() for t in inputs]

        def prep():
            for w, t in zip(work, inputs):
                w.copy_(t)

        runs, sorted_runs = {}, {}
        for name, (lib, packed) in libs.items():
            run = query_caller(lib, packed, dlog, work)
            prep()
            rec = cs.walk_compare(ref, run(), dest)
            cs.log(f"{name} {n} queries against the plain walk: {rec} (limits {limit})")
            if rec["max_pos_err"] > limit[0] or rec["same_ids"] < limit[1]:
                raise RuntimeError(f"{name} disagrees with the plain walk at {n} queries")
            runs[name] = run

            def sorted_walk(run=run):  # sort by start face, walk, unpermute
                perm = torch.argsort(inputs[2], stable=True)
                for w, t in zip(work, inputs):
                    w.copy_(t[perm])
                run()
                return [torch.empty_like(w).index_copy_(0, perm, w) for w in work]

            if not all(torch.equal(a, b) for a, b in zip(sorted_walk(), ref)):
                raise RuntimeError(f"{name}: the sorted walk differs from the plain walk")
            sorted_runs[name] = sorted_walk
        perm = torch.argsort(inputs[2], stable=True)
        presorted = [t[perm] for t in inputs]

        def prep_sorted():
            for w, t in zip(work, presorted):
                w.copy_(t)

        order = [*runs, *reversed(runs)]
        warm = timing.in_turns(runs, order, lambda fn: timing.queued_ms(prep, fn, reps))
        alone = timing.in_turns(runs, order, lambda fn: timing.queued_ms(prep_sorted, fn, reps))
        srt = timing.in_turns(sorted_runs, order,
                              lambda fn: timing.queued_ms(lambda: None, fn, reps))
        stats = {}
        cs.walked(query_walk_plain, dlog, True, inputs, stats=stats)
        nbytes, ops = cs.walk_bytes(qlog, stats, True, n, 4)
        rec = {"queries": n, "bound_ms": cs.bound_ms(nbytes, ops)[0],
               **{f"{name}_ms": float(np.median(t)) for name, t in warm.items()},
               **{f"{name}_presorted_ms": float(np.median(t)) for name, t in alone.items()},
               **{f"{name}_sorted_ms": float(np.median(t)) for name, t in srt.items()}}
        recs.append(rec)
        cs.log(f"f2c {n} queries: bound {1e3 * rec['bound_ms']:.3f} us; ms per call (events), in "
               f"turns: {ms_line(warm)}; the walk alone on the queries sorted by start face: "
               f"{ms_line(alone)}; sorted, walk and unpermute included: {ms_line(srt)}")
    return recs


def ms_line(turns):
    return ", ".join(f"{name} {[round(t, 4) for t in ts]}" for name, ts in turns.items())


def in_turns(runs, reps, event, before=None):
    """{name: [device ms per call, one per turn]} over turns A B ... B A:
    the mean duration of the recorded launches of the kernel whose name
    holds ``event`` (one a call); ``before`` runs ahead of every call and
    is not counted."""
    return timing.in_turns(runs, [*runs, *reversed(runs)],
                           lambda fn: timing.device_ms(fn, reps, event, before=before)["ms"])


def turns_line(warm):
    return ", ".join(f"{name} {[round(1e3 * t, 3) for t in ts]}" for name, ts in warm.items())


def spmv_ab(libs, dev, reps):
    from surface_multigrid_code_torch import SolveConfig, min_quad_with_fixed_mg_precompute
    from surface_multigrid_code_torch.config import SmootherType
    from surface_multigrid_code_torch.ops.spmv import (
        card_threads,
        fused_spmv_plain,
        launch_lanes,
    )

    _, _, mg, A, _, _ = cs.ico_system(7)
    gs = min_quad_with_fixed_mg_precompute(
        A, None, mg, SolveConfig(smoother=SmootherType.MULTICOLOR_GS), device=dev)
    ogre = cs.ogre_system(dev)[0]
    cases = cs.spmv_cases(gs.hier, ogre.hier, dev)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    recs = []
    for k, case in enumerate(cases):
        label, S, C, epi, rows, _ = case
        H, x, kw, host_rows = cs.shape_inputs(k, case, dev)
        n_out = S.n_rows if rows is None else rows.shape[0]
        lanes = launch_lanes(S.lanes, n_out, card_threads(dev.index or 0))
        for name, (lib, takes) in libs.items():  # each version against the plain one
            xk, xp = x.clone(), x.clone()  # in place with rows: x, u and out one buffer
            kk = {**kw, "u": xk, "out": xk} if rows is not None else kw
            kp = {**kw, "u": xp, "out": xp} if rows is not None else kw
            y = spmv_caller(lib, takes, S, xk, kk, lanes)()
            ref = fused_spmv_plain(S, xp, **kp)
            cs._compare(y, ref, torch.float32, f"{name} {label}", {}, name)
        runs = {name: spmv_caller(lib, takes, S, x, kw, lanes)
                for name, (lib, takes) in libs.items()}
        warm = in_turns(runs, reps, EVENT["spmv"])
        rec = {"shape": label, "C": C, "rows": int(n_out), "lanes": lanes,
               "bound_ms": cs.bound_ms(*cs.spmv_bytes(H, C, epi, host_rows))[0],
               **{f"{name}_ms": float(np.median(t)) for name, t in warm.items()}}
        line = turns_line(warm)
        if label.startswith("A_0 axpby"):
            cold = in_turns(runs, reps, EVENT["spmv"], before=flush.sum)
            rec.update({f"{name}_l2_flushed_ms": float(np.median(t))
                        for name, t in cold.items()})
            line += "; L2 flushed: " + turns_line(cold)
        recs.append(rec)
        cs.log(f"{label} ({n_out} rows, lanes {lanes}): bound {1e3 * rec['bound_ms']:.3f} us; "
               f"device us per call, in turns: {line}")
    return recs


def bsr_ab(libs, dev, reps):
    from surface_multigrid_code_torch import mg_precompute
    from surface_multigrid_code_torch.models.balloon import BsrBalloonStepper
    from surface_multigrid_code_torch.ops.bsr_spmv import fused_bsr_spmv_plain
    from surface_multigrid_code_torch.ops.spmv import card_threads, launch_lanes
    from surface_multigrid_code_torch.utils.obj_io import read_obj
    from surface_multigrid_code_torch.utils.paths import mesh_path

    V, F = read_obj(mesh_path(cs.BALLOON_MESH))
    shell, M = cs.balloon_shell(V, F, dev)
    stepper = BsrBalloonStepper(shell, M, mg_precompute(V, F, verbose=False),
                                cs.balloon_defaults()["dt"])
    hier = stepper.solver.refresh(cs.block_hessian(stepper, V, dev))
    g = torch.Generator(device=dev).manual_seed(7)
    recs = []
    for lv, level in enumerate(hier.levels[:-1]):
        A = level.A
        x = torch.randn((A.n_cols, 3), device=dev, generator=g)
        b = torch.randn((A.n_rows, 3), device=dev, generator=g)
        lanes = launch_lanes(A.lanes, A.n_rows, card_threads(dev.index or 0))
        for epi in ("resid_scaled", None):
            kw = {"epi": epi, "b": b, "s": level.dinv, "escale": 1.0}
            ref = fused_bsr_spmv_plain(A, x, epi, b=b, s=level.dinv)
            runs = {name: bsr_caller(lib, takes, A, x, kw, lanes)
                    for name, (lib, takes) in libs.items()}
            for name, run in runs.items():
                cs._compare(run(), ref, torch.float32, f"{name} level {lv} {epi}", {}, name)
            warm = in_turns(runs, reps, EVENT["bsr"])
            nbytes, flops = cs.bsr_bytes(A, epi)
            rec = {"shape": f"level {lv} {epi}", "rows": A.n_rows, "blocks": A.nnz,
                   "lanes": lanes, "bound_ms": cs.bound_ms(nbytes, flops)[0],
                   **{f"{name}_ms": float(np.median(t)) for name, t in warm.items()}}
            recs.append(rec)
            cs.log(f"level {lv} {epi} ({A.n_rows} rows, {A.nnz} blocks, lanes {lanes}): bound "
                   f"{1e3 * rec['bound_ms']:.3f} us; device us per call, in turns: "
                   f"{turns_line(warm)}")
    return recs


def psd_ab(libs, dev, reps):
    from surface_multigrid_code_torch.ops.psd import NS_SCHEDULE, ns_sign_apply_plain
    from surface_multigrid_code_torch.utils.obj_io import read_obj
    from surface_multigrid_code_torch.utils.paths import mesh_path

    coeffs = (ctypes.c_double * (2 * len(NS_SCHEDULE)))(
        *(float(v) for pair in NS_SCHEDULE for v in pair))
    recs = []
    for d in (9, 18):
        E, P = cs.edge_blocks(4096, d, 2 + d)  # chip_smoke.check_sign_kernel's sets
        for dt in (torch.float32, torch.float64):
            X = torch.as_tensor(E, device=dev).to(dt).contiguous()
            ref = ns_sign_apply_plain(X)
            rec = {"shape": f"edge {d}x{d} {str(dt)[6:]}", "blocks": X.shape[0]}
            for name, Y in {"plain": ref, **{name: psd_caller(lib, X, coeffs)()
                                             for name, (lib, _) in libs.items()}}.items():
                half = 0.5 * Y.double().cpu().numpy()
                sym = 0.5 * (half + half.transpose(0, 2, 1))
                rec[name] = {"least_eig": float(np.linalg.eigvalsh(sym).min()),
                             "distance": float(np.abs(half - P).max())}
                if name != "plain":
                    rec[name]["vs_plain"] = float((Y - ref).abs().max())
                    if dt == torch.float64:
                        cs._compare(Y, ref, dt, f"{name} {rec['shape']}", {}, name)
            recs.append(rec)
            cs.log(f"{rec['shape']}: least eigenvalue of Y/2, max distance to the f64 "
                   f"eigen-projection (and to the plain version): "
                   + "; ".join(f"{k} {v}" for k, v in rec.items() if isinstance(v, dict)))
    V, F = read_obj(mesh_path(cs.BALLOON_MESH))
    shell, _ = cs.balloon_shell(V, F, dev)
    x9 = torch.as_tensor(np.asarray(V)[F].reshape(-1, 9), device=dev, dtype=torch.float64)
    X9 = cs.scaled_blocks(shell.face_hess(x9, shell.abars.double()))
    m = X9.shape[0]
    g = torch.Generator(device=dev).manual_seed(6)
    for n in BLOCK_COUNTS:
        R = cs.scaled_blocks(torch.randn((n, 18, 18), device=dev, generator=g,
                                         dtype=torch.float64))
        # the face blocks repeated to n (the work of a block does not depend on its values)
        F9 = X9.repeat(-(-n // m), 1, 1)[:n].contiguous()
        for label, X in (("face Hessians 9x9", F9), ("random 18x18", R)):
            for dt in (torch.float32, torch.float64):
                Xd = X.to(dt).contiguous()
                runs = {name: psd_caller(lib, Xd, coeffs) for name, (lib, _) in libs.items()}
                ref = ns_sign_apply_plain(Xd)
                for name, run in runs.items():
                    cs._compare(run(), ref, dt, f"{name} {label} {dt}", {}, name)
                del ref
                warm = in_turns(runs, reps, EVENT["psd"])
                d = Xd.shape[1]
                nbytes, flops, bms, by = cs.sign_bound(n, d, Xd.element_size())
                cms = cs.cuda_core_bound_ms(nbytes, flops, Xd.element_size())
                rec = {"shape": f"{label} {str(dt)[6:]}", "blocks": n, "bound_ms": bms,
                       "bound_by": by, "cuda_core_bound_ms": cms,
                       **{f"{name}_ms": float(np.median(t)) for name, t in warm.items()},
                       **{f"{name}_turns_ms": t for name, t in warm.items()}}
                recs.append(rec)
                cs.log(f"{rec['shape']} ({n} blocks): bound {1e3 * bms:.3f} us ({by}); device "
                       f"us per call, in turns: {turns_line(warm)}; share of the bound: "
                       + ", ".join(f"{name} {100 * bms / rec[f'{name}_ms']:.1f}%"
                                   for name in runs)
                       + "; of the CUDA cores' bound "
                       + f"{1e3 * cms:.3f} us: "
                       + ", ".join(f"{name} {100 * cms / rec[f'{name}_ms']:.1f}%"
                                   for name in runs))
    return recs


def psd_tc_caller(lib, X, schedule, passes):
    """One launch of this library's ``ns_sign_apply_tc`` on the blocks X."""
    Y = torch.empty_like(X)
    coeffs = (ctypes.c_double * (2 * len(schedule)))(*(float(v) for ab in schedule for v in ab))
    return launcher(lib.smg_ns_sign_apply_tc_f32,
                    [X.data_ptr(), Y.data_ptr(), X.shape[0], ctypes.cast(coeffs, ctypes.c_void_p),
                     len(schedule), passes], Y)


def psd_tc_ab(libs, dev, reps):
    from surface_multigrid_code_torch.ops.psd import NS_SCHEDULE, ns_sign_apply
    from surface_multigrid_code_torch.probes import psd_precision as PP
    from surface_multigrid_code_torch.utils.bounds import F32_FLOPS_PER_S, TF32_FLOPS_PER_S

    p = PP.prepare(PP.random_blocks(PP.BLOCKS, 0), dev)
    X, m, steps = p["X"], p["X"].shape[0], len(NS_SCHEDULE)
    checks, runs = {}, {}
    for name, (lib, _) in libs.items():
        checks[name] = PP.check_tc(
            p, fn=lambda Xv, schedule, passes, lib=lib: psd_tc_caller(lib, Xv, schedule, passes)())
        cs.log(f"{name}: held to the plain version {json.dumps(checks[name])}")
        for variant, passes in (("tf32", 1), ("3xtf32", 3)):
            runs[f"{name} {variant}"] = (psd_tc_caller(lib, X, NS_SCHEDULE, passes),
                                         EVENT["psd_tc"])
    runs["K4 fp32"] = (lambda: ns_sign_apply(X), PP.K4_KERNEL)
    warm = timing.in_turns(runs, [*runs, *reversed(runs)], lambda r: timing.checked_kernel_ms(
        r[0], reps, r[1], "psd_tc")[0])
    bounds = {variant: {"bound_ms": PP.sign_bound(m, steps, TF32_FLOPS_PER_S)[0],
                        "tile_bound_ms": PP.tc_tile_bound_ms(m, steps, passes),
                        "parent_tile_bound_ms": PP.tc_tile_bound_ms(m, steps, passes,
                                                                    PP.PARENT_TILE_MMAS)}
              for variant, passes in (("tf32", 1), ("3xtf32", 3))}
    bounds["fp32"] = {"bound_ms": PP.sign_bound(m, steps, F32_FLOPS_PER_S)[0]}
    rec = {"blocks": m, "bounds": bounds, "checks": checks,
           **{f"{name}_ms": float(np.median(t)) for name, t in warm.items()},
           **{f"{name}_turns_ms": t for name, t in warm.items()}}
    rec["shares"] = shares = {name: {k: b / rec[f"{name}_ms"]
                                     for k, b in bounds[name.split()[-1]].items()}
                              for name in runs}
    cs.log(f"{m} random blocks, {steps} steps: bounds {json.dumps(bounds)}; device us per call, "
           f"in turns: {turns_line(warm)}; share of the function's bound, of this design's "
           "tiles' and of the 16^3 tiles': "
           + ", ".join(f"{name} " + " / ".join(f"{100 * v:.1f}%" for v in sh.values())
                       for name, sh in shares.items()))
    return [rec]


PARENT_BAND_ROWS = 256  # the band kernel before tile lists: 256-row blocks
PARENT_WINDOW = 8192  # the staged kernel before the ring: floats a buffer, two a CTA


def parent_band(H, dev, dtype):
    """The band as the kernel before tile lists took it: (band [blocks x
    256, W], start [blocks] int32 (each block's least column), W (the
    largest span rounded up to 32))."""
    n = H.shape[0]
    starts = np.arange(0, n, PARENT_BAND_ROWS)
    offs = H.indptr[starts]
    lo = np.minimum.reduceat(H.indices, offs)
    hi = np.maximum.reduceat(H.indices, offs)
    W = -(-int((hi - lo + 1).max()) // 32) * 32
    rows = np.repeat(np.arange(n), np.diff(H.indptr))
    band = torch.zeros((starts.size * PARENT_BAND_ROWS, W), dtype=dtype, device=dev)
    band[torch.as_tensor(rows, device=dev),
         torch.as_tensor(H.indices - lo[rows // PARENT_BAND_ROWS], device=dev)] = torch.as_tensor(
        H.data.astype(np.float32), device=dev).to(dtype)
    return band, torch.as_tensor(lo.astype(np.int32), device=dev), W


def band_caller(lib, tiled, H, L, X, tiles, parent):
    """One call of this library's band kernel: with tile lists on L's list
    ``tiles``, else on the parent's layout (``parent_band``)."""
    from surface_multigrid_code_torch.probes.band_spmv import BAND_K, band_n

    nc = X.shape[1]
    Y = torch.empty((H.shape[0], nc), dtype=torch.float32, device=X.device)
    bf16 = int(L.band.dtype == torch.bfloat16)
    if tiled:
        T = L.lists[tiles]
        xt = torch.empty(L.x_tiles * BAND_K * band_n(nc), dtype=L.band.dtype, device=X.device)
        args = [T.tiles.data_ptr(), T.tile_ptr.data_ptr(), T.tile_k.data_ptr(),
                L.start.data_ptr(), X.data_ptr(), xt.data_ptr(), Y.data_ptr(), L.n_rows,
                L.blocks, L.x_tiles, X.shape[0], nc, bf16]
    else:
        band, start, W = parent
        args = [band.data_ptr(), start.data_ptr(), X.data_ptr(), Y.data_ptr(), H.shape[0], W,
                X.shape[0], nc, bf16]
    return launcher(lib.smg_band_spmv_tc, args, Y)


def band_ab(libs, dev, reps):
    from surface_multigrid_code_torch import bench
    from surface_multigrid_code_torch.probes import band_spmv as B

    recs = []
    for k in (7, 6):
        H = bench.ico_finest(k)
        X0 = torch.as_tensor(np.random.default_rng(0).standard_normal((H.shape[1], 128))
                             .astype(np.float32), device=dev)
        for dtype in B.BAND_TYPES:
            L = B.band_layout(H, dev, dtype)
            parent = (parent_band(H, dev, dtype) if not all(t for _, t in libs.values())
                      else None)
            for nc in B.NCS:
                X = X0[:, :nc].contiguous()
                ref = B.band_spmv_tc_plain(L, X)
                saved = torch.backends.cuda.matmul.allow_tf32
                torch.backends.cuda.matmul.allow_tf32 = False
                try:
                    mag = torch.matmul(L.band.view(L.blocks, B.BAND_ROWS, L.W).abs().float(),
                                       B.windows(L, X.abs())).reshape(-1, nc)[:L.n_rows]
                finally:
                    torch.backends.cuda.matmul.allow_tf32 = saved
                tol = B.band_tolerance(L)
                shape = f"ico{k} {str(dtype)[6:]} nc={nc}"
                runs = {}
                for name, (lib, tiled) in libs.items():
                    for tiles in (B.TILE_LISTS if tiled else ("dense",)):
                        run = band_caller(lib, tiled, H, L, X, tiles, parent)
                        worst = float(((run() - ref).abs() / mag.clamp_min(1e-30)).max())
                        if not worst <= tol:
                            raise RuntimeError(f"{name} {tiles} {shape}: {worst:.3e} of |A||X| "
                                               f"from the plain version (limit {tol:.3e})")
                        runs[f"{name}/{tiles}" if tiled else name] = run
                warm = timing.in_turns(runs, [*runs, *reversed(runs)],
                                       lambda fn: timing.burst_ms(fn, reps))
                parts = {name: {kern: timing.device_ms(fn, reps, kern)["ms"]
                                for kern in (B.CAST, B.KERNEL)}
                         for name, fn in runs.items() if "/" in name}
                rec = {"shape": shape, "W": L.W, "tiles": {t: L.lists[t].n_tiles
                                                           for t in B.TILE_LISTS},
                       "parent_W": None if parent is None else parent[2],
                       **{f"{name}_ms": float(np.median(t)) for name, t in warm.items()},
                       **{f"{name}_turns_ms": t for name, t in warm.items()},
                       **{f"{name}_parts_ms": v for name, v in parts.items()}}
                recs.append(rec)
                cs.log(f"band {shape} (W {L.W}, tiles {rec['tiles']}): device us per call "
                       f"(events, back to back), in turns: {turns_line(warm)}; by kernel "
                       + "; ".join(f"{n} cast {1e3 * v[B.CAST]:.2f} product "
                                   f"{1e3 * v[B.KERNEL]:.2f}" for n, v in parts.items()))
            del L, parent
    return recs


def parent_staged(H, dev):
    """The staged kernel's plan before the ring: each chunk's window
    [win_lo, win_hi] and the grid (CTAs of 512 threads, two buffers of
    PARENT_WINDOW floats)."""
    from surface_multigrid_code_torch.probes.staged_spmv import CHUNK_ROWS, chunk_windows

    lo, hi = chunk_windows(H, CHUNK_ROWS)
    p = torch.cuda.get_device_properties(dev)
    per_sm = min(p.max_threads_per_multi_processor // 512,
                 227 * 1024 // (2 * 4 * PARENT_WINDOW + 1024))
    return (torch.as_tensor(lo.astype(np.int32), device=dev),
            torch.as_tensor(hi.astype(np.int32), device=dev),
            min(lo.size, p.multi_processor_count * per_sm))


def staged_caller(lib, ring, A, v, plan, window):
    """One call of this library's staged kernel: the ring's on ``plan``,
    the parent's on its windows ``plan`` with buffers of ``window``
    floats."""
    from surface_multigrid_code_torch.ops.spmv import card_threads, launch_lanes
    from surface_multigrid_code_torch.probes.bf16_values import ESCALE
    from surface_multigrid_code_torch.probes.staged_spmv import CHUNK_ROWS, MAX_LANES

    n = A.n_rows
    y = torch.empty_like(v["u"])
    head = [A.indptr.data_ptr(), A.indices.data_ptr(), A.data.data_ptr(), v["x"].data_ptr(),
            y.data_ptr(), v["u"].data_ptr(), v["b"].data_ptr(), v["s"].data_ptr(), ESCALE]
    if ring:
        args = head + [plan.table.data_ptr(), plan.cta_ptr.data_ptr(), n, A.n_cols,
                       int(A.indices.shape[0]), plan.chunk_rows, plan.ring, plan.a_cap,
                       launch_lanes(min(A.lanes, MAX_LANES), n, card_threads(0)),
                       int(plan.stage_a), plan.grid]
    else:
        lo, hi, grid = plan
        args = head + [lo.data_ptr(), hi.data_ptr(), n, CHUNK_ROWS, lo.shape[0], window,
                       min(A.lanes, MAX_LANES), grid]
    return launcher(lib.smg_spmv_staged_f32, args, y)


def staged_ab(libs, dev, reps):
    from surface_multigrid_code_torch import bench
    from surface_multigrid_code_torch.ops.sparse import csr_from_scipy
    from surface_multigrid_code_torch.probes import staged_spmv as S
    from surface_multigrid_code_torch.probes.bf16_values import ESCALE, jacobi_inputs

    recs = []
    for k in (9, 7):
        H = bench.ico_finest(k)
        A = csr_from_scipy(H, dev, torch.float32)
        v = jacobi_inputs(H, dev, 0)
        ref = S.spmv_staged_plain(A, None, v["x"], v["u"], v["b"], v["s"], ESCALE)
        scale = float(ref.abs().max())
        plans = {"ring": S.staged_plan(H, dev, stage_a=False),
                 "ring_a": S.staged_plan(H, dev, stage_a=True)}
        half = max(4, plans["ring"].window_floats["max"] // 2)
        plans["narrow"] = S.staged_plan(H, dev, ring=1 << (half.bit_length() - 1))
        parent = parent_staged(H, dev)
        runs, checks = {}, {}
        for name, (lib, ring) in libs.items():
            cases = (plans.items() if ring else
                     (("windows", PARENT_WINDOW), ("narrow", half // 4 * 4)))
            for label, plan in cases:
                run = staged_caller(lib, ring, A, v, plan if ring else parent,
                                    None if ring else plan)
                err = float((run() - ref).abs().max())
                checks[f"{name}/{label}"] = err
                if not err <= cs.TOL[torch.float32] * scale:
                    raise RuntimeError(f"{name} {label} ico{k}: {err:.3e} from K1's plain "
                                       f"version (limit {cs.TOL[torch.float32] * scale:.3e})")
                if label != "narrow":
                    runs[f"{name}/{label}" if ring else name] = run
        warm = in_turns(runs, reps, EVENT["staged"])
        rec = {"shape": f"ico{k} A_0 axpby", "rows": A.n_rows,
               "wide": {n: p.wide for n, p in plans.items()},
               "copy_bytes": {n: p.copy_bytes for n, p in plans.items()},
               "grid": {n: p.grid for n, p in plans.items()}, "parent_grid": parent[2],
               "max_abs_err": checks,
               **{f"{name}_ms": float(np.median(t)) for name, t in warm.items()},
               **{f"{name}_turns_ms": t for name, t in warm.items()}}
        recs.append(rec)
        cs.log(f"staged ico{k} A_0 ({A.n_rows} rows; wide chunks {rec['wide']}; ring copies "
               f"{rec['copy_bytes']} B): held to the plain version {checks}; device us per "
               f"call, in turns: {turns_line(warm)}")
    return recs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernel", choices=("spmv", "bsr", "psd", "psd_tc", "query", "band", "staged"))
    ap.add_argument("versions", nargs="+", help="NAME=FILE.cu")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: kernel_ab.py runs only on a GPU")
    versions = dict(v.split("=", 1) for v in args.versions)
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    cs.log(card)
    libs = build(args.kernel, versions)
    recs = {"spmv": spmv_ab, "bsr": bsr_ab, "psd": psd_ab, "psd_tc": psd_tc_ab, "query": query_ab,
            "band": band_ab, "staged": staged_ab}[args.kernel](libs, dev, args.reps)
    cs.log(card)
    cs.log(json.dumps({f"{args.kernel}_ab": recs, "versions": versions, "reps": args.reps}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
