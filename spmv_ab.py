#!/usr/bin/env python3
"""A/B timing of versions of the CSR SpMV kernel source (K1/K2) on one GPU.

Run from the repository root:

    python3 spmv_ab.py NAME=FILE.cu [NAME=FILE.cu ...] [--reps N]

Each FILE is a version of ``surface_multigrid_code_torch/csrc/spmv.cu``:
the checkout's, or one taken from an earlier commit with
``git show REV:surface_multigrid_code_torch/csrc/spmv.cu > FILE``. Each is
compiled by nvcc with the port's flags into a library of its own. At every
K1/K2 shape of the static path (``chip_smoke.spmv_cases``: ico7 levels,
the largest GS colors, P and PT, the constrained ogre's hub PT, C = 3, the
32-row launch floor) each version's output is held against the plain
version at ``chip_smoke.TOL``; then the versions are timed on the same
inputs and the same launch plan (``ops.spmv.launch_lanes``) in turns
A B ... B A, device time per call from the profiler (kernel events only),
L2 warm. ico7's level-0 A is also timed with the L2 flushed (a 256 MB
read) before every call, the time its bound at the HBM rate speaks of.
A version whose entry points take no ``lanes`` argument (one thread per
row) is called without it. Prints one line per shape, the card's name and
power limit, and a JSON line ``{"spmv_ab": ...}``.
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

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
EPI_CODE = {None: 0, "axpby": 1, "resid": 2, "add": 3, "resid_scaled": 4}


def build(versions):
    """Compile every version at once; returns {name: (library, takes lanes)}."""
    from surface_multigrid_code_torch._build import BUILD_DIR, NVCC_FLAGS, _nvcc

    out_dir = BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in versions.items():
        so = out_dir / f"libspmv_{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {versions[name]}:\n{err}")
        lanes = "int lanes" in Path(versions[name]).read_text()
        lib = ctypes.CDLL(str(so))
        for fn, cols in (("smg_spmv_fused_f32", []), ("smg_spmv_fused_planes_f32", [_I])):
            getattr(lib, fn).argtypes = ([_P] * 8 + [_D, _P, _I] + cols + [_I] * lanes
                                         + [_I, _P])
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = (lib, lanes)
    return libs


def caller(lib, takes_lanes, S, x, kw, lanes):
    """A function that runs one launch of this library's kernel on the case."""
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

    def run():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return out
    return run


def kernel_ms(fn, reps, before=None):
    """Device time per call of fn's kernels (events named spmv), from the
    profiler; ``before`` runs ahead of every call and is not counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a short session now and then records no device event
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if before is not None:
                    before()
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.events()
              if e.device_type == DeviceType.CUDA and "spmv" in e.name]
        if ev:
            return sum(e.time_range.elapsed_us() for e in ev) / reps / 1e3
    raise RuntimeError("the profiler recorded no kernel in 3 sessions")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("versions", nargs="+", help="NAME=FILE.cu")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: spmv_ab.py runs only on a GPU")
    versions = dict(v.split("=", 1) for v in args.versions)
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    cs.log(card)

    from surface_multigrid_code_torch import SolveConfig, min_quad_with_fixed_mg_precompute
    from surface_multigrid_code_torch.config import SmootherType
    from surface_multigrid_code_torch.ops.spmv import (
        card_threads,
        fused_spmv_plain,
        launch_lanes,
    )

    libs = build(versions)
    _, _, mg, A, _, _ = cs.ico_system(7)
    gs = min_quad_with_fixed_mg_precompute(
        A, None, mg, SolveConfig(smoother=SmootherType.MULTICOLOR_GS), device=dev)
    ogre = cs.ogre_system(dev)[0]
    cases = cs.spmv_cases(gs.hier, ogre.hier, dev)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    order = [*versions, *reversed(versions)]
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
            y = caller(lib, takes, S, xk, kk, lanes)()
            ref = fused_spmv_plain(S, xp, **kp)
            cs._compare(y, ref, torch.float32, f"{name} {label}", {}, name)
        runs = {name: caller(lib, takes, S, x, kw, lanes) for name, (lib, takes) in libs.items()}
        warm = {name: [] for name in versions}
        for name in order:
            warm[name].append(kernel_ms(runs[name], args.reps))
        rec = {"shape": label, "C": C, "rows": int(n_out), "lanes": lanes,
               "bound_ms": cs.bound_ms(*cs.spmv_bytes(H, C, epi, host_rows))[0],
               **{f"{name}_ms": float(np.median(t)) for name, t in warm.items()}}
        line = ", ".join(f"{name} {[round(1e3 * t, 3) for t in warm[name]]}"
                         for name in versions)
        if label.startswith("A_0 axpby"):
            cold = {name: [] for name in versions}
            for name in order:
                cold[name].append(kernel_ms(runs[name], args.reps, before=flush.sum))
            rec.update({f"{name}_l2_flushed_ms": float(np.median(t))
                        for name, t in cold.items()})
            line += "; L2 flushed: " + ", ".join(
                f"{name} {[round(1e3 * t, 3) for t in cold[name]]}" for name in versions)
        recs.append(rec)
        cs.log(f"{label} ({n_out} rows, lanes {lanes}): bound {1e3 * rec['bound_ms']:.3f} us; "
               f"device us per call, in turns: {line}")
    cs.log(card)
    cs.log(json.dumps({"spmv_ab": recs, "versions": versions, "reps": args.reps}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
