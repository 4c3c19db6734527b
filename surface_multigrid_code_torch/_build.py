"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` has a plain C interface. Each source is compiled with
``nvcc`` for ``sm_90a`` into an object, all of them at once in parallel,
and the objects are linked into one shared library under
``surface_multigrid_code_torch/build/`` at first use, loaded with ctypes;
nothing of PyTorch's headers is compiled, which keeps the build to
seconds. The library name carries a hash of every source, every header
(``csrc/*.cuh``) and the flags, so an edited source is rebuilt. The
compiler's report (``-Xptxas -v``: registers, spills) is kept beside the
library as ``<name>.log``.

A missing ``nvcc`` or a failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent
SOURCES = sorted((_PKG_DIR / "csrc").glob("*.cu"))
HEADERS = sorted((_PKG_DIR / "csrc").glob("*.cuh"))
BUILD_DIR = _PKG_DIR / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
_LOCK = threading.Lock()
_LIB = None

_p = ctypes.c_void_p
_i = ctypes.c_int
_d = ctypes.c_double
# indptr, indices, data, x, y, u, b, s, escale, rows, n, [C,] lanes, epi, stream
_K1_ARGS = [_p, _p, _p, _p, _p, _p, _p, _p, _d, _p, _i, _i, _i, _p]
_K2_ARGS = [_p, _p, _p, _p, _p, _p, _p, _p, _d, _p, _i, _i, _i, _i, _p]
# indptr, indices, blocks, x, y, u, b, s, escale, n, lanes, epi, stream
_K3_ARGS = [_p, _p, _p, _p, _p, _p, _p, _p, _d, _i, _i, _i, _p]
# X, Y, m, d, schedule (host double [2 * steps]), steps, stream
_K4_ARGS = [_p, _p, _i, _i, _p, _i, _p]
# the probes' kernels (probes/): K4's copy stage (X, Y, m, stream); K4 on
# tensor cores (X, Y, m, schedule, steps, passes, stream); x staged by
# chunk (K1's arguments without rows, then win_lo, win_hi, n, chunk_rows,
# n_chunks, window, lanes, grid, stream); the band (band, start, X, Y,
# n_rows, W, n_x, nc, bf16, stream)
_COPY_ARGS = [_p, _p, _i, _p]
_TC_ARGS = [_p, _p, _i, _p, _i, _i, _p]
_STAGED_ARGS = [_p] * 8 + [_d, _p, _p] + [_i] * 6 + [_p]
_BAND_ARGS = [_p] * 4 + [_i] * 5 + [_p]
# subset, fidx, dim_off, dim_dat, rec, pack, uv_src, uv_dst, fuv, BC, BF, FIdx, nq,
# n_collapse, nvert, forward, threads, shared bytes, stream
_K5_ARGS = [_p] * 12 + [_i] * 6 + [_p]
SIGNATURES = {
    "smg_spmv_fused_f32": _K1_ARGS,
    "smg_spmv_fused_f64": _K1_ARGS,
    "smg_spmv_fused_planes_f32": _K2_ARGS,
    "smg_spmv_fused_planes_f64": _K2_ARGS,
    "smg_bsr_spmv_f32": _K3_ARGS,
    "smg_bsr_spmv_f64": _K3_ARGS,
    "smg_ns_sign_apply_f32": _K4_ARGS,
    "smg_ns_sign_apply_f64": _K4_ARGS,
    "smg_query_walk_f32": _K5_ARGS,
    "smg_query_walk_f64": _K5_ARGS,
    "smg_ns_sign_copy_f32": _COPY_ARGS,
    "smg_ns_sign_apply_tc_f32": _TC_ARGS,
    "smg_spmv_bf16v_f32": _K1_ARGS,
    "smg_spmv_staged_f32": _STAGED_ARGS,
    "smg_band_spmv_tc": _BAND_ARGS,
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    """Compile ``csrc/*.cu`` if their library is not built yet; return the path."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (*SOURCES, *HEADERS):
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    out = BUILD_DIR / f"libsmg_kernels-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"tmp{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.{tag}.o" for src in SOURCES]
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for src, obj in zip(SOURCES, objs)
    ]
    logs, failed = [], []
    for src, proc in zip(SOURCES, procs):
        stdout, stderr = proc.communicate()
        logs.append(f"== {src.name}\n{stdout}{stderr}")
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{stderr}")
    tmp = out.with_name(out.name + f".{tag}")
    if not failed:
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True,
        )
        logs.append(f"== link\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            failed.append(f"link:\n{link.stderr}")
    for obj in objs:
        obj.unlink(missing_ok=True)
    out.with_suffix(".log").write_text("\n".join(logs))
    if failed:
        raise RuntimeError("nvcc failed on " + "\n".join(failed))
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """Build (once) and load the kernel library with its C signatures set."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(library_path()))
            for name, args in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            _LIB = lib
    return _LIB
