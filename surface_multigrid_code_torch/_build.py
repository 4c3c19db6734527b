"""Build and load the port's CUDA kernels.

``csrc/spmv.cu`` has a plain C interface. It is compiled with ``nvcc`` for
``sm_90a`` into a shared library under ``surface_multigrid_code_torch/build/``
at first use, and loaded with ctypes; nothing of PyTorch's headers is
compiled, which keeps the build to seconds. The library name carries a hash
of the source and flags, so an edited source is rebuilt. The compiler's
report (``-Xptxas -v``: registers, spills) is kept beside the library as
``<name>.log``.

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
_SOURCE = _PKG_DIR / "csrc" / "spmv.cu"
BUILD_DIR = _PKG_DIR / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
_LOCK = threading.Lock()
_LIB = None

_p = ctypes.c_void_p
_i = ctypes.c_int
_d = ctypes.c_double
# indptr, indices, data, x, y, u, b, s, escale, rows, n, [C,] epi, stream
_K1_ARGS = [_p, _p, _p, _p, _p, _p, _p, _p, _d, _p, _i, _i, _p]
_K2_ARGS = [_p, _p, _p, _p, _p, _p, _p, _p, _d, _p, _i, _i, _i, _p]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    """Compile ``csrc/spmv.cu`` if its library is not built yet; return the path."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode() + _SOURCE.read_bytes())
    out = BUILD_DIR / f"libsmg_spmv-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + f".tmp{os.getpid()}")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)],
        capture_output=True, text=True,
    )
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {_SOURCE.name}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """Build (once) and load the kernel library with its C signatures set."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(library_path()))
            for name, args in (
                ("smg_spmv_fused_f32", _K1_ARGS),
                ("smg_spmv_fused_f64", _K1_ARGS),
                ("smg_spmv_fused_planes_f32", _K2_ARGS),
                ("smg_spmv_fused_planes_f64", _K2_ARGS),
            ):
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            _LIB = lib
    return _LIB
