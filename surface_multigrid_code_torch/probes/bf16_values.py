"""K1 with bfloat16 values on the card: the bytes a nonzero, and what they cost in accuracy.

The counterpart of ``benchmarks/probes/probe_bf16_chain.py``, which timed
the TPU windowed kernel's select chain on f32 8-row against bf16 16-row
tiles. The select chain is not carried to the port (a TPU layout); what
is left of the question is the value type: K1 moves 4 B of index and 4 B
of value a nonzero, and bf16 values make that 6.

``spmv_bf16_values`` is K1's template (``csrc/spmv_fused.cuh``) with
bfloat16 values and float32 x, sums and y (``csrc/spmv_probe.cu``), the
Jacobi sweep's epilogue: y = u + (b - A x) (s escale). The probe runs it
and K1 (f32) in turns on the finest operator of ``bench.ico_operators``
(RCM-ordered A_0 of icosphere(order); s = 1 / diag(A), escale = 2/3,
x, u, b standard normal from ``--seed``), with each call's bytes
(``utils.bounds.spmv_bytes``) and bound, and holds both to the f64
product of the f64 operator: max|y - y_f64| / max|y_f64|. The kernel is
held to its plain version (``fused_spmv_plain`` on the values rounded to
bf16 and widened again) at ``TOL`` x max|y|: the same products, summed in
another order.

    python -m surface_multigrid_code_torch.probes.bf16_values [--device cpu] [--orders 7 9]
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from surface_multigrid_code_torch._build import load_library
from surface_multigrid_code_torch.ops.sparse import CSRMatrix, csr_from_scipy
from surface_multigrid_code_torch.ops.spmv import (
    card_threads,
    fused_spmv,
    fused_spmv_plain,
    launch_lanes,
)
from surface_multigrid_code_torch.probes import _common as C
from surface_multigrid_code_torch.utils.bounds import spmv_bytes

ORDERS = (7, 9)
ESCALE = 2.0 / 3.0
TOL = 1e-5
EPI_AXPBY = 1  # csrc/spmv_fused.cuh Epi
K1_KERNEL = "spmv_fused_kernel"  # the name the profiler records


def bf16_operator(A: CSRMatrix) -> CSRMatrix:
    """The operator with its values rounded to bfloat16 (to nearest even,
    from the f32 values K1 reads)."""
    return CSRMatrix(A.indptr, A.indices, A.data.float().to(torch.bfloat16), A.n_cols)


def spmv_bf16_values_plain(A: CSRMatrix, x, u, b, s, escale=1.0):
    """Plain PyTorch version of ``spmv_bf16_values``: K1's plain version on
    the bf16 values widened to f32."""
    spmv_bf16_values_plain.calls += 1
    A32 = CSRMatrix(A.indptr, A.indices, A.data.float(), A.n_cols)
    return fused_spmv_plain(A32, x, "axpby", b=b, u=u, s=s, escale=escale)


spmv_bf16_values_plain.calls = 0


def spmv_bf16_values(A: CSRMatrix, x, u, b, s, escale=1.0) -> torch.Tensor:
    """y = u + (b - A x) (s escale) for A with bfloat16 values and float32
    x, u, b, s (one column). A CUDA tensor goes to K1's bf16-valued
    instantiation at K1's launch plan (each launch adds one to
    ``spmv_bf16_values.launches``), a CPU tensor to the plain version."""
    if A.data.dtype != torch.bfloat16:
        raise TypeError(f"the operator's values must be bfloat16, not {A.data.dtype}")
    n = A.n_rows
    for name, t, shape in (("x", x, (A.n_cols,)), ("u", u, (n,)), ("b", b, (n,)),
                           ("s", s, (n,))):
        if t.dtype != torch.float32 or t.device != A.data.device:
            raise TypeError(f"{name} is {t.dtype} on {t.device}; float32 on {A.data.device} "
                            "expected")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous of shape {shape}, not {tuple(t.shape)}")
    if x.device.type == "cpu":
        return spmv_bf16_values_plain(A, x, u, b, s, escale)
    if x.device.type != "cuda":
        raise TypeError(f"spmv_bf16_values runs on CUDA or CPU tensors, not {x.device}")
    for name in ("indptr", "indices"):
        t = getattr(A, name)
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != x.device:
            raise TypeError(f"operator {name} must be contiguous int32 on {x.device}")
    if not A.data.is_contiguous():
        raise ValueError("the operator's values must be contiguous")
    lib = load_library()
    y = torch.empty_like(u)
    if n == 0:
        return y
    with torch.cuda.device(x.device):
        lanes = launch_lanes(A.lanes, n, card_threads(torch.cuda.current_device()))
        err = lib.smg_spmv_bf16v_f32(
            A.indptr.data_ptr(), A.indices.data_ptr(), A.data.data_ptr(), x.data_ptr(),
            y.data_ptr(), u.data_ptr(), b.data_ptr(), s.data_ptr(), float(escale), None, n,
            lanes, EPI_AXPBY, torch.cuda.current_stream().cuda_stream)
    spmv_bf16_values.launches += 1
    if err != 0:
        raise RuntimeError(f"spmv_bf16_values launch failed: cudaError {err}")
    return y


spmv_bf16_values.launches = 0


def jacobi_inputs(H: sp.csr_matrix, dev, seed: int) -> dict:
    """x, u, b (standard normal) and s = 1 / diag(H), f32 on ``dev``."""
    rng = np.random.default_rng(seed)
    n = H.shape[0]
    x, u, b = (torch.as_tensor(rng.standard_normal(n).astype(np.float32), device=dev)
               for _ in range(3))
    s = torch.as_tensor((1.0 / H.diagonal()).astype(np.float32), device=dev)
    return {"x": x, "u": u, "b": b, "s": s}


def f64_axpby(H: sp.csr_matrix, v: dict) -> np.ndarray:
    """The sweep in f64 on the host, on the f64 operator and the f32 inputs."""
    h = {k: t.double().cpu().numpy() for k, t in v.items()}
    return h["u"] + (h["b"] - H @ h["x"]) * (h["s"] * ESCALE)


def prepare(H: sp.csr_matrix, dev: torch.device, label: str, seed: int = 0) -> dict:
    """The operator of the host CSR ``H`` in f32 and with bf16 values on
    ``dev``, and the sweep's inputs."""
    A32 = csr_from_scipy(H, dev, torch.float32)
    return {"H": H, "label": label, "A32": A32, "A16": bf16_operator(A32),
            "v": jacobi_inputs(H, dev, seed)}


def sweeps(p: dict) -> dict:
    """() -> K1's sweep (f32) and the bf16-valued one, on the prepared inputs."""
    A32, A16, v = p["A32"], p["A16"], p["v"]
    return {"f32": lambda: fused_spmv(A32, v["x"], "axpby", b=v["b"], u=v["u"], s=v["s"],
                                      escale=ESCALE),
            "bf16": lambda: spmv_bf16_values(A16, v["x"], v["u"], v["b"], v["s"], ESCALE)}


def check(p: dict) -> dict:
    """The bf16-valued kernel against its plain version at ``TOL`` x
    max|y|; raises on a disagreement."""
    v = p["v"]
    y = sweeps(p)["bf16"]()
    yp = spmv_bf16_values_plain(p["A16"], v["x"], v["u"], v["b"], v["s"], ESCALE)
    err, scale = float((y - yp).abs().max()), float(yp.abs().max())
    if not err <= TOL * scale:
        raise RuntimeError(f"spmv_bf16_values on {p['label']} is {err:.3e} from its plain "
                           f"version (limit {TOL * scale:.3e})")
    return {"max_abs_err": err, "max_abs_y": scale, "tol": TOL}


def measure(p: dict, dev: torch.device) -> dict:
    """K1 f32 and K1 with bf16 values on the prepared operator: each
    against the f64 sweep, bytes, bounds and device times in turns (K1,
    bf16, bf16, K1, then the plain version; back-to-back calls: L2 warm
    where the call's bytes fit in the 50 MB L2)."""
    H, v = p["H"], p["v"]
    fns = sweeps(p)
    y64 = f64_axpby(H, v)
    ref = np.abs(y64).max()
    rec = {"operator": p["label"], "rows": int(H.shape[0]), "nnz": int(H.nnz),
           "rel_err_vs_f64": {name: float(np.abs(fn().double().cpu().numpy() - y64).max() / ref)
                              for name, fn in fns.items()}}
    for name, vsize in (("f32", 4), ("bf16", 2)):
        nbytes, flops = spmv_bytes(H, 1, "axpby", value_itemsize=vsize)
        rec[f"bytes_{name}"] = int(nbytes)
        rec[f"bound_ms_{name}"], rec[f"bound_by_{name}"] = C.bound_ms(nbytes, flops)
    rec["l2"] = "warm" if rec["bytes_f32"] < 50e6 else "exceeds the 50 MB L2"
    fns["plain"] = lambda: spmv_bf16_values_plain(p["A16"], v["x"], v["u"], v["b"], v["s"],
                                                  ESCALE)
    t = C.timed(fns, ("f32", "bf16", "bf16", "f32", "plain"),
                dict.fromkeys(("f32", "bf16"), K1_KERNEL), dev, p["label"])
    rec["turns_ms"] = {name: t[name]["turns_ms"] for name in ("f32", "bf16")}
    for name in ("f32", "bf16"):
        rec[f"ms_{name}"], rec[f"call_ms_{name}"] = t[name]["ms"], t[name]["call_ms"]
        rec[f"bound_share_{name}"] = C.share(rec[f"bound_ms_{name}"], rec[f"ms_{name}"])
    rec["plain_ms"], rec["plain_call_ms"] = t["plain"]["ms"], t["plain"]["call_ms"]
    rec["library_ms"] = None  # no PyTorch call takes bf16 values with f32 vectors
    return rec


def main(argv=None) -> int:
    return C.operator_main("bf16_values", __doc__, argv, ORDERS, "ico{k} A_0 axpby", prepare,
                           measure, check)


if __name__ == "__main__":
    raise SystemExit(main())
