"""K4 by stage on the card: where the sign-apply's time goes.

The counterpart of ``benchmarks/probes/probe_psd_stages.py``, which ran the
Pallas sign kernel in isolated stages against XLA einsums. The stages, on
random symmetric 9x9 f32 blocks scaled by their inf-norm:

1. ``copy``: K4's register body with its arithmetic compiled out
   (``ns_sign_copy``, ``csrc/psd.cu``: the CTA's loads and stores alone);
2. ``one product``: K4 on the empty schedule, Y = X + X X;
3. ``one cubic``: K4 on ``((1.5, 0.5),)``;
4. ``12 plain cubics``: K4 on twelve ``(1.5, 0.5)``;
5. ``NS_SCHEDULE``: K4 as the balloon runs it.

Each stage's kernel output is held to the plain version
(``ops.psd.ns_sign_apply_plain``; the copy: X itself) in f32 at ``TOL`` x
max|Y|, K4's f64 instantiation to the f64 plain version at the f64 ``TOL``
(stages 2-5), and the f32 kernel's distance to the f64 plain version
within ``F64_FACTOR`` of the f32 plain version's own (plus ``TOL``). Each
stage is timed (in the L2 at 31,608 blocks, 10.2 MB each way; out of it
at 505,664, 164 MB each way) beside its bound, its plain version and its library time:
``Tensor.copy_`` for the copy, ``torch.baddbmm`` for the one product, the
batched bmm chain of the plain version for the cubic stages (no single
PyTorch call computes them). From the stage times: the copy floor, the
cost of one product (2 - 1) and of one cubic ((4 - 2) / 12).

    python -m surface_multigrid_code_torch.probes.psd_stages [--device cpu] [--blocks N ...]
"""

from __future__ import annotations

import numpy as np
import torch

from surface_multigrid_code_torch._build import load_library
from surface_multigrid_code_torch.ops.psd import NS_SCHEDULE, ns_sign_apply, ns_sign_apply_plain
from surface_multigrid_code_torch.probes import _common as C
from surface_multigrid_code_torch.utils.device import resolve_device

BLOCKS = (31_608, 505_664)  # bunny_15K's faces (the probe's count) and phase 18's
D = 9
PLAIN_CUBIC = (1.5, 0.5)
STAGES = {  # name: the schedule K4 runs (None: the copy)
    "copy": None,
    "one product": (),
    "one cubic": (PLAIN_CUBIC,),
    "12 plain cubics": (PLAIN_CUBIC,) * 12,
    "NS_SCHEDULE": NS_SCHEDULE,
}
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
F64_FACTOR = 10.0


def ns_sign_copy_plain(X: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``ns_sign_copy``: a copy of X."""
    ns_sign_copy_plain.calls += 1
    return X.clone()


ns_sign_copy_plain.calls = 0


def ns_sign_copy(X: torch.Tensor) -> torch.Tensor:
    """Y = X through K4's 9x9 f32 register body with its arithmetic
    compiled out: its loads and stores alone. A CUDA tensor goes to the
    kernel (each launch adds one to ``ns_sign_copy.launches``), a CPU
    tensor to ``ns_sign_copy_plain``."""
    if X.ndim != 3 or tuple(X.shape[1:]) != (D, D):
        raise ValueError(f"X must be [m, {D}, {D}], not {tuple(X.shape)}")
    if X.dtype != torch.float32:
        raise TypeError(f"kernel takes float32 blocks, not {X.dtype}")
    if X.device.type == "cpu":
        return ns_sign_copy_plain(X)
    if X.device.type != "cuda":
        raise TypeError(f"ns_sign_copy runs on CUDA or CPU tensors, not {X.device}")
    if not X.is_contiguous():
        raise ValueError("X must be contiguous")
    if X.shape[0] >= 2**31:
        raise ValueError("too many blocks for one launch")
    lib = load_library()
    Y = torch.empty_like(X)
    if X.shape[0] == 0:
        return Y
    with torch.cuda.device(X.device):
        err = lib.smg_ns_sign_copy_f32(X.data_ptr(), Y.data_ptr(), X.shape[0],
                                       torch.cuda.current_stream().cuda_stream)
    ns_sign_copy.launches += 1
    if err != 0:
        raise RuntimeError(f"ns_sign_copy launch failed: cudaError {err}")
    return Y


ns_sign_copy.launches = 0


def stage_fn(name: str):
    """X -> the stage's kernel output."""
    schedule = STAGES[name]
    if schedule is None:
        return ns_sign_copy
    return lambda X: ns_sign_apply(X, schedule)


def plain_fn(name: str):
    """X -> the stage's plain version."""
    schedule = STAGES[name]
    if schedule is None:
        return ns_sign_copy_plain
    return lambda X: ns_sign_apply_plain(X, schedule)


def library_fn(name: str, X: torch.Tensor):
    """() -> the stage as one PyTorch call where there is one (copy_,
    baddbmm), else None (the plain version's bmm chain stands for it)."""
    schedule = STAGES[name]
    if schedule is None:
        out = torch.empty_like(X)
        return lambda: out.copy_(X)
    if schedule == ():
        return lambda: torch.baddbmm(X, X, X)
    return None


def random_scaled(m: int, seed: int) -> np.ndarray:
    """m symmetric 9x9 f32 blocks, standard normal, scaled by their inf-norm."""
    B = np.random.default_rng(seed).standard_normal((m, D, D)).astype(np.float32)
    H = 0.5 * (B + B.transpose(0, 2, 1))
    return H / np.abs(H).sum(-1).max(-1)[:, None, None]


def stage_bound(m: int, name: str) -> tuple:
    """(ms, by): X read and Y written once; 2 steps + 1 symmetric products
    of d^2 (d + 1) FLOP (none for the copy), at the f32 CUDA-core peak."""
    schedule = STAGES[name]
    flops = 0 if schedule is None else m * (2 * len(schedule) + 1) * D * D * (D + 1)
    return C.bound_ms(2 * m * D * D * 4, flops)


def check_stages(X32: torch.Tensor) -> dict:
    """Every stage's kernel held to its plain version (see the module
    docstring); raises on a disagreement, returns the readings."""
    X64 = X32.double()
    out = {}
    with torch.no_grad():
        for name in STAGES:
            got = stage_fn(name)(X32)
            ref32 = plain_fn(name)(X32)
            ref64 = X64.clone() if STAGES[name] is None else ns_sign_apply_plain(
                X64, STAGES[name])
            scale = float(ref64.abs().max())
            r = {"max_abs_err": float((got - ref32).abs().max()),
                 "f64_dist_kernel": float((got.double() - ref64).abs().max()),
                 "f64_dist_plain": float((ref32.double() - ref64).abs().max()), "scale": scale}
            if STAGES[name] is not None:
                r["max_abs_err_f64"] = float((ns_sign_apply(X64, STAGES[name]) - ref64)
                                             .abs().max())
                if not r["max_abs_err_f64"] <= TOL[torch.float64] * scale:
                    raise RuntimeError(f"K4 f64 stage {name!r}: {r['max_abs_err_f64']:.3e} from "
                                       "its plain version")
            tol = TOL[torch.float32] * scale
            if not (r["max_abs_err"] <= tol
                    and r["f64_dist_kernel"] <= F64_FACTOR * r["f64_dist_plain"] + tol):
                raise RuntimeError(f"K4 stage {name!r}: {r} (limit {tol:.3e})")
            out[name] = r
    return out


def blocks_on(m: int, dev: torch.device, seed: int = 0) -> torch.Tensor:
    """``random_scaled`` blocks on ``dev``."""
    return torch.as_tensor(random_scaled(m, seed), device=dev).contiguous()


def measure(X: torch.Tensor, dev: torch.device) -> dict:
    """Each stage's kernel, plain and library times on the blocks X beside
    its bound, and the derived costs."""
    m = X.shape[0]
    rec = {"blocks": m, "l2": "warm" if 2 * X.numel() * 4 < 50e6 else "exceeds the 50 MB L2",
           "stages": {}}
    with torch.no_grad():
        for name in STAGES:
            fn, pfn, lfn = stage_fn(name), plain_fn(name), library_fn(name, X)
            r = dict(zip(("bound_ms", "bound_by"), stage_bound(m, name)))
            fns = {"kernel": lambda: fn(X), "plain": lambda: pfn(X)}
            lib = [] if lfn is None else ["library"]
            if lfn is not None:
                fns["library"] = lfn
            t = C.timed(fns, ["kernel", *lib, "plain", *lib, "kernel"],
                        {"kernel": "ns_sign_apply"}, dev, f"psd_stages {name!r} {m} blocks")
            r["ms"], r["call_ms"], r["turns_ms"] = (t["kernel"][k] for k in
                                                    ("ms", "call_ms", "turns_ms"))
            r["plain_ms"], r["plain_call_ms"] = t["plain"]["ms"], t["plain"]["call_ms"]
            r["library_ms"] = t["library" if lfn else "plain"]["ms"]
            r["library"] = ("the plain version's batched bmm chain" if lfn is None
                            else "Tensor.copy_" if STAGES[name] is None else "torch.baddbmm")
            r["bound_share"] = C.share(r["bound_ms"], r["ms"])
            rec["stages"][name] = r
    t = {name: r["ms"] for name, r in rec["stages"].items()}
    if None not in t.values():
        rec["derived_ms"] = {
            "copy_floor": t["copy"],
            "one_product": t["one product"] - t["copy"],
            "one_cubic": (t["12 plain cubics"] - t["one product"]) / 12,
            "one_cubic_from_stage_3": t["one cubic"] - t["one product"],
        }
    return rec


def main(argv=None) -> int:
    ap = C.parser("surface_multigrid_code_torch.probes.psd_stages", __doc__)
    ap.add_argument("--blocks", type=int, nargs="+", default=list(BLOCKS),
                    help="block counts to run the stages at")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    runs = []
    for m in args.blocks:
        X = blocks_on(m, dev, args.seed)
        runs.append({**measure(X, dev), "checks": check_stages(X)})
    C.emit({"probe": "psd_stages", "device": C.device_record(dev), "seed": args.seed,
            "runs": runs})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
