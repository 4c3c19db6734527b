"""K4's precision study on the card: the sign-apply at f32, on tensor cores, and on cut schedules.

The counterpart of ``benchmarks/probes/probe_psd_precision.py`` (the TPU
probe ran the Pallas sign kernel's products at HIGHEST and DEFAULT
precision; HIGH did not lower). Here the variants are

- ``fp32``: K4 as it is (``ops.psd.ns_sign_apply``, f32 on the CUDA
  cores), the counterpart of HIGHEST;
- ``fp32-trunc1`` .. ``-trunc3``: K4 with the last 1-3 steps of
  ``NS_SCHEDULE`` cut;
- ``3xtf32``: ``ns_sign_apply_tc`` with 3 passes (hi hi + hi lo + lo hi
  on TF32 tensor cores), the counterpart of HIGH;
- ``tf32``: ``ns_sign_apply_tc`` with 1 pass, DEFAULT's class of error.

Each goes through the probe's scale and clamp (``probe_psd_precision.py
:106-113``, as ``models/shell.psd_project_blocks``): blocks scaled by their
inf-norm s, ``Hp = (s / 2) Y`` symmetrised, a block is clamped where Hp is
more than ``CLAMP_REL`` s from H. The result is held to the f64
eigen-projection ``U max(L, 0) U^T`` of H: ``min_eig_rel`` (least
eigenvalue over largest magnitude), ``reldiff_vs_f64`` (max distance over
max entry). The input is the probe's: ``BLOCKS`` random 9x9 blocks,
standard normal, symmetrised, from ``--seed``.

``ns_sign_apply_tc`` (``csrc/psd_probe.cu``) is held to its plain
version, ``ns_sign_apply_tc_plain`` (batched ``torch.bmm`` with TF32 off on
operands rounded to TF32 in software, split the same way): elementwise on
schedules of 0 and 1 steps within ``tc_tolerance``, and on the full
schedule by ``min_eig_rel`` and ``reldiff_vs_f64`` within
``FULL_FACTOR`` of the plain version's own (the growth cubics amplify
rounding ~700-fold there, so entries are not comparable).

    python -m surface_multigrid_code_torch.probes.psd_precision [--device cpu] [--blocks N]
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from surface_multigrid_code_torch._build import load_library
from surface_multigrid_code_torch.ops.psd import NS_SCHEDULE, ns_sign_apply
from surface_multigrid_code_torch.probes import _common as C
from surface_multigrid_code_torch.utils.device import resolve_device

BLOCKS = 31_608
D = 9
CLAMP_REL = 1e-4  # psd_project_blocks' clamp test
PASSES = (1, 3)
# unit roundoff of an operand: TF32 (10 stored mantissa bits, round to
# nearest) in one pass; hi + lo in three (the dropped lo lo term); f32
F32_U = 2.0**-24
OPERAND_U = {1: 2.0**-11, 3: 2.0**-22}
FULL_FACTOR = 10.0
K4_KERNEL, TC_KERNEL = "ns_sign_apply", "ns_sign_apply_tc_kernel"  # as the profiler names them
FULL_FLOOR = 1e-6
VARIANTS = {  # name: (route, cut steps or passes)
    "fp32": ("k4", 0), "fp32-trunc1": ("k4", 1), "fp32-trunc2": ("k4", 2),
    "fp32-trunc3": ("k4", 3), "3xtf32": ("tc", 3), "tf32": ("tc", 1),
}


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32 as ``cvt.rna.tf32.f32`` does: to nearest
    on the 13 dropped mantissa bits, ties away from zero (on the sign and
    magnitude bits: adding half an ulp to the magnitude and truncating).
    Non-finite values pass unchanged."""
    bits = x.contiguous().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), r, x)


def tc_bmm(A: torch.Tensor, B: torch.Tensor, passes: int) -> torch.Tensor:
    """A @ B (batched, f32) as the tensor-core kernel forms it: TF32
    operands in one pass; with three, hi = tf32(a), lo = tf32(a - hi) and
    lo hi + hi lo + hi hi, summed in that order."""
    Ah, Bh = tf32_round(A), tf32_round(B)
    if passes == 1:
        return torch.bmm(Ah, Bh)
    Al, Bl = tf32_round(A - Ah), tf32_round(B - Bh)
    return torch.bmm(Al, Bh) + torch.bmm(Ah, Bl) + torch.bmm(Ah, Bh)


def ns_sign_apply_tc_plain(X: torch.Tensor, schedule=NS_SCHEDULE, passes: int = 3):
    """Plain PyTorch version of ``ns_sign_apply_tc`` (batched bmm, TF32
    off, on operands rounded to TF32 in software)."""
    ns_sign_apply_tc_plain.calls += 1
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        Z = X
        for a, b in schedule:
            Z = a * Z - b * tc_bmm(tc_bmm(Z, Z, passes), Z, passes)
        return X + tc_bmm(X, Z, passes)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


ns_sign_apply_tc_plain.calls = 0


def ns_sign_apply_tc(X: torch.Tensor, schedule=NS_SCHEDULE, passes: int = 3) -> torch.Tensor:
    """X + X sign(X) per symmetric 9x9 f32 block of ``X [m, 9, 9]``, every
    product on TF32 tensor cores in ``passes`` passes (1 or 3). A CUDA
    tensor goes to the kernel (each launch adds one to
    ``ns_sign_apply_tc.launches`` and to ``.launches_by_passes[passes]``),
    a CPU tensor to ``ns_sign_apply_tc_plain``."""
    if X.ndim != 3 or tuple(X.shape[1:]) != (D, D):
        raise ValueError(f"X must be [m, {D}, {D}], not {tuple(X.shape)}")
    if X.dtype != torch.float32:
        raise TypeError(f"kernel takes float32 blocks, not {X.dtype}")
    if passes not in PASSES:
        raise ValueError(f"passes must be one of {PASSES}, not {passes}")
    if X.device.type == "cpu":
        return ns_sign_apply_tc_plain(X, schedule, passes)
    if X.device.type != "cuda":
        raise TypeError(f"ns_sign_apply_tc runs on CUDA or CPU tensors, not {X.device}")
    if not X.is_contiguous():
        raise ValueError("X must be contiguous")
    if X.shape[0] >= 2**31:
        raise ValueError("too many blocks for one launch")
    lib = load_library()
    Y = torch.empty_like(X)
    if X.shape[0] == 0:
        return Y
    coeffs = (ctypes.c_double * (2 * len(schedule)))(
        *(float(v) for pair in schedule for v in pair))
    with torch.cuda.device(X.device):
        err = lib.smg_ns_sign_apply_tc_f32(
            X.data_ptr(), Y.data_ptr(), X.shape[0], ctypes.cast(coeffs, ctypes.c_void_p),
            len(schedule), passes, torch.cuda.current_stream().cuda_stream)
    ns_sign_apply_tc.launches += 1
    ns_sign_apply_tc.launches_by_passes[passes] += 1
    if err != 0:
        raise RuntimeError(f"ns_sign_apply_tc launch failed: cudaError {err}")
    return Y


ns_sign_apply_tc.launches = 0
ns_sign_apply_tc.launches_by_passes = {p: 0 for p in PASSES}


def tc_tolerance(steps: int, passes: int) -> float:
    """Bound on max|kernel - plain| / max(1, max|Y|) for ``ns_sign_apply_tc``
    on a schedule of ``steps`` steps (blocks scaled to inf-norm <= 1, so
    every operand and product entry is O(1)).

    - Each of the 2 steps + 1 products sums 16 terms (9 live) in f32 on
      both sides, in other orders (and the tensor core's own alignment):
      32 f32 roundoffs of the result each.
    - The first product's operands are the same f32 values on both sides,
      so the same TF32 values. Every later product may see an operand
      that differs by those sums' roundings and so rounds to the
      neighbouring TF32 value: 2 ulps = 4 u of that operand, on each of
      its two operands, for 2 steps products: 8 steps u, u the operand's
      roundoff (``OPERAND_U``: 2^-11 in one pass, 2^-22 split in three).
    """
    return (2 * steps + 1) * 32 * F32_U + 8 * steps * OPERAND_U[passes]


def random_blocks(m: int, seed: int) -> np.ndarray:
    """The probe's input (``probe_psd_precision.py:37-39``): m symmetric
    9x9 f32 blocks, standard normal, symmetrised."""
    B = np.random.default_rng(seed).standard_normal((m, D, D)).astype(np.float32)
    return 0.5 * (B + B.transpose(0, 2, 1))


def variant_fn(name: str):
    """X -> Y of one variant (K4 or the tensor-core kernel)."""
    route, k = VARIANTS[name]
    if route == "k4":
        schedule = NS_SCHEDULE[:len(NS_SCHEDULE) - k]
        return lambda X: ns_sign_apply(X, schedule)
    return lambda X: ns_sign_apply_tc(X, NS_SCHEDULE, k)


def variant_steps(name: str) -> int:
    route, k = VARIANTS[name]
    return len(NS_SCHEDULE) - (k if route == "k4" else 0)


def projection_metrics(Y: np.ndarray, H: np.ndarray, s: np.ndarray, ref: np.ndarray) -> dict:
    """The probe's scale and clamp (``probe_psd_precision.py:106-113``) of
    the kernel's Y for the blocks H (scaled by s), held to the f64
    eigen-projection ``ref``."""
    Hp = 0.5 * s[:, None, None] * Y
    Hp = 0.5 * (Hp + Hp.transpose(0, 2, 1))
    clamped = np.abs(Hp - H).max(axis=(-1, -2)) > CLAMP_REL * s
    out = np.where(clamped[:, None, None], Hp, H)
    w = np.linalg.eigvalsh(out.astype(np.float64))
    return {"min_eig": float(w.min()), "min_eig_rel": float(w.min() / np.abs(w).max()),
            "reldiff_vs_f64": float(np.abs(out - ref).max() / np.abs(ref).max()),
            "clamped": float(clamped.mean())}


def sign_bound(m: int, steps: int, peak) -> tuple:
    """(ms, by) of one sign-apply of m 9x9 f32 blocks: X read and Y
    written once; useful work 2 steps + 1 symmetric products of d^2 (d + 1)
    FLOP (the count of K4's row in ``chip_smoke.sign_shapes``)."""
    return C.bound_ms(2 * m * D * D * 4, m * (2 * steps + 1) * D * D * (D + 1), peak=peak)


def prepare(H: np.ndarray, dev: torch.device, scale: bool = True) -> dict:
    """The probe's inputs for the symmetric 9x9 blocks ``H`` (numpy f32):
    H, the scale s (the inf-norm, or 1 with ``scale=False``: the blocks as
    given), the scaled blocks X on ``dev`` and the f64 eigen-projection."""
    m = H.shape[0]
    H = np.ascontiguousarray(H, dtype=np.float32)
    s = (np.maximum(np.abs(H).sum(-1).max(-1), np.float32(1e-30)) if scale
         else np.ones(m, np.float32))
    w, Q = np.linalg.eigh(H.astype(np.float64))
    ref = np.einsum("fik,fk,fjk->fij", Q, np.maximum(w, 0.0), Q)
    X = torch.as_tensor(H / s[:, None, None], device=dev).contiguous()
    return {"H": H, "s": s, "ref": ref, "X": X, "scaled": scale}


def metrics_of(Y: torch.Tensor, p: dict) -> dict:
    return projection_metrics(Y.double().cpu().numpy(), p["H"], p["s"], p["ref"])


def check_tc(p: dict) -> dict:
    """``ns_sign_apply_tc`` against ``ns_sign_apply_tc_plain`` on the
    prepared blocks, both pass counts: elementwise at 0 and 1 steps within
    ``tc_tolerance``; on the full schedule the kernel's ``min_eig_rel``
    and ``reldiff_vs_f64`` within ``FULL_FACTOR`` of the plain version's
    (plus ``FULL_FLOOR``). Raises on a disagreement; returns the readings."""
    X = p["X"]
    out = {}
    for passes in PASSES:
        for steps in (0, 1):
            schedule = NS_SCHEDULE[:steps]
            Y = ns_sign_apply_tc(X, schedule, passes)
            ref_y = ns_sign_apply_tc_plain(X, schedule, passes)
            err = float((Y - ref_y).abs().max())
            scale = max(1.0, float(ref_y.abs().max()))
            tol = tc_tolerance(steps, passes)
            out[f"passes{passes}_steps{steps}"] = {"max_abs_err": err, "scale": scale,
                                                   "tol": tol}
            if not err <= tol * scale:
                raise RuntimeError(f"ns_sign_apply_tc ({passes} passes, {steps} steps) is "
                                   f"{err:.3e} from its plain version (limit {tol * scale:.3e})")
        got = metrics_of(ns_sign_apply_tc(X, NS_SCHEDULE, passes), p)
        plain = metrics_of(ns_sign_apply_tc_plain(X, NS_SCHEDULE, passes), p)
        out[f"passes{passes}_full"] = {"kernel": got, "plain": plain}
        if not (got["reldiff_vs_f64"] <= FULL_FACTOR * plain["reldiff_vs_f64"] + FULL_FLOOR
                and got["min_eig_rel"] >= FULL_FACTOR * min(plain["min_eig_rel"], 0.0)
                - FULL_FLOOR):
            raise RuntimeError(f"ns_sign_apply_tc ({passes} passes, full schedule): kernel "
                               f"{got}, plain version {plain}: beyond {FULL_FACTOR}x")
    return out


def measure(p: dict, dev: torch.device, timed: bool = True) -> dict:
    """Every variant on the prepared blocks, through the scale and clamp,
    held to the f64 eigen-projection; with ``timed`` each variant's device
    time beside its bound, in turns (every variant, the tensor-core
    variants' plain versions, every variant in reverse; back-to-back
    calls, L2 warm)."""
    X, m = p["X"], p["H"].shape[0]
    rec = {"blocks": m, "scaled": p["scaled"], "l2": "warm", "variants": {}}
    fns = {}
    for name, (route, k) in VARIANTS.items():
        fn = variant_fn(name)
        rec["variants"][name] = r = metrics_of(fn(X), p)
        fns[name] = lambda fn=fn: fn(X)
        if route == "tc":
            fns[f"plain {name}"] = lambda k=k: ns_sign_apply_tc_plain(X, NS_SCHEDULE, k)
        if timed:
            peak = C.F32_FLOPS_PER_S if route == "k4" else C.TF32_FLOPS_PER_S
            r["bound_ms"], r["bound_by"] = sign_bound(m, variant_steps(name), peak)
    if not timed:
        return rec
    kernels = {name: TC_KERNEL if route == "tc" else K4_KERNEL
               for name, (route, _) in VARIANTS.items()}
    order = [*VARIANTS, *(f"plain {n}" for n, (r, _) in VARIANTS.items() if r == "tc"),
             *reversed(VARIANTS)]
    t = C.timed(fns, order, kernels, dev, f"psd_precision {m} blocks")
    for name, (route, _) in VARIANTS.items():
        r = rec["variants"][name]
        r["ms"], r["call_ms"], r["turns_ms"] = (t[name][k] for k in ("ms", "call_ms", "turns_ms"))
        r["bound_share"] = C.share(r["bound_ms"], r["ms"])
        if route == "tc":
            r["plain_ms"], r["plain_call_ms"] = (t[f"plain {name}"][k] for k in ("ms", "call_ms"))
    return rec


def main(argv=None) -> int:
    ap = C.parser("surface_multigrid_code_torch.probes.psd_precision", __doc__)
    ap.add_argument("--blocks", type=int, default=BLOCKS, help="random 9x9 blocks")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    p = prepare(random_blocks(args.blocks, args.seed), dev)
    C.emit({"probe": "psd_precision", "device": C.device_record(dev), "seed": args.seed,
            "input": "random", **measure(p, dev), "tc_checks": check_tc(p)})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
