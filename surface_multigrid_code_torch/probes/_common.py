"""What the probes share: the device, the card line, timing, bounds.

Timing is ``utils.timing``'s, the yardstick of every kernel time
``chip_smoke.py`` reports: ``timed`` runs ``timing.timed_turns`` over a
given order of turns, ``REPS`` calls a turn. A hand kernel's device time
is the profiler's mean duration of its recorded launches, held to the
back-to-back CUDA-event time of the same calls (``checked_kernel_ms``);
a plain version's or a library call's is the summed device time of the
kernels a call launches; beside each, the per-call time between CUDA
events over back-to-back calls, host included. Every timing is L2 warm:
the calls run back to back on the same inputs, which stay in the 50 MB
L2 where they fit. On the CPU no probe times anything: a host timing is
not a device metric, and the fields stay ``None``.

Bounds are ``utils.bounds``': bytes over 3.35 TB/s, or operations over
the peak of the unit the kernel uses (the f32 CUDA cores, 67 TFLOP/s;
TF32 tensor cores, 495; bf16, 989), whichever is larger.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from surface_multigrid_code_torch.utils.bounds import (  # noqa: F401  (re-exported)
    BF16_FLOPS_PER_S,
    F32_FLOPS_PER_S,
    TF32_FLOPS_PER_S,
    bound_ms,
)
from surface_multigrid_code_torch.utils.device import resolve_device
from surface_multigrid_code_torch.utils.timing import timed_turns

REPS = 20


def parser(prog: str, doc: str) -> argparse.ArgumentParser:
    """An argument parser with the probes' common ``--device`` and ``--seed``."""
    ap = argparse.ArgumentParser(prog=prog, description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="the card (cuda, the default) or cpu")
    ap.add_argument("--seed", type=int, default=0, help="seed of the random inputs")
    return ap


def operator_main(name: str, doc: str, argv, orders, label: str, prepare, measure, check) -> int:
    """``main`` of a probe on the finest operators of ``bench.ico_operators``:
    per ``--orders`` entry k, ``prepare(A_0, dev, label.format(k=k), seed)``,
    then its ``measure`` and ``check``; one JSON line of the runs."""
    from surface_multigrid_code_torch import bench

    ap = parser(f"surface_multigrid_code_torch.probes.{name}", doc)
    ap.add_argument("--orders", type=int, nargs="+", default=list(orders),
                    help="icosphere orders of the operators")
    ap.add_argument("--cache-dir", default=str(bench.CACHE_DIR),
                    help="where the SSP hierarchies are cached ('' builds them every run)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    runs = []
    for k in args.orders:
        p = prepare(bench.ico_operators(k, args.cache_dir or None)[0][0], dev,
                    label.format(k=k), args.seed)
        runs.append({**measure(p, dev), "check": check(p)})
    emit({"probe": name, "device": device_record(dev), "seed": args.seed, "runs": runs})
    return 0


def device_record(dev: torch.device) -> dict:
    """The device a record ran on: the card's name and power limit as
    ``nvidia-smi`` gives them, or the CPU."""
    if dev.type != "cuda":
        return {"type": dev.type}
    from surface_multigrid_code_torch.bench import card

    return {"type": "cuda", "kind": torch.cuda.get_device_name(dev), **card()}


def timed(fns: dict, order, kernels: dict, dev: torch.device, label: str) -> dict:
    """Each of ``fns`` timed in the turns of ``order`` (names of fns, e.g.
    kernel, library, library, kernel), ``REPS`` calls a turn
    (``utils.timing.timed_turns``; ``kernels`` maps a fn that launches one
    hand kernel a call to that kernel's name). {name: {"ms": median device
    ms, "turns_ms": device ms per turn, "call_ms": median per-call ms,
    "burst_ms": median back-to-back ms (hand kernels only)}}; every
    reading None on the CPU."""
    if dev.type != "cuda":
        return {w: dict.fromkeys(("ms", "turns_ms", "call_ms", "burst_ms")) for w in fns}
    dev_ms, call_ms, burst = timed_turns(fns, order, REPS, kernels, label)
    return {w: {"ms": median(dev_ms[w]), "turns_ms": dev_ms[w], "call_ms": median(call_ms[w]),
                "burst_ms": median(burst[w])} for w in fns}


def median(times):
    """The median of a list of times, None where they were not measured."""
    vals = [t for t in times if t is not None]
    return float(np.median(vals)) if vals else None


def share(bound, ms):
    """The bound's share of a measured time (None where not measured)."""
    return None if ms is None else bound / ms


def emit(record: dict) -> None:
    """Print the probe's one JSON line."""
    print(json.dumps(record), flush=True)
