"""The control of ``correct``: the reference in the program's place, one precision lower.

    python3 -m portbench.control --workload NAME --seeds N [N ...] [--answers K]

For each seed it makes the cell's inputs as a run does (the same mesh,
system, generator and draws; none of the program is imported), solves the
first K right-hand sides of the seed's pool from Z = 0 to the
configuration's tolerance with the plain solver of
``reference/plain_solve.py``, in the precision just below the
configuration's (the control) and in the configuration's own (the witness,
which has to pass), and judges both with ``reference/judge.py``, the
comparison the runs use. One JSON line per seed with the compared number of
the control and of the witness, beside the cell's limits. The benchmark's
own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench.lib import fields
from portbench.reference import judge
from portbench.reference.plain_solve import solve_control
from portbench.run import load_json, log

# the plain CG's iterations: a stated-precision witness converges well inside them
MAX_ITER = 20000
LOWER = {"float64": torch.float32}
STATED = {"float64": torch.float64}


def solve_readings(config, workload, seed, answers, device) -> dict:
    from portbench.traffic.solve import mesh_and_system

    p = workload["params"]
    V, F, mass, A, _ = mesh_and_system(config)
    gen = fields.generator(seed, device)
    Vd = torch.as_tensor(V, device=device)
    Fd = torch.as_tensor(F, device=device)
    pool = [fields.start_shape(Vd, Fd, p["amplitude"], gen).to("cpu").numpy()
            for _ in range(answers)]
    out = {}
    for role, dtype in (("control", LOWER[config["precision"]]),
                        ("witness", STATED[config["precision"]])):
        t0 = time.perf_counter()
        answers_, iters = [], []
        for j, U in enumerate(pool):
            Z, it = solve_control(A, mass, U, config["tolerance"], MAX_ITER, device, dtype)
            answers_.append((j, j, Z))
            iters.append(it)
        res = judge.solve_residuals(mass, A, {"answers": answers_, "fields": dict(enumerate(pool))})
        out[role] = {"resid": max(res), "resids": res, "iterations": iters,
                     "seconds": time.perf_counter() - t0, "precision": str(dtype)[6:]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--answers", type=int, default=2)
    args = ap.parse_args(argv)
    workload = load_json("workloads", args.workload)
    config = load_json("configs", workload["config"])
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        rec = solve_readings(config, workload, seed, args.answers, device)
        log(f"seed {seed}: " + ", ".join(f"{role} resid {v['resid']!r}" for role, v in rec.items()))
        print(json.dumps({"workload": args.workload, "seed": seed, "limits": workload["limits"],
                          **rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
