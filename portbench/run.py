"""Run one cell of the benchmark of the PyTorch and CUDA port once.

    python3 -m portbench.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout on a machine with the card(s) the cell asks
for. The cell ``NAME`` is ``portbench/workloads/NAME.json``; it names its
configuration (``portbench/configs/<config>.json``) and its traffic kind
(``portbench/traffic/<kind>.py``). The run builds everything from the
configuration and ``--seed`` (set-up: the kernels' build, the caches of
``portbench/.cache/``, the program's precompute and a warm-up of the cell's
own shapes), measures a closed loop for ``--seconds``, judges the answers
it kept against the plain reference (``portbench/reference/``), and prints
one JSON line as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics of
``BENCHMARK.json``, each read by ``portbench/e2e/<name>.py``; with
``--trace 1`` its per-layer metrics instead, each read by
``portbench/metrics/<name>.py`` from the traced run), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each compared number with
its limit, which also end standard error.

It exits non-zero and prints no result when there is no card or fewer
than the cell asks for, or when ``jax``, ``jaxlib``, ``flax`` or the JAX
package has been imported by the time the window closes.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "surface_multigrid_code_tpu")


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def load_json(kind: str, name: str) -> dict:
    return json.loads((ROOT / kind / f"{name}.json").read_text())


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py``, by its file (a name may hold dots)."""
    path = ROOT / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {kind} module {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"portbench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """The modules loaded in this process whose top-level name is one of
    FORBIDDEN (compared whole: the port's name begins with the JAX
    package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def cell_metrics(bench: dict, section: str, workload: str) -> list[dict]:
    """The metrics of ``section`` that this cell reports."""
    return [m for m in bench[section] if workload in m.get("workloads", [workload])]


def read_metrics(specs, kind: str, run: dict) -> dict:
    out = {}
    for m in specs:
        value = load_module(kind, m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def host_peak_bytes() -> int:
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def card_note() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def run_cell(bench, name, workload, config, seed, seconds, trace, dev):
    """Set-up, window, metrics and the reference check of one run of the cell
    ``name`` on ``dev``: the result line's object, or None (with the reason
    on standard error) where the run must print no result."""
    import torch

    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    ctx = SimpleNamespace(config=config, workload=workload, params=workload["params"],
                          seed=seed, device=dev, log=log)
    log(f"set-up phase {time.perf_counter() - T_START:.3f} s: "
        "start to the session (imports, the kernels' library)")
    session = load_module("traffic", workload["kind"]).open_session(ctx)
    session.warm()
    sync()
    setup_s = time.perf_counter() - T_START
    log(f"set-up {setup_s:.3f} s; window {seconds} s, trace {int(trace)}")

    from portbench.lib.window import closed_loop

    trace_s = min(float(workload["params"]["trace_seconds"]), seconds) if trace else None
    requests, window_s, prof = closed_loop(session, seconds, trace_s)
    sync()
    found = forbidden_modules()
    if found:
        log(f"modules that must not be loaded are: {', '.join(found)}")
        return None
    peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
              "count": int(workload["chips"]), "memory_peak_bytes": peak}
    run = {"requests": requests, "window_s": window_s, "setup_s": setup_s, "session": session,
           "trace": None}
    if prof is not None:
        from portbench.lib.trace import read

        run["trace"] = read(prof)
        del prof
        if run["trace"] is None:
            log("the profiler recorded no device event in the traced window")
            return None
        device.update(busy_s=run["trace"]["busy_s"], window_s=run["trace"]["window_s"])
        metrics = read_metrics(cell_metrics(bench, "per_layer", name), "metrics", run)
    else:
        metrics = read_metrics(cell_metrics(bench, "end_to_end", name), "e2e", run)
    failed = sum(not r["ok"] for r in requests)
    log(f"{len(requests)} requests in {window_s:.3f} s, {failed} failed; "
        f"memory peak {peak} B; host peak {host_peak_bytes()} B; "
        f"{card_note() if cuda else 'cpu'}")
    log(f"cycles of the first requests {[r['cycles'] for r in requests[:40]]}")
    if requests:
        quarters = [requests[k * len(requests) // 4:(k + 1) * len(requests) // 4]
                    for k in range(4)]
        lat = sorted(1e3 * (r["t1"] - r["t0"]) for r in requests)
        log("latency ms at 50/90/95/99/100% "
            f"{[round(lat[min(len(lat) - 1, int(q * len(lat)))], 4) for q in (.5, .9, .95, .99, 1)]}")
        log("ms a request by quarter of the window "
            f"{[round(1e3 * (q[-1]['t1'] - q[0]['t0']) / len(q), 4) for q in quarters if q]}")

    collected = session.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    checks = session.judge(collected)
    checks.append({"name": "failed", "value": failed, "limit": 0, "ok": failed == 0})
    log(f"reference check {time.perf_counter() - t0:.1f} s")
    out = {"correct": all(c["ok"] for c in checks), "attempted": len(requests),
           "failed": failed, "metrics": metrics, "device": device}
    if run["trace"] is not None:
        out["breakdown"] = run["trace"]["breakdown"]
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    for c in checks:
        log(f"check {c['name']} {c['value']!r} limit {c['limit']!r} "
            f"{'ok' if c['ok'] else 'FAILED'}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache inside the checkout, at fixed paths
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / ".cache" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".cache" / "triton")
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    workload = load_json("workloads", args.workload)
    config = load_json("configs", workload["config"])

    import torch

    chips = int(workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"the cell needs {chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.set_num_threads(min(8, torch.get_num_threads()))

    from surface_multigrid_code_torch._build import load_library

    load_library()
    out = run_cell(bench, args.workload, workload, config, args.seed, args.seconds,
                   bool(args.trace), dev)
    if out is None:
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
