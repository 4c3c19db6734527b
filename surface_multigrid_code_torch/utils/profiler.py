"""Named accumulated-region profiler (analog of reference src/profc.h; ports ``surface_multigrid_code_tpu/utils/profiler.py``).

The reference registers scoped timers that print a name/count/elapsed/
us-per-call table at process exit (src/profc.h:70-90). The same registry
and report as the JAX package's; ``trace=True`` also opens a
``torch.profiler.record_function`` span, so the region shows up on a
``torch.profiler`` timeline (where the JAX package opens a
``jax.profiler.TraceAnnotation``). The host clock times the region: on
the card, work queued inside it may finish after it closes.
"""

from __future__ import annotations

import atexit
import contextlib
import threading
import time
from dataclasses import dataclass


@dataclass
class _Node:
    name: str
    count: int = 0
    elapsed_s: float = 0.0


class _Registry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._nodes: dict[str, _Node] = {}

    def add(self, name: str, dt: float) -> None:
        with self._lock:
            node = self._nodes.setdefault(name, _Node(name))
            node.count += 1
            node.elapsed_s += dt

    def report(self) -> str:
        with self._lock:
            if not self._nodes:
                return ""
            rows = sorted(self._nodes.values(), key=lambda n: -n.elapsed_s)
            width = max(len(n.name) for n in rows)
            lines = [
                f"{'region'.ljust(width)}  {'count':>8}  {'elapsed_s':>10}  {'us/call':>10}"
            ]
            for n in rows:
                per = 1e6 * n.elapsed_s / max(n.count, 1)
                lines.append(
                    f"{n.name.ljust(width)}  {n.count:>8}  {n.elapsed_s:>10.4f}  {per:>10.1f}"
                )
            return "\n".join(lines)

    def reset(self) -> None:
        with self._lock:
            self._nodes.clear()


_REGISTRY = _Registry()
_PRINT_AT_EXIT = False


@contextlib.contextmanager
def profile_region(name: str, trace: bool = False):
    """Scoped timer accumulating under `name`; optionally a torch.profiler span."""
    ctx = contextlib.nullcontext()
    if trace:
        import torch.profiler

        ctx = torch.profiler.record_function(name)
    t0 = time.perf_counter()
    with ctx:
        try:
            yield
        finally:
            _REGISTRY.add(name, time.perf_counter() - t0)


def profiler_report() -> str:
    return _REGISTRY.report()


def profiler_reset() -> None:
    _REGISTRY.reset()


def enable_exit_report() -> None:
    global _PRINT_AT_EXIT
    if not _PRINT_AT_EXIT:
        _PRINT_AT_EXIT = True
        atexit.register(lambda: print(profiler_report() or "", flush=True))
