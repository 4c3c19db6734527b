"""Named accumulated-region profiler (analog of reference src/profc.h; ports ``surface_multigrid_code_tpu/utils/profiler.py``).

The reference registers scoped timers that print a name/count/elapsed/
us-per-call table at process exit (src/profc.h:70-90). The same registry
and report as the JAX package's. Two kinds of region write to it:

- ``profile_region(name, trace=False)``: always accumulates. With
  ``trace=True`` it also opens a ``torch.profiler.record_function`` span
  while a ``torch.profiler`` session records (where the JAX package opens
  a ``jax.profiler.TraceAnnotation``);
- ``span(name)``, for the hot path: nothing at all while no session
  records; while one does, it accumulates and opens an annotation of that
  name, so it sits on the profiler's own timeline, the clock of the
  device events. The annotation is PyTorch's ``_RecordFunctionFast``: an
  event like ``record_function``'s (a ``cpu_op``, not a
  ``user_annotation``, in a Chrome trace, and with no copy on the
  device's timeline) at about a tenth of its host cost, so the spans
  disturb the traced window less.

A site too hot for a context manager writes a counter instead: it checks
``recording()`` inline and adds its time with ``record()``, with no
annotation.

The switch is the session itself (``recording()``), so a ``span``'s
registry entry covers exactly the profiled window. The host clock times
every region: on the card, work queued inside it may finish after it
closes. ``profiler_snapshot()`` reads the registry.

An entry is named for its site, not for its caller: the precompute's
``smg.precompute.device_build`` and ``.coarse_inverse`` live in
``vcycle.build_device_hierarchy`` and record on every call of it, also
where a caller builds a hierarchy outside any precompute.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd


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
            node = self._nodes.get(name)
            if node is None:
                node = self._nodes[name] = _Node(name)
            node.count += 1
            node.elapsed_s += dt

    def snapshot(self) -> dict[str, tuple[int, float]]:
        with self._lock:
            return {n.name: (n.count, n.elapsed_s) for n in self._nodes.values()}

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


def recording() -> bool:
    """Whether a ``torch.profiler`` session records in this process (a
    module boolean of ``torch.autograd.profiler``: tens of nanoseconds to
    read)."""
    return _autograd._is_profiler_enabled


def record(name: str, elapsed_s: float) -> None:
    """Add one call of ``elapsed_s`` seconds to ``name``'s entry: a counter
    for a site too hot for a context manager, gated by the caller on
    ``recording()``."""
    _REGISTRY.add(name, elapsed_s)


@contextlib.contextmanager
def profile_region(name: str, trace: bool = False):
    """Scoped timer accumulating under `name`; with `trace`, also a
    torch.profiler span while a session records."""
    ctx = _autograd.record_function(name) if trace and recording() else contextlib.nullcontext()
    t0 = time.perf_counter()
    with ctx:
        try:
            yield
        finally:
            _REGISTRY.add(name, time.perf_counter() - t0)


class _Span:
    __slots__ = ("name", "annotation", "t0")

    def __init__(self, name: str):
        self.name = name
        self.annotation = _RecordFunctionFast(name)

    def __enter__(self):
        self.annotation.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        self.annotation.__exit__(*exc)
        _REGISTRY.add(self.name, dt)
        return False


_OFF = contextlib.nullcontext()


def span(name: str):
    """A hot-path region: a shared no-op while no profiler session records;
    while one does, accumulated under `name` and an annotation of that name
    on the profiler's timeline."""
    return _Span(name) if _autograd._is_profiler_enabled else _OFF


def profiler_snapshot() -> dict[str, tuple[int, float]]:
    """{name: (count, elapsed seconds)} of every region recorded so far."""
    return _REGISTRY.snapshot()


def profiler_report() -> str:
    return _REGISTRY.report()


def profiler_reset() -> None:
    _REGISTRY.reset()
