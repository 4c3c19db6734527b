"""Device times on the card: the profiler's, back-to-back bursts, calls, in turns.

One yardstick for every kernel time the repo reports (``chip_smoke.py``,
``kernel_ab.py``, ``probes/``):

- ``device_ms``: one ``torch.profiler`` session of reps calls; the mean
  duration of the recorded launches of a named kernel, or the summed
  durations of every kernel and copy a call launches (a plain version, a
  library call);
- ``burst_ms``: CUDA events around reps calls queued behind a spin kernel
  (``torch.cuda._sleep``, ``behind_spin``), so the card runs them back to
  back however long the host takes: each call's kernels plus the gaps
  between launches; ``queued_ms``: the same with a preparation queued
  before each call and events around each call alone (the median);
- ``checked_kernel_ms``: ``device_ms`` of a named kernel held to
  ``burst_ms`` of the same calls (``PROFILER_BAND``, ``LAUNCH_GAP_MS``);
- ``cuda_ms``: CUDA events around reps back-to-back calls, host included;
- ``in_turns`` / ``timed_turns``: one measurement per turn, in a given
  order of names (e.g. kernel, library, library, kernel).

Every timing is L2 warm: the calls run back to back on the same inputs,
which stay in the 50 MB L2 where they fit. Messages (a discarded session)
go to standard error, so a caller's standard output stays its own.
"""

from __future__ import annotations

import statistics
import sys
import time

import torch

# The profiler's check. A kernel's mean time per recorded launch t is held
# to its back-to-back time per call b (burst_ms: the kernel plus the gap to
# the next launch, 1.02-1.24 us on the H100 at every shape timed):
# PROFILER_BAND[0] * b - LAUNCH_GAP_MS <= t <= PROFILER_BAND[1] * b, which
# a reading at half the kernel's time fails at every shape.
PROFILER_BAND = (0.9, 1.15)
LAUNCH_GAP_MS = 1.5e-3
SPIN_CYCLES = 20_000_000


def _note(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def cuda_ms(fn, reps, warmup=3):
    """Per-call time of fn between CUDA events around reps back-to-back
    calls: the host's enqueue time where that is longer than the device's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def device_ms(fn, reps, kernel=None, counts=None, before=None):
    """One profiler session of reps calls of fn. Returns a record: "ms",
    the device time per call: without ``kernel`` the summed durations of
    the kernels and copies recorded, over reps; with ``kernel`` (a
    substring of the name of the one kernel a call of fn launches) the
    mean duration of its recorded launches. "events": device events
    recorded per call; "wall_ms": the session's time per call between
    CUDA events around the reps calls (the same sample). With ``counts``
    ({kernel name substring: () -> the wrapper's launch count}):
    "counted", the launches of each in the session, and "recorded", the
    events of that name the profiler kept. ``before`` (with ``kernel``)
    runs ahead of every call; its kernels are not counted. The profiler
    was seen to drop some events of a session (17 of 20 launches, every
    session of one call), so a sum over reps undercounts where the mean of
    a named kernel does not."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    counts = counts or {}
    fn()
    torch.cuda.synchronize()
    for attempt in range(8):  # a session now and then records no device event
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            before_counts = {k: c() for k, c in counts.items()}
            e0.record()
            for _ in range(reps):
                if before is not None:
                    before()
                fn()
            e1.record()
            torch.cuda.synchronize()
            counted = {k: c() - before_counts[k] for k, c in counts.items()}
        dev_ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        ev = [e for e in dev_ev if kernel is None or kernel in e.name]
        if ev:
            total = sum(e.time_range.elapsed_us() for e in ev) / 1e3
            return {"ms": total / reps if kernel is None else total / len(ev),
                    "events": len(dev_ev) / reps, "wall_ms": e0.elapsed_time(e1) / reps,
                    "counted": counted,
                    "recorded": {k: sum(k in e.name for e in dev_ev) for k in counts}}
        _note(f"  profiler session {attempt} recorded no device event"
              + ("" if kernel is None else f" named {kernel}") + "; again")
        time.sleep(1.0)
    raise RuntimeError("the profiler recorded no device event in 8 sessions")


def behind_spin(enqueue):
    """enqueue() (which queues work on the card; its result is returned)
    queued behind a spin kernel (``torch.cuda._sleep``), so that the card
    runs the work back to back however long the host takes to queue it.
    The spin is lengthened until the host has queued it all before the
    spin ends."""
    cycles = SPIN_CYCLES
    for _ in range(4):
        ea, eb = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ea.record()
        torch.cuda._sleep(cycles)
        eb.record()
        t0 = time.perf_counter()
        out = enqueue()
        host_ms = 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
        if host_ms < 0.8 * ea.elapsed_time(eb):
            return out
        cycles *= 4
    raise RuntimeError("the calls could not be queued behind the spin kernel")


def burst_ms(fn, reps):
    """Per-call device time of fn from CUDA events around reps calls queued
    behind a spin kernel (behind_spin): each call's kernels plus the gaps
    between launches."""
    fn()
    torch.cuda.synchronize()

    def enqueue():
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        return e0, e1

    e0, e1 = behind_spin(enqueue)
    return e0.elapsed_time(e1) / reps


def queued_ms(prep, fn, reps):
    """Device time of fn alone, per call (median): reps pairs (prep, fn)
    queued behind a spin kernel (behind_spin), with CUDA events around
    each fn only."""
    prep()
    fn()
    torch.cuda.synchronize()

    def enqueue():
        evs = [tuple(torch.cuda.Event(enable_timing=True) for _ in range(2)) for _ in range(reps)]
        for e0, e1 in evs:
            prep()
            e0.record()
            fn()
            e1.record()
        return evs

    return float(statistics.median(e0.elapsed_time(e1) for e0, e1 in behind_spin(enqueue)))


def checked_kernel_ms(fn, reps, kernel, what, sessions=3):
    """The profiler's mean time of the named kernel over reps calls of fn,
    held to the back-to-back event time per call (burst_ms) of the same
    calls (PROFILER_BAND, LAUNCH_GAP_MS). A session whose reading falls
    outside is discarded and noted, as one that records no event is;
    the run fails when ``sessions`` sessions in a row misread the kernel.
    Returns (profiler ms, burst ms)."""
    burst = burst_ms(fn, reps)
    lo, hi = PROFILER_BAND[0] * burst - LAUNCH_GAP_MS, PROFILER_BAND[1] * burst
    for _ in range(sessions):
        ms = device_ms(fn, reps, kernel)["ms"]
        msg = (f"{what}: the profiler reads {kernel} at {1e3 * ms:.3f} us a launch, "
               f"back-to-back calls take {1e3 * burst:.3f} us: outside "
               f"[{1e3 * lo:.3f}, {1e3 * hi:.3f}] us")
        if lo <= ms <= hi:
            return ms, burst
        _note(f"  {msg}; discarded, again")
    raise RuntimeError(f"{msg}, in {sessions} sessions")


def in_turns(fns, order, measure):
    """``measure(fns[name])`` for each name of ``order`` in turn (e.g.
    kernel, plain, plain, kernel); {name: [reading per turn]}."""
    out = {name: [] for name in fns}
    for name in order:
        out[name].append(measure(fns[name]))
    return out


def timed_turns(fns, turns, reps, kernels, label):
    """Device time (profiler) and per-call time (events) of each of fns,
    one measurement of reps calls per entry of turns. ``kernels`` maps the
    fns that launch one hand kernel a call to its name: those are timed by
    that kernel's recorded launches and held to their back-to-back time
    (checked_kernel_ms); the others by the summed device time of the
    kernels a call launches. Returns ({name: [device ms per turn]}, {name:
    [call ms per turn]}, {name: [back-to-back ms per turn]}, the kernels'
    only)."""
    burst = {w: [] for w in fns}

    def measure(w):
        if w in kernels:
            d, b = checked_kernel_ms(fns[w], reps, kernels[w], f"{label} ({w})")
            burst[w].append(b)
        else:
            d = device_ms(fns[w], reps)["ms"]
        return d, cuda_ms(fns[w], reps)

    both = in_turns({w: w for w in fns}, turns, measure)
    return ({w: [d for d, _ in r] for w, r in both.items()},
            {w: [c for _, c in r] for w, r in both.items()}, burst)
