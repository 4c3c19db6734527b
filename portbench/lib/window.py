"""The measured window: a closed loop of one client, and the statistics taken over it.

The client sends its next request when the last one has completed (a
user's script calling back to back). Requests start while the window is
open; the window ends when the last of them completes, so the window's
time covers all of their work. With tracing, the profiler records the
first ``trace_seconds`` of the window and stops; the loop runs on to the
window's end untraced.
"""

from __future__ import annotations

import statistics
import time
from contextlib import nullcontext


def closed_loop(session, seconds: float, trace_seconds: float | None = None):
    """Run ``session.request(i)`` back to back for ``seconds``. Returns
    (requests, window_s, profiler or None); each request is the dict the
    session returned with its host-clock start ``t0``, end ``t1`` and
    ``traced``."""
    from torch.autograd.profiler import record_function

    from portbench.lib.trace import REQUEST_SPAN

    prof = None
    if trace_seconds:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
    tracing = prof is not None
    requests = []
    start = time.perf_counter()
    i = 0
    while True:
        t0 = time.perf_counter()
        if t0 - start >= seconds:
            break
        if tracing and t0 - start >= trace_seconds:
            prof.stop()
            tracing = False
            t0 = time.perf_counter()
        with record_function(REQUEST_SPAN) if tracing else nullcontext():
            rec = session.request(i)
        t1 = time.perf_counter()
        requests.append({**rec, "t0": t0, "t1": t1, "traced": tracing})
        i += 1
    if tracing:
        prof.stop()
    return requests, requests[-1]["t1"] - start if requests else float(seconds), prof


def per_request_ms(requests, window_s: float) -> float:
    """The window's time over the requests completed in it, in ms."""
    return 1e3 * window_s / len(requests) if requests else float("nan")


def latency_quantile_ms(requests, q: int) -> float:
    """The q-th percentile of every request's latency in ms (the
    inclusive method of ``statistics.quantiles``)."""
    lat = [1e3 * (r["t1"] - r["t0"]) for r in requests]
    if len(lat) < 2:
        return lat[0] if lat else float("nan")
    return statistics.quantiles(lat, n=100, method="inclusive")[q - 1]
