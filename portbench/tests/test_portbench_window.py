"""The end-to-end metrics come from every request of the window, a stall included."""

from __future__ import annotations

import statistics
import time

from portbench.lib import window


class Stalling:
    """Requests of ~2 ms; every tenth stalls for 40 ms."""

    def request(self, i):
        time.sleep(0.040 if i % 10 == 9 else 0.002)
        return {"cycles": 1, "ok": True}


def test_window_counts_every_request_and_the_stall():
    reqs, window_s, prof = window.closed_loop(Stalling(), 0.6)
    assert prof is None and len(reqs) >= 10
    lat = [1e3 * (r["t1"] - r["t0"]) for r in reqs]
    # the window's time covers every request, the stalls with them
    assert window_s >= sum(lat) / 1e3
    ms = window.per_request_ms(reqs, window_s)
    assert abs(ms - 1e3 * window_s / len(reqs)) < 1e-9
    assert ms > 1.3 * statistics.median(lat)
    # with one request in ten stalled, the 95th percentile is a stall
    assert window.latency_quantile_ms(reqs, 95) >= 40.0
    assert window.latency_quantile_ms(reqs, 95) == statistics.quantiles(
        lat, n=100, method="inclusive")[94]


def test_no_request_starts_after_the_window():
    reqs, window_s, _ = window.closed_loop(Stalling(), 0.3)
    assert all(r["t0"] - reqs[0]["t0"] < 0.3 + 1e-3 for r in reqs)
