"""latency_p95_ms: the 95th percentile of every request's latency in the window (host clock)."""

from portbench.lib.window import latency_quantile_ms


def read(run):
    return latency_quantile_ms(run["requests"], 95)
