"""solve_ms: the window's time over the solves completed in it (host clock)."""

from portbench.lib.window import per_request_ms


def read(run):
    return per_request_ms(run["requests"], run["window_s"])
