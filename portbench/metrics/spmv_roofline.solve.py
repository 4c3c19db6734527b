"""spmv_roofline.solve: the least time of the traced solves' SpMV work (its bytes, counted
from the operators' shapes and the cycles done by ``lib/bounds.py``, at the HBM rate) over
the card's busy time in the traced window."""

from portbench.lib.bounds import HBM_BYTES_PER_S


def read(run):
    t = run["trace"]
    traced = [r for r in run["requests"] if r["traced"]]
    if not t or not traced or t["busy_s"] <= 0:
        return None
    least_s = sum(run["session"].least_bytes(r) for r in traced) / HBM_BYTES_PER_S
    return 100.0 * least_s / t["busy_s"]
