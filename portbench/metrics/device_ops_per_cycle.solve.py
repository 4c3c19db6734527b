"""device_ops_per_cycle.solve: the device operations the profiler recorded in the traced
window (kernels, copies and sets, CUDA graphs' replays included) over the V-cycles done there."""


def read(run):
    trace = run["trace"]
    cycles = sum(r["cycles"] for r in run["requests"] if r["traced"])
    return trace["device_ops"] / cycles if trace and cycles else None
