"""enqueue_ms_per_cycle.solve: the host's time to enqueue one V-cycle in the traced window,
the program's ``smg.cycle`` span (elapsed over count). The cycle makes no sync of its own,
but a cudaMalloc inside it, where the caching allocator has no free block, can block and
counts. The span records only while a profiler session does, so it covers the traced
window alone; a program without it reads nothing."""


def read(run):
    try:
        from surface_multigrid_code_torch.utils.profiler import profiler_snapshot
    except ImportError:
        return None
    count, elapsed_s = profiler_snapshot().get("smg.cycle", (0, 0.0))
    return 1e3 * elapsed_s / count if count else None
