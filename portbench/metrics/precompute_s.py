"""precompute_s: the host-clock seconds of the program's precompute in set-up, its
``smg.precompute`` region (always recorded; one precompute a run). A program without
the region reads nothing."""


def read(run):
    try:
        from surface_multigrid_code_torch.utils.profiler import profiler_snapshot
    except ImportError:
        return None
    count, elapsed_s = profiler_snapshot().get("smg.precompute", (0, 0.0))
    return elapsed_s if count else None
