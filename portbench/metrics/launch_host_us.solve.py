"""launch_host_us.solve: the host's time in one call of the program's SpMV launch path
(``fused_spmv``, entry to return) in the traced window, the program's ``smg.spmv``
counter (elapsed over count); a cudaMalloc of its output, where the caching allocator has
no free block, counts too. It records only while a profiler session does; a program
without it reads nothing."""


def read(run):
    try:
        from surface_multigrid_code_torch.utils.profiler import profiler_snapshot
    except ImportError:
        return None
    count, elapsed_s = profiler_snapshot().get("smg.spmv", (0, 0.0))
    return 1e6 * elapsed_s / count if count else None
