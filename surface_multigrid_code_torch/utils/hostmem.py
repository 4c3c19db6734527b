"""Host allocator pooling for large-array precompute stages (ports ``surface_multigrid_code_tpu/utils/hostmem.py``).

The host precompute path (SSP log marshalling, ELL/windowed staging,
Galerkin pattern builds) allocates and frees many multi-hundred-MB NumPy
temporaries. glibc serves those via mmap and returns the pages to the
kernel on free, so EVERY temporary pays first-touch page-fault cost.
On some kernels that cost is extreme (the JAX package's record: np.arange
of 17.7M elements took 7-16 s freshly mapped against 0.02 s from pooled
pages, a ~400x difference; benchmarks/probes/probe_hbm_head.py history). Keeping freed pages in the
process heap makes the cost a one-time warmup.

The reference implementation never hits this because Eigen's workspaces
live for the whole decimation (src/SSP_midpoint.cpp keeps V/F/E buffers
across all collapses); the staged array pipeline is the host-side
analog, so we restore the same "allocate once" economics at the
allocator level.

Trade-off: the heap grows to the high-water mark of host staging
(~10 GB at 2.6M-vertex scale) and is not returned until process exit.
Set SMC_TPU_NO_MALLOC_POOL=1 to opt out: the variable keeps the JAX
package's name, so one setting applies to both packages. The port's
``__init__`` applies the pooling at import, as the JAX package's does.
"""

from __future__ import annotations

import ctypes
import os

_M_TRIM_THRESHOLD = -1
_M_MMAP_MAX = -4

_applied = False


def pool_host_allocations() -> bool:
    """Keep freed large allocations in the process heap (glibc only).

    Idempotent, best-effort: returns True when both mallopt calls
    succeed, False on non-glibc platforms or opt-out.
    """
    global _applied
    if _applied:
        return True
    if os.environ.get("SMC_TPU_NO_MALLOC_POOL"):
        return False
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        ok = bool(libc.mallopt(_M_MMAP_MAX, 0))
        ok = bool(libc.mallopt(_M_TRIM_THRESHOLD, 2**31 - 1)) and ok
    except (OSError, AttributeError):
        return False
    _applied = ok
    return ok
