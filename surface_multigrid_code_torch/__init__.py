"""surface_multigrid_code_torch: the surface multigrid solver in PyTorch + CUDA.

The port of ``surface_multigrid_code_tpu`` (JAX on a TPU) to PyTorch on an
NVIDIA H100. Module names mirror the JAX package. It carries these paths:

- the static Galerkin multigrid solve: mg_precompute ->
  min_quad_with_fixed_mg_precompute -> build_device_hierarchy ->
  solve_loop / solve_loop_ir -> vcycle;
- mean-curvature flow (``MCFStepper``): per step the barycentric mass, a
  device Galerkin value refresh on the fixed hierarchy
  (``RefreshableMGSolver``) and V-cycles on [n, 3];
- the balloon shell simulation (``models.balloon.run_balloon``): the BSR
  multigrid (``solver="bsr"``), or the scalar cross-check on the
  refreshed solver (``solver="scalar"``); ``models.balloon.
  DeviceBalloonStepper`` runs the scalar system with the whole Newton
  loop on the device;
- point queries between the levels of an SSP decimation: the host OpenMP
  walk (``query_fine_to_coarse``, ``query_coarse_to_fine``) and the walk on
  the card (``query.device``, kernel K5);
- persistence: the collapse log and the host hierarchy in the JAX
  package's npz formats (``ssp.decimate.save_log``, ``save_hierarchy``),
  the device hierarchies with torch (``save_device_hierarchy``);
- the command line, ``python -m surface_multigrid_code_torch <cmd>``
  (``cli.py``: decimate, hierarchy, solve, mcf, remesh);
- the multi-device paths (``parallel/``), SPMD over a torch.distributed
  process group: ``WellHaloHierarchy`` (the default backend: levels in
  the global induced-RCM ordering, each rank's rows, the halo exchanged
  as two band segments per SpMV, a column-partitioned restriction or a
  replicated level where the band is wider than a block; ``solve`` and
  ``solve_values`` with the value refresh sharded by rank),
  ``HaloHierarchy`` (publish sets gathered per SpMV, the refresh
  replicated), ``build_sharded_hierarchy`` / ``sharded_solve`` (the
  GSPMD layout: the whole vector gathered per SpMV), and
  ``ShardedMCFStepper`` and ``ShardedBalloonNewton`` (``backend="well"``
  or ``"halo"``; with ``parallel.balloon.implicit_euler_mg_balloon_sharded``);
  the ranks start with ``parallel.comm.spawn_ranks`` / ``RankPool`` or any
  launcher that initialises the group.

Host precompute (SSP decimation in the port's copy of the C++ engine,
``native/``, Laplacians, Galerkin plans, colorings) is numpy/scipy; every
SpMV of a V-cycle is one launch of a hand-written CUDA kernel (``csrc/``).
The host utilities of the JAX package are carried as jax-free copies:
``ops.lscm``, ``ssp.quadrics``, ``utils.param``, ``utils.barycentric``,
``utils.mesh``, ``solver.host_reference`` (the sequential-GS oracle);
``utils.profiler`` is the region profiler (``trace=True`` opens a
``torch.profiler`` span), and importing the package pools host
allocations (``utils.hostmem``; ``SMC_TPU_NO_MALLOC_POOL=1`` opts out, as
in the JAX package). The package imports torch, numpy and scipy, and
never jax or the JAX package.
"""

from surface_multigrid_code_torch.utils.hostmem import pool_host_allocations

pool_host_allocations()

from surface_multigrid_code_torch.config import DecimationType, MGConfig, SolveConfig
from surface_multigrid_code_torch.models.mcf import MCFStepper
from surface_multigrid_code_torch.parallel.balloon import ShardedBalloonNewton
from surface_multigrid_code_torch.parallel.halo import HaloHierarchy
from surface_multigrid_code_torch.parallel.mcf import ShardedMCFStepper
from surface_multigrid_code_torch.parallel.spmd import build_sharded_hierarchy, sharded_solve
from surface_multigrid_code_torch.parallel.wellhalo import WellHaloHierarchy
from surface_multigrid_code_torch.query.maps import query_coarse_to_fine, query_fine_to_coarse
from surface_multigrid_code_torch.solver.hierarchy import (
    extend_hierarchy,
    get_prolong,
    get_prolong_block,
    load_hierarchy,
    mg_precompute,
    mg_precompute_block,
    save_hierarchy,
)
from surface_multigrid_code_torch.solver.mqwf_mg import (
    min_quad_with_fixed_mg_precompute,
    min_quad_with_fixed_mg_solve,
)
from surface_multigrid_code_torch.solver.refresh import RefreshableMGSolver
from surface_multigrid_code_torch.solver.serialize import (
    load_device_hierarchy,
    save_device_hierarchy,
)
from surface_multigrid_code_torch.ssp.decimate import SSP_decimate

__version__ = "0.1.0"

__all__ = [
    "DecimationType",
    "HaloHierarchy",
    "MCFStepper",
    "MGConfig",
    "RefreshableMGSolver",
    "SSP_decimate",
    "ShardedBalloonNewton",
    "ShardedMCFStepper",
    "SolveConfig",
    "WellHaloHierarchy",
    "build_sharded_hierarchy",
    "extend_hierarchy",
    "get_prolong",
    "get_prolong_block",
    "load_device_hierarchy",
    "load_hierarchy",
    "mg_precompute",
    "mg_precompute_block",
    "min_quad_with_fixed_mg_precompute",
    "min_quad_with_fixed_mg_solve",
    "query_coarse_to_fine",
    "query_fine_to_coarse",
    "save_device_hierarchy",
    "save_hierarchy",
    "sharded_solve",
]
