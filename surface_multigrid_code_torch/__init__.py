"""surface_multigrid_code_torch: the surface multigrid solver in PyTorch + CUDA.

The port of ``surface_multigrid_code_tpu`` (JAX on a TPU) to PyTorch on an
NVIDIA H100. Module names mirror the JAX package. It carries three paths:

- the static Galerkin multigrid solve: mg_precompute ->
  min_quad_with_fixed_mg_precompute -> build_device_hierarchy ->
  solve_loop / solve_loop_ir -> vcycle;
- mean-curvature flow (``MCFStepper``): per step the barycentric mass, a
  device Galerkin value refresh on the fixed hierarchy
  (``RefreshableMGSolver``) and V-cycles on [n, 3];
- the balloon shell simulation (``models.balloon.run_balloon``): the BSR
  multigrid (``solver="bsr"``), or the scalar cross-check on the
  refreshed solver (``solver="scalar"``).

Host precompute (SSP decimation in the shared C++ engine, Laplacians,
Galerkin plans, colorings) is numpy/scipy; every SpMV of a V-cycle is one
launch of a hand-written CUDA kernel (``csrc/``). The package imports
torch, numpy and scipy, and never jax or the JAX package.
"""

from surface_multigrid_code_torch.config import MGConfig, SolveConfig
from surface_multigrid_code_torch.models.mcf import MCFStepper
from surface_multigrid_code_torch.solver.hierarchy import mg_precompute, mg_precompute_block
from surface_multigrid_code_torch.solver.mqwf_mg import (
    min_quad_with_fixed_mg_precompute,
    min_quad_with_fixed_mg_solve,
)
from surface_multigrid_code_torch.solver.refresh import RefreshableMGSolver

__version__ = "0.1.0"

__all__ = [
    "MCFStepper",
    "MGConfig",
    "RefreshableMGSolver",
    "SolveConfig",
    "mg_precompute",
    "mg_precompute_block",
    "min_quad_with_fixed_mg_precompute",
    "min_quad_with_fixed_mg_solve",
]
