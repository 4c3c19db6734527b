"""surface_multigrid_code_torch: the surface multigrid solver in PyTorch + CUDA.

The port of ``surface_multigrid_code_tpu`` (JAX on a TPU) to PyTorch on an
NVIDIA H100. Module names mirror the JAX package. This slice carries the
static Galerkin multigrid solve:

    mg_precompute -> min_quad_with_fixed_mg_precompute
      -> build_device_hierarchy -> solve_loop / solve_loop_ir -> vcycle

Host precompute (SSP decimation in the shared C++ engine, Laplacians,
Galerkin products, colorings) is numpy/scipy; every SpMV of the V-cycle is
one launch of the fused CSR kernel in ``csrc/spmv.cu``. The package
imports torch, numpy and scipy, and never jax or the JAX package.
"""

from surface_multigrid_code_torch.config import MGConfig, SolveConfig
from surface_multigrid_code_torch.solver.hierarchy import mg_precompute
from surface_multigrid_code_torch.solver.mqwf_mg import (
    min_quad_with_fixed_mg_precompute,
    min_quad_with_fixed_mg_solve,
)

__version__ = "0.1.0"

__all__ = [
    "MGConfig",
    "SolveConfig",
    "mg_precompute",
    "min_quad_with_fixed_mg_precompute",
    "min_quad_with_fixed_mg_solve",
]
