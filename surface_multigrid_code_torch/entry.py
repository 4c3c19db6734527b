"""A forward step of the port, the counterpart of ``__graft_entry__.entry()``.

``entry(device)`` returns ``(fn, (hier, b, z0))``: ``fn(hier, b, z0)`` is
one Jacobi V-cycle (2 + 2 sweeps, the residual, Pᵀ, P and the dense
coarse correction, every SpMV one K1 launch on the card) on the system of
``__graft_entry__._system(4)``: A = M - 0.01 L on the fourth midpoint
subdivision of the icosahedron, Galerkin coarse operators Pᵀ A P of the
subdivision hierarchy, b = M V[:, 0], z0 = 0, float32. There is no
windowed layout to select, so it takes no ``well`` argument. The card is
the default device; pass ``device="cpu"`` for the plain PyTorch versions.
"""

from __future__ import annotations

import numpy as np
import torch

DEPTH = 4


def system(depth: int = DEPTH):
    """(As, Ps, rhs) of ``__graft_entry__._system(depth)``."""
    from surface_multigrid_code_torch.ops.laplacian import cotmatrix, massmatrix
    from surface_multigrid_code_torch.utils.synthetic import subdivision_hierarchy

    meshes, Ps = subdivision_hierarchy(depth)
    V, F = meshes[0]
    M = massmatrix(V, F)
    As = [(M - 0.01 * cotmatrix(V, F)).tocsr()]
    for P in Ps:
        As.append((P.T @ As[-1] @ P).tocsr())
    return As, Ps, np.asarray(M @ V[:, 0])


def entry(device="cuda"):
    """(fn, (hier, b, z0)): one Jacobi V-cycle and its float32 inputs on ``device``."""
    from surface_multigrid_code_torch.config import SmootherType, SolveConfig
    from surface_multigrid_code_torch.solver.vcycle import build_device_hierarchy, vcycle
    from surface_multigrid_code_torch.utils.device import resolve_device

    device = resolve_device(device)
    As, Ps, rhs = system()
    cfg = SolveConfig(smoother=SmootherType.JACOBI)
    hier = build_device_hierarchy(As, Ps, cfg=cfg, device=device, dtype=torch.float32)
    b = torch.as_tensor(rhs).to(device=device, dtype=torch.float32)
    z0 = torch.zeros_like(b)

    def fn(hier, b, z0):
        return vcycle(hier, b, z0, cfg)

    return fn, (hier, b, z0)
