"""Seeded inputs made on the device: noisy copies of a mesh's coordinates.

Everything is drawn from one ``torch.Generator`` on the run's device,
seeded with ``--seed``, in a few large calls: the same seed gives the same
inputs on the same kind of card. Every seed gets the same sizes; only the
values differ.
"""

from __future__ import annotations

import torch


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2**64))
    return g


def vertex_normals_and_spacing(V: torch.Tensor, F: torch.Tensor):
    """(unit area-weighted vertex normals [n, 3], mean length of the edges
    at each vertex [n]) on V's device."""
    n = V.shape[0]
    P0, P1, P2 = V[F[:, 0]], V[F[:, 1]], V[F[:, 2]]
    fn = torch.cross(P1 - P0, P2 - P0, dim=1)
    normals = torch.zeros_like(V)
    length = V.new_zeros(n)
    count = V.new_zeros(n)
    ones = V.new_ones(F.shape[0])
    for c in range(3):
        normals.index_add_(0, F[:, c], fn)
        a, b = F[:, (c + 1) % 3], F[:, (c + 2) % 3]
        e = torch.linalg.norm(V[a] - V[b], dim=1)
        # each face edge counts once at each of its two ends
        length.index_add_(0, a, e).index_add_(0, b, e)
        count.index_add_(0, a, ones).index_add_(0, b, ones)
    normals = normals / torch.linalg.norm(normals, dim=1, keepdim=True).clamp_min(1e-300)
    return normals, length / count.clamp_min(1.0)


def start_shape(V: torch.Tensor, F: torch.Tensor, amplitude: float,
                gen: torch.Generator) -> torch.Tensor:
    """V moved along its vertex normals by a uniform random share in
    [-amplitude, amplitude] of each vertex's mean edge length."""
    normals, spacing = vertex_normals_and_spacing(V, F)
    u = 2.0 * torch.rand((V.shape[0],), generator=gen, device=V.device, dtype=V.dtype) - 1.0
    return V + normals * (amplitude * spacing * u)[:, None]
