"""Wavefront OBJ triangle-mesh reading (ports ``surface_multigrid_code_tpu/utils/obj_io.py``).

Only the V/F subset (positions + triangular faces) is read. Polygonal faces
are fan triangulated; texture/normal indices in face tokens are ignored.
"""

from __future__ import annotations

import numpy as np


def read_obj(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read an OBJ file; returns (V float64 [n,3], F int32 [m,3])."""
    verts: list[list[float]] = []
    faces: list[list[int]] = []
    with open(path, "r") as fh:
        for line in fh:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) for tok in line.split()[1:]]
                # OBJ is 1-based; negative indices count from the end.
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append([idx[0], idx[k], idx[k + 1]])
    V = np.asarray(verts, dtype=np.float64)
    F = np.asarray(faces, dtype=np.int32).reshape(-1, 3)
    return V, F
