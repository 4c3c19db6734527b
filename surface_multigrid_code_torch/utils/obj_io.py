"""Wavefront OBJ triangle-mesh IO (ports ``surface_multigrid_code_tpu/utils/obj_io.py``).

Only the V/F subset (positions + triangular faces) is read and written.
Polygonal faces are fan triangulated; texture/normal indices in face
tokens are ignored.
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


def write_obj(path: str, V: np.ndarray, F: np.ndarray) -> None:
    """Write (V, F) as an OBJ file (1-based face indices)."""
    V = np.asarray(V, dtype=np.float64)
    F = np.asarray(F)
    with open(path, "w") as fh:
        for v in V:
            fh.write(f"v {v[0]:.17g} {v[1]:.17g} {v[2]:.17g}\n")
        for f in F:
            fh.write(f"f {f[0] + 1} {f[1] + 1} {f[2] + 1}\n")
