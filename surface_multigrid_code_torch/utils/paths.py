"""Repo-relative data paths (ports ``surface_multigrid_code_tpu/utils/paths.py``)."""

from __future__ import annotations

import os

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
MESH_DIR = os.path.join(_REPO_ROOT, "data", "meshes")


def mesh_path(name: str) -> str:
    """Path of a bundled test mesh (``data/meshes/<name>.obj``)."""
    if not name.endswith(".obj"):
        name += ".obj"
    return os.path.join(MESH_DIR, name)
