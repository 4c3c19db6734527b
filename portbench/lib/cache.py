"""What depends only on the mesh, kept between runs in ``portbench/.cache/``.

The directory is fixed inside the checkout, so every run of a cell after
the first loads what the first one built. Each file is written under a
temporary name and renamed, so a run that is cut off leaves no half file.
Arrays are stored uncompressed (``np.save`` in an ``.npz``), which loads
in seconds.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

import numpy as np
import scipy.sparse as sp

CACHE_DIR = Path(__file__).resolve().parents[1] / ".cache"


def key(*parts) -> str:
    """A short hash of JSON-serialisable parts (a recipe, a source hash)."""
    return hashlib.sha256(json.dumps(parts, sort_keys=True).encode()).hexdigest()[:16]


def path(name: str) -> Path:
    return CACHE_DIR / name


def _write(target: Path, write) -> None:
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.stem}.partial.npz")
    write(tmp)
    os.replace(tmp, target)


def arrays(name: str, build) -> tuple[dict, bool]:
    """({name: array}, loaded): the arrays saved under ``name``, or those
    ``build()`` returns, saved there first."""
    target = path(name)
    if target.exists():
        with np.load(target) as z:
            return {k: z[k] for k in z.files}, True
    out = build()
    _write(target, lambda tmp: np.savez(tmp, **out))
    return out, False


def csr_arrays(prefix: str, A: sp.csr_matrix) -> dict:
    return {f"{prefix}_data": A.data, f"{prefix}_indices": A.indices,
            f"{prefix}_indptr": A.indptr, f"{prefix}_shape": np.asarray(A.shape)}


def csr_from(z: dict, prefix: str) -> sp.csr_matrix:
    return sp.csr_matrix((z[f"{prefix}_data"], z[f"{prefix}_indices"], z[f"{prefix}_indptr"]),
                         shape=tuple(int(s) for s in z[f"{prefix}_shape"]))


def hierarchy(name: str, build, save, load):
    """(the program's hierarchy, loaded): loaded from ``name`` with the
    program's ``load``, or built by ``build()`` and saved with its ``save``
    first."""
    target = path(name)
    if target.exists():
        return load(target), True
    mg = build()
    _write(target, lambda tmp: save(tmp, mg))
    return mg, False
