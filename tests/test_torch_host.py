"""The port's host modules against the JAX package's, and its import boundary.

The port carries its own copies of the jax-free host code (Laplacians, the
SSP engine binding, mg_precompute); on the same inputs they must give
bit-identical results. The port itself must import neither jax nor the
JAX package, which the GPU machine does not have.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from surface_multigrid_code_tpu.ops import laplacian as jlap
from surface_multigrid_code_tpu.solver.hierarchy import mg_precompute as jax_mg_precompute
from surface_multigrid_code_tpu.utils.mesh import normalize_unit_area as jnorm
from surface_multigrid_code_tpu.utils.obj_io import read_obj as jread
from surface_multigrid_code_tpu.utils.paths import mesh_path as jpath
from surface_multigrid_code_tpu.utils.synthetic import icosphere as jico

from surface_multigrid_code_torch import mg_precompute
from surface_multigrid_code_torch.ops import laplacian as tlap
from surface_multigrid_code_torch.utils.mesh import boundary_vertices, normalize_unit_area
from surface_multigrid_code_torch.utils.obj_io import read_obj
from surface_multigrid_code_torch.utils.paths import mesh_path
from surface_multigrid_code_torch.utils.synthetic import icosphere

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _same_csr(a, b):
    a, b = a.tocsr(), b.tocsr()
    assert a.shape == b.shape
    assert np.array_equal(a.indptr, b.indptr)
    assert np.array_equal(a.indices, b.indices)
    assert np.array_equal(a.data, b.data)


def test_laplacian_bitwise_on_ogre_sim():
    V, F = read_obj(mesh_path("ogre_sim"))
    Vj, Fj = jread(jpath("ogre_sim"))
    assert np.array_equal(V, Vj) and np.array_equal(F, Fj)
    V = normalize_unit_area(V, F)
    assert np.array_equal(V, jnorm(Vj, Fj))
    _same_csr(tlap.cotmatrix(V, F), jlap.cotmatrix(V, F))
    for kind in ("voronoi", "barycentric"):
        _same_csr(tlap.massmatrix(V, F, kind), jlap.massmatrix(V, F, kind))
    from surface_multigrid_code_tpu.utils.mesh import boundary_vertices as jbv

    assert np.array_equal(boundary_vertices(F), jbv(F))


def test_mg_precompute_bitwise_on_icosphere4():
    V, F = icosphere(4)
    Vj, Fj = jico(4)
    assert np.array_equal(V, Vj) and np.array_equal(F, Fj)
    mg = mg_precompute(V, F, verbose=False)
    mgj = jax_mg_precompute(Vj, Fj, verbose=False)
    assert len(mg) == len(mgj) >= 2
    for lv, lj in zip(mg[1:], mgj[1:]):
        assert np.array_equal(lv.V, lj.V) and np.array_equal(lv.F, lj.F)
        _same_csr(lv.P_full, lj.P_full)
        _same_csr(lv.PT, lj.PT)


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, import without jax."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import surface_multigrid_code_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.startswith('surface_multigrid_code_tpu')]\n"
        "assert not bad, bad\n"
        "assert len(names) >= 20, names\n"
        "print(len(names))\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), env.get("PYTHONPATH", "")) if p
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
