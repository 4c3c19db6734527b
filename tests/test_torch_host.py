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
import pytest
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


def test_orderings_bitwise_on_icosphere4():
    """finest_rcm, induced_orderings, permute_hierarchy and
    nnz_permutation_map on icosphere(4)'s hierarchy give the JAX package's
    arrays bit for bit."""
    from surface_multigrid_code_tpu.solver import ordering as jord

    from surface_multigrid_code_torch.solver import ordering as tord

    V, F = icosphere(4)
    mg = mg_precompute(V, F, verbose=False)
    A = (tlap.massmatrix(V, F) - 0.01 * tlap.cotmatrix(V, F)).tocsr()
    Ps = [lv.P_full.tocsr() for lv in mg[1:]]
    As = [A]
    for P in Ps:
        As.append((P.T @ As[-1] @ P).tocsr())
    p0 = tord.finest_rcm(A)
    assert np.array_equal(p0, jord.finest_rcm(A))
    perms, permsj = tord.induced_orderings(p0, Ps), jord.induced_orderings(p0, Ps)
    assert len(perms) == len(permsj) == len(As) >= 2
    for a, b in zip(perms, permsj):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    ours, theirs = tord.permute_hierarchy(As, Ps, perms), jord.permute_hierarchy(As, Ps, perms)
    for a, b in zip(ours, theirs):
        for x, y in zip(a, b):
            _same_csr(x, y)
            assert np.array_equal(x.data, y.data)
    assert np.array_equal(tord.nnz_permutation_map(A, p0), jord.nnz_permutation_map(A, p0))


def test_mg_precompute_block_bitwise_on_icosphere3():
    """mg_precompute_block (3-expanded prolongations on xyz-interleaved
    DOFs) gives the JAX package's levels bit for bit."""
    from surface_multigrid_code_tpu.solver.hierarchy import mg_precompute_block as jblock

    from surface_multigrid_code_torch import mg_precompute_block

    V, F = icosphere(3)
    mg = mg_precompute_block(V, F, min_coarsest_nv=30, verbose=False)
    mgj = jblock(V, F, min_coarsest_nv=30, verbose=False)
    assert len(mg) == len(mgj) == 3
    for fine, lv, lj in zip(mg[:-1], mg[1:], mgj[1:]):
        assert np.array_equal(lv.V, lj.V) and np.array_equal(lv.F, lj.F)
        assert lv.P_full.shape == (3 * fine.V.shape[0], 3 * lv.V.shape[0])
        _same_csr(lv.P_full, lj.P_full)
        _same_csr(lv.PT, lj.PT)
        assert (lv.dec_type, lv.ratio) == (lj.dec_type, lj.ratio)


def test_native_engine_is_the_port_s_own_byte_identical_copy():
    """The port builds the SSP engine from its own copy of the C++ sources,
    byte for byte the JAX package's."""
    from surface_multigrid_code_torch.ssp import _native

    assert _native._NATIVE_DIR == REPO / "surface_multigrid_code_torch" / "native"
    for name in _native._SOURCES:
        ours = (_native._NATIVE_DIR / name).read_bytes()
        assert ours == (REPO / "surface_multigrid_code_tpu" / "native" / name).read_bytes(), name
    assert "surface_multigrid_code_tpu" not in Path(_native.__file__).read_text().split('"""')[2]


def test_write_obj_boundary_loops_upsample_bitwise(tmp_path):
    """write_obj writes the same bytes, boundary_loops the same loops and
    upsample_barycentric the same arrays as the JAX package's."""
    from surface_multigrid_code_tpu.utils.mesh import boundary_loops as jloops
    from surface_multigrid_code_tpu.utils.obj_io import write_obj as jwrite
    from surface_multigrid_code_tpu.utils.upsample import upsample_barycentric as jup

    from surface_multigrid_code_torch.utils.mesh import boundary_loops
    from surface_multigrid_code_torch.utils.obj_io import write_obj
    from surface_multigrid_code_torch.utils.upsample import upsample_barycentric

    V, F = read_obj(mesh_path("ogre"))
    write_obj(tmp_path / "t.obj", V, F)
    jwrite(tmp_path / "j.obj", V, F)
    assert (tmp_path / "t.obj").read_bytes() == (tmp_path / "j.obj").read_bytes()
    loops, jl = boundary_loops(F), jloops(F)
    assert len(loops) == len(jl) >= 1
    assert all(np.array_equal(a, b) and a.dtype == b.dtype for a, b in zip(loops, jl))
    Vs, Fs = icosphere(1)
    ours, theirs = upsample_barycentric(Vs, Fs, 2), jup(Vs, Fs, 2)
    for a, b in zip(ours[:3], theirs[:3]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert all(np.array_equal(a, b) for a, b in zip(ours[3], theirs[3]))


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
        "for need in ('cli', 'query.device', 'solver.serialize', 'utils.upsample',\n"
        "             'solver.ordering', 'parallel.comm', 'parallel.halo', 'parallel.mcf',\n"
        "             'parallel.wellhalo', 'parallel.spmd',\n"
        "             'parallel.balloon', 'ops.lscm', 'utils.barycentric', 'ssp.quadrics',\n"
        "             'utils.param', 'solver.host_reference', 'utils.profiler',\n"
        "             'utils.hostmem', 'utils.mesh', 'bench', 'entry', 'utils.bounds',\n"
        "             'probes.psd_precision', 'probes.psd_stages', 'probes.bf16_values',\n"
        "             'probes.staged_spmv', 'probes.band_spmv', 'utils.timing'):\n"
        "    assert pkg.__name__ + '.' + need in names, need\n"
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


def _same_plan_level(a, b):
    for f in ("gat_idx", "gat_w", "tail_idx", "tail_w", "tail_seg", "ell_gather",
              "ell_indices", "diag_idx"):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.shape == y.shape and np.array_equal(x, y), f
    assert (a.nnz_in, a.nnz_out, tuple(a.ell_shape)) == (b.nnz_in, b.nnz_out, tuple(b.ell_shape))


def test_galerkin_plan_slot_map_and_extension_bitwise():
    """build_galerkin_plan, csr_slot_map and extend_hierarchy on icosphere(3)
    give the JAX package's arrays bit for bit; galerkin_chain its values."""
    from surface_multigrid_code_tpu.solver import galerkin as jgal
    from surface_multigrid_code_tpu.solver.hierarchy import extend_hierarchy as jextend
    from surface_multigrid_code_tpu.solver.refresh import csr_slot_map as jslot

    from surface_multigrid_code_torch.solver import galerkin as tgal
    from surface_multigrid_code_torch.solver.hierarchy import extend_hierarchy
    from surface_multigrid_code_torch.solver.refresh import csr_slot_map

    V, F = icosphere(3)
    mg = mg_precompute(V, F, min_coarsest_nv=100, verbose=False)
    mgj = jax_mg_precompute(V, F, min_coarsest_nv=100, verbose=False)
    ext = extend_hierarchy(mg, min_coarsest_nv=10)
    extj = jextend(mgj, min_coarsest_nv=10)
    assert len(ext) == len(extj) > len(mg)
    for lv, lj in zip(ext[1:], extj[1:]):
        assert np.array_equal(lv.V, lj.V) and np.array_equal(lv.F, lj.F)
        _same_csr(lv.P_full, lj.P_full)

    A = (tlap.massmatrix(V, F) - 0.01 * tlap.cotmatrix(V, F)).tocsr()
    Ps = [lv.P_full for lv in ext[1:]]
    plan = tgal.build_galerkin_plan(A, Ps)
    planj = jgal.build_galerkin_plan(A, [lv.P_full for lv in extj[1:]])
    assert len(plan.levels) == len(planj.levels) == len(Ps)
    for a, b in zip((plan.lvl0, *plan.levels), (planj.lvl0, *planj.levels)):
        _same_plan_level(a, b)
        _same_csr(tgal.plan_pattern(a), jgal.plan_pattern(b))
    As = tgal.galerkin_chain(A, Ps)
    Aj = jgal.galerkin_chain(A, Ps)
    for a, b in zip(As, Aj):
        assert np.array_equal(a.indptr, b.indptr) and np.array_equal(a.indices, b.indices)
        assert np.abs(a.data - b.data).max() <= 1e-13 * np.abs(b.data).max()

    rng = np.random.default_rng(2)
    k = rng.integers(0, A.nnz, size=500)
    rows = np.repeat(np.arange(A.shape[0]), np.diff(A.indptr))[k]
    cols = A.indices[k]
    assert np.array_equal(csr_slot_map(A, rows, cols), jslot(A, rows, cols))
    with pytest.raises(ValueError):
        csr_slot_map(A, np.array([0]), np.array([A.shape[0] - 1]))


def test_c_entry_points_match_their_ctypes_signatures():
    """Every ``extern "C"`` entry point of ``csrc/*.cu`` has its ctypes
    argument list in ``_build.SIGNATURES``, and no other name does: a
    pointer is ``c_void_p``, a double ``c_double``, anything else
    ``c_int`` (a pointer passed as an int would be cut to 32 bits). The
    sources cannot be compiled here, so this is their only check off the
    card."""
    import ctypes
    import re

    from surface_multigrid_code_torch._build import SIGNATURES, SOURCES

    found = {}
    for src in SOURCES:
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
            found[m.group(1)] = [
                ctypes.c_void_p if "*" in p else
                ctypes.c_double if p.strip().startswith("double") else ctypes.c_int
                for p in m.group(2).split(",")]
    assert found.keys() == SIGNATURES.keys()
    for name, args in found.items():
        assert SIGNATURES[name] == args, name
