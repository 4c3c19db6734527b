"""The port's jax-free host utilities against the JAX package's, bit for bit.

Each case runs one function of the port and its JAX-package original on
the same numpy inputs (the JAX tests' fixtures: the disk patch of
``tests/test_lscm_utils.py``, the warped grids of
``tests/test_quadrics_param.py``, the meshes of ``tests/test_mesh_utils.py``,
``ogre_sim`` with its 150 boundary vertices) and requires identical
arrays: the same dtype, shape and bits.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp

from surface_multigrid_code_tpu import config as jconfig
from surface_multigrid_code_tpu.ops import laplacian as jlap
from surface_multigrid_code_tpu.ops import lscm as jlscm
from surface_multigrid_code_tpu.solver import host_reference as jhr
from surface_multigrid_code_tpu.ssp import quadrics as jquad
from surface_multigrid_code_tpu.utils import barycentric as jbary
from surface_multigrid_code_tpu.utils import mesh as jmesh
from surface_multigrid_code_tpu.utils import param as jparam

from surface_multigrid_code_torch import config as tconfig
from surface_multigrid_code_torch import mg_precompute
from surface_multigrid_code_torch.ops import laplacian as tlap
from surface_multigrid_code_torch.ops import lscm as tlscm
from surface_multigrid_code_torch.solver import host_reference as thr
from surface_multigrid_code_torch.ssp import quadrics as tquad
from surface_multigrid_code_torch.utils import barycentric as tbary
from surface_multigrid_code_torch.utils import mesh as tmesh
from surface_multigrid_code_torch.utils import param as tparam
from surface_multigrid_code_torch.utils.obj_io import read_obj
from surface_multigrid_code_torch.utils.paths import mesh_path
from surface_multigrid_code_torch.utils.synthetic import icosahedron, icosphere


def hemisphere_patch():
    """The disk patch of tests/test_lscm_utils.py."""
    V, F = icosphere(2)
    keep = V[:, 2] > 0.2
    Fs = F[keep[F].all(axis=1)]
    used = np.unique(Fs)
    remap = -np.ones(V.shape[0], dtype=np.int64)
    remap[used] = np.arange(used.shape[0])
    return V[used], remap[Fs]


def planar_grid():
    """The 4x4 planar grid of tests/test_lscm_utils.py."""
    xs, ys = np.meshgrid(np.arange(4.0), np.arange(4.0))
    V = np.stack([xs.ravel(), ys.ravel(), np.zeros(16)], 1)
    faces = []
    for i in range(3):
        for j in range(3):
            a = i * 4 + j
            faces += [[a, a + 1, a + 5], [a, a + 5, a + 4]]
    return V, np.array(faces)


def grid_mesh(nx=6, ny=5, warp=0.0):
    """The warped grid of tests/test_quadrics_param.py."""
    xs, ys = np.meshgrid(np.linspace(0, 1, nx), np.linspace(0, 1, ny))
    V = np.stack([xs.ravel(), ys.ravel(), warp * np.sin(3 * xs.ravel())], axis=1)
    F = []
    for j in range(ny - 1):
        for i in range(nx - 1):
            a = j * nx + i
            F.append([a, a + 1, a + nx])
            F.append([a + 1, a + nx + 1, a + nx])
    return V, np.asarray(F, dtype=np.int64)


def square_mesh():
    """The two-triangle square of tests/test_mesh_utils.py."""
    V = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], dtype=float)
    return V, np.array([[0, 1, 2], [0, 2, 3]], dtype=np.int64)


def ogre_sim():
    return read_obj(mesh_path("ogre_sim"))


def same(a, b, path="out"):
    """a and b hold the same arrays bit for bit (through tuples, lists,
    dicts and dataclasses); returns the number of arrays compared."""
    if dataclasses.is_dataclass(a):
        return same(dataclasses.asdict(a), dataclasses.asdict(b), path)
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        return sum(same(a[k], b[k], f"{path}.{k}") for k in a)
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        return sum(same(x, y, f"{path}[{i}]") for i, (x, y) in enumerate(zip(a, b)))
    if sp.issparse(a):
        return same(a.toarray(), b.toarray(), path)
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape, b.shape)
    assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), path
    return 1


def _lscm_flatten(mod):
    V, F = hemisphere_patch()
    loop = tmesh.boundary_loops(F)[0]
    b = np.array([loop[0], loop[len(loop) // 2]])
    return mod.lscm_flatten(V, F, b, np.array([[0.0, 0.0], [1.0, 0.0]]))


def _quasi_conformal_error(mod):
    V, F = hemisphere_patch()
    rng = np.random.default_rng(0)
    UV = V[:, :2] + 1e-2 * rng.standard_normal((V.shape[0], 2))
    Vg, Fg = planar_grid()
    return mod.quasi_conformal_error(V, F, UV), mod.quasi_conformal_error(Vg, Fg, Vg[:, :2])


def _vector_area_matrix(mod):
    V, F = hemisphere_patch()
    Vg, Fg = planar_grid()
    return mod.vector_area_matrix(F, V.shape[0]), mod.vector_area_matrix(Fg, 16)


def _mqwf_dense(mod):
    rng = np.random.default_rng(0)
    n = 12
    Q0 = rng.normal(size=(n, n))
    Q = Q0 @ Q0.T + n * np.eye(n)
    data = mod.mqwf_dense_precompute(Q, np.array([0, 5]))
    free = mod.mqwf_dense_precompute(Q, np.array([], dtype=np.int64))
    rhs = rng.normal(size=n)
    return (data, mod.mqwf_dense_solve(data, rhs, np.array([1.0, -2.0])),
            mod.mqwf_dense_solve(free, rhs, np.zeros(0)))


def _cotmatrix_dense(mod):
    return [mod.cotmatrix_dense(*m) for m in (hemisphere_patch(), planar_grid(), icosphere(1))]


def _compute_vertex_quadrics(mod):
    meshes = [grid_mesh(), grid_mesh(warp=0.3), grid_mesh(nx=8, ny=7, warp=0.4), ogre_sim()]
    return [mod.compute_vertex_quadrics(V, F) for V, F in meshes]


def _project_to_disk(mod):
    V, F = grid_mesh(nx=8, ny=7, warp=0.4)
    loop = mod.boundary_loops(F)[0]
    return (mod.project_to_disk(V, F), mod.project_to_disk(*hemisphere_patch()), loop,
            mod.map_vertices_to_circle(V, loop))


def _edges_and_flaps(mod):
    return [mod.edges_and_flaps(F) for _V, F in
            (square_mesh(), icosphere(2), grid_mesh(warp=0.3), ogre_sim())]


def _is_edge_manifold(mod):
    bad = np.array([[0, 1, 2], [0, 1, 3], [1, 0, 2]], dtype=np.int64)
    return [mod.is_edge_manifold(F) for F in (square_mesh()[1], bad, icosphere(2)[1],
                                              ogre_sim()[1])]


def _connect_boundary_to_infinity(mod):
    return [mod.connect_boundary_to_infinity(V, F) for V, F in
            (square_mesh(), icosphere(1), hemisphere_patch(), ogre_sim())]


def _remove_unreferenced(mod):
    V = np.random.default_rng(0).normal(size=(6, 3))
    F = np.array([[0, 2, 4], [2, 4, 5]], dtype=np.int64)
    Vh, Fh = hemisphere_patch()
    return (mod.remove_unreferenced(V, F), mod.remove_unreferenced(V, F[:0]),
            mod.remove_unreferenced(np.vstack([Vh, Vh]), Fh + Vh.shape[0]))


def _internal_angles(mod):
    Vg, Fg = grid_mesh(warp=0.3)
    return [mod.internal_angles(V, F) for V, F in
            (icosphere(1), (Vg[:, :2], Fg), ogre_sim())]


def _triangle_quality(mod):
    F = np.array([[0, 1, 2]])
    flat = np.array([[0, 0, 0], [1, 0, 0], [2, 0, 0]])
    Vg, Fg = grid_mesh(warp=0.3)
    return [mod.triangle_quality(V, F_) for V, F_ in
            ((flat, F), (Vg[:, :2], Fg), icosahedron(), ogre_sim())]


def _compute_barycentric(mod):
    UV = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [1.0, 1.0]])
    F = np.array([[0, 1, 2], [1, 3, 2]])
    rng = np.random.default_rng(1)
    return [mod.compute_barycentric(p, UV, F) for p in
            (np.array([0.25, 0.25]), *rng.uniform(-0.5, 1.5, (8, 2)))]


def _snap_to_best_face(mod):
    rng = np.random.default_rng(2)
    rows = [rng.normal(size=(5, 3)) for _ in range(8)]
    rows.append(np.array([[-1.0, -1.0, -1.0], [-2.0, 0.5, 0.5]]))
    return [mod.snap_to_best_face(B) for B in rows]


def _sequential_gs(mod):
    V, F = icosphere(3)
    mg = mg_precompute(V, F, min_coarsest_nv=40, verbose=False)
    As = [(-tlap.cotmatrix(V, F) + tlap.massmatrix(V, F)).tocsr()]
    Ps = [mg[lv].P_full.tocsr() for lv in range(1, len(mg))]
    for P in Ps:
        As.append((P.T @ As[-1] @ P).tocsr())
    As[-1] = (As[-1] + 1e-12 * sp.identity(As[-1].shape[0])).tocsr()
    rhs = np.random.default_rng(3).standard_normal(V.shape[0])
    ref = mod.SequentialGSReference(As, Ps)
    return ref.solve(rhs, tolerance=1e-9, max_iter=6), ref.solve(rhs, z0=rhs, max_iter=3)


def _lscm_config(mod):
    return dataclasses.asdict(mod.LSCMConfig()), dataclasses.asdict(mod.DEFAULT_LSCM)


CASES = {
    "lscm_flatten": (_lscm_flatten, jlscm, tlscm),
    "quasi_conformal_error": (_quasi_conformal_error, jlscm, tlscm),
    "vector_area_matrix": (_vector_area_matrix, jlscm, tlscm),
    "mqwf_dense": (_mqwf_dense, jlscm, tlscm),
    "cotmatrix_dense": (_cotmatrix_dense, jlap, tlap),
    "compute_vertex_quadrics": (_compute_vertex_quadrics, jquad, tquad),
    "project_to_disk": (_project_to_disk, jparam, tparam),
    "edges_and_flaps": (_edges_and_flaps, jmesh, tmesh),
    "is_edge_manifold": (_is_edge_manifold, jmesh, tmesh),
    "connect_boundary_to_infinity": (_connect_boundary_to_infinity, jmesh, tmesh),
    "remove_unreferenced": (_remove_unreferenced, jmesh, tmesh),
    "internal_angles": (_internal_angles, jmesh, tmesh),
    "triangle_quality": (_triangle_quality, jmesh, tmesh),
    "compute_barycentric": (_compute_barycentric, jbary, tbary),
    "snap_to_best_face": (_snap_to_best_face, jbary, tbary),
    "sequential_gs_reference": (_sequential_gs, jhr, thr),
    "lscm_config": (_lscm_config, jconfig, tconfig),
}


@pytest.mark.parametrize("name", list(CASES))
def test_host_copy_is_bit_identical(name):
    run, jmod, tmod = CASES[name]
    assert same(run(tmod), run(jmod)) > 0


def test_ogre_sim_quadrics_see_its_boundary():
    """The quadrics case runs a mesh with a boundary: ogre_sim's 5,072
    faces and 150 boundary vertices."""
    V, F = ogre_sim()
    assert F.shape[0] == 5072 and tmesh.boundary_vertices(F).size == 150
    E, _EMAP, EF, _EI = tmesh.edges_and_flaps(F)
    assert (EF[:, 1] < 0).sum() == 150
