"""The port's CLI against the JAX package's, command by command, in process.

Both run on the same inputs with the JAX package in float64 (x64 on, as
the tests run it) and the port on the CPU (``--device cpu``, float64). The
host commands write the same files; ``solve`` and ``mcf`` agree to
rounding. ``solve`` and ``mcf`` run on icosphere(4), the smallest
icosphere whose default hierarchy (``min_coarsest_nv`` 500) has two
levels: the JAX package's ``solve`` needs a second level.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from surface_multigrid_code_tpu.cli import main as jax_main
from surface_multigrid_code_tpu.solver.hierarchy import load_hierarchy as jax_load_hierarchy
from surface_multigrid_code_tpu.ssp.decimate import load_log as jax_load_log
from surface_multigrid_code_tpu.utils.obj_io import read_obj, write_obj
from surface_multigrid_code_tpu.utils.synthetic import icosphere

from surface_multigrid_code_torch.cli import main

REPO = Path(__file__).resolve().parents[1]
COMMANDS = {
    "decimate": (2, ["-t", "80", "-o", "{p}d.obj", "--log", "{p}log.npz"]),
    "hierarchy": (2, ["--min-coarsest", "40", "-o", "{p}h.npz"]),
    "solve": (4, ["-o", "{p}z.npz"]),
    "mcf": (4, ["--steps", "2", "-o", "{p}m.obj"]),
    "remesh": (2, ["-t", "40", "-n", "1", "-o", "{p}rm"]),
}

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def spheres(tmp_path_factory):
    d = tmp_path_factory.mktemp("spheres")
    out = {}
    for depth in (2, 4):
        out[depth] = d / f"ico{depth}.obj"
        write_obj(out[depth], *icosphere(depth))
    return out


def _run(fn, cmd, mesh, prefix, extra=()):
    depth, args = COMMANDS[cmd]
    fn([cmd, str(mesh), *(a.format(p=prefix) for a in args), *extra])


@pytest.mark.parametrize("cmd", list(COMMANDS))
def test_cli_matches_jax(tmp_path, spheres, capsys, cmd):
    mesh = spheres[COMMANDS[cmd][0]]
    _run(jax_main, cmd, mesh, f"{tmp_path}/j_")
    jax_out = capsys.readouterr().out
    _run(main, cmd, mesh, f"{tmp_path}/t_", ["--device", "cpu"])
    port_out = capsys.readouterr().out
    # the same printed lines, paths aside
    assert port_out.replace("/t_", "/j_") == jax_out
    j, t = f"{tmp_path}/j_", f"{tmp_path}/t_"
    if cmd == "decimate":
        assert all(np.array_equal(a, b) for a, b in zip(read_obj(j + "d.obj"), read_obj(t + "d.obj")))
        lj, lt = jax_load_log(j + "log.npz"), jax_load_log(t + "log.npz")
        assert sorted(lj) == sorted(lt) and all(np.array_equal(lj[k], lt[k]) for k in lj)
    elif cmd == "hierarchy":
        hj, ht = jax_load_hierarchy(j + "h.npz"), jax_load_hierarchy(t + "h.npz")
        assert len(hj) == len(ht) >= 2
        for a, b in zip(hj[1:], ht[1:]):
            assert np.array_equal(a.V, b.V) and (a.P_full != b.P_full).nnz == 0
    elif cmd == "solve":
        zj, zt = np.load(j + "z.npz"), np.load(t + "z.npz")
        assert zj["r_his"].shape == zt["r_his"].shape
        assert np.allclose(zt["r_his"], zj["r_his"], rtol=1e-9)
        assert np.abs(zt["z"] - zj["z"]).max() <= 1e-9 * np.abs(zj["z"]).max()
    elif cmd == "mcf":
        (Uj, Fj), (Ut, Ft) = read_obj(j + "m.obj"), read_obj(t + "m.obj")
        assert np.array_equal(Fj, Ft) and np.abs(Ut - Uj).max() <= 1e-9
    else:
        for s in (0, 1):
            (Vj, Fj), (Vt, Ft) = read_obj(f"{j}rm_s{s}.obj"), read_obj(f"{t}rm_s{s}.obj")
            assert np.array_equal(Fj, Ft) and np.array_equal(Vj, Vt)


def test_cli_default_device_is_the_card(tmp_path, spheres):
    """Without --device cpu the CLI asks for the card, and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _run(main, "decimate", spheres[2], f"{tmp_path}/t_")
    assert not (tmp_path / "t_d.obj").exists()


def test_python_m_runs_the_cli(tmp_path, spheres):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(REPO), env.get("PYTHONPATH", "")) if p)
    out = subprocess.run(
        [sys.executable, "-m", "surface_multigrid_code_torch", "remesh", str(spheres[2]),
         "-t", "40", "-n", "1", "-o", "rm", "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    V1, F1 = read_obj(tmp_path / "rm_s1.obj")
    V0, F0 = read_obj(tmp_path / "rm_s0.obj")
    assert F1.shape[0] == 4 * F0.shape[0]
    assert abs(np.linalg.norm(V1, axis=1).mean() - 1.0) < 0.05
