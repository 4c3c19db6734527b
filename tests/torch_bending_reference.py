"""The bending balloon of ``chip_smoke.py`` phase 22, run by the JAX package and by the port in float64 on the CPU.

bunny_15K at example 06's settings with ``ShellEnergy(bending=True)``:
``STEPS`` steps from rest of each package's ``BsrBalloonStepper`` (the
hierarchy extended to 40 coarsest vertices, as on an accelerator), step 0
of each package's ``DeviceBalloonStepper`` on its own block hierarchy,
the JAX package's direct step 0 (host splu, ``psd_project=True``), and
on bunny_15K and the midpoint-subdivided bunny, how far each package's
float32 Newton right-hand side at rest, g = -dt (G + fExt) with G the
shell's gradient, lies from its float64 one.
With bending the multigrid solves do not reach ``mg_tolerance`` in
``max_cycles``, and from step 1 some Newton iterations meet a coarsest
operator whose Cholesky factor fails: this records what the reference
itself does there, step by step, and how far the port on the CPU lies
from it. Phase 22 holds the card's float64 steps to these numbers.

    JAX_PLATFORMS=cpu python tests/torch_bending_reference.py > tests/torch_bending_reference.json

About 25 minutes on 4 cores, 8 GB of memory. Exits 1 if a port step lies
more than ``PORT_GAP[k]`` (relative to max|disp|) from the JAX step or
rejects another number of Newton iterations.
"""

import json
import os
import sys
import time
import warnings

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from surface_multigrid_code_tpu.models import balloon as jb  # noqa: E402
from surface_multigrid_code_tpu.models.shell import ShellEnergy as JShell  # noqa: E402
from surface_multigrid_code_tpu.models.shell import _energy_sum as j_energy_sum  # noqa: E402
from surface_multigrid_code_tpu.solver.hierarchy import mg_precompute as jmg  # noqa: E402
from surface_multigrid_code_tpu.solver.hierarchy import mg_precompute_block as jmg_block  # noqa: E402

from surface_multigrid_code_torch import mg_precompute, mg_precompute_block  # noqa: E402
from surface_multigrid_code_torch.convert import shell_state_from_jax  # noqa: E402
from surface_multigrid_code_torch.models import balloon as tb  # noqa: E402
from surface_multigrid_code_torch.models.shell import (  # noqa: E402
    ShellEnergy,
    energy_and_gradient,
    lame_parameters,
)
from surface_multigrid_code_torch.utils.obj_io import read_obj  # noqa: E402
from surface_multigrid_code_torch.utils.paths import mesh_path  # noqa: E402
from surface_multigrid_code_torch.utils.synthetic import midpoint_subdivide  # noqa: E402

MESH = "bunny_15K_init"
STEPS = 3
# example 06 (run_balloon's defaults)
DT, THICKNESS, YOUNG, POISSON, PRESSURE = 1e-3, 0.1, 6e6, 0.5, 1e6
COARSEST_NV = 40
# the port's positions against the JAX package's, per step (max|Δ| over
# max|disp|): step 0 differs by rounding alone (1.4e-11); the regime then
# grows a difference about 500-fold a step (9.9e-9, 5.2e-6)
PORT_GAP = (1e-9, 1e-7, 1e-4)


def jax_force(P, F):
    """The JAX run_balloon's per-step force (inline there)."""
    N = jb.vertex_normals(P, F)
    Mvd = np.asarray(jb.massmatrix(P, F, kind="voronoi").diagonal())
    return (-(N * Mvd[:, None]) * PRESSURE).reshape(-1)


def summary(P, V, stepper, s):
    """max|disp|, mean|disp|, the rejects and the Newton alphas of a step."""
    disp = np.abs(P - V)
    rec = {"max_disp": float(disp.max()), "mean_disp": float(disp.mean()),
           "rejects": int(stepper.last_rejected), "s": s}
    newton = getattr(stepper, "last_newton", None)
    if newton and "alpha" in newton[0]:
        rec["alphas"] = [float(r["alpha"]) for r in newton]
    return rec


def jax_rest_rhs(js, V, fExt, dtype):
    """The JAX steppers' Newton right-hand side at rest in dtype: their
    energy (``_energy_sum`` on the shell's state cast to dtype) and its
    gradient, g = -dt (G + fExt)."""
    bend = (jnp.asarray(js.opp), jnp.asarray(js.mask), js.bbars.astype(dtype))

    def energy(x):
        return j_energy_sum(x, jnp.asarray(js.F), js.abars.astype(dtype), js.thickness,
                            js.alpha, js.beta, js.material, bend=bend)

    G = jax.grad(energy)(jnp.asarray(V.reshape(-1), dtype=dtype))
    return np.asarray(-DT * (G + jnp.asarray(fExt, dtype=dtype)), dtype=np.float64)


def port_rest_rhs(stepper, V, fExt):
    """The same on the port's stepper, in its dtype."""
    x = torch.as_tensor(V.reshape(-1)).to(stepper.dtype)
    _, G = energy_and_gradient(stepper._energy, x)
    return (-stepper.dt * (G + torch.as_tensor(fExt).to(stepper.dtype))).double().numpy()


def rest_departures(V, F, M):
    """||g32 - g64|| / ||g64|| at rest, the JAX package's and the port's."""
    al, be = lame_parameters(YOUNG, POISSON)
    js = JShell(V, F, THICKNESS, al, be, "neohookean", bending=True)
    ts = shell_state_from_jax(
        ShellEnergy(V, F, THICKNESS, al, be, "neohookean", bending=True, device="cpu"),
        np.asarray(js.abars), np.asarray(js.bbars))
    fExt = tb.inflation_force(V, F, PRESSURE)
    j64, j32 = (jax_rest_rhs(js, V, fExt, dt) for dt in (jnp.float64, jnp.float32))
    mg = mg_precompute(V, F, verbose=False)
    t = {}
    for dt in (torch.float64, torch.float32):
        st = tb.BsrBalloonStepper(ts, M, mg, DT, dtype=dt, coarsest_nv=COARSEST_NV)
        t[dt] = port_rest_rhs(st, V, fExt)
        del st
    n64 = np.linalg.norm(j64)
    return {"nv": int(V.shape[0]), "jax": float(np.linalg.norm(j32 - j64) / n64),
            "port": float(np.linalg.norm(t[torch.float32] - t[torch.float64]) / n64),
            "port_float64_gap": float(np.linalg.norm(t[torch.float64] - j64) / n64)}


def main() -> int:
    torch.set_num_threads(4)
    warnings.simplefilter("ignore")  # a reject warns; the counts are recorded
    V, F = read_obj(mesh_path(MESH))
    al, be = lame_parameters(YOUNG, POISSON)
    M = 1000.0 * tb.lumped_mass_matrix(V, F)
    js = JShell(V, F, THICKNESS, al, be, "neohookean", bending=True)
    ts = shell_state_from_jax(
        ShellEnergy(V, F, THICKNESS, al, be, "neohookean", bending=True, device="cpu"),
        np.asarray(js.abars), np.asarray(js.bbars))
    out = {"mesh": MESH, "nv": int(V.shape[0]), "nf": int(F.shape[0]), "dtype": "float64",
           "coarsest_nv": COARSEST_NV, "port_gap_limit": PORT_GAP,
           "jax_bsr": [], "port_bsr": []}
    ok = True

    # BsrBalloonStepper, STEPS steps, each package from its own state
    jstep = jb.BsrBalloonStepper(js, M, jmg(V, F, verbose=False), DT, dtype=jnp.float64,
                                 well=False, coarsest_nv=COARSEST_NV)
    tstep = tb.BsrBalloonStepper(ts, M, mg_precompute(V, F, verbose=False), DT,
                                 dtype=torch.float64, coarsest_nv=COARSEST_NV)
    pj, qj = V.copy(), np.zeros(V.size)
    pt, qt = pj.copy(), qj.copy()
    for k in range(STEPS):
        t0 = time.perf_counter()
        pj, qj = jstep.step(pj, qj, jax_force(pj, F))
        t1 = time.perf_counter()
        pt, qt = tstep.step(pt, qt, tb.inflation_force(pt, F, PRESSURE))
        t2 = time.perf_counter()
        rj, rt = summary(pj, V, jstep, t1 - t0), summary(pt, V, tstep, t2 - t1)
        rt["pos_gap"] = float(np.abs(pt - pj).max()) / rj["max_disp"]
        rt["qdot_gap"] = float(np.abs(qt - qj).max() / np.abs(qj).max())
        ok &= rt["pos_gap"] <= PORT_GAP[k] and rt["rejects"] == rj["rejects"]
        out["jax_bsr"].append(rj)
        out["port_bsr"].append(rt)
        print(json.dumps({"bsr step": k, "jax": rj, "port": rt}), file=sys.stderr, flush=True)
        if k == 0:
            pos_bsr0 = pj
    del jstep, tstep

    # DeviceBalloonStepper, step 0, on each package's own block hierarchy
    fj, ft = jax_force(V, F), tb.inflation_force(V, F, PRESSURE)
    t0 = time.perf_counter()
    jdev = jb.DeviceBalloonStepper(js, M, jmg_block(V, F, verbose=False), DT, dtype=jnp.float64)
    pdj, _ = jdev.step(V.copy(), np.zeros(V.size), fj)
    t1 = time.perf_counter()
    tdev = tb.DeviceBalloonStepper(ts, M, mg_precompute_block(V, F, verbose=False), DT,
                                   dtype=torch.float64)
    pdt, _ = tdev.step(V.copy(), np.zeros(V.size), ft)
    t2 = time.perf_counter()
    rj, rt = summary(pdj, V, jdev, t1 - t0), summary(pdt, V, tdev, t2 - t1)
    rt["pos_gap"] = float(np.abs(pdt - pdj).max()) / rj["max_disp"]
    ok &= rt["pos_gap"] <= PORT_GAP[0] and rt["rejects"] == rj["rejects"]
    rj["bsr_pos_gap"] = float(np.abs(pdj - pos_bsr0).max()) / out["jax_bsr"][0]["max_disp"]
    out["jax_device"], out["port_device"] = rj, rt
    print(json.dumps({"device step 0": {"jax": rj, "port": rt}}), file=sys.stderr, flush=True)
    del jdev, tdev

    # the JAX package's direct step 0
    t0 = time.perf_counter()
    pd, _ = jb.implicit_euler_balloon_direct(js, M, V.copy(), np.zeros(V.size), fj, DT,
                                             verbose=False, psd_project=True)
    direct = float(np.abs(pd - V).max())
    out["jax_direct"] = {"max_disp": direct, "s": time.perf_counter() - t0}
    for key in ("jax_bsr", "port_bsr"):
        out[key][0]["gap_to_direct"] = abs(out[key][0]["max_disp"] - direct) / direct
    for key in ("jax_device", "port_device"):
        out[key]["gap_to_direct"] = abs(out[key]["max_disp"] - direct) / direct
    # float32 at rest, bunny_15K and the subdivided bunny
    out["float32_rest_rhs"] = {"bunny_15K": rest_departures(V, F, M)}
    V2, F2, _ = midpoint_subdivide(V, F)
    out["float32_rest_rhs"]["subdivided"] = rest_departures(
        V2, F2, 1000.0 * tb.lumped_mass_matrix(V2, F2))
    print(json.dumps({"float32_rest_rhs": out["float32_rest_rhs"]}), file=sys.stderr,
          flush=True)
    out["ok"] = bool(ok)
    print(json.dumps(out, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
