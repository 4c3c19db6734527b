"""The float64 bending balloon step, Newton iteration by Newton iteration, with the float32 pipeline held beside it at the same states.

Step 0 from rest of the port's ``BsrBalloonStepper`` with
``ShellEnergy(bending=True)`` at example 06's settings (the hierarchy
extended to 40 coarsest vertices, as on an accelerator), on bunny_15K or
its midpoint subdivision, on the CPU. At each float64 iterate it prints
one JSON line: the solve's residuals (first and last of its cycles), the
predicted decrease g.dx, the line energy's change at a few step lengths,
the step length the float64 line search takes; and the float32 stepper's
right-hand side g and direction dx at the same state against float64's
(relative 2-norm). This is how ``PERF.md`` reads where float32 parts from
float64 on the bending balloon. The line search is the stepper's own
(``LS_C``, ``LS_P``, ``LS_ALPHA_MIN``) on the float64 energy.

    python tests/torch_bending_newton.py [--subdivided]

About 10 minutes on 4 cores (bunny_15K, 3 GB) or 45 (subdivided, 10 GB).
"""

import argparse
import json
import warnings

import numpy as np
import torch

from surface_multigrid_code_torch import mg_precompute
from surface_multigrid_code_torch.models import balloon as tb
from surface_multigrid_code_torch.models.shell import (
    ShellEnergy,
    energy_and_gradient,
    lame_parameters,
    psd_project_blocks,
)
from surface_multigrid_code_torch.utils.obj_io import read_obj
from surface_multigrid_code_torch.utils.paths import mesh_path
from surface_multigrid_code_torch.utils.synthetic import midpoint_subdivide

DT, THICKNESS, YOUNG, POISSON, PRESSURE = 1e-3, 0.1, 6e6, 0.5, 1e6
ALPHAS = (1.0, 0.5, 0.25, 0.125, 2.0**-7, 2.0**-12)


def newton_pieces(st, curPos0, qdot, fExt):
    """One Newton iteration's pieces at x = curPos0 + dt qdot (qdot0 = 0),
    computed as the stepper computes them, in its dtype: g, dx, the solve's
    residuals, f0 (the step's objective at x), g.dx, and a function giving
    the objective's change at qdot + alpha dx."""
    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64).reshape(-1)).to(st.dtype)

    curPos0, qdot, fExt = t(curPos0), t(qdot), t(fExt)
    Md = st.Mdiag
    x = curPos0 + st.dt * qdot
    Ev0, G = energy_and_gradient(st._energy, x)
    H = [psd_project_blocks(h) for h in st._face_blocks(x, st._face9(x))]
    g = -(Md * qdot + st.dt * G + st.dt * fExt)
    dx, r_his, k = st._solve(st.solver.refresh(st._assemble(H)), g)

    def objective(q):
        xq = curPos0 + st.dt * q
        return float(st._energy(xq) + 0.5 * (q * Md * q).sum() + (xq * fExt).sum())

    f0 = objective(qdot)
    return {"g": g.double().numpy(), "dx": dx.double().numpy(),
            "r": [float(v) for v in r_his[:k]], "f0": f0, "gdx": float((g * dx).sum()),
            "dE": lambda a: objective(qdot + a * dx) - f0}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--subdivided", action="store_true")
    args = ap.parse_args()
    torch.set_num_threads(4)
    warnings.simplefilter("ignore")
    V, F = read_obj(mesh_path("bunny_15K_init"))
    if args.subdivided:
        V, F, _ = midpoint_subdivide(V, F)
    al, be = lame_parameters(YOUNG, POISSON)
    M = 1000.0 * tb.lumped_mass_matrix(V, F)
    mg = mg_precompute(V, F, verbose=False)
    shell = ShellEnergy(V, F, THICKNESS, al, be, "neohookean", bending=True, device="cpu")
    s64, s32 = (tb.BsrBalloonStepper(shell, M, mg, DT, dtype=dt, coarsest_nv=40)
                for dt in (torch.float64, torch.float32))
    fExt = tb.inflation_force(V, F, PRESSURE)
    qdot = np.zeros(V.size)
    for it in range(s64.n_newton):
        a, b = newton_pieces(s64, V, qdot, fExt), newton_pieces(s32, V, qdot, fExt)

        def rel(u, v):
            return float(np.linalg.norm(u - v) / np.linalg.norm(v))

        # the stepper's line search, on the float64 objective
        s = a["gdx"] * tb.LS_C
        alpha = 1.0
        while alpha > tb.LS_ALPHA_MIN and not a["dE"](alpha) <= s:
            alpha *= tb.LS_P
        print(json.dumps({
            "newton": it, "nv": int(V.shape[0]), "cycles": len(a["r"]),
            "residual_first": a["r"][0], "residual_last": a["r"][-1], "f0": a["f0"],
            "gdx": a["gdx"], "dE": {str(x): a["dE"](x) for x in ALPHAS},
            "alpha": alpha if alpha > tb.LS_ALPHA_MIN else None,
            "float32_g_gap": rel(b["g"], a["g"]), "float32_dx_gap": rel(b["dx"], a["dx"]),
            "float32_gdx": b["gdx"]}), flush=True)
        if alpha > tb.LS_ALPHA_MIN:
            qdot = qdot + alpha * a["dx"]
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
