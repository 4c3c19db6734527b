"""Command-line interface: ``python -m surface_multigrid_code_torch <cmd> [--device cpu]``.

The counterpart of the JAX package's CLI (``surface_multigrid_code_tpu/cli.py``),
with its commands, arguments, defaults, printed lines and output files:

  decimate   SSP-decimate a mesh, save the coarse mesh + collapse log
  hierarchy  build + serialize a full multigrid hierarchy
  solve      Poisson solve (A = -L, B = M@1) with the longest boundary loop pinned
  mcf        mean-curvature flow (device-resident stepper)
  remesh     subdivision remeshing (decimate -> upsample -> map back)
  bench      the port's benchmark (``bench.py``): one JSON line

Every command takes ``--device``, the card (``cuda``) unless ``--device
cpu`` is given; without a card the default raises, there is no fallback.
``solve`` and ``mcf`` run on that device, in float32 on the card and
float64 on the CPU (the JAX package picks by its x64 flag). ``decimate``,
``hierarchy`` and ``remesh`` are host work (the native SSP engine and the
host OpenMP walk, as in the JAX package). ``bench`` is the counterpart of
the JAX CLI's, which runs the repository's ``bench.py``: on the card the
icosphere(9) headline, the icosphere(7) detail and the balloon step; with
``--device cpu`` the small float64 case (``bench.py``'s docstring).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def _load(path):
    from surface_multigrid_code_torch.utils.obj_io import read_obj

    V, F = read_obj(path)
    print(f"loaded {path}: |V| {V.shape[0]}, |F| {F.shape[0]}")
    return V, F


def _dtype(device: torch.device) -> torch.dtype:
    return torch.float32 if device.type == "cuda" else torch.float64


def cmd_decimate(args):
    from surface_multigrid_code_torch.ssp.decimate import SSP_decimate, save_log
    from surface_multigrid_code_torch.utils.obj_io import write_obj

    V, F = _load(args.mesh)
    ok, Vc, Fc, IMF, IM, log = SSP_decimate(
        V, F, args.target_faces, args.dec_type, seed=args.seed, verbose=True
    )
    if not ok:
        sys.exit("decimation failed (non-manifold input?)")
    write_obj(args.output, Vc, Fc)
    print(f"wrote {args.output}")
    if args.log:
        save_log(args.log, log)
        print(f"wrote collapse log {args.log}")


def cmd_hierarchy(args):
    from surface_multigrid_code_torch.solver.hierarchy import mg_precompute, save_hierarchy

    V, F = _load(args.mesh)
    mg = mg_precompute(
        V, F, ratio=args.ratio, min_coarsest_nv=args.min_coarsest,
        dec_type=args.dec_type,
    )
    save_hierarchy(args.output, mg)
    print(f"wrote hierarchy ({len(mg)} levels) to {args.output}")


def cmd_solve(args):
    from surface_multigrid_code_torch import (
        mg_precompute,
        min_quad_with_fixed_mg_precompute,
        min_quad_with_fixed_mg_solve,
    )
    from surface_multigrid_code_torch.ops.laplacian import cotmatrix, massmatrix
    from surface_multigrid_code_torch.utils.mesh import boundary_loops, normalize_unit_area

    V, F = _load(args.mesh)
    V = normalize_unit_area(V, F)
    mg = mg_precompute(V, F)
    A = (-cotmatrix(V, F)).tocsr()
    B = np.asarray(massmatrix(V, F) @ np.ones(V.shape[0]))
    loops = boundary_loops(F)
    known = loops[0] if loops else np.array([0])
    B[known] = 0.0
    data = min_quad_with_fixed_mg_precompute(
        A, known, mg, device=args.device, dtype=_dtype(args.device))
    z, r_his, ok = min_quad_with_fixed_mg_solve(
        data, B, known_val=np.zeros(known.shape[0]),
        tolerance=args.tolerance, max_iter=args.max_iter,
    )
    print("residuals:", ["%.3e" % r for r in r_his], "converged:", ok)
    if args.output:
        np.savez(args.output, z=z, r_his=np.asarray(r_his))
        print(f"wrote {args.output}")


def cmd_mcf(args):
    from surface_multigrid_code_torch.models.mcf import MCFStepper
    from surface_multigrid_code_torch.solver.hierarchy import mg_precompute
    from surface_multigrid_code_torch.utils.mesh import normalize_unit_area
    from surface_multigrid_code_torch.utils.obj_io import write_obj

    V, F = _load(args.mesh)
    V = normalize_unit_area(V, F)
    mg = mg_precompute(V, F)
    stepper = MCFStepper(V, F, mg, delta=args.delta, dtype=_dtype(args.device),
                         device=args.device)
    U = V.copy()
    for step in range(args.steps):
        U, r_his, ok = stepper.step(U)
        print(f"step {step}: {len(r_his)} cycles, resid {r_his[-1]:.3e}")
    write_obj(args.output, U, F)
    print(f"wrote {args.output}")


def cmd_remesh(args):
    from surface_multigrid_code_torch.query.maps import query_coarse_to_fine
    from surface_multigrid_code_torch.ssp.decimate import SSP_decimate
    from surface_multigrid_code_torch.utils.obj_io import write_obj
    from surface_multigrid_code_torch.utils.upsample import upsample_barycentric

    VO, FO = _load(args.mesh)
    ok, V, F, IMF, IM, log = SSP_decimate(
        VO, FO, args.target_faces, args.dec_type, seed=args.seed
    )
    if not ok:
        sys.exit("decimation failed")
    BC, BF, FIdx, faces = upsample_barycentric(V, F, args.subdivs)
    BC, BF, FIdx = query_coarse_to_fine(log, BC, BF, FIdx)
    SV = (BC[:, :, None] * VO[BF]).sum(axis=1)
    for it, Fk in enumerate(faces):
        out = f"{args.output_prefix}_s{it}.obj"
        write_obj(out, SV[: Fk.max() + 1], Fk)
        print(f"wrote {out}")


def cmd_bench(args):
    from surface_multigrid_code_torch import bench

    cache = [] if args.cache_dir is None else ["--cache-dir", args.cache_dir]
    rc = bench.main(["--device", str(args.device), *cache])
    if rc:
        sys.exit(rc)


def main(argv=None):
    from surface_multigrid_code_torch.utils.device import resolve_device

    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default="cuda",
                        help="the card (cuda, the default) or cpu")
    ap = argparse.ArgumentParser(prog="surface_multigrid_code_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("decimate", help="SSP decimation", parents=[common])
    p.add_argument("mesh")
    p.add_argument("-t", "--target-faces", type=int, default=500)
    p.add_argument("-d", "--dec-type", type=int, default=1, choices=(0, 1, 2))
    p.add_argument("-s", "--seed", type=int, default=None,
                   help="use the randomized variant with this seed")
    p.add_argument("-o", "--output", default="decimated.obj")
    p.add_argument("--log", default=None, help="save the collapse log (npz)")
    p.set_defaults(fn=cmd_decimate)

    p = sub.add_parser("hierarchy", help="build + serialize a hierarchy", parents=[common])
    p.add_argument("mesh")
    p.add_argument("--ratio", type=float, default=0.25)
    p.add_argument("--min-coarsest", type=int, default=500)
    p.add_argument("-d", "--dec-type", type=int, default=1, choices=(0, 1, 2))
    p.add_argument("-o", "--output", default="hierarchy.npz")
    p.set_defaults(fn=cmd_hierarchy)

    p = sub.add_parser("solve", help="Poisson solve", parents=[common])
    p.add_argument("mesh")
    p.add_argument("--tolerance", type=float, default=1e-3)
    p.add_argument("--max-iter", type=int, default=20)
    p.add_argument("-o", "--output", default=None)
    p.set_defaults(fn=cmd_solve)

    p = sub.add_parser("mcf", help="mean-curvature flow", parents=[common])
    p.add_argument("mesh")
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--delta", type=float, default=0.01)
    p.add_argument("-o", "--output", default="mcf.obj")
    p.set_defaults(fn=cmd_mcf)

    p = sub.add_parser("remesh", help="subdivision remeshing", parents=[common])
    p.add_argument("mesh")
    p.add_argument("-t", "--target-faces", type=int, default=500)
    p.add_argument("-d", "--dec-type", type=int, default=1, choices=(0, 1, 2))
    p.add_argument("-n", "--subdivs", type=int, default=2)
    p.add_argument("-s", "--seed", type=int, default=None)
    p.add_argument("-o", "--output-prefix", default="remesh")
    p.set_defaults(fn=cmd_remesh)

    p = sub.add_parser("bench", help="the port's benchmark (one JSON line)", parents=[common])
    p.add_argument("--cache-dir", default=None,
                   help="where the SSP hierarchies are cached (default: the package's "
                        "build directory; '' builds them every run)")
    p.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    args.device = resolve_device(args.device)
    args.fn(args)


if __name__ == "__main__":
    main()
