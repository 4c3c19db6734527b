"""Traffic kind ``solve``: a closed loop of static solves of one operator on the mesh's coordinates.

Set-up, all from the configuration and the seed:

- the mesh (``lib/meshes.make_mesh``), its barycentric mass and cotangent
  Laplacian (``reference/laplacian.py``) and A = M - delta L, built by the
  benchmark and cached in ``portbench/.cache/``;
- the program's SSP hierarchy (``mg_precompute``), cached with the
  program's ``save_hierarchy`` under the program's SSP source hash;
- the program's precompute, ``min_quad_with_fixed_mg_precompute(A, None,
  mg, SolveConfig(...), dtype=...)``: the public path, no reordering;
- a pool of right-hand sides B = M U, U a noisy copy of the mesh's
  coordinates made on the device from the seed (``lib/fields.start_shape``).

One request is one ``solve_loop(hier, B, 0, tol, max_iter, cfg)`` on the
next B of the pool, tol the configuration's absolute tolerance; it fails
when its last recorded residual is not below tol (a non-finite one
included). The solutions of the requests drawn from the seed, and of the
last one, are kept and judged against the reference once the window has
closed.
"""

from __future__ import annotations

import random
import time

import numpy as np
import torch

from portbench.lib import bounds, cache, fields, meshes
from portbench.reference import judge
from portbench.reference.laplacian import barycentric_mass, cotmatrix, screened_operator

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def mesh_and_system(config):
    """(V, F, mass, A) of the configuration, cached by its recipe."""
    name = f"{config['name']}-system-{cache.key(config['mesh'], config['system'])}.npz"

    def build():
        V, F = meshes.make_mesh(config["mesh"])
        mass = barycentric_mass(V, F)
        A = screened_operator(mass, cotmatrix(V, F), config["system"]["delta"])
        return {"V": V, "F": F, "mass": mass, **cache.csr_arrays("A", A)}

    z, loaded = cache.arrays(name, build)
    return z["V"], z["F"], z["mass"], cache.csr_from(z, "A"), loaded


def program_hierarchy(config, V, F):
    """The program's SSP hierarchy of (V, F), cached under its source hash."""
    from surface_multigrid_code_torch import load_hierarchy, mg_precompute, save_hierarchy
    from surface_multigrid_code_torch.ssp._native import _source_hash

    name = f"{config['name']}-ssp-{_source_hash()}-{cache.key(config['mesh'])}.npz"
    return cache.hierarchy(name, lambda: mg_precompute(V, F, verbose=False),
                           save_hierarchy, load_hierarchy)


class Phases:
    """Logs the seconds each phase of set-up took, so that a slow set-up
    can be traced to its phase."""

    def __init__(self, log):
        self.log, self.t = log, time.perf_counter()

    def done(self, what: str) -> None:
        now = time.perf_counter()
        self.log(f"set-up phase {now - self.t:.3f} s: {what}")
        self.t = now


def solve_config(config):
    from surface_multigrid_code_torch.config import SmootherType, SolveConfig

    return SolveConfig(smoother=SmootherType(config["smoother"]),
                       pre_relax_iter=config["pre_relax"], post_relax_iter=config["post_relax"],
                       max_iter=config["max_iter"])


def sample_indices(seed: int, count: int, within: int) -> set[int]:
    """The requests whose answers are judged, drawn from the seed."""
    return set(random.Random(seed).sample(range(within), count))


def level_counts(mg) -> list[dict]:
    """(rows, nonzeros, gathered columns) of every host operator the
    precompute left on ``mg`` (A_l, and P_l, P_l^T from level 1 on)."""
    def counts(H):
        return (H.shape[0], H.nnz, int(np.unique(H.indices).size))

    out = []
    for lv, level in enumerate(mg):
        rec = {"A": counts(level.A)}
        if lv:
            rec.update(P=counts(level.P), PT=counts(level.PT))
        out.append(rec)
    return out


class SolveSession:
    def __init__(self, ctx):
        from surface_multigrid_code_torch import min_quad_with_fixed_mg_precompute

        cfg_, p, dev = ctx.config, ctx.params, ctx.device
        clock = Phases(ctx.log)
        self.limits = ctx.workload["limits"]
        self.dtype = DTYPES[cfg_["precision"]]
        self.V, self.F, self.mass, self.A, loaded = mesh_and_system(cfg_)
        mass, A = self.mass, self.A
        clock.done(f"mesh |V| {self.V.shape[0]} |F| {self.F.shape[0]} nnz(A) {A.nnz} "
                   f"({'loaded' if loaded else 'built'})")
        mg, loaded = program_hierarchy(cfg_, self.V, self.F)
        clock.done(f"SSP hierarchy {[lv.V.shape[0] for lv in mg]} "
                   f"({'loaded' if loaded else 'built'})")
        self.cfg = solve_config(cfg_)
        self.data = min_quad_with_fixed_mg_precompute(A, None, mg, self.cfg, device=dev,
                                                      dtype=self.dtype)
        self.levels = level_counts(mg)
        clock.done("the program's precompute")
        self.tol, self.max_iter = cfg_["tolerance"], cfg_["max_iter"]
        gen = fields.generator(ctx.seed, dev)
        Vd = torch.as_tensor(self.V, device=dev)
        Fd = torch.as_tensor(self.F, device=dev)
        m = torch.as_tensor(mass, device=dev)
        self.U = [fields.start_shape(Vd, Fd, p["amplitude"], gen) for _ in range(p["pool"])]
        self.B = [(m[:, None] * U).to(self.dtype).contiguous() for U in self.U]
        self.sample_at = sample_indices(ctx.seed, p["samples"], p["sample_within"])
        self.kept: dict[int, tuple[int, torch.Tensor]] = {}
        self.last = None
        self.clock = clock
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        clock.done("right-hand sides")

    def _solve(self, j):
        from surface_multigrid_code_torch.solver.vcycle import solve_loop

        B = self.B[j]
        return solve_loop(self.data.hier, B, torch.zeros_like(B), self.tol, self.max_iter,
                          self.cfg)

    def warm(self):
        for j in range(min(2, len(self.B))):
            self._solve(j)
        torch.cuda.synchronize() if self.B[0].is_cuda else None
        self.clock.done("warm-up")

    def request(self, i):
        j = i % len(self.B)
        z, r_his, k = self._solve(j)
        r_last = float(r_his[k - 1])
        if i in self.sample_at:
            self.kept[i] = (j, z)
        self.last = (i, j, z)
        return {"cycles": k - 1, "residuals": k, "ok": bool(r_last <= self.tol)}

    def least_bytes(self, rec) -> int:
        """The least bytes of a request's SpMV work: its cycles, and the
        residual the loop records before each cycle and after the last."""
        it = torch.finfo(self.dtype).bits // 8
        C = self.B[0].shape[1]
        cyc = bounds.cycle_spmv_bytes(self.levels, C, it,
                                      self.cfg.pre_relax_iter + self.cfg.post_relax_iter)
        resid = bounds.spmv_counts(*self.levels[0]["A"], C, "resid", it)
        return rec["cycles"] * cyc + rec["residuals"] * resid

    def collect(self):
        """The kept answers on the host, then the program's state freed."""
        if self.last is not None:
            i, j, z = self.last
            self.kept.setdefault(i, (j, z))
        out = {"answers": [(i, j, z.to("cpu", torch.float64).numpy())
                           for i, (j, z) in sorted(self.kept.items())],
               "fields": {j: self.U[j].to("cpu", torch.float64).numpy()
                          for j in {j for j, _ in self.kept.values()}}}
        del self.data, self.B, self.U, self.kept, self.last
        return out

    def judge(self, collected):
        return judge.judge_solve(self.mass, self.A, collected, self.limits)


open_session = SolveSession
