"""Balloon inflation simulation (reference example 06; ports ``surface_multigrid_code_tpu/models/balloon.py``).

Nonlinear implicit Euler with multigrid Newton solves
(sim_utils/implicit_euler_mg_balloon.h:18-124), per Newton iteration (x10):

    K   = stretching Hessian at curPos (per-face blocks, PSD-projected)
    H   = M + dt^2 K
    g   = -(M (qdot - qdot0) + dt G + dt fExt)
    dx  = multigrid solve H dx = g  (block hierarchy reused, Galerkin
          values refreshed, tol 2e-1 - reference main.cpp:42)
    backtracking line search on E(qdot + alpha dx) with c = 1e-8, p = 0.5
    qdot += alpha dx;  curPos = curPos0 + dt * qdot

per outer step (main.cpp:113-122): fExt = -N_v * M_v * 1e6 (inflation
pressure along vertex normals), M = 1000 * 3-expanded lumped mass.

``run_balloon(solver="bsr")`` drives ``BsrBalloonStepper``: the Hessian
lives as 3x3 blocks on the vertex graph and every solve runs the BSR
multigrid of ``solver/bsr.py`` (kernels K2, K3; the projection runs K4).
``implicit_euler_balloon_direct`` is the host sparse-LU oracle.
"""

from __future__ import annotations

import time
import warnings

import numpy as np
import scipy.sparse as sp
import torch

from surface_multigrid_code_torch.config import SmootherType, SolveConfig
from surface_multigrid_code_torch.models.shell import (
    ShellEnergy,
    _energy_sum,
    energy_and_gradient,
    face_bending_energy,
    face_energy,
    lame_parameters,
    psd_project_blocks,
)
from surface_multigrid_code_torch.ops.laplacian import massmatrix
from surface_multigrid_code_torch.solver.bsr import BsrRefreshableSolver, bsr_solve_loop
from surface_multigrid_code_torch.solver.galerkin import _ellize_segments
from surface_multigrid_code_torch.solver.hierarchy import extend_hierarchy, mg_precompute
from surface_multigrid_code_torch.solver.refresh import csr_slot_map

PHASES = ("assembly", "psd", "refresh", "vcycles", "line_search")


def lumped_mass_matrix(V, F) -> sp.csr_matrix:
    """3-expanded lumped (voronoi) mass matrix over interleaved xyz DOFs
    (sim_utils/lumped_mass_matrix.cpp)."""
    Mv = massmatrix(V, F, kind="voronoi")
    d = np.asarray(Mv.diagonal())
    return sp.diags(np.repeat(d, 3)).tocsr()


def vertex_normals(V, F) -> np.ndarray:
    """Area-weighted per-vertex normals (igl::per_vertex_normals default)."""
    V = np.asarray(V, dtype=np.float64)
    F = np.asarray(F, dtype=np.int64)
    fn = np.cross(V[F[:, 1]] - V[F[:, 0]], V[F[:, 2]] - V[F[:, 0]])
    N = np.zeros_like(V)
    for c in range(3):
        np.add.at(N, F[:, c], fn)
    nrm = np.linalg.norm(N, axis=1, keepdims=True)
    nrm[nrm == 0] = 1.0
    return N / nrm


class BsrBalloonStepper:
    """Implicit-Euler balloon step with the BSR (3x3-block) multigrid, on
    the shell's device.

    10 Newton iterations of H dx = -g with H = M + dt^2 K and a backtracking
    line search (reference implicit_euler_mg_balloon.h:40-120). Takes the
    SCALAR hierarchy from mg_precompute: the reference's 3-expanded block
    prolongation (src/get_prolong.cpp:59-115) is the same scalar weight on
    each DOF of a vertex.

    coarsest_nv: the hierarchy is extended down to about this many coarsest
    vertices (``extend_hierarchy``), since every Newton iteration pays a
    dense Cholesky inverse of the coarsest operator. As in the JAX package
    the default depends on the device: 40 on an accelerator, 0 (the
    hierarchy as given) on the CPU. dtype: float32 on an accelerator,
    float64 on the CPU unless given.

    PyTorch runs eagerly, so the Newton loop and the line search are
    Python loops: each line-search trial and each V-cycle costs one host
    sync. After ``step``, ``last_rejected`` counts the Newton iterations
    whose direction was rejected and ``last_newton`` holds one record per
    iteration (the residuals the solve loop recorded, one more than the
    V-cycles it ran once converged; whether it reached the tolerance;
    alpha; and with ``timed = True`` the
    host seconds per phase of ``PHASES``, each phase closed by a device
    sync).
    """

    def __init__(self, shell: ShellEnergy, M: sp.csr_matrix, mg, dt: float,
                 mg_tolerance: float = 2e-1, n_newton: int = 10,
                 max_cycles: int = 20, cfg: SolveConfig | None = None,
                 dtype: torch.dtype | None = None, psd_project: bool = True,
                 asm_w_cap: int = 4, coarsest_nv: int | None = None):
        device = shell.device
        if coarsest_nv is None:
            coarsest_nv = 40 if device.type != "cpu" else 0
        if coarsest_nv:
            mg = extend_hierarchy(mg, min_coarsest_nv=coarsest_nv)
        if dtype is None:
            dtype = torch.float64 if device.type == "cpu" else torch.float32
        self.device, self.dtype = device, dtype
        self.shell = shell
        self.dt = float(dt)
        self.mg_tolerance = float(mg_tolerance)
        self.n_newton = int(n_newton)
        self.max_cycles = int(max_cycles)
        self.psd_project = bool(psd_project)
        self.timed = False
        self.last_rejected = 0
        self.last_newton: list[dict] = []
        cfg = cfg or SolveConfig(smoother=SmootherType.CHEBYSHEV)
        nv = shell.n
        F = shell.F
        self.nf = F.shape[0]

        # vertex-pair pattern in the SAME (face, a, b) flatten order as the
        # per-face Hessian blocks of _face_blocks
        rows = [np.repeat(F, 3, axis=1).reshape(-1)]
        cols = [np.tile(F, (1, 3)).reshape(-1)]
        if shell.bending:
            v6 = np.concatenate([F, shell.opp], axis=1)  # [nf, 6]
            rows.append(np.repeat(v6, 6, axis=1).reshape(-1))
            cols.append(np.tile(v6, (1, 6)).reshape(-1))
        rows = np.concatenate(rows)
        cols = np.concatenate(cols)
        pattern = (
            sp.coo_matrix((np.ones(rows.shape[0]), (rows, cols)), shape=(nv, nv))
            + sp.identity(nv)
        ).tocsr()
        pattern.sum_duplicates()
        self.solver = BsrRefreshableSolver(mg, pattern, cfg=cfg, dtype=dtype, device=device)
        self.pattern = self.solver.pattern_v
        self.cfg = self.solver.cfg
        self.nnz = self.pattern.nnz

        # Gather-only assembly: for every pattern nnz, the (padded) list of
        # per-face block entries that land in it, summed in a fixed order
        # (off-diagonal vertex pairs get two face contributions on a closed
        # manifold, so W = 4 covers most slots; the longer diagonal
        # segments go to a sorted tail).
        slots = csr_slot_map(self.pattern, rows, cols)
        order = np.argsort(slots, kind="stable")
        gi, _gw, ti, _tw, ts = _ellize_segments(
            slots[order], order, np.ones(order.shape[0]),
            order.shape[0], self.nnz, W_cap=asm_w_cap,
        )
        diag_slots = csr_slot_map(self.pattern, np.arange(nv), np.arange(nv))
        Md = np.asarray(M.diagonal())
        t = (lambda a, dt_: torch.as_tensor(np.asarray(a)).to(device=device, dtype=dt_))
        self.asm_gather = t(gi, torch.int64)
        self.asm_tail_idx = t(ti, torch.int64)
        self.asm_tail_seg = t(ts, torch.int64)
        self.diag_slots = t(diag_slots, torch.int64)
        self.Mv = t(Md[0::3], dtype)
        self.Mdiag = t(Md, dtype)
        self.F = t(F, torch.int64)
        self.abars = shell.abars.to(dtype)
        self.bend = shell.bend_state(dtype)

    # ------------------------------------------------------------------
    def _energy(self, x_flat):
        s = self.shell
        return _energy_sum(x_flat, self.F, self.abars, s.thickness, s.alpha,
                           s.beta, s.material, bend=self.bend)

    def _face9(self, v_flat):
        """[nv*3] -> [nf, 9] per-face corner states."""
        return v_flat.reshape(-1, 3)[self.F].reshape(self.nf, 9)

    def _face_blocks(self, x_flat, x9):
        """Per-face Hessians: [nf, 9, 9] stretch (+ [nf, 18, 18] bending)."""
        H = [self.shell.face_hess(x9, self.abars)]
        if self.bend is not None:
            opp, mask, bbars = self.bend
            x18 = torch.cat([x9, x_flat.reshape(-1, 3)[opp].reshape(self.nf, 9)], dim=1)
            H.append(self.shell.face_hess_bend(x18, self.abars, bbars, mask))
        return H

    def _assemble(self, H):
        """dt^2 K + M as [nnz_v, 3, 3] blocks (gather-only assembly)."""
        nf = self.nf
        ent = [H[0].reshape(nf, 3, 3, 3, 3).permute(0, 1, 3, 2, 4).reshape(nf * 9, 3, 3)]
        if len(H) > 1:
            ent.append(H[1].reshape(nf, 6, 3, 6, 3).permute(0, 1, 3, 2, 4)
                       .reshape(nf * 36, 3, 3))
        e = (self.dt * self.dt) * torch.cat(ent)
        epad = torch.cat([e, e.new_zeros((1, 3, 3))])
        vals = epad[self.asm_gather].sum(dim=1)
        if self.asm_tail_idx.shape[0]:
            vals = vals + torch.zeros_like(vals).index_add_(
                0, self.asm_tail_seg, epad[self.asm_tail_idx])
        eye3 = torch.eye(3, dtype=vals.dtype, device=vals.device)
        return vals.index_add_(0, self.diag_slots, self.Mv[:, None, None] * eye3)

    def _clock(self):
        """Host clock, after a device sync when the stepper is timed."""
        if self.timed and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def _mark(self, rec, name, t0):
        """Close phase `name` of a timed iteration; returns the new start."""
        if not self.timed:
            return t0
        t1 = self._clock()
        rec[name] = rec.get(name, 0.0) + (t1 - t0)
        return t1

    def step(self, curPos, qdot, fExt):
        """One implicit Euler step; returns (curPos_next [nv, 3], qdot_next
        [3nv]) as float64 numpy arrays.

        Newton iterations whose direction fails the line search (or is
        non-finite) leave qdot bitwise unchanged; their count is reported in
        ``last_rejected`` with a warning: the soft-failure analog of the
        reference returning converged=false.
        """
        dev, dtype, dt = self.device, self.dtype, self.dt
        shell = self.shell

        def t(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float64)).to(device=dev, dtype=dtype)

        nv = shell.n
        curPos0 = t(curPos).reshape(-1)
        qdot0 = t(qdot).reshape(-1)
        fExt = t(fExt).reshape(-1)
        Md = self.Mdiag
        qdot = qdot0
        nrej = torch.zeros((), dtype=torch.int64, device=dev)
        self.last_newton = []
        for _ in range(self.n_newton):
            rec: dict = {}
            t0 = self._clock()
            x = curPos0 + dt * qdot
            # the elastic energy at x is also the line search's f0 term
            Ev0, G = energy_and_gradient(self._energy, x)
            x9 = self._face9(x)
            H = self._face_blocks(x, x9)
            t0 = self._mark(rec, "assembly", t0)
            if self.psd_project:
                H = [psd_project_blocks(h) for h in H]
            t0 = self._mark(rec, "psd", t0)
            vals = self._assemble(H)
            g = -(Md * (qdot - qdot0) + dt * G + dt * fExt)
            t0 = self._mark(rec, "assembly", t0)
            hier = self.solver.refresh(vals)
            t0 = self._mark(rec, "refresh", t0)
            dx2, r_his, k = bsr_solve_loop(
                hier, g.reshape(nv, 3), torch.zeros((nv, 3), dtype=dtype, device=dev),
                self.mg_tolerance, self.max_cycles, self.cfg,
            )
            # the loop stops early only below tol; at max_cycles read the last residual
            converged = k < self.max_cycles or bool(r_his[k - 1] < self.mg_tolerance)
            t0 = self._mark(rec, "vcycles", t0)
            dx = dx2.reshape(-1)
            dq = qdot - qdot0
            f0 = 0.5 * (dq * Md * dq).sum() + (x * fExt).sum() + Ev0
            s = f0 + 1e-8 * (g * dx).sum()

            # Line-search energies on the 1-D line x + (alpha dt) dx: the
            # face corner states of x and dx are gathered once, so each
            # trial is per-face arithmetic (reference backtracking
            # semantics, sim_utils/implicit_euler_mg_balloon.h:80-114).
            d9 = self._face9(dx)
            if self.bend is not None:
                opp, mask, bbars = self.bend
                xo9 = x.reshape(-1, 3)[opp].reshape(self.nf, 9)
                do9 = dx.reshape(-1, 3)[opp].reshape(self.nf, 9)

            def line_energy(alpha):
                qd = qdot + alpha * dx
                dqa = qd - qdot0
                Ek = 0.5 * (dqa * Md * dqa).sum()
                newPos = curPos0 + dt * qd
                ad = alpha * dt
                e9 = x9 + ad * d9
                ev = face_energy(e9, self.abars, shell.thickness, shell.alpha,
                                 shell.beta, shell.material).sum()
                if self.bend is not None:
                    e18 = torch.cat([e9, xo9 + ad * do9], dim=1)
                    ev = ev + face_bending_energy(
                        e18, self.abars, bbars, mask, shell.thickness,
                        shell.alpha, shell.beta, shell.material).sum()
                return Ek + (newPos * fExt).sum() + ev

            alpha, found = 1.0, False
            while alpha > 1e-8:
                if bool(line_energy(alpha) <= s):  # one host sync per trial
                    found = True
                    break
                alpha *= 0.5
            # frozen-state guard: a rejected or non-finite direction leaves
            # qdot BITWISE unchanged (`qdot + 0 * dx` would turn an inf
            # direction into NaN)
            good = torch.isfinite((dx * dx).sum()) & found
            qdot = torch.where(good, qdot + alpha * dx, qdot)
            nrej += (~good).to(torch.int64)
            self._mark(rec, "line_search", t0)
            self.last_newton.append({"residuals": k, "converged": converged,
                                     "alpha": alpha, "found": found, **rec})
        curPos1 = curPos0.reshape(-1, 3) + dt * qdot.reshape(-1, 3)
        self.last_rejected = int(nrej)
        if self.last_rejected:
            warnings.warn(
                f"balloon step: {self.last_rejected} Newton iteration(s)"
                " rejected (line search failed or non-finite direction);"
                " state frozen for those iterations", stacklevel=2,
            )
        return (curPos1.cpu().to(torch.float64).numpy(),
                qdot.cpu().to(torch.float64).numpy())


def implicit_euler_balloon_direct(
    shell: ShellEnergy,
    M: sp.csr_matrix,
    curPos: np.ndarray,
    qdot: np.ndarray,
    fExt: np.ndarray,
    dt: float,
    n_newton: int = 10,
    verbose: bool = True,
    psd_project: bool = False,
):
    """Direct-solver implicit Euler (reference implicit_euler_balloon.h,
    the useMG=false toggle of example 06): a host sparse LU (scipy splu,
    f64) per Newton iteration instead of multigrid. psd_project=True uses
    the same per-face PSD clamping as the multigrid stepper (needed for
    like-for-like comparisons at large deformation)."""
    from scipy.sparse.linalg import splu

    qdot0 = qdot.copy()
    curPos0 = curPos.copy()
    qdot = qdot.copy()
    curPos = curPos.copy()

    def total_energy(tmp_qdot):
        Ek = 0.5 * (tmp_qdot - qdot0) @ (M @ (tmp_qdot - qdot0))
        newPos = curPos0 + dt * tmp_qdot.reshape(-1, 3)
        return float(newPos.reshape(-1) @ fExt) + Ek + shell.energy(newPos.reshape(-1))

    for it in range(n_newton):
        G = shell.gradient(curPos.reshape(-1))
        K = shell.hessian(curPos.reshape(-1), psd_project=psd_project)
        H = (M + dt * dt * K).tocsc()
        g = -(M @ (qdot - qdot0) + dt * G + dt * fExt)
        dx = splu(H).solve(g)
        alpha, p, c = 1.0, 0.5, 1e-8
        s = total_energy(qdot) + c * (g @ dx)
        while alpha > 1e-8:
            if total_energy(qdot + alpha * dx) <= s:
                qdot = qdot + alpha * dx
                break
            alpha *= p
        if verbose:
            print(f"  newton {it} (direct): alpha {alpha}")
        curPos = curPos0 + dt * qdot.reshape(-1, 3)
    return curPos, qdot


def inflation_force(curPos, F, pressure: float) -> np.ndarray:
    """fExt = -N_v * M_v * pressure over interleaved DOFs (main.cpp:113-122)."""
    N = vertex_normals(curPos, F)
    Mvd = np.asarray(massmatrix(curPos, F, kind="voronoi").diagonal())
    return (-(N * Mvd[:, None]) * pressure).reshape(-1)


def run_balloon(
    V,
    F,
    n_steps: int = 1,
    dt: float = 1e-3,
    thickness: float = 1e-1,
    poisson: float = 0.5,
    young: float = 6e6,
    material: str = "neohookean",
    mg_tolerance: float = 2e-1,
    pressure: float = 1e6,
    mg=None,
    solver: str = "bsr",
    n_newton: int = 10,
    verbose: bool = True,
    device="cpu",
    dtype: torch.dtype | None = None,
    coarsest_nv: int | None = None,
    stats: list | None = None,
):
    """Reference main.cpp:154-201 time loop: multigrid hierarchy on the rest
    mesh, inflation force recomputed per outer step. Yields curPos per step.

    solver="bsr" (the only one ported): `BsrBalloonStepper` on `device`;
    `mg` must be a SCALAR hierarchy (`mg_precompute`). With `stats` (a
    list), one record per step is appended: the step's `last_rejected`,
    its per-Newton records (`last_newton`) and the new qdot.
    """
    if solver == "scalar":
        raise NotImplementedError(
            "solver='scalar' (BalloonNewtonSolver, implicit_euler_mg_balloon) "
            "is not ported yet: it needs RefreshableMGSolver, which lands with "
            "MCF (ROADMAP queue 1 item 6)")
    if solver != "bsr":
        raise ValueError(f"unknown solver {solver!r} (want 'bsr'|'scalar')")
    V = np.asarray(V, dtype=np.float64)
    F = np.asarray(F, dtype=np.int64)
    alpha, beta = lame_parameters(young, poisson)
    shell = ShellEnergy(V, F, thickness, alpha, beta, material, device=device)
    M = 1000.0 * lumped_mass_matrix(V, F)

    curPos = V.copy()
    qdot = np.zeros(3 * V.shape[0])
    if mg is None:
        mg = mg_precompute(V, F, verbose=verbose)
    stepper = BsrBalloonStepper(shell, M, mg, dt, mg_tolerance=mg_tolerance,
                                n_newton=n_newton, dtype=dtype, coarsest_nv=coarsest_nv)
    for step in range(n_steps):
        fExt = inflation_force(curPos, F, pressure)
        curPos, qdot = stepper.step(curPos, qdot, fExt)
        if stats is not None:
            stats.append({"last_rejected": stepper.last_rejected,
                          "newton": stepper.last_newton, "qdot": qdot})
        if verbose:
            print(f"step {step}: max |disp| = {np.abs(curPos - V).max():.4f}")
        yield curPos
