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
``run_balloon(solver="scalar")`` is the cross-check on the reference's
own data layout: ``implicit_euler_mg_balloon`` solves the 3-expanded
scalar system on the block hierarchy (``mg_precompute_block``) with
``BalloonNewtonSolver`` (``RefreshableMGSolver``, multicolor GS; K1 for
every SpMV, K4 in the projection). ``DeviceBalloonStepper`` runs the
same scalar system with the whole Newton loop on the device (the loop
``BsrBalloonStepper`` shares, ``_NewtonStepper``; K1 and K4).
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
from surface_multigrid_code_torch.solver.hierarchy import (
    extend_hierarchy,
    mg_precompute,
    mg_precompute_block,
)
from surface_multigrid_code_torch.solver.refresh import RefreshableMGSolver, csr_slot_map
from surface_multigrid_code_torch.solver.vcycle import solve_loop
from surface_multigrid_code_torch.utils.device import resolve_device

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


def face_hessians(shell: ShellEnergy, x_flat, x9, abars, bend) -> list[torch.Tensor]:
    """The shell's per-face Hessians at x_flat ([3nv]; x9 its [nf, 9]
    corner states): [nf, 9, 9] stretch, and [nf, 18, 18] bending when
    ``bend`` (``shell.bend_state``) is set."""
    H = [shell.face_hess(x9, abars)]
    if bend is not None:
        opp, mask, bbars = bend
        x18 = torch.cat([x9, x_flat.reshape(-1, 3)[opp].reshape(x9.shape[0], 9)], dim=1)
        H.append(shell.face_hess_bend(x18, abars, bbars, mask))
    return H


class GatherAssembly:
    """Gather-only assembly of per-face entries into the nnz values of a
    CSR pattern, on a device. For every nnz slot, the padded list of the
    entries that land in it (at most w_cap, ``_ellize_segments``) is summed
    in a fixed order; longer segments go to a sorted tail added by
    ``index_add_``. ``rows``/``cols`` place the entries in the order they
    are passed; an entry is a scalar or a block (any trailing shape)."""

    def __init__(self, pattern: sp.csr_matrix, rows, cols, w_cap: int, device):
        slots = csr_slot_map(pattern, rows, cols)
        order = np.argsort(slots, kind="stable")
        gi, _gw, ti, _tw, ts = _ellize_segments(
            slots[order], order, np.ones(order.shape[0]), order.shape[0], pattern.nnz,
            W_cap=w_cap)
        n = pattern.shape[0]
        diag = csr_slot_map(pattern, np.arange(n), np.arange(n))
        self.gather, self.tail_idx, self.tail_seg, self.diag_slots = (
            torch.as_tensor(np.asarray(a), dtype=torch.int64, device=device)
            for a in (gi, ti, ts, diag))

    def __call__(self, e: torch.Tensor, diag: torch.Tensor) -> torch.Tensor:
        """The pattern's values [nnz, *E]: the entries e [k, *E] summed into
        their slots, plus diag [n, *E] on the diagonal slots."""
        epad = torch.cat([e, e.new_zeros((1, *e.shape[1:]))])
        vals = epad[self.gather].sum(dim=1)
        if self.tail_idx.shape[0]:
            vals = vals + torch.zeros_like(vals).index_add_(
                0, self.tail_seg, epad[self.tail_idx])
        return vals.index_add_(0, self.diag_slots, diag)


# backtracking line search of every Newton loop here (reference
# implicit_euler_mg_balloon.h:80-114): sufficient decrease c, shrink p,
# and the smallest step tried
LS_C, LS_P, LS_ALPHA_MIN = 1e-8, 0.5, 1e-8


class _NewtonStepper:
    """The Newton loop both device steppers share (reference
    implicit_euler_mg_balloon.h:40-120): ``n_newton`` iterations, no early
    exit, each one

        energy and gradient at x = curPos0 + dt qdot (one autograd pass)
        per-face Hessian blocks at x, PSD-projected when ``psd_project``
        vals = M + dt^2 K in the solver's layout (``_assemble``)
        g = -(M (qdot - qdot0) + dt G + dt fExt)
        hier = solver.refresh(vals); dx = V-cycles on H dx = g from zero
                (``_solve``, mg_tolerance, max_cycles)
        backtracking line search on E(qdot + alpha dx) from f0 (the energy
                at x), LS_C / LS_P / LS_ALPHA_MIN
        qdot = where(found and dx finite, qdot + alpha dx, qdot)

    so a rejected iteration leaves qdot bitwise unchanged; the rejects are
    counted on the device and read once, after the last iteration.
    Subclasses set the state ``_init_newton`` names and ``solver``, and
    define ``_assemble`` and ``_solve``.
    """

    def _init_newton(self, shell: ShellEnergy, M, dt, mg_tolerance, n_newton, max_cycles,
                     psd_project, dtype):
        device = shell.device
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
        self.nf = shell.F.shape[0]
        self.Mdiag = torch.as_tensor(np.asarray(M.diagonal())).to(device=device, dtype=dtype)
        self.F = torch.as_tensor(shell.F, dtype=torch.int64, device=device)
        self.abars = shell.abars.to(dtype)
        self.bend = shell.bend_state(dtype)

    def _energy(self, x_flat):
        s = self.shell
        return _energy_sum(x_flat, self.F, self.abars, s.thickness, s.alpha,
                           s.beta, s.material, bend=self.bend)

    def _face9(self, v_flat):
        """[nv*3] -> [nf, 9] per-face corner states."""
        return v_flat.reshape(-1, 3)[self.F].reshape(self.nf, 9)

    def _face_blocks(self, x_flat, x9):
        """Per-face Hessians: [nf, 9, 9] stretch (+ [nf, 18, 18] bending)."""
        return face_hessians(self.shell, x_flat, x9, self.abars, self.bend)

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
            dx, r_his, k = self._solve(hier, g)
            # the loop stops early only below tol; at max_cycles read the last residual
            converged = k < self.max_cycles or bool(r_his[k - 1] < self.mg_tolerance)
            t0 = self._mark(rec, "vcycles", t0)
            dq = qdot - qdot0
            f0 = 0.5 * (dq * Md * dq).sum() + (x * fExt).sum() + Ev0
            s = f0 + LS_C * (g * dx).sum()

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
            while alpha > LS_ALPHA_MIN:
                if bool(line_energy(alpha) <= s):  # one host sync per trial
                    found = True
                    break
                alpha *= LS_P
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


class BsrBalloonStepper(_NewtonStepper):
    """Implicit-Euler balloon step with the BSR (3x3-block) multigrid, on
    the shell's device.

    10 Newton iterations of H dx = -g with H = M + dt^2 K and a backtracking
    line search (reference implicit_euler_mg_balloon.h:40-120; the loop of
    ``_NewtonStepper``). Takes the SCALAR hierarchy from mg_precompute: the
    reference's 3-expanded block prolongation (src/get_prolong.cpp:59-115)
    is the same scalar weight on each DOF of a vertex.

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
        self._init_newton(shell, M, dt, mg_tolerance, n_newton, max_cycles, psd_project, dtype)
        cfg = cfg or SolveConfig(smoother=SmootherType.CHEBYSHEV)
        nv = shell.n
        F = shell.F

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

        # off-diagonal vertex pairs get two face contributions on a closed
        # manifold, so W = 4 covers most slots
        self.asm = GatherAssembly(self.pattern, rows, cols, asm_w_cap, device)
        self.Mv = self.Mdiag[0::3].contiguous()

    def _assemble(self, H):
        """dt^2 K + M as [nnz_v, 3, 3] blocks (gather-only assembly)."""
        nf = self.nf
        ent = [H[0].reshape(nf, 3, 3, 3, 3).permute(0, 1, 3, 2, 4).reshape(nf * 9, 3, 3)]
        if len(H) > 1:
            ent.append(H[1].reshape(nf, 6, 3, 6, 3).permute(0, 1, 3, 2, 4)
                       .reshape(nf * 36, 3, 3))
        eye3 = torch.eye(3, dtype=self.Mv.dtype, device=self.Mv.device)
        return self.asm((self.dt * self.dt) * torch.cat(ent), self.Mv[:, None, None] * eye3)

    def _solve(self, hier, g):
        """The block V-cycles on [nv, 3]; returns (dx [3nv], r_his, k)."""
        nv = self.shell.n
        dx, r_his, k = bsr_solve_loop(
            hier, g.reshape(nv, 3), torch.zeros((nv, 3), dtype=self.dtype, device=self.device),
            self.mg_tolerance, self.max_cycles, self.cfg,
        )
        return dx.reshape(-1), r_his, k


class BalloonNewtonSolver:
    """Per-Newton-iteration Hessian refresh on the fixed 3-expanded
    (scalar) hierarchy, on the shell's device.

    The reference re-runs the full multigrid precompute every Newton
    iteration (implicit_euler_mg_balloon.h:75); here the symbolic structure
    is cached once, and each iteration gathers the new per-face Hessian
    entries into the finest nnz values (``hessian_values``) and refreshes
    the hierarchy through ``solver.solve``. dtype: float32 on an
    accelerator, float64 on the CPU unless given; the Hessian is computed
    in it. psd_project (default True): project each face's Hessian block
    onto the PSD cone (``psd_project_blocks``, kernel K4 on the card): the
    raw shell Hessians go indefinite under large deformation, and the
    SPD-assuming multigrid then diverges; blocks that are PSD already pass
    bitwise. cfg: multicolor GS unless given (the reference's smoother
    family, and the JAX ``implicit_euler_mg_balloon``'s; the interleaved
    block patterns need about 21 colors; ``DeviceBalloonStepper`` passes
    Chebyshev, the JAX class's own default). build_solver=False: the
    assembly only, with ``solver`` None (the row-partitioned
    ``parallel/balloon.py`` solves through its own hierarchy).
    """

    def __init__(self, shell: ShellEnergy, M: sp.csr_matrix, mg, cfg=None,
                 dtype: torch.dtype | None = None, build_solver: bool = True,
                 psd_project: bool = True):
        device = shell.device
        if dtype is None:
            dtype = torch.float64 if device.type == "cpu" else torch.float32
        self.device, self.dtype = device, dtype
        self.shell = shell
        self.psd_project = bool(psd_project)
        cfg = cfg or SolveConfig(smoother=SmootherType.MULTICOLOR_GS)
        n3 = M.shape[0]
        rows, cols = shell._rows, shell._cols
        if shell.bending:
            rows = np.concatenate([rows, shell._rows_b])
            cols = np.concatenate([cols, shell._cols_b])
        K_pat = sp.coo_matrix((np.ones(rows.shape[0]), (rows, cols)), shape=(n3, n3)).tocsr()
        pattern = (K_pat + M).tocsr()
        pattern.sum_duplicates()
        self.pattern = pattern
        # the rare long segments are the bending diagonals
        self.asm = GatherAssembly(pattern, rows, cols, 24, device)
        self.Mdiag = torch.as_tensor(np.asarray(M.diagonal())).to(device=device, dtype=dtype)
        self.F = torch.as_tensor(shell.F, dtype=torch.int64, device=device)
        self.abars = shell.abars.to(dtype)
        self.bend = shell.bend_state(dtype)
        self.solver = (RefreshableMGSolver(mg, pattern, cfg=cfg, dtype=dtype, device=device)
                       if build_solver else None)
        self.last_newton: list[dict] = []

    def values(self, H: list[torch.Tensor], dt: float) -> torch.Tensor:
        """Finest nnz values of M + dt^2 K from the per-face blocks H (in
        ``face_hessians``' order), gathered into the pattern's nnz slots."""
        e = torch.cat([h.reshape(-1) for h in H])
        return self.asm((dt * dt) * e, self.Mdiag)

    def hessian_values(self, x_flat, dt: float) -> torch.Tensor:
        """Finest nnz values of H = M + dt^2 K at the positions x_flat, on
        the device: the per-face Hessian blocks (stretching 9x9, bending
        18x18), PSD-projected when ``psd_project``, gathered into the
        pattern's nnz slots. x_flat: [3nv] numpy, or a tensor (no host
        round trip)."""
        if not isinstance(x_flat, torch.Tensor):
            x_flat = torch.as_tensor(np.asarray(x_flat, dtype=np.float64))
        xv = x_flat.to(device=self.device, dtype=self.dtype).reshape(-1, 3)
        H = face_hessians(self.shell, xv.reshape(-1), xv[self.F].reshape(-1, 9), self.abars,
                          self.bend)
        if self.psd_project:
            H = [psd_project_blocks(h) for h in H]
        return self.values(H, dt)


class DeviceBalloonStepper(_NewtonStepper):
    """The implicit-Euler step on the 3-expanded scalar hierarchy with every
    Newton iteration on the device (the JAX package's
    ``DeviceBalloonStepper``).

    mg: the block hierarchy (``mg_precompute_block``). Each of the
    ``n_newton`` iterations (``_NewtonStepper``, no early exit) takes the
    energy and gradient at x in one pass, the Hessian values of
    ``newton_solver`` (a ``BalloonNewtonSolver``: per-face blocks,
    PSD-projected when ``psd_project`` (K4), gathered into the 3-expanded
    pattern), ``solver.refresh`` and ``solve_loop`` from zero (K1 for every
    SpMV) to ``mg_tolerance`` in at most ``max_cycles``, then the line
    search and the frozen-state guard. cfg: Chebyshev unless given (the
    JAX class's default). dtype: float32 on an accelerator, float64 on the
    CPU unless given. Runs on the shell's device.

    Unlike ``implicit_euler_mg_balloon``, which crosses to numpy every
    iteration, x, qdot, g, dx and the reject count stay tensors on the
    device for the whole step. The JAX class jits the whole step into one
    device program; PyTorch runs eagerly and has no counterpart of that,
    so the loops are Python loops and the step reads the device at these
    points: once per V-cycle (the solve loop's stopping test), once per
    line-search trial, once for the reject count at the end; besides, the
    refresh's coarse Cholesky checks its factor (one read), the Chebyshev
    bounds are read once per refresh, and the step's inputs and outputs
    cross as numpy. ``last_rejected`` and ``last_newton`` as in
    ``BsrBalloonStepper``.
    """

    def __init__(self, shell: ShellEnergy, M: sp.csr_matrix, mg, dt: float,
                 mg_tolerance: float = 2e-1, n_newton: int = 10,
                 max_cycles: int = 20, cfg: SolveConfig | None = None,
                 dtype: torch.dtype | None = None, psd_project: bool = True):
        ns = BalloonNewtonSolver(shell, M, mg, cfg=cfg or SolveConfig(
            smoother=SmootherType.CHEBYSHEV), dtype=dtype, psd_project=psd_project)
        self.newton_solver = ns
        self._init_newton(shell, M, dt, mg_tolerance, n_newton, max_cycles, psd_project,
                          ns.dtype)
        self.solver = ns.solver
        self.cfg = ns.solver.cfg
        self.pattern = ns.pattern

    def _assemble(self, H):
        return self.newton_solver.values(H, self.dt)

    def _solve(self, hier, g):
        return solve_loop(hier, g, torch.zeros_like(g), self.mg_tolerance, self.max_cycles,
                          self.cfg)


def implicit_euler_mg_balloon(
    shell: ShellEnergy,
    M: sp.csr_matrix,
    curPos: np.ndarray,
    qdot: np.ndarray,
    fExt: np.ndarray,
    dt: float,
    mg,
    mg_tolerance: float = 2e-1,
    n_newton: int = 10,
    cfg: SolveConfig | None = None,
    newton_solver: BalloonNewtonSolver | None = None,
    verbose: bool = True,
):
    """One implicit Euler step on the 3-expanded scalar system (reference
    sim_utils/implicit_euler_mg_balloon.h:18-124), host-orchestrated: the
    gradient, the line search and the multigrid solve's input and output
    cross to the host every Newton iteration. Mutates nothing; returns
    (curPos, qdot, newton_solver). ``newton_solver.last_newton`` holds one
    record per iteration (residuals recorded, converged, alpha, found)."""
    if newton_solver is None:
        newton_solver = BalloonNewtonSolver(shell, M, mg, cfg=cfg)
    qdot0 = qdot.copy()
    curPos0 = curPos.copy()
    qdot = qdot.copy()
    curPos = curPos.copy()

    def total_energy(tmp_qdot):
        Ek = 0.5 * (tmp_qdot - qdot0) @ (M @ (tmp_qdot - qdot0))
        newPos = curPos0 + dt * tmp_qdot.reshape(-1, 3)
        return float(newPos.reshape(-1) @ fExt) + Ek + shell.energy(newPos.reshape(-1))

    newton_solver.last_newton = []
    for it in range(n_newton):
        G = shell.gradient(curPos.reshape(-1))
        vals = newton_solver.hessian_values(curPos.reshape(-1), dt)
        g = -(M @ (qdot - qdot0) + dt * G + dt * fExt)
        dx, r_his, ok = newton_solver.solver.solve(vals, g, tolerance=mg_tolerance, max_iter=20)
        if verbose:
            print(f"  newton {it}: g.dx = {g @ dx:.6e}, cycles {len(r_his)}")
        # backtracking line search (reference :80-114)
        alpha = 1.0
        s = total_energy(qdot) + LS_C * (g @ dx)
        found = False
        while alpha > LS_ALPHA_MIN:
            if total_energy(qdot + alpha * dx) <= s:
                qdot = qdot + alpha * dx
                found = True
                break
            alpha *= LS_P
        if verbose:
            print(f"  alpha: {alpha}")
        newton_solver.last_newton.append(
            {"residuals": len(r_his), "converged": ok, "alpha": alpha, "found": found})
        curPos = curPos0 + dt * qdot.reshape(-1, 3)
    return curPos, qdot, newton_solver


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
        alpha = 1.0
        s = total_energy(qdot) + LS_C * (g @ dx)
        while alpha > LS_ALPHA_MIN:
            if total_energy(qdot + alpha * dx) <= s:
                qdot = qdot + alpha * dx
                break
            alpha *= LS_P
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
    device="cuda",
    dtype: torch.dtype | None = None,
    coarsest_nv: int | None = None,
    stats: list | None = None,
):
    """Reference main.cpp:154-201 time loop: multigrid hierarchy on the rest
    mesh, inflation force recomputed per outer step. Yields curPos per step.

    solver="bsr" (default): `BsrBalloonStepper` on `device`; `mg` must be
    a SCALAR hierarchy (`mg_precompute`), extended to `coarsest_nv`.
    solver="scalar": the host-orchestrated `implicit_euler_mg_balloon` on
    the 3-expanded block hierarchy (`mg_precompute_block`) with multicolor
    GS, the reference's own data layout, kept as the cross-check path
    (`coarsest_nv` does not apply). With `stats` (a list), one record per
    step is appended: the step's rejected Newton iterations
    (`last_rejected`), its per-Newton records and the new qdot.
    """
    if solver not in ("bsr", "scalar"):
        raise ValueError(f"unknown solver {solver!r} (want 'bsr'|'scalar')")
    device = resolve_device(device)
    V = np.asarray(V, dtype=np.float64)
    F = np.asarray(F, dtype=np.int64)
    alpha, beta = lame_parameters(young, poisson)
    shell = ShellEnergy(V, F, thickness, alpha, beta, material, device=device)
    M = 1000.0 * lumped_mass_matrix(V, F)

    curPos = V.copy()
    qdot = np.zeros(3 * V.shape[0])
    if solver == "scalar":
        if mg is None:
            mg = mg_precompute_block(V, F, verbose=verbose)
        ns = BalloonNewtonSolver(shell, M, mg, dtype=dtype)
    else:
        if mg is None:
            mg = mg_precompute(V, F, verbose=verbose)
        stepper = BsrBalloonStepper(shell, M, mg, dt, mg_tolerance=mg_tolerance,
                                    n_newton=n_newton, dtype=dtype, coarsest_nv=coarsest_nv)
    for step in range(n_steps):
        fExt = inflation_force(curPos, F, pressure)
        if solver == "scalar":
            curPos, qdot, _ = implicit_euler_mg_balloon(
                shell, M, curPos, qdot, fExt, dt, mg, mg_tolerance=mg_tolerance,
                n_newton=n_newton, newton_solver=ns, verbose=verbose)
            newton = ns.last_newton
            rejected = sum(not r["found"] for r in newton)
        else:
            curPos, qdot = stepper.step(curPos, qdot, fExt)
            newton, rejected = stepper.last_newton, stepper.last_rejected
        if stats is not None:
            stats.append({"last_rejected": rejected, "newton": newton, "qdot": qdot})
        if verbose:
            print(f"step {step}: max |disp| = {np.abs(curPos - V).max():.4f}")
        yield curPos
