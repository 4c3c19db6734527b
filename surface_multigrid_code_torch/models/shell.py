"""Elastic shell energies in PyTorch (ports ``surface_multigrid_code_tpu/models/shell.py``).

The reference vendors libshell with ~1.5 KLoC of hand-coded per-face
gradients and Hessians (06_example_balloon_sim/sim_utils/MaterialModel/
*.cpp, GeometryDerivatives.cpp). The port, like the JAX package, writes the
per-face energy densities once and takes exact derivatives by autodiff:
the gradient is one reverse pass (``torch.autograd.grad``) over the summed
energy, the 3-variable material Hessian of the structured stretching
Hessian comes from ``torch.func.vmap(hessian)``, and the 18-DOF bending
Hessian from ``vmap(hessian)`` of the face energy.

Every per-face function takes tensors with leading face dimensions
(``x9 [..., 9]``, ``abar [..., 2, 2]``), so the same code runs batched
and under ``vmap``.

Energy densities (the reference's formulas):

- StVK (StVKMaterial.cpp:21-31):
    W = t/4 * dA * (alpha/2 tr(S)^2 + beta tr(S^2)),
    S = abar^-1 (a - abar),  dA = 1/2 sqrt(det abar)
- NeoHookean (NeoHookeanMaterial.cpp:21-34):
    W = t sqrt(det abar)/4 * (beta (tr(abar^-1 a) - 2 - 2 lnJ) + alpha lnJ^2),
    lnJ = 1/2 ln(det a / det abar)
- Tension-field StVK (TensionFieldStVKMaterial.cpp:21-110): StVK in pure
  tension; zero when fully slack (lambda1 < 0); relaxed single-wrinkle
  energy k dA lambda1^2 otherwise.
- Bending with the midedge-average second fundamental form
  (MidedgeAverageFormulation.cpp:7-246; StVK/NeoHookean bending terms).
- The angle-based midedge SFF (MidedgeAngle{Tan,Sin}Formulation.cpp),
  batched over faces: ``edge_tables`` (host), ``edge_thetas`` and
  ``second_fundamental_form_angle``; no energy of the port uses it, as in
  the JAX package.

Lame parameters from Young's modulus / Poisson ratio as in the reference
(main.cpp:63-67): alpha = Y nu / (1 - nu^2), beta = Y / (2 (1 + nu)).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch
from torch.func import grad, hessian, vmap

from surface_multigrid_code_torch.ops.psd import NS_SCHEDULE, ns_sign_apply
from surface_multigrid_code_torch.utils.device import resolve_device

MATERIALS = ("neohookean", "stvk", "tension_field")


def psd_project_blocks(H: torch.Tensor, schedule=NS_SCHEDULE) -> torch.Tensor:
    """Per-face PSD projection of symmetric Hessian blocks [m, d, d]:
    clamp negative eigenvalues to (near) zero.

    The raw shell Hessians go indefinite under large deformation (the
    reference's inflation pressure 1e6); an SPD-assuming f32 multigrid
    (Chebyshev window, coarse Cholesky) then diverges. With s the per-block
    inf-norm (>= the spectral radius, floored at 1e-30) and X = Hs / s,

        PSD(H) = (s / 2) (X + X sign(X)) = U max(L, 0) U^T,

    where ``ns_sign_apply`` (kernel K4 on the card) computes X + X sign(X)
    by the 12-cubic Newton-Schulz schedule. Blocks whose clamp correction
    is at most 1e-4 s pass through BITWISE unchanged, so trajectories at
    moderate loads are identical to unprojected ones.
    """
    Hs = 0.5 * (H + H.transpose(-1, -2))
    s = Hs.abs().sum(dim=-1).amax(dim=-1).clamp_min(1e-30)
    X = (Hs / s[:, None, None]).contiguous()
    Y = ns_sign_apply(X, schedule)
    Hp = 0.5 * s[:, None, None] * Y
    Hp = 0.5 * (Hp + Hp.transpose(-1, -2))
    clamped = (Hp - Hs).abs().amax(dim=(-1, -2)) > 1e-4 * s
    return torch.where(clamped[:, None, None], Hp, H)


def lame_parameters(young: float, poisson: float) -> tuple[float, float]:
    alpha = young * poisson / (1.0 - poisson * poisson)
    beta = young / 2.0 / (1.0 + poisson)
    return alpha, beta


def _dot(a, b):
    return (a * b).sum(dim=-1)


def _sym2(c0, c1, c2):
    """[[c0, c1], [c1, c2]] over leading dimensions."""
    return torch.stack([torch.stack([c0, c1], -1), torch.stack([c1, c2], -1)], -2)


def _det2(a):
    return a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]


def _adj2(a):
    return torch.stack([
        torch.stack([a[..., 1, 1], -a[..., 0, 1]], -1),
        torch.stack([-a[..., 1, 0], a[..., 0, 0]], -1),
    ], -2)


def _inv2(a):
    return _adj2(a) / _det2(a)[..., None, None]


def _trace2(a):
    return a[..., 0, 0] + a[..., 1, 1]


def _stvk_W(S, alpha, beta):
    return 0.5 * alpha * _trace2(S) ** 2 + beta * _trace2(S @ S)


def _metric_entries(x9):
    e1 = x9[..., 3:6] - x9[..., 0:3]
    e2 = x9[..., 6:9] - x9[..., 0:3]
    return e1, e2, torch.stack([_dot(e1, e1), _dot(e1, e2), _dot(e2, e2)], -1)


def first_fundamental_form(x9: torch.Tensor) -> torch.Tensor:
    """2x2 metric [..., 2, 2] of triangles given stacked vertex positions [..., 9]."""
    _e1, _e2, c = _metric_entries(x9)
    return _sym2(c[..., 0], c[..., 1], c[..., 2])


def first_fundamental_forms(V: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
    """Per-face rest metrics abar [m, 2, 2] (ElasticShell::firstFundamentalForms)."""
    return first_fundamental_form(V[F].reshape(F.shape[0], 9))


def metric_energy(c, abar, thickness, alpha, beta, material: str):
    """Stretching energy density as a function of the metric's three
    distinct entries c = (a11, a12, a22) [..., 3], the only channel through
    which the vertex positions enter every material law."""
    a = _sym2(c[..., 0], c[..., 1], c[..., 2])
    detabar = _det2(abar)
    abarinv = _inv2(abar)
    if material == "neohookean":
        deta = _det2(a)
        lnJ = 0.5 * torch.log(deta / detabar)
        W = beta * (_trace2(abarinv @ a) - 2.0 - 2.0 * lnJ) + alpha * lnJ**2
        return thickness * torch.sqrt(detabar) / 4.0 * W
    S = abarinv @ (a - abar)
    dA = 0.5 * torch.sqrt(detabar)
    coeff = thickness / 4.0
    if material == "stvk":
        return coeff * dA * _stvk_W(S, alpha, beta)
    # tension-field StVK (branchless via torch.where; the guarded sqrt keeps
    # the derivatives NaN-free at branch boundaries)
    T = _trace2(S)
    D = _det2(S)
    disc = torch.sqrt(torch.clamp_min(T * T / 4.0 - D, 1e-30))
    lam1 = T / 2.0 + disc  # largest eigenvalue
    lam2 = T / 2.0 - disc
    k1 = 0.5 * coeff * alpha
    k2 = coeff * beta
    transition = -k1 / (k1 + k2)
    pure_tension = (lam1 >= 0) & (lam2 >= transition * lam1)
    slack = lam1 < 0
    # relaxed single-wrinkle energy: kstretching dA lambda1^2, with the
    # thickness/4 factor already inside k1/k2 (reference :103-106)
    kstretch = k1 + k2 - k1 * k1 / (k1 + k2)
    wrinkle = kstretch * dA * lam1 * lam1
    stvk = coeff * dA * _stvk_W(S, alpha, beta)
    return torch.where(pure_tension, stvk,
                       torch.where(slack, torch.zeros_like(wrinkle), wrinkle))


def face_energy(x9, abar, thickness, alpha, beta, material: str):
    """Stretching energy of faces [...] (density formulas above)."""
    return metric_energy(_metric_entries(x9)[2], abar, thickness, alpha, beta, material)


# Constant edge maps e1 = L1 x9, e2 = L2 x9 and the (face-independent)
# second derivatives of the metric entries: c is QUADRATIC in x9, so
# d2c1 = 2 L1'L1, d2c2 = L1'L2 + L2'L1, d2c3 = 2 L2'L2.
_L1 = np.hstack([-np.eye(3), np.eye(3), np.zeros((3, 3))])
_L2 = np.hstack([-np.eye(3), np.zeros((3, 3)), np.eye(3)])
_KC = np.stack([
    2.0 * _L1.T @ _L1,
    _L1.T @ _L2 + _L2.T @ _L1,
    2.0 * _L2.T @ _L2,
])  # [3, 9, 9]


def face_hessian_stretch(x9, abar, thickness, alpha, beta, material: str):
    """Structured 9x9 stretching Hessians [nf, 9, 9] via the metric pullback.

    E(x9) = W(c(x9)) with c = (a11, a12, a22), so

        d2E = J' H_W J  +  sum_k (dW/dc_k) * d2c_k

    with J = dc/dx9 (3x9, linear in the edges), the constant d2c_k above,
    and H_W the 3-variable Hessian of the material law (``vmap(hessian)``).
    Algebraically identical to the Hessian of ``face_energy``."""
    e1, e2, c = _metric_entries(x9)

    def Wc(cc, ab):
        return metric_energy(cc, ab, thickness, alpha, beta, material)

    gW = vmap(grad(Wc))(c, abar)      # [nf, 3]
    HW = vmap(hessian(Wc))(c, abar)   # [nf, 3, 3]
    L1 = torch.as_tensor(_L1, dtype=x9.dtype, device=x9.device)
    L2 = torch.as_tensor(_L2, dtype=x9.dtype, device=x9.device)
    KC = torch.as_tensor(_KC, dtype=x9.dtype, device=x9.device)
    J = torch.stack([2.0 * (e1 @ L1), e2 @ L1 + e1 @ L2, 2.0 * (e2 @ L2)], dim=1)
    return J.transpose(1, 2) @ HW @ J + torch.einsum("fk,kij->fij", gW, KC)


def opposite_vertices(F: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """For each face corner i: the vertex of the neighboring face across the
    edge opposite corner i (MeshConnectivity::vertexOppositeFaceEdge
    semantics). Returns (opp [m,3] int64 with 0 placeholder, mask [m,3]
    1.0 where a neighbor exists)."""
    F = np.asarray(F, dtype=np.int64)
    m = F.shape[0]
    owner: dict[tuple[int, int], tuple[int, int]] = {}
    for f in range(m):
        for c in range(3):
            a, b = int(F[f, (c + 1) % 3]), int(F[f, (c + 2) % 3])
            owner[(a, b)] = (f, int(F[f, c]))
    opp = np.zeros((m, 3), dtype=np.int64)
    mask = np.zeros((m, 3))
    for f in range(m):
        for c in range(3):
            a, b = int(F[f, (c + 1) % 3]), int(F[f, (c + 2) % 3])
            got = owner.get((b, a))
            if got is not None:
                opp[f, c] = got[1]
                mask[f, c] = 1.0
    return opp, mask


def edge_tables(F: np.ndarray):
    """Per-face-corner edge ids and orientations + per-edge dihedral frame.

    edge i of face f joins F[f,(i+1)%3] -> F[f,(i+2)%3] (directed);
    the canonical frame of an undirected edge is taken from the first face
    in which it appears: (v0, v1, v2 = that face's opposite vertex,
    v3 = the other face's opposite vertex).  orient[f,i] = +1 for the
    canonical face, -1 for the other (MeshConnectivity::faceEdgeOrientation
    semantics feeding the alpha = theta/2 + orient*phi composition,
    MidedgeAngleTanFormulation.cpp:141)."""
    F = np.asarray(F, dtype=np.int64)
    m = F.shape[0]
    edges: dict[tuple[int, int], int] = {}
    ev = []  # v0, v1, v2, v3 (v3 = -1 until second face seen)
    eid = np.zeros((m, 3), dtype=np.int64)
    orient = np.zeros((m, 3))
    for f in range(m):
        for c in range(3):
            a, b = int(F[f, (c + 1) % 3]), int(F[f, (c + 2) % 3])
            key = (min(a, b), max(a, b))
            if key not in edges:
                edges[key] = len(ev)
                ev.append([a, b, int(F[f, c]), -1])
                eid[f, c] = edges[key]
                orient[f, c] = 1.0
            else:
                e = edges[key]
                ev[e][3] = int(F[f, c])
                eid[f, c] = e
                orient[f, c] = -1.0
    ev = np.asarray(ev, dtype=np.int64)
    return eid, orient, ev


def edge_thetas(V: torch.Tensor, ev: torch.Tensor) -> torch.Tensor:
    """Signed dihedral angle per edge [ne] of positions V [n, 3] and the
    edge frames ev [ne, 4] of ``edge_tables`` (GeometryDerivatives
    edgeTheta/angle: theta = 2 atan2((n0 x n1).axis/|axis|, n0.n1 +
    |n0||n1|)); 0 on boundary edges (ev[:, 3] < 0)."""
    q0, q1 = V[ev[:, 0]], V[ev[:, 1]]
    q2 = V[ev[:, 2]]
    q3 = V[ev[:, 3].clamp_min(0)]
    n0 = torch.linalg.cross(q0 - q2, q1 - q2)
    n1 = torch.linalg.cross(q1 - q3, q0 - q3)
    axis = q1 - q0
    num = _dot(torch.linalg.cross(n0, n1), axis) / torch.linalg.norm(axis, dim=-1)
    den = _dot(n0, n1) + torch.linalg.norm(n0, dim=-1) * torch.linalg.norm(n1, dim=-1)
    theta = 2.0 * torch.atan2(num, den)
    return torch.where(ev[:, 3] >= 0, theta, torch.zeros_like(theta))


def second_fundamental_form_angle(x9, theta3, phi3, orient3, variant: str):
    """Angle-based midedge SFF [..., 2, 2] of faces x9 [..., 9], with the
    dihedral angles theta3, edge DOFs phi3 and orientations orient3 of
    their three edges [..., 3] (MidedgeAngle{Tan,Sin}Formulation.cpp:
    110-270): II_i = 2 h_i * tan_or_sin(theta_e/2 + orient*phi_e), h_i the
    altitude from corner i; b = [[II0+II1, II0],[II0, II0+II2]].
    variant: "tan" or "sin"."""
    q = x9.unflatten(-1, (3, 3))
    n = torch.linalg.cross(q[..., 1, :] - q[..., 0, :], q[..., 2, :] - q[..., 0, :])
    nnorm = torch.linalg.norm(n, dim=-1)
    II = []
    for i in range(3):
        e = q[..., (i + 2) % 3, :] - q[..., (i + 1) % 3, :]
        h = nnorm / torch.linalg.norm(e, dim=-1)
        alpha = 0.5 * theta3[..., i] + orient3[..., i] * phi3[..., i]
        g = torch.tan(alpha) if variant == "tan" else torch.sin(alpha)
        II.append(2.0 * h * g)
    return _sym2(II[0] + II[1], II[0], II[0] + II[2])


def second_fundamental_form(x18, mask3):
    """Midedge-average SFF [..., 2, 2] of faces from their 6-vertex stencils
    (reference MidedgeAverageFormulation.cpp:7-246): unnormalized own and
    neighbor face normals; II_i = (q_{i+1}+q_{i+2}-2q_i).n_opp,i /
    |n_opp,i + n_c|; b = [[II0+II1, II0],[II0, II0+II2]].

    x18 = [q0,q1,q2, o0,o1,o2] stacked; mask3 [..., 3] zeroes boundary edges."""
    q = x18[..., :9].unflatten(-1, (3, 3))
    o = x18[..., 9:].unflatten(-1, (3, 3))
    cN = torch.linalg.cross(q[..., 1, :] - q[..., 0, :], q[..., 2, :] - q[..., 0, :])
    II = []
    for i in range(3):
        b_v = q[..., (i + 1) % 3, :]
        c_v = q[..., (i + 2) % 3, :]
        # neighbor face (c_v, b_v, o_i) in CCW order; normal matches the
        # consistent orientation of the mesh
        oppN = mask3[..., i, None] * torch.linalg.cross(b_v - c_v, o[..., i, :] - c_v)
        mvec = oppN + cN
        mnorm = torch.sqrt(_dot(mvec, mvec))
        qvec = b_v + c_v - 2.0 * q[..., i, :]
        II.append(_dot(qvec, oppN) / mnorm)
    return _sym2(II[0] + II[1], II[0], II[0] + II[2])


def face_bending_energy(x18, abar, bbar, mask3, thickness, alpha, beta,
                        material: str):
    """Bending energy of faces [...].

    StVK (StVKMaterial.cpp:62-108): t^3/12 * dA * W_StVK(abar^-1 (b-bbar));
    NeoHookean (NeoHookeanMaterial.cpp:70-117): sqrt(det abar) t^3/24 *
    W(adj(a) b / det a - adj(abar) bbar / det abar);
    tension-field: zero (TensionFieldStVKMaterial.cpp:174-189)."""
    if material == "tension_field":
        return x18.new_zeros(x18.shape[:-1])
    b = second_fundamental_form(x18, mask3)
    detabar = _det2(abar)
    if material == "neohookean":
        a = first_fundamental_form(x18[..., :9])
        deta = _det2(a)
        S = (_adj2(a) @ b) / deta[..., None, None] \
            - (_adj2(abar) @ bbar) / detabar[..., None, None]
        coeff = torch.sqrt(detabar) * thickness**3 / 24.0
        return coeff * _stvk_W(S, alpha, beta)
    S = _inv2(abar) @ (b - bbar)
    dA = 0.5 * torch.sqrt(detabar)
    return thickness**3 / 12.0 * dA * _stvk_W(S, alpha, beta)


def face_hessian_bend(x18, abar, bbar, mask3, thickness, alpha, beta,
                      material: str):
    """18x18 bending Hessians [nf, 18, 18] (``vmap(hessian)`` of the face energy)."""
    if material == "tension_field":
        return x18.new_zeros((x18.shape[0], 18, 18))

    def eb(x, ab, bb, mk):
        return face_bending_energy(x, ab, bb, mk, thickness, alpha, beta, material)

    return vmap(hessian(eb))(x18, abar, bbar, mask3)


def _energy_sum(x_flat, F, abars, thickness, alpha, beta, material,
                bend=None):
    """Total elastic energy (0-d tensor); bend = (opp, mask, bbars) or None."""
    xv = x_flat.reshape(-1, 3)
    x9 = xv[F].reshape(F.shape[0], 9)
    total = face_energy(x9, abars, thickness, alpha, beta, material).sum()
    if bend is not None:
        opp, mask, bbars = bend
        x18 = torch.cat([x9, xv[opp].reshape(F.shape[0], 9)], dim=1)
        total = total + face_bending_energy(
            x18, abars, bbars, mask, thickness, alpha, beta, material).sum()
    return total


def energy_and_gradient(fun, x_flat: torch.Tensor):
    """(fun(x), d fun / dx) by one reverse pass; fun maps [3nv] -> 0-d."""
    x = x_flat.detach().requires_grad_(True)
    with torch.enable_grad():
        E = fun(x)
        (G,) = torch.autograd.grad(E, x)
    return E.detach(), G


class ShellEnergy:
    """Stretching (and optional bending) energy with autodiff gradient and
    per-face Hessians, on one device in float64.

    Equivalent of ElasticShell<SFF>::elasticEnergy(...) returning (energy,
    gradient, Hessian triplets); ``hessian`` assembles a scipy CSR over
    interleaved xyz DOFs for the direct solver. The balloon stepper reads
    the rest state (``abars``, ``bbars``, ``opp``, ``mask``) and the
    per-face functions of this module directly, in its own dtype.
    """

    def __init__(self, V_rest, F, thickness, alpha, beta,
                 material="neohookean", bending=False, device="cuda"):
        if material not in MATERIALS:
            raise ValueError(f"unknown material {material!r} (want one of {MATERIALS})")
        self.device = resolve_device(device)
        self.F = np.asarray(F, dtype=np.int64)
        self.n = int(np.asarray(V_rest).shape[0])
        self.thickness = float(thickness)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.material = material
        self.bending = bool(bending)
        self.Ft = torch.as_tensor(self.F, device=self.device)
        Vr = torch.as_tensor(np.asarray(V_rest, dtype=np.float64), device=self.device)
        self.abars = first_fundamental_forms(Vr, self.Ft)
        self.opp = self.mask = self.bbars = None
        if self.bending:
            self.opp, self.mask = opposite_vertices(self.F)
            x18 = torch.cat([Vr[self.Ft].reshape(-1, 9),
                             Vr[torch.as_tensor(self.opp, device=self.device)].reshape(-1, 9)],
                            dim=1)
            self.bbars = second_fundamental_form(
                x18, torch.as_tensor(self.mask, device=self.device))

        # static COO pattern for Hessian assembly: rows/cols of each face's
        # 9x9 block over interleaved DOFs
        dof = (3 * self.F[:, :, None] + np.arange(3)[None, None, :]).reshape(-1, 9)
        self._rows = np.repeat(dof, 9, axis=1).reshape(-1)
        self._cols = np.tile(dof, (1, 9)).reshape(-1)
        if self.bending:
            vids = np.concatenate([self.F, self.opp], axis=1)  # [m, 6]
            dof18 = (3 * vids[:, :, None] + np.arange(3)[None, None, :]).reshape(-1, 18)
            self._rows_b = np.repeat(dof18, 18, axis=1).reshape(-1)
            self._cols_b = np.tile(dof18, (1, 18)).reshape(-1)

    def bend_state(self, dtype=torch.float64):
        """(opp, mask, bbars) on the device, or None without bending."""
        if not self.bending:
            return None
        return (torch.as_tensor(self.opp, device=self.device),
                torch.as_tensor(self.mask, device=self.device, dtype=dtype),
                self.bbars.to(dtype))

    def energy_fn(self, dtype=torch.float64):
        """x_flat [3nv] -> total elastic energy, with the rest state in dtype."""
        abars, bend = self.abars.to(dtype), self.bend_state(dtype)
        return lambda x: _energy_sum(x, self.Ft, abars, self.thickness, self.alpha,
                                     self.beta, self.material, bend=bend)

    def _x(self, x_flat):
        return torch.as_tensor(np.asarray(x_flat, dtype=np.float64), device=self.device)

    def energy(self, x_flat) -> float:
        return float(self.energy_fn()(self._x(x_flat)))

    def gradient(self, x_flat) -> np.ndarray:
        _, G = energy_and_gradient(self.energy_fn(), self._x(x_flat))
        return G.cpu().numpy()

    def face_hess(self, x9, abars):
        return face_hessian_stretch(x9, abars, self.thickness, self.alpha,
                                    self.beta, self.material)

    def face_hess_bend(self, x18, abars, bbars, mask):
        return face_hessian_bend(x18, abars, bbars, mask, self.thickness,
                                 self.alpha, self.beta, self.material)

    def hessian(self, x_flat, psd_project: bool = False) -> sp.csr_matrix:
        """Assembled stiffness K; psd_project=True clamps each per-face
        block to PSD (see psd_project_blocks), as the multigrid stepper does."""
        xv = self._x(x_flat).reshape(-1, 3)
        x9 = xv[self.Ft].reshape(-1, 9)
        H = self.face_hess(x9, self.abars)
        if psd_project:
            H = psd_project_blocks(H)
        rows, cols, vals = self._rows, self._cols, H.cpu().numpy().reshape(-1)
        if self.bending:
            opp, mask, bbars = self.bend_state()
            x18 = torch.cat([x9, xv[opp].reshape(-1, 9)], dim=1)
            Hb = self.face_hess_bend(x18, self.abars, bbars, mask)
            if psd_project:
                Hb = psd_project_blocks(Hb)
            rows = np.concatenate([rows, self._rows_b])
            cols = np.concatenate([cols, self._cols_b])
            vals = np.concatenate([vals, Hb.cpu().numpy().reshape(-1)])
        return sp.coo_matrix((vals, (rows, cols)), shape=(3 * self.n, 3 * self.n)).tocsr()
