"""Multigrid hierarchy construction and its npz (ports ``surface_multigrid_code_tpu/solver/hierarchy.py``).

Host-side (offline) stage: runs SSP decimation and composes the collapse
log into sparse prolongation operators.

Semantics follow the reference:
- `mg_precompute` (src/mg_precompute.cpp:15-90): level count = number of
  times nV*ratio stays > nVCoarsest; per level the decimation target is
  round(#F_prev * ratio) FACES; stores V, F, P, PT = P^T, P_full = P per
  level. An optional caller-seeded level-0 record is reused.
- `get_prolong` (src/get_prolong.cpp:3-56): runs SSP_decimate, seeds each
  fine vertex with a corner barycentric on its first incident face, pushes
  all fine vertices through the collapse log with query_fine_to_coarse,
  and assembles P (#V_fine x #V_coarse, rows = convex barycentric weights,
  <= 3 nnz each) from (row, BF, BC) triplets.
- `save_hierarchy` / `load_hierarchy`: per-level V/F, decimation metadata
  and CSR prolongations in one npz, the JAX package's format, so a file
  either package writes loads in the other.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp

from surface_multigrid_code_torch.config import DecimationType


@dataclass
class MGLevel:
    """Analog of reference mg_data (src/mg_data.h:11-44)."""

    V: np.ndarray
    F: np.ndarray
    P_full: sp.csr_matrix | None = None
    P: sp.csr_matrix | None = None
    PT: sp.csr_matrix | None = None
    A: sp.csr_matrix | None = None
    A_diag: np.ndarray | None = None
    # how this level was decimated; None on hand-built levels
    dec_type: "DecimationType | None" = None
    ratio: float | None = None


def _seed_corner_barycentrics(
    nV: int, FO: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Seed each fine vertex at a corner of its first incident face.

    Reference get_prolong.cpp:23-39: iterate faces in order; the first face
    that references a vertex fixes its (BC one-hot, BF=face row, FIdx).
    """
    FO = np.asarray(FO, dtype=np.int64)
    BC = np.zeros((nV, 3))
    BF = np.zeros((nV, 3), dtype=np.int64)
    FIdx = np.zeros(nV, dtype=np.int64)
    # first occurrence of each vertex among flattened (face-major) corners
    flat = FO.ravel()
    first_pos = np.full(nV, -1, dtype=np.int64)
    uniq, first = np.unique(flat, return_index=True)
    first_pos[uniq] = first
    fidx = first_pos // 3
    corner = first_pos % 3
    valid = first_pos >= 0
    BC[np.nonzero(valid)[0], corner[valid]] = 1.0
    BF[valid] = FO[fidx[valid]]
    FIdx[valid] = fidx[valid]
    return BC, BF, FIdx


def get_prolong(
    VO: np.ndarray,
    FO: np.ndarray,
    tarF: int,
    dec_type: DecimationType = DecimationType.MIDPOINT,
    seed: int | None = None,
):
    """One coarsening step -> (V, F, P, J, IM, log) with P: #VO x #V prolongation."""
    from surface_multigrid_code_torch.query.maps import query_fine_to_coarse
    from surface_multigrid_code_torch.ssp.decimate import SSP_decimate

    VO = np.asarray(VO, dtype=np.float64)
    FO = np.asarray(FO, dtype=np.int64)
    ok, V, F, J, IM, dec_log = SSP_decimate(VO, FO, tarF, dec_type, seed=seed)
    if not ok:
        raise RuntimeError("SSP_decimate failed (non-manifold input?)")

    BC, BF, FIdx = _seed_corner_barycentrics(VO.shape[0], FO)
    BC, BF, FIdx = query_fine_to_coarse(dec_log, BC, BF, FIdx)

    rows = np.tile(np.arange(VO.shape[0]), 3)
    cols = BF.T.ravel()
    vals = BC.T.ravel()
    P = sp.coo_matrix((vals, (rows, cols)), shape=(VO.shape[0], V.shape[0])).tocsr()
    P.sum_duplicates()
    return V, F, P, J, IM, dec_log


def get_prolong_block(
    VO: np.ndarray,
    FO: np.ndarray,
    tarF: int,
    dec_type: DecimationType = DecimationType.MIDPOINT,
    seed: int | None = None,
):
    """Block (3-DOF) prolongation: P is 3#VO x 3#V on xyz-interleaved DOFs."""
    V, F, P, J, IM, dec_log = get_prolong(VO, FO, tarF, dec_type, seed=seed)
    P = P.tocoo()
    rows = np.concatenate([3 * P.row, 3 * P.row + 1, 3 * P.row + 2])
    cols = np.concatenate([3 * P.col, 3 * P.col + 1, 3 * P.col + 2])
    vals = np.concatenate([P.data, P.data, P.data])
    Pb = sp.coo_matrix(
        (vals, (rows, cols)), shape=(3 * P.shape[0], 3 * P.shape[1])
    ).tocsr()
    return V, F, Pb, J, IM, dec_log


def _num_levels(nV: int, ratio: float, nv_coarsest: int) -> int:
    """Reference level-count rule (src/mg_precompute.cpp:27-40)."""
    n_lvs = 1
    nv = float(nV)
    while True:
        nv *= ratio
        if nv > nv_coarsest:
            n_lvs += 1
        else:
            break
    return n_lvs


def mg_precompute(
    V: np.ndarray,
    F: np.ndarray,
    ratio: float = 0.25,
    min_coarsest_nv: int = 500,
    dec_type: DecimationType = DecimationType.MIDPOINT,
    mg: list[MGLevel] | None = None,
    block: bool = False,
    verbose: bool = True,
    seed: int | None = None,
) -> list[MGLevel]:
    """Build the level stack (reference src/mg_precompute.cpp:15-90).

    If `mg` is passed non-empty, its level-0 record is reused
    (reference :43-49). With `block`, each P is the 3-expanded block
    prolongation (`get_prolong_block`). Returns the new list of MGLevel.
    """
    V = np.asarray(V, dtype=np.float64)
    F = np.asarray(F, dtype=np.int64)
    n_lvs = _num_levels(V.shape[0], ratio, min_coarsest_nv)

    lv0 = mg[0] if mg else MGLevel(V=V, F=F)
    out: list[MGLevel] = [lv0]
    for lv in range(1, n_lvs):
        tarF = int(round(out[lv - 1].F.shape[0] * ratio))
        if verbose:
            print(f"lv: {lv}, tarF: {tarF}")
        build = get_prolong_block if block else get_prolong
        Vc, Fc, P, _, _, _ = build(
            out[lv - 1].V, out[lv - 1].F, tarF, dec_type, seed=seed
        )
        if verbose:
            print(f"lv: {lv}, Vc: {Vc.shape[0]}")
        out.append(
            MGLevel(V=Vc, F=Fc, P_full=P, P=P, PT=P.T.tocsr(),
                    dec_type=dec_type, ratio=ratio)
        )
    if verbose:
        print("============")
        print("Multigrid Info")
        print("============")
        print(f"numLv: {len(out)}")
        print(f"|V_coarsest|: {out[-1].V.shape[0]}")
    return out


def extend_hierarchy(
    mg: list[MGLevel],
    ratio: float | None = None,
    min_coarsest_nv: int = 40,
    dec_type: "DecimationType | None" = None,
    verbose: bool = False,
    seed: int | None = None,
) -> list[MGLevel]:
    """Continue decimation below an existing hierarchy's coarsest level,
    applying the reference level-count rule (src/mg_precompute.cpp:27-40)
    from the current coarsest mesh downward.

    Steppers that refresh the hierarchy every Newton iteration pay a dense
    Cholesky inverse of the coarsest operator each time, so they push the
    hierarchy deeper than the reference's >500-vertex rule. Returns a NEW
    list; `mg` is not mutated and its level records are shared. (The JAX
    package's ``block=True`` variant builds 3-expanded prolongations; the
    port's block solver takes the scalar hierarchy, so it has no such option.)
    """
    out = list(mg)
    # continue with the strategy the hierarchy itself was built with
    # (recorded on its levels by mg_precompute); hand-built hierarchies
    # without metadata fall back to the reference defaults
    if dec_type is None:
        dec_type = out[-1].dec_type if out[-1].dec_type is not None \
            else DecimationType.MIDPOINT
    if ratio is None:
        ratio = out[-1].ratio if out[-1].ratio is not None else 0.25
    while out[-1].V.shape[0] * ratio > min_coarsest_nv:
        tarF = int(round(out[-1].F.shape[0] * ratio))
        if verbose:
            print(f"extend lv: {len(out)}, tarF: {tarF}")
        try:
            Vc, Fc, P, _, _, _ = get_prolong(
                out[-1].V, out[-1].F, tarF, dec_type, seed=seed
            )
        except RuntimeError as e:  # decimation gave up (tiny/degenerate)
            import warnings

            warnings.warn(
                f"extend_hierarchy stopped at level {len(out)}: {e}",
                stacklevel=2,
            )
            break
        if Vc.shape[0] >= out[-1].V.shape[0]:
            break
        out.append(MGLevel(V=Vc, F=Fc, P_full=P, P=P, PT=P.T.tocsr(),
                           dec_type=dec_type, ratio=ratio))
    return out


def save_hierarchy(path, mg: list[MGLevel]) -> None:
    """Serialize a hierarchy (per-level V/F + CSR prolongations) to npz:
    the checkpoint the reference never persists, so the expensive SSP host
    precompute becomes reusable across runs."""
    arrs: dict[str, np.ndarray] = {"n_levels": np.asarray([len(mg)])}
    for lv, L in enumerate(mg):
        arrs[f"V{lv}"] = L.V
        arrs[f"F{lv}"] = L.F
        arrs[f"meta{lv}"] = np.asarray([
            -1.0 if L.dec_type is None else float(int(L.dec_type)),
            np.nan if L.ratio is None else float(L.ratio),
        ])
        if lv > 0:
            P = L.P_full.tocsr()
            arrs[f"P{lv}_indptr"] = P.indptr
            arrs[f"P{lv}_indices"] = P.indices
            arrs[f"P{lv}_data"] = P.data
            arrs[f"P{lv}_shape"] = np.asarray(P.shape)
    np.savez_compressed(path, **arrs)


def load_hierarchy(path) -> list[MGLevel]:
    with np.load(path) as z:
        n = int(z["n_levels"][0])
        mg = []
        for lv in range(n):
            level = MGLevel(V=z[f"V{lv}"], F=z[f"F{lv}"])
            if f"meta{lv}" in z.files:
                dt, rt = z[f"meta{lv}"]
                if dt >= 0:
                    level.dec_type = DecimationType(int(dt))
                if not np.isnan(rt):
                    level.ratio = float(rt)
            if lv > 0:
                P = sp.csr_matrix(
                    (
                        z[f"P{lv}_data"],
                        z[f"P{lv}_indices"],
                        z[f"P{lv}_indptr"],
                    ),
                    shape=tuple(z[f"P{lv}_shape"]),
                )
                level.P_full = P
                level.P = P
                level.PT = P.T.tocsr()
            mg.append(level)
    return mg


def mg_precompute_block(
    V: np.ndarray,
    F: np.ndarray,
    ratio: float = 0.25,
    min_coarsest_nv: int = 500,
    dec_type: DecimationType = DecimationType.MIDPOINT,
    mg: list[MGLevel] | None = None,
    verbose: bool = True,
    seed: int | None = None,
) -> list[MGLevel]:
    """Block-DOF hierarchy (reference src/mg_precompute_block.cpp): P acts
    on xyz-interleaved stacked 3-vectors; the balloon's scalar cross-check
    solves on it."""
    return mg_precompute(V, F, ratio, min_coarsest_nv, dec_type, mg=mg,
                         block=True, verbose=verbose, seed=seed)
