"""The probes (``surface_multigrid_code_torch/probes/``) against the JAX package, on the CPU.

On the CPU every probe wrapper runs its plain version; these tests hold
those plain versions, and the layouts the kernels read, to the JAX
package and to numpy / scipy:

- K4 on cut schedules (``psd_precision``'s trunc variants) against the
  Pallas kernel ``ns_sign_apply_packed`` with the same schedule
  (interpret mode), 56 blocks packed 14 a tile, f32, at 1e-5 max|Y| (the
  tolerance of ``test_torch_psd.py``: the two sum in other orders);
- the stages of ``psd_stages`` in f64 against ``ns_sign_apply_packed_xla``
  with the same schedules at 1e-12, the one product also against the
  einsum X + X X, the copy bit for bit;
- the TF32 rounding of the tensor-core plain version bit for bit against
  a numpy reference (round to 11 significant bits, ties away, through
  ``frexp``); its 3-pass product within 1e-6 of the f64 product, the
  1-pass one within 2^-10 (relative to max |P|); its 3-pass sign-apply on
  the full schedule against the Pallas kernel at 1e-5 max|Y|;
- the band plain product against scipy and the JAX ``well_apply``
  (interpret mode) on the RCM-ordered icosphere(3) operator;
- the bf16-valued plain SpMV against scipy on values rounded through
  ``jnp.bfloat16``;
- the band's tile lists on ico3 and on a permuted ico3: "skip" lists
  exactly the tiles that hold a nonzero, "dense" every tile, and a
  tile-by-tile product of the listed tiles (the kernel's operands) equals
  the plain version within ``band_tolerance``; the tile-major layout
  unpacks bit for bit to the band;
- the staged plan's windows against a brute force (``main`` also checks
  the narrow plan, which has wide chunks); the ring plan against a numpy
  simulation of the ring that applies the plan's copies: every chunk
  that reads the ring finds its window there while it computes (the next
  chunk's copy may land meanwhile), the gather gives K1's plain result at
  ``TOL``, and the copies total x once plus one window a CTA; on an
  operator whose second half is permuted the non-monotone chunks go wide
  and the result stays the same;
- each probe's ``main`` on the CPU: one JSON line with its fields.
"""

import json

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from surface_multigrid_code_tpu.ops.psd import (
    NS_SCHEDULE as JSCHEDULE,
    ns_sign_apply_packed,
    ns_sign_apply_packed_xla,
)
from surface_multigrid_code_tpu.ops.well import build_well_auto, well_apply

from surface_multigrid_code_torch import bench
from surface_multigrid_code_torch.ops.sparse import csr_from_scipy
from surface_multigrid_code_torch.ops.spmv import fused_spmv_plain
from surface_multigrid_code_torch.probes import (
    band_spmv,
    bf16_values,
    psd_precision,
    psd_stages,
    staged_spmv,
)

torch.set_num_threads(1)

TILE = 128
PACK = 14  # 9x9 blocks a 128x128 tile


def _pack(X):
    m, d, _ = X.shape
    Z = np.zeros((-(-m // PACK), TILE, TILE), X.dtype)
    for i in range(m):
        o = (i % PACK) * d
        Z[i // PACK, o:o + d, o:o + d] = X[i]
    return Z


def _unpack(Y, m, d):
    return np.stack([Y[i // PACK, (i % PACK) * d:(i % PACK + 1) * d,
                       (i % PACK) * d:(i % PACK + 1) * d] for i in range(m)])


def _scaled(m, seed):
    return psd_stages.random_scaled(m, seed)


@pytest.fixture(scope="module")
def ico3():
    """The RCM-ordered finest operator of ``bench.ico_operators(3)`` (f64)."""
    return bench.ico_operators(3, None)[0][0]


def _permuted(H, seed, tail=0):
    """H with its rows and columns permuted at random from ``tail`` on."""
    perm = np.arange(H.shape[0])
    perm[tail:] = tail + np.random.default_rng(seed).permutation(H.shape[0] - tail)
    return sp.csr_matrix(H[perm][:, perm])


@pytest.mark.parametrize("k", [1, 2, 3])
def test_truncated_schedule_matches_pallas(k):
    X = _scaled(56, seed=10 + k)
    ref = _unpack(np.asarray(ns_sign_apply_packed(jnp.asarray(_pack(X)),
                                                  schedule=JSCHEDULE[:-k])), 56, 9)
    got = psd_precision.variant_fn(f"fp32-trunc{k}")(torch.as_tensor(X)).numpy()
    assert psd_precision.variant_steps(f"fp32-trunc{k}") == len(JSCHEDULE) - k
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("stage", list(psd_stages.STAGES))
def test_stages_match_xla(stage):
    schedule = psd_stages.STAGES[stage]
    if schedule is None:  # the copy runs in f32 only, K4's register body
        X32 = _scaled(40, seed=20)
        assert np.array_equal(psd_stages.stage_fn(stage)(torch.as_tensor(X32)).numpy(), X32)
        return
    X = _scaled(40, seed=20).astype(np.float64)
    got = psd_stages.stage_fn(stage)(torch.as_tensor(X)).numpy()
    ref = _unpack(np.asarray(ns_sign_apply_packed_xla(jnp.asarray(_pack(X)), schedule)), 40, 9)
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()
    if schedule == ():
        prod = X + np.einsum("fij,fjk->fik", X, X)
        assert np.abs(got - prod).max() <= 1e-12 * np.abs(prod).max()


def _tf32_numpy(x):
    """Round f32 values to 11 significant bits, ties away from zero."""
    m, e = np.frexp(x.astype(np.float64))
    r = np.copysign(np.floor(np.abs(m) * 2.0**11 + 0.5), m)
    return np.ldexp(r, e - 11).astype(np.float32)


def test_tf32_round_bitwise():
    rng = np.random.default_rng(30)
    x = (rng.standard_normal(4096) * 10.0 ** rng.uniform(-30, 30, 4096)).astype(np.float32)
    bits = x.view(np.int32)
    # exact ties (the 13 dropped bits 0x1000) and values just below them
    ties = ((bits & ~0x1FFF) | 0x1000).view(np.float32)
    below = ((bits & ~0x1FFF) | 0x0FFF).view(np.float32)
    x = np.concatenate([x, ties, below, np.float32([0.0, -0.0, 1.0, -1.5])])
    got = psd_precision.tf32_round(torch.as_tensor(x)).numpy()
    assert np.array_equal(got.view(np.int32), _tf32_numpy(x).view(np.int32))


@pytest.mark.parametrize("passes, bound", [(3, 1e-6), (1, 2.0**-10)])
def test_tc_product_precision(passes, bound):
    A, B = _scaled(64, seed=31), _scaled(64, seed=32)
    got = psd_precision.tc_bmm(torch.as_tensor(A), torch.as_tensor(B), passes).numpy()
    ref = np.einsum("fij,fjk->fik", A.astype(np.float64), B.astype(np.float64))
    assert np.abs(got - ref).max() <= bound * np.abs(ref).max()


def test_tc_plain_checks_on_the_cpu():
    """The tensor-core wrapper takes the CPU path: its 3-pass plain
    version on the full schedule against the Pallas kernel (interpret
    mode) at the f32 tolerance of the cut schedules; the 1-pass one
    beyond it; the full-schedule metrics of 3 passes near f32's."""
    X = _scaled(56, seed=33)
    ref = _unpack(np.asarray(ns_sign_apply_packed(jnp.asarray(_pack(X)))), 56, 9)
    scale = np.abs(ref).max()
    got = {passes: psd_precision.ns_sign_apply_tc(torch.as_tensor(X), JSCHEDULE, passes).numpy()
           for passes in psd_precision.PASSES}
    assert np.abs(got[3] - ref).max() <= 1e-5 * scale
    assert np.abs(got[1] - ref).max() > 1e-4 * scale
    p = psd_precision.prepare(psd_precision.random_blocks(64, 33), torch.device("cpu"))
    rec = psd_precision.measure(p, torch.device("cpu"), timed=False)
    v = rec["variants"]
    assert abs(v["3xtf32"]["reldiff_vs_f64"]) < 1e-4
    assert v["tf32"]["reldiff_vs_f64"] > v["3xtf32"]["reldiff_vs_f64"]


def test_tc_plain_ragged_matches_pallas():
    """At a block count that fills no whole tile, group of 4 or warp's
    blocks (37), the 3-pass plain version against the Pallas kernel as at
    56."""
    X = _scaled(37, seed=34)
    ref = _unpack(np.asarray(ns_sign_apply_packed(jnp.asarray(_pack(X)))), 37, 9)
    got = psd_precision.ns_sign_apply_tc(torch.as_tensor(X), JSCHEDULE, 3).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("passes, mmas, flop, us", [
    (1, psd_precision.TILE_MMAS, 3_236_659_200, 6.538705),
    (3, psd_precision.TILE_MMAS, 9_709_977_600, 19.616116),
    (1, psd_precision.PARENT_TILE_MMAS, 6_473_318_400, 13.077411),
    (3, psd_precision.PARENT_TILE_MMAS, 19_419_955_200, 39.232233),
])
def test_tc_tile_bound(passes, mmas, flop, us):
    """The tile bound at the probe's 31,608 blocks and 12 steps (PERF.md
    §6 row 5): 2 m16n8k8 a product a pass, 4 in the 16^3 design before."""
    m, steps = psd_precision.BLOCKS, len(JSCHEDULE)
    assert (m, steps) == (31_608, 12)
    assert mmas * psd_precision.MMA_FLOP * passes * (2 * steps + 1) * m == flop
    got = psd_precision.tc_tile_bound_ms(m, steps, passes, mmas)
    assert abs(1e3 * got - us) <= 1e-6
    assert got == pytest.approx(1e3 * flop / psd_precision.C.TF32_FLOPS_PER_S, rel=1e-12)


def test_check_tc_holds_a_version_to_the_plain_one():
    """``check_tc`` at 0, 1 and 2 steps passes the plain version given as
    the version and refuses one an entry off by twice the limit."""
    p = psd_precision.prepare(psd_precision.random_blocks(37, 35), torch.device("cpu"))
    rec = psd_precision.check_tc(p, (0, 1, 2), fn=psd_precision.ns_sign_apply_tc_plain)
    assert {k for k in rec if "steps" in k} == {
        f"passes{q}_steps{s}" for q in psd_precision.PASSES for s in (0, 1, 2)}
    assert all(r["max_abs_err"] == 0.0 for k, r in rec.items() if "steps" in k)

    def off(X, schedule, passes):
        Y = psd_precision.ns_sign_apply_tc_plain(X, schedule, passes).clone()
        Y[-1, 8, 8] += 2 * psd_precision.tc_tolerance(len(schedule), passes) * max(
            1.0, float(Y.abs().max()))
        return Y

    with pytest.raises(RuntimeError, match="from its plain version"):
        psd_precision.check_tc(p, (0, 1, 2), fn=off)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_band_plain_matches_scipy_and_well_apply(ico3, dtype):
    H = ico3
    L = band_spmv.band_layout(H, "cpu", dtype)
    assert L.W % band_spmv.BAND_K == 0 and L.blocks == -(-H.shape[0] // band_spmv.BAND_ROWS)
    X = np.random.default_rng(40).standard_normal((H.shape[1], 3)).astype(np.float32)
    got = band_spmv.band_spmv_tc(L, torch.as_tensor(X)).numpy()
    if dtype == torch.float32:
        ref = H @ X.astype(np.float64)
        W = build_well_auto(H, dtype=jnp.float64)
        ref_well = np.asarray(well_apply(W, jnp.asarray(X.T.astype(np.float64)))).T
        assert np.abs(ref_well - ref).max() <= 1e-12 * np.abs(ref).max()
        assert np.abs(got - ref_well).max() <= 1e-5 * np.abs(ref).max()
    else:
        # both operands rounded to bf16, the products exact in f32
        Hb = sp.csr_matrix((np.asarray(jnp.asarray(H.data.astype(np.float32), jnp.bfloat16),
                                       np.float64), H.indices, H.indptr), shape=H.shape)
        Xb = np.asarray(jnp.asarray(X, jnp.bfloat16), np.float64)
        ref = Hb @ Xb
        assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


def test_band_layout_holds_the_operator(ico3):
    H = ico3
    L = band_spmv.band_layout(H, "cpu", torch.float32)
    band, start = L.band.numpy(), L.start.numpy()
    dense = np.zeros(H.shape)
    for r in range(L.blocks):
        rows = slice(r * band_spmv.BAND_ROWS, min((r + 1) * band_spmv.BAND_ROWS, H.shape[0]))
        n = rows.stop - rows.start
        span = min(L.W, H.shape[1] - start[r])
        dense[rows, start[r]:start[r] + span] = band[rows.start:rows.start + n, :span]
    assert np.array_equal(dense, H.toarray().astype(np.float32).astype(np.float64))


def test_bf16_plain_spmv_matches_scipy(ico3):
    H = ico3
    v = bf16_values.jacobi_inputs(H, "cpu", seed=50)
    A16 = bf16_values.bf16_operator(csr_from_scipy(H, "cpu", torch.float32))
    got = bf16_values.spmv_bf16_values(A16, v["x"], v["u"], v["b"], v["s"],
                                       bf16_values.ESCALE).numpy()
    vals = np.asarray(jnp.asarray(H.data.astype(np.float32), jnp.bfloat16), np.float64)
    Hb = sp.csr_matrix((vals, H.indices, H.indptr), shape=H.shape)
    h = {k: t.double().numpy() for k, t in v.items()}
    ref = h["u"] + (h["b"] - Hb @ h["x"]) * (h["s"] * bf16_values.ESCALE)
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("chunk_rows, window", [(64, 8192), (64, 64), (100, 512)])
def test_staged_plan_windows(ico3, chunk_rows, window):
    H = ico3
    plan = staged_spmv.staged_plan(H, "cpu", chunk_rows, window)
    lo, hi = plan.win_lo.numpy(), plan.win_hi.numpy()
    wide = plan.table.numpy()[:, 2]
    for c in range(plan.n_chunks):
        cols = H[c * chunk_rows:(c + 1) * chunk_rows].indices
        assert (lo[c], hi[c]) == ((cols.min(), cols.max()) if cols.size else (0, -1))
        if ((hi[c] + 4) & ~3) - (lo[c] & ~3) > window:  # a window the ring cannot hold
            assert wide[c]
    assert plan.wide == wide.sum()
    assert (plan.wide > 0) == (window == 64)


def _tiled_product(L, X, tiles):
    """Y = A X tile by tile over the list ``tiles``, from the packed tiles
    (unpacked) and X's tiles, in f64 with the kernel's operands: X rounded
    to bf16 for the bf16 band; for the f32 band X rounded to TF32 (nearest,
    ties away, as the cast pass does) and the values cut to TF32 (the low
    13 bits dropped: the tensor cores read the stored f32 values as
    TF32)."""
    T = L.lists[tiles]
    A = band_spmv.unpack_tiles(T.tiles, band_spmv.BAND_K).view(-1, band_spmv.BAND_ROWS,
                                                                band_spmv.BAND_K)
    if L.band.dtype == torch.bfloat16:
        A, Xr = A.double(), X.to(torch.bfloat16).double()
    else:
        A = (A.view(torch.int32) & ~0x1FFF).view(torch.float32).double()
        Xr = psd_precision.tf32_round(X).double()
    Xp = torch.zeros((L.x_rows, X.shape[1]), dtype=torch.float64)
    Xp[:X.shape[0]] = Xr
    Y = torch.zeros((L.blocks, band_spmv.BAND_ROWS, X.shape[1]), dtype=torch.float64)
    ptr, tk, start = T.tile_ptr.numpy(), T.tile_k.numpy(), L.start.numpy()
    for r in range(L.blocks):
        for t in range(ptr[r], ptr[r + 1]):
            c0 = int(start[r]) + band_spmv.BAND_K * int(tk[t])
            Y[r] += A[t] @ Xp[c0:c0 + band_spmv.BAND_K]
    return Y.reshape(-1, X.shape[1])[:L.n_rows]


@pytest.mark.parametrize("operator", ["ico3", "permuted"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_band_tile_lists(ico3, operator, dtype):
    """"skip" lists exactly the tiles of the band that hold a nonzero,
    "dense" every tile, each block's in window order; the tile-by-tile
    product of either list equals the plain version within
    ``band_tolerance`` of |A| |X|."""
    H = ico3 if operator == "ico3" else _permuted(ico3, 41)
    L = band_spmv.band_layout(H, "cpu", dtype)
    assert (L.start.numpy() % band_spmv.BAND_K == 0).all()
    nw = L.W // band_spmv.BAND_K
    full = L.band.view(L.blocks, band_spmv.BAND_ROWS, nw, band_spmv.BAND_K).ne(0).any(3).any(1)
    for name, want in (("skip", full), ("dense", torch.ones_like(full))):
        T = L.lists[name]
        ptr, tk = T.tile_ptr.numpy(), T.tile_k.numpy()
        assert ptr[0] == 0 and ptr[-1] == T.n_tiles == T.tiles.shape[0]
        for r in range(L.blocks):
            assert list(tk[ptr[r]:ptr[r + 1]]) == list(np.flatnonzero(want[r].numpy()))
    if operator == "permuted":
        assert L.lists["skip"].n_tiles < L.lists["dense"].n_tiles
    X = torch.as_tensor(np.random.default_rng(42).standard_normal((H.shape[1], 5))
                        .astype(np.float32))
    ref = band_spmv.band_spmv_tc_plain(L, X).double()
    mag = torch.matmul(L.band.view(L.blocks, band_spmv.BAND_ROWS, L.W).abs().double(),
                       band_spmv.windows(L, X.abs()).double()).reshape(-1, 5)[:L.n_rows]
    for name in band_spmv.TILE_LISTS:
        got = _tiled_product(L, X, name)
        assert bool(((got - ref).abs() <= band_spmv.band_tolerance(L) * mag).all()), name


@pytest.mark.parametrize("operator", ["ico3", "permuted"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_band_tiles_unpack_to_the_band(ico3, operator, dtype):
    """The tile-major layout (wgmma's core-matrix order) unpacks bit for
    bit to the band: every tile for "dense", the listed ones (the others
    zero) for "skip"."""
    H = ico3 if operator == "ico3" else _permuted(ico3, 43)
    L = band_spmv.band_layout(H, "cpu", dtype)
    dense = L.lists["dense"]
    assert torch.equal(band_spmv.unpack_tiles(dense.tiles, L.W).view(torch.int16 if dtype ==
                       torch.bfloat16 else torch.int32),
                       L.band.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))
    skip = L.lists["skip"]
    nw = L.W // band_spmv.BAND_K
    ids = (np.repeat(np.arange(L.blocks), np.diff(skip.tile_ptr.numpy())) * nw
           + skip.tile_k.numpy())
    tiles = torch.zeros_like(dense.tiles)
    tiles[torch.as_tensor(ids)] = skip.tiles
    assert torch.equal(band_spmv.unpack_tiles(tiles, L.W), L.band)
    # one core matrix: 8 rows of 16 bytes, K-major, at (k group, row group)
    kc = band_spmv.core_k(dtype)
    t = dense.tiles[0].view(band_spmv.BAND_K // kc, band_spmv.BAND_ROWS // 8, 8, kc)
    assert torch.equal(t[1, 2], L.band[16:24, kc:2 * kc])


def _simulate_ring(H, plan, v):
    """The sweep as the kernel makes it with ``plan``: per CTA, the ring's
    slots (the column each holds and its x) after each copy; a ring chunk
    must find its window both after its own copy and after the next
    chunk's (which may land while it computes). Returns y (f64)."""
    x, u, b, s = (v[k].double().numpy() for k in ("x", "u", "b", "s"))
    table, cta = plan.table.numpy(), plan.cta_ptr.numpy()
    R, n, rows = plan.ring, H.shape[0], plan.chunk_rows
    y = np.zeros(n)
    for blk in range(plan.grid):
        tags, vals = np.full(R, -1), np.zeros(R)

        def apply(c):
            cols = np.arange(table[c, 0], min(table[c, 1], H.shape[1]))
            tags[cols % R], vals[cols % R] = cols, x[cols]

        chunks = range(cta[blk], cta[blk + 1])
        if len(chunks):
            apply(chunks[0])
        for k, c in enumerate(chunks):
            sub = H[c * rows:(c + 1) * rows]
            held = tags[sub.indices % R] == sub.indices
            if k + 1 < len(chunks):
                apply(chunks[k + 1])
                held &= tags[sub.indices % R] == sub.indices
            if not table[c, 2]:
                assert held.all(), f"chunk {c} reads columns the ring does not hold"
                xs = vals[sub.indices % R]
            else:
                xs = x[sub.indices]
            Ax = np.add.reduceat(sub.data * xs, sub.indptr[:-1]) if sub.nnz else 0.0
            Ax = np.where(np.diff(sub.indptr) > 0, Ax, 0.0)
            r = slice(c * rows, c * rows + sub.shape[0])
            y[r] = u[r] + (b[r] - Ax) * (s[r] * bf16_values.ESCALE)
    return y


@pytest.mark.parametrize("operator, chunk_rows, ring, grid, wide", [
    ("ico3", 64, 256, 4, False), ("ico3", 32, 64, 7, True), ("ico3", 64, 8192, 3, False),
    ("permuted", 32, 256, 5, True)])
def test_staged_ring_plan_holds_every_window(ico3, operator, chunk_rows, ring, grid, wide):
    """The ring plan on the host: a simulation of the ring with the plan's
    copies gives K1's plain result at TOL x max|y|; the copies bring x
    once plus one window a CTA (16-byte rounding aside); on the operator
    whose second half is permuted, only the non-monotone chunks
    go wide, and the result is the same."""
    H = ico3 if operator == "ico3" else _permuted(ico3, 44, tail=ico3.shape[0] // 2)
    plan = staged_spmv.staged_plan(H, "cpu", chunk_rows, ring, grid=grid)
    assert plan.grid == grid
    cta = plan.cta_ptr.numpy()
    assert cta[0] == 0 and cta[-1] == plan.n_chunks and (np.diff(cta) >= 0).all()
    v = bf16_values.jacobi_inputs(H, "cpu", seed=45)
    A = csr_from_scipy(H, "cpu", torch.float32)
    ref = fused_spmv_plain(A, v["x"], "axpby", b=v["b"], u=v["u"], s=v["s"],
                           escale=bf16_values.ESCALE).double().numpy()
    got = _simulate_ring(H, plan, v)
    assert np.abs(got - ref).max() <= staged_spmv.TOL * np.abs(ref).max()
    lo, hi = plan.win_lo.numpy(), plan.win_hi.numpy()
    first = [c for b in range(plan.grid) for c in range(cta[b], cta[b + 1])[:1]]
    once = H.shape[1] + sum(hi[c] + 4 - (lo[c] & ~3) for c in first) + 4 * plan.grid
    assert (plan.wide > 0) == wide
    flags = plan.table.numpy()[:, 2].astype(bool)
    if operator == "ico3":
        assert plan.copy_bytes // 4 <= once
    else:
        half = (H.shape[0] // 2) // chunk_rows
        # the chunks just before the jump go wide too: the next copy would
        # overwrite their windows
        assert not flags[:half - 3].any() and flags[half + 1:].all()


@pytest.mark.parametrize("probe, argv, fields", [
    (psd_precision, ["--blocks", "40"], ("variants", "tc_checks", "blocks")),
    (psd_stages, ["--blocks", "40"], ("runs",)),
    (bf16_values, ["--orders", "3", "--cache-dir", ""], ("runs",)),
    (staged_spmv, ["--orders", "3", "--cache-dir", ""], ("runs",)),
    (band_spmv, ["--orders", "3", "--cache-dir", ""], ("runs",)),
])
def test_probe_main_prints_one_json_line(probe, argv, fields, capsys):
    assert probe.main(["--device", "cpu", *argv]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["probe"] == probe.__name__.rsplit(".", 1)[1]
    assert rec["device"] == {"type": "cpu"}
    for f in fields:
        assert f in rec
    if probe is psd_precision:
        assert set(rec["variants"]) == set(psd_precision.VARIANTS)
        assert all(v["ms"] is None for v in rec["variants"].values())
    elif probe is psd_stages:
        assert set(rec["runs"][0]["stages"]) == set(psd_stages.STAGES)
        assert set(rec["runs"][0]["checks"]) == set(psd_stages.STAGES)
    else:
        run = rec["runs"][0]
        assert run["operator"].startswith("ico3 A_0") and "check" in run
        if probe is band_spmv:
            assert {(c["band"], c["nc"]) for c in run["cases"]} == {
                (b, nc) for b in ("bfloat16", "float32") for nc in band_spmv.NCS}
            assert set(run["tiles"]) == set(band_spmv.TILE_LISTS)
            assert 0 < run["tiles"]["skip"] <= run["tiles"]["dense"]
            assert set(run["check"]) == {f"{b} nc={nc} {t}" for b in ("bfloat16", "float32")
                                         for nc in band_spmv.NCS for t in band_spmv.TILE_LISTS}
            for c in run["cases"]:
                for t in band_spmv.TILE_LISTS:
                    assert c[f"{t}_tile_bound_ms"] > 0 and c[f"{t}_x_tile_bytes"] > 0
                assert c["skip_tile_bound_ms"] <= c["dense_tile_bound_ms"]
                assert c["ms"] is None and c["dense_ms"] is None
        if probe is staged_spmv:
            assert run["copy_bytes"] > 0 and run["wide_chunks"] == 0
            assert run["check"]["narrow"]["wide_chunks"] > 0
            assert {run["check"][k]["stage_a"] for k in ("plan", "plan_a")} == {False, True}
