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
- the staged plan's windows against a brute force (``main`` also checks
  the narrow plan, which has wide chunks);
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
    wide = 0
    for c in range(plan.n_chunks):
        cols = H[c * chunk_rows:(c + 1) * chunk_rows].indices
        assert (lo[c], hi[c]) == ((cols.min(), cols.max()) if cols.size else (0, -1))
        wide += hi[c] + 1 - (lo[c] & ~3) > window
    assert plan.wide == wide
    assert (wide > 0) == (window == 64)


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
