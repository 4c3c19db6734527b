"""The port's point queries against the JAX package's and the host walk.

The walk on the card (K5, ``csrc/query_walk.cu``) runs only there; on the
CPU ``query.device.query_walk`` takes its plain PyTorch version, the JAX
package's lockstep loop. Here that version is held against the JAX
package's device walk and the host OpenMP walk on one icosphere(3) log, at
the bars of ``tests/test_query_device.py``: positions, not ids, because an
f32 walk may take the other face of an exact tie. ``chip_smoke.py`` holds
K5 against the same version on the card.
"""

import numpy as np
import pytest
import torch

from surface_multigrid_code_tpu.query.device import pad_log
from surface_multigrid_code_tpu.query.device import (
    query_coarse_to_fine_device as jax_c2f,
    query_fine_to_coarse_device as jax_f2c,
)
from surface_multigrid_code_tpu.ssp.decimate import SSP_decimate as jax_decimate
from surface_multigrid_code_tpu.utils.synthetic import icosphere

from surface_multigrid_code_torch.query import device as qd
from surface_multigrid_code_torch.query.maps import query_coarse_to_fine, query_fine_to_coarse
from surface_multigrid_code_torch.ssp import _native
from surface_multigrid_code_torch.ssp.decimate import SSP_decimate
from surface_multigrid_code_torch.utils.synthetic import drum

torch.set_num_threads(1)


def _positions(bc, bf, Vtab):
    return (np.asarray(bc)[:, :, None] * Vtab[np.asarray(bf)]).sum(1)


def _rand_queries(F, n, seed=0):
    rng = np.random.default_rng(seed)
    fids = rng.integers(0, F.shape[0], n)
    return rng.dirichlet(np.ones(3), n), F[fids], fids


def _corner_seeds(nV, F):
    """Each vertex at a corner of its first face (tests/test_query_device.py)."""
    BC = np.zeros((nV, 3))
    BF = np.zeros((nV, 3), dtype=np.int64)
    FIdx = np.zeros(nV, dtype=np.int64)
    seen = np.zeros(nV, bool)
    for fi, f in enumerate(F):
        for c, v in enumerate(f):
            if not seen[v]:
                seen[v] = True
                BC[v, c] = 1.0
                BF[v] = f
                FIdx[v] = fi
    return BC, BF, FIdx


def _held(p, ref):
    """The bar of tests/test_query_device.py:47-48."""
    err = np.linalg.norm(p - ref, axis=1)
    assert np.median(err) < 1e-6, np.median(err)
    assert (err < 1e-3).mean() > 0.99, err.max()


@pytest.fixture(scope="module")
def ico3():
    V, F = icosphere(3)
    ok, Vc, Fc, IMF, IM, log = SSP_decimate(V, F, 320, 0)
    assert ok
    return V, F, Vc, Fc, log


@pytest.mark.parametrize("forward", [True, False], ids=["f2c", "c2f"])
def test_plain_walk_matches_jax_and_host(ico3, forward):
    V, F, Vc, Fc, log = ico3
    dlog = qd.device_log(log, "cpu")
    if forward:
        q, host, port, jax, Vout = (_rand_queries(F, 3000, seed=1), query_fine_to_coarse,
                                    qd.query_fine_to_coarse_device, jax_f2c, Vc)
    else:
        q, host, port, jax, Vout = (_corner_seeds(Vc.shape[0], Fc), query_coarse_to_fine,
                                    qd.query_coarse_to_fine_device, jax_c2f, V)
    calls = qd.query_walk_plain.calls
    got = port(dlog, *q)
    assert qd.query_walk_plain.calls == calls + 1
    assert got[0].dtype == np.float64 and got[1].dtype == got[2].dtype == np.int64
    p = _positions(got[0], got[1], Vout)
    _held(p, _positions(*host(log, *q)[:2], Vout))
    _held(p, _positions(*jax(pad_log(log), *q)[:2], Vout))


def test_plain_walk_f64_follows_host(ico3):
    """In float64 the plain version takes the host walk's faces and its
    barycentrics to rounding (the host contracts products into FMAs where
    the compiler chooses, so not bit for bit)."""
    V, F, Vc, Fc, log = ico3
    dlog = qd.device_log(log, "cpu", torch.float64)
    q = _rand_queries(F, 3000, seed=4)
    h = query_fine_to_coarse(log, *q)
    d = qd.query_fine_to_coarse_device(dlog, *q)
    assert np.array_equal(h[1], d[1]) and np.array_equal(h[2], d[2])
    assert np.abs(h[0] - d[0]).max() < 1e-12
    h2 = query_coarse_to_fine(log, *h)
    d2 = qd.query_coarse_to_fine_device(dlog, *d)
    assert np.array_equal(h2[2], d2[2])
    assert np.abs(_positions(*h2[:2], V) - _positions(*d2[:2], V)).max() < 1e-12


@pytest.mark.parametrize("dec_type,seed", [(0, None), (1, None), (2, None), (1, 7), (0, 3)])
def test_round_trip_f2c_c2f(dec_type, seed):
    """f2c then c2f returns to the start (tests/test_query_device.py:96-105)."""
    V, F = icosphere(3)
    ok, Vc, Fc, IMF, IM, log = SSP_decimate(V, F, 320, dec_type, seed=seed)
    assert ok
    dlog = qd.device_log(log, "cpu")
    bc, bf, fids = _rand_queries(F, 2000, seed=1)
    p0 = _positions(bc, bf, V)
    back = qd.query_coarse_to_fine_device(dlog, *qd.query_fine_to_coarse_device(dlog, bc, bf, fids))
    scale = np.linalg.norm(V.max(0) - V.min(0))
    err = np.linalg.norm(p0 - _positions(back[0], back[1], V), axis=1) / scale
    assert np.median(err) < 5e-3, np.median(err)
    assert (err < 5e-2).mean() > 0.99


def test_device_log_matches_pad_log(ico3):
    """device_log's CSR arrays, padded, are pad_log's non-pad entries."""
    _V, _F, _Vc, _Fc, log = ico3
    jl = pad_log(log)
    dl = qd.device_log(log, "cpu")
    assert dl.subset.dtype == torch.int32 and dl.uv_pre.dtype == torch.float32
    pad = (lambda off, flat, fill: qd._pad(off, flat, fill).numpy())
    assert np.array_equal(pad(dl.voff, dl.subset, -1), np.asarray(jl.subset))
    for k in ("uv_pre", "uv_post"):
        assert np.array_equal(pad(dl.voff, getattr(dl, k), 0.0), np.asarray(getattr(jl, k)))
    for side in ("pre", "post"):
        off = getattr(dl, f"foff_{side}")
        nf = np.asarray(getattr(jl, f"nf_{side}"))
        assert np.array_equal(np.diff(off.numpy()), nf)
        valid = np.arange(np.asarray(getattr(jl, f"fidx_{side}")).shape[1])[None] < nf[:, None]
        for k, fill in (("fuv", 0), ("fidx", -1)):
            mine = pad(off, getattr(dl, f"{k}_{side}"), fill)
            theirs = np.asarray(getattr(jl, f"{k}_{side}"))
            assert np.array_equal(mine[valid], theirs[valid])
    assert np.array_equal(pad(dl.dim_off, dl.dim_dat, -1), np.asarray(jl.dim))
    for mine, theirs in ((dl.im_fwd, jl.im_fwd), (dl.FIM, jl.fim), (dl.IM, jl.im),
                         (dl.IMF, jl.imf)):
        assert np.array_equal(mine.numpy(), np.asarray(theirs))


def test_device_log_refuses_ids_outside_int32(ico3):
    log = dict(ico3[4])
    log["dim_dat"] = log["dim_dat"] + 2**31
    with pytest.raises(ValueError, match="int32"):
        qd.device_log(log, "cpu")


def test_public_queries_refuse_ids_the_log_does_not_hold(ico3):
    """Ids index the log's tables on the card: out of range raises before
    any walk."""
    _V, F, _Vc, Fc, log = ico3
    dlog = qd.device_log(log, "cpu")
    bc, bf, fids = _rand_queries(F, 10, seed=6)
    with pytest.raises(ValueError, match="face ids"):
        qd.query_fine_to_coarse_device(dlog, bc, bf, fids + F.shape[0])
    cbc, cbf, cfi = _rand_queries(Fc, 10, seed=6)
    with pytest.raises(ValueError, match="vertex ids"):
        qd.query_coarse_to_fine_device(dlog, cbc, cbf - cbf.max() - 1, cfi)
    with pytest.raises(ValueError, match="face ids"):
        qd.query_coarse_to_fine_device(dlog, cbc, cbf, cfi + Fc.shape[0])
    with pytest.raises(ValueError, match="shapes"):
        qd.query_fine_to_coarse_device(dlog, bc[:, :2], bf, fids)


def test_device_log_default_device_is_the_card(ico3):
    """Without a card the default device raises: no fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        qd.device_log(ico3[4])


def test_query_walk_takes_the_plain_version_only_on_the_cpu(ico3):
    _V, F, _Vc, _Fc, log = ico3
    dlog = qd.device_log(log, "cpu")
    bc, bf, fids = _rand_queries(F, 100, seed=5)
    BC = torch.tensor(bc, dtype=torch.float32)
    BF = torch.tensor(bf, dtype=torch.int32)
    FI = torch.tensor(fids, dtype=torch.int32)
    launches, calls = qd.query_walk.launches, qd.query_walk_plain.calls
    stats = {}
    out = qd.query_walk_plain(dlog, True, BC.clone(), BF.clone(), FI.clone(), stats=stats)
    got = qd.query_walk(dlog, True, BC, BF, FI)
    assert got[0] is BC and got[1] is BF and got[2] is FI  # in place
    assert all(torch.equal(a, b) for a, b in zip(out, got))
    assert qd.query_walk.launches == launches
    assert qd.query_walk_plain.calls == calls + 2
    assert stats["steps"] > 0 and 0 < int(stats["records"].sum()) <= dlog.n_collapse
    with pytest.raises(TypeError, match="CUDA or CPU"):
        qd.query_walk(dlog, True, BC.to("meta"), BF.to("meta"), FI.to("meta"))


def _remesh(dec_type, seed, nsub, tarF=500):
    from surface_multigrid_code_torch.utils.obj_io import read_obj
    from surface_multigrid_code_torch.utils.paths import mesh_path
    from surface_multigrid_code_torch.utils.upsample import upsample_barycentric

    VO, FO = read_obj(mesh_path("bunny"))
    ok, V, F, IMF, IM, log = SSP_decimate(VO, FO, tarF, dec_type, seed=seed)
    assert ok
    BC, BF, FIdx, faces = upsample_barycentric(V, F, nsub)
    BC, BF, FIdx = query_coarse_to_fine(log, BC, BF, FIdx)
    return (BC[:, :, None] * VO[BF]).sum(axis=1), faces


@pytest.mark.parametrize("tag,dec_type,seed,nsub", [("ex08", 1, None, 2), ("ex09", 0, 10, 3)])
def test_remesh_through_the_port_matches_golden(tag, dec_type, seed, nsub):
    """Examples 08 / 09 through the port's host walk against data/golden,
    at tests/test_golden_remesh.py's tolerance."""
    from pathlib import Path

    from surface_multigrid_code_torch.utils.obj_io import read_obj

    golden = Path(__file__).resolve().parent.parent / "data" / "golden"
    SV, faces = _remesh(dec_type, seed, nsub)
    for it, Fk in enumerate(faces):
        Vg, Fg = read_obj(str(golden / f"{tag}_output_s{it}.obj"))
        Vr = SV[: Fk.max() + 1]
        assert Fg.shape == Fk.shape and np.array_equal(Fg, Fk)
        assert Vg.shape == Vr.shape
        assert np.allclose(Vr, Vg, atol=1e-5 * np.abs(Vg).max())


def test_jax_and_port_decimations_give_one_log():
    """Both packages' engines (the port's copy of ssp.cpp) write the same log."""
    V, F = icosphere(3)
    ok, *_rest, log = SSP_decimate(V, F, 320, 1)
    okj, *_restj, logj = jax_decimate(V, F, 320, 1)
    assert ok and okj and sorted(log) == sorted(logj)
    for k in log:
        assert np.array_equal(log[k], logj[k]), k


def _brute_tables(log, forward):
    """next_rec / next_lid of walk_tables by the host's own searches, one
    destination face row at a time (the dim_dat scan, np.searchsorted left)."""
    side = "post" if forward else "pre"
    voff, sub = log["voff"], log["subset"]
    foff, fuv, fidx = log[f"foff_{side}"], log[f"fuv_{side}"], log[f"fidx_{side}"]
    dim_off, dim_dat = log["dim_off"], log["dim_dat"]
    nxt = np.full(fidx.shape[0], -1, dtype=np.int64)
    lid = np.zeros((fidx.shape[0], 3), dtype=np.int64)
    for d in range(voff.shape[0] - 1):
        for i in range(foff[d], foff[d + 1]):
            row = dim_dat[dim_off[fidx[i]]:dim_off[fidx[i] + 1]]
            later = row[row > d] if forward else row[row < d][::-1]
            if later.size:
                nxt[i] = later[0]
                s = sub[voff[nxt[i]]:voff[nxt[i] + 1]]
                lid[i] = np.searchsorted(s, sub[voff[d] + fuv[i]], side="left")
    return nxt, lid


@pytest.mark.parametrize("forward", [True, False], ids=["f2c", "c2f"])
def test_walk_tables_match_brute_force(ico3, forward):
    log = ico3[4]
    nxt, lid = qd.walk_tables(qd.device_log(log, "cpu"), forward)
    want_nxt, want_lid = _brute_tables(log, forward)
    assert np.array_equal(nxt.numpy(), want_nxt)
    assert np.array_equal(lid.numpy(), want_lid)
    assert (want_nxt >= 0).any() and (want_nxt < 0).any()


def _unpack(walk, n_pairs_dtype, nv, nf):
    """Record d's block of a PackedWalk as numpy: (src [nv + 1, 2],
    dst [nv, 2], faces [nf, 4] int32)."""
    words = walk.pack.numpy()
    per = 16 // (2 * np.dtype(n_pairs_dtype).itemsize)
    nus, nud = (nv + per) // per, (nv + per - 1) // per
    raw = words.reshape(-1).view(np.uint8)

    def pairs(chunk, count):
        b = raw[16 * chunk: 16 * chunk + count * 2 * np.dtype(n_pairs_dtype).itemsize]
        return b.view(n_pairs_dtype).reshape(count, 2)

    def block(start):
        return pairs(start, nv + 1), pairs(start + nus, nv), words[start + nus + nud:][:nf]
    return block


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_packed_blocks_unpack_to_csr(ico3, dtype):
    log = ico3[4]
    dl = qd.device_log(log, "cpu", dtype)
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    voff = log["voff"]
    for forward in (True, False):
        side = "post" if forward else "pre"
        src, dst = (log["uv_pre"], log["uv_post"]) if forward else (log["uv_post"], log["uv_pre"])
        src = np.vstack([src, np.zeros((1, 2))]).astype(np_dt)
        dst = dst.astype(np_dt)
        foff, fuv = log[f"foff_{side}"], log[f"fuv_{side}"]
        walk = dl.packed(forward)
        rec = walk.rec.numpy()
        nxt, lid = (t.numpy() for t in qd.walk_tables(dl, forward))
        assert rec.dtype == np.int32 and walk.pack.dtype == torch.int32
        assert np.array_equal(rec[:, 2], voff[:-1]) and np.array_equal(rec[:, 3], foff[:-1])
        most = 0
        for d in range(voff.shape[0] - 1):
            nv, nf = voff[d + 1] - voff[d], foff[d + 1] - foff[d]
            assert rec[d, 1] == nv | (nf << 16)
            s, t, faces = _unpack(walk, np_dt, nv, nf)(rec[d, 0])
            assert np.array_equal(s, src[voff[d]:voff[d + 1] + 1])
            assert np.array_equal(t, dst[voff[d]:voff[d + 1]])
            b = faces[:, 2:].view(np.uint8).reshape(nf, 8).astype(np.int64)
            rows = slice(foff[d], foff[d + 1])
            assert np.array_equal(b[:, :3], fuv[rows]) and np.array_equal(b[:, 4:7], lid[rows])
            assert np.array_equal(faces[:, 0], nxt[rows])
            to = nxt[rows]
            has = to >= 0
            assert np.array_equal(faces[:, 1], np.where(has, rec[to, 0], -1))
            assert np.array_equal(b[:, 3], np.where(has, np.diff(voff)[to], 0))
            assert np.array_equal(b[:, 7], np.where(has, np.diff(foff)[to], 0))
            per = 16 // (2 * np.dtype(np_dt).itemsize)
            most = max(most, (nv + per - 1) // per + nf)
        assert walk.chunks == most
        assert walk.nbytes == 4 * (rec.size + walk.pack.numel())
    assert dl.pack_s > 0


def _no_win_log(log, r):
    """A copy of the log whose record r has NaN parameterisations: no face
    of r wins in either direction, so every walk through r stays put there."""
    out = dict(log)
    for k in ("uv_pre", "uv_post"):
        a = np.array(log[k], dtype=np.float64)
        a[log["voff"][r]:log["voff"][r + 1]] = np.nan
        out[k] = a
    return out


@pytest.mark.parametrize("forward", [True, False], ids=["f2c", "c2f"])
def test_no_win_step_follows_the_host_walk(ico3, forward):
    """Through a record where no face wins, the plain walk keeps the point
    and goes on from the same face as the host walk does: the host's
    records, its lower_bound where a carried corner is missing from the
    next record, at the file's bars (f32) and to rounding in f64."""
    V, F, Vc, Fc, log = ico3
    n = log["voff"].shape[0] - 1
    r = n - n // 5  # late, so that many queries pass it, with records after it
    nan = _no_win_log(log, r)
    if forward:
        bc, bf, fids = _rand_queries(F, 3000, seed=8)
    else:
        bc, bf, fids = _rand_queries(Fc, 3000, seed=8)
        bf, fids = log["IM"][bf], log["IMF"][fids]
    host = _native.query_walk(nan, forward, bc.copy(), bf.copy(), fids.copy())  # in place
    Vw = np.array(V, dtype=np.float64)  # working ids -> coarse positions where coarse
    Vw[log["IM"]] = Vc
    dest = (lambda a, b: _positions(a, b, Vw if forward else V))
    for dt in (torch.float32, torch.float64):
        args = (torch.tensor(bc, dtype=dt), torch.tensor(bf, dtype=torch.int32),
                torch.tensor(fids, dtype=torch.int32))
        clean = qd.query_walk_plain(qd.device_log(log, "cpu", dt), forward,
                                    *(t.clone() for t in args))
        got = qd.query_walk_plain(qd.device_log(nan, "cpu", dt), forward,
                                  *(t.clone() for t in args))
        assert np.isfinite(got[0].numpy()).all()
        p = dest(got[0].numpy(), got[1].numpy())
        _held(p, dest(*host[:2]))
        if dt == torch.float64:
            assert np.array_equal(got[1].numpy(), host[1]) and np.array_equal(got[2].numpy(), host[2])
            assert np.abs(p - dest(*host[:2])).max() < 1e-12
    hit = np.flatnonzero((got[2] != clean[2]).numpy() | (got[0] != clean[0]).any(1).numpy())
    assert hit.size >= 10
    stats = {}
    qd.query_walk_plain(qd.device_log(nan, "cpu"), forward,
                        *(t[hit].clone() for t in (args[0].float(), args[1], args[2])), stats=stats)
    seen = stats["records"].numpy()
    assert seen[r] and (seen[r + 1:] if forward else seen[:r]).any()  # on past r


def test_query_steps_count_each_query(ico3):
    _V, F, _Vc, _Fc, log = ico3
    dlog = qd.device_log(log, "cpu")
    bc, bf, fids = _rand_queries(F, 200, seed=9)
    stats = {}
    qd.query_walk_plain(dlog, True, torch.tensor(bc, dtype=torch.float32),
                        torch.tensor(bf, dtype=torch.int32), torch.tensor(fids, dtype=torch.int32),
                        stats=stats)
    steps = stats["query_steps"]
    assert steps.shape == (200,) and int(steps.sum()) == stats["steps"] and int(steps.min()) > 0


def _unpacked_entries_hold_no_block(dl, forward):
    """Records without a block have block -1; face entries leading to one
    hold next_rec, -1 and zero sizes and local ids; every other record's
    entries are as packed."""
    walk = dl.packed(forward)
    rec, words = walk.rec.numpy(), walk.pack.numpy()
    packed = rec[:, 0] >= 0
    nxt, _lid = (t.numpy() for t in qd.walk_tables(dl, forward))
    foff = (dl.foff_post if forward else dl.foff_pre).numpy()
    per = 16 // (2 * dl.uv_pre.element_size())
    nv, nf = rec[:, 1] & 0xFFFF, rec[:, 1] >> 16
    for d in np.flatnonzero(packed):
        at = rec[d, 0] + (nv[d] + per) // per + (nv[d] + per - 1) // per
        faces = words[at:at + nf[d]]
        to = nxt[foff[d]:foff[d + 1]]
        assert np.array_equal(faces[:, 0], to)
        into = (to >= 0) & ~packed[np.maximum(to, 0)]
        assert (faces[into, 1] == -1).all()
        b = faces[into, 2:].view(np.uint8).reshape(-1, 8)
        assert (b[:, 3] == 0).all() and (b[:, 4:] == 0).all()
    return np.flatnonzero(~packed)


def test_pack_walk_refuses_records_beyond_a_byte(ico3, monkeypatch):
    """Local ids, nv and nf are bytes in a face entry: a larger record is
    left unpacked (block -1) and the walk still follows the host's."""
    V, F, Vc, Fc, log = ico3
    monkeypatch.setattr(qd, "MAX_RECORD", 8)
    dl = qd.device_log(log, "cpu")
    nv = np.diff(log["voff"])
    for forward in (True, False):
        big = _unpacked_entries_hold_no_block(dl, forward)
        nf = np.diff(log["foff_post" if forward else "foff_pre"])
        assert np.array_equal(big, np.flatnonzero((nv > 8) | (nf > 8))) and big.size
    for forward, fn, host_fn, Ft in ((True, qd.query_fine_to_coarse_device,
                                      query_fine_to_coarse, F),
                                     (False, qd.query_coarse_to_fine_device,
                                      query_coarse_to_fine, Fc)):
        q = _rand_queries(Ft, 300, seed=11)
        got, host = fn(dl, *q), host_fn(log, *q)
        dest = Vc if forward else V
        _held(_positions(*got[:2], dest), _positions(*host[:2], dest))


@pytest.fixture(scope="module")
def drum_log():
    """The N = 300 drum, decimated with qslim to 600 faces: records of up
    to 303 vertices, more than a packed face entry's bytes hold."""
    V, F = drum(300)
    ok, Vc, Fc, _IMF, _IM, log = SSP_decimate(V, F, 600, 0)
    assert ok and int(np.diff(log["voff"]).max()) == 303
    return V, F, Vc, Fc, log


# In float32 the walk rounds its barycentrics on the drum's sliver fans
# (2 pi / 300 wide) and takes another face near a tie for a few queries:
# the port's ids agree with the host walk's on 99.95% (f2c) / 99.05% (c2f)
# of these 2,000 queries, the JAX package's float32 walk on 100% / 99.25%.
# Held: at least DRUM_F32_SAME of them on the same ids, and every position
# within DRUM_F32_POS (the drum's radius is 1). In float64 every id is the
# host walk's.
DRUM_F32_SAME = 0.98
DRUM_F32_POS = 1e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("forward", [True, False], ids=["f2c", "c2f"])
def test_drum_log_walks_like_the_host(drum_log, forward, dtype):
    """device_log takes a log whose records exceed a byte; its walk returns
    the host walk's vertex and face ids on 2,000 seeded queries."""
    V, F, Vc, Fc, log = drum_log
    dl = qd.device_log(log, "cpu", dtype)
    big = _unpacked_entries_hold_no_block(dl, forward)
    assert big.size and dl.packed(forward).chunks <= qd.MAX_CHUNKS
    fn = qd.query_fine_to_coarse_device if forward else qd.query_coarse_to_fine_device
    host_fn = query_fine_to_coarse if forward else query_coarse_to_fine
    q = _rand_queries(F if forward else Fc, 2000, seed=12)
    got, host = fn(dl, *q), host_fn(log, *q)
    same = (got[2] == host[2]) & (got[1] == host[1]).all(1)
    dest = Vc if forward else V
    err = np.linalg.norm(_positions(*got[:2], dest) - _positions(*host[:2], dest), axis=1)
    if dtype == torch.float64:
        assert same.all() and err.max() < 1e-9, (same.mean(), err.max())
    else:
        assert same.mean() >= DRUM_F32_SAME and err.max() < DRUM_F32_POS, (same.mean(), err.max())


def test_records_beyond_the_shared_memory_are_unpacked(ico3, monkeypatch):
    """A record of more chunks than 32 threads' slices stage is left
    unpacked, and the launch is sized from the packed ones."""
    log = ico3[4]
    monkeypatch.setattr(qd, "MAX_CHUNKS", 16)
    dl = qd.device_log(log, "cpu", torch.float64)
    nv = np.diff(log["voff"])
    for forward in (True, False):
        nf = np.diff(log["foff_post" if forward else "foff_pre"])
        big = _unpacked_entries_hold_no_block(dl, forward)
        assert np.array_equal(big, np.flatnonzero(nv + nf > 16)) and big.size
        assert dl.packed(forward).chunks == (nv + nf)[nv + nf <= 16].max()


def test_launch_shape_fits_the_shared_memory():
    assert qd.launch_shape(18) == (64, 64 * 18 * 16)
    threads, smem = qd.launch_shape(300)
    assert threads == 32 and smem == 32 * 300 * 16 <= qd.MAX_SHARED
    with pytest.raises(ValueError, match="shared memory"):
        qd.launch_shape(qd.MAX_SHARED // (32 * 16) + 1)


@pytest.mark.parametrize("forward", [True, False], ids=["f2c", "c2f"])
def test_public_call_parts(ico3, forward):
    """With ``parts`` a public call times each part and returns what it
    returns without."""
    _V, F, _Vc, Fc, log = ico3
    dlog = qd.device_log(log, "cpu")
    fn = qd.query_fine_to_coarse_device if forward else qd.query_coarse_to_fine_device
    q = _rand_queries(F if forward else Fc, 500, seed=10)
    parts = {}
    got = fn(dlog, *q, parts=parts)
    want = fn(dlog, *q)
    assert set(parts) == {"validation", "h2d", "walk", "id_maps", "d2h"}
    assert all(v >= 0 for v in parts.values())
    for a, b, dt in zip(got, want, (np.float64, np.int64, np.int64)):
        assert a.dtype == dt and np.array_equal(a, b)
