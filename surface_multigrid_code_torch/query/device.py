"""Point queries through the SSP collapse log on the card (counterpart of ``surface_multigrid_code_tpu/query/device.py``).

The JAX package pads the log to fixed per-record sizes and advances every
query in lockstep under one ``lax.while_loop`` (``_query_device``), chunked
and sorted by walk start so that the TPU's lanes retire early. On the card
each query is one thread: the hand-written kernel K5
(``csrc/query_walk.cu``), which follows the host walk of the native engine
(``native/ssp.cpp`` ``query_walk``) step for step. Nothing is padded,
sorted or chunked; the log is laid out for the walk instead (``PackedWalk``).

- ``DeviceCollapseLog``: the log's CSR arrays as tensors (int32 ids, the
  parameterisations in the walk's float type) and, per direction, the
  packed record blocks K5 walks; ``device_log`` builds it.
- ``walk_tables`` / ``pack_walk``: where each destination face of a record
  leads (the next record and the corners' local ids there) and the blocks
  built from it, in plain PyTorch on the log's device.
- ``query_walk``: the walk in the working mesh's id space, in place. A
  CUDA tensor goes to K5, a CPU tensor to ``query_walk_plain``, the JAX
  loop written in PyTorch; there is no other route.
- ``query_fine_to_coarse_device`` / ``query_coarse_to_fine_device``: the
  contract of ``query/maps.py`` (numpy in; BC float64, BF / FIdx int64
  out), walking in the log's float type: float32 by default, as the JAX
  package walks.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from surface_multigrid_code_torch._build import load_library
from surface_multigrid_code_torch.ops.sparse import row_ids
from surface_multigrid_code_torch.utils.device import resolve_device

_I32 = np.iinfo(np.int32)
# The CSR arrays of the log dict that DeviceCollapseLog holds.
_CSR = ("voff", "subset", "uv_pre", "uv_post", "foff_pre", "fuv_pre", "fidx_pre",
        "foff_post", "fuv_post", "fidx_post", "dim_off", "dim_dat")
# K5's block: at most this many threads, and the shared memory one may use.
MAX_THREADS = 64
MAX_SHARED = 227 * 1024
# Local ids, nv and nf are bytes in a packed face entry; a larger record is
# not packed. Nor is one of more chunks than a warp's slices can stage.
MAX_RECORD = 255
MAX_CHUNKS = MAX_SHARED // (32 * 16)


@dataclass
class PackedWalk:
    """One direction of the log as K5 walks it.

    ``pack`` ([chunks, 4] int32, 16-byte chunks): per record d one block at
    chunk ``rec[d, 0]``: its source parameterisation (nv (u, v) pairs and
    the CSR pair after them, which the walk reads where a corner is not in
    the subset; (0, 0) after the last record), then its destination
    parameterisation (nv pairs), each padded to whole chunks, then one
    chunk per destination face k: {next_rec, the block of next_rec, fuv[k]
    as three bytes | next nv << 24, next_lid as three bytes | next nf <<
    24} (``walk_tables``; -1 and zeros where the walk ends). The floats are
    stored as their bits. ``rec`` ([n, 4] int32): {block, nv | nf << 16,
    voff[d], foff[d]} of the direction. A record of more than
    ``MAX_RECORD`` vertices or destination faces, or of more than
    ``MAX_CHUNKS`` chunks to stage, has no block: its block is -1, and a
    face entry leading to it holds next_rec, -1 and zeros (K5 walks it
    through the CSR arrays). ``chunks``: the largest packed record's
    destination parameterisation and face chunks, what a thread stages in
    shared memory."""

    rec: torch.Tensor
    pack: torch.Tensor
    chunks: int

    @property
    def nbytes(self) -> int:
        return self.rec.numel() * 4 + self.pack.numel() * 4


@dataclass
class DeviceCollapseLog:
    """The collapse log's CSR arrays on one device, and the packed blocks
    of both directions.

    Per record (collapse) r of n: ``subset[voff[r]:voff[r + 1]]`` its sorted
    global vertex ids and ``uv_pre`` / ``uv_post`` their parameterisations
    before and after the collapse; ``fuv_*[foff_*[r]:foff_*[r + 1]]`` its
    faces before / after in local ids, ``fidx_*`` their working-mesh face
    ids. Per working-mesh face f: ``dim_dat[dim_off[f]:dim_off[f + 1]]``
    the records touching it, ascending. ``im_fwd`` maps working vertex ids
    to coarse ones, ``FIM`` working faces to coarse faces, ``IM`` / ``IMF``
    coarse vertices / faces to working ids. ``fwd`` / ``bwd``: the
    ``PackedWalk`` of each direction; ``pack_s``: the seconds their build
    took (set-up).
    """

    voff: torch.Tensor
    subset: torch.Tensor
    uv_pre: torch.Tensor
    uv_post: torch.Tensor
    foff_pre: torch.Tensor
    fuv_pre: torch.Tensor
    fidx_pre: torch.Tensor
    foff_post: torch.Tensor
    fuv_post: torch.Tensor
    fidx_post: torch.Tensor
    dim_off: torch.Tensor
    dim_dat: torch.Tensor
    im_fwd: torch.Tensor
    FIM: torch.Tensor
    IM: torch.Tensor
    IMF: torch.Tensor
    fwd: PackedWalk | None = None
    bwd: PackedWalk | None = None
    pack_s: float = 0.0

    @property
    def n_collapse(self) -> int:
        return self.voff.shape[0] - 1

    @property
    def device(self) -> torch.device:
        return self.voff.device

    @property
    def dtype(self) -> torch.dtype:
        return self.uv_pre.dtype

    def tensors(self) -> dict:
        """Every tensor of the log by name (the packed ones as fwd_rec etc.)."""
        out = {name: getattr(self, name) for name in (*_CSR, "im_fwd", "FIM", "IM", "IMF")}
        for side in ("fwd", "bwd"):
            walk = getattr(self, side)
            if walk is not None:
                out.update({f"{side}_rec": walk.rec, f"{side}_pack": walk.pack})
        return out

    def side(self, forward: bool):
        """(uv_src, uv_dst, foff, fuv, fidx) of one direction: forward walks
        uv_pre -> uv_post onto the post faces, backward the reverse."""
        if forward:
            return self.uv_pre, self.uv_post, self.foff_post, self.fuv_post, self.fidx_post
        return self.uv_post, self.uv_pre, self.foff_pre, self.fuv_pre, self.fidx_pre

    def packed(self, forward: bool) -> PackedWalk:
        return self.fwd if forward else self.bwd


def _ids(a, name: str) -> np.ndarray:
    a = np.asarray(a)
    if a.size and (int(a.min()) < _I32.min or int(a.max()) > _I32.max):
        raise ValueError(f"log array {name} holds ids outside int32")
    return np.ascontiguousarray(a, dtype=np.int32)


def device_log(log: dict, device="cuda", dtype: torch.dtype = torch.float32) -> DeviceCollapseLog:
    """The log dict of ``ssp.decimate.SSP_decimate`` (or ``load_log``) as a
    ``DeviceCollapseLog`` on ``device`` (the card unless the caller passes
    ``device="cpu"``), the parameterisations in ``dtype``, with both
    directions packed for K5 on that device (timed into ``pack_s``)."""
    device = resolve_device(device)
    IM = np.asarray(log["IM"])
    im_fwd = np.zeros(int(IM.max()) + 1, dtype=np.int64)
    im_fwd[IM] = np.arange(IM.shape[0])
    arrays = {name: log[name] for name in (*_CSR, "FIM", "IM", "IMF")}
    arrays["im_fwd"] = im_fwd
    for name in ("uv_pre", "uv_post"):
        arrays[name] = np.ascontiguousarray(log[name], dtype=np.float64)
    out = {}
    for name, a in arrays.items():
        t = torch.as_tensor(a if a.dtype == np.float64 else _ids(a, name))
        out[name] = t.to(device=device, dtype=dtype if t.is_floating_point() else torch.int32)
    dlog = DeviceCollapseLog(**out)
    _sync(device)
    t0 = time.perf_counter()
    dlog.fwd = pack_walk(dlog, True)
    dlog.bwd = pack_walk(dlog, False)
    _sync(device)
    dlog.pack_s = time.perf_counter() - t0
    return dlog


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def walk_tables(dlog: DeviceCollapseLog, forward: bool):
    """Where each destination face of one direction leads, on the log's
    device. Row i = foff[d] + k of the direction (record d, its face k):

    - ``next_rec[i]``: the record the host walk visits next from face
      ``fidx[i]`` after d: forward the smallest entry > d of its dim_dat
      range, backward the largest < d; -1 if there is none;
    - ``next_lid[i, c]``: lower_bound(subset of next_rec[i],
      subset[voff[d] + fuv[i, c]]), the local id there of the corner the
      query carries (0 where next_rec is -1).

    Both are segmented searches: one ``searchsorted`` over keys (segment,
    value) that sort the CSR rows end to end. Returns (next_rec,
    next_lid) as int64."""
    _, _, foff, fuv, fidx = dlog.side(forward)
    n, m = dlog.n_collapse, fuv.shape[0]
    d = row_ids(foff, m)
    g = fidx.long()
    dim_off, dim_dat = dlog.dim_off.long(), dlog.dim_dat.long()
    keys = row_ids(dlog.dim_off, dim_dat.shape[0]) * (n + 1) + dim_dat
    q = g * (n + 1) + d
    if forward:
        p = torch.searchsorted(keys, q, right=True)
        ok = p < dim_off[g + 1]
    else:
        p = torch.searchsorted(keys, q) - 1
        ok = p >= dim_off[g]
    nxt = torch.where(ok, dim_dat[p.clamp(0, max(dim_dat.shape[0] - 1, 0))], -1)

    voff, subset = dlog.voff.long(), dlog.subset.long()
    width = int(subset.max()) + 1 if subset.numel() else 1
    skeys = row_ids(dlog.voff, subset.shape[0]) * width + subset
    carried = subset[voff[d][:, None] + fuv.long()]
    to = nxt.clamp_min(0)
    lid = torch.searchsorted(skeys, (to * width)[:, None] + carried) - voff[to][:, None]
    return nxt, torch.where(nxt[:, None] >= 0, lid, 0)


def _bytes4(b0, b1, b2, b3) -> torch.Tensor:
    """Four bytes (int64 tensors, each < 256) as one int32 word, b0 lowest."""
    w = b0 | (b1 << 8) | (b2 << 16) | (b3 << 24)
    return (w - ((w >> 31) << 32)).to(torch.int32)


def pack_walk(dlog: DeviceCollapseLog, forward: bool) -> PackedWalk:
    """The ``PackedWalk`` of one direction, built with plain PyTorch on the
    log's device. Records of more than ``MAX_RECORD`` vertices or
    destination faces (a packed face entry keeps them in bytes) or of more
    than ``MAX_CHUNKS`` chunks to stage are left unpacked."""
    uv_src, uv_dst, foff, fuv, fidx = dlog.side(forward)
    dev, n = dlog.device, dlog.n_collapse
    voff, foff = dlog.voff.long(), foff.long()
    nv, nf = voff[1:] - voff[:-1], foff[1:] - foff[:-1]
    if n and int(torch.maximum(nv.max(), nf.max())) > 0xFFFF:
        raise ValueError("rec keeps a record's vertex and face counts in 16 bits each")
    per = 16 // (2 * uv_src.element_size())             # (u, v) pairs per chunk
    nus, nud = (nv + per) // per, (nv + per - 1) // per  # chunks of nv + 1 and nv pairs
    fits = (nv <= MAX_RECORD) & (nf <= MAX_RECORD) & (nud + nf <= MAX_CHUNKS)
    size = torch.where(fits, nus + nud + nf, 0)
    blk = torch.where(fits, torch.cumsum(size, 0) - size, -1)
    total = int(size.sum()) if n else 0
    if total > _I32.max:
        raise ValueError("the packed walk indexes its chunks with int32")
    words = torch.zeros((total, 4), dtype=torch.int32, device=dev)
    flat = words.view(-1)

    nvert = dlog.subset.shape[0]
    w = 2 * uv_src.element_size() // 4                   # 32-bit words per pair
    r = row_ids(dlog.voff, nvert)
    v = fits[r]                                          # vertices of packed records
    r = r[v]
    at = 4 * blk[r] + w * (torch.arange(nvert, device=dev)[v] - voff[r])
    cols = torch.arange(w, device=dev)
    bits = (lambda uv: uv.contiguous().view(torch.int32).reshape(-1, w))
    src = torch.cat([uv_src, uv_src.new_zeros((1, 2))])
    flat[at[:, None] + cols] = bits(uv_src[v])
    flat[(4 * blk + w * nv)[fits][:, None] + cols] = bits(src[voff[1:][fits]])
    flat[(at + 4 * nus[r])[:, None] + cols] = bits(uv_dst[v])

    nxt, lid = walk_tables(dlog, forward)
    r = row_ids(foff, fuv.shape[0])
    e = fits[r]                                          # face entries of packed records
    r, nxt, lid, tri = r[e], nxt[e], lid[e], fuv.long()[e]
    row = blk[r] + nus[r] + nud[r] + torch.arange(fuv.shape[0], device=dev)[e] - foff[r]
    to = nxt.clamp_min(0)
    has = (nxt >= 0) & fits[to]                          # leads to a packed record
    zero = torch.zeros_like(nxt)
    words[row, 0] = nxt.to(torch.int32)
    words[row, 1] = torch.where(has, blk[to], -1).to(torch.int32)
    words[row, 2] = _bytes4(tri[:, 0], tri[:, 1], tri[:, 2], torch.where(has, nv[to], zero))
    lid = torch.where(has[:, None], lid, 0)
    words[row, 3] = _bytes4(lid[:, 0], lid[:, 1], lid[:, 2], torch.where(has, nf[to], zero))
    rec = torch.stack([blk, nv | (nf << 16), voff[:-1], foff[:-1]], 1).to(torch.int32)
    chunks = int((nud + nf)[fits].max()) if bool(fits.any()) else 0
    return PackedWalk(rec.contiguous(), words, chunks)


def launch_shape(chunks: int) -> tuple[int, int]:
    """(threads a block, dynamic shared bytes a block) of a K5 launch whose
    threads each stage ``chunks`` 16-byte chunks: ``MAX_THREADS``, halved
    while the block's slices exceed ``MAX_SHARED`` (down to one warp)."""
    threads = MAX_THREADS
    while threads > 32 and threads * chunks * 16 > MAX_SHARED:
        threads //= 2
    if threads * chunks * 16 > MAX_SHARED:
        raise ValueError(f"a record of {chunks} chunks does not fit K5's shared memory")
    return threads, threads * max(chunks, 1) * 16


def _check(dlog: DeviceCollapseLog, BC, BF, FIdx) -> None:
    """Raise on anything K5 does not take."""
    dev, dt = dlog.device, dlog.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"the walk runs in float32 or float64, not {dt}")
    n = BC.shape[0] if BC.ndim == 2 else -1
    for name, t, shape, want in (("BC", BC, (n, 3), dt), ("BF", BF, (n, 3), torch.int32),
                                 ("FIdx", FIdx, (n,), torch.int32)):
        if t.device != dev or t.dtype != want:
            raise TypeError(f"{name} is {t.dtype} on {t.device}; the walk takes {want} on {dev}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous tensor of shape {shape}")
    if dlog.fwd is None or dlog.bwd is None:
        raise ValueError("the log has no packed walk: build it with device_log")
    for name, t in dlog.tensors().items():
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"log array {name} must be contiguous on {dev}")
    if max(BC.numel(), dlog.uv_pre.numel(), dlog.dim_dat.numel()) > _I32.max:
        raise ValueError("K5 indexes its arrays with int32")


def query_walk(dlog: DeviceCollapseLog, forward: bool, BC: torch.Tensor, BF: torch.Tensor,
               FIdx: torch.Tensor):
    """Walk the queries (BC [n, 3] in the log's float type, BF [n, 3] and
    FIdx [n] int32, working-mesh ids) through the log, in place: forward
    (fine -> coarse) in increasing record order, backward in decreasing.
    Returns (BC, BF, FIdx).

    Each K5 launch adds one to ``query_walk.launches``."""
    if BC.device.type == "cpu":
        return query_walk_plain(dlog, forward, BC, BF, FIdx)
    if BC.device.type != "cuda":
        raise TypeError(f"query_walk runs on CUDA or CPU tensors, not {BC.device}")
    _check(dlog, BC, BF, FIdx)
    if BC.shape[0] == 0:
        return BC, BF, FIdx
    lib = load_library()
    fn = lib.smg_query_walk_f32 if BC.dtype == torch.float32 else lib.smg_query_walk_f64
    walk = dlog.packed(forward)
    uv_src, uv_dst, _, fuv, fidx = dlog.side(forward)
    threads, smem = launch_shape(walk.chunks)
    with torch.cuda.device(BC.device):
        err = fn(
            dlog.subset.data_ptr(), fidx.data_ptr(), dlog.dim_off.data_ptr(),
            dlog.dim_dat.data_ptr(), walk.rec.data_ptr(), walk.pack.data_ptr(),
            uv_src.data_ptr(), uv_dst.data_ptr(), fuv.data_ptr(),
            BC.data_ptr(), BF.data_ptr(), FIdx.data_ptr(), BC.shape[0], dlog.n_collapse,
            dlog.subset.shape[0], 1 if forward else 0, threads, smem,
            torch.cuda.current_stream().cuda_stream,
        )
    query_walk.launches += 1
    if err != 0:
        raise RuntimeError(f"query_walk launch failed: cudaError {err}")
    return BC, BF, FIdx


query_walk.launches = 0


def _pad(off: torch.Tensor, flat: torch.Tensor, fill):
    """CSR rows ``flat[off[r]:off[r + 1]]`` as a [rows, longest, ...] table
    padded with ``fill``."""
    n = off.shape[0] - 1
    counts = (off[1:] - off[:-1]).long()
    width = max(int(counts.max()) if n else 0, 1)
    rows = row_ids(off, flat.shape[0])
    cols = torch.arange(flat.shape[0], device=flat.device) - off.long()[rows]
    out = torch.full((n, width, *flat.shape[1:]), fill, dtype=flat.dtype, device=flat.device)
    out[rows, cols] = flat
    return out


def query_walk_plain(dlog: DeviceCollapseLog, forward: bool, BC, BF, FIdx, stats=None):
    """Plain PyTorch version of ``query_walk`` (same arguments and result):
    the JAX package's loop. The log is padded from its CSR arrays; every
    step gathers one record per walking query, with masked updates, until
    no query finds a next record. Ties and NaN follow the host rule: the
    first of equal minima wins, a NaN minimum never does (it is masked to
    +inf before the argmin), and nothing moves unless the best minimum is
    below 1. A corner's local id is the host's lower_bound (the JAX loop
    takes the position of an equal entry, 0 if there is none: the same
    wherever the corner is in the record, which after a no-win it may not
    be).

    With ``stats`` (a dict) it records what the walk read: "steps" (the
    record visits of all queries), "tested" (the destination faces those
    visits tested), "records" (bool [n_collapse], the records visited),
    "faces" (bool [nF_working], the faces whose dim_dat range was read) and
    "query_steps" (int64 [n], the record visits of each query)."""
    query_walk_plain.calls += 1
    dev, dt = BC.device, BC.dtype
    uv_src, uv_dst, foff, fuv, fidx = dlog.side(forward)
    subset = _pad(dlog.voff, dlog.subset.long(), -1)
    voff = dlog.voff.long()
    src = torch.cat([uv_src.to(dt), uv_src.new_zeros((1, 2), dtype=dt)])  # (0, 0) past the end
    dst = _pad(dlog.voff, uv_dst.to(dt), 0.0)
    tri = _pad(foff, fuv.long(), 0)
    fid = _pad(foff, fidx.long(), -1)
    nf = (foff[1:] - foff[:-1]).long()
    dim = _pad(dlog.dim_off, dlog.dim_dat.long(), -1)
    big = torch.iinfo(torch.int64).max

    bc, bf, f = BC.clone(), BF.long(), FIdx.long()
    d = torch.full((BC.shape[0],), -1 if forward else dlog.n_collapse, dtype=torch.long,
                   device=dev)
    live = torch.arange(BC.shape[0], device=dev)
    seen_rec = torch.zeros(dlog.n_collapse, dtype=torch.bool, device=dev)
    seen_face = torch.zeros(dlog.dim_off.shape[0] - 1, dtype=torch.bool, device=dev)
    per_query = torch.zeros(BC.shape[0], dtype=torch.long, device=dev)
    steps = tested = 0
    while live.numel():
        seen_face[f[live]] = True
        row = dim[f[live]]
        dl = d[live][:, None]
        if forward:
            nxt = torch.where((row > dl) & (row >= 0), row, big).min(1).values
            nxt = torch.where(nxt == big, -1, nxt)
        else:
            nxt = torch.where((row < dl) & (row >= 0), row, -1).max(1).values
        go = nxt >= 0
        live, r = live[go], nxt[go]
        if not live.numel():
            break
        d[live] = r
        seen_rec[r] = True
        per_query[live] += 1
        steps += live.numel()
        if stats is not None:
            tested += int(nf[r].sum())
        sub = subset[r]                                          # [m, maxV]
        # lower_bound of each corner in the record's subset, as the host
        # searches; where a corner is not there (after a no-win) the host
        # reads the CSR entry at that position, past the record at nv
        below = (sub[:, None, :] < bf[live][:, :, None]) & (sub[:, None, :] >= 0)
        p = src[voff[r][:, None] + below.sum(2)]                 # [m, 3, 2]
        b = bc[live]
        q = b[:, 0:1] * p[:, 0] + b[:, 1:2] * p[:, 1] + b[:, 2:3] * p[:, 2]  # [m, 2]
        t = tri[r]                                               # [m, maxF, 3]
        uvd = dst[r]

        def corner(k):
            c = torch.take_along_dim(uvd, t[:, :, k, None], 1)   # [m, maxF, 2]
            return c[..., 0], c[..., 1]

        (ax, ay), (bx, by), (cx, cy) = corner(0), corner(1), corner(2)
        v0x, v0y = bx - ax, by - ay
        v1x, v1y = cx - ax, cy - ay
        v2x, v2y = q[:, 0:1] - ax, q[:, 1:2] - ay
        d00 = v0x * v0x + v0y * v0y
        d01 = v0x * v1x + v0y * v1y
        d11 = v1x * v1x + v1y * v1y
        d20 = v2x * v0x + v2y * v0y
        d21 = v2x * v1x + v2y * v1y
        den = d00 * d11 - d01 * d01
        v = (d11 * d20 - d01 * d21) / den
        w = (d00 * d21 - d01 * d20) / den
        u = 1.0 - v - w
        B = torch.stack([u, v, w], 2)                           # [m, maxF, 3]
        mind = -B.min(2).values
        valid = torch.arange(mind.shape[1], device=dev)[None, :] < nf[r][:, None]
        mind = torch.where(valid & ~torch.isnan(mind), mind, torch.inf)
        best = mind.argmin(1)
        commit = mind.gather(1, best[:, None])[:, 0] < 1.0
        ar = torch.arange(best.shape[0], device=dev)
        Bb = B[ar, best].clamp_min(0.0)
        s = Bb[:, 0] + Bb[:, 1] + Bb[:, 2]
        idx = live[commit]
        bc[idx] = (Bb / s[:, None])[commit]
        bf[idx] = sub.gather(1, t[ar, best])[commit]
        f[idx] = fid[r][ar, best][commit]
    if stats is not None:
        stats.update(steps=steps, tested=tested, records=seen_rec, faces=seen_face,
                     query_steps=per_query)
    BC.copy_(bc)
    BF.copy_(bf)
    FIdx.copy_(f)
    return BC, BF, FIdx


query_walk_plain.calls = 0


class _Parts:
    """Seconds by part of a public query call, added into ``parts`` (a
    dict) with the device synchronised at each mark; does nothing when
    ``parts`` is None."""

    def __init__(self, parts, device):
        self.parts, self.device = parts, device
        self.t = time.perf_counter()

    def mark(self, name: str) -> None:
        if self.parts is None:
            return
        _sync(self.device)
        now = time.perf_counter()
        self.parts[name] = self.parts.get(name, 0.0) + now - self.t
        self.t = now


def _queries(dlog: DeviceCollapseLog, BC, BF, FIdx, n_vertices: int, n_faces: int, clock):
    """The caller's arrays as new tensors on the log's device (the walk is
    in place): BC in the log's float type, ids int32. The ids index tables
    on the card, so they are checked against ``n_vertices`` / ``n_faces``."""
    BC, BF, FIdx = np.asarray(BC), np.asarray(BF), np.asarray(FIdx)
    if BC.ndim != 2 or BC.shape[1] != 3 or BF.shape != BC.shape or FIdx.shape != BC.shape[:1]:
        raise ValueError(f"queries of shapes BC {BC.shape}, BF {BF.shape}, FIdx {FIdx.shape}; "
                         "expected (n, 3), (n, 3), (n,)")
    if FIdx.size and (int(FIdx.min()) < 0 or int(FIdx.max()) >= n_faces):
        raise ValueError(f"FIdx holds face ids outside [0, {n_faces})")
    if BF.size and (int(BF.min()) < 0 or int(BF.max()) >= n_vertices):
        raise ValueError(f"BF holds vertex ids outside [0, {n_vertices})")
    clock.mark("validation")
    dev = dlog.device
    out = (torch.tensor(BC, dtype=dlog.dtype, device=dev),
           torch.tensor(BF, dtype=torch.int32, device=dev),
           torch.tensor(FIdx, dtype=torch.int32, device=dev))
    clock.mark("h2d")
    return out


def _out(BC, BF, FIdx, clock):
    """The results in the contract's types, widened on the card and sent
    across wide: at 1M queries widening on the host with numpy took 4x
    the PCIe time the narrow types save (``PERF.md``)."""
    cpu = torch.device("cpu")
    out = (BC.to(cpu, torch.float64).numpy(), BF.to(cpu, torch.int64).numpy(),
           FIdx.to(cpu, torch.int64).numpy())
    clock.mark("d2h")
    return out


def query_fine_to_coarse_device(dlog: DeviceCollapseLog, BC, BF, FIdx, parts=None):
    """Fine -> coarse on the log's device; the contract of
    ``query.maps.query_fine_to_coarse``. With ``parts`` (a dict) it adds
    the seconds of each part ("validation", "h2d", "walk", "id_maps",
    "d2h": widening included), synchronising the device between them."""
    clock = _Parts(parts, dlog.device)
    queries = _queries(dlog, BC, BF, FIdx, _I32.max, dlog.dim_off.shape[0] - 1, clock)
    BC, BF, FIdx = query_walk(dlog, True, *queries)
    clock.mark("walk")
    # working-mesh ids -> coarse ids (reference query_fine_to_coarse.cpp:132-151)
    BF, FIdx = dlog.im_fwd[BF], dlog.FIM[FIdx]
    clock.mark("id_maps")
    return _out(BC, BF, FIdx, clock)


def query_coarse_to_fine_device(dlog: DeviceCollapseLog, BC, BF, FIdx, parts=None):
    """Coarse -> fine on the log's device; the contract of
    ``query.maps.query_coarse_to_fine`` (``parts`` as in
    ``query_fine_to_coarse_device``)."""
    clock = _Parts(parts, dlog.device)
    BC, BF, FIdx = _queries(dlog, BC, BF, FIdx, dlog.IM.shape[0], dlog.IMF.shape[0], clock)
    # coarse ids -> working-mesh ids (reference query_coarse_to_fine.cpp:22-36)
    BF, FIdx = dlog.IM[BF], dlog.IMF[FIdx]
    clock.mark("id_maps")
    BC, BF, FIdx = query_walk(dlog, False, BC, BF, FIdx)
    clock.mark("walk")
    return _out(BC, BF, FIdx, clock)
