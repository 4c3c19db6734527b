"""Point queries through the SSP collapse log on the card (counterpart of ``surface_multigrid_code_tpu/query/device.py``).

The JAX package pads the log to fixed per-record sizes and advances every
query in lockstep under one ``lax.while_loop`` (``_query_device``), chunked
and sorted by walk start so that the TPU's lanes retire early. On the card
each query is one thread walking the log's CSR arrays as they are: the
hand-written kernel K5 (``csrc/query_walk.cu``), which follows the host
walk of the native engine (``native/ssp.cpp`` ``query_walk``) step for
step. Nothing is padded, sorted or chunked.

- ``DeviceCollapseLog``: the log's CSR arrays as tensors (int32 ids, the
  parameterisations in the walk's float type); ``device_log`` builds it.
- ``query_walk``: the walk in the working mesh's id space, in place. A
  CUDA tensor goes to K5, a CPU tensor to ``query_walk_plain``, the JAX
  loop written in PyTorch; there is no other route.
- ``query_fine_to_coarse_device`` / ``query_coarse_to_fine_device``: the
  contract of ``query/maps.py`` (numpy in; BC float64, BF / FIdx int64
  out), walking in the log's float type: float32 by default, as the JAX
  package walks.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from surface_multigrid_code_torch._build import load_library
from surface_multigrid_code_torch.ops.sparse import row_ids
from surface_multigrid_code_torch.utils.device import resolve_device

_I32 = np.iinfo(np.int32)


@dataclass
class DeviceCollapseLog:
    """The collapse log's CSR arrays on one device.

    Per record (collapse) r of n: ``subset[voff[r]:voff[r + 1]]`` its sorted
    global vertex ids and ``uv_pre`` / ``uv_post`` their parameterisations
    before and after the collapse; ``fuv_*[foff_*[r]:foff_*[r + 1]]`` its
    faces before / after in local ids, ``fidx_*`` their working-mesh face
    ids. Per working-mesh face f: ``dim_dat[dim_off[f]:dim_off[f + 1]]``
    the records touching it, ascending. ``im_fwd`` maps working vertex ids
    to coarse ones, ``FIM`` working faces to coarse faces, ``IM`` / ``IMF``
    coarse vertices / faces to working ids.
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

    @property
    def n_collapse(self) -> int:
        return self.voff.shape[0] - 1

    @property
    def device(self) -> torch.device:
        return self.voff.device

    @property
    def dtype(self) -> torch.dtype:
        return self.uv_pre.dtype

    def side(self, forward: bool):
        """(uv_src, uv_dst, foff, fuv, fidx) of one direction: forward walks
        uv_pre -> uv_post onto the post faces, backward the reverse."""
        if forward:
            return self.uv_pre, self.uv_post, self.foff_post, self.fuv_post, self.fidx_post
        return self.uv_post, self.uv_pre, self.foff_pre, self.fuv_pre, self.fidx_pre


def _ids(a, name: str) -> np.ndarray:
    a = np.asarray(a)
    if a.size and (int(a.min()) < _I32.min or int(a.max()) > _I32.max):
        raise ValueError(f"log array {name} holds ids outside int32")
    return np.ascontiguousarray(a, dtype=np.int32)


def device_log(log: dict, device="cuda", dtype: torch.dtype = torch.float32) -> DeviceCollapseLog:
    """The log dict of ``ssp.decimate.SSP_decimate`` (or ``load_log``) as a
    ``DeviceCollapseLog`` on ``device`` (the card unless the caller passes
    ``device="cpu"``), the parameterisations in ``dtype``."""
    device = resolve_device(device)
    IM = np.asarray(log["IM"])
    im_fwd = np.zeros(int(IM.max()) + 1, dtype=np.int64)
    im_fwd[IM] = np.arange(IM.shape[0])
    arrays = {"im_fwd": im_fwd}
    for f in fields(DeviceCollapseLog):
        if f.name in ("uv_pre", "uv_post"):
            arrays[f.name] = np.ascontiguousarray(log[f.name], dtype=np.float64)
        elif f.name != "im_fwd":
            arrays[f.name] = log[f.name]
    out = {}
    for name, a in arrays.items():
        t = torch.as_tensor(a if a.dtype == np.float64 else _ids(a, name))
        out[name] = t.to(device=device, dtype=dtype if t.is_floating_point() else torch.int32)
    return DeviceCollapseLog(**out)


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
    for f in fields(DeviceCollapseLog):
        t = getattr(dlog, f.name)
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"log array {f.name} must be contiguous on {dev}")
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
    uv_src, uv_dst, foff, fuv, fidx = dlog.side(forward)
    with torch.cuda.device(BC.device):
        err = fn(
            dlog.voff.data_ptr(), dlog.subset.data_ptr(), uv_src.data_ptr(), uv_dst.data_ptr(),
            foff.data_ptr(), fuv.data_ptr(), fidx.data_ptr(), dlog.dim_off.data_ptr(),
            dlog.dim_dat.data_ptr(), BC.data_ptr(), BF.data_ptr(), FIdx.data_ptr(),
            BC.shape[0], dlog.n_collapse, 1 if forward else 0,
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
    below 1.

    With ``stats`` (a dict) it records what the walk read: "steps" (the
    record visits of all queries), "tested" (the destination faces those
    visits tested), "records" (bool [n_collapse], the records visited) and
    "faces" (bool [nF_working], the faces whose dim_dat range was read)."""
    query_walk_plain.calls += 1
    dev, dt = BC.device, BC.dtype
    uv_src, uv_dst, foff, fuv, fidx = dlog.side(forward)
    subset = _pad(dlog.voff, dlog.subset.long(), -1)
    src = _pad(dlog.voff, uv_src.to(dt), 0.0)
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
        steps += live.numel()
        if stats is not None:
            tested += int(nf[r].sum())
        sub = subset[r]                                          # [m, maxV]
        lid = (sub[:, None, :] == bf[live][:, :, None]).to(torch.uint8).argmax(2)  # [m, 3]
        p = torch.take_along_dim(src[r], lid[:, :, None], 1)    # [m, 3, 2]
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
        stats.update(steps=steps, tested=tested, records=seen_rec, faces=seen_face)
    BC.copy_(bc)
    BF.copy_(bf)
    FIdx.copy_(f)
    return BC, BF, FIdx


query_walk_plain.calls = 0


def _queries(dlog: DeviceCollapseLog, BC, BF, FIdx, n_vertices: int, n_faces: int):
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
    dev = dlog.device
    return (torch.tensor(BC, dtype=dlog.dtype, device=dev),
            torch.tensor(BF, dtype=torch.int32, device=dev),
            torch.tensor(FIdx, dtype=torch.int32, device=dev))


def _out(BC, BF, FIdx):
    cpu = torch.device("cpu")
    return (BC.to(cpu, torch.float64).numpy(), BF.to(cpu, torch.int64).numpy(),
            FIdx.to(cpu, torch.int64).numpy())


def query_fine_to_coarse_device(dlog: DeviceCollapseLog, BC, BF, FIdx):
    """Fine -> coarse on the log's device; the contract of
    ``query.maps.query_fine_to_coarse``."""
    queries = _queries(dlog, BC, BF, FIdx, _I32.max, dlog.dim_off.shape[0] - 1)
    BC, BF, FIdx = query_walk(dlog, True, *queries)
    # working-mesh ids -> coarse ids (reference query_fine_to_coarse.cpp:132-151)
    return _out(BC, dlog.im_fwd[BF], dlog.FIM[FIdx])


def query_coarse_to_fine_device(dlog: DeviceCollapseLog, BC, BF, FIdx):
    """Coarse -> fine on the log's device; the contract of
    ``query.maps.query_coarse_to_fine``."""
    BC, BF, FIdx = _queries(dlog, BC, BF, FIdx, dlog.IM.shape[0], dlog.IMF.shape[0])
    # coarse ids -> working-mesh ids (reference query_coarse_to_fine.cpp:22-36)
    return _out(*query_walk(dlog, False, BC, dlog.IM[BF], dlog.IMF[FIdx]))
