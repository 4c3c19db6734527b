"""The process group of the row-partitioned hierarchy and its collectives.

The sharded paths run SPMD in the torchrun idiom: every rank is one
process that has joined a ``torch.distributed`` process group, constructs
the same object from the same host matrices and keeps its own rows. The
collectives they use (counterparts of the ``jax.lax`` ones inside the JAX
package's ``shard_map`` bodies, ``parallel/halo.py:426-500``):

- ``Comm.exchange(x_local, send)``: the halo exchange. Each rank
  publishes ``x_local[send]`` (``index_select``), one ``all_gather``
  brings every rank's publish buffer, and the result is
  ``[x_local; published]``: the rank's local address space.
- ``Comm.gather_rows(x_local)``: every rank's rows, concatenated: the
  coarse right-hand side of the replicated dense solve, and the solution
  at the end of a solve.
- ``Comm.allreduce_sum(t)``: residual norms and the column-partitioned
  restriction's partial products.
- ``Comm.broadcast(t)``: rank 0's value on every rank, where host code
  takes a decision that must agree across ranks (the balloon's line search).
- ``Comm.shift(x_local, lo, hi)``: the band-segment halo exchange of
  ``parallel/wellhalo.py`` (the two ``ppermute`` of the JAX
  ``wellhalo._exchange_seg``, ``wellhalo.py:132-149``): each rank sends the
  last ``lo`` rows of its block to the next rank and the first ``hi`` rows
  to the previous one, in one ``batch_isend_irecv``, and gets
  ``[lo rows of the previous rank; x_local; hi rows of the next rank]``,
  zeros where the first or last rank has no neighbour.

``Comm.counts`` counts the calls of each collective (a V-cycle's
collectives are read from it).

The backend is the caller's choice: ``nccl`` with one rank per card, or
``gloo`` on the CPU and for ranks that share one card. gloo takes CUDA
tensors for ``all_gather``, ``all_reduce`` and ``broadcast`` and stages
them through host memory itself. Its point-to-point operations do not:
they are documented for CPU tensors only, and given a CUDA tensor a rank
aborts (gloo::IoException, "Bad address": ``chip_smoke.py --gloo-p2p``
on the H100 machine). So under gloo ``shift`` copies the segments it
sends to host memory and what it receives back to the card; under nccl
it sends device memory. That route is chosen by the backend.

``spawn_ranks`` starts D rank processes (``torch.multiprocessing`` with
``spawn``: CUDA cannot be initialised in a forked child) that join one
group through a ``file://`` rendezvous, so concurrent runs never contend
for a TCP port. ``RankPool`` keeps D ranks alive and runs one task after
another on the first d of them, so a caller pays process start-up once.
"""

from __future__ import annotations

import collections
import datetime
import os
import pickle
import queue
import tempfile
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from surface_multigrid_code_torch.utils.device import resolve_device

# A rank that fails while the others wait in a collective would leave them
# waiting for gloo's default of 30 minutes; they give up after this.
COLLECTIVE_TIMEOUT_S = 300
# The thread pools a rank's libraries start with; each is given its share
# of the host's cores, or D ranks each spinning a thread per core (numpy's
# BLAS in the dense coarse inverse, torch's own) run many times slower.
_THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


class Comm:
    """One rank's view of a process group (``None``: the default group)."""

    def __init__(self, group=None):
        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialised: call "
                               "init_process_group (or run under spawn_ranks) first")
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.backend = str(dist.get_backend(group))
        self.counts = collections.Counter()

    def exchange(self, x_local: torch.Tensor, send: torch.Tensor) -> torch.Tensor:
        """``[x_local; all ranks' x_local[send]]`` (rows; any trailing columns)."""
        self.counts["exchange"] += 1
        pub = x_local.index_select(0, send)
        parts = [torch.empty_like(pub) for _ in range(self.size)]
        dist.all_gather(parts, pub, group=self.group)
        return torch.cat([x_local, *parts])

    def gather_rows(self, x_local: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x_local`` (each of the same shape), in rank order."""
        self.counts["gather_rows"] += 1
        parts = [torch.empty_like(x_local) for _ in range(self.size)]
        dist.all_gather(parts, x_local.contiguous(), group=self.group)
        return torch.cat(parts)

    def allreduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks, in place; returns ``t``."""
        self.counts["allreduce_sum"] += 1
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``t`` on every rank, in place; returns ``t``."""
        self.counts["broadcast"] += 1
        dist.broadcast(t, src=dist.get_global_rank(self.group, 0) if self.group else 0,
                       group=self.group)
        return t

    def shift(self, x_local: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
        """``[lo rows from rank - 1; x_local; hi rows from rank + 1]``: this
        rank sends its last ``lo`` rows to rank + 1 and its first ``hi`` rows
        to rank - 1 (rows; any trailing columns). The first rank gets zeros
        for the rows below, the last for those above. Every rank passes the
        same lo and hi, each at most its own row count."""
        self.counts["shift"] += 1
        r, D, n = self.rank, self.size, x_local.shape[0]
        stage = self.backend == "gloo" and x_local.device.type != "cpu"
        buf = torch.device("cpu") if stage else x_local.device
        below = torch.zeros((lo, *x_local.shape[1:]), dtype=x_local.dtype, device=buf)
        above = torch.zeros((hi, *x_local.shape[1:]), dtype=x_local.dtype, device=buf)

        def peer(q):
            return q if self.group is None else dist.get_global_rank(self.group, q)

        def seg(a, b):
            t = x_local[a:b].contiguous()
            return t.cpu() if stage else t

        ops = []
        if lo and r + 1 < D:
            ops.append(dist.P2POp(dist.isend, seg(n - lo, n), peer(r + 1), self.group))
        if lo and r > 0:
            ops.append(dist.P2POp(dist.irecv, below, peer(r - 1), self.group))
        if hi and r > 0:
            ops.append(dist.P2POp(dist.isend, seg(0, hi), peer(r - 1), self.group))
        if hi and r + 1 < D:
            ops.append(dist.P2POp(dist.irecv, above, peer(r + 1), self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if stage:
            below, above = below.to(x_local.device), above.to(x_local.device)
        return torch.cat([below, x_local, above])


def rank_device(device="cuda") -> torch.device:
    """The device of this rank: ``cuda`` without an index means
    ``cuda:{global rank % device count}``; anything else as given."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def _rank_main(rank, D, backend, device, init_file, target, args, results):
    try:
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", rank=rank, world_size=D,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        dev = rank_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        torch.set_num_threads(_threads(D))
        out = (rank, True, target(dev, *args))
    except Exception:  # reported to the parent, which raises
        out = (rank, False, traceback.format_exc())
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    results.put(out)


class Ranks:
    """Handle on the processes of ``spawn_ranks``."""

    def __init__(self, procs, results):
        self.procs, self.results = procs, results

    def join(self, timeout: float) -> list:
        """Every rank's return value, in rank order; raises with the
        traceback of a rank that failed, or when ``timeout`` seconds pass."""
        got, failed = {}, []
        try:
            for _ in self.procs:
                rank, ok, value = self.results.get(timeout=timeout)
                if ok:
                    got[rank] = value
                else:
                    failed.append((rank, value))
        except queue.Empty:
            self.terminate()
            raise RuntimeError(f"ranks {sorted(set(range(len(self.procs))) - set(got))} "
                               f"gave no result in {timeout} s") from None
        for p in self.procs:
            p.join(timeout=60)
        if failed:
            self.terminate()
            raise RuntimeError("".join(f"rank {r} failed:\n{tb}" for r, tb in failed))
        return [got[r] for r in range(len(self.procs))]

    def terminate(self):
        for p in self.procs:
            if p.is_alive():
                p.terminate()
            p.join(timeout=10)


def _threads(D: int) -> int:
    return max(1, (os.cpu_count() or 1) // D)


def spawn_ranks(target, D: int, backend: str, device, init_file: str, *args) -> Ranks:
    """Start D processes; rank r joins a ``backend`` group of size D
    through the rendezvous file ``init_file`` (which must not exist yet),
    then calls ``target(its device, *args)`` and returns the result to the
    parent through ``Ranks.join``. ``target`` and ``args`` are pickled
    (``target`` by its import path). ``device`` is as for ``rank_device``."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, D, backend, device, init_file, target, args, results))
             for r in range(D)]
    # a spawned child reads the environment as it is at start()
    saved = {k: os.environ.get(k) for k in _THREAD_VARS}
    os.environ.update({k: str(_threads(D)) for k in _THREAD_VARS})
    try:
        for p in procs:
            p.start()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return Ranks(procs, results)


def _serve(dev, tasks, results):
    """A RankPool rank: run tasks until a None arrives. A task on d ranks
    runs ``fn(group, dev, *args)`` on ranks 0..d-1, with ``group`` their
    subgroup (None when d is every rank); the others return None."""
    rank, world = dist.get_rank(), dist.get_world_size()
    groups = {}
    while True:
        task = tasks[rank].get()
        if task is None:
            return None
        fn, d, args = pickle.loads(task)  # the pool's own bytes (RankPool.run)
        if d not in groups:  # every rank creates every group, in one order
            groups[d] = None if d == world else dist.new_group(list(range(d)))
        try:
            out = pickle.dumps((True, fn(groups[d], dev, *args) if rank < d else None))
        except Exception:
            out = pickle.dumps((False, traceback.format_exc()))
        results.put((rank, out))


class RankPool:
    """D ranks started once (``spawn_ranks``) that run one task after
    another: ``run(fn, d, *args)`` calls ``fn(group, device, *args)`` on
    ranks 0..d-1 and returns their results in rank order. ``fn`` must be
    importable by the ranks (a module-level function). Close it, or use it
    as a context manager."""

    def __init__(self, D: int, backend: str, device="cuda", timeout: float = 600):
        ctx = mp.get_context("spawn")
        self.D, self.timeout = D, timeout
        self._tmp = tempfile.TemporaryDirectory()
        self._tasks = [ctx.Queue() for _ in range(D)]
        self._results = ctx.Queue()
        self._ranks = spawn_ranks(_serve, D, backend, device,
                                  os.path.join(self._tmp.name, "rendezvous"),
                                  self._tasks, self._results)

    def run(self, fn, d: int, *args) -> list:
        if not 1 <= d <= self.D:
            raise ValueError(f"a task on {d} ranks in a pool of {self.D}")
        # pickled here, and the results on the ranks, so that what does not
        # pickle raises at once instead of leaving the other side waiting
        task = pickle.dumps((fn, d, args))
        for q in self._tasks:
            q.put(task)
        got, failed = {}, []
        try:
            for _ in range(self.D):
                rank, out = self._results.get(timeout=self.timeout)
                ok, value = pickle.loads(out)
                if ok:
                    got[rank] = value
                else:
                    failed.append((rank, value))
        except queue.Empty:
            self.close()
            raise RuntimeError(f"a task gave no result in {self.timeout} s") from None
        if failed:
            self.close()
            raise RuntimeError("".join(f"rank {r} failed:\n{tb}" for r, tb in failed))
        return [got[r] for r in range(d)]

    def close(self):
        if self._ranks is None:
            return
        for q in self._tasks:
            q.put(None)
        try:
            self._ranks.join(timeout=60)
        except RuntimeError:
            self._ranks.terminate()
        self._ranks = None
        self._tmp.cleanup()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
