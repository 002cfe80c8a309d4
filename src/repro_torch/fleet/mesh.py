"""Multi-host mesh smoke path for fleet telemetry, over ``torch.distributed``.

A real fleet coordinator all-reduces per-host telemetry over the
network.  The simulation's stand-in is a ``gloo`` process group of
local worker processes, one rank per host: each host's row goes to its
own rank and the rows are summed with ``all_reduce``, so the
aggregation *pattern* (every host computes the identical global row) is
exercised across real processes.  The counterpart of ``repro.fleet.mesh``,
whose mesh is a jax CPU host-platform mesh; this one runs on the host
too (NCCL cannot put several ranks on one card).

* :func:`request_host_devices` sets the group's size; it reports False
  when a group of another size is already running.
* :func:`host_device_count` is that size (0 before any request).
* :func:`mesh_reduce_telemetry` starts the group on first use (workers
  from ``torch.multiprocessing``'s ``spawn`` context, rendezvous through
  a ``FileStore`` in a temporary directory).  The workers are daemons,
  reused by later calls and shut down at exit.  ``spawn`` workers import
  the caller's main module, so a script that uses the mesh guards its
  entry point with ``if __name__ == "__main__"``.

Everything degrades as in the reference: more rows than ranks, or ranks
that disagree → ``None``, and callers (the coordinator's ``use_mesh``
aggregate) fall back to plain numpy.  The tests assert the mesh result
equals the numpy sum.
"""

from __future__ import annotations

import atexit
import datetime
import os
import queue
import shutil
import tempfile
from typing import List, Optional

import numpy as np

#: Seconds a rendezvous or one reduction may take before it fails.
TIMEOUT_S = 120.0

_size = 0
_group: Optional["_Group"] = None


def request_host_devices(n: int) -> bool:
    """Arrange for a mesh of ``n`` ranks, if still possible.

    Returns True when the mesh has (or will start with) ``n`` ranks,
    False when a group of another size is already running.
    """
    global _size
    n = int(n)
    if n < 1:
        raise ValueError(f"a mesh needs at least one rank, got {n}")
    if _group is not None:
        return _group.size == n
    _size = n
    return True


def host_device_count() -> int:
    """Ranks the mesh can span (0 before any request)."""
    return _size


def _worker(rank: int, size: int, store_path: str, inbox, outbox) -> None:
    import torch
    import torch.distributed as dist

    store = dist.FileStore(store_path, size)
    dist.init_process_group(
        "gloo", store=store, rank=rank, world_size=size,
        timeout=datetime.timedelta(seconds=TIMEOUT_S),
    )
    try:
        while True:
            row = inbox.get()
            if row is None:
                break
            t = torch.from_numpy(row)
            dist.all_reduce(t, op=dist.ReduceOp.SUM)
            outbox.put((rank, t.numpy()))
    finally:
        dist.destroy_process_group()


class _Group:
    """``size`` daemon worker processes joined in one ``gloo`` group."""

    def __init__(self, size: int) -> None:
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.size = size
        self.tmp = tempfile.mkdtemp(prefix="repro_torch_mesh_")
        store_path = os.path.join(self.tmp, "store")
        self.outbox = ctx.Queue()
        self.inboxes = [ctx.Queue() for _ in range(size)]
        self.procs = [
            ctx.Process(target=_worker, daemon=True,
                        args=(r, size, store_path, self.inboxes[r], self.outbox))
            for r in range(size)
        ]
        for p in self.procs:
            p.start()

    def all_reduce(self, rows: np.ndarray) -> List[np.ndarray]:
        """Rank ``r`` contributes ``rows[r]``; returns every rank's sum,
        in rank order."""
        for r, inbox in enumerate(self.inboxes):
            inbox.put(np.ascontiguousarray(rows[r]))
        out: List[Optional[np.ndarray]] = [None] * self.size
        for _ in range(self.size):
            try:
                rank, row = self.outbox.get(timeout=TIMEOUT_S)
            except queue.Empty:
                dead = [p.pid for p in self.procs if not p.is_alive()]
                raise RuntimeError(
                    f"mesh all_reduce over {self.size} ranks timed out after "
                    f"{TIMEOUT_S} s (dead workers: {dead})") from None
            out[rank] = row
        return out

    def close(self) -> None:
        for p, inbox in zip(self.procs, self.inboxes):
            if p.is_alive():
                inbox.put(None)
        for p in self.procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        shutil.rmtree(self.tmp, ignore_errors=True)


def _shutdown() -> None:
    global _group
    if _group is not None:
        _group.close()
        _group = None


atexit.register(_shutdown)


def mesh_reduce_telemetry(per_host: np.ndarray) -> Optional[np.ndarray]:
    """All-reduce per-host telemetry rows across a one-rank-per-host mesh.

    ``per_host`` is ``(n_hosts, k)`` (a 1-D vector is treated as one
    row per host, k = 1).  Row ``r`` goes to rank ``r`` (zero rows pad
    the group's spare ranks) and is summed with ``all_reduce`` in
    float64; every rank then holds the identical global row, and that
    row is returned.  Returns ``None`` when the mesh has fewer ranks
    than rows — callers fall back to ``per_host.sum(axis=0)``, which is
    numerically the same reduction.
    """
    global _group
    rows = np.asarray(per_host, np.float64)
    if rows.ndim == 1:
        rows = rows[:, None]
    if rows.ndim != 2 or rows.shape[0] < 1:
        raise ValueError(
            f"per_host telemetry must be (n_hosts, k), got {rows.shape}"
        )
    n = rows.shape[0]
    if n > _size:
        return None
    if _group is None:
        _group = _Group(_size)
    padded = np.zeros((_size, rows.shape[1]), np.float64)
    padded[:n] = rows
    reduced = _group.all_reduce(padded)
    # the mesh invariant: every host computed the same global row
    if any(not np.array_equal(r, reduced[0]) for r in reduced):
        return None
    return reduced[0]
