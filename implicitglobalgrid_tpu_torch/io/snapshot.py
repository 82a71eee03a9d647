"""Async sharded snapshots: the step loop never waits on disk.

Counterpart of `implicitglobalgrid_tpu/io/snapshot.py`. `SnapshotWriter.submit`
does the ONLY work that blocks the caller, a device-to-host copy of this
process's box (the same volume `save_checkpoint_sharded` writes), and hands
the host blocks to a bounded background writer queue. Serialization, fsync,
checksums and the directory-atomic commit run on the writer thread, under
the next chunk. Two policies when the queue is full:

- ``block`` (default): `submit` waits for a slot (bounded memory; the run
  throttles to disk speed);
- ``drop_oldest``: the oldest queued snapshot is discarded and counted
  (bounded memory and stall, for outputs where freshness beats
  completeness). One process only: each process's queue fills at its own
  disk speed, so drops would desynchronize the processes' shard sets; the
  constructor refuses it in a process group of more than one.

On disk: ``<root>/step_<NNNNNNNNNN>/`` in the checkpoint container
(`utils/blockio.py`: ``shards_p<rank>.npz`` keyed by block coordinates,
``meta.npz``, sha256 sidecars), so either package reads the other's. Every
process stages into the SAME ``.tmp-step...`` directory (named from the
step: no broadcast, since the writer thread must never enter a collective);
a process's sidecar appears only after its data file is fsync'ed, so
process 0's writer thread polls for every sidecar, writes ``meta.npz`` (the
commit record) and renames the staging directory into place. A crash leaves
either a committed, checksum-complete snapshot or a stale ``.tmp-``
directory that `io.reader.list_snapshots` never lists. A re-attempt of the
same step reuses the staging directory; each process unlinks its own stale
sidecar before rewriting.

`_capture_shards` copies the box to host memory whole before `submit`
returns, never a view: a runner with ``donate=True`` hands the state it was
given to the next step as its spare buffer (`models.common`), which
overwrites it. `write_snapshot` is the synchronous core (what the writer
thread runs).
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np

from ..parallel.topology import check_initialized, global_grid, grid_is_initialized
from ..utils.blockio import (
    META_PREFIX, commit_staged_dir, grid_meta, shard_key,
    validate_block_keys, write_npz_synced,
)
from ..utils.exceptions import InvalidArgumentError

__all__ = ["SnapshotWriter", "write_snapshot", "snapshot_dirname"]

_POLICIES = ("block", "drop_oldest")
STEP_PREFIX = "step_"


def snapshot_dirname(step: int) -> str:
    """Directory name of the snapshot at ``step`` (zero-padded so lexical
    order IS step order: `list_snapshots` relies on it)."""
    return f"{STEP_PREFIX}{int(step):010d}"


def _capture_shards(state: dict, fields=None) -> dict:
    """The device-to-host part of a snapshot: a complete host copy of this
    process's blocks of each field, plus everything the writer thread needs
    to serialize them without touching torch or the live grid (which an
    elastic restart may re-initialize under it). An ensemble's member axes
    (`utils.checkpoint.member_axes`) are recorded as checkpoints record
    them."""
    import torch

    from ..utils.checkpoint import box_host_blocks, dtype_name, member_axes

    check_initialized()
    gg = global_grid()
    if not isinstance(state, dict) or not state:
        raise InvalidArgumentError(
            "snapshot expects a non-empty dict of name -> stacked array.")
    if fields is not None:
        missing = [f for f in fields if f not in state]
        if missing:
            raise InvalidArgumentError(
                f"snapshot fields {missing} are not in the state "
                f"(have {list(state)}).")
    names = list(state) if fields is None else list(fields)
    validate_block_keys(dict.fromkeys(names), "snapshot")
    blocks, shapes, dtypes, leads = {}, {}, {}, {}
    nbytes = 0
    for k in names:
        v = torch.as_tensor(state[k], device=gg.device)
        leads[k] = member_axes(v.shape, name=k)
        got, shapes[k] = box_host_blocks(v, leads[k], gg)
        dtypes[k] = dtype_name(v)
        for starts, block in got.items():
            blocks[shard_key(k, starts)] = block
            nbytes += block.nbytes
    return {
        "names": names, "shapes": shapes, "dtypes": dtypes, "leads": leads,
        "blocks": blocks, "nbytes": nbytes,
        "grid_meta": grid_meta(gg),
        "pidx": int(gg.me),
        "nprocs_files": int(gg.transport.world),
    }


def _write_captured(root: str, step: int, cap: dict, *,
                    commit_timeout: float = 120.0) -> tuple:
    """Serialize one captured snapshot into ``<root>/step_<n>`` with the
    staged-directory atomic commit. Pure host code — safe on a background
    thread. Returns ``(path, committed)``: process 0 commits (path is the
    final directory); other processes only stage their shard file — their
    snapshot exists only once process 0's commit lands."""
    final = os.path.join(root, snapshot_dirname(step))
    token = snapshot_dirname(step)  # deterministic: no cross-process bcast
    stage = f"{final}.tmp-{token}"
    os.makedirs(stage, exist_ok=True)

    payload = {f"{META_PREFIX}save_token": np.str_(token)}
    payload.update(cap["blocks"])
    shard_file = os.path.join(stage, f"shards_p{cap['pidx']}.npz")
    # A re-attempt of the same step (rollback replay, or a retry after an
    # aborted commit) reuses the deterministic stage dir: drop the OWN
    # stale sidecar before touching the data file, so process 0's poll
    # can never read a prior attempt's completion marker while this one
    # is mid-write.
    try:
        os.unlink(shard_file + ".sha256")
    except FileNotFoundError:
        pass
    write_npz_synced(shard_file, payload)
    if cap["pidx"] != 0:
        return stage, False

    # Process 0 commits: wait for every process's sidecar (a sidecar is
    # written only after its data file is fsync'ed — presence == complete),
    # then write meta.npz (the commit record) and rename the set into
    # place. Polling replaces the checkpoint path's barrier: a writer
    # thread must never enter a collective.
    deadline = time.monotonic() + commit_timeout
    sidecars = [os.path.join(stage, f"shards_p{i}.npz.sha256")
                for i in range(cap["nprocs_files"])]
    while not all(os.path.exists(p) for p in sidecars):
        if time.monotonic() > deadline:
            raise InvalidArgumentError(
                f"Snapshot commit timed out after {commit_timeout}s: "
                f"missing {[p for p in sidecars if not os.path.exists(p)]} "
                f"in {stage} — a peer process stalled or died; the staged "
                "directory is left for inspection (it is never listed as "
                "a snapshot).")
        time.sleep(0.01)

    meta = dict(cap["grid_meta"])
    meta[f"{META_PREFIX}names"] = np.asarray(cap["names"])
    meta[f"{META_PREFIX}save_token"] = np.str_(token)
    meta[f"{META_PREFIX}nprocs_files"] = np.int64(cap["nprocs_files"])
    meta[f"{META_PREFIX}checksums"] = np.str_("sha256")
    meta[f"{META_PREFIX}step"] = np.int64(step)
    meta[f"{META_PREFIX}kind"] = np.str_("snapshot")
    for k in cap["names"]:
        meta[f"{META_PREFIX}shape__{k}"] = np.asarray(cap["shapes"][k],
                                                      dtype=np.int64)
        meta[f"{META_PREFIX}dtype__{k}"] = np.str_(cap["dtypes"][k])
        if cap["leads"][k]:  # an ensemble's member axes, as checkpoints record them
            meta[f"{META_PREFIX}lead__{k}"] = np.int64(cap["leads"][k])
    write_npz_synced(os.path.join(stage, "meta.npz"), meta)
    # re-snapshot of the same step (rollback replay): the old committed
    # dir is replaced whole (`blockio.commit_staged_dir`, shared with the
    # checkpoint save)
    commit_staged_dir(stage, final, token)
    return final, True


def write_snapshot(root, state: dict, *, step: int, fields=None,
                   commit_timeout: float = 120.0) -> str:
    """Synchronously write one snapshot of ``state`` under ``root``
    (directory ``<root>/step_<n>``): the core of `SnapshotWriter`, the same
    container and commit, no queue. Every process of a group must call it
    for the commit to complete. Returns the snapshot's path."""
    os.makedirs(str(root), exist_ok=True)
    cap = _capture_shards(state, fields)
    _write_captured(str(root), int(step), cap, commit_timeout=commit_timeout)
    # the FINAL path on every process: the others only staged, but the
    # committed directory's name is deterministic
    return os.path.join(str(root), snapshot_dirname(int(step)))


def _process_count() -> int:
    if grid_is_initialized():
        return int(global_grid().transport.world)
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


class SnapshotWriter:
    """Bounded-queue async snapshot writer (the module docstring has the
    protocol). One writer owns one ``root`` directory; `submit` is called
    from the step loop, everything else runs on a daemon writer thread.
    Thread-safe; `close` (or leaving the context manager) drains the queue."""

    def __init__(self, root, *, queue_depth: int = 2,
                 policy: str = "block", fields=None,
                 commit_timeout: float = 120.0):
        if policy not in _POLICIES:
            raise InvalidArgumentError(
                f"SnapshotWriter policy must be one of {_POLICIES}; "
                f"got {policy!r}.")
        if policy == "drop_oldest" and _process_count() > 1:
            raise InvalidArgumentError(
                "SnapshotWriter policy='drop_oldest' is single-process "
                "only: multi-process runs must use policy='block' so every "
                "process stages the same snapshot sequence.")
        if int(queue_depth) < 1:
            raise InvalidArgumentError(
                f"SnapshotWriter queue_depth must be >= 1; got "
                f"{queue_depth}.")
        self.root = str(root)
        self.policy = policy
        self.queue_depth = int(queue_depth)
        self.fields = None if fields is None else tuple(fields)
        self.commit_timeout = float(commit_timeout)
        os.makedirs(self.root, exist_ok=True)
        self._cv = threading.Condition()
        self._queue: list = []     # [(step, captured)] oldest first
        self._busy = False         # writer thread mid-write
        self._closed = False
        self._stats = {"submitted": 0, "written": 0, "staged": 0,
                       "dropped": 0, "errors": 0, "bytes": 0, "write_s": 0.0}
        self._thread = threading.Thread(
            target=self._run, name="igg-snapshot-writer", daemon=True)
        self._thread.start()

    # -- producer side ----------------------------------------------------

    def submit(self, state: dict, step: int) -> bool:
        """Snapshot ``state`` at ``step``: the device-to-host copy now, the
        disk on the writer thread. Returns False iff the job displaced the
        oldest queued snapshot (``drop_oldest`` under a full queue)."""
        cap = _capture_shards(state, self.fields)
        with self._cv:
            if self._closed:
                raise InvalidArgumentError(
                    "SnapshotWriter is closed; create a new one.")
            while (self.policy == "block"
                   and len(self._queue) >= self.queue_depth
                   and not self._closed):
                self._cv.wait()
            if self._closed:
                raise InvalidArgumentError(
                    "SnapshotWriter was closed while waiting for a queue "
                    "slot; the snapshot was not submitted.")
            dropped = len(self._queue) >= self.queue_depth  # drop_oldest
            if dropped:
                self._queue.pop(0)
                self._stats["dropped"] += 1
            self._queue.append((int(step), cap))
            self._stats["submitted"] += 1
            self._cv.notify_all()
        return not dropped

    def flush(self, timeout: float | None = None) -> bool:
        """Wait until every submitted snapshot is on disk (or dropped).
        Returns False on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while self._queue or self._busy:
                rem = None if deadline is None \
                    else max(0.0, deadline - time.monotonic())
                if rem == 0.0:
                    return False
                self._cv.wait(timeout=rem)
        return True

    def close(self, timeout: float | None = None) -> bool:
        """Drain and stop the writer thread (idempotent). Returns the
        `flush` verdict."""
        ok = self.flush(timeout)
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=5.0)
        return ok

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    @property
    def stats(self) -> dict:
        """Counters: submitted / written (COMMITTED: process 0 only in a
        process group) / staged (the other processes' shard files handed to
        process 0's commit) / dropped / errors / bytes (committed payload
        bytes, this process's blocks) / write_s (the writer thread's seconds
        in its writes and commits, on the host clock)."""
        with self._cv:
            return dict(self._stats)

    # -- writer thread -----------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if not self._queue:  # closed and drained
                    return
                step, cap = self._queue.pop(0)
                self._busy = True
                self._cv.notify_all()
            t0 = time.perf_counter()
            try:
                _, committed = _write_captured(
                    self.root, step, cap, commit_timeout=self.commit_timeout)
            except Exception:  # never kill the run from the writer
                with self._cv:
                    self._stats["errors"] += 1
                    self._stats["write_s"] += time.perf_counter() - t0
                    self._busy = False
                    self._cv.notify_all()
                continue
            # only a COMMITTED snapshot counts as written: another process
            # merely staged its shard file for process 0's commit
            with self._cv:
                self._stats["write_s"] += time.perf_counter() - t0
                self._stats["written" if committed else "staged"] += 1
                if committed:
                    self._stats["bytes"] += cap["nbytes"]
                self._busy = False
                self._cv.notify_all()
