"""Sharded snapshots and in-situ analysis: data off the grid without ever
building the grid.

Counterpart of `implicitglobalgrid_tpu/io/`, in its container format:

- `snapshot`: async sharded snapshots. `SnapshotWriter` copies each
  process's box to the host (the only cost that blocks the step loop) and
  hands it to a bounded background writer queue (``block`` |
  ``drop_oldest``); the blocks land in the checkpoint container
  (`utils/blockio.py`) with the staged-directory commit.
- `reducers`: probes, axis slices and global min/max/mean/RMS over the
  IMPLICIT grid (overlap cells counted once), after each chunk and summed
  with the health guard's stats by one `transport.all_sum`.
- `reader`: `open_snapshot(dir).read_global(name, box=...)` assembles any
  sub-box of the implicit global grid on the host in O(box) memory, with
  `gather_interior`'s semantics; host-only, and it reads sharded
  checkpoints and the JAX package's snapshots too.
"""

from .reader import Snapshot, list_snapshots, open_snapshot
from .reducers import AxisSlice, Probe, Stats, build_reducer_plan
from .snapshot import SnapshotWriter, write_snapshot

__all__ = [
    "SnapshotWriter", "write_snapshot",
    "Snapshot", "open_snapshot", "list_snapshots",
    "Probe", "AxisSlice", "Stats", "build_reducer_plan",
]
