"""Deterministic fault injection: every recovery path exercised, not
believed.

Counterpart of `implicitglobalgrid_tpu/runtime/faults.py`: the fault records
a supervised run (`run_resilient`) consumes, and the two primitives that
inject them.

- `NaNPoke`: silent data corruption; one cell of one field set to NaN at an
  exact step (`poke_nan`). The health guard must trip within that chunk.
- `CheckpointCorruption`: a storage failure; right after the N-th
  checkpoint save, its directory is truncated, bit-flipped or deleted on
  disk (`corrupt_checkpoint`). The next restore must detect it (the content
  checksums of `utils/checkpoint.py`).
- `ProcessLoss`: a lost device; at an exact step the live state is
  abandoned and the grid re-initialized with ``new_dims``, and the last
  good checkpoint is restored elastically (`runtime.recovery`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

__all__ = ["NaNPoke", "CheckpointCorruption", "ProcessLoss",
           "poke_nan", "corrupt_checkpoint"]


@dataclass(frozen=True)
class NaNPoke:
    """Set ``state[name][index] = NaN`` when the run reaches ``step``
    (``index`` in the STACKED layout — it addresses a cell of a specific
    shard, the 'chosen shard at a chosen step' of the injection matrix)."""
    step: int
    name: str
    index: tuple = (0, 0, 0)


@dataclass(frozen=True)
class CheckpointCorruption:
    """Corrupt the checkpoint written by save number ``save_index``
    (0-based, counting the run's initial step-0 save) immediately after
    it completes. ``kind``: ``"truncate"`` | ``"bitflip"`` | ``"delete"``;
    ``target``: ``"shard"`` (process ``process``'s file) | ``"meta"``."""
    save_index: int
    kind: str = "truncate"
    target: str = "shard"
    process: int = 0


@dataclass(frozen=True)
class ProcessLoss:
    """Abandon the live state at ``step`` and restart elastically on a
    grid decomposed as ``new_dims`` (same implicit global grid)."""
    step: int
    new_dims: tuple


def poke_nan(A, index=(0, 0, 0)):
    """A copy of tensor ``A`` with the cell at ``index`` of its box (the
    stacked layout) set to NaN: the injection primitive behind `NaNPoke`.
    ``A`` itself is not written."""
    out = A.clone()
    out[tuple(int(i) for i in index)] = float("nan")
    return out


def corrupt_checkpoint(dirpath, *, kind: str = "truncate",
                       target: str = "shard", process: int = 0) -> None:
    """Damage a sharded checkpoint directory ON DISK (the injection
    primitive behind `CheckpointCorruption`): truncate the target file to
    half its size, flip one byte in its middle, or delete it. The content
    checksums added by `save_checkpoint_sharded` guarantee a later restore
    raises instead of reassembling garbage."""
    from ..utils.exceptions import InvalidArgumentError

    if kind not in ("truncate", "bitflip", "delete"):
        raise InvalidArgumentError(
            f"corrupt_checkpoint kind must be truncate|bitflip|delete, "
            f"got {kind!r}.")
    if target not in ("shard", "meta"):
        raise InvalidArgumentError(
            f"corrupt_checkpoint target must be shard|meta, got {target!r}.")
    fname = "meta.npz" if target == "meta" else f"shards_p{process}.npz"
    path = os.path.join(dirpath, fname)
    if not os.path.exists(path):
        raise InvalidArgumentError(
            f"corrupt_checkpoint: no such checkpoint file {path}.")
    if kind == "delete":
        os.remove(path)
        return
    size = os.path.getsize(path)
    if kind == "truncate":
        with open(path, "r+b") as f:
            f.truncate(size // 2)
        return
    with open(path, "r+b") as f:  # bitflip: one byte, mid-file
        f.seek(size // 2)
        b = f.read(1)
        f.seek(size // 2)
        f.write(bytes([b[0] ^ 0xFF]) if b else b"\xff")
