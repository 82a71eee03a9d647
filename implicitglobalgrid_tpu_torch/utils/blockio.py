"""The block container of checkpoints and snapshots.

Counterpart of `implicitglobalgrid_tpu/utils/blockio.py`, copied (it is pure
numpy): the same on-disk format, so either package reads what the other
writes. A container is a DIRECTORY holding

- ``shards_p<process>.npz``: each process's blocks, keyed by BLOCK
  COORDINATES (``shard_key``: the array's name and the block's start
  offsets in the whole grid's stacked array), so any reader can reassemble
  any sub-box without knowing which process wrote which block;
- ``meta.npz``: the grid topology (``grid_meta``), the arrays' names,
  stacked shapes and dtypes, the save token that ties the file set
  together, and the step; its write is the COMMIT record of the set;
- a ``<file>.sha256`` content-checksum sidecar per file (written after the
  data file is fsync'ed: its presence marks that file complete), verified
  before any byte of the file is used.

Durability protocol (both writers follow it): stage every file into a
``<dir>.tmp-<token>`` directory, fsync each, and only after the complete
set (meta last) is on disk does ONE rename give the directory its final
name: a crash at any point leaves either a previous complete directory or
a stale ``.tmp-``, never a half-written committed one.

Host-side numpy/os code only (no torch), so the reader side (`io.reader`)
works on a machine without a GPU.
"""

from __future__ import annotations

import os

import numpy as np

from .exceptions import IncoherentArgumentError, InvalidArgumentError

__all__ = [
    "META_PREFIX", "ARR_PREFIX", "file_sha256", "write_npz_synced",
    "verify_checksum", "fsync_dir", "starts_of", "shard_key", "grid_meta",
    "load_prefixed_meta", "block_scanner", "validate_block_keys",
    "commit_staged_dir",
]

META_PREFIX = "__igg_meta__"
ARR_PREFIX = "__igg_arr__"


def validate_block_keys(state: dict, what: str) -> None:
    """The container's key rule, shared by every writer: array names key
    npz members (`shard_key`), so they must be plain strings without the
    ``__`` separator and outside the reserved ``__igg_`` namespace."""
    if not isinstance(state, dict) or not state:
        raise InvalidArgumentError(
            f"{what} expects a non-empty dict of name -> array.")
    for k in state:
        if not isinstance(k, str) or k.startswith("__igg_") or "__" in k:
            raise InvalidArgumentError(
                f"Invalid state key {k!r}: keys must be strings without "
                "'__' and not starting with '__igg_'.")


def grid_meta(gg) -> dict:
    """The topology record every container carries (prefixed keys)."""
    return {
        f"{META_PREFIX}nxyz": np.asarray(gg.nxyz, dtype=np.int64),
        f"{META_PREFIX}dims": np.asarray(gg.dims, dtype=np.int64),
        f"{META_PREFIX}overlaps": np.asarray(gg.overlaps, dtype=np.int64),
        f"{META_PREFIX}periods": np.asarray(gg.periods, dtype=np.int64),
        f"{META_PREFIX}halowidths": np.asarray(gg.halowidths,
                                               dtype=np.int64),
    }


# ---------------------------------------------------------------------------
# File integrity: fsync'ed writes + sha256 content sidecars
# ---------------------------------------------------------------------------

def file_sha256(path) -> str:
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def write_npz_synced(path, payload: dict) -> None:
    """`np.savez` to ``path`` with fsync, plus a ``<path>.sha256``
    content-checksum sidecar (also fsync'ed) verified before reads. The
    sidecar lands LAST, so its presence marks the data file complete —
    the multi-process snapshot commit polls for exactly that."""
    with open(path, "wb") as f:
        np.savez(f, **payload)
        f.flush()
        os.fsync(f.fileno())
    side = path + ".sha256"
    with open(side + ".tmp", "w") as f:
        f.write(file_sha256(path) + "\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(side + ".tmp", side)


def verify_checksum(path, *, required: bool) -> None:
    """Compare ``path`` against its ``.sha256`` sidecar. ``required=False``
    tolerates a MISSING sidecar (containers from before the checksum
    format); a PRESENT sidecar is always enforced."""
    side = path + ".sha256"
    if not os.path.exists(side):
        if required:
            raise IncoherentArgumentError(
                f"Checkpoint file {path} has no .sha256 sidecar but the "
                "save recorded checksums — the directory was tampered with "
                "or partially copied; do not resume from it.")
        return
    with open(side) as f:
        expect = f.read().strip()
    got = file_sha256(path)
    if got != expect:
        raise IncoherentArgumentError(
            f"Checkpoint file {path} is corrupt: content checksum "
            f"{got[:12]}… does not match the recorded {expect[:12]}… — the "
            "file was truncated or bit-flipped after the save; restore "
            "from another checkpoint.")


def fsync_dir(path) -> None:
    """Durability for a commit rename (POSIX: the rename is only durable
    once the parent directory is fsync'ed); best-effort on platforms
    without directory fds."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


# ---------------------------------------------------------------------------
# Block keys and scanning
# ---------------------------------------------------------------------------

def starts_of(index) -> tuple:
    return tuple(int(sl.start or 0) for sl in index)


def shard_key(name: str, starts) -> str:
    return f"{ARR_PREFIX}{name}__" + "_".join(str(s) for s in starts)


def load_prefixed_meta(dirpath) -> dict:
    """Open + verify + prefix-strip ``meta.npz`` — the ONE meta-loading
    path of every block container. The file is checksum-verified BEFORE
    parsing (a corrupt meta must raise the typed error, not a raw zipfile
    one); ``required=False`` tolerates pre-checksum-format saves, which
    have no sidecars at all."""
    meta_path = os.path.join(dirpath, "meta.npz")
    if not os.path.exists(meta_path):
        raise InvalidArgumentError(
            f"Sharded checkpoint meta not found: {meta_path}")
    verify_checksum(meta_path, required=False)
    import zipfile

    try:
        with np.load(meta_path) as z:
            return {k[len(META_PREFIX):]: z[k] for k in z.files
                    if k.startswith(META_PREFIX)}
    except (OSError, ValueError, zipfile.BadZipFile) as e:
        # a half-committed / truncated meta.npz without a sidecar (a
        # pre-checksum save interrupted mid-copy) surfaces as a raw
        # zipfile error — readers polling a live root need the TYPED
        # refusal instead
        raise IncoherentArgumentError(
            f"{meta_path} is unreadable ({type(e).__name__}: {e}) — the "
            "directory is half-committed or was truncated after commit; "
            "do not read from it.") from e


def commit_staged_dir(stage: str, final: str, token: str) -> None:
    """The container's one-rename commit, shared by every writer: a
    pre-existing ``final`` is moved aside first (stale files from an
    earlier save can never shadow the new set — the whole directory is
    replaced, not patched), the staging dir takes the final name in ONE
    rename, the parent is fsync'ed (POSIX: the rename is only durable
    then), and the old set is removed last."""
    import shutil

    old = None
    if os.path.exists(final):
        old = f"{final}.old-{token}"
        os.rename(final, old)
    os.rename(stage, final)
    fsync_dir(os.path.dirname(os.path.abspath(final)) or ".")
    if old is not None:
        shutil.rmtree(old, ignore_errors=True)


def block_scanner(files, wanted: set, checksums_required: bool,
                  verified: set, *, pop: bool = True):
    """Lazy scan over the shard files for the keys in ``wanted``: each file
    is opened at most once (checksum-verified on first open) and each
    found block cached, so host memory stays at the CONSUMER'S working-set
    volume — the restore's per-process shard volume, the snapshot reader's
    requested box — never the global array. ``pop=True`` drops a block
    once consumed (the plain restore's one consumer per block);
    ``pop=False`` keeps it cached — the elastic restore and the box reader
    reuse one saved block for several destinations."""

    blocks: dict = {}
    unscanned = list(files)

    def find_block(key: str):
        while key not in blocks and unscanned:
            path = unscanned.pop(0)
            if path not in verified:
                verify_checksum(path, required=checksums_required)
                verified.add(path)
            with np.load(path) as z:
                for k in z.files:
                    if k in wanted:
                        blocks[k] = z[k]
        if key not in blocks:
            raise IncoherentArgumentError(
                f"Sharded checkpoint is missing block `{key}` — was the "
                "save interrupted, or written with a different topology?")
        return blocks.pop(key) if pop else blocks[key]

    return find_block
