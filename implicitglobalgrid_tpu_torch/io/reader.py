"""Lazy snapshot reader: assemble any sub-box, never the grid.

Counterpart of `implicitglobalgrid_tpu/io/reader.py`. `open_snapshot(dir)`
parses a block container's ``meta.npz`` (topology, names, stacked shapes,
dtypes); `Snapshot.read_global(name, box=...)` assembles the requested
sub-box of the IMPLICIT global grid on the host (overlap stripped, periodic
ghost shift and wrap applied) with `gather_interior`'s semantics, bit for bit
(the ownership arithmetic of `io/layout.py`). Memory stays O(box + one
block): the block scanner (`utils/blockio.py`) loads only the blocks the box
touches, each file opened at most once and checksum-verified before use.

Host-only: numpy and no torch, no grid, no GPU. It reads either package's
snapshots and `save_checkpoint_sharded` directories (one container format).
bfloat16 comes back as `ml_dtypes.bfloat16` where `ml_dtypes` imports (as
`gather` returns it), else widened exactly to float32; an ensemble's field
(``lead__<name>`` recorded) keeps its member axes whole.
"""

from __future__ import annotations

import itertools
import os

import numpy as np

from ..utils.blockio import block_scanner, load_prefixed_meta, shard_key
from ..utils.exceptions import IncoherentArgumentError, InvalidArgumentError
from .layout import (
    AxisGeometry, field_geometry, global_shape_of, normalize_box, owner_maps,
)
from .snapshot import STEP_PREFIX

__all__ = ["Snapshot", "open_snapshot", "list_snapshots"]


class Snapshot:
    """One committed block container, opened lazily (meta only; shard
    files are read on demand, box-sized)."""

    def __init__(self, dirpath):
        self.path = os.fspath(dirpath)
        base = os.path.basename(os.path.normpath(self.path))
        if ".tmp-" in base or ".old-" in base:
            # a staging (or moved-aside) directory is NOT a snapshot: a
            # query-service replica polling a live root must get the
            # typed refusal, never a torn read of a half-written set
            raise IncoherentArgumentError(
                f"{self.path} is an uncommitted staging directory "
                "(.tmp-/.old- — an in-flight or interrupted writer); "
                "only committed snapshot directories can be opened. "
                "Use list_snapshots(root) — it never lists these.")
        if not os.path.isdir(self.path):
            raise InvalidArgumentError(
                f"Snapshot directory not found: {self.path}")
        meta = load_prefixed_meta(self.path)
        self._meta = meta
        tok = meta.get("save_token")
        self.token = None if tok is None else str(tok)
        self.names = [str(n) for n in meta.get("names", ())]
        self.step = int(meta["step"]) if "step" in meta else None
        self._checksums = "checksums" in meta
        n_files = int(meta.get("nprocs_files", 0)) or 1
        self.files = [os.path.join(self.path, f"shards_p{i}.npz")
                      for i in range(n_files)]
        missing = [f for f in self.files if not os.path.exists(f)]
        if missing:
            raise IncoherentArgumentError(
                f"Snapshot {self.path} is incomplete: missing shard "
                f"file(s) {missing} — it was partially copied or "
                "tampered with after commit (an interrupted writer "
                "leaves an uncommitted .tmp- staging dir instead; a "
                "committed dir must be whole).")
        self._verified: set = set()

    # -- meta --------------------------------------------------------------

    def topology(self) -> dict:
        """The saved grid topology (``nxyz, dims, overlaps, periods,
        halowidths, step``) — same record as `igg.saved_topology`."""
        out = {k: np.asarray(self._meta[k], dtype=np.int64)
               for k in ("nxyz", "dims", "overlaps", "periods",
                         "halowidths")}
        out["step"] = self.step
        return out

    def dtype(self, name: str) -> np.dtype:
        """The numpy dtype `read_global` returns (bfloat16: the module
        docstring)."""
        self._check_name(name)
        saved = str(self._meta[f"dtype__{name}"])
        if saved != "bfloat16":
            return np.dtype(saved)
        try:
            import ml_dtypes
        except ImportError:
            return np.dtype(np.float32)
        return np.dtype(ml_dtypes.bfloat16)

    def _host(self, name: str, block) -> np.ndarray:
        """``block`` as `dtype` reads it: a bfloat16 block by its bytes."""
        block = np.asarray(block)
        if str(self._meta[f"dtype__{name}"]) != "bfloat16":
            return block
        raw = np.ascontiguousarray(block).view(np.uint16)
        want = self.dtype(name)
        if want == np.float32:
            return (raw.astype(np.uint32) << 16).view(np.float32)
        return raw.view(want)

    def stacked_shape(self, name: str) -> tuple:
        self._check_name(name)
        return tuple(int(s) for s in self._meta[f"shape__{name}"])

    def _check_name(self, name: str) -> None:
        if name not in self.names:
            raise InvalidArgumentError(
                f"Snapshot {self.path} has no field {name!r} "
                f"(have {self.names}).")

    def _geoms(self, name: str) -> tuple:
        m = self._meta
        lead = int(m.get(f"lead__{name}", 0))
        full = self.stacked_shape(name)
        shape = full[lead:]
        dims = np.asarray(m["dims"], dtype=np.int64)
        loc = [shape[d] // int(dims[d]) if d < 3 else shape[d]
               for d in range(len(shape))]
        for d in range(min(len(shape), 3)):
            if shape[d] % int(dims[d]):
                raise IncoherentArgumentError(
                    f"Stacked size {shape[d]} of `{name}` along dimension "
                    f"{d} is not divisible by dims[{d}]={int(dims[d])}.")
        members = tuple(AxisGeometry(1, n, 0, n, False, n) for n in full[:lead])
        return members + field_geometry(dims, m["nxyz"], m["overlaps"], m["periods"], loc)

    def global_shape(self, name: str) -> tuple:
        """Implicit-global shape of ``name`` — what `gather_interior`
        would return for the same (possibly staggered) field."""
        return global_shape_of(self._geoms(name))

    # -- data --------------------------------------------------------------

    def read_global(self, name: str, box=None) -> np.ndarray:
        """Assemble the ``box`` (per-dim ``(lo, hi)`` half-open global
        ranges; ``None`` = whole axis/grid) of field ``name`` —
        bit-identical to ``gather_interior(A)[box]`` on the snapshotted
        state, in O(box) host memory."""
        geoms = self._geoms(name)
        gshape = global_shape_of(geoms)
        box = normalize_box(box, gshape)
        dtype = self.dtype(name)
        loc = tuple(g.n for g in geoms)

        # Per-axis owner maps of the requested cells, then the block set
        # they touch (the keys the lazy scanner is allowed to cache).
        per_axis = []
        for d, (lo, hi) in enumerate(box):
            c_of, i_of = owner_maps(geoms[d], np.arange(lo, hi))
            per_axis.append((c_of, i_of))
        wanted = {
            shard_key(name, tuple(int(co[d]) * loc[d]
                                  for d in range(len(loc))))
            for co in itertools.product(
                *[np.unique(pa[0]) for pa in per_axis])}
        find_block = block_scanner(self.files, wanted, self._checksums,
                                   self._verified, pop=False)

        out = np.empty(tuple(hi - lo for lo, hi in box), dtype=dtype)
        for co in itertools.product(*[np.unique(pa[0]) for pa in per_axis]):
            sel_out, sel_src = [], []
            for d in range(len(loc)):
                c_of, i_of = per_axis[d]
                jj = np.nonzero(c_of == co[d])[0]
                sel_out.append(jj)
                sel_src.append(i_of[jj])
            key = shard_key(name, tuple(int(co[d]) * loc[d]
                                        for d in range(len(loc))))
            block = self._host(name, self._fetch_block(name, key, find_block))
            out[np.ix_(*sel_out)] = block[np.ix_(*sel_src)]
        return out

    def _fetch_block(self, name: str, key: str, find_block):
        """Block-fetch hook: the shard files' scan (`block_scanner`,
        sha256-verified on first open); a caching reader overrides it."""
        return find_block(key)

    def read_point(self, name: str, index) -> float:
        """One global cell: an O(1 block) read."""
        index = tuple(int(i) for i in index)
        gshape = self.global_shape(name)
        if len(index) != len(gshape):
            raise InvalidArgumentError(
                f"Point index {index} has {len(index)} entries; field "
                f"{name!r} is {len(gshape)}-D (global shape {gshape}).")
        box = tuple((i, i + 1) for i in index)
        return self.read_global(name, box)[(0,) * len(index)]

    def __repr__(self) -> str:  # operator-friendly
        return (f"Snapshot({self.path!r}, step={self.step}, "
                f"fields={self.names})")


def open_snapshot(dirpath) -> Snapshot:
    """Open one committed snapshot (or `save_checkpoint_sharded`)
    directory for lazy box reads."""
    return Snapshot(dirpath)


def list_snapshots(root) -> list:
    """The COMMITTED snapshots under ``root``, as ``(step, path)`` sorted
    by step. Staged ``.tmp-``/``.old-`` directories (an interrupted
    writer's leftovers) and directories without a ``meta.npz`` commit
    record are never listed — an uncommitted snapshot does not exist."""
    root = os.fspath(root)
    if not os.path.isdir(root):
        raise InvalidArgumentError(f"Snapshot root not found: {root}")
    out = []
    for entry in sorted(os.listdir(root)):
        if not entry.startswith(STEP_PREFIX) or ".tmp-" in entry \
                or ".old-" in entry:
            continue
        path = os.path.join(root, entry)
        if not os.path.isdir(path) \
                or not os.path.exists(os.path.join(path, "meta.npz")):
            continue
        try:
            step = int(entry[len(STEP_PREFIX):])
        except ValueError:
            continue
        out.append((step, path))
    out.sort()
    return out
