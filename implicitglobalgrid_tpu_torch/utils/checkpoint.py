"""Checkpoint and resume of a run's state.

Counterpart of `implicitglobalgrid_tpu/utils/checkpoint.py`, in its container
format (`utils/blockio.py`): a checkpoint or snapshot written by either
package is read by the other, bit for bit. Two formats:

- **Single-file** (`save_checkpoint` / `restore_checkpoint`): one `.npz`
  holding the GATHERED whole-grid stacked arrays (through `ops.gather`, to
  ``root``) and the grid topology (``nxyz``, ``dims``, ``overlaps``,
  ``periods``, ``halowidths``).
- **Sharded** (`save_checkpoint_sharded` / `restore_checkpoint_sharded`): a
  DIRECTORY in which every process writes the blocks of its box to
  ``shards_p<rank>.npz``, each keyed by that block's starts in the whole
  grid's stacked array (``coords * local``: the keys of the JAX package's
  per-device shards), and process 0 writes ``meta.npz``. Restore reads
  only the blocks of this process's box, whichever process wrote them.
  Atomic at the directory level (staged into ``<dir>.tmp-<token>``, one
  rename), every file checked against its sha256 sidecar before use.
- `restore_checkpoint_elastic` restores onto a grid whose ``dims`` differ
  from the saved ones (the same implicit global grid, re-blocked).

Every restore returns this process's box of each array on the grid's device,
as `device_put_g` gives it. Save and restore are collective where a process
group is up: every process must call them.
Each save and restore records its latency in the metrics registry and the
flight recorder (`telemetry.hooks.observe_checkpoint`), at the JAX package's
places.

**Member axes.** The JAX package records the leading replicated axes of an
ensemble's array (`models.common.ensemble_state`) from its sharding, as
``lead__<name>``; a tensor carries no sharding, so the port reads them from
the shape (`member_axes`): an array of more than 3 axes leads with ``ndim -
3`` member axes, and an array of 3 axes or fewer is a solo field when its
axes are blocks of this grid, or one member axis ahead of a field of the
grid's rank (a 2-D grid's ``(E, x, y)``) when those are; where both readings
fit, or neither does, the rule cannot decide and raises
`InvalidArgumentError`. A solo field is never read as an ensemble's.

**bfloat16.** numpy has no bfloat16: the JAX package's npz member of a
bfloat16 block is the 2-byte void type that `np.savez` makes of an
`ml_dtypes.bfloat16` array, with ``dtype__<name>`` ``"bfloat16"``. The port
writes the same member (through `ml_dtypes` where it imports, else as a
``V2`` view of the same bytes) and reads such blocks back by a byte view
(int16 -> `torch.bfloat16`), never by a cast.
"""

from __future__ import annotations

import itertools
import os
import time

import numpy as np

from ..parallel.topology import NDIMS, check_initialized, global_grid
from .blockio import (
    ARR_PREFIX as _ARR_PREFIX,
    META_PREFIX as _META_PREFIX,
    block_scanner as _block_scanner,
    commit_staged_dir as _commit_staged_dir,
    grid_meta as _grid_meta,
    load_prefixed_meta as _load_meta,
    shard_key as _shard_key,
    validate_block_keys as _validate_block_keys,
    verify_checksum as _verify_checksum,
    write_npz_synced as _write_npz_synced,
)
from .exceptions import IncoherentArgumentError, InvalidArgumentError

__all__ = ["save_checkpoint", "restore_checkpoint", "load_checkpoint",
           "save_checkpoint_sharded", "restore_checkpoint_sharded",
           "restore_checkpoint_elastic", "saved_topology",
           "elastic_local_size", "AxisRedistribution", "member_axes"]


# ---------------------------------------------------------------------------
# Host arrays of tensors and back; member axes; the blocks of a box
# ---------------------------------------------------------------------------

def dtype_name(t) -> str:
    """The JAX package's name of tensor ``t``'s dtype ("float32", "bfloat16")."""
    return str(t.dtype).removeprefix("torch.")


def host_array(t) -> np.ndarray:
    """A complete host numpy copy of tensor ``t`` (never a view of it: the
    runner may overwrite ``t`` next); bfloat16 as the JAX package's npz
    member (`ml_dtypes.bfloat16`, or without it a ``V2`` view of the same
    bytes)."""
    import torch

    h = t.detach().to("cpu", copy=True)
    if h.dtype != torch.bfloat16:
        return h.numpy()
    raw = h.contiguous().view(torch.int16).numpy()
    try:
        import ml_dtypes
    except ImportError:
        return raw.view(np.dtype("V2"))
    return raw.view(ml_dtypes.bfloat16)


def carrier(block, name: str) -> np.ndarray:
    """``block`` (as a container holds it) in the numpy dtype the port
    assembles dtype ``name`` in: bfloat16 as its int16 bytes, every other
    dtype as itself."""
    block = np.asarray(block)
    if name == "bfloat16":
        if block.dtype.itemsize != 2:
            raise IncoherentArgumentError(
                f"A bfloat16 block is stored as {block.dtype} ({block.dtype.itemsize} bytes "
                "a cell); the container is not a bfloat16 save.")
        return np.ascontiguousarray(block).view(np.int16)
    want = np.dtype(name)
    return block if block.dtype == want else block.astype(want)


def tensor_of(a: np.ndarray, name: str):
    """The CPU tensor of dtype ``name`` holding `carrier` array ``a``."""
    import torch

    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise InvalidArgumentError(f"Unknown dtype {name!r} in the container.")
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.view(torch.bfloat16) if dt == torch.bfloat16 else t


def _fits(shape, per, gg) -> bool:
    """Whether every axis of ``shape`` is ``per[d]`` blocks of a local size
    within the field tolerance of ``nxyz[d]`` (`ops.fields.local_shape_of`'s)."""
    if not 1 <= len(shape) <= NDIMS:
        return False
    for d, s in enumerate(shape):
        k, n = int(per[d]), int(gg.nxyz[d])
        if int(s) % k or abs(int(s) // k - n) > int(gg.overlaps[d]) + 1:
            return False
    return True


def member_axes(shape, *, whole: bool = False, name: str = "the array") -> int:
    """The leading member axes of a stacked array of ``shape`` (the rule of
    the module docstring): this process's box, or with ``whole`` the whole
    grid's stacked array. Raises `InvalidArgumentError` where the rule
    cannot decide."""
    gg = global_grid()
    shape = tuple(int(s) for s in shape)
    if len(shape) > NDIMS:
        return len(shape) - NDIMS
    per = gg.dims if whole else gg.box
    grid_rank = 3 if int(gg.nxyz[2]) > 1 else (2 if int(gg.nxyz[1]) > 1 else 1)
    solo = _fits(shape, per, gg)
    member = len(shape) - 1 == grid_rank and _fits(shape[1:], per, gg)
    if solo != member:
        return int(member)
    raise InvalidArgumentError(
        f"Cannot tell whether {name} of shape {shape} leads with a member axis: "
        + ("it reads both as a solo field and as an ensemble of this grid's fields."
           if solo else "it is no stacked field of this grid, solo or an ensemble's."))


def _writes_blocks(gg, nsp: int) -> bool:
    """Whether this process writes its blocks of a field of ``nsp`` physical
    axes: the field is replicated over the grid's other dims, and only the
    copy at coordinate 0 along them is written (the JAX package writes
    replica 0 alone)."""
    return all(int(gg.coords[d]) == 0 for d in range(nsp, NDIMS))


def box_blocks(gg, lead_shape, loc):
    """``(key starts, box slices, box position)`` of every block of this
    process's box of a field with member axes ``lead_shape`` (whole in every
    block) and physical local shape ``loc``; starts in the whole grid's
    stacked array (``coords * loc``), the JAX package's shard starts."""
    nl = len(lead_shape)
    for p in itertools.product(*(range(int(gg.box[d])) for d in range(len(loc)))):
        starts = (0,) * nl + tuple((int(gg.coords[d]) + p[d]) * int(loc[d])
                                   for d in range(len(loc)))
        sl = (slice(None),) * nl + tuple(slice(p[d] * int(loc[d]), (p[d] + 1) * int(loc[d]))
                                         for d in range(len(loc)))
        yield starts, sl, p


def box_host_blocks(t, lead: int, gg):
    """``({key starts: host block}, whole-grid stacked shape)`` of this
    process's blocks of box tensor ``t`` (``lead`` member axes): ONE
    complete host copy of ``t`` (`host_array`), its blocks views of that
    copy; none where another process writes this replicated field's blocks
    (`_writes_blocks`)."""
    shape = tuple(int(s) for s in t.shape)
    loc = tuple(shape[lead + d] // int(gg.box[d]) for d in range(len(shape) - lead))
    whole = shape[:lead] + tuple(int(gg.dims[d]) * loc[d] for d in range(len(loc)))
    if not _writes_blocks(gg, len(loc)):
        return {}, whole
    host = host_array(t)
    return {starts: host[sl] for starts, sl, _ in box_blocks(gg, shape[:lead], loc)}, whole


def _box_tensor(gg, name, shape, dtype, lead, fetch):
    """This process's box of field ``name`` (whole-grid stacked ``shape``,
    ``lead`` member axes) on the grid's device, each block ``fetch(key)``."""
    loc = tuple(shape[lead + d] // int(gg.dims[d]) for d in range(len(shape) - lead))
    out = None
    for starts, sl, _ in box_blocks(gg, shape[:lead], loc):
        block = carrier(fetch(_shard_key(name, starts)), dtype)
        if out is None:
            out = np.empty(shape[:lead] + tuple(int(gg.box[d]) * loc[d]
                                                for d in range(len(loc))), block.dtype)
        out[sl] = block
    return tensor_of(out, dtype).to(gg.device)


def _box_of(gg, A, lead: int):
    """This process's box of whole-grid stacked host array ``A``."""
    sl = [slice(None)] * A.ndim
    for d in range(A.ndim - lead):
        n = A.shape[lead + d] // int(gg.dims[d])
        sl[lead + d] = slice(int(gg.coords[d]) * n, (int(gg.coords[d]) + int(gg.box[d])) * n)
    return A[tuple(sl)]


# ---------------------------------------------------------------------------
# Single-file checkpoints
# ---------------------------------------------------------------------------

def _gather_host(v, root: int, lead: int):
    """The whole grid's stacked host array of box tensor ``v`` on ``root``
    (None elsewhere), member by member; bfloat16 as its bytes."""
    import torch

    from ..ops.gather import gather

    bf16 = v.dtype == torch.bfloat16
    src = v.view(torch.int16) if bf16 else v
    if lead:
        parts = [_gather_host(src[m], root, lead - 1) for m in range(int(src.shape[0]))]
        out = None if parts[0] is None else np.stack(parts)
    else:
        out = gather(src, root=root)
    if out is None or not bf16:
        return out
    try:
        import ml_dtypes
    except ImportError:
        return out.view(np.dtype("V2"))
    return out.view(ml_dtypes.bfloat16)


def _observe(op: str, t0: float, **fields) -> None:
    """The operation's latency since ``t0`` to the metrics registry and the
    flight recorder (`telemetry.hooks.observe_checkpoint`, the JAX
    package's calls at the same places)."""
    from ..telemetry.hooks import observe_checkpoint

    observe_checkpoint(op, time.monotonic() - t0, **fields)


def save_checkpoint(path, state: dict, *, step: int | None = None,
                    root: int = 0) -> None:
    """Write ``state`` (a dict name -> stacked tensor, this process's box)
    and the grid topology to ``path`` (.npz). Collective where a process
    group is up; only process ``root`` writes the file, atomically (fsync'ed
    tmp file + rename). An ensemble's tensors are gathered member by member
    (`member_axes`)."""
    import torch

    from .timing import barrier

    check_initialized()
    t0 = time.monotonic()
    if not isinstance(state, dict) or not state:
        raise InvalidArgumentError(
            "save_checkpoint expects a non-empty dict of name -> array.")
    for k in state:
        if not isinstance(k, str) or k.startswith("__igg_"):
            raise InvalidArgumentError(
                f"Invalid state key {k!r}: keys must be strings not starting "
                "with '__igg_'.")
    gg = global_grid()
    hosts = {}
    for k, v in state.items():
        v = torch.as_tensor(v, device=gg.device)
        hosts[k] = _gather_host(v, root, member_axes(v.shape, name=k))
    if gg.me == root:
        payload = {f"{_ARR_PREFIX}{k}": v for k, v in hosts.items()}
        payload.update(_grid_meta(gg))
        if step is not None:
            payload[f"{_META_PREFIX}step"] = np.int64(step)
        tmp = f"{path}.tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    # every process returns after the write, so a restore that follows
    # never reads a missing file
    barrier()
    _observe("save", t0, path=path, step=step)


def load_checkpoint(path):
    """Read a checkpoint file: ``(state, meta)`` with ``state`` a dict of
    numpy arrays (the whole grid's stacked layout; bfloat16 as the
    container's 2-byte members) and ``meta`` the saved topology (nxyz, dims,
    overlaps, periods, halowidths, step|None). Host-only: needs no grid."""
    if not os.path.exists(path):
        raise InvalidArgumentError(f"Checkpoint file not found: {path}")
    with np.load(path) as z:
        state = {k[len(_ARR_PREFIX):]: z[k] for k in z.files
                 if k.startswith(_ARR_PREFIX)}
        meta = {k[len(_META_PREFIX):]: z[k] for k in z.files
                if k.startswith(_META_PREFIX)}
    meta["step"] = int(meta["step"]) if "step" in meta else None
    return state, meta


def _validate_topology(meta: dict, gg, strict: bool, required=()) -> None:
    """``required`` fields are validated even with ``strict=False`` (the
    sharded layout cannot reassemble across a different decomposition; the
    single-file path can, hence its escape hatch)."""
    for name in ("nxyz", "dims", "overlaps", "periods", "halowidths"):
        hard = name in required
        if not strict and not hard:
            continue
        saved = meta.get(name)
        live = np.asarray(getattr(gg, name))
        if saved is None or not np.array_equal(np.asarray(saved), live):
            hint = ("Re-init the grid to match (sharded restore cannot "
                    "reshard; use the single-file restore_checkpoint, or "
                    "restore_checkpoint_elastic for a dims change)."
                    if hard else
                    "Re-init the grid to match or pass strict=False.")
            raise IncoherentArgumentError(
                f"Checkpoint topology mismatch for `{name}`: saved "
                f"{None if saved is None else list(np.asarray(saved))}, live "
                f"{list(live)}. {hint}")


def restore_checkpoint(path, *, strict: bool = True):
    """Load ``path`` and return ``(state, step)``: ``state`` a dict of this
    process's box of every array, on the grid's device. With ``strict``
    (default) the saved topology must match the live grid; ``strict=False``
    skips the check (resuming onto a different decomposition of the same
    stacked shapes is the caller's responsibility). Where the box is not
    the whole grid, `member_axes` reads an array's member axes from its
    shape."""
    check_initialized()
    t0 = time.monotonic()
    gg = global_grid()
    state, meta = load_checkpoint(path)
    _validate_topology(meta, gg, strict)
    out = {}
    for k, v in state.items():
        name = "bfloat16" if v.dtype.kind == "V" and v.dtype.itemsize == 2 else str(v.dtype)
        if not np.array_equal(gg.box, gg.dims):
            v = _box_of(gg, v, member_axes(v.shape, whole=True, name=k))
        out[k] = tensor_of(carrier(v, name), name).to(gg.device, copy=True)
    _observe("restore", t0, path=path, step=meta["step"])
    return out, meta["step"]


# ---------------------------------------------------------------------------
# Sharded checkpoints
# ---------------------------------------------------------------------------

def save_checkpoint_sharded(dirpath, state: dict, *, step: int | None = None) -> None:
    """Write ``state`` (a dict name -> stacked tensor, this process's box) to
    directory ``dirpath``: each process writes the blocks of its box,
    process 0 the meta. Collective; ATOMIC at the directory level (staged
    into ``<dirpath>.tmp-<token>`` with sha256 sidecars; the staging
    directory takes the final name once ``meta.npz`` commits the set).
    Replacing an existing checkpoint moves it aside first, so ``dirpath``
    is briefly absent during the swap: alternate two directories for a
    checkpoint that always exists. An ensemble's member axes
    (`member_axes`) are recorded as the JAX package records them,
    ``lead__<name>``."""
    import secrets

    import torch

    from .timing import barrier

    check_initialized()
    t0 = time.monotonic()
    _validate_block_keys(state, "save_checkpoint_sharded")
    gg = global_grid()
    payload, names, meta = {}, [], {}
    for k, v in state.items():
        v = torch.as_tensor(v, device=gg.device)
        lead = member_axes(v.shape, name=k)
        blocks, whole = box_host_blocks(v, lead, gg)
        names.append(k)
        meta[f"{_META_PREFIX}shape__{k}"] = np.asarray(whole, dtype=np.int64)
        meta[f"{_META_PREFIX}dtype__{k}"] = np.str_(dtype_name(v))
        if lead:
            meta[f"{_META_PREFIX}lead__{k}"] = np.int64(lead)
        for starts, block in blocks.items():
            payload[_shard_key(k, starts)] = block
    # One token per SAVE, process 0's, on every process: restore checks
    # every shard file against it, so blocks of two saves never mix. It
    # also names the staging directory all processes write into.
    token = gg.transport.broadcast_one_to_all(secrets.token_hex(16))
    stage = f"{dirpath}.tmp-{token}"
    os.makedirs(stage, exist_ok=True)
    payload[f"{_META_PREFIX}save_token"] = np.str_(token)
    _write_npz_synced(os.path.join(stage, f"shards_p{gg.me}.npz"), payload)
    # meta.npz is the COMMIT record of a complete shard set: every process
    # has written its file before process 0 writes it
    barrier()
    if gg.me == 0:
        meta.update(_grid_meta(gg))
        meta[f"{_META_PREFIX}names"] = np.asarray(names)
        meta[f"{_META_PREFIX}save_token"] = np.str_(token)
        meta[f"{_META_PREFIX}nprocs_files"] = np.int64(gg.transport.world)
        meta[f"{_META_PREFIX}checksums"] = np.str_("sha256")
        if step is not None:
            meta[f"{_META_PREFIX}step"] = np.int64(step)
        _write_npz_synced(os.path.join(stage, "meta.npz"), meta)
        _commit_staged_dir(stage, dirpath, token)
    # no process returns (and maybe starts the next save) before the commit
    barrier()
    _observe("save_sharded", t0, path=dirpath, step=step)


def _sharded_meta_and_files(dirpath):
    """The sharded restores' shared open: load ``meta.npz``, list exactly the
    shard files the save wrote (this process's first), token-check every
    one and checksum-verify this process's own up front (the others are
    verified when first scanned). Returns ``(meta, files,
    checksums_required, verified)``."""
    import glob as _glob

    meta = _load_meta(dirpath)
    checksums = "checksums" in meta
    pidx = global_grid().me
    # the meta records how many shard files the save wrote: read EXACTLY
    # those (a glob could pick up stale files of an earlier save)
    n_files = int(meta.get("nprocs_files", 0)) or len(
        _glob.glob(os.path.join(dirpath, "shards_p*.npz")))
    files = [os.path.join(dirpath, f"shards_p{i}.npz") for i in range(n_files)]
    missing = [f for f in files if not os.path.exists(f)]
    if not files or missing:
        raise InvalidArgumentError(
            f"Sharded checkpoint in {dirpath} is incomplete: expected "
            f"{n_files} shard file(s), missing {missing or 'all'}.")
    own = os.path.join(dirpath, f"shards_p{pidx}.npz")
    if own in files:
        files.remove(own)
        files.insert(0, own)
    # every file is token-checked up front (one tiny member each), so every
    # process fails alike on an interrupted save
    expect_token = str(meta["save_token"]) if "save_token" in meta else None
    token_key = f"{_META_PREFIX}save_token"
    if expect_token is not None:
        for path in files:
            try:
                with np.load(path) as z:
                    ftok = str(z[token_key]) if token_key in z.files else None
            except Exception as e:
                # an unreadable container: name the truncation if the
                # checksum disagrees, else the error
                _verify_checksum(path, required=checksums)
                raise IncoherentArgumentError(f"Unreadable shard file {path}: {e!r}") from e
            if ftok != expect_token:
                raise IncoherentArgumentError(
                    f"Shard file {path} belongs to a different save than "
                    "meta.npz (save-token mismatch) — the save was "
                    "interrupted; do not resume from this checkpoint.")
    verified = set()
    if own in files:
        _verify_checksum(own, required=checksums)
        verified.add(own)
    return meta, files, checksums, verified


def _meta_field(meta, name):
    """(whole-grid stacked shape, dtype name, member axes) of saved ``name``."""
    return (tuple(int(s) for s in meta[f"shape__{name}"]), str(meta[f"dtype__{name}"]),
            int(meta.get(f"lead__{name}", 0)))


def restore_checkpoint_sharded(dirpath, *, strict: bool = True, _preloaded=None):
    """Load a `save_checkpoint_sharded` directory: each process reads the
    blocks of its box (its own file first, the others scanned for the rest),
    every file verified against its checksum first. Returns ``(state,
    step)``, this process's box of every array on the grid's device.
    ``_preloaded``: an already opened `_sharded_meta_and_files` (the
    elastic restore's same-dims delegation)."""
    check_initialized()
    t0 = time.monotonic()
    gg = global_grid()
    meta, files, checksums, verified = (
        _preloaded if _preloaded is not None else _sharded_meta_and_files(dirpath))
    # nxyz and dims are required even with strict=False: blocks are keyed by
    # the saved decomposition (restore_checkpoint_elastic re-blocks)
    _validate_topology(meta, gg, strict, required=("nxyz", "dims"))
    names = [str(n) for n in meta["names"]]
    step = int(meta["step"]) if "step" in meta else None
    plans, wanted = {}, set()
    for name in names:
        shape, dtype, lead = plans[name] = _meta_field(meta, name)
        loc = tuple(shape[lead + d] // int(gg.dims[d]) for d in range(len(shape) - lead))
        wanted |= {_shard_key(name, starts) for starts, _, _ in box_blocks(gg, shape[:lead], loc)}
    find_block = _block_scanner(files, wanted, checksums, verified)
    out = {name: _box_tensor(gg, name, *plans[name], find_block) for name in names}
    _observe("restore_sharded", t0, path=dirpath, step=step)
    return out, step


# ---------------------------------------------------------------------------
# Elastic restore: the same implicit global grid, another decomposition
# ---------------------------------------------------------------------------

def saved_topology(dirpath) -> dict:
    """Host-only read of a sharded checkpoint's grid topology: ``{nxyz,
    dims, overlaps, periods, halowidths, step}``; needs no grid (the
    elastic restart reads it to size the grid it initializes)."""
    meta = _load_meta(dirpath)
    out = {name: np.asarray(meta[name], dtype=np.int64)
           for name in ("nxyz", "dims", "overlaps", "periods", "halowidths")}
    out["step"] = int(meta["step"]) if "step" in meta else None
    return out


def elastic_local_size(topo: dict, new_dims) -> tuple:
    """The LOCAL block size ``(nx, ny, nz)`` that decomposes the same
    implicit global grid as ``topo`` (a `saved_topology` record) over
    ``new_dims``; raises where the interior does not divide evenly."""
    nxyz = np.asarray(topo["nxyz"], dtype=np.int64)
    dims = np.asarray(topo["dims"], dtype=np.int64)
    ol = np.asarray(topo["overlaps"], dtype=np.int64)
    per = np.asarray(topo["periods"], dtype=np.int64)
    new_dims = np.asarray(new_dims, dtype=np.int64)
    nxyz_g = dims * (nxyz - ol) + ol * (per == 0)
    out = []
    for d in range(3):
        interior = int(nxyz_g[d]) - (int(ol[d]) if not per[d] else 0)
        nd = int(new_dims[d])
        if nd < 1 or interior % nd:
            raise IncoherentArgumentError(
                f"Cannot redistribute dimension {d}: global interior "
                f"{interior} does not divide evenly over new dims[{d}]="
                f"{nd}.")
        out.append(interior // nd + int(ol[d]))
    return tuple(out)


class AxisRedistribution:
    """Per-dimension owner maps of the elastic re-blocking (the JAX
    package's): ``c_of[p]`` / ``i_of[p]`` give the saved block and its
    local index owning physical cell ``p`` (the `gather_interior`
    convention), `new_phys(c)` the physical index of every local cell of
    live block ``c``; so ``new_block[i] = saved_block[c_of[g[i]]][i_of[g[i]]]``
    with ``g = new_phys(c)``. Overlap cells come from their interior owner,
    so a checkpoint with exchange-fresh halos restores bitwise the gathered
    field laid out over the new decomposition."""

    def __init__(self, n_old: int, n_new: int, dd_old: int, dd_new: int,
                 ol_f: int, per: bool):
        s_o, s_n = n_old - ol_f, n_new - ol_f
        if per:
            ng_o, ng_n = dd_old * s_o, dd_new * s_n
        else:
            ng_o, ng_n = dd_old * s_o + ol_f, dd_new * s_n + ol_f
        if ng_o != ng_n:
            raise IncoherentArgumentError(
                f"Elastic restore: saved axis covers {ng_o} global cells, "
                f"the live one {ng_n} — the decompositions describe "
                "different global grids (staggering changed?).")
        self.ng = ng_o
        p = np.arange(self.ng)
        if per:
            c = p // s_o
            i = p - c * s_o + 1
        else:
            c = np.minimum(p // s_o, dd_old - 1)
            i = p - c * s_o
        self.c_of, self.i_of = c, i
        self._s_n, self._n_new, self._per = s_n, n_new, per

    def new_phys(self, c: int) -> np.ndarray:
        i = np.arange(self._n_new)
        if self._per:
            return (c * self._s_n + i - 1) % self.ng
        return c * self._s_n + i


class _IdentityAxis:
    """A member axis: never decomposed, every cell at its own index in
    saved 'block' 0."""

    def __init__(self, n: int):
        self.ng = int(n)
        self.c_of = np.zeros(self.ng, dtype=np.int64)
        self.i_of = np.arange(self.ng)

    def new_phys(self, c: int) -> np.ndarray:
        return np.arange(self.ng)


def restore_checkpoint_elastic(dirpath):
    """Restore a `save_checkpoint_sharded` directory onto a grid whose
    ``dims`` differ from the saved ones: every block of this process's box
    is assembled from the saved blocks covering its physical cells, and
    each process reads only those. Needs equal ``overlaps`` / ``periods`` /
    ``halowidths`` and the same implicit global size (`elastic_local_size`
    gives the local size to init with); a live grid equal to the saved one
    delegates to `restore_checkpoint_sharded`. Member axes pass through
    untouched. Returns ``(state, step)``."""
    check_initialized()
    t0 = time.monotonic()
    gg = global_grid()
    meta, files, checksums, verified = _sharded_meta_and_files(dirpath)
    names = [str(n) for n in meta["names"]]
    step = int(meta["step"]) if "step" in meta else None
    dims_o = np.asarray(meta["dims"], dtype=np.int64)
    nxyz_o = np.asarray(meta["nxyz"], dtype=np.int64)
    if np.array_equal(dims_o, np.asarray(gg.dims)) and \
            np.array_equal(nxyz_o, np.asarray(gg.nxyz)):
        return restore_checkpoint_sharded(
            dirpath, _preloaded=(meta, files, checksums, verified))
    for field in ("overlaps", "periods", "halowidths"):
        if not np.array_equal(np.asarray(meta[field]), np.asarray(getattr(gg, field))):
            raise IncoherentArgumentError(
                f"Elastic restore requires equal `{field}` (saved "
                f"{list(np.asarray(meta[field]))}, live "
                f"{list(np.asarray(getattr(gg, field)))}): only the "
                "decomposition may change.")
    ol = np.asarray(gg.overlaps, dtype=np.int64)
    per = np.asarray(gg.periods, dtype=np.int64)
    saved_g = dims_o * (nxyz_o - ol) + ol * (per == 0)
    if not np.array_equal(saved_g, np.asarray(gg.nxyz_g)):
        raise IncoherentArgumentError(
            f"Elastic restore: saved implicit global grid {list(saved_g)} "
            f"differs from the live one {list(np.asarray(gg.nxyz_g))}; "
            "re-init with elastic_local_size(saved_topology(dir), dims).")

    # per field: for each block of this process's box, the saved blocks
    # covering its physical cells and the index maps placing them
    plans, wanted = {}, set()
    for name in names:
        shape_o, dtype, lead = _meta_field(meta, name)
        nd = len(shape_o)
        loc_o, loc_n, axes = [], [], []
        for d in range(nd):
            if d < lead:
                axes.append(_IdentityAxis(shape_o[d]))
                loc_o.append(shape_o[d])
                loc_n.append(shape_o[d])
                continue
            sd = d - lead
            dd_o = int(dims_o[sd])
            if shape_o[d] % dd_o:
                raise IncoherentArgumentError(
                    f"Saved stacked size {shape_o[d]} of `{name}` along "
                    f"dimension {sd} is not divisible by the saved "
                    f"dims[{sd}]={dd_o}.")
            lo = shape_o[d] // dd_o
            stag = lo - int(nxyz_o[sd])     # staggered fields carry their
            ln = int(gg.nxyz[sd]) + stag    # extra cells to the new blocks
            axes.append(AxisRedistribution(lo, ln, dd_o, int(gg.dims[sd]),
                                           int(ol[sd]) + stag, bool(per[sd])))
            loc_o.append(lo)
            loc_n.append(ln)
        blockplans = []
        for _, sl, p in box_blocks(gg, shape_o[:lead], loc_n[lead:]):
            c = (0,) * lead + tuple(int(gg.coords[d]) + p[d] for d in range(nd - lead))
            per_axis = []
            for d in range(nd):
                g = axes[d].new_phys(c[d])
                per_axis.append((axes[d].c_of[g], axes[d].i_of[g]))
            pieces = []
            for co in itertools.product(*[np.unique(pa[0]) for pa in per_axis]):
                sel_new, sel_old = [], []
                for d in range(nd):
                    c_of, i_of = per_axis[d]
                    jj = np.nonzero(c_of == co[d])[0]
                    sel_new.append(jj)
                    sel_old.append(i_of[jj])
                key = _shard_key(name, tuple(int(co[d]) * loc_o[d] for d in range(nd)))
                pieces.append((key, sel_new, sel_old))
                wanted.add(key)
            blockplans.append((sl, pieces))
        box_shape = tuple(loc_n[:lead]) + tuple(int(gg.box[d]) * loc_n[lead + d]
                                                for d in range(nd - lead))
        plans[name] = (dtype, tuple(loc_n), box_shape, blockplans)

    # pop=False: one saved block can source several live blocks
    find_block = _block_scanner(files, wanted, checksums, verified, pop=False)
    out = {}
    for name in names:
        dtype, loc_n, box_shape, blockplans = plans[name]
        box = None
        for sl, pieces in blockplans:
            block = None
            for key, sel_new, sel_old in pieces:
                src = carrier(find_block(key), dtype)
                if block is None:
                    block = np.empty(loc_n, src.dtype)
                block[np.ix_(*sel_new)] = src[np.ix_(*sel_old)]
            if box is None:
                box = np.empty(box_shape, block.dtype)
            box[sl] = block
        out[name] = tensor_of(box, dtype).to(gg.device)
    _observe("restore_elastic", t0, path=dirpath, step=step,
             saved_dims=[int(d) for d in dims_o],
             live_dims=[int(d) for d in np.asarray(gg.dims)])
    return out, step
