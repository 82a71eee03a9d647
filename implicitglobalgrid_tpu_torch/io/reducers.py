"""In-situ reducers: probes, axis slices and global stats behind one sum.

Counterpart of `implicitglobalgrid_tpu/io/reducers.py`. The analysis
questions a long run asks at every chunk boundary (the value at a sensor
point, a centerline, whether the max is still bounded) need O(1)..O(axis)
numbers; these reducers compute them over the IMPLICIT grid after each chunk
(`make_state_runner(post_chunk=...)`, the health guard's hook). Every block
of a process's box masks the cells it OWNS (`io/layout.py`: the
`gather_interior` ownership, overlap cells counted once, periodic ghosts
left out) and contributes to a small float32 vector; ONE
`transport.all_sum`, shared with the health guard's stats, adds the
processes' vectors. The JAX package's shards find their owner through
`lax.axis_index`; here each block's global coordinate is the box's first
rank (``gg.coords``) plus its position in the box.

The vector is the JAX package's entry for entry, so `ReducerPlan.decode` is
JAX's. Global min/max ride the same sum by the slot trick: each block
writes its masked min/max into ITS slot (its rank) of a ``prod(dims)``-long
segment and the host reduces over slots. A probe, a slice, a min and a max
are one owner's value plus exact zeros, so they match JAX's bitwise; sums
and sums of squares are float32 sums in another order (a relative
tolerance).

Reducer species (field names refer to the supervised state):

- `Probe(field, index)`: one global cell's value at each chunk boundary;
- `AxisSlice(field, axis, index)`: the 1-D line along ``axis`` through the
  global anchor ``index`` (``index[axis]`` is ignored);
- `Stats(field, which=("min", "max", "mean", "rms"))`: exact global stats
  over the implicit grid (float32 accumulation, as the health guard's).
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field as dc_field

import numpy as np

from ..parallel.topology import NDIMS, global_grid
from ..utils.exceptions import InvalidArgumentError
from .layout import field_geometry, global_shape_of, owner_maps

__all__ = ["Probe", "AxisSlice", "Stats", "ReducerPlan",
           "build_reducer_plan", "make_reduced_post_chunk"]

_STATS_KINDS = ("min", "max", "mean", "rms")


@dataclass(frozen=True)
class Probe:
    """Value of one IMPLICIT-global cell of ``field`` (staggering
    included: indices address `gather_interior(field)`'s coordinates)."""
    field: str
    index: tuple
    name: str | None = None

    def __post_init__(self):
        object.__setattr__(self, "index",
                           tuple(int(i) for i in self.index))

    @property
    def label(self) -> str:
        return self.name or f"probe:{self.field}@" + \
            ",".join(str(i) for i in self.index)


@dataclass(frozen=True)
class AxisSlice:
    """The 1-D line of ``field`` along ``axis`` through the global anchor
    ``index`` (whose ``axis`` entry is ignored)."""
    field: str
    axis: int
    index: tuple
    name: str | None = None

    def __post_init__(self):
        object.__setattr__(self, "index",
                           tuple(int(i) for i in self.index))

    @property
    def label(self) -> str:
        anchor = ",".join("_" if d == self.axis else str(i)
                          for d, i in enumerate(self.index))
        return self.name or f"slice:{self.field}[{self.axis}]@{anchor}"


@dataclass(frozen=True)
class Stats:
    """Global scalar statistics of ``field`` over the implicit grid."""
    field: str
    which: tuple = dc_field(default=_STATS_KINDS)
    name: str | None = None

    def __post_init__(self):
        object.__setattr__(self, "which", tuple(self.which))
        bad = [w for w in self.which if w not in _STATS_KINDS]
        if bad or not self.which:
            raise InvalidArgumentError(
                f"Stats.which entries must be among {_STATS_KINDS}; "
                f"got {tuple(self.which)}.")

    @property
    def label(self) -> str:
        return self.name or f"stats:{self.field}"


class ReducerPlan:
    """The layout of a reducer set: each reducer's segment of the chunk
    stats vector, the function that computes this process's part, and the
    host-side decoder. Built per grid (`build_reducer_plan`): the ownership
    geometry depends on the decomposition."""

    def __init__(self, entries, signature, nprocs: int):
        self._entries = entries          # [(reducer, offset, length, geoms)]
        self.signature = signature       # hashable: the geometry and specs
        self.nprocs = int(nprocs)        # min/max slot count at build time
        self.length = sum(e[2] for e in entries)
        self.labels = [e[0].label for e in entries]
        dup = {l for l in self.labels if self.labels.count(l) > 1}
        if dup:
            raise InvalidArgumentError(
                f"Duplicate reducer label(s) {sorted(dup)}: give the "
                "colliding reducers distinct name=...")

    def local_parts(self, state_names, state, members: int | None = None):
        """This process's contribution vector before the sum: float32 on
        the state's device, length `self.length` (``(members, length)`` for
        an ensemble's state, whose tensors lead with the member axis).
        ``state`` is the tuple of box tensors in ``state_names`` order."""
        import torch

        gg = global_grid()
        by_name = dict(zip(state_names, state))
        parts = []
        for red, _off, _ln, geoms in self._entries:
            x = by_name[red.field].float()
            if x.dim() != len(geoms) + (members is not None):
                raise InvalidArgumentError(
                    f"Reducer {red.label!r}: field {red.field!r} has shape "
                    f"{tuple(x.shape)}, the plan a {len(geoms)}-D field"
                    + ("" if members is None else f" with {members} members") + ".")
            if isinstance(red, Probe):
                parts.append(_probe_part(x, red, geoms, gg))
            elif isinstance(red, AxisSlice):
                parts.append(_slice_part(x, red, geoms, gg))
            else:
                parts.append(_stats_part(x, geoms, gg))
        return torch.cat(parts, dim=-1)

    # -- host side ---------------------------------------------------------

    def decode(self, tail) -> dict:
        """label -> value(s), from the summed vector's reducer tail (host)."""
        if hasattr(tail, "detach"):
            tail = tail.detach().cpu().numpy()
        tail = np.asarray(tail)
        if tail.shape != (self.length,):
            raise InvalidArgumentError(
                f"Reducer tail has shape {tail.shape}; the plan expects "
                f"({self.length},).")
        out = {}
        P = self.nprocs
        for red, off, ln, geoms in self._entries:
            seg = tail[off:off + ln]
            if isinstance(red, Probe):
                out[red.label] = float(seg[0])
            elif isinstance(red, AxisSlice):
                out[red.label] = np.array(seg)
            else:
                count = float(np.prod(global_shape_of(geoms)))
                vals = {"min": float(np.min(seg[2:2 + P])),
                        "max": float(np.max(seg[2 + P:2 + 2 * P])),
                        "mean": float(seg[0]) / count,
                        "rms": math.sqrt(max(float(seg[1]), 0.0) / count)}
                out[red.label] = {w: vals[w] for w in red.which}
        return out


# ---------------------------------------------------------------------------
# This process's contributions (every block of its box, before the sum)
# ---------------------------------------------------------------------------

def _blocks(gg, d: int) -> tuple:
    """(blocks of the box along field axis ``d``, the first one's global
    coordinate); axes beyond the grid's are one unsharded block."""
    return (int(gg.box[d]), int(gg.coords[d])) if d < NDIMS else (1, 0)


def _replica_guard(gg, rank: int) -> float:
    """Fields of rank < 3 are replicated over the grid's other dims: only
    the copy at coordinate 0 along them contributes, or the sum would
    multiply sums and probes by the replica count."""
    return float(all(int(gg.coords[d]) == 0 for d in range(rank, NDIMS)))


def _at(x, idx):
    """``x[..., I0, I1, ...]`` with ``idx[d]`` (1-D numpy) broadcast along
    axis ``d`` of the field's axes: shape ``(*lead, len(idx[0]), ...)``."""
    import torch

    r = len(idx)
    ix = tuple(torch.as_tensor(np.asarray(i).reshape([-1 if k == d else 1 for k in range(r)]),
                               device=x.device) for d, i in enumerate(idx))
    return x[(Ellipsis,) + ix]


def _anchor(gg, geoms, index, dims_sel):
    """Per dim of ``dims_sel``: the local index of the anchor cell in every
    block of the box, and the 0/1 mask of the block that owns it (the JAX
    package's `_is_owner`: only the grid's dims mask)."""
    out = {}
    for d in dims_sel:
        c, i = owner_maps(geoms[d], np.asarray([index[d]]))
        B, f = _blocks(gg, d)
        own = (f + np.arange(B) == int(c[0])) if d < NDIMS else np.ones(B, bool)
        out[d] = (np.arange(B) * geoms[d].n + int(i[0]), own.astype(np.float32))
    return out


def _mask_of(masks, rank, x):
    """The outer product of 1-D masks (``None``: axis kept whole), shaped to
    broadcast against the field axes of ``x``."""
    import torch

    m = np.ones([1] * rank, np.float32)
    for d, md in masks.items():
        m = m * md.reshape([-1 if k == d else 1 for k in range(rank)])
    return torch.as_tensor(m, device=x.device)


def _probe_part(x, red: Probe, geoms, gg):
    rank = len(geoms)
    at = _anchor(gg, geoms, red.index, range(rank))
    vals = _at(x, [at[d][0] for d in range(rank)])
    mine = _mask_of({d: at[d][1] for d in range(rank)}, rank, x)
    val = (vals * mine).sum(dim=tuple(range(-rank, 0)))
    return (val * _replica_guard(gg, rank)).unsqueeze(-1)


def _own_1d(geom, B: int, first: int, d: int):
    """(ownership mask, global cell) of every local cell of the box's
    blocks along dim ``d``, block-major (``B * n`` entries)."""
    i = np.arange(geom.n)
    own, g = [], []
    for b in range(B):
        c = first + b if d < NDIMS else 0
        if geom.per:
            own.append((i >= 1) & (i <= geom.s))
            g.append((c * geom.s + i - 1) % geom.size)
        else:
            own.append(i < (geom.n if c == geom.dd - 1 or d >= NDIMS else geom.s))
            g.append(c * geom.s + i)
    return np.concatenate(own), np.concatenate(g)


def _slice_part(x, red: AxisSlice, geoms, gg):
    import torch

    rank, a = len(geoms), red.axis
    others = [d for d in range(rank) if d != a]
    at = _anchor(gg, geoms, red.index, others)
    B, f = _blocks(gg, a)
    idx = [np.arange(B * geoms[a].n) if d == a else at[d][0] for d in range(rank)]
    vals = _at(x, idx)
    mine = _mask_of({d: at[d][1] for d in others}, rank, x)
    line = (vals * mine).sum(dim=tuple(d - rank for d in others)) if others else vals
    own, g = _own_1d(geoms[a], B, f, a)
    contrib = line * torch.as_tensor(own.astype(np.float32), device=x.device) \
        * _replica_guard(gg, rank)
    out = torch.zeros(tuple(x.shape[:x.dim() - rank]) + (geoms[a].size,),
                      dtype=torch.float32, device=x.device)
    return out.index_add_(-1, torch.as_tensor(g, device=x.device), contrib)


def _stats_part(x, geoms, gg):
    import torch

    rank = len(geoms)
    nl = x.dim() - rank
    mask = None
    for d in range(rank):
        md = torch.as_tensor(_own_1d(geoms[d], *_blocks(gg, d), d)[0], device=x.device)
        md = md.reshape([-1 if k == d else 1 for k in range(rank)])
        mask = md if mask is None else mask & md
    axes = tuple(range(nl, x.dim()))
    guard = _replica_guard(gg, rank)
    ssum = torch.where(mask, x, 0.0).sum(dim=axes) * guard
    ssq = torch.where(mask, x * x, 0.0).sum(dim=axes) * guard
    # each block's masked min/max: the block axes (B_d, n_d) of the box
    Bs = [_blocks(gg, d)[0] for d in range(rank)]
    split = tuple(x.shape[:nl]) + tuple(v for d in range(rank) for v in (Bs[d], geoms[d].n))
    cells = tuple(nl + 2 * d + 1 for d in range(rank))
    mn = torch.where(mask, x, float("inf")).reshape(split).amin(dim=cells).reshape(
        tuple(x.shape[:nl]) + (-1,))
    mx = torch.where(mask, x, float("-inf")).reshape(split).amax(dim=cells).reshape(
        tuple(x.shape[:nl]) + (-1,))
    # slot trick: block r's min/max land in slot r alone (a field of rank <
    # 3 fills the slot of every replica, as each replica shard does in JAX)
    dims = [int(d) for d in gg.dims]
    P = dims[0] * dims[1] * dims[2]
    slot, src = [], []
    for pos in itertools.product(*(range(int(b)) for b in gg.box)):
        c = [int(gg.coords[d]) + pos[d] for d in range(NDIMS)]
        slot.append((c[0] * dims[1] + c[1]) * dims[2] + c[2])
        src.append(int(np.ravel_multi_index(pos[:rank], Bs)) if rank else 0)
    slot = torch.as_tensor(slot, device=x.device)
    src = torch.as_tensor(src, device=x.device)
    slots_mn = torch.zeros(tuple(x.shape[:nl]) + (P,), dtype=torch.float32, device=x.device)
    slots_mx = slots_mn.clone()
    slots_mn[..., slot] = mn[..., src]
    slots_mx[..., slot] = mx[..., src]
    return torch.cat([ssum.unsqueeze(-1), ssq.unsqueeze(-1), slots_mn, slots_mx], dim=-1)


# ---------------------------------------------------------------------------
# Plan building and the post-chunk hook
# ---------------------------------------------------------------------------

def build_reducer_plan(reducers, names, state) -> ReducerPlan:
    """Validate ``reducers`` against the supervised ``state`` (dict of name
    -> stacked tensor, this process's box; an ensemble's per member, without
    the member axis) on the LIVE grid and lay out their segments. Host-side
    and cheap; the geometry changes with the decomposition, so a plan
    serves one grid (its `signature` pins it)."""
    gg = global_grid()
    entries = []
    off = 0
    P = int(np.prod(np.asarray(gg.dims)))
    for red in reducers:
        if not isinstance(red, (Probe, AxisSlice, Stats)):
            raise InvalidArgumentError(
                f"Unknown reducer type {type(red).__name__}; use Probe, "
                "AxisSlice or Stats.")
        if red.field not in names:
            raise InvalidArgumentError(
                f"Reducer {red.label!r} names unknown field "
                f"{red.field!r} (state has {list(names)}).")
        shape = tuple(int(s) for s in state[red.field].shape)
        for d in range(min(len(shape), NDIMS)):
            if shape[d] % int(gg.box[d]):
                raise InvalidArgumentError(
                    f"Reducer {red.label!r}: field {red.field!r} of shape {shape} is not "
                    f"this process's box ({tuple(int(b) for b in gg.box)} blocks).")
        loc = [shape[d] // int(gg.box[d]) if d < NDIMS else shape[d]
               for d in range(len(shape))]
        geoms = field_geometry(gg.dims, gg.nxyz, gg.overlaps, gg.periods,
                               loc)
        gshape = global_shape_of(geoms)
        if isinstance(red, (Probe, AxisSlice)):
            if len(red.index) != len(gshape):
                raise InvalidArgumentError(
                    f"Reducer {red.label!r} index {red.index} has "
                    f"{len(red.index)} entries; field {red.field!r} is "
                    f"{len(gshape)}-D (global shape {gshape}).")
            for d, i in enumerate(red.index):
                free = isinstance(red, AxisSlice) and d == red.axis
                if not free and not 0 <= i < gshape[d]:
                    raise InvalidArgumentError(
                        f"Reducer {red.label!r} index {red.index} is "
                        f"outside the implicit global shape {gshape}.")
        if isinstance(red, AxisSlice):
            if not 0 <= red.axis < len(gshape):
                raise InvalidArgumentError(
                    f"AxisSlice axis {red.axis} is outside field "
                    f"{red.field!r}'s rank {len(gshape)}.")
            ln = geoms[red.axis].size
        elif isinstance(red, Probe):
            ln = 1
        else:
            ln = 2 + 2 * P
        entries.append((red, off, ln, geoms))
        off += ln
    # the signature pins the GEOMETRY too, not just the specs: owners and
    # strides depend on the field's local shape (its staggering)
    sig = tuple(
        (type(r).__name__, r.field,
         getattr(r, "axis", None), getattr(r, "index", None),
         getattr(r, "which", None), r.label, tuple(g))
        for r, _o, _l, g in entries)
    return ReducerPlan(entries, sig, P)


def make_reduced_post_chunk(names, plan: ReducerPlan):
    """The guard-and-reducer hook for `make_state_runner(post_chunk=)`: the
    health parts (`runtime.health.health_parts_local`) and the reducer
    parts in ONE vector, summed over the processes by ONE
    `transport.all_sum`. Slice the result: ``[:2*nfields]`` health,
    ``[2*nfields:]`` reducers (`ReducerPlan.decode`). An ensemble runner
    (``make_state_runner(ensemble=E)``) calls it with ``members=E``: the
    result is ``(E, 2N+R)``, one row a member, behind the same single sum;
    the plan is built over the per-member shapes."""
    names = tuple(names)

    def post_chunk(state, members: int | None = None):
        import torch

        from ..runtime.health import health_parts_local

        vec = torch.cat([health_parts_local(state, members),
                         plan.local_parts(names, state, members)], dim=-1)
        return global_grid().transport.all_sum(vec)

    return post_chunk
