"""Halo exchange: `update_halo` and `local_update_halo`.

Counterpart of `implicitglobalgrid_tpu/ops/halo.py`. Every rank's block of a
process's box is a view of one stacked tensor, so the "send/recv" of the JAX
package's per-axis `ppermute` becomes a tensor copy between block views
inside the box; along a dim split across processes (`topology.crosses`) the
blocks at the box's edges take their neighbours' slabs through the grid's
transport (`parallel.transport`). The exchange semantics are the JAX
package's, 0-based:

- send slab, right side: ``[s-ol, s-ol+hw)``; left: ``[ol-hw, ol)``
- recv slab, right side: ``[s-hw, s)``;       left: ``[0, hw)``
- a field participates along a dim iff ``ol(dim, A) >= 2*hw[dim]``
- dims are processed strictly in sequence (default z, x, y), so corner and
  edge values propagate across dims;
- non-periodic boundary ranks keep their halo values (PROC_NULL neighbours);
- a periodic axis with a single rank copies its own slabs (self-neighbour).

Tiers, in the JAX package's order (`halo_routes` names the tier each field
takes, and the groups of the coalesced tier by dim):

1. ``"self"``: every exchanging dim is self-neighbour; the whole exchange
   is one pass of K3 (`cuda_halo.halo_self_exchange`).
2. ``"coalesced"``: same-dtype fields, two or more, that exchange along a
   dim with more than one rank form one group on that dim
   (`_coalesce_groups`, ``coalesce``/``IGG_HALO_COALESCE``, on by default);
   per dim and group, K8 (`cuda_halo.wire_pack`) packs every block's send
   slabs of every field into the block's wire buffer on the canonical
   schema (`ops.wire`), and K7 (`cuda_halo.halo_write_multi`) writes every
   field's halos from the neighbour blocks' buffers: two launches a dim,
   whatever the field count. A grouped field skips the combined tier.
3. ``"combined"``: 3-D, z exchanging, halowidth 1 on y and z
   (`cuda_halo.combined_write_supported`); the slab pipeline
   (`exchange_recv_slabs`, one K4s launch per dim) then one K6 launch
   (`cuda_halo.halo_write_combined`) that writes every dim's halos.
4. ``"per_dim"``: each dim's halos written by K2 (`cuda_halo.halo_write`),
   one launch per (field, dim) for all ranks, from K4s's received slabs.

The whole-exchange kernels (K3, K6) need every ``IGG_USE_PALLAS`` flag on;
with a dim's flag off, that dim's packs, slabs and writes are plain PyTorch.

Across processes, each route computes every block's slabs of the box with
its kernels, then: K4s's moves stay inside the box (a non-periodic launch,
so an edge block keeps its own slab), a second K4s launch with the identity
moves gives every block's corner-patched send slabs, and `transport.
fill_edges` moves the edge blocks' ones between processes (`_recv_dim`);
the coalesced route sends K8's wire buffer rows and runs K7 with ``disp`` 0
on the rows each block reads (`transport.shift_rows`). The virtual mesh
takes none of these steps.

The wire (``wire_dtype``/``IGG_HALO_WIRE_DTYPE``, `ops.precision`): float
state may cross between blocks cast or quantized, per mesh axis. K4s's
received slabs go through `wire.SlabCodec` block by block (cast and back,
or each block's slab quantized against its own scale, with the corners
received along earlier dims already patched in) before K2, K6 or the
model's step kernel reads them; the coalesced route casts or codes K8's
staging rows (`WireSchema.encode_rows`) before K7 reads them; a quantized
field always takes the coalesced route, a single field too; a field the
wire touches skips the combined tier. A block on a PROC_NULL edge keeps
its current halo exact, and a self-neighbour dim ships no wire. Across
processes the payload crosses in the wire format (`parallel.transport`).
A staged axis (``wire_stage``/``IGG_HALO_WIRE_STAGE``) sends every
exchanging field down the coalesced route and moves the flat route's
halos; `halo_comm_plan` prices the staged stages.

An ensemble's fields (`models.common.ensemble_state`: a leading axis of E
members, ``local_update_halo(..., members=E)``; the JAX package vmaps its
exchange over them) take the coalesced route on every exchanging dim,
self-neighbour dims too: each dtype's fields, one or many, in one K8 and
one K7 launch a dim that carry every member (`WireSchema.members`), each
member's slabs quantized against their own scales under a quantized wire,
and one transport message a neighbour process and dim whatever E.
`halo_comm_plan(ensemble=E)` prices it as the JAX package does.

The halo writes are IN PLACE on the given tensor (on a contiguous copy of a
field that is not contiguous), while the self-exchange pass returns a new
one: always use the returned tensors, as with the JAX package (``T =
update_halo(T)``).

The exchange is labelled (``igg::update_halo``, `utils.profiling.label`)
in a profiler's trace, which `utils.profiling.overlap_stats` reads as
comm on the host; outside a capture the label costs a flag read.

Every `update_halo` call is charged to the telemetry (the
``igg_halo_*`` counters and a ``halo_exchange`` flight event) from its
static wire plan, the `halo_comm_plan` record of its signature, computed
once a signature; `local_update_halo`, the models' step-side form, charges
nothing (the JAX package's accounting).
Under a recording (`analysis.record.recording`, off by default: one test
of a module attribute a site) the routes record their LOGICAL exchange
for the communication audit: the per-dim route (`_exchange_dim`), the slab
pipeline of the combined and the fused routes (`exchange_recv_slabs_multi`)
and the coalesced route (`_exchange_dim_coalesced`, ensembles included)
each record one collective-permute a (group, dim, direction) with the
whole mesh's pairs and the wire payload, as the JAX package's program
carries them; a field copied dense first (`_dense`) is recorded as the
permutes' operand. The self-neighbour tier and self-neighbour dims record
nothing.
"""

from __future__ import annotations

import numpy as np

from ..analysis import record as _record
from ..parallel.topology import (
    NDIMS, axis_perm_pairs, check_initialized, crosses, global_grid,
)
from ..utils.exceptions import IncoherentArgumentError, InvalidArgumentError
from ..utils.profiling import label
from .fields import Field, check_fields, extract, wrap_field
from .precision import resolve_wire_dtype, wire_format_for
from .wire import (
    SlabCodec, StagedWireSchema, dtype_name, resolve_wire_stage, schema_for_fields,
)

__all__ = ["update_halo", "local_update_halo", "DEFAULT_DIMS_ORDER", "halo_route",
           "halo_routes", "halo_comm_plan", "resolve_halo_coalesce",
           "exchange_recv_slabs_multi", "exchange_recv_slabs"]

# Reference default `dims=(3,1,2)` (1-based: z, x, y).
DEFAULT_DIMS_ORDER = (2, 0, 1)


def _normalize_dims_order(dims):
    if dims is None:
        return DEFAULT_DIMS_ORDER
    out = tuple(int(d) for d in (dims if np.iterable(dims) else (dims,)))
    if any(d < 0 or d >= NDIMS for d in out):
        raise InvalidArgumentError(
            f"dims must contain 0-based dimension indices in [0, {NDIMS}); got {out}. "
            "(Note: this API is 0-based; the Julia reference's default (3,1,2) is (2,0,1) here.)"
        )
    return out


def resolve_halo_coalesce(coalesce=None) -> bool:
    """Whether multi-field exchanges pack one buffer per (axis, dtype
    group). An explicit argument wins; else ``IGG_HALO_COALESCE`` (default
    ON)."""
    if coalesce is not None:
        return bool(coalesce)
    import os

    v = os.environ.get("IGG_HALO_COALESCE")
    if v is None:
        return True
    try:
        return int(v) > 0
    except ValueError as e:
        raise InvalidArgumentError(
            f"Environment variable IGG_HALO_COALESCE: expected an integer, "
            f"got {v!r}.") from e


def _dim_meta(gg, dim: int):
    return int(gg.dims[dim]), bool(gg.periods[dim]), int(gg.disp)


def _box_locals(gg, shape) -> tuple:
    """The LOCAL block shape of a stacked tensor of this process's box."""
    return tuple(int(s) // int(gg.box[d]) for d, s in enumerate(shape))


def _ol(gg, shape, dim) -> int:
    return int(gg.overlaps[dim] + (shape[dim] - gg.nxyz[dim]))


def _dim_exchanges(gg, shape, hws, dim) -> bool:
    """Whether a field of this LOCAL ``shape`` exchanges along ``dim``."""
    if dim >= len(shape):
        return False
    D, periodic, disp = _dim_meta(gg, dim)
    if D == 1 and not periodic:
        return False
    if D > 1 and not periodic and disp >= D:
        return False
    return _ol(gg, shape, dim) >= 2 * int(hws[dim])


def _kernel_tier_enabled(gg, shape, dims_order) -> bool:
    """Gate of the whole-exchange kernel: default order, 3-D, every
    per-dim kernel flag on."""
    return (tuple(dims_order) == DEFAULT_DIMS_ORDER and len(shape) == 3
            and bool(gg.use_pallas.all()))


def _self_exchange_plan(gg, shape, hws, dims_order):
    """If every exchanging dim of a field of LOCAL ``shape`` is
    self-neighbour, return (modes, ols) for the one-pass kernel; else None
    (a mix with a multi-rank dim would break the strict dim sequencing)."""
    from .cuda_halo import self_exchange_supported

    if not _kernel_tier_enabled(gg, shape, dims_order):
        return None
    modes, ols = [False] * 3, [0] * 3
    for dim in range(3):
        D, periodic, disp = _dim_meta(gg, dim)
        ol_d = _ol(gg, shape, dim)
        if D == 1 and not periodic:
            continue
        if ol_d < 2 * int(hws[dim]):
            continue
        if D != 1 or not periodic or disp != 1:
            return None
        if ol_d > int(shape[dim]) - 1:
            return None
        modes[dim], ols[dim] = True, ol_d
    if not self_exchange_supported(shape, modes, hws):
        return None
    return tuple(modes), tuple(ols)


def _check_slab_fit(s, dim, ol_d, hw):
    if not (0 <= s - ol_d and ol_d - hw >= 0 and hw <= s):
        raise IncoherentArgumentError(
            f"Field of local size {s} along dimension {dim} cannot hold send slabs "
            f"(overlap {ol_d}, halowidth {hw})."
        )


def _moves(s, ol_d, hw, disp):
    """Where a block's received slabs come from along a dim (local size
    ``s``): recv_l of block t is send_r ``[s-ol, s-ol+hw)`` of block t-disp
    (the forward pairs of `axis_perm_pairs`), else its own current ``[0,
    hw)``; recv_r is send_l ``[ol-hw, ol)`` of block t+disp, else its own
    ``[s-hw, s)``."""
    from .cuda_stencil import Move

    return (Move(s - ol_d, 0, -disp), Move(ol_d - hw, s - hw, disp))


def _send_moves(moves):
    """Each block's own send slabs at the starts ``moves`` read: ``(send_r,
    send_l)``."""
    from .cuda_stencil import Move

    return tuple(Move(m.start, m.start, 0) for m in moves)


def _codecs(gg, dim, hw, got, shapes, wire):
    """``{f: SlabCodec}`` for the fields whose received slabs ``got`` cross
    the wire in a narrowed format along ``dim`` (none along a
    self-neighbour dim); ``shapes`` the fields' LOCAL block shapes."""
    if wire is None or int(gg.dims[dim]) == 1:
        return {}
    out = {}
    for f, pair in got.items():
        fmt = wire_format_for(pair[0].dtype, wire, dim)
        if fmt is not None:
            blk = list(shapes[f])
            blk[dim] = int(hw)
            out[f] = SlabCodec(fmt, blk, pair[0].dtype)
    return out


def _wire_inside(gg, dim, hw, got, codecs, periodic):
    """Pass the received slabs ``got`` that moved between blocks of the box
    through their wire, in place: every block's along a periodic dim, else
    a block's left (right) slab where the block ``disp`` before (after) it
    lies in the box; an edge block's own slab stays exact."""
    import torch

    Db, disp = int(gg.box[dim]), int(gg.disp)
    for f, codec in codecs.items():
        for side, t in enumerate(got[f]):
            if periodic:
                t.copy_(codec.roundtrip(t))
                continue
            if disp >= Db:
                continue  # no block of the box reaches another
            pos = torch.arange(Db, device=t.device)
            reached = pos >= disp if side == 0 else pos < Db - disp
            view = t.unflatten(dim, (Db, hw))
            mask = reached.view([-1 if d == dim else 1 for d in range(view.dim())])
            view.copy_(torch.where(mask, codec.roundtrip(t).unflatten(dim, (Db, hw)), view))


def _recv_dim(gg, dim, hw, per_field, dim_fn, wire=None, shapes=None):
    """One dim's received slabs ``{f: (recv_l, recv_r)}`` from ``dim_fn``
    (`exchange_recv_slabs_multi`), through the ``wire`` policy (``shapes``
    the fields' LOCAL block shapes). Along a dim that crosses processes: the
    moves inside the box (a non-periodic launch), every block's send slabs
    (the identity moves), and the box's edge blocks' slabs through
    `transport.fill_edges` (in the wire format)."""
    _, periodic, _ = _dim_meta(gg, dim)
    if not crosses(gg, dim):
        got = dim_fn(dim, hw, periodic, per_field)
        _wire_inside(gg, dim, hw, got, _codecs(gg, dim, hw, got, shapes, wire), periodic)
        return got
    from ..parallel.transport import fill_edges

    got = dim_fn(dim, hw, False, per_field)
    codecs = _codecs(gg, dim, hw, got, shapes, wire)
    _wire_inside(gg, dim, hw, got, codecs, False)
    sends = dim_fn(dim, hw, False, {f: (_send_moves(mv), ear)
                                    for f, (mv, ear) in per_field.items()})
    Db = int(gg.box[dim])
    items = []
    for f in per_field:
        for side, (dst, src) in enumerate(zip(got[f], sends[f])):
            items.append((dst.unflatten(dim, (Db, hw)), src.unflatten(dim, (Db, hw)), side,
                          codecs.get(f)))
    fill_edges(gg, dim, items)
    return got


def _exchange_dim(gg, A, dim, hw, ol_d, use_kernel, wire=None):
    """Exchange the halos of every block of stacked ``A`` along ``dim``, in
    place: the received slabs (K4s, `_recv_dim`, through the ``wire``), then
    K2 writes them (the plain versions with ``use_kernel`` off)."""
    from .cuda_halo import halo_write, halo_write_plain
    from .cuda_stencil import exchange_slabs, exchange_slabs_plain

    D, periodic, disp = _dim_meta(gg, dim)
    if not periodic and disp >= D:
        return A  # no neighbours along this dim: every halo is PROC_NULL
    loc = _box_locals(gg, A.shape)
    n = loc[dim]
    _check_slab_fit(n, dim, ol_d, hw)
    if _record.ACTIVE is not None:
        _record.ACTIVE.exchange(gg, dim, schema_for_fields(
            dim, [loc], [hw], A.dtype, wire_format_for(A.dtype, wire, dim)),
            site="per_dim", sources=(A,))
    slabs, write = (exchange_slabs, halo_write) if use_kernel \
        else (exchange_slabs_plain, halo_write_plain)

    def dim_fn(dim, hw, periodic, per_field):
        return {"A": slabs(A, dim, hw, per_field["A"][0], block=loc, periodic=periodic)}

    recv_l, recv_r = _recv_dim(gg, dim, hw, {"A": (_moves(n, ol_d, hw, disp), ())}, dim_fn,
                               wire, {"A": loc})["A"]
    return write(A, recv_l, recv_r, dim=dim, hw=hw, block=n)


def exchange_recv_slabs_multi(gg, shapes, hws, modes, dim_fn, *, wire=None, sources=None):
    """Corner-patched RECEIVED slabs for every (field, dim): the slab
    pipeline of the fused kernel tiers (the JAX package's function of the
    same name, on the virtual mesh).

    Per dim, in the reference's write order (z, x, y), a call
    ``dim_fn(dim, hw, periodic, {f: (moves, earlier)})`` returns ``{f:
    (recv_l, recv_r)}`` for every field exchanging along ``dim`` (two calls
    along a dim that crosses processes, `_recv_dim`): each
    block's received slabs, the neighbour block's send slab ``[s-ol,
    s-ol+hw)`` or ``[ol-hw, ol)`` (a plain slice for a standalone exchange,
    a freshly computed slab when a model fuses its update with the
    exchange), patched with the values that block received along the
    field's ``earlier`` dims (the corners), moved as the two `Move`s say (a
    local swap for a self-neighbour dim); on a PROC_NULL edge the block
    keeps its own patched current halo. K4s (`cuda_stencil.exchange_slabs`,
    or its staggered modes for every field of a dim) does all of that in
    one launch.

    ``wire`` is the resolved wire policy (`precision.resolve_wire_dtype`;
    None: exact): each block's received slab crosses in its format (a
    quantized slab against its own scale, its earlier dims' corners
    patched in first), and a PROC_NULL edge keeps its halo exact.

    ``shapes``/``modes`` are dicts keyed by field name; ``hws`` is the
    shared per-dim halowidth tuple; ``sources`` (optional, by field name)
    the stacked tensors the slabs are cut from, which a recording
    (`analysis.record`) names as the permutes' operands. Returns ``{field: {dim: (recv_l,
    recv_r)}}`` in K2's slab layout (the stacked shape with dim at D*hw)."""
    earlier = {f: [] for f in shapes}  # [(dim, hw, (recv_l, recv_r))]
    recvs = {f: {} for f in shapes}
    for dim in DEFAULT_DIMS_ORDER:
        _, _, disp = _dim_meta(gg, dim)
        per_field = {}
        for f in shapes:
            if not modes[f][dim]:
                continue
            hw = int(hws[dim])
            s = int(shapes[f][dim])
            ol_d = _ol(gg, shapes[f], dim)
            _check_slab_fit(s, dim, ol_d, hw)
            per_field[f] = (_moves(s, ol_d, hw, disp), tuple(earlier[f]))
        if not per_field:
            continue
        got = _recv_dim(gg, dim, hw, per_field, dim_fn, wire, shapes)
        if _record.ACTIVE is not None:
            _record.ACTIVE.exchange_slabs(gg, dim, {f: shapes[f] for f in per_field}, hw,
                                          {f: got[f][0].dtype for f in per_field}, wire,
                                          site="slabs", sources=sources)
        for f in per_field:
            recvs[f][dim] = tuple(got[f])
            earlier[f].append((dim, hw, recvs[f][dim]))
    return recvs


def exchange_recv_slabs(gg, shape, hws, modes, slab_fn, *, wire=None, source=None):
    """Single-field form of `exchange_recv_slabs_multi`: ``slab_fn(dim, hw,
    moves, periodic, earlier)`` returns one dim's ``(recv_l, recv_r)``;
    returns ``{dim: (recv_l, recv_r)}``."""
    def dim_fn(dim, hw, periodic, per_field):
        moves, ear = per_field["A"]
        return {"A": slab_fn(dim, hw, moves, periodic, ear)}

    return exchange_recv_slabs_multi(gg, {"A": shape}, hws, {"A": modes}, dim_fn, wire=wire,
                                     sources=None if source is None else {"A": source})["A"]


def _combined_plan(gg, shape, hws, dims_order):
    """Participation modes of the combined one-pass exchange (K6) for a
    field of LOCAL ``shape``, or None: the kernel tier is on and
    `combined_write_supported` holds (the JAX gate)."""
    from .cuda_halo import combined_write_supported

    if not _kernel_tier_enabled(gg, shape, dims_order):
        return None
    modes = tuple(_dim_exchanges(gg, shape, hws, dim) for dim in range(3))
    if not combined_write_supported(shape, modes, hws):
        return None
    return modes


def halo_route(gg, shape, hws, dims_order=DEFAULT_DIMS_ORDER) -> str:
    """The kernel tier `update_halo` takes for one float64 field alone, of
    LOCAL ``shape``: ``"self"`` (K3), ``"coalesced"`` (K8 + K7, under a
    quantized ``IGG_HALO_WIRE_DTYPE`` or a staged dim), ``"combined"`` (K4s
    + K6) or ``"per_dim"`` (K4s + K2 for each dim, or their plain versions
    with the tier off), in the JAX package's order; see `halo_routes`."""
    return halo_routes(gg, [shape], [None], [hws], dims_order)[0][0]


class _Sig:
    """Shape (LOCAL) and dtype of a field, so that the routing helpers serve
    the static plan without tensors."""

    __slots__ = ("shape", "dtype")

    def __init__(self, shape, dtype):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype_name(dtype)


def _staged_layouts(gg, stage) -> dict:
    """``{dim: StagedWireLayout}`` for every dim the resolved staging policy
    stages and whose granule geometry supports it
    (`parallel.topology.staged_wire_layout`; a degenerate axis stays
    flat)."""
    if stage is None:
        return {}
    from ..parallel.topology import staged_wire_layout

    out = {}
    for d in stage.staged_dims:
        lay = staged_wire_layout(gg, d)
        if lay is not None:
            out[d] = lay
    return out


def _coalesce_groups(gg, fields, hws, handled, dims_order, coalesce=True, wire=None,
                     staged_dims=frozenset()):
    """Packing plan of the coalesced exchange: ``{dim: [group, ...]}``, each
    group a tuple of the indices of fields of ONE dtype that all exchange
    along the multi-rank axis ``dim`` (``fields`` carry LOCAL shapes).
    Without a quantized wire a group needs two or more fields (a lone field
    keeps its per-field route). A dtype the policy quantizes along ``dim``,
    or a dim in ``staged_dims``, sends every exchanging field of it down the
    packed route, a single field too (with ``coalesce`` off, one group a
    field)."""
    out = {}
    for dim in dims_order:
        D, _, _ = _dim_meta(gg, dim)
        if D == 1:
            continue  # self-neighbour / no-neighbour axes: nothing to pack
        by_dt = {}
        for i, f in enumerate(fields):
            if handled[i]:
                continue
            if _dim_exchanges(gg, f.shape, hws[i], dim):
                by_dt.setdefault(dtype_name(f.dtype), []).append(i)
        groups = []
        for dt, idxs in by_dt.items():
            fmt = wire_format_for(dt, wire, dim)
            packed = (fmt is not None and fmt.is_quant) or dim in staged_dims
            if packed and not coalesce:
                groups.extend((i,) for i in idxs)
            elif packed or (coalesce and len(idxs) >= 2):
                groups.append(tuple(idxs))
        if groups:
            out[dim] = groups
    return out


def _plan_routes(gg, fields, hws, dims_order, coalesce, wire, stage):
    """The tiers of `halo_routes` for resolved policies: ``(tiers, groups,
    staged layouts)``."""
    tiers = [None] * len(fields)
    for i, f in enumerate(fields):
        if _self_exchange_plan(gg, f.shape, hws[i], dims_order) is not None:
            tiers[i] = "self"
    staged = _staged_layouts(gg, stage)
    groups = _coalesce_groups(gg, fields, hws, [t is not None for t in tiers], dims_order,
                              coalesce, wire, frozenset(staged))
    grouped = {i for gs in groups.values() for g in gs for i in g}

    def touched(f, hw):
        # whether the wire or the staging reaches one of this field's
        # multi-rank exchanges: such a field skips the combined tier
        return any(_dim_exchanges(gg, f.shape, hw, d) and (
            d in staged or (wire_format_for(f.dtype, wire, d) is not None
                            and _dim_meta(gg, d)[0] > 1)) for d in dims_order)

    for i, f in enumerate(fields):
        if tiers[i] is None:
            tiers[i] = ("coalesced" if i in grouped else
                        "combined" if not touched(f, hws[i]) and _combined_plan(
                            gg, f.shape, hws[i], dims_order) is not None else "per_dim")
    return tiers, groups, staged


def halo_routes(gg, shapes, dtypes, hws, dims_order=DEFAULT_DIMS_ORDER, coalesce=None,
                wire_dtype=None, wire_stage=None):
    """The tiers `update_halo` takes for several fields at once (LOCAL
    ``shapes``, their ``dtypes`` and halowidths): ``(tiers, groups)``, one of
    ``"self"``, ``"coalesced"``, ``"combined"`` or ``"per_dim"`` per field,
    and the coalesced groups by dim (`_coalesce_groups`), the JAX package's
    selection: a field the wire or the staging touches skips the combined
    tier. A grouped field takes the per-dim route on the dims where it has
    no group. ``wire_dtype``/``wire_stage`` resolve as in `update_halo`."""
    fields = [_Sig(s, d) for s, d in zip(shapes, dtypes)]
    hws = [tuple(int(h) for h in hw) for hw in hws]
    tiers, groups, _ = _plan_routes(gg, fields, hws, dims_order,
                                    resolve_halo_coalesce(coalesce),
                                    resolve_wire_dtype(wire_dtype),
                                    resolve_wire_stage(wire_stage))
    return tiers, groups


def _combined_exchange(gg, A, hws, modes, loc):
    """All dims of stacked ``A`` in two steps: the slab pipeline on plain
    slices (K4s, one launch per dim), then K6 writes every received slab
    into the halos, in place."""
    from .cuda_halo import halo_write_combined
    from .cuda_stencil import exchange_slabs

    def slab_fn(dim, hw, moves, periodic, earlier):
        return exchange_slabs(A, dim, hw, moves, block=loc, periodic=periodic,
                              earlier=earlier)

    recvs = exchange_recv_slabs(gg, loc, hws, modes, slab_fn, source=A)
    return halo_write_combined(A, recvs, modes=modes, hws=hws, block=loc)


def _exchange_dim_coalesced(gg, arrays, idxs, locs, hws, dim, use_kernel, wire=None,
                            members=None):
    """Exchange the halos of the fields ``idxs`` (one dtype) along ``dim``
    on every block: K8 packs both directions' send slabs of every field into
    the blocks' staging rows (`WireSchema.staging` of the group), the rows
    cross the wire (`WireSchema.encode_rows`/`decode_rows`: cast, or each
    slab quantized against its own scale), and K7 writes every field's halos
    from the neighbour blocks' rows, in place (the plain versions with
    ``use_kernel`` off); a block on a PROC_NULL edge keeps its halo. Along a
    dim that crosses processes, the payload rows go over the transport and
    K7 runs with ``disp`` 0 on the rows each block reads
    (`transport.shift_rows`). A group of more than `MAX_SLABS` fields goes
    in several launches of the same schema rule; the values are the
    same. ``members``: the fields lead with an ensemble's member axis of
    that many members, all of them in each launch (`WireSchema.members`)."""
    from .cuda_halo import (
        MAX_SLABS, halo_write_multi, halo_write_multi_plain, wire_pack, wire_pack_plain,
    )

    _, periodic, disp = _dim_meta(gg, dim)
    pack, write = (wire_pack, halo_write_multi) if use_kernel \
        else (wire_pack_plain, halo_write_multi_plain)
    if _record.ACTIVE is not None:  # the group's logical exchange, one schema
        dt = arrays[idxs[0]].dtype
        _record.ACTIVE.exchange(gg, dim, schema_for_fields(
            dim, [locs[i] for i in idxs], [int(hws[i][dim]) for i in idxs], dt,
            wire_format_for(dt, wire, dim), members=members or 1),
            site="coalesced", sources=[arrays[i] for i in idxs])
    for k0 in range(0, len(idxs), MAX_SLABS):
        sub = idxs[k0:k0 + MAX_SLABS]
        fs = [arrays[i] for i in sub]
        blks = [locs[i] for i in sub]
        hw = [int(hws[i][dim]) for i in sub]
        starts_r, starts_l = [], []
        for blk, h in zip(blks, hw):
            s, ol_d = blk[dim], _ol(gg, blk, dim)
            _check_slab_fit(s, dim, ol_d, h)
            starts_r.append(s - ol_d)
            starts_l.append(ol_d - h)
        schema = schema_for_fields(dim, blks, hw, fs[0].dtype,
                                   wire_format_for(fs[0].dtype, wire, dim),
                                   members=members or 1)
        staging = schema.staging
        buf_r, buf_l = pack(fs, staging, starts_r=starts_r, starts_l=starts_l, blocks=blks)
        if not crosses(gg, dim):
            if schema.fmt is not None:
                buf_r = schema.decode_rows(schema.encode_rows(buf_r))
                buf_l = schema.decode_rows(schema.encode_rows(buf_l))
            write(fs, buf_r, buf_l, staging, blocks=blks, periodic=periodic, disp=disp)
            continue
        from ..parallel.transport import shift_rows

        lead = fs[0].dim() - len(blks[0])
        counts = [int(s) // int(b) for s, b in zip(fs[0].shape[lead:], blks[0])]
        counts += [1] * (3 - len(counts))

        def rows(bufs):
            return [b.view(*counts, b.shape[1]) for b in bufs]

        def own(fs=fs, blks=blks, hw=hw, staging=staging):
            # every block's own halos: what a block on a non-periodic edge keeps
            return rows(pack(fs, staging, starts_r=[0] * len(fs),
                             starts_l=[b[dim] - h for b, h in zip(blks, hw)], blocks=blks))

        src_r, src_l = shift_rows(gg, dim, rows((buf_r, buf_l)), own,
                                  schema if schema.fmt is not None else None)
        write(fs, src_r.reshape(buf_r.shape), src_l.reshape(buf_l.shape), staging,
              blocks=blks, periodic=True, disp=0)


def _dense(arrays) -> list:
    """Each field as a dense tensor (a copy where it is not contiguous: the
    kernels take only dense blocks); a recording notes each copy."""
    out = [A.contiguous() for A in arrays]
    if _record.ACTIVE is not None:
        for A, B in zip(arrays, out):
            if B is not A:
                _record.ACTIVE.copy(B, site="dense")
    return out


def _exchange_members(gg, arrays, hws, dims_order, wire, members):
    """Exchange the halos of an ensemble's fields (stacked tensors leading
    with an axis of ``members`` members), in place: along every exchanging
    dim, each dtype's fields go down the coalesced route, one K8 and one K7
    launch a dim for every member of every field (a self-neighbour dim too,
    with no wire). Returns the list of tensors (dense copies of fields that
    were not contiguous)."""
    arrays = _dense(arrays)
    for A in arrays:
        if A.dim() < 2 or int(A.shape[0]) != members:
            raise InvalidArgumentError(
                f"an ensemble's field leads with its {members} members; got shape "
                f"{tuple(A.shape)}.")
    locs = [_box_locals(gg, A.shape[1:]) for A in arrays]
    for dim in dims_order:
        D, periodic, _ = _dim_meta(gg, dim)
        if D == 1 and not periodic:
            continue
        by_dt = {}
        for i, loc in enumerate(locs):
            if _dim_exchanges(gg, loc, hws[i], dim):
                by_dt.setdefault(dtype_name(arrays[i].dtype), []).append(i)
        for idxs in by_dt.values():
            _exchange_dim_coalesced(gg, arrays, idxs, locs, hws, dim, bool(gg.use_pallas[dim]),
                                    wire if D > 1 else None, members)
    return arrays


def _exchange_arrays(gg, arrays, hws, dims_order, coalesce=None, wire=None, stage=None,
                     members=None):
    """Exchange every field's halos (stacked tensors), each by its tier of
    `halo_routes`: self (K3) > coalesced groups (K8 + K7 per dim) >
    combined (K4s + K6) > per dim (K4s + K2), through the resolved ``wire``
    policy; a staged dim takes the coalesced route. Returns the list of
    updated tensors: K3 out of place, the others in place (on a dense copy
    where a field is not contiguous, as the kernels take only dense
    blocks). ``members``: the fields lead with an ensemble's member axis
    (`_exchange_members`)."""
    from .cuda_halo import halo_self_exchange

    if members is not None:
        return _exchange_members(gg, arrays, [tuple(int(h) for h in hw) for hw in hws],
                                 dims_order, wire, int(members))
    coalesce = resolve_halo_coalesce(coalesce)
    arrays = _dense(arrays)
    locs = [_box_locals(gg, A.shape) for A in arrays]
    hws = [tuple(int(h) for h in hw) for hw in hws]
    tiers, groups_by_dim, _ = _plan_routes(gg, [_Sig(l, A.dtype) for l, A in zip(locs, arrays)],
                                           hws, dims_order, coalesce, wire, stage)
    handled = [t in ("self", "combined") for t in tiers]
    for i, A in enumerate(arrays):
        if tiers[i] == "self":
            plan = _self_exchange_plan(gg, locs[i], hws[i], dims_order)
            arrays[i] = halo_self_exchange(A, modes=plan[0], ols=plan[1], block=locs[i])
        elif tiers[i] == "combined":
            modes = _combined_plan(gg, locs[i], hws[i], dims_order)
            arrays[i] = _combined_exchange(gg, A, hws[i], modes, locs[i])
    for dim in dims_order:
        D, periodic, _ = _dim_meta(gg, dim)
        if D == 1 and not periodic:
            continue
        use_kernel = bool(gg.use_pallas[dim])
        in_group = set()
        for g in groups_by_dim.get(dim, ()):
            in_group.update(g)
            _exchange_dim_coalesced(gg, arrays, list(g), locs, hws, dim, use_kernel, wire)
        for i, A in enumerate(arrays):
            if handled[i] or i in in_group or dim >= A.dim():
                continue
            hw = hws[i][dim]
            ol_d = _ol(gg, locs[i], dim)
            if ol_d < 2 * hw:
                continue
            arrays[i] = _exchange_dim(gg, A, dim, hw, ol_d, use_kernel, wire)
    return arrays


def _normalized_fields(fields):
    """Normalize `update_halo` arguments: ``(A, hw)`` tuples -> `Field`,
    containers exploded, ndim and stacked divisibility validated."""
    fs = []
    for f in fields:
        if isinstance(f, tuple) and not isinstance(f, Field) and len(f) == 2 \
                and hasattr(f[0], "shape") and not hasattr(f[1], "shape"):
            fs.append(wrap_field(f[0], f[1]))
        else:
            fs.extend(wrap_field(x) for x in extract(f))
    if not fs:
        raise InvalidArgumentError("update_halo requires at least one field.")
    for f in fs:
        if not hasattr(f.A, "shape"):
            raise InvalidArgumentError("update_halo requires array inputs.")
        if not (1 <= f.A.dim() <= NDIMS):
            raise InvalidArgumentError(
                f"update_halo supports 1-D to {NDIMS}-D arrays; got {f.A.dim()}-D."
            )
    check_fields(fs)
    gg = global_grid()
    for f in fs:
        for d in range(f.A.dim()):
            if int(f.A.shape[d]) % int(gg.box[d]) != 0:
                raise IncoherentArgumentError(
                    f"Stacked array size {f.A.shape[d]} along dimension {d} is not "
                    f"divisible by the box's {int(gg.box[d])} rank(s). update_halo operates "
                    "on stacked arrays (this process's box * local size)."
                )
    return fs


def update_halo(*fields, dims=None, coalesce=None, wire_dtype=None,
                wire_stage=None):
    """Update the halos of the given stacked field(s) (this process's box)::

        T = update_halo(T)
        A, B, C = update_halo(A, B, (C, (2, 2, 2)))   # per-field halowidths

    Fields may be tensors, ``Field(A, halowidths)``, ``(A, halowidths)``
    tuples or containers of tensors. ``dims`` is the 0-based dim order
    (default z, x, y). ``coalesce`` packs same-dtype fields into one wire
    buffer per (axis, group) (default from ``IGG_HALO_COALESCE``: on); the
    values are the same either way. ``wire_dtype`` (default from
    ``IGG_HALO_WIRE_DTYPE``: off) sends float halos cast
    (``"bfloat16"``, ``"float16"``, ``"float32"``) or per-slab quantized
    (``"int8"``, ``"int4"``), per mesh axis (``"z:int8,x:f32"``);
    ``wire_stage`` (default from ``IGG_HALO_WIRE_STAGE``: off) stages an
    axis (``"z:staged"``): the same halos, the coalesced route. Use the
    returned tensors: see the module docstring."""
    check_initialized()
    gg = global_grid()
    dims_order = _normalize_dims_order(dims)
    fs = _normalized_fields(fields)
    coalesce = resolve_halo_coalesce(coalesce)
    wire, stage = resolve_wire_dtype(wire_dtype), resolve_wire_stage(wire_stage)
    _account(gg, fs, dims_order, coalesce, wire, stage)
    with label("igg::update_halo"):
        out = _exchange_arrays(gg, [f.A for f in fs], [f.halowidths for f in fs],
                               dims_order, coalesce, wire, stage)
    return out[0] if len(out) == 1 else tuple(out)


# the wire plans `update_halo` charges, by grid epoch and call signature
_plan_cache: dict = {}


def _account(gg, fs, dims_order, coalesce, wire, stage) -> None:
    """Charge one `update_halo` call's static wire plan to the metrics
    registry and the flight recorder (`telemetry.hooks.
    account_halo_exchange`), as the JAX package does on every call: the
    plan is computed once a signature (`_plan_from_sigs`), then a call
    costs a dict lookup and a few counter increments (one JSONL line while
    a recorder is open). `local_update_halo` charges nothing."""
    from ..parallel.topology import live_epochs
    from ..telemetry.hooks import account_halo_exchange

    sig = tuple((tuple(f.A.shape), f.A.dtype, tuple(f.halowidths)) for f in fs)
    key = (gg.epoch, sig, dims_order, coalesce, str(wire), str(stage))
    plan = _plan_cache.get(key)
    if plan is None:
        live = live_epochs()
        for k in [k for k in _plan_cache if k[0] not in live]:
            del _plan_cache[k]
        plan = _plan_from_sigs(
            gg, [_Sig(_box_locals(gg, shape), dt) for shape, dt, _ in sig],
            [tuple(int(h) for h in hw) for _, _, hw in sig], dims_order, coalesce, wire,
            stage)
        _plan_cache[key] = plan
    account_halo_exchange(plan)


def local_update_halo(*fields, dims=None, coalesce=None, wire_dtype=None,
                      wire_stage=None, members=None):
    """The step-side form of `update_halo` (the JAX package calls it inside
    `shard_map` on local blocks). Every rank's block of the box is part of
    the stacked tensor, so it takes the stacked tensors and is
    `update_halo` without the argument normalization of containers.

    ``members``: the fields are an ensemble's (`models.common.
    ensemble_state`), each leading with an axis of that many members; a
    4-D field reads so without it. Every member of every field then
    crosses in one K8 + K7 launch a dim (the coalesced route, whatever the
    field count; the JAX package vmaps its exchange over the members)."""
    check_initialized()
    gg = global_grid()
    dims_order = _normalize_dims_order(dims)
    fs = [wrap_field(f) for f in fields]
    if members is None and any(f.A.dim() > NDIMS for f in fs):
        members = int(fs[0].A.shape[0])
    with label("igg::update_halo"):
        out = _exchange_arrays(gg, [f.A for f in fs], [f.halowidths for f in fs],
                               dims_order, coalesce, resolve_wire_dtype(wire_dtype),
                               resolve_wire_stage(wire_stage), members)
    return out[0] if len(out) == 1 else tuple(out)


def halo_comm_plan(*fields, dims=None, coalesce=None, wire_dtype=None,
                   ensemble=None, wire_stage=None) -> dict:
    """Static message-count and byte plan of an `update_halo` call with these
    stacked fields (the JAX package's `halo_comm_plan`), from shapes,
    overlaps, dtypes and the wire policy alone: per mesh axis the permute
    count (two a packed group or a lone field), the bytes on the wire over
    every link of both directions (`WireSchema.payload_bytes` for a group:
    quantized slabs and their scales, or the cast's bytes), and the
    self-neighbour copies that never leave a device. A staged axis
    (``wire_stage``) carries the staged stages' exact counts and absolute
    bytes (`StagedWireSchema`) and a ``staged`` record. Fields take the
    forms of `update_halo`, or anything with ``shape`` and ``dtype``.
    ``ensemble=E`` prices the exchange of an E-member ensemble: the fields
    are given without the member axis (one member's geometry), the
    permute counts stay those of one member and every payload and local
    copy carries E members' slabs (`WireSchema.members`, E times the
    quantized slabs' scales).

    Returns ``{fields, coalesce, wire_dtype, wire_stage, staged_axes,
    ensemble, axes: {axis: {ppermutes, wire_bytes, by_dtype[, staged]}},
    ppermutes, wire_bytes, local_copy_bytes, local_copy_by_axis}``."""
    check_initialized()
    E = 1
    if ensemble is not None:
        E = int(ensemble)
        if E < 1:
            raise InvalidArgumentError(f"halo_comm_plan: ensemble must be >= 1; got {ensemble}.")
    gg = global_grid()
    dims_order = _normalize_dims_order(dims)
    coalesce = resolve_halo_coalesce(coalesce)
    wire = resolve_wire_dtype(wire_dtype)
    stage = resolve_wire_stage(wire_stage)
    fs = []
    for f in fields:
        if isinstance(f, tuple) and not isinstance(f, Field) and len(f) == 2 \
                and hasattr(f[0], "shape") and not hasattr(f[1], "shape"):
            fs.append(wrap_field(f[0], f[1]))
        else:
            fs.extend(wrap_field(x) for x in extract(f))
    if not fs:
        raise InvalidArgumentError("halo_comm_plan requires at least one field.")
    sigs = []
    for f in fs:
        shape = tuple(int(s) for s in f.A.shape)
        if any(s % int(gg.box[d]) for d, s in enumerate(shape)):
            raise IncoherentArgumentError(
                f"Stacked array size {shape} is not divisible by the box "
                f"{tuple(int(d) for d in gg.box)}.")
        sigs.append(_Sig(_box_locals(gg, shape), f.A.dtype))
    hws = [tuple(int(h) for h in f.halowidths) for f in fs]
    return _plan_from_sigs(gg, sigs, hws, dims_order, coalesce, wire, stage, E)


def _plan_from_sigs(gg, sigs, hws, dims_order, coalesce, wire, stage, E=1) -> dict:
    """`halo_comm_plan`'s record for fields of LOCAL signatures ``sigs``
    (`_Sig`) and halowidths ``hws``, under resolved knobs."""
    from ..parallel.topology import AXIS_NAMES
    from .wire import _itemsize

    def slab_cells(i, dim):
        shp = sigs[i].shape
        return int(np.prod(shp)) // shp[dim] * hws[i][dim]

    axes: dict = {}

    def axis_rec(dim):
        return axes.setdefault(AXIS_NAMES[dim], {"ppermutes": 0, "wire_bytes": 0,
                                                 "by_dtype": {}})

    def add_wire(dim, payload_bytes, key, npairs):
        rec = axis_rec(dim)
        rec["ppermutes"] += 2
        b = payload_bytes * npairs
        rec["wire_bytes"] += b
        rec["by_dtype"][key] = rec["by_dtype"].get(key, 0) + b

    local_bytes = 0
    local_by_axis: dict = {}
    staged = _staged_layouts(gg, stage)
    groups_by_dim = _coalesce_groups(gg, sigs, hws, [False] * len(sigs), dims_order,
                                     coalesce, wire, frozenset(staged))
    for dim in dims_order:
        D, periodic, disp = _dim_meta(gg, dim)
        if D == 1 and not periodic:
            continue
        perm_p, perm_m = axis_perm_pairs(D, periodic, disp)
        npairs = len(perm_p) + len(perm_m)
        in_group = set()
        for g in groups_by_dim.get(dim, ()):
            in_group.update(g)
            dt = sigs[g[0]].dtype
            schema = schema_for_fields(dim, [sigs[i].shape for i in g],
                                       [hws[i][dim] for i in g], dt,
                                       wire_format_for(dt, wire, dim), members=E)
            if dim in staged:
                sws = StagedWireSchema(schema=schema, layout=staged[dim])
                rec = axis_rec(dim)
                rec["ppermutes"] += sws.ppermute_ops
                rec["wire_bytes"] += sws.wire_bytes
                rec["by_dtype"][schema.wire_key] = (
                    rec["by_dtype"].get(schema.wire_key, 0) + sws.wire_bytes)
                det = rec.setdefault("staged", {
                    "fold": int(sws.layout.fold),
                    "gather_axis": AXIS_NAMES[sws.layout.gather_dim],
                    "granules": int(sws.layout.granules),
                    "dcn_pairs": sws.dcn_pair_count,
                    "flat_dcn_pairs": sws.flat_dcn_pair_count(),
                    "stages": [],
                })
                det["stages"].extend(dict(r, group=tuple(g)) for r in sws.stage_table())
                continue
            add_wire(dim, schema.payload_bytes, schema.wire_key, npairs)
        for i, f in enumerate(sigs):
            if i in in_group or not _dim_exchanges(gg, f.shape, hws[i], dim):
                continue
            if D == 1:  # periodic self-neighbour: local slab swap, no wire
                b = 2 * slab_cells(i, dim) * _itemsize(f.dtype) * E
                local_bytes += b
                local_by_axis[AXIS_NAMES[dim]] = local_by_axis.get(AXIS_NAMES[dim], 0) + b
                continue
            fmt = wire_format_for(f.dtype, wire, dim)
            wd = f.dtype if fmt is None else fmt.dtype_name
            add_wire(dim, slab_cells(i, dim) * _itemsize(wd) * E, wd, npairs)
    return {
        "fields": len(sigs),
        "coalesce": bool(coalesce),
        "wire_dtype": None if wire is None else str(wire),
        "wire_stage": None if stage is None else str(stage),
        "staged_axes": tuple(sorted(AXIS_NAMES[d] for d in staged)),
        "ensemble": E,
        "axes": axes,
        "ppermutes": sum(r["ppermutes"] for r in axes.values()),
        "wire_bytes": sum(r["wire_bytes"] for r in axes.values()),
        "local_copy_bytes": local_bytes,
        "local_copy_by_axis": local_by_axis,
    }
