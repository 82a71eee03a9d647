"""Halo exchange on the virtual mesh: `update_halo` and `local_update_halo`.

Counterpart of `implicitglobalgrid_tpu/ops/halo.py`. Every rank's block is a
view of one stacked tensor, so the "send/recv" of the JAX package's
per-axis `ppermute` becomes a tensor copy between block views. The exchange
semantics are the JAX package's, 0-based:

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

Differences from the JAX package: the wire buffers of a group are copied
between blocks of one tensor (the `torch.distributed` transport that would
send them comes in a later slice); wire dtypes and staging raise
`NotSupportedError`. The halo writes are IN PLACE on the given tensor (on a
contiguous copy of a field that is not contiguous), while the self-exchange
pass returns a new one: always use the returned tensors,
as with the JAX package (``T = update_halo(T)``).
"""

from __future__ import annotations

import numpy as np

from ..parallel.topology import NDIMS, axis_perm_pairs, check_initialized, global_grid
from ..utils.exceptions import (
    IncoherentArgumentError, InvalidArgumentError, NotSupportedError,
)
from .fields import Field, check_fields, extract, wrap_field
from .wire import dtype_name, schema_for_fields

__all__ = ["update_halo", "local_update_halo", "DEFAULT_DIMS_ORDER", "halo_route",
           "halo_routes", "halo_comm_plan", "resolve_halo_coalesce",
           "exchange_recv_slabs_multi", "exchange_recv_slabs"]

# Reference default `dims=(3,1,2)` (1-based: z, x, y).
DEFAULT_DIMS_ORDER = (2, 0, 1)

_LATER = "a later slice of the PyTorch port"


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


def _reject_wire(wire_dtype, wire_stage):
    import os

    if wire_dtype not in (None, "none", "off") or os.environ.get("IGG_HALO_WIRE_DTYPE"):
        raise NotSupportedError(f"wire dtypes are not ported yet ({_LATER}).")
    if wire_stage not in (None, "none", "off") or os.environ.get("IGG_HALO_WIRE_STAGE"):
        raise NotSupportedError(f"the staged wire is not ported yet ({_LATER}).")


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


def _exchange_dim(gg, A, dim, hw, ol_d, use_kernel):
    """Exchange the halos of every block of stacked ``A`` along ``dim``, in
    place: the received slabs (K4s), then K2 writes them (the plain
    versions with ``use_kernel`` off)."""
    from .cuda_halo import halo_write, halo_write_plain
    from .cuda_stencil import exchange_slabs, exchange_slabs_plain

    D, periodic, disp = _dim_meta(gg, dim)
    if not periodic and disp >= D:
        return A  # no neighbours along this dim: every halo is PROC_NULL
    loc = tuple(int(s) // int(gg.dims[d]) for d, s in enumerate(A.shape))
    n = loc[dim]
    _check_slab_fit(n, dim, ol_d, hw)
    slabs, write = (exchange_slabs, halo_write) if use_kernel \
        else (exchange_slabs_plain, halo_write_plain)
    recv_l, recv_r = slabs(A, dim, hw, _moves(n, ol_d, hw, disp), block=loc,
                           periodic=periodic)
    return write(A, recv_l, recv_r, dim=dim, hw=hw, block=n)


def exchange_recv_slabs_multi(gg, shapes, hws, modes, dim_fn):
    """Corner-patched RECEIVED slabs for every (field, dim): the slab
    pipeline of the fused kernel tiers (the JAX package's function of the
    same name, on the virtual mesh).

    Per dim, in the reference's write order (z, x, y), one call
    ``dim_fn(dim, hw, periodic, {f: (moves, earlier)})`` returns ``{f:
    (recv_l, recv_r)}`` for every field exchanging along ``dim``: each
    block's received slabs, the neighbour block's send slab ``[s-ol,
    s-ol+hw)`` or ``[ol-hw, ol)`` (a plain slice for a standalone exchange,
    a freshly computed slab when a model fuses its update with the
    exchange), patched with the values that block received along the
    field's ``earlier`` dims (the corners), moved as the two `Move`s say (a
    local swap for a self-neighbour dim); on a PROC_NULL edge the block
    keeps its own patched current halo. K4s (`cuda_stencil.exchange_slabs`,
    or its staggered modes for every field of a dim) does all of that in
    one launch.

    ``shapes``/``modes`` are dicts keyed by field name; ``hws`` is the
    shared per-dim halowidth tuple. Returns ``{field: {dim: (recv_l,
    recv_r)}}`` in K2's slab layout (the stacked shape with dim at D*hw)."""
    earlier = {f: [] for f in shapes}  # [(dim, hw, (recv_l, recv_r))]
    recvs = {f: {} for f in shapes}
    for dim in DEFAULT_DIMS_ORDER:
        _, periodic, disp = _dim_meta(gg, dim)
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
        got = dim_fn(dim, hw, periodic, per_field)
        for f in per_field:
            recvs[f][dim] = tuple(got[f])
            earlier[f].append((dim, hw, recvs[f][dim]))
    return recvs


def exchange_recv_slabs(gg, shape, hws, modes, slab_fn):
    """Single-field form of `exchange_recv_slabs_multi`: ``slab_fn(dim, hw,
    moves, periodic, earlier)`` returns one dim's ``(recv_l, recv_r)``;
    returns ``{dim: (recv_l, recv_r)}``."""
    def dim_fn(dim, hw, periodic, per_field):
        moves, ear = per_field["A"]
        return {"A": slab_fn(dim, hw, moves, periodic, ear)}

    return exchange_recv_slabs_multi(gg, {"A": shape}, hws, {"A": modes}, dim_fn)["A"]


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
    """The kernel tier `update_halo` takes for one field alone, of LOCAL
    ``shape``: ``"self"`` (K3), ``"combined"`` (K4s + K6) or ``"per_dim"``
    (K4s + K2 for each dim, or their plain versions with the tier off), in
    the JAX package's order. A lone field never coalesces; see
    `halo_routes` for several."""
    return halo_routes(gg, [shape], [None], [hws], dims_order)[0][0]


class _Sig:
    """Shape (LOCAL) and dtype of a field, so that the routing helpers serve
    the static plan without tensors."""

    __slots__ = ("shape", "dtype")

    def __init__(self, shape, dtype):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype_name(dtype)


def _coalesce_groups(gg, fields, hws, handled, dims_order, coalesce=True):
    """Packing plan of the coalesced exchange: ``{dim: [group, ...]}``, each
    group a tuple of the indices of two or more fields of ONE dtype that all
    exchange along the multi-rank axis ``dim`` (``fields`` carry LOCAL
    shapes). A lone field of a dtype keeps its per-field route."""
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
        groups = [tuple(idxs) for idxs in by_dt.values() if coalesce and len(idxs) >= 2]
        if groups:
            out[dim] = groups
    return out


def halo_routes(gg, shapes, dtypes, hws, dims_order=DEFAULT_DIMS_ORDER, coalesce=None):
    """The tiers `update_halo` takes for several fields at once (LOCAL
    ``shapes``, their ``dtypes`` and halowidths): ``(tiers, groups)``, one of
    ``"self"``, ``"coalesced"``, ``"combined"`` or ``"per_dim"`` per field,
    and the coalesced groups by dim (`_coalesce_groups`). A grouped field
    takes the per-dim route on the dims where it has no group."""
    coalesce = resolve_halo_coalesce(coalesce)
    fields = [_Sig(s, d) for s, d in zip(shapes, dtypes)]
    hws = [tuple(int(h) for h in hw) for hw in hws]
    tiers = [None] * len(fields)
    for i, f in enumerate(fields):
        if _self_exchange_plan(gg, f.shape, hws[i], dims_order) is not None:
            tiers[i] = "self"
    groups = _coalesce_groups(gg, fields, hws, [t is not None for t in tiers],
                              dims_order, coalesce)
    grouped = {i for gs in groups.values() for g in gs for i in g}
    for i, f in enumerate(fields):
        if tiers[i] is None:
            tiers[i] = ("coalesced" if i in grouped else
                        "combined" if _combined_plan(gg, f.shape, hws[i], dims_order)
                        is not None else "per_dim")
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

    recvs = exchange_recv_slabs(gg, loc, hws, modes, slab_fn)
    return halo_write_combined(A, recvs, modes=modes, hws=hws, block=loc)


def _exchange_dim_coalesced(gg, arrays, idxs, locs, hws, dim, use_kernel):
    """Exchange the halos of the fields ``idxs`` (one dtype) along ``dim``
    on every block: K8 packs both directions' send slabs of every field into
    the blocks' wire buffers (`WireSchema` of the group), K7 writes every
    field's halos from the neighbour blocks' buffers, in place (the plain
    versions with ``use_kernel`` off). A group of more than `MAX_SLABS`
    fields goes in several launches of the same schema rule; the values are
    the same."""
    from .cuda_halo import (
        MAX_SLABS, halo_write_multi, halo_write_multi_plain, wire_pack, wire_pack_plain,
    )

    _, periodic, disp = _dim_meta(gg, dim)
    pack, write = (wire_pack, halo_write_multi) if use_kernel \
        else (wire_pack_plain, halo_write_multi_plain)
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
        schema = schema_for_fields(dim, blks, hw, fs[0].dtype)
        buf_r, buf_l = pack(fs, schema, starts_r=starts_r, starts_l=starts_l, blocks=blks)
        write(fs, buf_r, buf_l, schema, blocks=blks, periodic=periodic, disp=disp)


def _exchange_arrays(gg, arrays, hws, dims_order, coalesce=None):
    """Exchange every field's halos (stacked tensors), each by its tier of
    `halo_routes`: self (K3) > coalesced groups (K8 + K7 per dim) >
    combined (K4s + K6) > per dim (K4s + K2). Returns the list of updated
    tensors: K3 out of place, the others in place (on a dense copy where a
    field is not contiguous, as the kernels take only dense blocks)."""
    from .cuda_halo import halo_self_exchange

    coalesce = resolve_halo_coalesce(coalesce)
    arrays = [A.contiguous() for A in arrays]
    locs = [tuple(int(s) // int(gg.dims[d]) for d, s in enumerate(A.shape)) for A in arrays]
    hws = [tuple(int(h) for h in hw) for hw in hws]
    handled = [False] * len(arrays)
    for i, A in enumerate(arrays):
        plan = _self_exchange_plan(gg, locs[i], hws[i], dims_order)
        if plan is not None:
            arrays[i] = halo_self_exchange(A, modes=plan[0], ols=plan[1], block=locs[i])
            handled[i] = True
    groups_by_dim = _coalesce_groups(gg, [_Sig(l, A.dtype) for l, A in zip(locs, arrays)],
                                     hws, handled, dims_order, coalesce)
    grouped = {i for gs in groups_by_dim.values() for g in gs for i in g}
    for i, A in enumerate(arrays):
        if handled[i] or i in grouped:
            continue
        modes = _combined_plan(gg, locs[i], hws[i], dims_order)
        if modes is not None:
            arrays[i] = _combined_exchange(gg, A, hws[i], modes, locs[i])
            handled[i] = True
    for dim in dims_order:
        D, periodic, _ = _dim_meta(gg, dim)
        if D == 1 and not periodic:
            continue
        use_kernel = bool(gg.use_pallas[dim])
        in_group = set()
        for g in groups_by_dim.get(dim, ()):
            in_group.update(g)
            _exchange_dim_coalesced(gg, arrays, list(g), locs, hws, dim, use_kernel)
        for i, A in enumerate(arrays):
            if handled[i] or i in in_group or dim >= A.dim():
                continue
            hw = hws[i][dim]
            ol_d = _ol(gg, locs[i], dim)
            if ol_d < 2 * hw:
                continue
            arrays[i] = _exchange_dim(gg, A, dim, hw, ol_d, use_kernel)
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
            if int(f.A.shape[d]) % int(gg.dims[d]) != 0:
                raise IncoherentArgumentError(
                    f"Global (stacked) array size {f.A.shape[d]} along dimension {d} is not "
                    f"divisible by dims[{d}]={int(gg.dims[d])}. update_halo operates on "
                    "stacked global arrays (dims * local size)."
                )
    return fs


def update_halo(*fields, dims=None, coalesce=None, wire_dtype=None,
                wire_stage=None):
    """Update the halos of the given stacked field(s) on the virtual mesh::

        T = update_halo(T)
        A, B, C = update_halo(A, B, (C, (2, 2, 2)))   # per-field halowidths

    Fields may be tensors, ``Field(A, halowidths)``, ``(A, halowidths)``
    tuples or containers of tensors. ``dims`` is the 0-based dim order
    (default z, x, y). ``coalesce`` packs same-dtype fields into one wire
    buffer per (axis, group) (default from ``IGG_HALO_COALESCE``: on); the
    values are the same either way. Use the returned tensors: see the
    module docstring."""
    check_initialized()
    _reject_wire(wire_dtype, wire_stage)
    gg = global_grid()
    dims_order = _normalize_dims_order(dims)
    fs = _normalized_fields(fields)
    out = _exchange_arrays(gg, [f.A for f in fs], [f.halowidths for f in fs],
                           dims_order, coalesce)
    return out[0] if len(out) == 1 else tuple(out)


def local_update_halo(*fields, dims=None, coalesce=None, wire_dtype=None,
                      wire_stage=None):
    """The step-side form of `update_halo` (the JAX package calls it inside
    `shard_map` on local blocks). On the virtual mesh every rank's block is
    part of the stacked tensor, so it takes the stacked tensors and is
    `update_halo` without the argument normalization of containers."""
    check_initialized()
    _reject_wire(wire_dtype, wire_stage)
    gg = global_grid()
    dims_order = _normalize_dims_order(dims)
    fs = [wrap_field(f) for f in fields]
    out = _exchange_arrays(gg, [f.A for f in fs], [f.halowidths for f in fs],
                           dims_order, coalesce)
    return out[0] if len(out) == 1 else tuple(out)


def halo_comm_plan(*fields, dims=None, coalesce=None, wire_dtype=None,
                   ensemble=None, wire_stage=None) -> dict:
    """Static message-count and byte plan of an `update_halo` call with these
    stacked fields (the JAX package's `halo_comm_plan` for the exact,
    unstaged wire), from shapes, overlaps and dtypes alone: per mesh axis the
    permute count (two a packed group or a lone field), the bytes on the
    wire over every link of both directions (`WireSchema.payload_bytes` for a
    group), and the self-neighbour copies that never leave a device. Fields
    take the forms of `update_halo`, or anything with ``shape`` and
    ``dtype``. The ensemble axis, wire dtypes and the staged wire raise
    `NotSupportedError`.

    Returns ``{fields, coalesce, wire_dtype, wire_stage, staged_axes,
    ensemble, axes: {axis: {ppermutes, wire_bytes, by_dtype}}, ppermutes,
    wire_bytes, local_copy_bytes, local_copy_by_axis}``."""
    from ..parallel.topology import AXIS_NAMES
    from .wire import _itemsize

    check_initialized()
    _reject_wire(wire_dtype, wire_stage)
    if ensemble is not None:
        raise NotSupportedError(f"ensemble batching is not ported yet ({_LATER}).")
    gg = global_grid()
    dims_order = _normalize_dims_order(dims)
    coalesce = resolve_halo_coalesce(coalesce)
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
        if any(s % int(gg.dims[d]) for d, s in enumerate(shape)):
            raise IncoherentArgumentError(
                f"Global (stacked) array size {shape} is not divisible by dims "
                f"{tuple(int(d) for d in gg.dims)}.")
        sigs.append(_Sig([s // int(gg.dims[d]) for d, s in enumerate(shape)], f.A.dtype))
    hws = [tuple(int(h) for h in f.halowidths) for f in fs]

    def slab_cells(i, dim):
        shp = sigs[i].shape
        return int(np.prod(shp)) // shp[dim] * hws[i][dim]

    axes: dict = {}

    def add_wire(dim, payload_bytes, key, npairs):
        rec = axes.setdefault(AXIS_NAMES[dim], {"ppermutes": 0, "wire_bytes": 0,
                                                "by_dtype": {}})
        rec["ppermutes"] += 2
        b = payload_bytes * npairs
        rec["wire_bytes"] += b
        rec["by_dtype"][key] = rec["by_dtype"].get(key, 0) + b

    local_bytes = 0
    local_by_axis: dict = {}
    groups_by_dim = _coalesce_groups(gg, sigs, hws, [False] * len(sigs), dims_order,
                                     coalesce)
    for dim in dims_order:
        D, periodic, disp = _dim_meta(gg, dim)
        if D == 1 and not periodic:
            continue
        perm_p, perm_m = axis_perm_pairs(D, periodic, disp)
        npairs = len(perm_p) + len(perm_m)
        in_group = set()
        for g in groups_by_dim.get(dim, ()):
            in_group.update(g)
            schema = schema_for_fields(dim, [sigs[i].shape for i in g],
                                       [hws[i][dim] for i in g], sigs[g[0]].dtype)
            add_wire(dim, schema.payload_bytes, schema.wire_key, npairs)
        for i, f in enumerate(sigs):
            if i in in_group or not _dim_exchanges(gg, f.shape, hws[i], dim):
                continue
            if D == 1:  # periodic self-neighbour: local slab swap, no wire
                b = 2 * slab_cells(i, dim) * _itemsize(f.dtype)
                local_bytes += b
                local_by_axis[AXIS_NAMES[dim]] = local_by_axis.get(AXIS_NAMES[dim], 0) + b
                continue
            add_wire(dim, slab_cells(i, dim) * _itemsize(f.dtype), f.dtype, npairs)
    return {
        "fields": len(sigs),
        "coalesce": bool(coalesce),
        "wire_dtype": None,
        "wire_stage": None,
        "staged_axes": (),
        "ensemble": 1,
        "axes": axes,
        "ppermutes": sum(r["ppermutes"] for r in axes.values()),
        "wire_bytes": sum(r["wire_bytes"] for r in axes.values()),
        "local_copy_bytes": local_bytes,
        "local_copy_by_axis": local_by_axis,
    }
