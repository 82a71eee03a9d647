"""Communication/computation overlap: the `@hide_communication` analog.

Counterpart of `implicitglobalgrid_tpu/ops/overlap.py`. One step restructured
interior-first, on the stacked tensors of this process's box (every block
a view of one tensor; the update is applied per block, as the models'
plain routes apply theirs):

1. the updated BOUNDARY SHELL of every block (slabs of width ``ol`` per
   exchanged dim, ``ol + stagger`` for face-staggered outputs), computed
   from thin input slabs;
2. the halo exchange: ONE `local_update_halo` round of the first
   ``n_exchange`` outputs, on the shells only, so on a CUDA grid it runs
   the kernel tier (K3, K6, K2, or K8 + K7 for a group);
3. the INTERIOR update, which does not read what (2) writes;
4. the stitch of interior, shell and received halos.

The values are those of ``update_fn`` followed by ``local_update_halo``.
Where the JAX package lets XLA's scheduler run (3) under the collectives of
(2), the port orders it by streams on a CUDA grid: the shells are enqueued
on the current stream, a side stream (one per device, kept) waits for them,
the interior is enqueued on the current stream, and only then does the
exchange run under ``torch.cuda.stream(side)``; the current stream waits
for the side stream before the stitch. Enqueueing the interior first matters
across processes: the transport (`parallel.transport.Dist`) blocks the host
on the side stream and on the wire while the interior kernels run. On the
CPU the same code runs in the same order without streams.
"""

from __future__ import annotations

import itertools

from ..parallel.topology import check_initialized, global_grid
from ..utils.exceptions import InvalidArgumentError
from .halo import _box_locals, _normalize_dims_order, local_update_halo
from ..utils.profiling import label
from .precision import resolve_wire_dtype

__all__ = ["hide_communication", "side_stream"]

# device index -> the side stream the exchanges of overlapped steps run on
_side_streams: dict = {}


def side_stream(device):
    """The side stream of CUDA ``device`` (made once, then kept), or None
    for a device without streams (the CPU)."""
    if device.type != "cuda":
        return None
    import torch

    idx = torch.device(device).index
    if idx is None:
        idx = torch.cuda.current_device()
    s = _side_streams.get(idx)
    if s is None:
        s = _side_streams[idx] = torch.cuda.Stream(device=idx)
    return s


def _exchanged_dims(gg, ndim, dims_order):
    return [d for d in dims_order
            if d < ndim and (int(gg.dims[d]) > 1 or bool(gg.periods[d]))]


def hide_communication(update_fn, T, *aux, radius: int = 1, dims=None, halowidths=None,
                       coalesce=None, wire_dtype=None, n_exchange: int | None = None,
                       members: int | None = None):
    """One overlapped (interior-first) step of stacked tensors:
    ``T = hide_communication(update_fn, T, Cp)`` or, multi-field,
    ``Vx, Vy, Vz = hide_communication(upd, (Vx, Vy, Vz), P)``.

    ``T`` is one stacked tensor or a tuple of them; ``update_fn(*T_blocks,
    *aux_blocks)`` takes one block's views (or thinner slabs of it) and
    returns its updated block(s) as new tensors, with the structure of
    ``T``. It must be a local stencil of radius ``radius`` that updates only
    cells whose whole neighbourhood lies inside what it is given, leaving
    the edge cells as they are; ``radius=0``: each cell's update reads no
    neighbour within the outputs. Outputs and ``aux`` may be face-staggered
    (one more cell per dim than the smallest output); a staggered output's
    shell and stitch regions grow by its stagger.

    The exchange is ONE `local_update_halo` round of the first
    ``n_exchange`` outputs (default: all) with ``dims``, ``coalesce`` and
    ``wire_dtype`` (default from ``IGG_HALO_WIRE_DTYPE``: the shells' halos
    cross in that wire format, as the plain order's would);
    ``halowidths`` (single-field form only) forwards per-field halowidths.
    A block too thin to split (``n < 2*(ol + radius) + 1``, or ``radius >
    ol``) takes the plain order: update, then exchange. Returns the updated, exchanged
    tensor(s), new ones; the inputs are not written.

    ``members``: the tensors are an ensemble's, each leading with an axis
    of that many members; ``update_fn`` then takes blocks with that axis
    first, and the exchange carries every member (`local_update_halo`)."""
    check_initialized()
    wire = resolve_wire_dtype(wire_dtype)
    gg = global_grid()
    r = int(radius)
    if r < 0:
        raise InvalidArgumentError("radius must be >= 0.")
    multi = isinstance(T, (tuple, list))
    outs = tuple(T) if multi else (T,)
    nex = len(outs) if n_exchange is None else int(n_exchange)
    if not 1 <= nex <= len(outs):
        raise InvalidArgumentError(
            f"n_exchange={n_exchange} must name 1..{len(outs)} leading outputs.")
    if multi and halowidths is not None:
        raise InvalidArgumentError(
            "halowidths is supported in the single-field form only (the multi-field "
            "exchange uses the grid halowidths).")
    dims_order = _normalize_dims_order(dims)
    arrays = outs + tuple(aux)
    lead = 0 if members is None else 1
    ndim = outs[0].dim() - lead
    locs = [_box_locals(gg, a.shape[lead:]) for a in arrays]
    base = tuple(min(loc[d] for loc in locs[:len(outs)]) for d in range(ndim))
    stags = []
    for k, loc in enumerate(locs):
        st = tuple(loc[d] - base[d] for d in range(ndim))
        if arrays[k].dim() != ndim + lead or any(s not in (0, 1) for s in st):
            raise InvalidArgumentError(
                f"hide_communication {'output' if k < len(outs) else 'aux'} arrays must "
                "match the base extent or be face-staggered (+1) per dimension.")
        stags.append(st)
    ex_dims = _exchanged_dims(gg, ndim, dims_order)
    blocks = list(itertools.product(*(range(int(gg.box[d])) for d in range(ndim))))
    nout = len(outs)

    def block(a, k, c, bounds=None):
        """Block ``c`` of ``a``, shaped as array ``k``, narrowed to
        ``bounds`` ({dim: (lo, hi)} in base cells; a staggered array takes
        its extra face)."""
        idx = [slice(None)] * lead
        for d in range(ndim):
            lo, hi = (bounds or {}).get(d, (0, base[d]))
            o = c[d] * locs[k][d]
            idx.append(slice(o + lo, o + hi + stags[k][d]))
        return a[tuple(idx)]

    def update(c, bounds=None):
        res = update_fn(*(block(a, k, c, bounds) for k, a in enumerate(arrays)))
        res = tuple(res) if isinstance(res, (tuple, list)) else (res,)
        if len(res) != nout:
            raise InvalidArgumentError(
                f"update_fn returned {len(res)} outputs for {nout} output fields.")
        return res

    def exchange(fields):
        if halowidths is not None:
            fields = [{"A": f, "halowidths": halowidths} for f in fields]
        with label("igg::exchange_shells"):
            got = local_update_halo(*fields, dims=dims_order, coalesce=coalesce,
                                    wire_dtype=wire if wire is not None else "off",
                                    members=members)
        return list(got) if isinstance(got, tuple) else [got]

    def finish(new):
        return tuple(new) if multi else new[0]

    import torch

    if not ex_dims or any(base[d] < 2 * (int(gg.overlaps[d]) + r) + 1
                          or r > int(gg.overlaps[d]) for d in ex_dims):
        # nothing exchanges, or a block too thin to split: update, then exchange
        new = [torch.empty_like(o) for o in outs]
        for c in blocks:
            for f, v in enumerate(update(c)):
                block(new[f], f, c).copy_(v)
        if ex_dims:
            new[:nex] = exchange(new[:nex])
        return finish(new)

    # (1) the shells, on the current stream (shells and interior cover
    # every cell)
    shells = [torch.empty_like(o) for o in outs]
    lohi = {d: (int(gg.overlaps[d]), base[d] - int(gg.overlaps[d])) for d in ex_dims}
    for d in ex_dims:
        ol_d, s = lohi[d][0], base[d]
        for c in blocks:
            left = update(c, {d: (0, ol_d + r)})
            right = update(c, {d: (s - ol_d - r, s)})
            for f in range(nout):
                w = ol_d + stags[f][d]
                dst = block(shells[f], f, c)
                a = lead + d
                dst.narrow(a, 0, w).copy_(left[f].narrow(a, 0, w))
                dst.narrow(a, dst.shape[a] - w, w).copy_(right[f].narrow(a, r, w))
    side = side_stream(outs[0].device)
    if side is not None:
        cur = torch.cuda.current_stream(outs[0].device)
        side.wait_stream(cur)  # the exchange reads the shells

    # (3) the interior, enqueued before the exchange: input grown by r
    grown = {d: (lo - r, hi + r) for d, (lo, hi) in lohi.items()}
    interior = {c: update(c, grown) for c in blocks}

    # (2) the exchange of the shells, on the side stream
    if side is None:
        exchanged = exchange(shells[:nex])
    else:
        with torch.cuda.stream(side):
            exchanged = exchange(shells[:nex])
        cur.wait_stream(side)
        for t in exchanged:  # made or written on the side stream, read on this one
            t.record_stream(cur)
    new = exchanged + shells[nex:]

    # (4) the stitch, after both
    for f in range(nout):
        for c in blocks:
            dst, src = block(new[f], f, c), interior[c][f]
            for d, (lo, hi) in lohi.items():
                st = stags[f][d]
                dst = dst.narrow(lead + d, lo + st, hi - lo - st)
                src = src.narrow(lead + d, r + st, hi - lo - st)
            dst.copy_(src)
    return finish(new)
