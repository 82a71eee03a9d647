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

Kernel tier (``IGG_USE_PALLAS``, on by default), in the JAX package's
order (`halo_route` names the tier a field takes):

1. ``"self"``: every exchanging dim is self-neighbour; the whole exchange
   is one pass of K3 (`cuda_halo.halo_self_exchange`).
2. ``"combined"``: 3-D, z exchanging, halowidth 1 on y and z
   (`cuda_halo.combined_write_supported`); the slab pipeline
   (`exchange_recv_slabs`, one K4s launch per dim) then one K6 launch
   (`cuda_halo.halo_write_combined`) that writes every dim's halos.
3. ``"per_dim"``: each dim's halos written by K2 (`cuda_halo.halo_write`),
   one launch per (field, dim) for all ranks.

The received slabs of every tier but K3 come from K4s
(`cuda_stencil.exchange_slabs`, one launch per dim). With the tier off,
slabs and writes are plain PyTorch.

Differences from the JAX package: the exchange is per field (coalescing
several fields into one message is pure layout and bit-identical there, so
it only changes the message count, which a later slice brings with the
`torch.distributed` transport); wire dtypes and staging raise
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

__all__ = ["update_halo", "local_update_halo", "DEFAULT_DIMS_ORDER", "halo_route",
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


def exchange_recv_slabs_multi(gg, shapes, hws, modes, slab_fns):
    """Corner-patched RECEIVED slabs for every (field, dim): the slab
    pipeline of the fused kernel tiers (the JAX package's function of the
    same name, on the virtual mesh).

    Per dim, in the reference's write order (z, x, y): each field's
    ``slab_fns[f](dim, hw, moves, periodic, earlier)`` returns its received
    ``(recv_l, recv_r)`` for every block: the neighbour block's send slab
    ``[s-ol, s-ol+hw)`` or ``[ol-hw, ol)`` (a plain slice for a standalone
    exchange, a freshly computed slab when a model fuses its update with the
    exchange), patched with the values that block received along the
    ``earlier`` dims (the corners), moved as the two `Move`s say (a local
    swap for a self-neighbour dim); on a PROC_NULL edge the block keeps its
    own patched current halo. K4s (`cuda_stencil.exchange_slabs`) does all
    of that in one launch.

    ``shapes``/``modes``/``slab_fns`` are dicts keyed by field name; ``hws``
    is the shared per-dim halowidth tuple. Returns ``{field: {dim: (recv_l,
    recv_r)}}`` in K2's slab layout (the stacked shape with dim at D*hw)."""
    names = list(slab_fns)
    earlier = {f: [] for f in names}  # [(dim, hw, (recv_l, recv_r))]
    recvs = {f: {} for f in names}
    for dim in DEFAULT_DIMS_ORDER:
        _, periodic, disp = _dim_meta(gg, dim)
        for f in names:
            if not modes[f][dim]:
                continue
            hw = int(hws[dim])
            s = int(shapes[f][dim])
            ol_d = _ol(gg, shapes[f], dim)
            _check_slab_fit(s, dim, ol_d, hw)
            recvs[f][dim] = tuple(slab_fns[f](dim, hw, _moves(s, ol_d, hw, disp),
                                              periodic, tuple(earlier[f])))
            earlier[f].append((dim, hw, recvs[f][dim]))
    return recvs


def exchange_recv_slabs(gg, shape, hws, modes, slab_fn):
    """Single-field form of `exchange_recv_slabs_multi`: ``{dim: (recv_l,
    recv_r)}``."""
    return exchange_recv_slabs_multi(gg, {"A": shape}, hws, {"A": modes},
                                     {"A": slab_fn})["A"]


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


def _route_plan(gg, shape, hws, dims_order):
    """The tier of `halo_route` with its plan: ("self", (modes, ols)),
    ("combined", modes) or ("per_dim", None)."""
    plan = _self_exchange_plan(gg, shape, hws, dims_order)
    if plan is not None:
        return "self", plan
    modes = _combined_plan(gg, shape, hws, dims_order)
    if modes is not None:
        return "combined", modes
    return "per_dim", None


def halo_route(gg, shape, hws, dims_order=DEFAULT_DIMS_ORDER) -> str:
    """The kernel tier `update_halo` takes for one field of LOCAL ``shape``:
    ``"self"`` (K3), ``"combined"`` (K4s + K6) or ``"per_dim"`` (K4s + K2
    for each dim, or their plain versions with the tier off), in the JAX
    package's order."""
    return _route_plan(gg, shape, hws, dims_order)[0]


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


def _exchange_arrays(gg, arrays, hws, dims_order):
    """Exchange every field's halos (stacked tensors), each by the tier
    `halo_route` names. Returns the list of updated tensors: K3 out of
    place, the others in place (on a dense copy where a field is not
    contiguous, as the kernels take only dense blocks)."""
    from .cuda_halo import halo_self_exchange

    arrays = [A.contiguous() for A in arrays]
    handled = [False] * len(arrays)
    for i, A in enumerate(arrays):
        loc = tuple(int(s) // int(gg.dims[d]) for d, s in enumerate(A.shape))
        hw = tuple(int(h) for h in hws[i])
        route, plan = _route_plan(gg, loc, hw, dims_order)
        if route == "self":
            arrays[i] = halo_self_exchange(A, modes=plan[0], ols=plan[1], block=loc)
        elif route == "combined":
            arrays[i] = _combined_exchange(gg, A, hw, plan, loc)
        handled[i] = route != "per_dim"
    for dim in dims_order:
        D, periodic, _ = _dim_meta(gg, dim)
        if D == 1 and not periodic:
            continue
        for i, A in enumerate(arrays):
            if handled[i] or dim >= A.dim():
                continue
            loc = tuple(int(s) // int(gg.dims[d]) for d, s in enumerate(A.shape))
            hw = int(hws[i][dim])
            ol_d = _ol(gg, loc, dim)
            if ol_d < 2 * hw:
                continue
            arrays[i] = _exchange_dim(gg, A, dim, hw, ol_d, bool(gg.use_pallas[dim]))
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
    (default z, x, y). ``coalesce`` is accepted for API parity (the virtual
    mesh exchanges per field; results are identical). Use the returned
    tensors: see the module docstring."""
    check_initialized()
    _reject_wire(wire_dtype, wire_stage)
    gg = global_grid()
    dims_order = _normalize_dims_order(dims)
    fs = _normalized_fields(fields)
    out = _exchange_arrays(gg, [f.A for f in fs], [f.halowidths for f in fs],
                           dims_order)
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
                           dims_order)
    return out[0] if len(out) == 1 else tuple(out)
