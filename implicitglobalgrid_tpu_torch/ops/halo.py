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

Kernel tier (``IGG_USE_PALLAS``, on by default): when every exchanging dim
of a field is self-neighbour, the whole exchange is one pass of K3
(`cuda_halo.halo_self_exchange`); otherwise each dim's halos are written by
K2 (`cuda_halo.halo_write`), one launch per (field, dim) for all ranks.
With the tier off, the writes are slice `copy_`s.

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

__all__ = ["update_halo", "local_update_halo", "DEFAULT_DIMS_ORDER"]

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


def _exchange_dim(gg, A, dim, hw, ol_d, use_kernel):
    """Exchange the halos of every block of stacked ``A`` along ``dim``, in
    place. The block axis of the view ``A.unflatten(dim, (D, n))`` sits at
    ``dim``, the local axis at ``dim + 1``."""
    import torch

    D, periodic, disp = _dim_meta(gg, dim)
    n = A.shape[dim] // D
    _check_slab_fit(n, dim, ol_d, hw)
    v = A.unflatten(dim, (D, n))
    send_r = v.narrow(dim + 1, n - ol_d, hw)
    send_l = v.narrow(dim + 1, ol_d - hw, hw)
    if D == 1:
        if not periodic:
            return A
        # self-neighbour: left halo <- own right slab, right <- own left
        recv_l = send_r.clone(memory_format=torch.contiguous_format)
        recv_r = send_l.clone(memory_format=torch.contiguous_format)
    else:
        perm_p, perm_m = axis_perm_pairs(D, periodic, disp)
        if not perm_p and not perm_m:
            return A
        # recv_l of block t comes from block s of the forward pairs; blocks
        # no pair reaches (PROC_NULL edges) keep their current halo
        src_l, src_r = list(range(D)), list(range(D))
        for s, t in perm_p:
            src_l[t] = s
        for s, t in perm_m:
            src_r[t] = s
        idx_l = torch.tensor(src_l, device=A.device)
        idx_r = torch.tensor(src_r, device=A.device)
        recv_l = send_r.index_select(dim, idx_l)
        recv_r = send_l.index_select(dim, idx_r)
        if not periodic:
            c = torch.arange(D, device=A.device).view(
                [-1 if d == dim else 1 for d in range(A.dim() + 1)])
            recv_l = torch.where(c >= disp, recv_l, v.narrow(dim + 1, 0, hw))
            recv_r = torch.where(c < D - disp, recv_r, v.narrow(dim + 1, n - hw, hw))
    recv_l = recv_l.flatten(dim, dim + 1)
    recv_r = recv_r.flatten(dim, dim + 1)
    if use_kernel:
        from .cuda_halo import halo_write

        return halo_write(A, recv_l, recv_r, dim=dim, hw=hw, block=n)
    from .cuda_halo import halo_write_plain

    return halo_write_plain(A, recv_l, recv_r, dim=dim, hw=hw, block=n)


def _exchange_arrays(gg, arrays, hws, dims_order):
    """Exchange every field's halos (stacked tensors). Returns the list of
    updated tensors: the K3 path out of place, the per-dim path in place
    (on a dense copy where a field is not contiguous, as the kernels take
    only dense blocks)."""
    from .cuda_halo import halo_self_exchange, halo_write_supported

    arrays = [A.contiguous() for A in arrays]
    handled = [False] * len(arrays)
    for i, A in enumerate(arrays):
        loc = tuple(int(s) // int(gg.dims[d]) for d, s in enumerate(A.shape))
        plan = _self_exchange_plan(gg, loc, hws[i], dims_order)
        if plan is not None:
            arrays[i] = halo_self_exchange(A, modes=plan[0], ols=plan[1], block=loc)
            handled[i] = True
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
            use_kernel = bool(gg.use_pallas[dim]) and halo_write_supported(loc, dim, hw)
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
