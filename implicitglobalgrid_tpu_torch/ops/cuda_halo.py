"""The halo copy kernels K2, K3, K6, K7 and K8 (`csrc/halo.cu`) and their plain
versions.

Counterpart of `implicitglobalgrid_tpu/ops/pallas_halo.py` for the entry
points on this slice's path:

- `halo_write` (K2) for `halo_write_inplace`: write received slabs of width
  ``hw`` into the left and right halos of every block along ``dim``, in
  place. The TPU kernel serves dims 0 and 1 (dim 2 is a lane-tiling
  artefact there); K2 serves all three.
- `halo_self_exchange` (K3) for `halo_self_exchange_pallas`: every
  self-neighbour halo (halowidth 1) of every block in one read+write pass,
  out of place.
- `halo_write_combined` (K6) for `halo_write_combined_pallas`: every
  exchanging dim's received slabs into every block's halos in one launch,
  in place, touching only halo cells.
- `wire_pack` (K8) for `wire_pack_pallas`: every block's send slabs of a
  group of fields into the block's wire buffer (`ops.wire.WireSchema`,
  slab or flat layout), both directions in one launch.
- `halo_write_multi` (K7) for `halo_write_multi_pallas`: every field's
  halos along one dim, on every block, from the neighbour blocks' wire
  buffers, in one launch, in place.

K8 and K7 also take an ensemble's fields (a leading axis of the schema's
`WireSchema.members` members): every member of every field in the one
launch, each member's payload in its own part of a block's row.

All are pure copies and match their plain versions bitwise. On a CUDA
tensor the wrapper launches the kernel (or raises); on a CPU tensor it runs
the plain version.
"""

from __future__ import annotations

import ctypes
import itertools

import numpy as np

from ..utils.exceptions import InvalidArgumentError, NotSupportedError
from .cuda_build import check_rc, count_launch, library
from .fields import block_slices
from .wire import dtype_name

__all__ = ["halo_write_supported", "halo_write", "halo_write_plain",
           "self_exchange_supported", "halo_self_exchange",
           "halo_self_exchange_plain", "combined_write_supported",
           "halo_write_combined", "halo_write_combined_plain", "MAX_SLABS",
           "wire_pack", "wire_pack_plain", "halo_write_multi",
           "halo_write_multi_plain"]

# fields a K7/K8 launch takes (`MAX_SLABS` in csrc/halo.cu)
MAX_SLABS = 16
# long longs a slab in the K7/K8 descriptor (`SLAB_DESC` in csrc/halo.cu)
_SLAB_DESC = 16


def _on_card(t):
    """False for a CPU tensor (the plain version runs); True for a CUDA one;
    raises for any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise NotSupportedError(f"no kernel for device {t.device}.")
    return True


def _stream(t):
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


# signatures a cache keeps
_MAX_CHECKED = 64
# checked K2 and K6 calls by signature: what their checks return
_CALLS: dict = {}


def _checked(cache, check, tensors, *extra):
    """``check()``'s result (``check`` raises on a bad call), once a call
    signature: the tensors' shapes, dtypes, devices and contiguity, and
    ``extra``; later calls of the signature reuse it from ``cache``."""
    import torch

    try:
        key = (*extra, tuple((t.shape, t.dtype, t.device, t.is_contiguous())
                             for t in tensors))
        hash(key)
    except (AttributeError, TypeError):
        key = None  # not tensors: the check raises
    g = cache.get(key) if key is not None and all(
        isinstance(t, torch.Tensor) for t in tensors) else None
    if g is None:
        g = check()
        if key is not None:
            if len(cache) >= _MAX_CHECKED:
                cache.clear()
            cache[key] = g
    return g


def _check_not_aliased(a, slabs, name):
    store = a.untyped_storage().data_ptr()
    if any(s.untyped_storage().data_ptr() == store for s in slabs):
        raise InvalidArgumentError(f"{name}: a slab must not alias the field.")


def halo_write_supported(shape, dim: int, hw: int) -> bool:
    """Whether `halo_write` takes halos of width ``hw`` along ``dim`` of a
    block of this LOCAL shape: 1-D to 3-D with disjoint left and right
    halos. (The TPU kernel is 3-D only, a tiling matter; a 1-D or 2-D field
    runs here as a 3-D one with unit trailing dims.)"""
    return 1 <= len(shape) <= 3 and 0 <= dim < len(shape) \
        and int(shape[dim]) >= 2 * int(hw)


def _check_write(a, slab_l, slab_r, dim, hw, block):
    import torch

    if not all(isinstance(x, torch.Tensor) for x in (a, slab_l, slab_r)):
        raise InvalidArgumentError("halo_write takes torch tensors.")
    if not 1 <= a.dim() <= 3 or not a.is_contiguous():
        raise InvalidArgumentError("halo_write needs a contiguous 1-D to 3-D tensor.")
    dim, hw = int(dim), int(hw)
    if not 0 <= dim < a.dim():
        raise InvalidArgumentError(f"halo_write: no dim {dim} in shape {tuple(a.shape)}.")
    n = int(a.shape[dim]) if block is None else int(block)
    if hw < 1 or n < 1 or a.shape[dim] % n:
        raise InvalidArgumentError(
            f"halo_write: dim {dim}, hw {hw}, block {n} do not fit shape "
            f"{tuple(a.shape)}.")
    if not halo_write_supported(tuple(a.shape[:dim]) + (n,) + tuple(a.shape[dim + 1:]),
                                dim, hw):
        raise InvalidArgumentError(
            f"halo_write: halos of width {hw} overlap in blocks of {n} along dim {dim}.")
    want = list(a.shape)
    want[dim] = a.shape[dim] // n * hw
    for s in (slab_l, slab_r):
        if list(s.shape) != want or s.dtype != a.dtype or s.device != a.device \
                or not s.is_contiguous():
            raise InvalidArgumentError(
                f"halo_write: slabs must be contiguous {tuple(want)} {a.dtype} on "
                f"{a.device}; got {tuple(s.shape)} {s.dtype} on {s.device}.")
    return dim, hw, n, tuple(int(s) for s in a.shape) + (1,) * (3 - a.dim())


def halo_write_plain(a, slab_l, slab_r, *, dim: int, hw: int, block=None):
    """Plain PyTorch version of K2: slice `copy_` into every block's halos."""
    n = int(a.shape[dim]) if block is None else int(block)
    nb = a.shape[dim] // n
    v = a.unflatten(dim, (nb, n))
    v.narrow(dim + 1, 0, hw).copy_(slab_l.unflatten(dim, (nb, hw)))
    v.narrow(dim + 1, n - hw, hw).copy_(slab_r.unflatten(dim, (nb, hw)))
    return a


def halo_write(a, slab_l, slab_r, *, dim: int, hw: int, block=None):
    """Write ``slab_l`` into the ``[0, hw)`` halo and ``slab_r`` into the
    ``[n-hw, n)`` halo along ``dim`` of every block (length ``block``,
    default the whole extent) of stacked ``a``, in place; returns ``a``.
    Slab ``c`` of width ``hw`` along ``dim`` goes to block ``c``."""
    dim, hw, n, shape = _checked(_CALLS, lambda: _check_write(a, slab_l, slab_r, dim, hw, block),
                                 (a, slab_l, slab_r), "write", dim, hw, block)
    _check_not_aliased(a, (slab_l, slab_r), "halo_write")
    if not _on_card(a):
        return halo_write_plain(a, slab_l, slab_r, dim=dim, hw=hw, block=n)
    import torch

    lib = library()
    with torch.cuda.device(a.device):
        rc = lib.igg_halo_write(
            a.element_size(), a.data_ptr(), slab_l.data_ptr(), slab_r.data_ptr(),
            *shape, dim, n, hw, _stream(a))
    check_rc(rc, "halo_write")
    count_launch("halo_write")
    return a


def self_exchange_supported(shape, modes, hws) -> bool:
    """Whether `halo_self_exchange` can run on a block of this LOCAL shape:
    3-D, at least one participating dim, halowidth 1 on each, and >= 3
    planes when dim 0 participates (the JAX gate of the same name)."""
    if len(shape) != 3 or not any(modes):
        return False
    if any(m and int(h) != 1 for m, h in zip(modes, hws)):
        return False
    return not (modes[0] and int(shape[0]) < 3)


def _self_source(n: int, ol: int, device):
    import torch

    idx = torch.arange(n, device=device)
    idx[0], idx[n - 1] = n - ol, ol - 1
    return idx


def _check_self(a, modes, ols, block):
    import torch

    if not isinstance(a, torch.Tensor) or a.dim() != 3 or not a.is_contiguous():
        raise InvalidArgumentError("halo_self_exchange needs a contiguous 3-D tensor.")
    block = tuple(a.shape) if block is None else tuple(int(b) for b in block)
    modes = tuple(bool(m) for m in modes)
    ols = tuple(int(o) for o in ols)
    if len(block) != 3 or any(b < 1 or s % b for s, b in zip(a.shape, block)):
        raise InvalidArgumentError(
            f"block {block} does not tile the stacked shape {tuple(a.shape)}.")
    if len(modes) != 3 or len(ols) != 3 or not self_exchange_supported(
            block, modes, (1, 1, 1)):
        raise InvalidArgumentError(
            f"halo_self_exchange: modes {modes} unsupported for block {block}.")
    if any(m and not (2 <= o <= n - 1) for m, o, n in zip(modes, ols, block)):
        raise InvalidArgumentError(
            f"halo_self_exchange: overlaps {ols} must lie in [2, n-1] for block {block}.")
    return block, modes, ols


def halo_self_exchange_plain(a, *, modes, ols, block=None):
    """Plain PyTorch version of K3: each block's index remap as
    `index_select`s into a new tensor."""
    import torch

    block, modes, ols = _check_self(a, modes, ols, block)
    out = torch.empty_like(a)
    for sl in block_slices(a.shape, block):
        u = a[sl]
        for d in range(3):
            if modes[d]:
                u = u.index_select(d, _self_source(block[d], ols[d], a.device))
        out[sl] = u
    return out


def halo_self_exchange(a, *, modes, ols, block=None):
    """Exchange every self-neighbour halo (halowidth 1) of every block of
    stacked ``a`` in one pass: ``modes[d]`` flags a periodic single-rank
    dim, ``ols[d]`` its overlap. Out of place: returns a new tensor."""
    block, modes, ols = _check_self(a, modes, ols, block)
    if not _on_card(a):
        return halo_self_exchange_plain(a, modes=modes, ols=ols, block=block)
    import torch

    out = torch.empty_like(a)
    lib = library()
    with torch.cuda.device(a.device):
        rc = lib.igg_halo_self_exchange(
            a.element_size(), a.data_ptr(), out.data_ptr(),
            *(int(s) for s in a.shape), *block, *(int(m) for m in modes), *ols, _stream(a))
    check_rc(rc, "halo_self_exchange")
    count_launch("halo_self_exchange")
    return out


def combined_write_supported(shape, modes, hws) -> bool:
    """Whether `halo_write_combined` delivers the received slabs of a block
    of this LOCAL shape (the JAX gate of the same name): 3-D, dim 2
    exchanging, halowidth 1 on dims 1 and 2, and disjoint dim-0 halos."""
    if len(shape) != 3 or not modes[2]:
        return False
    if (modes[1] and int(hws[1]) != 1) or int(hws[2]) != 1:
        return False
    if modes[0] and int(shape[0]) < 2 * int(hws[0]):
        return False
    return True


def _check_combined(a, recvs, modes, hws, block):
    import torch

    if not isinstance(a, torch.Tensor) or a.dim() != 3 or not a.is_contiguous():
        raise InvalidArgumentError("halo_write_combined needs a contiguous 3-D tensor.")
    block = tuple(int(b) for b in block)
    modes = tuple(bool(m) for m in modes)
    hws = tuple(int(h) for h in hws)
    if len(block) != 3 or any(b < 1 or s % b for s, b in zip(a.shape, block)):
        raise InvalidArgumentError(
            f"block {block} does not tile the stacked shape {tuple(a.shape)}.")
    if not combined_write_supported(block, modes, hws) or any(
            m and block[d] < 2 * hws[d] for d, m in enumerate(modes)):
        raise InvalidArgumentError(
            f"halo_write_combined: modes {modes}, halowidths {hws} unsupported for "
            f"block {block}.")
    for d in range(3):
        if not modes[d]:
            continue
        want = list(a.shape)
        want[d] = a.shape[d] // block[d] * hws[d]
        for s in recvs[d]:
            if (list(s.shape) != want or s.dtype != a.dtype or s.device != a.device
                    or not s.is_contiguous()):
                raise InvalidArgumentError(
                    f"halo_write_combined: the slabs of dim {d} must be contiguous "
                    f"{tuple(want)} {a.dtype}; got {tuple(s.shape)} {s.dtype}.")
    return block, modes, hws


def halo_write_combined_plain(a, recvs, *, modes, hws, block=None):
    """Plain PyTorch version of K6: K2's plain writes in the z, x, y order."""
    block = tuple(a.shape) if block is None else tuple(int(b) for b in block)
    for d in (2, 0, 1):
        if modes[d]:
            halo_write_plain(a, *recvs[d], dim=d, hw=int(hws[d]), block=block[d])
    return a


def halo_write_combined(a, recvs, *, modes, hws, block=None):
    """Write the received slabs ``recvs[d] = (recv_l, recv_r)`` of every
    dim flagged in ``modes`` (width ``hws[d]``, K2's layout) into the halos
    of every block of stacked ``a``, in one pass, in place; returns ``a``. A
    y-halo row takes its received value, else an x-halo plane, else a
    z-halo lane: the reference's z, x, y write order."""
    try:
        slabs = tuple(s for d in range(3) if modes[d] for s in recvs[d])
    except (TypeError, KeyError, IndexError):
        slabs = (None,)  # the check raises
    block, modes, hws = _checked(_CALLS, lambda: _check_combined(
        a, recvs, modes, hws, tuple(a.shape) if block is None else block), (a, *slabs),
        "combined", modes, hws, block)
    _check_not_aliased(a, slabs, "halo_write_combined")
    if not _on_card(a):
        return halo_write_combined_plain(a, recvs, modes=modes, hws=hws, block=block)
    import torch

    slabs = [p.data_ptr() if modes[d] else None
             for d in range(3) for p in (recvs[d] if modes[d] else (None, None))]
    lib = library()
    with torch.cuda.device(a.device):
        rc = lib.igg_halo_write_combined(
            a.element_size(), a.data_ptr(), *slabs, *(int(s) for s in a.shape), *block,
            hws[0], _stream(a))
    check_rc(rc, "halo_write_combined")
    count_launch("halo_write_combined")
    return a


# ---------------------------------------------------------------------------
# K8 and K7: the pack and the multi-field unpack of the coalesced exchange.
# ---------------------------------------------------------------------------

def _block_counts(f, blk):
    """Blocks of stacked ``f`` along each of three dims (1 past its ndim);
    a leading member axis is not a dim."""
    shape = f.shape[f.dim() - len(blk):]
    return tuple(int(s) // int(n) for s, n in zip(shape, blk)) + (1,) * (3 - len(blk))


def _members(f, blk, schema, name):
    """Whether stacked ``f`` leads with the schema's member axis (an
    ensemble's field, one more axis than its block), else it has none and
    the schema one member."""
    M = int(schema.members)
    if f.dim() == len(blk) + 1 and int(f.shape[0]) == M:
        return True
    if f.dim() == len(blk) and M == 1:
        return False
    raise InvalidArgumentError(
        f"{name}: a field of shape {tuple(f.shape)} with block {tuple(blk)} does not hold "
        f"the schema's {M} member(s) on a leading axis.")


def _check_group(fields, schema, blocks, name):
    """Validate a group of stacked fields against ``schema``; returns
    (dim, block counts, blocks, halowidths). A field of a schema of E
    members leads with an axis of E (an ensemble's members)."""
    import torch

    dim = int(schema.dim)
    if not fields or len(fields) > MAX_SLABS or len(fields) != schema.n_slabs \
            or len(blocks) != len(fields):
        raise InvalidArgumentError(
            f"{name} takes 1 to {MAX_SLABS} fields, one slab of the schema and one block "
            f"shape each; got {len(fields)} fields for a {schema.n_slabs}-slab schema.")
    f0 = fields[0]
    counts = None
    blks, hws = [], []
    for f, blk, shp in zip(fields, blocks, schema.shapes):
        blk = tuple(int(b) for b in blk)
        if not isinstance(f, torch.Tensor) or not 1 <= len(blk) <= 3 or not f.is_contiguous():
            raise InvalidArgumentError(f"{name} needs contiguous 1-D to 3-D tensors.")
        if f.dtype != f0.dtype or f.device != f0.device \
                or dtype_name(f.dtype) != schema.state_dtype:
            raise InvalidArgumentError(
                f"{name}: every field must be {schema.state_dtype} on {f0.device}; got "
                f"{f.dtype} on {f.device}.")
        lead = int(_members(f, blk, schema, name))
        if any(b < 1 or s % b for s, b in zip(f.shape[lead:], blk)) or not dim < len(blk):
            raise InvalidArgumentError(
                f"{name}: block {blk} does not tile {tuple(f.shape)} along dim {dim}.")
        c = _block_counts(f, blk)
        if counts is not None and c != counts:
            raise InvalidArgumentError(f"{name}: the fields have different block counts.")
        counts = c
        want = list(blk)
        want[dim] = int(shp[dim]) if len(shp) == len(blk) else -1
        if tuple(want) != tuple(shp) or want[dim] < 1:
            raise InvalidArgumentError(
                f"{name}: slab {tuple(shp)} of the schema does not fit block {blk}.")
        blks.append(blk)
        hws.append(want[dim])
    return dim, counts, blks, hws


def _check_pack(fields, schema, blocks, starts_r, starts_l):
    dim, counts, blks, hws = _check_group(fields, schema, blocks, "wire_pack")
    if len(starts_r) != len(fields) or len(starts_l) != len(fields):
        raise InvalidArgumentError("wire_pack: one right and one left start a field.")
    for a, b, blk, hw in zip(starts_r, starts_l, blks, hws):
        if not (0 <= int(a) <= blk[dim] - hw and 0 <= int(b) <= blk[dim] - hw):
            raise InvalidArgumentError(
                f"wire_pack: slabs at {a} and {b} of width {hw} leave a block of {blk[dim]}.")
    return dim, counts, blks, hws


def _buffer_shape(schema, counts):
    """A wire buffer: a row a block, its members' payloads member-major."""
    return (int(np.prod(counts)), int(schema.members) * sum(schema.cells))


def _check_buffers(fields, bufs, schema, counts, name):
    import torch

    want = _buffer_shape(schema, counts)
    for b in bufs:
        if not isinstance(b, torch.Tensor) or tuple(b.shape) != want \
                or b.dtype != fields[0].dtype or b.device != fields[0].device \
                or not b.is_contiguous():
            raise InvalidArgumentError(
                f"{name}: wire buffers must be contiguous {want} {fields[0].dtype} on "
                f"{fields[0].device}.")
    _check_alias(fields, bufs, name)


def _check_alias(fields, bufs, name):
    stores = {f.untyped_storage().data_ptr() for f in fields}
    if any(b.untyped_storage().data_ptr() in stores for b in bufs):
        raise InvalidArgumentError(f"{name}: a wire buffer must not alias a field.")


# checked K7/K8 groups by call signature: [dim, block counts, blocks,
# halowidths, buffer shape, descriptor (built at the group's first launch)]
_GROUPS: dict = {}


def _group(check, schema, tensors, *extra):
    """The checked group of a kernel call (`_checked`, keyed also by
    ``schema``)."""
    def checked():
        dim, counts, blks, hws = check()
        return [dim, counts, blks, hws, _buffer_shape(schema, counts), None]

    return _checked(_GROUPS, checked, tensors, schema, *extra)


def _descriptor(g, fields, schema, starts):
    """The host descriptor of `igg_wire_pack` / `igg_halo_write_multi` for
    group ``g``: per slab its field pointer, block shape (padded to 3-D),
    halowidth, the two starts, its base and strides in a member's buffer,
    the plan `igg_coalesced_plan` fills in (the slab's tile counts and
    whether its rows copy in 16-byte words), and its member count and
    member stride (the elements between two members of the field; 0 for a
    field without a member axis). Built and planned at the group's first
    launch; a call fills in only the field pointers."""
    dim, counts, blks, _, shape, desc = g
    M = int(schema.members)
    if desc is None:
        vals = []
        for f, blk, (a, b), (base, st), shp in zip(fields, blks, starts, schema.slab_offsets(),
                                                   schema.shapes):
            blk3 = tuple(blk) + (1,) * (3 - len(blk))
            mstride = f[0].numel() if f.dim() > len(blk) else 0
            vals += [0, *blk3, int(shp[dim]), int(a), int(b), int(base), *st, 0, 0, 0, M,
                     mstride]
        desc = (ctypes.c_longlong * len(vals))(*vals)
        check_rc(library().igg_coalesced_plan(fields[0].element_size(), len(fields),
                                              ctypes.addressof(desc), *counts,
                                              shape[1] // M, dim), "coalesced plan")
        g[5] = desc
    for k, f in enumerate(fields):
        desc[k * _SLAB_DESC] = f.data_ptr()
    return desc


def _member_views(f, blk, M):
    """The members of stacked ``f``: its leading axis' views, or ``f``."""
    return [f[m] for m in range(M)] if f.dim() > len(blk) else [f]


def wire_pack_plain(fields, schema, *, starts_r, starts_l, blocks):
    """Plain PyTorch version of K8: each block's slabs of each member
    through `WireSchema.pack`, raveled into that block's row, member-major."""
    import torch

    dim, counts, blks, hws = _check_pack(fields, schema, blocks, starts_r, starts_l)
    shape = _buffer_shape(schema, counts)
    M = int(schema.members)
    out = []
    for starts in (starts_r, starts_l):
        buf = torch.empty(shape, dtype=fields[0].dtype, device=fields[0].device)
        rows = buf.view(shape[0], M, -1)
        for m in range(M):
            fm = [_member_views(f, blk, M)[m] for f, blk in zip(fields, blks)]
            per_field = [block_slices(f.shape, blk) for f, blk in zip(fm, blks)]
            for b, sls in enumerate(zip(*per_field)):
                slabs = [f[sl].narrow(dim, int(st), hw)
                         for f, sl, st, hw in zip(fm, sls, starts, hws)]
                rows[b, m] = schema.pack(slabs).reshape(-1)
        out.append(buf)
    return tuple(out)


def wire_pack(fields, schema, *, starts_r, starts_l, blocks):
    """K8: the wire buffers of a group of stacked ``fields`` along
    ``schema.dim``: row ``b`` of ``buf_r`` is `WireSchema.pack` of block
    ``b``'s right send slabs (local ``[starts_r[k], starts_r[k]+hw_k)`` of
    field k), raveled, for each of the schema's members in turn (fields of
    an E-member schema lead with the member axis); ``buf_l`` the same of the
    left send slabs. Blocks in row-major order of their coordinates. Returns
    ``(buf_r, buf_l)``, each ``(blocks, members x payload cells)``, in one
    launch."""
    starts = tuple(zip(starts_r, starts_l))
    g = _group(lambda: _check_pack(fields, schema, blocks, starts_r, starts_l), schema,
               fields, "pack", tuple(map(tuple, blocks)), starts)
    dim, counts, blks, _, shape = g[:5]
    f0 = fields[0]
    if not _on_card(f0):
        return wire_pack_plain(fields, schema, starts_r=starts_r, starts_l=starts_l,
                               blocks=blks)
    import torch

    buf_r = torch.empty(shape, dtype=f0.dtype, device=f0.device)
    buf_l = torch.empty(shape, dtype=f0.dtype, device=f0.device)
    desc = _descriptor(g, fields, schema, starts)
    with torch.cuda.device(f0.device):
        rc = library().igg_wire_pack(
            f0.element_size(), len(fields), ctypes.addressof(desc), buf_r.data_ptr(),
            buf_l.data_ptr(), *counts, shape[1] // int(schema.members), dim, _stream(f0))
    check_rc(rc, "wire_pack")
    count_launch("wire_pack")
    return buf_r, buf_l


def _halo_starts(blks, hws, dim):
    return tuple((0, blk[dim] - hw) for blk, hw in zip(blks, hws))


def _check_multi(fields, bufs, schema, blocks, disp):
    dim, counts, blks, hws = _check_group(fields, schema, blocks, "halo_write_multi")
    if any(blk[dim] < 2 * hw for blk, hw in zip(blks, hws)):
        raise InvalidArgumentError("halo_write_multi: left and right halos overlap.")
    if int(disp) < 0:
        raise InvalidArgumentError(f"halo_write_multi: disp {disp} < 0.")
    _check_buffers(fields, bufs, schema, counts, "halo_write_multi")
    return dim, counts, blks, hws


def halo_write_multi_plain(fields, buf_r, buf_l, schema, *, blocks, periodic, disp):
    """Plain PyTorch version of K7: for every block and member,
    `WireSchema.unpack` of the neighbour blocks' rows of that member, slice
    `copy_` into the halos."""
    dim, counts, blks, hws = _check_multi(fields, (buf_r, buf_l), schema, blocks, disp)
    D = counts[dim]
    M = int(schema.members)
    coords = list(itertools.product(*(range(c) for c in counts)))
    index = {c: b for b, c in enumerate(coords)}
    shape = schema.buffer_shape
    for m in range(M):
        fm = [_member_views(f, blk, M)[m] for f, blk in zip(fields, blks)]
        for c, sls in zip(coords, zip(*[block_slices(f.shape, blk)
                                        for f, blk in zip(fm, blks)])):
            for side, buf, shift in ((0, buf_r, -int(disp)), (1, buf_l, int(disp))):
                s = c[dim] + shift
                if periodic:
                    s %= D
                elif not 0 <= s < D:
                    continue  # PROC_NULL: the block keeps its halo
                src = list(c)
                src[dim] = s
                row = buf[index[tuple(src)]].view(M, -1)[m]
                slabs = schema.unpack(row.view(shape))
                for f, sl, blk, hw, slab in zip(fm, sls, blks, hws, slabs):
                    f[sl].narrow(dim, 0 if side == 0 else blk[dim] - hw, hw).copy_(slab)
    return list(fields)


def halo_write_multi(fields, buf_r, buf_l, schema, *, blocks, periodic, disp):
    """K7: write every field's halos along ``schema.dim`` on every block of
    the stacked ``fields`` (and every member, for an E-member schema), in
    place, in one launch: the left halo ``[0, hw)`` of block ``t`` from row
    ``t - disp`` of ``buf_r`` (the right send slabs), the right halo ``[n-hw,
    n)`` from row ``t + disp`` of ``buf_l``, each member from its own part of
    the row, unpacked by the schema (wrapping when ``periodic``; else an edge
    block keeps its halo). Returns the list of fields."""
    g = _group(lambda: _check_multi(fields, (buf_r, buf_l), schema, blocks, disp), schema,
               (*fields, buf_r, buf_l), "multi", tuple(map(tuple, blocks)), int(disp) >= 0)
    dim, counts, blks, hws, shape = g[:5]
    _check_alias(fields, (buf_r, buf_l), "halo_write_multi")
    f0 = fields[0]
    if not _on_card(f0):
        return halo_write_multi_plain(fields, buf_r, buf_l, schema, blocks=blks,
                                      periodic=periodic, disp=disp)
    import torch

    desc = _descriptor(g, fields, schema, _halo_starts(blks, hws, dim))
    with torch.cuda.device(f0.device):
        rc = library().igg_halo_write_multi(
            f0.element_size(), len(fields), ctypes.addressof(desc), buf_r.data_ptr(),
            buf_l.data_ptr(), *counts, shape[1] // int(schema.members), dim,
            int(bool(periodic)), int(disp), _stream(f0))
    check_rc(rc, "halo_write_multi")
    count_launch("halo_write_multi")
    return list(fields)
