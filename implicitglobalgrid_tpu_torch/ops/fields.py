"""Field abstraction: tensor + per-field halo widths.

Counterpart of `implicitglobalgrid_tpu/ops/fields.py`. A field is ONE stacked
tensor of shape ``box * local_shape`` on the process's device (``box``: the
ranks this process owns per dim, ``dims`` on the virtual mesh); the block of
the rank at box position ``c`` is the view starting at ``c * local_shape``
(`block_slices`).
"""

from __future__ import annotations

import itertools
from typing import Any, NamedTuple

import numpy as np

from ..parallel.topology import AXIS_NAMES, NDIMS, check_initialized, global_grid, ol
from ..utils.exceptions import IncoherentArgumentError, InvalidArgumentError

__all__ = [
    "Field", "wrap_field", "extract", "check_fields",
    "local_shape_of", "stacked_shape", "has_halo", "block_slices", "block_view",
    "is_global_shape", "field_partition_spec",
]


class Field(NamedTuple):
    """A field = tensor + per-dimension halo widths."""
    A: Any
    halowidths: tuple


def wrap_field(x, halowidths=None) -> Field:
    """Wrap ``x`` into a `Field`, defaulting halowidths from the grid.
    Accepts a `Field`, a mapping with keys ``A``/``halowidths``, or a bare
    tensor."""
    check_initialized()
    if isinstance(x, Field):
        if halowidths is not None:
            raise InvalidArgumentError("halowidths given both in the field and as argument.")
        return Field(x.A, tuple(int(h) for h in x.halowidths))
    if isinstance(x, dict) and "A" in x:
        return wrap_field(x["A"], x.get("halowidths", halowidths))
    if halowidths is None:
        halowidths = tuple(int(h) for h in global_grid().halowidths)
    elif np.isscalar(halowidths):
        halowidths = (int(halowidths),) * NDIMS
    else:
        halowidths = tuple(int(h) for h in halowidths)
        if len(halowidths) != NDIMS:
            raise InvalidArgumentError(f"halowidths must have {NDIMS} entries.")
    return Field(x, halowidths)


def extract(x):
    """Explode a container (dict/list/tuple of tensors) into a flat tuple of
    tensors/Fields."""
    if isinstance(x, Field) or hasattr(x, "shape"):
        return (x,)
    if isinstance(x, dict):
        if "A" in x:
            return (x,)
        return tuple(leaf for v in x.values() for leaf in extract(v))
    if isinstance(x, (list, tuple)):
        return tuple(leaf for v in x for leaf in extract(v))
    raise InvalidArgumentError(f"Unsupported field type: {type(x)}.")


def local_shape_of(shape, layout: str | None = None) -> tuple:
    """Infer the LOCAL (per-rank) shape of a tensor of ``shape``: stacked
    (``shape[d] == box[d] * l`` with ``l`` within one overlap of
    ``nxyz[d]``, ``box`` this process's ranks per dim) or already local.
    ``layout`` ("local"/"stacked") overrides the inference for ambiguous
    small blocks. Ranks beyond `NDIMS` lead with member axes (an ensemble
    state, `models.common.ensemble_state`), which every block holds whole,
    as the JAX package's `field_partition_spec` reads them."""
    if layout not in (None, "local", "stacked"):
        raise InvalidArgumentError(
            f"layout must be None, 'local' or 'stacked'; got {layout!r}.")
    gg = global_grid()
    if layout == "local":
        return tuple(int(s) for s in shape)
    lead = max(0, len(shape) - NDIMS)
    local = [int(s) for s in shape[:lead]]
    for d in range(len(shape) - lead):
        s = int(shape[lead + d])
        dd, n, tol = int(gg.box[d]), int(gg.nxyz[d]), int(gg.overlaps[d]) + 1
        if layout == "stacked":
            if s % dd != 0:
                raise IncoherentArgumentError(
                    f"Stacked array size {s} along dimension {d} is not divisible "
                    f"by the box's {dd} rank(s).")
            local.append(s // dd)
            continue
        if dd == 1:
            local.append(s)
            continue
        if abs(s - n) <= 1:
            local.append(s)
        elif s % dd == 0 and abs(s // dd - n) <= tol:
            local.append(s // dd)
        elif abs(s - n) <= tol:
            local.append(s)
        else:
            raise IncoherentArgumentError(
                f"Array size {s} along dimension {d} is neither a stacked size "
                f"({dd} rank(s) times ~nxyz[{d}]={n}) nor a local size (~{n})."
            )
    return tuple(local)


def stacked_shape(local_shape) -> tuple:
    """The stacked shape of this process's box of ``local_shape`` blocks
    (leading member axes beyond `NDIMS` kept whole)."""
    gg = global_grid()
    lead = max(0, len(local_shape) - NDIMS)
    return tuple(int(s) for s in local_shape[:lead]) + tuple(
        int(gg.box[d]) * int(s) for d, s in enumerate(local_shape[lead:]))


def field_partition_spec(ndim: int) -> tuple:
    """The mesh axis that splits each axis of a stacked ``ndim``-D field, as
    the JAX package's ``PartitionSpec`` names them: ``("gx", "gy",
    "gz")[:ndim]``, and beyond `NDIMS` leading member axes that no mesh
    axis splits (``None``; every block holds all members)."""
    ndim = int(ndim)
    if ndim < 1:
        raise InvalidArgumentError(f"A field has at least one axis; got ndim={ndim}.")
    if ndim > NDIMS:
        return (None,) * (ndim - NDIMS) + AXIS_NAMES
    return AXIS_NAMES[:ndim]


def is_global_shape(shape) -> bool:
    """Whether ``shape`` is the whole grid's stacked shape (``dims *
    local``) rather than this process's box (``box * local``): the
    reading whose block is nearer ``nxyz`` wins, a tie is the box. Always
    False on the virtual mesh, where the two are one. Leading member axes
    beyond `NDIMS` are not read."""
    gg = global_grid()
    if np.array_equal(gg.box, gg.dims):
        return False
    shape = tuple(shape)[max(0, len(shape) - NDIMS):]
    dist = {}
    for name, per in (("box", gg.box), ("global", gg.dims)):
        total = 0
        for d in range(min(len(shape), NDIMS)):
            s, k = int(shape[d]), int(per[d])
            if s % k:
                total = None
                break
            total += abs(s // k - int(gg.nxyz[d]))
        dist[name] = total
    if dist["global"] is None:
        return False
    return dist["box"] is None or dist["global"] < dist["box"]


def block_slices(stacked, local):
    """Yield the index tuple of every virtual rank's block of a stacked
    tensor (shape ``stacked``, block shape ``local``), in rank order."""
    counts = [int(s) // int(n) for s, n in zip(stacked, local)]
    for c in itertools.product(*(range(k) for k in counts)):
        yield tuple(slice(ci * int(n), (ci + 1) * int(n))
                    for ci, n in zip(c, local))


def block_view(A, local):
    """Stacked 3-D ``A`` of blocks ``local`` as a (D0, n0, D1, n1, D2, n2)
    view: local axis d is axis 2d+1 (``2d-5`` from the end), so one
    operation serves every block. Axes of ``A`` before its last three (an
    ensemble's members) lead the view unchanged."""
    lead = A.dim() - 3
    D = [int(s) // int(n) for s, n in zip(A.shape[lead:], local)]
    n = [int(v) for v in local]
    return A.view(*A.shape[:lead], D[0], n[0], D[1], n[1], D[2], n[2])


def has_halo(local_shape, halowidths, dim: int) -> bool:
    """A field participates in the halo update along ``dim`` iff its overlap
    is at least twice its halowidth."""
    if dim >= len(local_shape):
        return False
    return ol(dim, local_shape) >= 2 * int(halowidths[dim])


def check_fields(fields) -> None:
    """Validate fields for `update_halo` (the JAX package's checks)."""
    bad = [i for i, f in enumerate(fields)
           if any(int(f.halowidths[d]) < 1 for d in range(min(len(f.A.shape), NDIMS)))]
    if bad:
        raise InvalidArgumentError(
            f"The field(s) at position(s) {[i + 1 for i in bad]} have a halowidth less than 1."
        )
    no_halo = []
    for i, f in enumerate(fields):
        loc = local_shape_of(f.A.shape)
        if all(not has_halo(loc, f.halowidths, d) for d in range(len(loc))):
            no_halo.append(i)
    if no_halo:
        raise IncoherentArgumentError(
            f"The field(s) at position(s) {[i + 1 for i in no_halo]} have no halo; "
            "remove them from the call."
        )
    dup = [(i, j) for i in range(len(fields)) for j in range(i + 1, len(fields))
           if fields[i].A is fields[j].A]
    if dup:
        i, j = dup[0]
        raise IncoherentArgumentError(
            f"The field at position {j + 1} is a duplicate of the one at position {i + 1}; "
            "remove the duplicate from the call."
        )
    import torch

    unsupported = [i for i, f in enumerate(fields) if not isinstance(f.A, torch.Tensor)]
    if unsupported:
        raise InvalidArgumentError(
            f"The field(s) at position(s) {[i + 1 for i in unsupported]} do not have a "
            "supported array type (torch.Tensor)."
        )
