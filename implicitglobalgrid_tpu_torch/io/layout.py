"""Implicit-grid ownership geometry: the one place the gather, reader and
reducer cell mapping lives.

Counterpart of `implicitglobalgrid_tpu/io/layout.py`, copied (pure numpy).
`ops/gather.gather_interior` defines the stacked -> implicit-global mapping:
along a sharded dim with local size ``n``, stride ``s = n - ol``, block
``c``'s local cell ``i`` is global cell

- non-periodic: ``c*s + i``; blocks overlap by ``ol`` and LATER blocks win
  ties (harmless: overlapping cells are equal after `update_halo`), so the
  OWNER of global cell ``p`` is ``min(p // s, dims-1)``;
- periodic: ``(c*s + i - 1) mod N`` with ``N = dims*s``; everything shifts
  by one ghost cell and wraps, the owner of ``p`` is ``p // s`` and its
  local index ``p - c*s + 1``.

The snapshot reader (`io/reader.py`) inverts this mapping on the host from
numpy meta alone, and the in-situ reducers (`io/reducers.py`) apply it to
every block of a process's box with ownership masks; both agree with
`gather_interior` bit for bit, so the arithmetic lives here once.
Plain host numpy over topology vectors (no torch, no live grid).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..utils.exceptions import InvalidArgumentError

__all__ = ["AxisGeometry", "axis_geometry", "field_geometry",
           "global_shape_of", "owner_maps", "normalize_box"]


class AxisGeometry(NamedTuple):
    """Per-dimension ownership record of one field's stacked layout.

    ``dd`` shards of local size ``n`` overlapping by ``ol`` (the FIELD's
    overlap: grid overlap plus staggering extra), stride ``s = n - ol``,
    covering ``size`` implicit-global cells, ``per``iodic or not."""
    dd: int
    n: int
    ol: int
    s: int
    per: bool
    size: int


def axis_geometry(dims, nxyz, overlaps, periods, n: int, d: int
                  ) -> AxisGeometry:
    """Geometry of dimension ``d`` for a field whose LOCAL size along it
    is ``n`` (staggered fields differ from ``nxyz[d]``; the difference
    joins the overlap, reference `ol(dim, A)` / `shared.jl:107`).

    Matches `gather_interior`'s shape rule exactly, including its
    single-shard non-periodic special case (``size == n``: the lone block
    is the global axis, overlap and all)."""
    if d >= 3 or (int(dims[d]) == 1 and not periods[d]):
        return AxisGeometry(1, n, 0, n, False, n)
    dd = int(dims[d])
    ol = int(overlaps[d]) + (n - int(nxyz[d]))
    s = n - ol
    per = bool(periods[d])
    size = dd * s if per else dd * s + ol
    return AxisGeometry(dd, n, ol, s, per, size)


def field_geometry(dims, nxyz, overlaps, periods, loc) -> tuple:
    """`axis_geometry` for every dimension of a field of LOCAL shape
    ``loc`` (any rank; dims beyond the third are trivially unsharded)."""
    return tuple(
        axis_geometry(dims, nxyz, overlaps, periods, int(loc[d]), d)
        for d in range(len(loc)))


def global_shape_of(geoms) -> tuple:
    """The field's implicit-global shape — `gather_interior`'s output
    shape for the same field."""
    return tuple(g.size for g in geoms)


def owner_maps(geom: AxisGeometry, g: np.ndarray):
    """For global cells ``g`` along one axis: the owning shard ``c_of[k]``
    and its block-local index ``i_of[k]`` (the `gather_interior`
    tie-breaking: later shards win the overlap)."""
    g = np.asarray(g, dtype=np.int64)
    if geom.per:
        c = g // geom.s
        i = g - c * geom.s + 1
    else:
        c = np.minimum(g // geom.s, geom.dd - 1)
        i = g - c * geom.s
    return c, i


def normalize_box(box, shape) -> tuple:
    """Validate a per-dimension ``(lo, hi)`` half-open box against the
    implicit-global ``shape``; ``None`` (whole box) and ``None`` entries
    (whole axis) are filled in. Returns a tuple of ``(lo, hi)`` pairs."""
    nd = len(shape)
    box = list(box) if box is not None else []
    if len(box) > nd:
        raise InvalidArgumentError(
            f"Box {tuple(box)} has more entries than the array has "
            f"dimensions ({nd}).")
    box = box + [None] * (nd - len(box))
    out = []
    for d in range(nd):
        if box[d] is None:
            out.append((0, int(shape[d])))
            continue
        lo, hi = (int(box[d][0]), int(box[d][1]))
        if not (0 <= lo < hi <= int(shape[d])):
            raise InvalidArgumentError(
                f"Box along dimension {d} must satisfy 0 <= lo < hi <= "
                f"{int(shape[d])}; got ({lo}, {hi}).")
        out.append((lo, hi))
    return tuple(out)
