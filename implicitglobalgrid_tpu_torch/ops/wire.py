"""The exact wire schema: how a group of send slabs packs into one buffer.

Counterpart of `WireSchema`, `_slab_layout_ok`, `slab_schema` and
`schema_for_fields` of `implicitglobalgrid_tpu/ops/wire.py`, for the exact
wire (the state dtype on the wire). A schema is derived from the slab
signature alone (slab shapes, state dtype, exchange axis) and fixes:

- the **layout**: ``"slab"`` concatenates the send slabs along the
  exchange axis (every slab shares its cross extents); ``"flat"`` ravels
  each slab and concatenates (cross extents differ, as for staggered
  fields);
- the **byte accounting**: ``payload_bytes``, one direction's buffer,
  which `ops.halo.halo_comm_plan` prices;
- where each slab lies in the buffer (`slab_offsets`), which the pack
  kernel K8 and the multi-field unpack kernel K7 (`ops/cuda_halo.py`) use
  as their addressing.

`pack`/`unpack` are the plain PyTorch program; on the virtual mesh every
block's buffer is what `pack` returns for that block's slabs, raveled.
Quantized and cast wire formats are not ported: a non-None ``fmt`` raises
`NotSupportedError`.

`CommCadence` and `resolve_comm_every` are the exchange cadence (the
``comm_every`` knob, ``IGG_COMM_EVERY``) resolved as the JAX package
resolves it; the models accept cadence 1 in any spelling and refuse a deep
one, which is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils.exceptions import InvalidArgumentError, NotSupportedError

__all__ = ["WireSchema", "slab_schema", "schema_for_fields", "dtype_name", "CommCadence",
           "resolve_comm_every"]

_LATER = "a later slice of the PyTorch port"


_AXIS_TOKENS = {"x": 0, "y": 1, "z": 2, "gx": 0, "gy": 1, "gz": 2}
_DIM_NAMES = ("x", "y", "z")


@dataclass(frozen=True)
class CommCadence:
    """The resolved exchange cadence: one integer ``k >= 1`` per grid
    dimension (x, y, z); axis ``d`` exchanges once per ``k_d`` steps, 1
    being every step. The string form round-trips through
    `resolve_comm_every` (``"4"`` when uniform, else e.g. ``"z:4"``)."""

    per_dim: tuple

    @property
    def deep(self) -> bool:
        """Whether any axis runs a deep-halo cadence (``k > 1``)."""
        return any(k > 1 for k in self.per_dim)

    def __str__(self) -> str:
        if len(set(self.per_dim)) == 1:
            return str(self.per_dim[0])
        parts = [f"{_DIM_NAMES[d]}:{k}" for d, k in enumerate(self.per_dim) if k != 1]
        return ",".join(parts) if parts else "1"


def _parse_cadence_k(token) -> int:
    try:
        k = int(str(token).strip())
    except (TypeError, ValueError):
        raise InvalidArgumentError(f"comm_every cadence must be an integer >= 1; got {token!r}.")
    if k < 1:
        raise InvalidArgumentError(f"comm_every cadence must be >= 1; got {k}.")
    return k


def resolve_comm_every(comm_every=None) -> CommCadence:
    """Resolve the requested exchange cadence to a `CommCadence` (the JAX
    package's resolver). ``comm_every=None`` consults ``IGG_COMM_EVERY``; an
    explicit argument wins over the environment; no argument and no (or an
    empty) variable is cadence 1. Accepted forms: an integer ``k`` or its
    string (every axis), a per-axis spec ``"z:4,x:1"`` (axes x/y/z or
    gx/gy/gz; unnamed axes 1), a ``{axis: k}`` mapping, or a
    `CommCadence`."""
    import os

    if comm_every is None:
        comm_every = os.environ.get("IGG_COMM_EVERY")
    if comm_every is None or comm_every == "":
        return CommCadence((1, 1, 1))
    if isinstance(comm_every, CommCadence):
        return comm_every
    if isinstance(comm_every, dict):
        items = list(comm_every.items())
    elif isinstance(comm_every, str) and ":" in comm_every:
        items = []
        for part in comm_every.split(","):
            part = part.strip()
            if not part:
                continue
            if ":" not in part:
                raise InvalidArgumentError(
                    f"Per-axis comm_every spec {comm_every!r}: entry {part!r} must be "
                    "'<axis>:<k>' (e.g. 'z:4,x:1').")
            items.append(tuple(part.split(":", 1)))
    else:
        return CommCadence((_parse_cadence_k(comm_every),) * 3)
    per_dim = [1, 1, 1]
    seen = set()
    for axis, k in items:
        dim = _AXIS_TOKENS.get(str(axis).strip().lower())
        if dim is None:
            raise InvalidArgumentError(
                f"Unknown mesh axis {axis!r} in comm_every spec (use x/y/z or gx/gy/gz).")
        if dim in seen:
            raise InvalidArgumentError(f"Mesh axis {axis!r} named twice in comm_every spec.")
        seen.add(dim)
        per_dim[dim] = _parse_cadence_k(k)
    return CommCadence(tuple(per_dim))


def _reject_fmt(fmt):
    if fmt is not None:
        raise NotSupportedError(f"wire formats (casts, quantization) are not ported yet "
                                f"({_LATER}).")


def dtype_name(dtype) -> str:
    """The numpy-style name of a torch or numpy dtype (``"float32"``,
    ``"bfloat16"``, ...)."""
    s = str(dtype)
    if s.startswith("torch."):
        return s[len("torch."):]
    if s == "bfloat16":  # a name already (numpy has no bfloat16)
        return s
    return np.dtype(dtype).name


def _itemsize(name: str) -> int:
    if name == "bfloat16":
        return 2
    return int(np.dtype(name).itemsize)


@dataclass(frozen=True)
class WireSchema:
    """One direction's packing program for a group of same-dtype slabs.

    ``shapes`` are the send-slab shapes in pack order, ``dim`` the exchange
    axis, ``layout`` ``"slab"`` or ``"flat"``, ``members`` the ensemble
    member count (1: the ensemble axis is not ported)."""

    dim: int
    shapes: tuple          # per-slab shapes, pack order
    state_dtype: str       # dtype name
    fmt: object = None     # exact wire only
    layout: str = "slab"
    members: int = 1

    @property
    def n_slabs(self) -> int:
        return len(self.shapes)

    @property
    def cells(self) -> tuple:
        """Per-slab element counts, pack order."""
        return tuple(int(np.prod(s)) for s in self.shapes)

    @property
    def is_quant(self) -> bool:
        return False

    @property
    def wire_dtype(self) -> str:
        return self.state_dtype

    @property
    def payload_bytes(self) -> int:
        """Exact bytes of one direction's packed buffer."""
        return sum(self.cells) * _itemsize(self.state_dtype) * max(1, int(self.members))

    @property
    def wire_key(self) -> str:
        """The `halo_comm_plan` ``by_dtype`` key of this payload."""
        return self.state_dtype

    @property
    def buffer_shape(self) -> tuple:
        """The shape `pack` returns: the concat shape (slab layout) or the
        payload's cell count (flat)."""
        if self.layout == "flat":
            return (sum(self.cells),)
        cat = list(self.shapes[0])
        cat[self.dim] = sum(int(s[self.dim]) for s in self.shapes)
        return tuple(cat)

    def slab_offsets(self):
        """Where each slab lies in one block's raveled buffer: per slab
        ``(base, strides)``, the element at slab index ``a`` sitting at
        ``base + sum(a[d] * strides[d])``. Shapes of fewer than 3 dims are
        padded with trailing 1s (strides 0)."""
        out = []
        if self.layout == "flat":
            base = 0
            for shp, c in zip(self.shapes, self.cells):
                st = _strides(shp)
                out.append((base, st + (0,) * (3 - len(st))))
                base += c
            return out
        st = _strides(self.buffer_shape)
        woff = 0
        for shp in self.shapes:
            out.append((woff * st[self.dim], st + (0,) * (3 - len(st))))
            woff += int(shp[self.dim])
        return out

    def pack(self, slabs):
        """Pack the per-field send slabs (tensors of exactly ``shapes``,
        pack order) into ONE buffer: the concat along ``dim`` (slab layout)
        or the concat of the ravels (flat layout)."""
        import torch

        self._check(slabs)
        if self.layout == "flat":
            return torch.cat([s.reshape(-1) for s in slabs])
        if len(slabs) == 1:
            return slabs[0]
        return torch.cat(list(slabs), dim=self.dim)

    def unpack(self, buf):
        """Inverse of `pack`: the buffer back into per-field slabs of
        ``shapes`` (views of ``buf``)."""
        out = []
        if self.layout == "flat":
            buf = buf.reshape(-1)
            off = 0
            for shp, c in zip(self.shapes, self.cells):
                out.append(buf.narrow(0, off, c).reshape(shp))
                off += c
            return out
        if self.n_slabs == 1:
            return [buf]
        off = 0
        for shp in self.shapes:
            w = int(shp[self.dim])
            out.append(buf.narrow(self.dim, off, w))
            off += w
        return out

    def _check(self, slabs) -> None:
        if len(slabs) != self.n_slabs:
            raise InvalidArgumentError(
                f"WireSchema.pack: {len(slabs)} slabs for a {self.n_slabs}-slab schema.")
        for s, shp in zip(slabs, self.shapes):
            if tuple(int(v) for v in s.shape) != shp:
                raise InvalidArgumentError(
                    f"WireSchema.pack: slab shape {tuple(s.shape)} does not match the "
                    f"schema's {shp}.")
            if dtype_name(s.dtype) != self.state_dtype:
                raise InvalidArgumentError(
                    f"WireSchema.pack: slab dtype {s.dtype} is not the schema's "
                    f"{self.state_dtype}.")


def _strides(shape) -> tuple:
    st, acc = [], 1
    for s in reversed(tuple(int(v) for v in shape)):
        st.append(acc)
        acc *= s
    return tuple(reversed(st))


def _slab_layout_ok(dim: int, shapes) -> bool:
    """Whether the slab (concat-along-axis) layout applies: every slab must
    share the cross-axis extents."""
    cross = None
    for shp in shapes:
        c = tuple(v for d, v in enumerate(shp) if d != dim)
        if cross is None:
            cross = c
        elif c != cross:
            return False
    return True


def slab_schema(dim: int, shapes, state_dtype, fmt=None, members: int = 1) -> WireSchema:
    """The canonical schema for one (axis, dtype group) from its slab
    shapes."""
    _reject_fmt(fmt)
    shapes = tuple(tuple(int(v) for v in s) for s in shapes)
    if not shapes:
        raise InvalidArgumentError("slab_schema needs at least one slab.")
    if int(members) != 1:
        raise NotSupportedError(f"ensemble batching is not ported yet ({_LATER}).")
    layout = "slab" if _slab_layout_ok(dim, shapes) else "flat"
    return WireSchema(dim=int(dim), shapes=shapes, state_dtype=dtype_name(state_dtype),
                      layout=layout)


def schema_for_fields(dim: int, shapes, hws, state_dtype, fmt=None,
                      members: int = 1) -> WireSchema:
    """`slab_schema` from FIELD shapes (local blocks): the send slab of a
    field along ``dim`` is its cross extents x the halowidth."""
    slab_shapes = []
    for shp, hw in zip(shapes, hws):
        s = [int(v) for v in shp]
        s[dim] = int(hw)
        slab_shapes.append(tuple(s))
    return slab_schema(dim, slab_shapes, state_dtype, fmt, members=members)
