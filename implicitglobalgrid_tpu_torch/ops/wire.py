"""The wire schema: how a group of send slabs packs into one buffer.

Counterpart of `implicitglobalgrid_tpu/ops/wire.py`. A `WireSchema` is
derived from the slab signature alone (slab shapes, state dtype, exchange
axis, `WireFormat`) and fixes:

- the **layout**: ``"slab"`` concatenates the send slabs along the
  exchange axis (every slab shares its cross extents); ``"flat"`` ravels
  each slab and concatenates (cross extents differ, as for staggered
  fields, or the payload is quantized: its per-slab scales ride a byte
  tail only a flat buffer has);
- the **wire dtype**: the state dtype, a narrower float cast, or int8
  bytes (bit-packed int4 included), per `precision.wire_format_for`;
- the **byte accounting**: ``payload_bytes``, one direction's payload,
  which `ops.halo.halo_comm_plan` prices and the transport sends;
- where each slab lies in the STAGING buffer, the state-dtype buffer the
  pack kernel K8 writes and the multi-field unpack kernel K7 reads
  (`slab_offsets`, `buffer_shape`; `staging` is the schema they take).

`encode_rows`/`decode_rows` are the codec, in plain PyTorch: K8's staging
rows (one row a block) to wire payloads and back. `pack`/`unpack` give one
block's payload from its slabs and back: the staging buffer, coded by the
same two functions. `SlabCodec` codes
the received slabs of the K4s routes block by block (`ops.halo`) and the
edge slabs the transport sends.

`CommCadence`/`resolve_comm_every` are the exchange cadence (the
``comm_every`` knob, ``IGG_COMM_EVERY``), and `WireStagePolicy`/
`resolve_wire_stage` the per-axis topology staging (``IGG_HALO_WIRE_STAGE``)
with its `StagedWireSchema` accounting, resolved as the JAX package
resolves them. The port's transport already sends one message a
neighbour process and dim holding every edge slab of the box, so a staged
axis moves the flat route's halos (bit-identical, as the JAX package
guarantees); the staging changes the grouping and the plan.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np

from ..utils.exceptions import InvalidArgumentError
from .precision import (
    SCALE_BYTES, _DIM_NAMES, _per_axis, decode_scales, dequantize_rows, dtype_name,
    encode_scales, narrow, quant_slab_bytes, quantize_rows,
)

__all__ = ["WireSchema", "slab_schema", "schema_for_fields", "dtype_name", "CommCadence",
           "resolve_comm_every", "WireStagePolicy", "resolve_wire_stage",
           "StagedWireSchema", "SlabCodec", "block_rows", "from_block_rows"]


@dataclass(frozen=True)
class CommCadence:
    """The resolved exchange cadence: one integer ``k >= 1`` per grid
    dimension (x, y, z); axis ``d`` exchanges once per ``k_d`` steps, 1
    being every step. The string form round-trips through
    `resolve_comm_every` (``"4"`` when uniform, else e.g. ``"z:4"``)."""

    per_dim: tuple

    def for_dim(self, dim: int) -> int:
        """Cadence along grid dimension ``dim`` (dims beyond the cadence,
        as a 2-D field's missing z, exchange every step)."""
        if 0 <= int(dim) < len(self.per_dim):
            return self.per_dim[int(dim)]
        return 1

    @property
    def uniform(self):
        """The single cadence when every dim shares one, else ``None``."""
        return self.per_dim[0] if len(set(self.per_dim)) == 1 else None

    @property
    def deep(self) -> bool:
        """Whether any axis runs a deep-halo cadence (``k > 1``)."""
        return any(k > 1 for k in self.per_dim)

    @property
    def cycle(self) -> int:
        """The super-cycle length, the lcm of the per-axis cadences: after
        ``cycle`` sub-steps every axis has just exchanged, so a deep
        runner's super-step advances this many physical steps."""
        return math.lcm(*self.per_dim)

    def retreats(self, j: int, ndim: int = 3) -> tuple:
        """Per-dim staleness at sub-step ``j`` of a super-cycle: the
        sub-steps since the last exchange along each dim (``j mod k_d``;
        an exchange lands after each sub-step with ``(j+1) % k_d == 0``)."""
        return tuple(int(j) % self.for_dim(d) for d in range(ndim))

    def due_dims(self, j: int, ndim: int = 3, order=None) -> tuple:
        """Grid dims whose exchange is due after sub-step ``j``, in the
        exchange order (default z, x, y: `ops.halo.DEFAULT_DIMS_ORDER`)."""
        if order is None:
            from .halo import DEFAULT_DIMS_ORDER

            order = DEFAULT_DIMS_ORDER
        return tuple(d for d in order if d < ndim and (int(j) + 1) % self.for_dim(d) == 0)

    def __str__(self) -> str:
        if self.uniform is not None:
            return str(self.uniform)
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
    per_dim = _per_axis(comm_every, "comm_every", "'<axis>:<k>' (e.g. 'z:4,x:1')", 1,
                        _parse_cadence_k)
    if per_dim is None:
        return CommCadence((_parse_cadence_k(comm_every),) * 3)
    return CommCadence(tuple(per_dim))


def _itemsize(name: str) -> int:
    if name == "bfloat16":
        return 2
    return int(np.dtype(name).itemsize)


@dataclass(frozen=True)
class WireSchema:
    """One direction's packing program for a group of same-dtype slabs.

    ``shapes`` are the send-slab shapes in pack order, ``dim`` the exchange
    axis, ``fmt`` the resolved `WireFormat` (None: the exact wire),
    ``layout`` ``"slab"`` or ``"flat"``, ``members`` the ensemble member
    count: a block's staging row and payload hold ``members`` member
    payloads, member-major (each member's slabs in pack order, and under a
    quantized format its own scales), as the JAX package's batched payload
    orders them. `pack`/`unpack` serve one member."""

    dim: int
    shapes: tuple          # per-slab shapes, pack order
    state_dtype: str       # dtype name
    fmt: object = None     # WireFormat | None
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
        return self.fmt is not None and self.fmt.is_quant

    @property
    def wire_dtype(self) -> str:
        """The dtype name the payload crosses in (``"int8"`` quantized)."""
        return self.state_dtype if self.fmt is None else self.fmt.dtype_name

    @property
    def member_payload(self) -> int:
        """Elements (of the wire dtype) of one member's payload: its cells,
        or its quantized bytes and scales."""
        if self.is_quant:
            return sum(quant_slab_bytes(c, self.fmt) for c in self.cells) \
                + SCALE_BYTES * self.n_slabs
        return sum(self.cells)

    @property
    def payload_bytes(self) -> int:
        """Exact bytes of one direction's payload: the quantized slabs and
        a `SCALE_BYTES` scale each, or every cell in the wire dtype; times
        ``members``."""
        per = self.member_payload * (1 if self.is_quant else _itemsize(self.wire_dtype))
        return per * max(1, int(self.members))

    @property
    def wire_key(self) -> str:
        """The `halo_comm_plan` ``by_dtype`` key of this payload (the format
        name for a quantized wire, the dtype name otherwise)."""
        return self.fmt.name if self.is_quant else self.wire_dtype

    @property
    def staging(self) -> "WireSchema":
        """The schema of the state-dtype buffer K8 packs and K7 unpacks (no
        wire format; the same layout)."""
        return self if self.fmt is None else replace(self, fmt=None)

    @property
    def buffer_shape(self) -> tuple:
        """The shape of one member's staging buffer: the concat shape (slab
        layout) or the payload's cell count (flat)."""
        if self.layout == "flat":
            return (sum(self.cells),)
        cat = list(self.shapes[0])
        cat[self.dim] = sum(int(s[self.dim]) for s in self.shapes)
        return tuple(cat)

    def slab_offsets(self):
        """Where each slab lies in one block's raveled staging buffer: per
        slab ``(base, strides)``, the element at slab index ``a`` sitting at
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
        """Pack the per-field send slabs (tensors of exactly ``shapes``, pack
        order) into ONE payload: the concat along ``dim`` (slab layout) or
        of the ravels (flat), then `encode_rows` of it under a wire format
        (cast to the wire dtype; quantized, each slab's int8 payload in
        order, then the scales' bytes)."""
        import torch

        if self.fmt is not None:
            return self.encode_rows(self.staging.pack(slabs))
        self._check(slabs)
        if self.layout == "flat":
            return torch.cat([s.reshape(-1) for s in slabs])
        if len(slabs) == 1:
            return slabs[0]
        return torch.cat(list(slabs), dim=self.dim)

    def unpack(self, buf):
        """Inverse of `pack`: the payload back into per-field slabs of
        ``shapes`` in the state dtype (views of ``buf`` on the exact wire,
        of its `decode_rows` otherwise)."""
        if self.fmt is not None:
            return self.staging.unpack(self.decode_rows(buf))
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

    def encode_rows(self, rows):
        """The payloads of staging rows ``rows`` (..., ``members`` x the sum
        of ``cells``; one block's raveled staging buffer a row, as K8 writes
        them; a cast takes any shape): each row's wire payload, as (...,
        ``members`` x `member_payload`) of the wire dtype, each member's
        slabs quantized against their own scales. The exact wire returns
        ``rows``."""
        if self.fmt is None:
            return rows
        if not self.is_quant:
            return narrow(rows, self.fmt.dtype)
        import torch

        if self.layout != "flat":
            raise InvalidArgumentError("a quantized payload takes the flat layout.")
        lead = rows.shape[:-1]
        flat = rows.reshape(-1, sum(self.cells))  # a (row, member) each
        parts, scales, off = [], [], 0
        for c in self.cells:
            q, s = quantize_rows(flat.narrow(1, off, c), self.fmt)
            parts.append(q)
            scales.append(s)
            off += c
        parts.append(encode_scales(torch.stack(scales, dim=1)))
        return torch.cat(parts, dim=1).reshape(lead + (-1,))

    def decode_rows(self, wire):
        """Inverse of `encode_rows`: payload rows back into staging rows of
        the state dtype (K7 reads them)."""
        if self.fmt is None:
            return wire
        out_dt = _torch_dtype(self.state_dtype)
        if not self.is_quant:
            return wire.to(out_dt)
        import torch

        lead = wire.shape[:-1]
        flat = wire.reshape(-1, self.member_payload)
        qsizes = [quant_slab_bytes(c, self.fmt) for c in self.cells]
        data = sum(qsizes)
        scales = decode_scales(flat.narrow(1, data, SCALE_BYTES * self.n_slabs), self.n_slabs)
        parts, off = [], 0
        for k, (c, qb) in enumerate(zip(self.cells, qsizes)):
            parts.append(dequantize_rows(flat.narrow(1, off, qb), scales[:, k], c, self.fmt,
                                         out_dt))
            off += qb
        return torch.cat(parts, dim=1).reshape(lead + (-1,))

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


def _torch_dtype(name: str):
    import torch

    return getattr(torch, name)


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
    shapes. ``fmt`` is the resolved `WireFormat` of the axis
    (`precision.wire_format_for`), or None for the exact wire; a quantized
    payload takes the flat layout. ``members``: the ensemble members a
    payload carries (`WireSchema.members`)."""
    from .precision import WireFormat, _parse_format

    shapes = tuple(tuple(int(v) for v in s) for s in shapes)
    if not shapes:
        raise InvalidArgumentError("slab_schema needs at least one slab.")
    if int(members) < 1:
        raise InvalidArgumentError(f"slab_schema: members must be >= 1; got {members}.")
    if fmt is not None and not isinstance(fmt, WireFormat):
        fmt = _parse_format(fmt)
    quant = fmt is not None and fmt.is_quant
    layout = "flat" if quant or not _slab_layout_ok(dim, shapes) else "slab"
    return WireSchema(dim=int(dim), shapes=shapes, state_dtype=dtype_name(state_dtype),
                      fmt=fmt, layout=layout, members=int(members))


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


# ---------------------------------------------------------------------------
# the received slabs of the K4s routes, block by block
# ---------------------------------------------------------------------------

def block_rows(t, blk):
    """The blocks of stacked ``t`` (blocks of shape ``blk``) as rows:
    (blocks in row-major order of their coordinates, raveled block)."""
    nd = t.dim()
    counts = [int(s) // int(b) for s, b in zip(t.shape, blk)]
    split = [v for c, b in zip(counts, blk) for v in (c, int(b))]
    perm = list(range(0, 2 * nd, 2)) + list(range(1, 2 * nd, 2))
    return t.reshape(split).permute(perm).reshape(int(np.prod(counts)), int(np.prod(blk)))


def from_block_rows(rows, shape, blk):
    """Inverse of `block_rows`: rows back into a stacked tensor of
    ``shape``."""
    nd = len(shape)
    counts = [int(s) // int(b) for s, b in zip(shape, blk)]
    v = rows.reshape(counts + [int(b) for b in blk])
    perm = [p for d in range(nd) for p in (d, nd + d)]
    return v.permute(perm).reshape(tuple(int(s) for s in shape))


class SlabCodec:
    """The wire of one field's slabs along one dim, block by block: ``fmt``
    the `WireFormat`, ``blk`` the LOCAL slab shape (the block with the dim
    at the halowidth). A stacked slab tensor (a whole number of such
    slabs along every dim) is one `WireSchema` payload a block, in
    row-major block order."""

    def __init__(self, fmt, blk, state_dtype):
        self.fmt = fmt
        self.blk = tuple(int(b) for b in blk)
        self.schema = slab_schema(0, [self.blk], state_dtype, fmt)

    def roundtrip(self, t):
        """``t`` as it arrives through the wire: cast and back, or every
        block's slab quantized and dequantized (a new tensor)."""
        if not self.fmt.is_quant:
            return narrow(t, self.fmt.dtype).to(t.dtype)
        rows = self.schema.decode_rows(self.schema.encode_rows(block_rows(t, self.blk)))
        return from_block_rows(rows, tuple(t.shape), self.blk)

    def encode(self, t):
        """The payload bytes of stacked slab tensor ``t`` (uint8, flat)."""
        import torch

        if not self.fmt.is_quant:
            return narrow(t, self.fmt.dtype).contiguous().reshape(-1).view(torch.uint8)
        return self.schema.encode_rows(block_rows(t, self.blk)).reshape(-1).view(torch.uint8)

    def nbytes(self, t) -> int:
        """Payload bytes of a stacked slab tensor shaped as ``t``."""
        blocks = int(np.prod([int(s) // b for s, b in zip(t.shape, self.blk)]))
        return blocks * self.schema.payload_bytes

    def decode_into(self, wire, out) -> None:
        """Write the slabs of payload bytes ``wire`` into ``out``."""
        import torch

        if not self.fmt.is_quant:
            out.copy_(wire.view(self.fmt.dtype).view(out.shape))
            return
        rows = self.schema.decode_rows(wire.view(torch.int8).view(-1, self.schema.payload_bytes))
        out.copy_(from_block_rows(rows, tuple(out.shape), self.blk))


# ---------------------------------------------------------------------------
# per-axis topology staging (the IGG_HALO_WIRE_STAGE knob's resolved form)
# ---------------------------------------------------------------------------

_STAGE_OFF = (None, "", "0", "off", "none", "flat", "false")
_STAGE_ON = ("staged", "hier", "hierarchical", "1", "on", "true")


def _parse_stage(token) -> bool:
    if isinstance(token, bool):
        return token
    if isinstance(token, str):
        token = token.strip().lower()
    if token in _STAGE_OFF:
        return False
    if token in _STAGE_ON:
        return True
    raise InvalidArgumentError(
        f"Unsupported halo wire stage {token!r}; supported: 'staged' "
        "(hierarchical gather->DCN->scatter) or 'flat'/'off'.")


@dataclass(frozen=True)
class WireStagePolicy:
    """Resolved per-mesh-axis topology staging: one bool per grid dimension
    (x, y, z), whether that axis's exchange is staged. An axis whose granule
    layout is degenerate (`parallel.topology.staged_wire_layout` returns
    None) keeps the flat wire. The string form round-trips through
    `resolve_wire_stage` (``"staged"``, ``"z:staged"``, ``"off"``)."""

    per_dim: tuple

    def for_dim(self, dim: int) -> bool:
        """Whether grid dimension ``dim`` is staged (dims beyond the policy
        stay flat)."""
        if 0 <= int(dim) < len(self.per_dim):
            return bool(self.per_dim[int(dim)])
        return False

    @property
    def any_staged(self) -> bool:
        return any(self.per_dim)

    @property
    def staged_dims(self) -> tuple:
        """Grid dims requesting the staged pipeline, ascending."""
        return tuple(d for d, s in enumerate(self.per_dim) if s)

    def __str__(self) -> str:
        if not self.any_staged:
            return "off"
        if all(self.per_dim):
            return "staged"
        return ",".join(f"{_DIM_NAMES[d]}:staged" for d in self.staged_dims)

    def __repr__(self) -> str:
        return f"WireStagePolicy({self})"


def resolve_wire_stage(wire_stage=None):
    """The requested topology staging as a `WireStagePolicy`, or None for
    the flat wire everywhere (the default). ``wire_stage=None`` consults
    ``IGG_HALO_WIRE_STAGE``; an explicit argument (``"off"`` included)
    wins. Accepted forms: ``"staged"`` (every axis), a per-axis spec
    ``"z:staged"`` / ``"z:staged,x:flat"`` (axes x/y/z or gx/gy/gz), a
    ``{axis: "staged" | bool}`` mapping, or a `WireStagePolicy`."""
    import os

    if wire_stage is None:
        wire_stage = os.environ.get("IGG_HALO_WIRE_STAGE")
    if isinstance(wire_stage, WireStagePolicy):
        return wire_stage if wire_stage.any_staged else None
    if isinstance(wire_stage, str):
        wire_stage = wire_stage.strip().lower()
    if wire_stage in _STAGE_OFF:
        return None
    per_dim = _per_axis(wire_stage, "wire stage", "'<axis>:staged' (e.g. 'z:staged')", False,
                        _parse_stage)
    if per_dim is None:
        return WireStagePolicy((True,) * 3) if _parse_stage(wire_stage) else None
    if not any(per_dim):
        return None
    return WireStagePolicy(tuple(per_dim))


@dataclass(frozen=True)
class StagedWireSchema:
    """One staged axis's three-stage wire accounting (the JAX package's
    ledger): the flat `WireSchema` payload plus the
    `parallel.topology.StagedWireLayout` routes it would travel (gather
    ``fold - 1`` hops along the gather axis, ONE striped transfer of
    ``fold`` payloads leader to leader across the granule boundary,
    scatter ``fold - 1`` hops back; same-granule pairs keep the flat
    pair). The port moves the flat route's halos (module docstring); this
    object prices the staged wire in `ops.halo.halo_comm_plan`."""

    schema: WireSchema
    layout: object  # parallel.topology.StagedWireLayout

    @property
    def fold(self) -> int:
        return int(self.layout.fold)

    @property
    def payload_bytes(self) -> int:
        """Bytes of ONE packed buffer (a gather, scatter or intra hop)."""
        return self.schema.payload_bytes

    @property
    def dcn_payload_bytes(self) -> int:
        return self.schema.payload_bytes * self.fold

    def stage_table(self) -> tuple:
        """Per (direction, stage) records ``{"direction", "stage", "ops",
        "pairs", "payload_bytes", "wire_bytes"}``, ``wire_bytes = ops *
        pairs * payload_bytes`` over the whole mesh."""
        out = []
        pb = self.payload_bytes
        f = self.fold
        for d in self.layout.directions:
            if d.intra_pairs_lin:
                out.append({"direction": d.name, "stage": "intra", "ops": 1,
                            "pairs": len(d.intra_pairs_lin), "payload_bytes": pb,
                            "wire_bytes": pb * len(d.intra_pairs_lin)})
            if not d.cross_pairs:
                continue
            out.append({"direction": d.name, "stage": "gather", "ops": f - 1,
                        "pairs": len(d.gather_pairs), "payload_bytes": pb,
                        "wire_bytes": (f - 1) * pb * len(d.gather_pairs)})
            out.append({"direction": d.name, "stage": "dcn", "ops": 1,
                        "pairs": len(d.dcn_pairs), "payload_bytes": pb * f,
                        "wire_bytes": pb * f * len(d.dcn_pairs)})
            out.append({"direction": d.name, "stage": "scatter", "ops": f - 1,
                        "pairs": len(d.scatter_pairs), "payload_bytes": pb,
                        "wire_bytes": (f - 1) * pb * len(d.scatter_pairs)})
        return tuple(out)

    @property
    def ppermute_ops(self) -> int:
        """Collective-permute ops of one exchange round on this axis."""
        return sum(r["ops"] for r in self.stage_table())

    @property
    def wire_bytes(self) -> int:
        """Absolute wire bytes of one exchange round on this axis."""
        return sum(r["wire_bytes"] for r in self.stage_table())

    @property
    def dcn_pair_count(self) -> int:
        """Granule-crossing source-target pairs per round (both
        directions)."""
        return sum(r["pairs"] for r in self.stage_table() if r["stage"] == "dcn")

    def flat_dcn_pair_count(self) -> int:
        """The flat wire's granule-crossing pair count on the same axis."""
        n_lines = 1
        for d, n in enumerate(self.layout.dims):
            if d != self.layout.dim:
                n_lines *= int(n)
        return sum(len(d.cross_pairs) for d in self.layout.directions) * n_lines
