"""Halo wire precision and stochastic-rounding bfloat16 storage.

Counterpart of `implicitglobalgrid_tpu/ops/precision.py`.

**The wire.** Float state may cross between blocks narrowed: as a float
CAST (``bfloat16``/``float16``/``float32``: cast, move, cast back) or as a
symmetric per-slab-scaled integer (``int8``, bit-packed ``int4``: quantize
each send slab against its own max-abs scale, move the int8 payload with
the f32 scales in a byte tail, dequantize). The policy is per mesh axis
(``"z:int8,x:f32"``), off by default, from ``IGG_HALO_WIRE_DTYPE`` or the
``wire_dtype=`` argument of the exchanges. `wire_format_for` decides which
states narrow: only real float state, a cast only where it strictly
narrows. PROC_NULL boundary halos and self-neighbour copies never go
through the wire format (`ops.halo`).

The codec (`quantize_slab`/`dequantize_slab` and their row forms
`quantize_rows`/`dequantize_rows`, which code many slabs of one length at
once) is plain PyTorch, bit for bit the JAX package's XLA arithmetic:
the scale is the max abs over the finite values (1 for an all-zero slab),
``round`` is half to even, and any non-finite element poisons its slab's
scale to NaN.

**Stochastic rounding.** `stochastic_round_bf16` rounds float32 to
bfloat16 up with the probability of the discarded fraction (unbiased), by
adding 16 random bits to the float32 bit pattern and keeping the top 16.
The JAX package draws the bits from a PRNG key; here they are an argument,
so the same bits give the same rounding. `sr_bits` makes them: a
counter-based integer hash of ``(seed, global step, the block's global
mesh coordinates, the cell within the block)`` in int64 tensor arithmetic,
so every block draws its own stream (the JAX package's
`shard_unique_fold`), the virtual mesh and any split of it over processes
draw the same bits, and the CPU and the card agree.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils.exceptions import InvalidArgumentError

__all__ = ["stochastic_round_bf16", "sr_bits",
           "resolve_wire_dtype", "wire_dtype_for", "wire_format_for",
           "WireFormat", "WirePolicy", "SCALE_BYTES",
           "quantize_slab", "dequantize_slab", "quantize_rows", "dequantize_rows",
           "encode_scales", "decode_scales", "quant_slab_bytes", "narrow"]

_WIRE_OFF = (None, "", "0", "off", "none")

# bytes of the f32 per-slab scale in the byte tail of a quantized payload
SCALE_BYTES = 4

# symmetric quantization levels: q in [-L, L]
_QUANT_LEVELS = {"int8": 127, "int4": 7}

_ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def dtype_name(dtype) -> str:
    """The numpy-style name of a torch or numpy dtype (``"float32"``,
    ``"bfloat16"``, ...)."""
    s = str(dtype)
    if s.startswith("torch."):
        return s[len("torch."):]
    if s == "bfloat16":  # a name already (numpy has no bfloat16)
        return s
    return np.dtype(dtype).name


@dataclass(frozen=True)
class WireFormat:
    """One on-wire format: a float cast (``bfloat16``/``float16``/
    ``float32``) or a symmetric per-slab-scaled integer quantization
    (``int8``, bit-packed ``int4``). ``name`` is canonical."""

    name: str

    @property
    def is_quant(self) -> bool:
        return self.name in _QUANT_LEVELS

    @property
    def levels(self) -> int:
        """Quantization levels L (q in [-L, L]); quantized formats only."""
        return _QUANT_LEVELS[self.name]

    @property
    def dtype(self):
        """The torch dtype elements of this format occupy on the wire
        (quantized payloads, bit-packed int4 included, are int8 bytes)."""
        import torch

        return {"bfloat16": torch.bfloat16, "float16": torch.float16,
                "float32": torch.float32}.get(self.name, torch.int8)

    @property
    def dtype_name(self) -> str:
        """The name of `dtype` (``"int8"`` for the quantized formats)."""
        return "int8" if self.is_quant else self.name

    @property
    def itemsize(self) -> int:
        return 1 if self.is_quant else _ITEMSIZE[self.name]

    def __str__(self) -> str:
        return self.name

    def __repr__(self) -> str:
        return f"WireFormat({self.name!r})"


# canonical names for every accepted wire-format spelling
_FORMAT_NAMES = {
    "bfloat16": "bfloat16", "bf16": "bfloat16",
    "float16": "float16", "f16": "float16", "fp16": "float16",
    "float32": "float32", "f32": "float32",
    "int8": "int8", "s8": "int8", "i8": "int8",
    "int4": "int4", "s4": "int4", "i4": "int4",
}
# per-axis spec tokens -> grid dimension index
_AXIS_TOKENS = {"x": 0, "y": 1, "z": 2, "gx": 0, "gy": 1, "gz": 2}
_DIM_NAMES = ("x", "y", "z")


def _parse_format(token):
    """One format token -> WireFormat, or None for the 'off' spellings."""
    if isinstance(token, WireFormat):
        return token
    if isinstance(token, str):
        token = token.strip().lower()
    if token in _WIRE_OFF:
        return None
    name = None
    if isinstance(token, str):
        name = _FORMAT_NAMES.get(token)
    else:
        try:
            name = _FORMAT_NAMES.get(dtype_name(token))
        except TypeError:
            name = None
    if name is None:
        raise InvalidArgumentError(
            f"Unsupported halo wire format {token!r}; supported: bfloat16, "
            "float16, float32, int8, int4 (or 'off').")
    return WireFormat(name)


def _per_axis(spec, what: str, entry: str, default, parse_value):
    """The per-dim values (x, y, z) of a per-axis spec, or None when
    ``spec`` names no axis: a ``{axis: value}`` mapping or a string
    ``"<axis>:<value>,..."`` (axes x/y/z or gx/gy/gz). Each named axis's
    value goes through ``parse_value``; the others take ``default``.
    ``what`` names the knob in errors, ``entry`` the form of one entry. The
    per-axis form of `resolve_wire_dtype`, `ops.wire.resolve_comm_every`
    and `ops.wire.resolve_wire_stage`."""
    if isinstance(spec, dict):
        items = list(spec.items())
    elif isinstance(spec, str) and ":" in spec:
        items = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if ":" not in part:
                raise InvalidArgumentError(
                    f"Per-axis {what} spec {spec!r}: entry {part!r} must be {entry}.")
            items.append(tuple(part.split(":", 1)))
    else:
        return None
    per_dim = [default] * 3
    seen = set()
    for axis, value in items:
        dim = _AXIS_TOKENS.get(str(axis).strip().lower())
        if dim is None:
            raise InvalidArgumentError(
                f"Unknown mesh axis {axis!r} in {what} spec (use x/y/z or gx/gy/gz).")
        if dim in seen:
            raise InvalidArgumentError(f"Mesh axis {axis!r} named twice in {what} spec.")
        seen.add(dim)
        per_dim[dim] = parse_value(value)
    return per_dim


@dataclass(frozen=True)
class WirePolicy:
    """Resolved per-mesh-axis wire policy: one `WireFormat` (or None,
    exact) per grid dimension (x, y, z). The string form round-trips
    through `resolve_wire_dtype` (``"int8"`` when uniform, else e.g.
    ``"x:float32,z:int8"``)."""

    per_dim: tuple

    def for_dim(self, dim: int):
        """The format along grid dimension ``dim`` (None: exact; dims
        beyond the policy, as a 2-D field's missing z, are exact)."""
        if 0 <= int(dim) < len(self.per_dim):
            return self.per_dim[int(dim)]
        return None

    @property
    def uniform(self):
        """The single format when every dim shares one, else None."""
        return self.per_dim[0] if len(set(self.per_dim)) == 1 else None

    def __str__(self) -> str:
        u = self.uniform
        if u is not None:
            return str(u)
        parts = [f"{_DIM_NAMES[d]}:{f}" for d, f in enumerate(self.per_dim) if f is not None]
        return ",".join(parts) if parts else "off"

    def __repr__(self) -> str:
        return f"WirePolicy({self})"


def _uniform_policy(fmt):
    return None if fmt is None else WirePolicy((fmt,) * 3)


def resolve_wire_dtype(wire_dtype=None):
    """The requested halo wire mode as a `WirePolicy`, or None for the
    exact wire (the default). ``wire_dtype=None`` consults
    ``IGG_HALO_WIRE_DTYPE``; an explicit argument (``"off"`` included) wins
    over the environment. Accepted forms: one format (``"bfloat16"``,
    ``"float16"``, ``"float32"``, ``"int8"``, ``"int4"``, their short
    spellings, or a torch/numpy dtype) on every axis; a per-axis spec
    ``"z:int8,x:f32"`` (axes x/y/z or gx/gy/gz; unnamed axes exact); a
    ``{axis: format}`` mapping; a `WireFormat`; a `WirePolicy`."""
    import os

    if wire_dtype is None:
        wire_dtype = os.environ.get("IGG_HALO_WIRE_DTYPE")
    if isinstance(wire_dtype, WirePolicy):
        return wire_dtype
    if isinstance(wire_dtype, str):
        wire_dtype = wire_dtype.strip().lower()
    if wire_dtype in _WIRE_OFF:
        return None
    per_dim = _per_axis(wire_dtype, "wire", "'<axis>:<format>' (e.g. 'z:int8,x:f32')", None,
                        _parse_format)
    if per_dim is None:
        return _uniform_policy(_parse_format(wire_dtype))
    if all(f is None for f in per_dim):
        return None
    return WirePolicy(tuple(per_dim))


def _as_policy(wire):
    """A resolved `WirePolicy`, or the raw format spellings older call
    sites pass."""
    if wire is None or isinstance(wire, WirePolicy):
        return wire
    if isinstance(wire, WireFormat):
        return _uniform_policy(wire)
    return _uniform_policy(_parse_format(wire))


_FLOATS = ("float16", "bfloat16", "float32", "float64")


def wire_format_for(state_dtype, wire, dim: int = 0):
    """The `WireFormat` halo payloads of ``state_dtype`` travel in along
    grid dimension ``dim`` under the resolved policy ``wire``, or None when
    they travel exact. Only real float state narrows (ints, bools and
    complex never convert); a float cast must strictly narrow; the
    quantized formats apply to every real float state."""
    policy = _as_policy(wire)
    if policy is None:
        return None
    fmt = policy.for_dim(dim)
    if fmt is None:
        return None
    name = dtype_name(state_dtype)
    if name not in _FLOATS:
        return None
    if fmt.is_quant:
        return fmt
    if fmt.itemsize >= (2 if name in ("float16", "bfloat16") else np.dtype(name).itemsize):
        return None
    return fmt


def narrow(t, dtype):
    """``t`` cast to the float ``dtype`` of a wire format, rounded as the
    JAX package's XLA conversion rounds it. XLA converts float64 to float16
    in one rounding, torch through float32 (rounding twice), so that cast
    goes through a float32 rounded to odd (the nearest float32 with its
    last bit set wherever the float32 is inexact), which the second
    rounding turns into the nearest float16. Float64 to bfloat16 rounds
    through float32 in both."""
    import torch

    if t.dtype != torch.float64 or dtype != torch.float16:
        return t.to(dtype)
    y = t.to(torch.float32)
    inexact = (y.to(torch.float64) != t) & torch.isfinite(y)
    even = (y.view(torch.int32) & 1) == 0
    toward = torch.where(t > y.to(torch.float64), torch.full_like(y, float("inf")),
                         torch.full_like(y, float("-inf")))
    y = torch.where(inexact & even, torch.nextafter(y, toward), y)
    return y.to(dtype)


def wire_dtype_for(state_dtype, wire, dim: int = 0):
    """The torch dtype of the halo payloads of ``state_dtype`` along
    ``dim`` under ``wire``, or None for the exact wire (quantized payloads
    report int8, the dtype their bytes occupy)."""
    fmt = wire_format_for(state_dtype, wire, dim)
    return None if fmt is None else fmt.dtype


# ---------------------------------------------------------------------------
# symmetric per-slab quantization (the int8/int4 payload codec)
# ---------------------------------------------------------------------------

def quant_slab_bytes(cells: int, fmt) -> int:
    """Wire bytes of one quantized slab of ``cells`` elements, without its
    `SCALE_BYTES` scale: one a cell for int8, one a nibble pair for int4
    (an odd slab pads one nibble)."""
    cells = int(cells)
    return (cells + 1) // 2 if fmt.name == "int4" else cells


def _to_int8(v):
    """int values in [0, 256) (or [-128, 128)) -> the int8 of their low
    byte, without relying on an overflowing cast."""
    import torch

    v = v & 0xFF
    return torch.where(v >= 128, v - 256, v).to(torch.int8)


def _pack_int4(q):
    """Bit-pack int8 values in [-7, 7] two a byte along the last axis (low
    nibble first; an odd length pads one zero nibble)."""
    import torch

    q = q.to(torch.int32)
    if q.shape[-1] % 2:
        q = torch.cat([q, q.new_zeros(q.shape[:-1] + (1,))], dim=-1)
    lo = q[..., 0::2] & 0x0F
    hi = (q[..., 1::2] & 0x0F) << 4
    return _to_int8(lo | hi)


def _unpack_int4(b, n: int):
    """Inverse of `_pack_int4`: ``n`` sign-extended int8 values a row."""
    import torch

    b = b.to(torch.int32)
    lo = b & 0x0F
    hi = (b >> 4) & 0x0F
    q = torch.stack([lo, hi], dim=-1).flatten(-2)[..., :n]
    return ((q ^ 8) - 8).to(torch.int8)


def quantize_rows(x, fmt):
    """Quantize every row of ``x`` (rows, cells) against its own max-abs
    scale: ``(payload, scale)``, the int8 payload (rows, `quant_slab_bytes`)
    and the float32 scale a row. Each row is `quantize_slab` of it, bit for
    bit."""
    import torch

    x = x.to(torch.float32)
    finite = torch.isfinite(x)
    amax = torch.where(finite, x.abs(), torch.zeros((), dtype=x.dtype, device=x.device))
    amax = amax.amax(dim=-1) if x.shape[-1] else x.new_zeros(x.shape[:-1])
    one = torch.ones((), dtype=x.dtype, device=x.device)
    scale = torch.where(amax > 0, amax, one)
    L = fmt.levels
    z = torch.where(finite, x, torch.zeros((), dtype=x.dtype, device=x.device))
    q = torch.clamp(torch.round(z / scale.unsqueeze(-1) * L), -L, L).to(torch.int8)
    nan = torch.full((), float("nan"), dtype=x.dtype, device=x.device)
    scale = torch.where(finite.all(dim=-1), scale, nan)
    if fmt.name == "int4":
        q = _pack_int4(q)
    return q, scale


def dequantize_rows(payload, scale, n: int, fmt, out_dtype):
    """Inverse of `quantize_rows`: the int8 ``payload`` (rows, bytes) and
    the scale a row -> (rows, ``n``) elements of ``out_dtype``.

    The arithmetic is that of the JAX package's compiled exchanges: XLA
    folds ``(q / L) * scale`` into ``q * (scale * (1 / L))`` with ``1 / L``
    a float32 constant (it differs from the written order in the last bit
    for about a third of the values), except for a one-cell slab, which it
    computes as written."""
    import torch

    q = _unpack_int4(payload, n) if fmt.name == "int4" else payload
    scale = scale.to(torch.float32).unsqueeze(-1)
    if int(n) == 1:
        return ((q.to(torch.float32) / fmt.levels) * scale).to(out_dtype)
    inv = torch.tensor(np.float32(1) / np.float32(fmt.levels), device=payload.device)
    return (q.to(torch.float32) * (scale * inv)).to(out_dtype)


def quantize_slab(flat, fmt):
    """Quantize one flat float slab symmetrically against its own max-abs
    scale: ``(payload, scale)``, the int8 payload (`quant_slab_bytes`
    long) and the float32[1] scale (the slab's max |finite value|).

    A constant slab quantizes to +/-L (and returns within one float32 ulp,
    `dequantize_rows`); an all-zero slab takes scale 1. Any non-finite element
    poisons the slab's scale to NaN, so its dequantized halo is wholly
    non-finite; float64 magnitudes beyond the float32 range poison the
    same way (the scale is float32)."""
    q, s = quantize_rows(flat.reshape(1, -1), fmt)
    return q[0], s


def dequantize_slab(payload, scale, n: int, fmt, out_dtype):
    """Inverse of `quantize_slab`: int8 ``payload`` + float32 ``scale`` ->
    ``n`` elements of ``out_dtype``."""
    return dequantize_rows(payload.reshape(1, -1), scale.reshape(1), n, fmt, out_dtype)[0]


def encode_scales(scales):
    """The float32 per-slab scales (a list of [1]-tensors, or one tensor
    whose last axis holds them) as the int8 tail of a quantized payload,
    `SCALE_BYTES` bytes each (the float32 bytes, little-endian)."""
    import torch

    if isinstance(scales, (list, tuple)):
        scales = torch.cat([s.to(torch.float32).reshape(-1) for s in scales])
    v = scales.to(torch.float32).contiguous()
    return v.view(torch.int8).reshape(v.shape[:-1] + (-1,))


def decode_scales(tail, n: int):
    """Inverse of `encode_scales`: int8[..., 4n] tail -> float32[..., n]."""
    import torch

    t = tail.clone(memory_format=torch.contiguous_format)  # a fresh, aligned copy
    return t.view(torch.float32).reshape(t.shape[:-1] + (n,))


# ---------------------------------------------------------------------------
# stochastic rounding
# ---------------------------------------------------------------------------

def stochastic_round_bf16(x, bits):
    """Round float32 ``x`` to bfloat16 stochastically (unbiased: E[out] ==
    x). ``bits`` holds one uniform 16-bit integer a cell (any integer
    dtype, values in [0, 65536)): it is added to the float32 bit pattern,
    which is then cut to its top 16 bits, so the value rounds away from
    zero with the probability of the discarded fraction. Non-finite
    inputs round to nearest; at the top of the finite range the carry may
    round into inf."""
    import torch

    x = x.to(torch.float32)
    u = (x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF) \
        + (bits.to(torch.int64) & 0xFFFF)
    hi = (u >> 16) & 0xFFFF
    sr = torch.where(hi >= 0x8000, hi - 0x10000, hi).to(torch.int16).view(torch.bfloat16)
    # a NaN rounds to the canonical quiet NaN of its sign, as XLA converts it
    nan = torch.where(torch.signbit(x), -0x40, 0x7FC0).to(torch.int16).view(torch.bfloat16)
    return torch.where(torch.isfinite(x), sr, torch.where(torch.isnan(x), nan,
                                                          x.to(torch.bfloat16)))


_M32 = 0xFFFFFFFF


def _mix32(x):
    """An avalanching 32-bit integer hash (int64 tensors or Python ints in
    [0, 2^32)); every product stays below 2^63."""
    x = x ^ (x >> 16)
    x = (x * 0x45D9F3B) & _M32
    x = x ^ (x >> 16)
    x = (x * 0x45D9F3B) & _M32
    return x ^ (x >> 16)


# (stacked shape, block, first coords, dims, device) -> every cell's global id
_CELL_IDS: dict = {}


def _cell_ids(shape, block, coords, dims, device):
    """Every cell's id ``rank * cells_per_block + cell``: ``rank`` the
    linear (row-major) index of its block's global mesh coordinates
    (``coords`` the box's first), ``cell`` its linear index in the block."""
    import torch

    key = (tuple(shape), tuple(block), tuple(coords), tuple(dims), str(device))
    ids = _CELL_IDS.get(key)
    if ids is not None:
        return ids
    nd = len(shape)
    rank = torch.zeros((1,) * nd, dtype=torch.int64, device=device)
    cell = torch.zeros((1,) * nd, dtype=torch.int64, device=device)
    for d in range(nd):
        i = torch.arange(int(shape[d]), dtype=torch.int64, device=device)
        view = [1] * nd
        view[d] = -1
        rank = rank * int(dims[d]) + (i // int(block[d]) + int(coords[d])).view(view)
        cell = cell * int(block[d]) + (i % int(block[d])).view(view)
    ids = rank * int(np.prod(block)) + cell
    if len(_CELL_IDS) > 8:
        _CELL_IDS.clear()
    _CELL_IDS[key] = ids
    return ids


def sr_bits(shape, block, coords, dims, seed: int, n: int, device):
    """The 16 random bits of every cell of a stacked tensor of ``shape``
    (blocks of ``block``; ``coords`` the global mesh coordinates of its
    first block, ``dims`` the mesh) for global step ``n`` of the run seeded
    ``seed``: a hash of (seed, n, the cell's global id), as int64 in [0,
    65536). A block's bits depend on its mesh coordinates, not on which
    process holds it."""
    ids = _cell_ids(shape, block, coords, dims, device)
    k1 = _mix32((_mix32(int(seed) & _M32) + (int(n) & _M32) * 0x9E3779B1) & _M32)
    k2 = _mix32(k1 ^ 0x85EBCA6B)
    h = _mix32((ids & _M32) ^ k1)
    h = _mix32(h ^ ((ids >> 32) & _M32) ^ k2)
    return h >> 16
