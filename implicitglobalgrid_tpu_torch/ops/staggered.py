"""Shared helpers of the fused staggered-field steps (the acoustic K9,
`cuda_wave.py`, and the Stokes K10, `cuda_stokes.py`): the four exchanged
fields (P, Vx, Vy, Vz) and their shapes, the gate and the index map of the
all-self route, the checks of a stacked state, its outputs and received
slabs, and the constants as 0-d tensors.

Counterpart of the parts of `implicitglobalgrid_tpu/ops/pallas_common.py`
that the plain versions need (`all_self_exchange`, the overlaps of
`self_recvs_and_ols`); the rest of that module is TPU operand wiring.
"""

from __future__ import annotations

from ..utils.exceptions import InvalidArgumentError

__all__ = ["FIELDS", "wave_shapes", "self_ols", "all_self_exchange", "self_index",
           "check_state", "check_out", "check_recvs", "check_self", "const_tensors", "into"]

FIELDS = ("P", "Vx", "Vy", "Vz")


def wave_shapes(block):
    """LOCAL (P, Vx, Vy, Vz) shapes for P's block (nx, ny, nz)."""
    nx, ny, nz = (int(b) for b in block)
    return {"P": (nx, ny, nz), "Vx": (nx + 1, ny, nz), "Vy": (nx, ny + 1, nz),
            "Vz": (nx, ny, nz + 1)}


def all_self_exchange(gg, modes) -> bool:
    """Whether every exchanging dim of the fields is self-neighbour (one
    rank, periodic): the gate of the fused steps' all-self route."""
    exch = [d for d in range(3) if any(m[d] for m in modes.values())]
    return bool(exch) and all(int(gg.dims[d]) == 1 and bool(gg.periods[d]) for d in exch)


def self_ols(gg, block):
    """Each field's overlap per dim (`ol`, grown by its staggering): the
    self-exchange of dim d maps index 0 to n-ol and n-1 to ol-1."""
    return {f: tuple(int(gg.overlaps[d]) + s[d] - int(gg.nxyz[d]) for d in range(3))
            for f, s in wave_shapes(block).items()}


def self_index(n_stack, n, ol, device):
    """Source index of every stacked index along a self-exchanging dim of
    blocks of length ``n``: 0 reads n-ol, n-1 reads ol-1, the rest itself."""
    import torch

    i = torch.arange(n_stack, device=device)
    loc = i % n
    src = torch.where(loc == 0, n - ol, torch.where(loc == n - 1, ol - 1, loc))
    return i - loc + src


def check_state(state, block, shapes_of, name):
    """Validate a stacked state whose fields have the LOCAL shapes
    ``shapes_of(block)`` (``{field: shape}``, P first, for P's block
    ``block``): contiguous stacked blocks of P's dtype (float32 or float64)
    and device. Returns (P block, block counts)."""
    import torch

    state = tuple(state)
    if not state or not all(isinstance(a, torch.Tensor) for a in state):
        raise InvalidArgumentError(f"{name} takes the state's tensors.")
    P = state[0]
    if P.dtype not in (torch.float32, torch.float64):
        raise InvalidArgumentError(f"{name} takes float32 or float64 states; got {P.dtype}.")
    block = tuple(int(b) for b in block)
    if len(block) != 3 or block[0] < 3 or min(block) < 1 or P.dim() != 3 \
            or any(s % b for s, b in zip(P.shape, block)):
        raise InvalidArgumentError(
            f"{name}: P block {block} (>= 3 planes) does not tile {tuple(P.shape)}.")
    shapes = shapes_of(block)
    if len(state) != len(shapes):
        raise InvalidArgumentError(f"{name} takes the {len(shapes)} tensors {tuple(shapes)}.")
    counts = tuple(int(s) // b for s, b in zip(P.shape, block))
    for a, (f, shp) in zip(state, shapes.items()):
        want = tuple(c * s for c, s in zip(counts, shp))
        if tuple(a.shape) != want or a.dtype != P.dtype or a.device != P.device \
                or not a.is_contiguous():
            raise InvalidArgumentError(
                f"{name}: {f} must be the contiguous stacked blocks {shp} ({counts} of "
                f"them) of P's dtype and device; got {tuple(a.shape)}.")
    return block, counts


def check_out(state, out, n, name):
    """``out``: the buffers of the first ``n`` fields of ``state`` (an entry
    for each field may be given; the rest are ignored), distinct, like the
    state and not aliasing it. Returns them as a tuple, or None."""
    if out is None:
        return None
    out = tuple(out)
    if len(out) not in (n, len(state)):
        raise InvalidArgumentError(f"{name}: out must hold {n} tensors.")
    out = out[:n]
    if len({o.untyped_storage().data_ptr() for o in out}) != n:
        raise InvalidArgumentError(f"{name}: the {n} outputs must not share storage.")
    stores = {a.untyped_storage().data_ptr() for a in state}
    for a, o in zip(state, out):
        if (tuple(o.shape) != tuple(a.shape) or o.dtype != a.dtype or o.device != a.device
                or not o.is_contiguous()):
            raise InvalidArgumentError(f"{name}: out must be contiguous tensors like the "
                                       "state.")
        if o.untyped_storage().data_ptr() in stores:
            raise InvalidArgumentError(f"{name}: out must not alias the state: the step "
                                       "reads it at its neighbours.")
    return out


def const_tensors(consts, like):
    """The constants ``{name: value}`` as 0-d tensors of ``like``'s dtype and
    device, so every operation of a plain version rounds as the kernel's."""
    import torch

    return {k: torch.tensor(float(v), dtype=like.dtype, device=like.device)
            for k, v in consts.items()}


def check_recvs(state, recvs, counts, out, name):
    """Received slabs ``{field: {dim: (recv_l, recv_r)}}`` of halowidth 1 in
    K2's layout for the fields (P, Vx, Vy, Vz) = ``state[:4]``; none may
    alias the state or ``out``."""
    stores = {a.untyped_storage().data_ptr() for a in tuple(state) + tuple(out or ())}
    for f, per_dim in recvs.items():
        if f not in FIELDS:
            raise InvalidArgumentError(f"{name}: unknown field {f!r} in recvs.")
        a = state[FIELDS.index(f)]
        for d, pair in per_dim.items():
            if not 0 <= int(d) < 3 or len(pair) != 2:
                raise InvalidArgumentError(f"{name}: no dim {d}.")
            want = list(a.shape)
            want[d] = counts[d]
            for s in pair:
                if (list(s.shape) != want or s.dtype != a.dtype or s.device != a.device
                        or not s.is_contiguous()):
                    raise InvalidArgumentError(
                        f"{name}: the slabs of {f} along dim {d} must be contiguous "
                        f"{tuple(want)} {a.dtype}; got {tuple(s.shape)} {s.dtype}.")
                if s.untyped_storage().data_ptr() in stores:
                    raise InvalidArgumentError(
                        f"{name}: a slab must not alias the state or the output.")


def check_self(modes, ols, block, name):
    """The overlaps of the self-exchanging dims fit their fields."""
    shp = wave_shapes(block)
    for f in FIELDS:
        for d in range(3):
            n = shp[f][d]
            if modes[f][d] and not 2 <= int(ols[f][d]) <= n - 1:
                raise InvalidArgumentError(
                    f"{name}: overlap {ols[f][d]} of {f} along dim {d} must lie in "
                    f"[2, {n - 1}].")


def into(out, new):
    """``new`` copied into ``out`` (returned), or ``new`` itself when
    ``out`` is None."""
    if out is None:
        return tuple(new)
    for o, n in zip(out, new):
        o.copy_(n)
    return tuple(out)
