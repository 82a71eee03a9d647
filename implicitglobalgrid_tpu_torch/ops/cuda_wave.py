"""The fused acoustic step K9 (`csrc/wave.cu`), the K4s wave modes, and their
plain versions.

Counterpart of `implicitglobalgrid_tpu/ops/pallas_wave.py` (and of what its
plain form needs from `ops/pallas_common.py`):

- `wave_exchange_modes`: the gate of the fused pass (the JAX function).
- `wave_update_plain`: the leapfrog update of every block of the state
  (P, Vx, Vy, Vz) in the fused pass's arithmetic (`_wave_plane_body`): the
  velocity faces ``v + cx*(P[i] - P[i-1])`` (boundary faces keep their
  value), then ``P - dtK*(((dvx/dx + dvy/dy) + dvz/dz))`` from the updated
  faces, with ``cx = -dt/rho/dx`` and ``dtK = dt*K`` rounded once to the
  state dtype.
- `wave_slabs` (K4s wave modes): the received slabs of one field along one
  dim for every block, the send slabs being that field updated
  (`_make_v_get_slab`, `_make_p_get_slab`); `wave_update_slab` is the same
  with identity moves (the getters themselves).
- `acoustic_step_recv` (K9, multi-rank route) and `acoustic_step_self` (K9,
  all-self route): the step of all four fields with their halos delivered,
  in one launch. `acoustic_step_exchange` is the entry point of
  `acoustic_step_exchange_pallas`: the all-self route, or the slab pipeline
  (`ops.halo.exchange_recv_slabs_multi` with K4s wave modes) then K9.

The VMEM relay, the multi-plane windows and Vx's extra planes
(`vx_extra_plane_slabs`) are TPU tiling: K9 writes every face itself. On a
CUDA tensor a wrapper launches its kernel (or raises); on a CPU tensor it
runs the plain version. Float32 and float64 states.
"""

from __future__ import annotations

import ctypes

from ..utils.exceptions import InvalidArgumentError
from .cuda_build import check_rc, count_launch, library
from .cuda_stencil import (
    Move, _check_slabs, _on_card, _slab_view, _stream, move_slabs_plain,
)
from .fields import block_view

__all__ = ["FIELDS", "wave_exchange_modes", "all_self_exchange", "self_ols",
           "wave_consts", "wave_shapes", "wave_update_plain", "wave_slabs",
           "wave_slabs_plain", "wave_update_slab", "acoustic_step_recv",
           "acoustic_step_recv_plain", "acoustic_step_self",
           "acoustic_step_self_plain", "acoustic_step_exchange", "wave_bytes"]

FIELDS = ("P", "Vx", "Vy", "Vz")


def wave_exchange_modes(gg, shapes):
    """Per-field participation modes of the fused acoustic step, or None
    (the JAX gate of the same name). ``shapes`` are the LOCAL (P, Vx, Vy, Vz)
    shapes; eligible when they follow the staggering (faces on +1 axes), P
    has at least 3 planes and every halowidth is 1. Returns ``{"P": modes,
    "Vx": ..., ...}``; all-False modes are the update alone."""
    from .halo import _dim_exchanges

    sp, sx, sy, sz = (tuple(int(v) for v in s) for s in shapes)
    if len(sp) != 3 or sp[0] < 3:
        return None
    if sp != tuple(int(n) for n in gg.nxyz):
        return None
    nx, ny, nz = sp
    if sx != (nx + 1, ny, nz) or sy != (nx, ny + 1, nz) or sz != (nx, ny, nz + 1):
        return None
    if any(int(h) != 1 for h in gg.halowidths):
        return None
    hws = (1, 1, 1)
    return {name: tuple(_dim_exchanges(gg, s, hws, d) for d in range(3))
            for name, s in zip(FIELDS, (sp, sx, sy, sz))}


def all_self_exchange(gg, modes) -> bool:
    """Whether every exchanging dim of the fields is self-neighbour (one
    rank, periodic): the gate of K9's all-self route."""
    exch = [d for d in range(3) if any(m[d] for m in modes.values())]
    return bool(exch) and all(int(gg.dims[d]) == 1 and bool(gg.periods[d]) for d in exch)


def wave_shapes(block):
    """LOCAL (P, Vx, Vy, Vz) shapes for P's block (nx, ny, nz)."""
    nx, ny, nz = (int(b) for b in block)
    return {"P": (nx, ny, nz), "Vx": (nx + 1, ny, nz), "Vy": (nx, ny + 1, nz),
            "Vz": (nx, ny, nz + 1)}


def self_ols(gg, block):
    """Each field's overlap per dim (`ol`, grown by its staggering): the
    self-exchange of dim d maps index 0 to n-ol and n-1 to ol-1."""
    return {f: tuple(int(gg.overlaps[d]) + s[d] - int(gg.nxyz[d]) for d in range(3))
            for f, s in wave_shapes(block).items()}


def wave_consts(*, rho, K, dt, dx, dy, dz):
    """The fused pass's constants (Python floats, rounded to the state dtype
    where they are used): cx, cy, cz = -dt/rho/d, dtK = dt*K, dx, dy, dz."""
    return dict(cx=-dt / rho / dx, cy=-dt / rho / dy, cz=-dt / rho / dz, dtK=dt * K,
                dx=float(dx), dy=float(dy), dz=float(dz))


_CONST_ORDER = ("cx", "cy", "cz", "dtK", "dx", "dy", "dz")


def _check_state(state, block, name):
    """Validate a stacked acoustic state; returns (P block, block counts)."""
    import torch

    if len(state) != 4 or not all(isinstance(a, torch.Tensor) for a in state):
        raise InvalidArgumentError(f"{name} takes the four tensors (P, Vx, Vy, Vz).")
    P = state[0]
    if P.dtype not in (torch.float32, torch.float64):
        raise InvalidArgumentError(f"{name} takes float32 or float64 states; got {P.dtype}.")
    block = tuple(int(b) for b in block)
    if len(block) != 3 or block[0] < 3 or min(block) < 1 or P.dim() != 3 \
            or any(s % b for s, b in zip(P.shape, block)):
        raise InvalidArgumentError(
            f"{name}: P block {block} (>= 3 planes) does not tile {tuple(P.shape)}.")
    counts = tuple(int(s) // b for s, b in zip(P.shape, block))
    for a, shp in zip(state, wave_shapes(block).values()):
        want = tuple(c * s for c, s in zip(counts, shp))
        if tuple(a.shape) != want or a.dtype != P.dtype or a.device != P.device \
                or not a.is_contiguous():
            raise InvalidArgumentError(
                f"{name}: the fields must be contiguous stacked blocks "
                f"{tuple(wave_shapes(block).values())} ({counts} of them) of one dtype and "
                f"device; got {tuple(a.shape)}.")
    return block, counts


def _check_out(state, out, name):
    if out is None:
        return
    if len(out) != 4:
        raise InvalidArgumentError(f"{name}: out must be four tensors.")
    if len({o.untyped_storage().data_ptr() for o in out}) != 4:
        raise InvalidArgumentError(f"{name}: the four outputs must not share storage.")
    stores = {a.untyped_storage().data_ptr() for a in state}
    for a, o in zip(state, out):
        if (tuple(o.shape) != tuple(a.shape) or o.dtype != a.dtype or o.device != a.device
                or not o.is_contiguous()):
            raise InvalidArgumentError(f"{name}: out must be four contiguous tensors like "
                                       "the state.")
        if o.untyped_storage().data_ptr() in stores:
            raise InvalidArgumentError(f"{name}: out must not alias the state: the step "
                                       "reads it at its neighbours.")


def _ctensors(consts, like):
    import torch

    return {k: torch.tensor(float(consts[k]), dtype=like.dtype, device=like.device)
            for k in _CONST_ORDER}


def wave_update_plain(state, *, block, consts):
    """The leapfrog update of every block of stacked ``state`` (P, Vx, Vy,
    Vz), no exchange: new stacked tensors in the fused pass's arithmetic.
    Constants are 0-d tensors of the state dtype, so every division is a
    true division."""
    block, _ = _check_state(state, block, "wave_update")
    P, Vx, Vy, Vz = state
    shp = wave_shapes(block)
    c = _ctensors(consts, P)
    Pb = block_view(P, shp["P"])
    outs = []
    for ax, (V, name, k) in enumerate(((Vx, "Vx", "cx"), (Vy, "Vy", "cy"), (Vz, "Vz", "cz"))):
        n = block[ax]
        U = V.clone()
        d = Pb.narrow(2 * ax + 1, 1, n - 1) - Pb.narrow(2 * ax + 1, 0, n - 1)
        Ub = block_view(U, shp[name])
        inner = Ub.narrow(2 * ax + 1, 1, n - 1)
        inner.copy_(inner + c[k] * d)
        outs.append(U)
    divs = []
    for ax, (U, name, k) in enumerate(zip(outs, ("Vx", "Vy", "Vz"), ("dx", "dy", "dz"))):
        Ub = block_view(U, shp[name])
        n = block[ax]
        divs.append((Ub.narrow(2 * ax + 1, 1, n) - Ub.narrow(2 * ax + 1, 0, n)) / c[k])
    div = (divs[0] + divs[1]) + divs[2]
    Pn = (Pb - c["dtK"] * div).reshape(P.shape)
    return (Pn, *outs)


# ---------------------------------------------------------------------------
# K4s wave modes: the send slabs of the fused step.
# ---------------------------------------------------------------------------

def wave_slabs_plain(state, field, dim, hw, moves, *, block, periodic, earlier=(), consts):
    """Plain PyTorch version of the K4s wave modes (same arguments as
    `wave_slabs`): the slab of `wave_update_plain`'s field, patched and
    moved as K4s's plain version does."""
    import torch

    f = FIELDS.index(field)
    U = wave_update_plain(state, block=block, consts=consts)[f]
    m = wave_shapes(block)[field]
    n = m[dim]

    def get_slab(start):
        return _slab_view(U, dim, n, start, hw).flatten(dim, dim + 1).clone(
            memory_format=torch.contiguous_format)

    return move_slabs_plain(get_slab, tuple(U.shape), U.device, dim, hw, moves, block=m,
                            periodic=periodic, earlier=earlier)


def wave_slabs(state, field, dim, hw, moves, *, block, periodic, earlier=(), consts):
    """K4s wave modes: the received slabs of width ``hw`` of ``field`` ("P",
    "Vx", "Vy" or "Vz") along ``dim`` for every block of the stacked acoustic
    ``state`` (P blocks ``block``), one for each `Move`, in one launch. The
    send slab is the field after the leapfrog update (`wave_update_plain`'s
    function, the per-cell functions K9 uses), patched with the ``earlier``
    dims' received slabs of that field and moved between blocks. Returns a
    tuple of new contiguous slabs in K2's layout."""
    if field not in FIELDS:
        raise InvalidArgumentError(f"wave_slabs: field must be one of {FIELDS}; got {field!r}.")
    block, counts = _check_state(state, block, "wave_slabs")
    f = FIELDS.index(field)
    m = wave_shapes(block)[field]
    dim, hw, _ = _check_slabs(state[f], dim, hw, moves, m, earlier, None, None)
    if len(state[f].shape) != 3:
        raise InvalidArgumentError("wave_slabs: 3-D fields only.")
    if not _on_card(state[0]):
        return wave_slabs_plain(state, field, dim, hw, moves, block=block, periodic=periodic,
                                earlier=earlier, consts=consts)
    import torch

    A = state[f]
    shape = list(A.shape)
    shape[dim] = counts[dim] * hw
    outs = [torch.empty(shape, dtype=A.dtype, device=A.device) for _ in moves]
    mv = [tuple(int(x) for x in mm) for mm in moves] + [(0, 0, 0)] * (2 - len(moves))
    ear = []
    eptr = []
    for e, hw_e, (rl, rr) in earlier:
        ear += [int(e), int(hw_e)]
        eptr += [rl.data_ptr(), rr.data_ptr()]
    ear += [-1, 0] * (2 - len(earlier))
    eptr += [None, None] * (2 - len(earlier))
    ptrs = (ctypes.c_void_p * 10)(*[a.data_ptr() for a in state],
                                  *[o.data_ptr() for o in outs] + [None] * (2 - len(outs)),
                                  *eptr)
    g = (ctypes.c_longlong * 19)(*block, *counts, dim, hw, int(bool(periodic)),
                                 *mv[0], *mv[1], *ear)
    c = (ctypes.c_double * 7)(*(float(consts[k]) for k in _CONST_ORDER))
    lib = library()
    with torch.cuda.device(A.device):
        rc = lib.igg_exchange_slabs_wave(
            0 if A.dtype == torch.float32 else 1, f, ctypes.addressof(ptrs),
            ctypes.addressof(g), ctypes.addressof(c), _stream(A))
    check_rc(rc, "exchange_slabs (wave)")
    count_launch("exchange_slabs")
    return tuple(outs)


def wave_update_slab(state, field, dim, starts, size, *, block, consts):
    """``field`` updated on ``[start, start+size)`` along ``dim`` of every
    block, for each of ``starts`` (K4s wave modes with the identity move,
    two ranges a launch): JAX's getters, in K2's layout."""
    moves = [Move(int(s), int(s), 0) for s in starts]
    out = []
    for k in range(0, len(moves), 2):
        out += wave_slabs(state, field, dim, size, moves[k:k + 2], block=block,
                          periodic=True, consts=consts)
    return out


# ---------------------------------------------------------------------------
# K9: the step of all four fields with the halo delivery.
# ---------------------------------------------------------------------------

def _check_recvs(state, recvs, counts, out):
    stores = {a.untyped_storage().data_ptr() for a in tuple(state) + tuple(out or ())}
    for f, per_dim in recvs.items():
        if f not in FIELDS:
            raise InvalidArgumentError(f"acoustic_step: unknown field {f!r} in recvs.")
        a = state[FIELDS.index(f)]
        for d, pair in per_dim.items():
            if not 0 <= int(d) < 3 or len(pair) != 2:
                raise InvalidArgumentError(f"acoustic_step: no dim {d}.")
            want = list(a.shape)
            want[d] = counts[d]
            for s in pair:
                if (list(s.shape) != want or s.dtype != a.dtype or s.device != a.device
                        or not s.is_contiguous()):
                    raise InvalidArgumentError(
                        f"acoustic_step: the slabs of {f} along dim {d} must be contiguous "
                        f"{tuple(want)} {a.dtype}; got {tuple(s.shape)} {s.dtype}.")
                if s.untyped_storage().data_ptr() in stores:
                    raise InvalidArgumentError(
                        "acoustic_step: a slab must not alias the state or the output.")


def _into(out, new):
    if out is None:
        return tuple(new)
    for o, n in zip(out, new):
        o.copy_(n)
    return tuple(out)


def acoustic_step_recv_plain(state, recvs, *, block, consts, out=None):
    """Plain PyTorch version of K9's multi-rank route: `wave_update_plain`,
    then each field's received slabs written in the z, x, y order (the
    fused pass's delivery; a pressure cell off every halo reads no
    delivered face, so its update is the fused pass's value)."""
    from .cuda_halo import halo_write_plain

    new = wave_update_plain(state, block=block, consts=consts)
    shp = wave_shapes(block)
    for f, U in zip(FIELDS, new):
        for d in (2, 0, 1):
            if d in recvs.get(f, {}):
                halo_write_plain(U, *recvs[f][d], dim=d, hw=1, block=shp[f][d])
    return _into(out, new)


def _self_index(n_stack, n, ol, device):
    import torch

    i = torch.arange(n_stack, device=device)
    loc = i % n
    src = torch.where(loc == 0, n - ol, torch.where(loc == n - 1, ol - 1, loc))
    return i - loc + src


def acoustic_step_self_plain(state, modes, ols, *, block, consts, out=None):
    """Plain PyTorch version of K9's all-self route: `wave_update_plain`,
    then every self-exchanging dim of each field as an index map onto the
    updated block (0 reads n-ol, n-1 reads ol-1)."""
    new = list(wave_update_plain(state, block=block, consts=consts))
    shp = wave_shapes(block)
    for k, f in enumerate(FIELDS):
        for d in range(3):
            if modes[f][d]:
                U = new[k]
                new[k] = U.index_select(d, _self_index(U.shape[d], shp[f][d], ols[f][d],
                                                       U.device))
    return _into(out, new)


def _check_self(modes, ols, block):
    shp = wave_shapes(block)
    for f in FIELDS:
        for d in range(3):
            n = shp[f][d]
            if modes[f][d] and not 2 <= int(ols[f][d]) <= n - 1:
                raise InvalidArgumentError(
                    f"acoustic_step: overlap {ols[f][d]} of {f} along dim {d} must lie in "
                    f"[2, {n - 1}].")


def _launch_k9(state, out, block, counts, consts, self_mode, slab_ptrs, modes, ols):
    import torch

    P = state[0]
    if out is None:
        out = tuple(torch.empty_like(a) for a in state)
    ptrs = (ctypes.c_void_p * 32)(*[a.data_ptr() for a in state],
                                  *[o.data_ptr() for o in out], *slab_ptrs)
    g = (ctypes.c_longlong * 30)(
        *block, *counts, *(int(bool(modes[f][d])) for f in FIELDS for d in range(3)),
        *(int(ols[f][d]) for f in FIELDS for d in range(3)))
    c = (ctypes.c_double * 7)(*(float(consts[k]) for k in _CONST_ORDER))
    lib = library()
    with torch.cuda.device(P.device):
        rc = lib.igg_acoustic_step_exchange(
            0 if P.dtype == torch.float32 else 1, int(self_mode), ctypes.addressof(ptrs),
            ctypes.addressof(g), ctypes.addressof(c), _stream(P))
    check_rc(rc, "acoustic_step_exchange")
    count_launch("acoustic_step_exchange")
    return tuple(out)


_NO_MODES = {f: (False, False, False) for f in FIELDS}


def acoustic_step_recv(state, recvs, *, block, consts, out=None):
    """K9, multi-rank route: one leapfrog step of every block of the stacked
    acoustic ``state`` with the received slabs ``recvs`` (``{field: {dim:
    (recv_l, recv_r)}}``, halowidth 1, K2's layout; may be empty: the update
    alone) delivered in the same pass, a y-halo row over an x-halo plane over
    a z-halo lane. Out of place: writes ``out`` (four tensors, allocated when
    None) and returns it."""
    block, counts = _check_state(state, block, "acoustic_step")
    _check_out(state, out, "acoustic_step")
    _check_recvs(state, recvs, counts, out)
    if not _on_card(state[0]):
        return acoustic_step_recv_plain(state, recvs, block=block, consts=consts, out=out)
    ptrs = []
    for f in FIELDS:
        for d in range(3):
            pair = recvs.get(f, {}).get(d)
            ptrs += [None, None] if pair is None else [p.data_ptr() for p in pair]
    return _launch_k9(state, out, block, counts, consts, False, ptrs, _NO_MODES,
                      {f: (0, 0, 0) for f in FIELDS})


def acoustic_step_self(state, modes, ols, *, block, consts, out=None):
    """K9, all-self route: one leapfrog step of every block with the halos of
    each field's self-exchanging dims (``modes[field][d]``, overlaps
    ``ols[field][d]``) folded in as an index map onto the updated cells, in
    one launch and with no slabs. Out of place, as `acoustic_step_recv`."""
    block, counts = _check_state(state, block, "acoustic_step")
    _check_out(state, out, "acoustic_step")
    _check_self(modes, ols, block)
    if not _on_card(state[0]):
        return acoustic_step_self_plain(state, modes, ols, block=block, consts=consts,
                                        out=out)
    return _launch_k9(state, out, block, counts, consts, True, [None] * 24, modes, ols)


def acoustic_step_exchange(state, gg, modes, *, rho, K, dt, dx, dy, dz, block, out=None):
    """One fused acoustic step (updates and the full exchange of all four
    fields) of every block of the stacked ``state``
    (`acoustic_step_exchange_pallas`). ``modes`` from `wave_exchange_modes`,
    ``block`` P's LOCAL shape. All-self grids: K9 alone. Otherwise the slab
    pipeline (`exchange_recv_slabs_multi`, one K4s wave-mode launch per
    exchanging (dim, field)) then K9."""
    from .halo import exchange_recv_slabs_multi

    consts = wave_consts(rho=rho, K=K, dt=dt, dx=dx, dy=dy, dz=dz)
    if all_self_exchange(gg, modes):
        return acoustic_step_self(state, modes, self_ols(gg, block), block=block,
                                  consts=consts, out=out)

    def slab_fn(field):
        def get(dim, hw, moves, periodic, earlier):
            return wave_slabs(state, field, dim, hw, moves, block=block, periodic=periodic,
                              earlier=earlier, consts=consts)
        return get

    recvs = exchange_recv_slabs_multi(gg, wave_shapes(block), (1, 1, 1), modes,
                                      {f: slab_fn(f) for f in FIELDS})
    return acoustic_step_recv(state, recvs, block=block, consts=consts, out=out)


def wave_bytes(state) -> int:
    """Least bytes the fused step must move: read the four fields once and
    write them once."""
    return 2 * sum(a.numel() * a.element_size() for a in state)
