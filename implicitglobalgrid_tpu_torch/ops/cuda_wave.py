"""The fused acoustic step K9 (`csrc/wave.cu`), the K4s wave modes, and their
plain versions.

Counterpart of `implicitglobalgrid_tpu/ops/pallas_wave.py` (what its plain
form needs from `ops/pallas_common.py` is in `staggered.py`):

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
from .staggered import (
    FIELDS, all_self_exchange, check_out, check_recvs, check_self, check_state,
    const_tensors, into, self_index, self_ols, wave_shapes,
)

__all__ = ["FIELDS", "wave_exchange_modes", "all_self_exchange", "self_ols",
           "wave_consts", "wave_shapes", "wave_update_plain", "wave_slabs",
           "wave_slabs_plain", "wave_update_slab", "acoustic_step_recv",
           "acoustic_step_recv_plain", "acoustic_step_self",
           "acoustic_step_self_plain", "acoustic_step_exchange", "wave_bytes"]


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


def wave_consts(*, rho, K, dt, dx, dy, dz):
    """The fused pass's constants (Python floats, rounded to the state dtype
    where they are used): cx, cy, cz = -dt/rho/d, dtK = dt*K, dx, dy, dz."""
    return dict(cx=-dt / rho / dx, cy=-dt / rho / dy, cz=-dt / rho / dz, dtK=dt * K,
                dx=float(dx), dy=float(dy), dz=float(dz))


_CONST_ORDER = ("cx", "cy", "cz", "dtK", "dx", "dy", "dz")


def wave_update_plain(state, *, block, consts):
    """The leapfrog update of every block of stacked ``state`` (P, Vx, Vy,
    Vz), no exchange: new stacked tensors in the fused pass's arithmetic.
    Constants are 0-d tensors of the state dtype, so every division is a
    true division."""
    block, _ = check_state(state, block, wave_shapes, "wave_update")
    P, Vx, Vy, Vz = state
    shp = wave_shapes(block)
    c = const_tensors({k: consts[k] for k in _CONST_ORDER}, P)
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
    block, counts = check_state(state, block, wave_shapes, "wave_slabs")
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
    return into(out, new)


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
                new[k] = U.index_select(d, self_index(U.shape[d], shp[f][d], ols[f][d],
                                                       U.device))
    return into(out, new)


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
    block, counts = check_state(state, block, wave_shapes, "acoustic_step")
    out = check_out(state, out, 4, "acoustic_step")
    check_recvs(state, recvs, counts, out, "acoustic_step")
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
    block, counts = check_state(state, block, wave_shapes, "acoustic_step")
    out = check_out(state, out, 4, "acoustic_step")
    check_self(modes, ols, block, "acoustic_step")
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
