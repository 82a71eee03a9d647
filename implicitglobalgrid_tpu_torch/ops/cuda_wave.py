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
- `wave_slabs_multi` (K4s wave modes): the received slabs of one dim for
  every field of a group and every block, in one launch, the send slabs
  being each field updated (`_make_v_get_slab`, `_make_p_get_slab`);
  `wave_slabs` is one field's, `wave_update_slab` the same with identity
  moves (the getters themselves).
- `acoustic_step_recv` (K9, multi-rank route) and `acoustic_step_self` (K9,
  all-self route): the step of all four fields with their halos delivered,
  in one launch. `AcousticStep` is `acoustic_step_exchange_pallas` on one
  grid, resolved once for a run: the all-self route, or the slab pipeline
  (`ops.halo.exchange_recv_slabs_multi`, one K4s wave-mode launch a dim)
  then K9; `acoustic_step_exchange` is the same for one call.

The VMEM relay, the multi-plane windows and Vx's extra planes
(`vx_extra_plane_slabs`) are TPU tiling: K9 writes every face itself. On a
CUDA tensor a wrapper launches its kernel (or raises); on a CPU tensor it
runs the plain version. Float32, float64 and bfloat16 states; a bfloat16
state computes each operation in float32 and rounds its result to
bfloat16, with bfloat16 constants, as JAX's Pallas kernel and PyTorch's
bfloat16 operations do.
"""

from __future__ import annotations

import ctypes

from .cuda_build import check_rc, count_launch, library
from .cuda_stencil import Move, _on_card, _stream
from .fields import block_view
from .staggered import (
    FIELDS, NO_MODES, NO_OLS, SlabBatch, all_self_exchange, check_out, check_recvs, check_self,
    check_slab_batch, check_state, const_tensors, dtype_code, into, self_index, self_ols,
    slab_batch_plain, slab_ptrs, step_args, wave_shapes,
)

__all__ = ["FIELDS", "DTYPES", "wave_exchange_modes", "all_self_exchange", "self_ols",
           "wave_consts", "wave_shapes", "wave_update_plain", "wave_slabs_multi",
           "wave_slabs_multi_plain", "wave_slabs", "wave_slabs_plain", "wave_update_slab",
           "acoustic_step_recv", "acoustic_step_recv_plain", "acoustic_step_self",
           "acoustic_step_self_plain", "AcousticStep", "acoustic_step_exchange",
           "wave_bytes"]

DTYPES = ("float32", "float64", "bfloat16")  # the acoustic kernels' state dtypes


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
    block, _ = check_state(state, block, wave_shapes, "wave_update", DTYPES)
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

def wave_slabs_multi_plain(state, dim, hw, per_field, *, block, periodic, consts):
    """Plain PyTorch version of the K4s wave modes (same arguments as
    `wave_slabs_multi`): the slabs of `wave_update_plain`'s fields, patched
    and moved as K4s's plain version does."""
    new = wave_update_plain(state, block=block, consts=consts)
    return slab_batch_plain(new, dim, hw, per_field, block=block, periodic=periodic)


def wave_slabs_multi(state, dim, hw, per_field, *, block, periodic, consts):
    """K4s wave modes: the received slabs of width ``hw`` along ``dim`` for
    every field of ``per_field`` (``{field: (moves, earlier)}``, fields of
    P, Vx, Vy, Vz; `cuda_stencil.exchange_slabs`' moves and earlier dims) and
    every block of the stacked acoustic ``state`` (P blocks ``block``), in
    one launch. A field's send slab is the field after the leapfrog update
    (`wave_update_plain`'s function, the per-cell functions K9 uses),
    patched with that field's ``earlier`` received slabs and moved between
    blocks. Returns ``{field: (slab, ...)}``, new contiguous slabs in K2's
    layout, one a move."""
    block, counts = check_state(state, block, wave_shapes, "wave_slabs", DTYPES)
    dim, hw = check_slab_batch(state, dim, hw, per_field, block, "wave_slabs")
    if not _on_card(state[0]):
        return wave_slabs_multi_plain(state, dim, hw, per_field, block=block,
                                      periodic=periodic, consts=consts)
    return SlabBatch("igg_exchange_slabs_wave", block=block, counts=counts, consts=consts,
                     const_order=_CONST_ORDER)(state, dim, hw, periodic, per_field)


def wave_slabs_plain(state, field, dim, hw, moves, *, block, periodic, earlier=(), consts):
    """Plain PyTorch version of `wave_slabs`."""
    return wave_slabs_multi_plain(state, dim, hw, {field: (moves, earlier)}, block=block,
                                  periodic=periodic, consts=consts)[field]


def wave_slabs(state, field, dim, hw, moves, *, block, periodic, earlier=(), consts):
    """`wave_slabs_multi` for one field ("P", "Vx", "Vy" or "Vz"): a tuple
    of its received slabs, one for each `Move`."""
    return wave_slabs_multi(state, dim, hw, {field: (moves, earlier)}, block=block,
                            periodic=periodic, consts=consts)[field]


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





def _launch_k9(state, out, args, self_mode, slabs):
    import torch

    P = state[0]
    if out is None:
        out = tuple(torch.empty_like(a) for a in state)
    ptrs = (ctypes.c_void_p * 32)(*[a.data_ptr() for a in state],
                                  *[o.data_ptr() for o in out], *slabs)
    g, c = args
    with torch.cuda.device(P.device):
        rc = library().igg_acoustic_step_exchange(
            dtype_code(P.dtype), int(self_mode), ctypes.addressof(ptrs), ctypes.addressof(g),
            ctypes.addressof(c), _stream(P))
    check_rc(rc, "acoustic_step_exchange")
    count_launch("acoustic_step_exchange")
    return tuple(out)



def acoustic_step_recv(state, recvs, *, block, consts, out=None):
    """K9, multi-rank route: one leapfrog step of every block of the stacked
    acoustic ``state`` with the received slabs ``recvs`` (``{field: {dim:
    (recv_l, recv_r)}}``, halowidth 1, K2's layout; may be empty: the update
    alone) delivered in the same pass, a y-halo row over an x-halo plane over
    a z-halo lane. Out of place: writes ``out`` (four tensors, allocated when
    None) and returns it."""
    block, counts = check_state(state, block, wave_shapes, "acoustic_step", DTYPES)
    out = check_out(state, out, 4, "acoustic_step")
    check_recvs(state, recvs, counts, out, "acoustic_step")
    if not _on_card(state[0]):
        return acoustic_step_recv_plain(state, recvs, block=block, consts=consts, out=out)
    return _launch_k9(state, out, step_args(block, counts, consts, _CONST_ORDER), False,
                      slab_ptrs(recvs))


def acoustic_step_self(state, modes, ols, *, block, consts, out=None):
    """K9, all-self route: one leapfrog step of every block with the halos of
    each field's self-exchanging dims (``modes[field][d]``, overlaps
    ``ols[field][d]``) folded in as an index map onto the updated cells, in
    one launch and with no slabs. Out of place, as `acoustic_step_recv`."""
    block, counts = check_state(state, block, wave_shapes, "acoustic_step", DTYPES)
    out = check_out(state, out, 4, "acoustic_step")
    check_self(modes, ols, block, "acoustic_step")
    if not _on_card(state[0]):
        return acoustic_step_self_plain(state, modes, ols, block=block, consts=consts,
                                        out=out)
    return _launch_k9(state, out, step_args(block, counts, consts, _CONST_ORDER, modes, ols),
                      True, [None] * 24)


class AcousticStep:
    """The fused acoustic step on one grid (`acoustic_step_exchange_pallas`),
    with what is fixed for a run resolved once: the route, the constants,
    the overlaps, and on the card K9's and the K4s launches' argument arrays
    and received slabs. ``modes`` from `wave_exchange_modes`, ``block`` P's
    LOCAL shape. ``step(state, out=None)`` checks the state and ``out``
    once, then runs K9 alone on all-self grids, else the slab pipeline
    (`exchange_recv_slabs_multi`, one K4s wave-mode launch a dim) then
    K9."""

    def __init__(self, gg, modes, *, rho, K, dt, dx, dy, dz, block):
        self.gg, self.modes = gg, modes
        self.block = tuple(int(b) for b in block)
        self.consts = wave_consts(rho=rho, K=K, dt=dt, dx=dx, dy=dy, dz=dz)
        self.shapes = wave_shapes(self.block)
        self.ols = self_ols(gg, self.block) if all_self_exchange(gg, modes) else None
        if self.ols is not None:
            check_self(modes, self.ols, self.block, "acoustic_step")
        self._card = None  # (K9's arrays, the K4s launches), at the first launch

    def _card_args(self, counts):
        if self._card is None:
            modes, ols = (self.modes, self.ols) if self.ols is not None \
                else (NO_MODES, NO_OLS)
            self._card = (step_args(self.block, counts, self.consts, _CONST_ORDER, modes, ols),
                          SlabBatch("igg_exchange_slabs_wave", block=self.block, counts=counts,
                                    consts=self.consts, const_order=_CONST_ORDER, keep=True))
        return self._card

    def __call__(self, state, out=None):
        from .halo import exchange_recv_slabs_multi

        block, counts = check_state(state, self.block, wave_shapes, "acoustic_step", DTYPES)
        out = check_out(state, out, 4, "acoustic_step")
        card = _on_card(state[0])
        if self.ols is not None:
            if not card:
                return acoustic_step_self_plain(state, self.modes, self.ols, block=block,
                                                consts=self.consts, out=out)
            return _launch_k9(state, out, self._card_args(counts)[0], True, [None] * 24)
        if card:
            args, slabs = self._card_args(counts)

            def dim_fn(dim, hw, periodic, per_field):
                return slabs(state, dim, hw, periodic, per_field)
        else:
            def dim_fn(dim, hw, periodic, per_field):
                return wave_slabs_multi_plain(state, dim, hw, per_field, block=block,
                                              periodic=periodic, consts=self.consts)

        recvs = exchange_recv_slabs_multi(self.gg, self.shapes, (1, 1, 1), self.modes,
                                          dim_fn=dim_fn)
        if not card:
            return acoustic_step_recv_plain(state, recvs, block=block, consts=self.consts,
                                            out=out)
        return _launch_k9(state, out, args, False, slab_ptrs(recvs))


def acoustic_step_exchange(state, gg, modes, *, rho, K, dt, dx, dy, dz, block, out=None):
    """One fused acoustic step (updates and the full exchange of all four
    fields) of every block of the stacked ``state``: `AcousticStep` for one
    call. A run resolves its `AcousticStep` once."""
    return AcousticStep(gg, modes, rho=rho, K=K, dt=dt, dx=dx, dy=dy, dz=dz,
                        block=block)(state, out)


def wave_bytes(state) -> int:
    """Least bytes the fused step must move: read the four fields once and
    write them once."""
    return 2 * sum(a.numel() * a.element_size() for a in state)
