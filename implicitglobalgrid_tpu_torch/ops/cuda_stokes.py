"""The fused PT iteration K10 (`csrc/stokes.cu`), the K4s Stokes modes, and
their plain versions.

Counterpart of `implicitglobalgrid_tpu/ops/pallas_stokes.py`:

- `stokes_exchange_modes`: the gate of the fused pass (the JAX function).
- `stokes_update_plain`: one pseudo-transient iteration of every block of
  the stacked state (P, Vx, Vy, Vz, dVx, dVy, dVz, rhog), no exchange, in
  the arithmetic of `_stokes_kernel` (``form="kernel"``) or of the model's
  `_stokes_terms` (``form="getter"``). The two differ only in the buoyancy
  term at a z-face: ``0.5*(rhog[k] + rhog[k-1])`` in the kernel,
  ``0.5*((rhog[k] - rhog[k-1]) + 2*rhog[k-1])`` in `_stokes_terms`; every
  other term has one operation order. The pressure update is unmasked;
  the damped-momentum and velocity updates hold on the interior faces
  (Vx: faces 1..nx-1, rows 1..ny-2, lanes 1..nz-2; Vy: cells 1..nx-2,
  faces 1..ny-1, lanes 1..nz-2; Vz: cells 1..nx-2, rows 1..ny-2, faces
  1..nz-1), other faces keep their values.
- `stokes_slabs_multi` (K4s Stokes modes): the received slabs of one dim
  for every field of a group and every block, in one launch, the send slabs
  being each field after the iteration in the getter form (`_v_get_slab`,
  `_pn_get_slab`); `stokes_slabs` is one field's, `stokes_update_slab` the
  same with identity moves (the getters).
- `stokes_step_recv` (K10, multi-rank route) and `stokes_step_self` (K10,
  all-self route): the iteration of all eight fields with the halos of
  (P, Vx, Vy, Vz) delivered, in one launch; dV is never exchanged.
  `StokesStep` is `stokes_step_exchange_pallas` on one grid, resolved once
  for a run: the all-self route, or the slab pipeline
  (`ops.halo.exchange_recv_slabs_multi`, one K4s Stokes-mode launch a dim)
  then K10; `stokes_step_exchange` is the same for one call.

On the all-self route an x-halo plane is the updated source plane that
JAX's getter computes (`self_recvs_and_ols`), so it takes the getter form;
every other cell the kernel form. The VMEM relay and Vx's extra planes
(`vx_extra_plane_slabs`, `vx_extra_planes_self`) are TPU tiling: K10 writes
every face itself. On a CUDA tensor a wrapper launches its kernel (or
raises); on a CPU tensor it runs the plain version. The kernels take
float32 and float64 states; the plain versions bfloat16 too (each operation
rounded to it, bfloat16 constants, as JAX's XLA route computes), and the
gate gives a bfloat16 state no fused route: JAX's own Pallas route refuses
it, so there is no result to hold a kernel against.
"""

from __future__ import annotations

import ctypes

from ..utils.exceptions import InvalidArgumentError
from .cuda_build import check_rc, count_launch, library
from .cuda_stencil import Move, _on_card, _stream
from .fields import block_view
from .staggered import (
    FIELDS, FLOATS, NO_MODES, NO_OLS, SlabBatch, all_self_exchange, check_out, check_recvs,
    check_self, check_slab_batch, check_state, const_tensors, dtype_code, into, self_index,
    self_ols, slab_batch_plain, slab_ptrs, step_args, wave_shapes,
)

__all__ = ["FIELDS", "STATE", "stokes_exchange_modes", "stokes_shapes", "stokes_consts",
           "stokes_update_plain", "stokes_terms_plain", "stokes_slabs_multi",
           "stokes_slabs_multi_plain", "stokes_slabs", "stokes_slabs_plain",
           "stokes_update_slab", "stokes_step_recv", "stokes_step_recv_plain",
           "stokes_step_self", "stokes_step_self_plain", "StokesStep",
           "stokes_step_exchange", "stokes_bytes"]

STATE = ("P", "Vx", "Vy", "Vz", "dVx", "dVy", "dVz", "rhog")
FORMS = ("kernel", "getter")
_CONST_ORDER = ("mu", "dt_v", "dt_p", "damp", "dx", "dy", "dz")


def stokes_exchange_modes(gg, shapes, dtype=None):
    """Per-field participation modes of the fused PT iteration, or None (the
    JAX gate of the same name). ``shapes`` are the 8 LOCAL state shapes;
    eligible when P has at least 3 planes and matches ``gg.nxyz``, the faces
    are staggered on the +1 axes, dV mirrors V, rhog is shaped like P and
    every halowidth is 1, and the state's ``dtype`` (where given) is float32
    or float64: a bfloat16 state takes the plain route. Returns ``{"P":
    modes, "Vx": ..., "Vy": ..., "Vz": ...}``; all-False modes are the
    iteration alone (one block, non-periodic)."""
    from .halo import _dim_exchanges

    if dtype is not None and str(dtype).replace("torch.", "") not in FLOATS:
        return None
    sp, sx, sy, sz, sdx, sdy, sdz, srh = (tuple(int(v) for v in s) for s in shapes)
    if len(sp) != 3 or sp[0] < 3:
        return None
    if sp != tuple(int(n) for n in gg.nxyz) or srh != sp:
        return None
    nx, ny, nz = sp
    if sx != (nx + 1, ny, nz) or sy != (nx, ny + 1, nz) or sz != (nx, ny, nz + 1):
        return None
    if (sdx, sdy, sdz) != (sx, sy, sz):
        return None
    if any(int(h) != 1 for h in gg.halowidths):
        return None
    hws = (1, 1, 1)
    return {name: tuple(_dim_exchanges(gg, s, hws, d) for d in range(3))
            for name, s in zip(FIELDS, (sp, sx, sy, sz))}


def stokes_shapes(block):
    """LOCAL shapes of the 8 state fields for P's block (nx, ny, nz)."""
    w = wave_shapes(block)
    return dict(w, dVx=w["Vx"], dVy=w["Vy"], dVz=w["Vz"], rhog=w["P"])


def stokes_consts(p):
    """The iteration's constants from `StokesParams` ``p`` (Python floats,
    rounded to the state dtype where they are used)."""
    return {k: float(getattr(p, k)) for k in _CONST_ORDER}


def _ctensors(consts, like):
    vals = {k: consts[k] for k in _CONST_ORDER}
    return const_tensors(dict(vals, mu2=2 * float(vals["mu"]), two=2.0, three=3.0, half=0.5),
                         like)


PLAIN_DTYPES = FLOATS + ("bfloat16",)  # the plain versions' state dtypes


def _check_state(state, block, name):
    """Validate a stacked Stokes state; returns (P block, block counts)."""
    return check_state(state, block, stokes_shapes, name, PLAIN_DTYPES)


def _kernel_dtype(P, name):
    """The kernels take float32 and float64 states only: the gate keeps
    bfloat16 off the fused route."""
    if str(P.dtype).replace("torch.", "") not in FLOATS:
        raise InvalidArgumentError(f"{name}: the kernels take float32 or float64 states; got "
                                   f"{P.dtype}.")


def _d(A, ax):
    """Difference of neighbours along local axis ``ax`` of a block view."""
    n = A.shape[2 * ax + 1]
    return A.narrow(2 * ax + 1, 1, n - 1) - A.narrow(2 * ax + 1, 0, n - 1)


def _inner(A, axes):
    """Drop the first and last cell of every block along the local ``axes``."""
    for ax in axes:
        A = A.narrow(2 * ax + 1, 1, A.shape[2 * ax + 1] - 2)
    return A


def _terms(views, c, form):
    """`_stokes_terms` on the block views of every block at once: (Pn, divV,
    Rx, Ry, Rz) in its accumulation order, the buoyancy in ``form``."""
    Pb, Vxb, Vyb, Vzb, rhb = views
    divV = _d(Vxb, 0) / c["dx"] + _d(Vyb, 1) / c["dy"] + _d(Vzb, 2) / c["dz"]
    Pn = Pb - c["dt_p"] * divV
    txx = c["mu2"] * (_d(Vxb, 0) / c["dx"] - divV / c["three"])
    tyy = c["mu2"] * (_d(Vyb, 1) / c["dy"] - divV / c["three"])
    tzz = c["mu2"] * (_d(Vzb, 2) / c["dz"] - divV / c["three"])
    txy = c["mu"] * (_inner(_d(Vxb, 1), (0,)) / c["dy"] + _inner(_d(Vyb, 0), (1,)) / c["dx"])
    txz = c["mu"] * (_inner(_d(Vxb, 2), (0,)) / c["dz"] + _inner(_d(Vzb, 0), (2,)) / c["dx"])
    tyz = c["mu"] * (_inner(_d(Vyb, 2), (1,)) / c["dz"] + _inner(_d(Vzb, 1), (2,)) / c["dy"])
    Rx = (_inner(_d(txx - Pn, 0), (1, 2)) / c["dx"]
          + _d(_inner(txy, (2,)), 1) / c["dy"]
          + _d(_inner(txz, (1,)), 2) / c["dz"])
    Ry = (_inner(_d(tyy - Pn, 1), (0, 2)) / c["dy"]
          + _d(_inner(txy, (2,)), 0) / c["dx"]
          + _d(_inner(tyz, (0,)), 2) / c["dz"])
    lo = rhb.narrow(5, 0, rhb.shape[5] - 1)
    if form == "getter":
        rg = c["half"] * (_d(rhb, 2) + c["two"] * lo)
    else:
        rg = c["half"] * (rhb.narrow(5, 1, rhb.shape[5] - 1) + lo)
    Rz = (_inner(_d(tzz - Pn, 2), (0, 1)) / c["dz"]
          + _d(_inner(txz, (1,)), 0) / c["dx"]
          + _d(_inner(tyz, (0,)), 1) / c["dy"]
          + _inner(rg, (0, 1)))
    return Pn, divV, Rx, Ry, Rz


def _views(state, block):
    shp = stokes_shapes(block)
    return [block_view(a, shp[f]) for a, f in zip(state, STATE)]


def stokes_terms_plain(state, *, block, consts, form="getter"):
    """(Pn, divV, Rx, Ry, Rz) of every block of stacked ``state``, as block
    views (D0, n0, D1, n1, D2, n2): the model's `_stokes_terms` per block."""
    block, _ = _check_state(state, block, "stokes_terms")
    v = _views(state, block)
    return _terms((v[0], v[1], v[2], v[3], v[7]), _ctensors(consts, state[0]), form)


def stokes_update_plain(state, *, block, consts, form="kernel"):
    """One PT iteration of every block of stacked ``state``, no exchange:
    the 7 updated fields (P, Vx, Vy, Vz, dVx, dVy, dVz) as new stacked
    tensors, in the arithmetic of ``form`` ("kernel" or "getter"; see the
    module docstring). Constants are 0-d tensors of the state dtype."""
    if form not in FORMS:
        raise InvalidArgumentError(f"form must be one of {FORMS}; got {form!r}.")
    block, _ = _check_state(state, block, "stokes_update")
    c = _ctensors(consts, state[0])
    v = _views(state, block)
    Pn, _, Rx, Ry, Rz = _terms((v[0], v[1], v[2], v[3], v[7]), c, form)
    vs, dvs = [], []
    for V, dV, Vb, dVb, R in zip(state[1:4], state[4:7], v[1:4], v[4:7], (Rx, Ry, Rz)):
        dn = c["damp"] * _inner(dVb, (0, 1, 2)) + R
        U, dU = V.clone(), dV.clone()
        ub = _inner(block_view(U, Vb.shape[1::2]), (0, 1, 2))
        ub.copy_(_inner(Vb, (0, 1, 2)) + c["dt_v"] * dn)
        _inner(block_view(dU, Vb.shape[1::2]), (0, 1, 2)).copy_(dn)
        vs.append(U)
        dvs.append(dU)
    return (Pn.reshape(state[0].shape), *vs, *dvs)


# ---------------------------------------------------------------------------
# K4s Stokes modes: the send slabs of the fused iteration.
# ---------------------------------------------------------------------------

def stokes_slabs_multi_plain(state, dim, hw, per_field, *, block, periodic, consts):
    """Plain PyTorch version of the K4s Stokes modes (same arguments as
    `stokes_slabs_multi`): the slabs of the getter-form iteration's fields,
    patched and moved as K4s's plain version does."""
    new = stokes_update_plain(state, block=block, consts=consts, form="getter")
    return slab_batch_plain(new, dim, hw, per_field, block=block, periodic=periodic)


def stokes_slabs_multi(state, dim, hw, per_field, *, block, periodic, consts):
    """K4s Stokes modes: the received slabs of width ``hw`` along ``dim``
    for every field of ``per_field`` (``{field: (moves, earlier)}``, fields
    of P, Vx, Vy, Vz; `cuda_stencil.exchange_slabs`' moves and earlier dims)
    and every block of the stacked Stokes ``state`` (P blocks ``block``), in
    one launch. A field's send slab is the field after the PT iteration in
    the getter form (the per-cell functions of `csrc/stokes.cuh` that K10
    uses), patched with that field's ``earlier`` received slabs and moved
    between blocks. Returns ``{field: (slab, ...)}``, new contiguous slabs
    in K2's layout, one a move."""
    block, counts = _check_state(state, block, "stokes_slabs")
    dim, hw = check_slab_batch(state, dim, hw, per_field, block, "stokes_slabs")
    if not _on_card(state[0]):
        return stokes_slabs_multi_plain(state, dim, hw, per_field, block=block,
                                        periodic=periodic, consts=consts)
    _kernel_dtype(state[0], "stokes_slabs")
    return SlabBatch("igg_exchange_slabs_stokes", block=block, counts=counts, consts=consts,
                     const_order=_CONST_ORDER)(state, dim, hw, periodic, per_field)


def stokes_slabs_plain(state, field, dim, hw, moves, *, block, periodic, earlier=(), consts):
    """Plain PyTorch version of `stokes_slabs`."""
    return stokes_slabs_multi_plain(state, dim, hw, {field: (moves, earlier)}, block=block,
                                    periodic=periodic, consts=consts)[field]


def stokes_slabs(state, field, dim, hw, moves, *, block, periodic, earlier=(), consts):
    """`stokes_slabs_multi` for one field ("P", "Vx", "Vy" or "Vz"): a
    tuple of its received slabs, one for each `Move`."""
    return stokes_slabs_multi(state, dim, hw, {field: (moves, earlier)}, block=block,
                              periodic=periodic, consts=consts)[field]


def stokes_update_slab(state, field, dim, starts, size, *, block, consts):
    """``field`` after the iteration (getter form) on ``[start,
    start+size)`` along ``dim`` of every block, for each of ``starts`` (K4s
    Stokes modes with the identity move, two ranges a launch): JAX's
    getters, in K2's layout."""
    moves = [Move(int(s), int(s), 0) for s in starts]
    out = []
    for k in range(0, len(moves), 2):
        out += stokes_slabs(state, field, dim, size, moves[k:k + 2], block=block,
                            periodic=True, consts=consts)
    return out


# ---------------------------------------------------------------------------
# K10: the iteration of all eight fields with the halo delivery.
# ---------------------------------------------------------------------------

def _with_rhog(new, state):
    return (*new, state[7])


def stokes_step_recv_plain(state, recvs, *, block, consts, out=None):
    """Plain PyTorch version of K10's multi-rank route: the kernel-form
    iteration, then each field's received slabs written in the z, x, y
    order (the fused pass's delivery; the iteration reads only the input
    state, so no update sees a delivered value)."""
    from .cuda_halo import halo_write_plain

    new = stokes_update_plain(state, block=block, consts=consts, form="kernel")
    shp = wave_shapes(block)
    for f, U in zip(FIELDS, new):
        for d in (2, 0, 1):
            if d in recvs.get(f, {}):
                halo_write_plain(U, *recvs[f][d], dim=d, hw=1, block=shp[f][d])
    return _with_rhog(into(out, new), state)


def stokes_step_self_plain(state, modes, ols, *, block, consts, out=None):
    """Plain PyTorch version of K10's all-self route: the iteration, then
    every self-exchanging dim of each field as an index map onto the
    updated block (0 reads n-ol, n-1 reads ol-1); a cell whose x index maps
    elsewhere reads the getter-form iteration, every other cell the kernel
    form."""
    import torch

    new = list(stokes_update_plain(state, block=block, consts=consts, form="kernel"))
    getter = None
    shp = wave_shapes(block)
    for k, f in enumerate(FIELDS):
        U = new[k]
        if modes[f][0]:
            if getter is None:
                getter = stokes_update_plain(state, block=block, consts=consts, form="getter")
            src = self_index(U.shape[0], shp[f][0], ols[f][0], U.device)
            keep = (src == torch.arange(U.shape[0], device=U.device)).view(-1, 1, 1)
            U = torch.where(keep, U, getter[k].index_select(0, src))
        for d in (1, 2):
            if modes[f][d]:
                U = U.index_select(d, self_index(U.shape[d], shp[f][d], ols[f][d], U.device))
        new[k] = U
    return _with_rhog(into(out, new), state)




def _step_recv(state, recvs, block, counts, consts, out, args=None):
    """K10's multi-rank route on arguments already checked (``args``: K10's
    arrays, built here when None)."""
    if not _on_card(state[0]):
        return stokes_step_recv_plain(state, recvs, block=block, consts=consts, out=out)
    args = args or step_args(block, counts, consts, _CONST_ORDER)
    return _launch_k10(state, out, args, False, slab_ptrs(recvs))


def _step_self(state, modes, ols, block, counts, consts, out, args=None):
    """K10's all-self route on arguments already checked."""
    if not _on_card(state[0]):
        return stokes_step_self_plain(state, modes, ols, block=block, consts=consts, out=out)
    args = args or step_args(block, counts, consts, _CONST_ORDER, modes, ols)
    return _launch_k10(state, out, args, True, [None] * 24)


def _launch_k10(state, out, args, self_mode, slabs):
    import torch

    P = state[0]
    _kernel_dtype(P, "stokes_step")
    if out is None:
        out = tuple(torch.empty_like(a) for a in state[:7])
    ptrs = (ctypes.c_void_p * 39)(*[a.data_ptr() for a in state],
                                  *[o.data_ptr() for o in out], *slabs)
    g, c = args
    with torch.cuda.device(P.device):
        rc = library().igg_stokes_step_exchange(
            dtype_code(P.dtype), int(self_mode), ctypes.addressof(ptrs), ctypes.addressof(g),
            ctypes.addressof(c), _stream(P))
    check_rc(rc, "stokes_step_exchange")
    count_launch("stokes_step_exchange")
    return _with_rhog(out, state)




def stokes_step_recv(state, recvs, *, block, consts, out=None):
    """K10, multi-rank route: one PT iteration of every block of the stacked
    Stokes ``state`` with the received slabs ``recvs`` (``{field: {dim:
    (recv_l, recv_r)}}`` for P, Vx, Vy, Vz, halowidth 1, K2's layout; may be
    empty: the iteration alone) delivered in the same pass, a y-halo row
    over an x-halo plane over a z-halo lane. Out of place: writes ``out``
    (the 7 updated fields; allocated when None) and returns the new state,
    rhog being the input's."""
    block, counts = _check_state(state, block, "stokes_step")
    out = check_out(state, out, 7, "stokes_step")
    check_recvs(state, recvs, counts, out, "stokes_step")
    return _step_recv(state, recvs, block, counts, consts, out)


def stokes_step_self(state, modes, ols, *, block, consts, out=None):
    """K10, all-self route: one PT iteration of every block with the halos
    of each field's self-exchanging dims (``modes[field][d]``, overlaps
    ``ols[field][d]``) folded in as an index map onto the updated cells, in
    one launch and with no slabs. Out of place, as `stokes_step_recv`."""
    block, counts = _check_state(state, block, "stokes_step")
    out = check_out(state, out, 7, "stokes_step")
    check_self(modes, ols, block, "stokes_step")
    return _step_self(state, modes, ols, block, counts, consts, out)


class StokesStep:
    """The fused PT iteration on one grid (`stokes_step_exchange_pallas`),
    with what is fixed for a run resolved once: the route, the constants of
    `StokesParams` ``p``, the overlaps, and on the card K10's and the K4s
    launches' argument arrays and received slabs. ``modes`` from
    `stokes_exchange_modes`, ``block`` P's LOCAL shape. ``step(state,
    out=None)`` checks the state and ``out`` once, then runs K10 alone on
    all-self grids, else the slab pipeline (`exchange_recv_slabs_multi`, one
    K4s Stokes-mode launch a dim) then K10."""

    def __init__(self, gg, modes, p, *, block):
        self.gg, self.modes = gg, modes
        self.block = tuple(int(b) for b in block)
        self.consts = stokes_consts(p)
        self.shapes = wave_shapes(self.block)
        self.ols = self_ols(gg, self.block) if all_self_exchange(gg, modes) else None
        if self.ols is not None:
            check_self(modes, self.ols, self.block, "stokes_step")
        self._card = None  # (K10's arrays, the K4s launches), at the first launch

    def _card_args(self, counts):
        if self._card is None:
            modes, ols = (self.modes, self.ols) if self.ols is not None \
                else (NO_MODES, NO_OLS)
            self._card = (step_args(self.block, counts, self.consts, _CONST_ORDER, modes, ols),
                          SlabBatch("igg_exchange_slabs_stokes", block=self.block,
                                    counts=counts, consts=self.consts,
                                    const_order=_CONST_ORDER, keep=True))
        return self._card

    def __call__(self, state, out=None):
        from .halo import exchange_recv_slabs_multi

        block, counts = _check_state(state, self.block, "stokes_step")
        out = check_out(state, out, 7, "stokes_step")
        card = _on_card(state[0])
        args, slabs = self._card_args(counts) if card else (None, None)
        if self.ols is not None:
            return _step_self(state, self.modes, self.ols, block, counts, self.consts, out,
                              args)
        if card:
            _kernel_dtype(state[0], "stokes_slabs")

            def dim_fn(dim, hw, periodic, per_field):
                return slabs(state, dim, hw, periodic, per_field)
        else:
            def dim_fn(dim, hw, periodic, per_field):
                return stokes_slabs_multi_plain(state, dim, hw, per_field, block=block,
                                                periodic=periodic, consts=self.consts)

        recvs = exchange_recv_slabs_multi(self.gg, self.shapes, (1, 1, 1), self.modes,
                                          dim_fn=dim_fn)
        return _step_recv(state, recvs, block, counts, self.consts, out, args)


def stokes_step_exchange(state, gg, modes, p, *, block, out=None):
    """One fused PT iteration (every update and the exchange of P, Vx, Vy
    and Vz) of every block of the stacked ``state``: `StokesStep` for one
    call. A run resolves its `StokesStep` once."""
    return StokesStep(gg, modes, p, block=block)(state, out)


def stokes_bytes(state) -> int:
    """Least bytes the fused iteration must move: read the eight fields
    once and write the seven updated ones once."""
    return sum(a.numel() * a.element_size() for a in state) \
        + sum(a.numel() * a.element_size() for a in state[:7])
