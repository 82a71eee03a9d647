"""3-D acoustic wave propagation on a staggered grid (BASELINE config 4).

Counterpart of `implicitglobalgrid_tpu/models/acoustic.py`: the first-order
velocity-pressure leapfrog

    dV/dt = -grad(P) / rho      (velocities on cell faces: Vx is (nx+1, ny, nz))
    dP/dt = -K div(V)           (pressure at cell centres)

on the stacked tensors of each process's box. Two routes (``impl``):

- ``"cuda"`` (the default while every ``IGG_USE_PALLAS`` flag is on), the
  JAX package's ``"pallas"`` route: where `wave_exchange_modes` admits the
  grid, the fused step (`ops.cuda_wave.acoustic_step_exchange`: K9 alone on
  all-self grids, else the K4s wave-mode send slabs then K9); otherwise
  the plain route, as JAX falls through to XLA. ``overlap`` is ignored on
  the fused route, as in JAX.
- ``"plain"``, the JAX package's ``"xla"``: the velocity update,
  ``local_update_halo(Vx, Vy, Vz)`` (one coalesced group on multi-rank
  axes: K8 + K7), the pressure update, ``local_update_halo(P)``, in the XLA
  tier's arithmetic form (``v + ((-dt/rho) * dP) / dx``; ``P - (dt*K) *
  divV``).

Both run the two-buffer runner of `models/common.py` over the four-tensor
state; a run resolves the fused route once (`ops.cuda_wave.AcousticStep`).
With ``overlap=True`` the plain route goes interior-first
(`models.common.interior_first_step` for the velocity round, radius 1,
then `ops.overlap.hide_communication` for the pressure round, radius 0).
A deep ``comm_every`` cadence runs the masked super-step (`deep_step`,
`make_acoustic_run_deep`) with one 4-field k-wide exchange per axis and
k_d sub-steps. ``ensemble=E`` advances E members (each state tensor
leading with the member axis, `common.ensemble_state`) on the plain route,
every member of the four fields in one K8 + K7 launch a dim; deep cadences
and ``overlap=True`` compose with it. Both routes take float32, float64 and
bfloat16 states.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..ops.alloc import device_put_g, zeros_g
from ..ops.cuda_wave import AcousticStep, wave_exchange_modes
from ..ops.fields import block_view
from ..ops.halo import local_update_halo
from ..ops.overlap import hide_communication
from ..ops.staggered import const_tensors
from ..ops.wire import resolve_comm_every
from ..parallel.topology import check_initialized, global_grid
from ..tools import coords_g, nx_g, ny_g, nz_g
from ..utils.exceptions import InvalidArgumentError
from .common import (
    check_ensemble, fresh_mask, interior_first_step, reject_comm_every,
    resolve_ensemble_impl, run_deep, traced_run, validate_deep_halo,
)
from .diffusion import IMPLS, _local_shape, _resolve_impl

__all__ = ["AcousticParams", "init_acoustic3d", "acoustic_step_local",
           "make_acoustic_run", "make_acoustic_run_deep", "deep_step", "run_acoustic"]


@dataclass(frozen=True)
class AcousticParams:
    """Physics/numerics constants (the JAX package's fields). ``overlap``
    takes the plain route interior-first; ``comm_every`` is the deep-halo
    cadence (``overlaps[d] >= 2*k_d``, ``halowidths[d] >= k_d``): between
    an axis's exchanges the velocity updates retreat ``r_d`` cells a
    neighbour side and the pressure update ``r_d + 1``."""
    rho: float
    K: float
    dt: float
    dx: float
    dy: float
    dz: float
    overlap: bool = False
    comm_every: int | str = 1


def init_acoustic3d(*, rho=1.0, K=1.0, lx=10.0, ly=10.0, lz=10.0, dtype=None,
                    overlap=False, comm_every=None):
    """State ``(P, Vx, Vy, Vz)`` with a Gaussian pressure pulse in the centre
    and the velocities zero, as stacked tensors on the grid's device, and
    the `AcousticParams`. ``dt`` is a Python float. ``dtype=None`` is
    torch's default float dtype."""
    import torch

    check_initialized()
    gg = global_grid()
    nx, ny, nz = (int(n) for n in gg.nxyz)
    dx, dy, dz = lx / (nx_g() - 1), ly / (ny_g() - 1), lz / (nz_g() - 1)
    c = float(np.sqrt(K / rho))
    dt = float(min(dx, dy, dz) / c / np.sqrt(3.1))
    p = AcousticParams(rho=rho, K=K, dt=dt, dx=dx, dy=dy, dz=dz, overlap=overlap,
                       comm_every=str(resolve_comm_every(comm_every)))
    Pz = zeros_g((nx, ny, nz), dtype=dtype)
    x, y, z = coords_g(dx, dy, dz, Pz)
    r2 = (x - lx / 2) ** 2 + (y - ly / 2) ** 2 + (z - lz / 2) ** 2
    pulse = torch.from_numpy(np.broadcast_to(np.exp(-r2), Pz.shape).copy())
    P = device_put_g(pulse.to(Pz.dtype))
    Vx = zeros_g((nx + 1, ny, nz), dtype=dtype)
    Vy = zeros_g((nx, ny + 1, nz), dtype=dtype)
    Vz = zeros_g((nx, ny, nz + 1), dtype=dtype)
    return (P, Vx, Vy, Vz), p


def _dP(Ab, axis, n):
    """The difference of neighbours along local ``axis`` of a block view
    (axis ``2 axis - 5`` from the end: a leading member axis stays whole)."""
    return Ab.narrow(2 * axis - 5, 1, n - 1) - Ab.narrow(2 * axis - 5, 0, n - 1)


def _consts(p: AcousticParams, P):
    """The step's constants as 0-d tensors of the state's dtype and device."""
    return const_tensors({"c_v": -p.dt / p.rho, "dtK": p.dt * p.K, "dx": p.dx, "dy": p.dy,
                          "dz": p.dz}, P)


def _v_update(P, vs, c, loc):
    """The velocity update of every block of ``P`` (blocks ``loc``) and
    ``vs`` (Vx, Vy, Vz): new tensors, the XLA tier's arithmetic (``v +
    ((-dt/rho) * dP) / dx``) on the inner faces. Also one block's slab,
    with ``loc`` its P shape."""
    Pb = block_view(P, loc)
    out = []
    for ax, V in enumerate(vs):
        m = list(loc)
        m[ax] += 1
        U = V.clone()
        inner = block_view(U, m).narrow(2 * ax - 5, 1, loc[ax] - 1)
        inner.copy_(inner + (c["c_v"] * _dP(Pb, ax, loc[ax])) / c["d" + "xyz"[ax]])
        out.append(U)
    return out


def _p_update(P, vs, c, loc):
    """The pressure update ``P - (dt*K) * divV`` of every block, new."""
    div = None
    for ax, V in enumerate(vs):
        m = list(loc)
        m[ax] += 1
        term = _dP(block_view(V, m), ax, m[ax]) / c["d" + "xyz"[ax]]
        div = term if div is None else div + term
    return (block_view(P, loc) - c["dtK"] * div).reshape(P.shape)


def _plain_step(state, p: AcousticParams, loc, members=None):
    """The plain route: the XLA tier's updates per block (broadcast over the
    block views, and over an ensemble's ``members``), each followed by its
    exchange."""
    P, Vx, Vy, Vz = state
    c = _consts(p, P)
    Vx, Vy, Vz = local_update_halo(*_v_update(P, (Vx, Vy, Vz), c, loc), members=members)
    return (local_update_halo(_p_update(P, (Vx, Vy, Vz), c, loc), members=members),
            Vx, Vy, Vz)


def _overlap_step(state, p: AcousticParams, members=None):
    """The plain route interior-first: the velocity round (one exchange of
    the three face-staggered fields) hidden under the interior velocity
    update, then the pressure round likewise (radius 0)."""
    P, Vx, Vy, Vz = state
    c = _consts(p, P)
    lead = int(members is not None)

    def v_upd(vx, vy, vz, Pc):
        return _v_update(Pc, (vx, vy, vz), c, tuple(Pc.shape[lead:]))

    def p_upd(Pc, vx, vy, vz):
        return _p_update(Pc, (vx, vy, vz), c, tuple(Pc.shape[lead:]))

    Vx, Vy, Vz = interior_first_step(v_upd, (Vx, Vy, Vz), (P,), radius=1, members=members)
    return (hide_communication(p_upd, P, Vx, Vy, Vz, radius=0, members=members), Vx, Vy, Vz)


def _check_state(state, members=None):
    state = tuple(state)
    nd = 3 if members is None else 4
    if len(state) != 4 or any(a.dim() != nd for a in state):
        raise InvalidArgumentError(
            "the acoustic state is four 3-D tensors (P, Vx, Vy, Vz)"
            + ("" if members is None else f", each leading with its {members} members") + ".")
    if members is not None:
        check_ensemble(state, members)
    return state


def _resolve(state, p: AcousticParams, impl: str, members=None):
    """The step on the current grid for states shaped like ``state``, as
    ``fn(state, out) -> state``: the fused route's `AcousticStep` where
    ``impl`` is "cuda" and the gate admits the grid, else the plain route
    (interior-first with ``p.overlap``), which ignores ``out``. An
    ensemble's state (``members``) takes the plain route."""
    gg = global_grid()
    if members is not None:
        resolve_ensemble_impl(impl, "acoustic")
        locs = [_local_shape(gg, a, 1) for a in _check_state(state, members)]
        if p.overlap:
            return lambda st, out: _overlap_step(st, p, members)
        return lambda st, out: _plain_step(st, p, locs[0], members)
    locs = [_local_shape(gg, a) for a in _check_state(state)]
    if impl == "cuda":
        modes = wave_exchange_modes(gg, locs)
        if modes is not None:
            return AcousticStep(gg, modes, rho=p.rho, K=p.K, dt=p.dt, dx=p.dx, dy=p.dy,
                                dz=p.dz, block=locs[0])
    if p.overlap:
        return lambda st, out: _overlap_step(st, p)
    return lambda st, out: _plain_step(st, p, locs[0])


def acoustic_step_local(state, p: AcousticParams, impl: str = "plain", out=None,
                        members: int | None = None):
    """One leapfrog step of the stacked state (every rank's block) with the
    halo exchanges. ``impl`` is "cuda" (the fused route where the grid
    admits it, else the plain route) or "plain". ``out`` is a spare state
    the fused route may write into (it must not alias ``state``); the new
    state is returned either way. ``members``: an ensemble's state, each
    tensor leading with that many members (the plain route)."""
    if impl not in IMPLS:
        raise InvalidArgumentError(f"impl must be one of {IMPLS}; got {impl!r}.")
    state = tuple(state)
    return _resolve(state, p, impl, members)(state, out)


def make_acoustic_run(p: AcousticParams, nt_chunk: int, impl: str | None = None,
                      ensemble: int | None = None):
    """A runner advancing ``nt_chunk`` steps: ``state = run(P, Vx, Vy, Vz)``
    (pass ``donate=True`` to let it overwrite the input state). The route,
    the gate's modes and the constants are resolved once for the grid and
    the state's shapes, not every step. A deep cadence raises
    `InvalidArgumentError`: use `run_acoustic` or `make_acoustic_run_deep`.
    ``ensemble=E``: the state leads with E members (the plain route)."""
    from .common import make_state_runner, resolve_once

    reject_comm_every(p.comm_every, "AcousticParams", "make_acoustic_run",
                      "run_acoustic or make_acoustic_run_deep")
    members = None if ensemble is None else int(ensemble)
    impl = _resolve_impl(impl) if members is None \
        else resolve_ensemble_impl(impl, "acoustic")
    return make_state_runner(resolve_once(lambda state: _resolve(state, p, impl, members)),
                             nt_chunk=nt_chunk, ensemble=ensemble)


def deep_step(p: AcousticParams, members: int | None = None):
    """The deep-halo leapfrog super-step: ``cycle`` masked sub-steps of the
    plain route, the 4-field k-wide exchange issued per axis when its
    cadence makes it due. Returns ``(step, cycle)``, ``step(state) ->
    state`` on the stacked tensors.

    Masks per dim ``d``, staleness ``r_d = j mod k_d`` (`common.fresh_mask`):
    each V field retreats ``r_d`` with base 1 in its staggered dim (its
    update touches faces ``[1, n)`` of ``n + 1``) and 0 elsewhere; P
    retreats ``r_d + 1`` with base 0 (it reads this sub-step's V). The
    skipped bands are what the k-wide exchange overwrites. ``members``: an
    ensemble's state."""
    import torch

    check_initialized()
    gg = global_grid()
    cad = resolve_comm_every(p.comm_every)
    validate_deep_halo(gg, 3, cad)

    def step(state):
        P, Vx, Vy, Vz = _check_state(state, members)
        loc = _local_shape(global_grid(), P, int(members is not None))
        c = _consts(p, P)
        for j in range(cad.cycle):
            r = cad.retreats(j)
            Vn = _v_update(P, (Vx, Vy, Vz), c, loc)
            if any(r):
                for s in range(3):
                    base = tuple(int(d == s) for d in range(3))
                    m = list(loc)
                    m[s] += 1
                    Vn[s] = torch.where(fresh_mask(m, r, base, base), Vn[s], (Vx, Vy, Vz)[s])
            Vx, Vy, Vz = Vn
            Pn = _p_update(P, (Vx, Vy, Vz), c, loc)
            P = torch.where(fresh_mask(loc, tuple(x + 1 for x in r), (0, 0, 0), (0, 0, 0)),
                            Pn, P)
            due = cad.due_dims(j)
            if due:
                P, Vx, Vy, Vz = local_update_halo(P, Vx, Vy, Vz, dims=due, members=members)
        return (P, Vx, Vy, Vz)

    return step, cad.cycle


def make_acoustic_run_deep(p: AcousticParams, nt_chunk_super: int,
                           ensemble: int | None = None):
    """The deep-halo leapfrog runner: ``state = run(P, Vx, Vy, Vz)``
    advances ``nt_chunk_super`` super-steps (`deep_step`). The input is
    never written. ``ensemble=E``: the state leads with E members."""
    from .common import make_state_runner

    step, _ = deep_step(p, None if ensemble is None else int(ensemble))
    return make_state_runner(lambda state, spare: (step(state), None),
                             nt_chunk=nt_chunk_super, ensemble=ensemble)


@traced_run
def run_acoustic(state, p: AcousticParams, nt: int, *, nt_chunk: int = 100,
                 impl: str | None = None, ensemble: int | None = None):
    """Advance ``nt`` steps and return the new state (the input is not
    written). Returns after the device has drained. A deep ``comm_every``
    cadence runs `make_acoustic_run_deep` (``nt`` a multiple of its
    cycle). ``ensemble=E``: every tensor of the state leads with E members
    (`common.ensemble_state`)."""
    from .common import run_chunked

    E = None if ensemble is None else check_ensemble(tuple(state), ensemble)
    if resolve_comm_every(p.comm_every).deep:
        return run_deep(lambda c: make_acoustic_run_deep(p, c, ensemble=E), tuple(state), p,
                        nt, nt_chunk, impl)
    return run_chunked(lambda c: make_acoustic_run(p, c, impl, ensemble=E), tuple(state), nt,
                       nt_chunk)
