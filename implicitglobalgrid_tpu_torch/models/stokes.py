"""3-D pseudo-transient (PT) Stokes solver on a staggered grid (BASELINE
config 5).

Counterpart of `implicitglobalgrid_tpu/models/stokes.py`: isoviscous,
incompressible Stokes flow driven by a buoyant sphere, solved by damped
pseudo-transient iteration, on the stacked tensors of each process's box::

    cell centres: P, txx, tyy, tzz, rhog     faces: Vx, Vy, Vz (and dV)
    divV = div(V);  P <- P - dt_p*divV
    tii  = 2 mu (d_i V_i - divV/3);  tij = mu (d_j V_i + d_i V_j)
    R_i  = -d_i P + d_j tij (+ buoyancy on z);  dV <- damp*dV + R;  V <- V + dt_v*dV
    halo-exchange (Vx, Vy, Vz, P)

Two routes (``impl``):

- ``"cuda"`` (the default while every ``IGG_USE_PALLAS`` flag is on), the
  JAX package's ``"pallas"`` route: where `stokes_exchange_modes` admits the
  grid, the fused iteration (`ops.cuda_stokes.StokesStep`: K10
  alone on all-self grids and on one non-periodic block, else the K4s
  Stokes-mode send slabs then K10); otherwise the plain route, as JAX falls
  through to XLA. ``overlap`` is ignored on the fused route, as in JAX.
- ``"plain"``, the JAX package's ``"xla"``: the iteration in `_stokes_terms`'
  arithmetic (`ops.cuda_stokes.stokes_update_plain`, getter form), then
  ``local_update_halo(Vx, Vy, Vz, Pn)`` (one coalesced group a dim on
  multi-rank axes: K8 + K7; K3 on all-self grids).

Both run the two-buffer runner of `models/common.py` over the eight-tensor
state (rhog is never written). `stokes_residuals` is the convergence
monitor: the global (max |divV|, max |R|). A bfloat16 state takes the
plain route (the gate gives it no fused route: JAX's Pallas route refuses
it). With ``overlap=True`` the plain route goes interior-first
(`models.common.interior_first_step`: shells of the 7 updated fields, the
exchange of the first 4 on a side stream under the interior). A deep
``comm_every`` cadence runs the masked super-step (`deep_step`,
`make_stokes_run_deep`): a dependency radius of 2 an iteration, one
7-field exchange (P, V, dV) per axis and k_d iterations. ``ensemble=E``
advances E members (each state tensor leading with the member axis,
`common.ensemble_state`) on the plain route, every member of the exchanged
fields in one K8 + K7 launch a dim; deep cadences and ``overlap=True``
compose with it. `stokes_residuals` takes one member's state (the JAX
package's fails on an ensemble's).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..ops.alloc import device_put_g, zeros_g
from ..ops.cuda_stokes import (
    StokesStep, stokes_consts, stokes_exchange_modes, stokes_terms_plain, stokes_update_plain,
)
from ..ops.halo import local_update_halo
from ..ops.wire import resolve_comm_every
from ..parallel.topology import check_initialized, global_grid
from ..tools import coords_g, nx_g, ny_g, nz_g
from ..utils.exceptions import InvalidArgumentError
from .common import (
    check_ensemble, fresh_mask, interior_first_step, reject_comm_every,
    resolve_ensemble_impl, run_deep, traced_run, validate_deep_halo,
)
from .diffusion import IMPLS, _local_shape, _resolve_impl

__all__ = ["StokesParams", "init_stokes3d", "stokes_step_local", "make_stokes_run",
           "make_stokes_run_deep", "deep_step", "run_stokes", "stokes_residuals"]


@dataclass(frozen=True)
class StokesParams:
    """Physics/numerics constants (the JAX package's fields). ``overlap``
    takes the plain route interior-first; ``comm_every`` is the deep-halo
    cadence, on grids with ``halowidths[d] >= 2*k_d`` and ``overlaps[d] >=
    4*k_d`` (the iteration's dependency radius is 2)."""
    mu: float       # shear viscosity
    dt_v: float     # pseudo time step, momentum
    dt_p: float     # pseudo time step, pressure
    damp: float     # PT damping factor
    dx: float
    dy: float
    dz: float
    comm_every: int | str = 1
    overlap: bool = False


def init_stokes3d(*, mu=1.0, lx=10.0, ly=10.0, lz=10.0, rhog_mag=1.0, r_incl=1.0,
                  dtype=None, comm_every=None, overlap=False):
    """State ``(P, Vx, Vy, Vz, dVx, dVy, dVz, rhog)``: zero initial flow and a
    buoyant sphere of radius ``r_incl`` at the domain centre, as stacked
    tensors on the grid's device, and the `StokesParams` (Python floats,
    the JAX package's PT scalings). ``dtype=None`` is torch's default float
    dtype."""
    import torch

    check_initialized()
    gg = global_grid()
    nx, ny, nz = (int(n) for n in gg.nxyz)
    dx, dy, dz = lx / (nx_g() - 1), ly / (ny_g() - 1), lz / (nz_g() - 1)
    min_d = min(dx, dy, dz)
    n_max = max(nx_g(), ny_g(), nz_g())
    p = StokesParams(mu=mu, dt_v=min_d ** 2 / mu / 6.1 / 2.0, dt_p=6.1 * mu / n_max,
                     damp=1.0 - 6.0 / n_max, dx=dx, dy=dy, dz=dz,
                     comm_every=str(resolve_comm_every(comm_every)), overlap=overlap)
    P = zeros_g((nx, ny, nz), dtype=dtype)
    x, y, z = coords_g(dx, dy, dz, P)
    r2 = (x - lx / 2) ** 2 + (y - ly / 2) ** 2 + (z - lz / 2) ** 2
    sphere = np.broadcast_to((r2 < r_incl ** 2) * rhog_mag, P.shape).copy()
    rhog = device_put_g(torch.from_numpy(sphere).to(P.dtype))
    Vx = zeros_g((nx + 1, ny, nz), dtype=dtype)
    Vy = zeros_g((nx, ny + 1, nz), dtype=dtype)
    Vz = zeros_g((nx, ny, nz + 1), dtype=dtype)
    dVx = zeros_g((nx + 1, ny, nz), dtype=dtype)
    dVy = zeros_g((nx, ny + 1, nz), dtype=dtype)
    dVz = zeros_g((nx, ny, nz + 1), dtype=dtype)
    return (P, Vx, Vy, Vz, dVx, dVy, dVz, rhog), p


def _check_state(state, members=None):
    state = tuple(state)
    nd = 3 if members is None else 4
    if len(state) != 8 or any(a.dim() != nd for a in state):
        raise InvalidArgumentError(
            "the Stokes state is eight 3-D tensors (P, Vx, Vy, Vz, dVx, dVy, dVz, rhog)"
            + ("" if members is None else f", each leading with its {members} members") + ".")
    if members is not None:
        check_ensemble(state, members)
    return state


def _plain_step(state, p: StokesParams, block, members=None):
    """The plain route: the iteration in `_stokes_terms`' arithmetic
    (broadcast over an ensemble's ``members``), then
    ``local_update_halo(Vx, Vy, Vz, Pn)``."""
    Pn, Vx, Vy, Vz, dVx, dVy, dVz = stokes_update_plain(
        state, block=block, consts=stokes_consts(p), form="getter")
    Vx, Vy, Vz, Pn = local_update_halo(Vx, Vy, Vz, Pn, members=members)
    return (Pn, Vx, Vy, Vz, dVx, dVy, dVz, state[7])


def _overlap_step(state, p: StokesParams, members=None):
    """The plain route interior-first: the 7 updated fields' shells, the
    exchange of (Vx, Vy, Vz, Pn) on them under the interior update."""
    consts = stokes_consts(p)
    lead = int(members is not None)

    def pt_update(vx, vy, vz, Pc, dvx, dvy, dvz, rh):
        blk = tuple(a.contiguous() for a in (Pc, vx, vy, vz, dvx, dvy, dvz, rh))
        Pn, Vx, Vy, Vz, dVx, dVy, dVz = stokes_update_plain(
            blk, block=tuple(Pc.shape[lead:]), consts=consts, form="getter")
        return Vx, Vy, Vz, Pn, dVx, dVy, dVz

    P, Vx, Vy, Vz, dVx, dVy, dVz, rhog = state
    Vx, Vy, Vz, Pn, dVx, dVy, dVz = interior_first_step(
        pt_update, (Vx, Vy, Vz, P, dVx, dVy, dVz), (rhog,), radius=1, n_exchange=4,
        members=members)
    return (Pn, Vx, Vy, Vz, dVx, dVy, dVz, rhog)


def _resolve(state, p: StokesParams, impl: str, members=None):
    """The iteration on the current grid for states shaped like ``state``,
    as ``fn(state, out) -> state``: the fused route's `StokesStep` where
    ``impl`` is "cuda" and the gate admits the grid, else the plain route
    (interior-first with ``p.overlap``), which ignores ``out``. An
    ensemble's state (``members``) takes the plain route."""
    gg = global_grid()
    if members is not None:
        resolve_ensemble_impl(impl, "stokes")
        block = _local_shape(gg, _check_state(state, members)[0], 1)
        if p.overlap:
            return lambda st, out: _overlap_step(st, p, members)
        return lambda st, out: _plain_step(st, p, block, members)
    block = _local_shape(gg, _check_state(state)[0])
    if impl == "cuda":
        modes = stokes_exchange_modes(gg, [_local_shape(gg, a) for a in state], state[0].dtype)
        if modes is not None:
            return StokesStep(gg, modes, p, block=block)
    if p.overlap:
        return lambda st, out: _overlap_step(st, p)
    return lambda st, out: _plain_step(st, p, block)


def stokes_step_local(state, p: StokesParams, impl: str = "plain", out=None,
                      members: int | None = None):
    """One damped PT iteration of the stacked state (every rank's block)
    with the halo exchange of (Vx, Vy, Vz, P). ``impl`` is "cuda" (the fused
    route where the grid admits it, else the plain route) or "plain".
    ``out`` is a spare state the fused route may write into (it must not
    alias ``state``; its rhog is never written); the new state is returned
    either way, with the input's rhog. ``members``: an ensemble's state,
    each tensor leading with that many members (the plain route)."""
    if impl not in IMPLS:
        raise InvalidArgumentError(f"impl must be one of {IMPLS}; got {impl!r}.")
    state = tuple(state)
    return _resolve(state, p, impl, members)(state, out)


def make_stokes_run(p: StokesParams, nt_chunk: int, impl: str | None = None,
                    ensemble: int | None = None):
    """A runner advancing ``nt_chunk`` iterations: ``state = run(*state)``
    (pass ``donate=True`` to let it overwrite the input state). The route,
    the gate's modes and the constants are resolved once for the grid and
    the state's shapes, not every iteration. A deep cadence raises
    `InvalidArgumentError`: use `run_stokes` or `make_stokes_run_deep`.
    ``ensemble=E``: the state leads with E members (the plain route)."""
    from .common import make_state_runner, resolve_once

    reject_comm_every(p.comm_every, "StokesParams", "make_stokes_run",
                      "run_stokes or make_stokes_run_deep")
    members = None if ensemble is None else int(ensemble)
    impl = _resolve_impl(impl) if members is None else resolve_ensemble_impl(impl, "stokes")
    return make_state_runner(resolve_once(lambda state: _resolve(state, p, impl, members)),
                             nt_chunk=nt_chunk, ensemble=ensemble)


def deep_step(p: StokesParams, members: int | None = None):
    """The deep-halo PT super-step: ``cycle`` masked iterations of the plain
    route, the 7-field exchange (P, Vx, Vy, Vz, dVx, dVy, dVz) issued per
    axis when its cadence makes it due. Returns ``(step, cycle)``,
    ``step(state) -> state`` on the stacked tensors.

    Masks per dim ``d``, staleness ``r_d = j mod k_d`` (`common.fresh_mask`;
    the dependency radius is 2 an iteration): P retreats ``2 r_d`` with base
    0; V and dV retreat ``2 r_d + 1`` where ``r_d >= 1`` (0 on an axis that
    just exchanged) with base 1 (they read this iteration's Pn and the edge
    stresses one cell deeper). dV joins the exchange: the base scheme keeps
    its band consistent by recomputing every face an iteration, which the
    masks skip. ``members``: an ensemble's state."""
    import torch

    check_initialized()
    gg = global_grid()
    cad = resolve_comm_every(p.comm_every)
    validate_deep_halo(gg, 3, cad, depth_per_step=2)
    consts = stokes_consts(p)
    lead = int(members is not None)

    def step(state):
        P, Vx, Vy, Vz, dVx, dVy, dVz, rhog = _check_state(state, members)
        g = global_grid()
        loc = _local_shape(g, P, lead)
        for j in range(cad.cycle):
            r = cad.retreats(j)
            Pn, *new = stokes_update_plain((P, Vx, Vy, Vz, dVx, dVy, dVz, rhog), block=loc,
                                           consts=consts, form="getter")
            if any(r):
                Pn = torch.where(fresh_mask(loc, tuple(2 * x for x in r), (0, 0, 0), (0, 0, 0)),
                                 Pn, P)
                old = (Vx, Vy, Vz, dVx, dVy, dVz)
                for s in range(3):
                    m = fresh_mask(_local_shape(g, old[s], lead),
                                   tuple(2 * x + 1 if x else 0 for x in r),
                                   (1, 1, 1), (1, 1, 1))
                    new[s] = torch.where(m, new[s], old[s])
                    new[s + 3] = torch.where(m, new[s + 3], old[s + 3])
            P = Pn
            Vx, Vy, Vz, dVx, dVy, dVz = new
            due = cad.due_dims(j)
            if due:
                P, Vx, Vy, Vz, dVx, dVy, dVz = local_update_halo(
                    P, Vx, Vy, Vz, dVx, dVy, dVz, dims=due, members=members)
        return (P, Vx, Vy, Vz, dVx, dVy, dVz, rhog)

    return step, cad.cycle


def make_stokes_run_deep(p: StokesParams, nt_chunk_super: int, ensemble: int | None = None):
    """The deep-halo PT runner: ``state = run(*state)`` advances
    ``nt_chunk_super`` super-steps (`deep_step`). The input is never
    written. ``ensemble=E``: the state leads with E members."""
    from .common import make_state_runner

    step, _ = deep_step(p, None if ensemble is None else int(ensemble))
    return make_state_runner(lambda state, spare: (step(state), None),
                             nt_chunk=nt_chunk_super, ensemble=ensemble)


@traced_run
def run_stokes(state, p: StokesParams, nt: int, *, nt_chunk: int = 100,
               impl: str | None = None, ensemble: int | None = None):
    """Run ``nt`` PT iterations and return the new state (the input is not
    written). Returns after the device has drained. A deep ``comm_every``
    cadence runs `make_stokes_run_deep` (``nt`` a multiple of its cycle).
    ``ensemble=E``: every tensor of the state leads with E members
    (`common.ensemble_state`)."""
    from .common import run_chunked

    E = None if ensemble is None else check_ensemble(tuple(state), ensemble)
    if resolve_comm_every(p.comm_every).deep:
        return run_deep(lambda c: make_stokes_run_deep(p, c, ensemble=E), tuple(state), p, nt,
                        nt_chunk, impl)
    return run_chunked(lambda c: make_stokes_run(p, c, impl, ensemble=E), tuple(state), nt,
                       nt_chunk)


def stokes_residuals(state, p: StokesParams):
    """Global (max |divV|, max |R|) over every block: the convergence
    monitor of the PT loop, `_stokes_terms` per block (plain tensor
    operations, as the JAX package computes it outside any kernel), the
    maximum over the processes' boxes taken by an all-reduce (COLLECTIVE
    where a process group is up)."""
    check_initialized()
    state = _check_state(state)
    gg = global_grid()
    _, divV, Rx, Ry, Rz = stokes_terms_plain(state, block=_local_shape(gg, state[0]),
                                             consts=stokes_consts(p))
    err_div = divV.abs().max()
    err_mom = Rx.abs().max().maximum(Ry.abs().max()).maximum(Rz.abs().max())
    err_div, err_mom = gg.transport.all_max([float(err_div), float(err_mom)])
    return err_div, err_mom
