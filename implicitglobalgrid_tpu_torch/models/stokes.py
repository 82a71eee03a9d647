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
it). Not ported yet (each raises `NotSupportedError`): a deep
``comm_every`` cadence (`deep_step`, `make_stokes_run_deep`; every spelling
of cadence 1 runs), ``ensemble``, and ``overlap=True`` on the plain route.
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
from ..utils.exceptions import InvalidArgumentError, NotSupportedError
from .common import reject_deep
from .diffusion import IMPLS, _local_shape, _reject_ensemble, _resolve_impl

__all__ = ["StokesParams", "init_stokes3d", "stokes_step_local", "make_stokes_run",
           "make_stokes_run_deep", "deep_step", "run_stokes", "stokes_residuals"]

_LATER = "a later slice of the PyTorch port"


@dataclass(frozen=True)
class StokesParams:
    """Physics/numerics constants (the JAX package's fields; a deep
    ``comm_every`` cadence is not ported yet)."""
    mu: float       # shear viscosity
    dt_v: float     # pseudo time step, momentum
    dt_p: float     # pseudo time step, pressure
    damp: float     # PT damping factor
    dx: float
    dy: float
    dz: float
    comm_every: int | str = 1
    overlap: bool = False


def check_supported(p: StokesParams) -> None:
    """Raise `NotSupportedError` for the deep-halo cadence, which a later
    slice ports."""
    reject_deep(p.comm_every, "StokesParams")


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
    check_supported(p)
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


def _check_state(state):
    state = tuple(state)
    if len(state) != 8 or any(a.dim() != 3 for a in state):
        raise InvalidArgumentError(
            "the Stokes state is eight 3-D tensors (P, Vx, Vy, Vz, dVx, dVy, dVz, rhog).")
    return state


def _plain_step(state, p: StokesParams, block):
    """The plain route: the iteration in `_stokes_terms`' arithmetic, then
    ``local_update_halo(Vx, Vy, Vz, Pn)``."""
    Pn, Vx, Vy, Vz, dVx, dVy, dVz = stokes_update_plain(
        state, block=block, consts=stokes_consts(p), form="getter")
    Vx, Vy, Vz, Pn = local_update_halo(Vx, Vy, Vz, Pn)
    return (Pn, Vx, Vy, Vz, dVx, dVy, dVz, state[7])


def _resolve(state, p: StokesParams, impl: str):
    """The iteration on the current grid for states shaped like ``state``,
    as ``fn(state, out) -> state``: the fused route's `StokesStep` where
    ``impl`` is "cuda" and the gate admits the grid, else the plain route
    (which ignores ``out``)."""
    gg = global_grid()
    block = _local_shape(gg, _check_state(state)[0])
    if impl == "cuda":
        modes = stokes_exchange_modes(gg, [_local_shape(gg, a) for a in state], state[0].dtype)
        if modes is not None:
            return StokesStep(gg, modes, p, block=block)
    if p.overlap:
        raise NotSupportedError(
            f"StokesParams(overlap=True) on the plain route is not ported yet ({_LATER}).")
    return lambda st, out: _plain_step(st, p, block)


def stokes_step_local(state, p: StokesParams, impl: str = "plain", out=None):
    """One damped PT iteration of the stacked state (every rank's block)
    with the halo exchange of (Vx, Vy, Vz, P). ``impl`` is "cuda" (the fused
    route where the grid admits it, else the plain route) or "plain".
    ``out`` is a spare state the fused route may write into (it must not
    alias ``state``; its rhog is never written); the new state is returned
    either way, with the input's rhog."""
    check_supported(p)
    if impl not in IMPLS:
        raise InvalidArgumentError(f"impl must be one of {IMPLS}; got {impl!r}.")
    state = tuple(state)
    return _resolve(state, p, impl)(state, out)


def make_stokes_run(p: StokesParams, nt_chunk: int, impl: str | None = None,
                    ensemble: int | None = None):
    """A runner advancing ``nt_chunk`` iterations: ``state = run(*state)``
    (pass ``donate=True`` to let it overwrite the input state). The route,
    the gate's modes and the constants are resolved once for the grid and
    the state's shapes, not every iteration."""
    from .common import make_state_runner, resolve_once

    _reject_ensemble(ensemble)
    check_supported(p)
    impl = _resolve_impl(impl)
    return make_state_runner(resolve_once(lambda state: _resolve(state, p, impl)),
                             nt_chunk=nt_chunk)


def deep_step(p: StokesParams):
    """The deep-halo super-step (``comm_every`` > 1): not ported yet."""
    raise NotSupportedError(f"deep-halo stepping (comm_every) is not ported yet ({_LATER}).")


def make_stokes_run_deep(p: StokesParams, nt_chunk_super: int, ensemble: int | None = None):
    """The deep-halo runner (``comm_every`` > 1): not ported yet."""
    raise NotSupportedError(f"deep-halo stepping (comm_every) is not ported yet ({_LATER}).")


def run_stokes(state, p: StokesParams, nt: int, *, nt_chunk: int = 100,
               impl: str | None = None, ensemble: int | None = None):
    """Run ``nt`` PT iterations and return the new state (the input is not
    written). Returns after the device has drained."""
    from .common import run_chunked

    _reject_ensemble(ensemble)
    check_supported(p)
    return run_chunked(lambda c: make_stokes_run(p, c, impl), tuple(state), nt, nt_chunk)


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
