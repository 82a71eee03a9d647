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
Not ported yet (each raises `NotSupportedError`): a deep ``comm_every``
cadence (`deep_step`, `make_acoustic_run_deep`; every spelling of cadence 1
runs), ``ensemble``, and ``overlap=True`` on the plain route. Both routes
take float32, float64 and bfloat16 states.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..ops.alloc import device_put_g, zeros_g
from ..ops.cuda_wave import AcousticStep, wave_exchange_modes
from ..ops.fields import block_view
from ..ops.halo import local_update_halo
from ..ops.wire import resolve_comm_every
from ..parallel.topology import check_initialized, global_grid
from ..tools import coords_g, nx_g, ny_g, nz_g
from ..utils.exceptions import InvalidArgumentError, NotSupportedError
from .common import reject_deep
from .diffusion import IMPLS, _local_shape, _reject_ensemble, _resolve_impl

__all__ = ["AcousticParams", "init_acoustic3d", "acoustic_step_local",
           "make_acoustic_run", "make_acoustic_run_deep", "deep_step", "run_acoustic"]

_LATER = "a later slice of the PyTorch port"


@dataclass(frozen=True)
class AcousticParams:
    """Physics/numerics constants (the JAX package's fields; a deep
    ``comm_every`` cadence is not ported yet)."""
    rho: float
    K: float
    dt: float
    dx: float
    dy: float
    dz: float
    overlap: bool = False
    comm_every: int | str = 1


def check_supported(p: AcousticParams) -> None:
    """Raise `NotSupportedError` for the deep-halo cadence, which a later
    slice ports."""
    reject_deep(p.comm_every, "AcousticParams")


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
    check_supported(p)
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
    """The difference of neighbours along local ``axis`` of a block view."""
    return Ab.narrow(2 * axis + 1, 1, n - 1) - Ab.narrow(2 * axis + 1, 0, n - 1)


def _plain_step(state, p: AcousticParams, loc):
    """The plain route: the XLA tier's updates per block (broadcast over the
    block views), each followed by its exchange."""
    import torch

    P, Vx, Vy, Vz = state
    nx, ny, nz = loc

    def t(v):
        return torch.tensor(float(v), dtype=P.dtype, device=P.device)

    c_v, dtK = t(-p.dt / p.rho), t(p.dt * p.K)
    d = (t(p.dx), t(p.dy), t(p.dz))
    Pb = block_view(P, loc)
    vs = []
    for ax, V in enumerate((Vx, Vy, Vz)):
        m = [nx, ny, nz]
        m[ax] += 1
        U = V.clone()
        inner = block_view(U, m).narrow(2 * ax + 1, 1, loc[ax] - 1)
        inner.copy_(inner + (c_v * _dP(Pb, ax, loc[ax])) / d[ax])
        vs.append(U)
    Vx, Vy, Vz = local_update_halo(*vs)
    div = None
    for ax, V in enumerate((Vx, Vy, Vz)):
        m = [nx, ny, nz]
        m[ax] += 1
        term = _dP(block_view(V, m), ax, m[ax]) / d[ax]
        div = term if div is None else div + term
    P = (Pb - dtK * div).reshape(P.shape)
    return (local_update_halo(P), Vx, Vy, Vz)


def _check_state(state):
    state = tuple(state)
    if len(state) != 4 or any(a.dim() != 3 for a in state):
        raise InvalidArgumentError("the acoustic state is four 3-D tensors (P, Vx, Vy, Vz).")
    return state


def _resolve(state, p: AcousticParams, impl: str):
    """The step on the current grid for states shaped like ``state``, as
    ``fn(state, out) -> state``: the fused route's `AcousticStep` where
    ``impl`` is "cuda" and the gate admits the grid, else the plain route
    (which ignores ``out``)."""
    gg = global_grid()
    locs = [_local_shape(gg, a) for a in _check_state(state)]
    if impl == "cuda":
        modes = wave_exchange_modes(gg, locs)
        if modes is not None:
            return AcousticStep(gg, modes, rho=p.rho, K=p.K, dt=p.dt, dx=p.dx, dy=p.dy,
                                dz=p.dz, block=locs[0])
    if p.overlap:
        raise NotSupportedError(
            f"AcousticParams(overlap=True) on the plain route is not ported yet ({_LATER}).")
    return lambda st, out: _plain_step(st, p, locs[0])


def acoustic_step_local(state, p: AcousticParams, impl: str = "plain", out=None):
    """One leapfrog step of the stacked state (every rank's block) with the
    halo exchanges. ``impl`` is "cuda" (the fused route where the grid
    admits it, else the plain route) or "plain". ``out`` is a spare state
    the fused route may write into (it must not alias ``state``); the new
    state is returned either way."""
    check_supported(p)
    if impl not in IMPLS:
        raise InvalidArgumentError(f"impl must be one of {IMPLS}; got {impl!r}.")
    state = tuple(state)
    return _resolve(state, p, impl)(state, out)


def make_acoustic_run(p: AcousticParams, nt_chunk: int, impl: str | None = None,
                      ensemble: int | None = None):
    """A runner advancing ``nt_chunk`` steps: ``state = run(P, Vx, Vy, Vz)``
    (pass ``donate=True`` to let it overwrite the input state). The route,
    the gate's modes and the constants are resolved once for the grid and
    the state's shapes, not every step."""
    from .common import make_state_runner, resolve_once

    _reject_ensemble(ensemble)
    check_supported(p)
    impl = _resolve_impl(impl)
    return make_state_runner(resolve_once(lambda state: _resolve(state, p, impl)),
                             nt_chunk=nt_chunk)


def deep_step(p: AcousticParams):
    """The deep-halo super-step (``comm_every`` > 1): not ported yet."""
    raise NotSupportedError(f"deep-halo stepping (comm_every) is not ported yet ({_LATER}).")


def make_acoustic_run_deep(p: AcousticParams, nt_chunk_super: int,
                           ensemble: int | None = None):
    """The deep-halo runner (``comm_every`` > 1): not ported yet."""
    raise NotSupportedError(f"deep-halo stepping (comm_every) is not ported yet ({_LATER}).")


def run_acoustic(state, p: AcousticParams, nt: int, *, nt_chunk: int = 100,
                 impl: str | None = None, ensemble: int | None = None):
    """Advance ``nt`` steps and return the new state (the input is not
    written). Returns after the device has drained."""
    from .common import run_chunked

    _reject_ensemble(ensemble)
    check_supported(p)
    return run_chunked(lambda c: make_acoustic_run(p, c, impl), tuple(state), nt, nt_chunk)
