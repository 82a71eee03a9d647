"""3-D (and 2-D) heat diffusion — the main path of the port.

Counterpart of `implicitglobalgrid_tpu/models/diffusion.py`: the reference
example's hot loop

    q = -λ ∇T;   δT/δt = -∇·q / cₚ;   T += dt δT/δt;   update_halo(T)

on stacked tensors over the virtual mesh. Two routes (``impl``):

- ``"cuda"`` (the default while ``IGG_USE_PALLAS`` is on), the JAX
  package's Pallas route order. 3-D: every exchanging dim self-neighbour ->
  K1 with the halo updates folded in; else `step_exchange_modes` -> the
  fused step + exchange (K4s send slabs, then K4); else a self-neighbour
  prefix -> K1 then `local_update_halo` over the remaining dims; else K1
  then `local_update_halo`. 2-D: the fused step + exchange (K4s, then K5);
  where `step_exchange_modes` refuses the grid, K5 with no received slabs
  (the step alone) then `local_update_halo` (the JAX package runs XLA
  there). On CPU tensors the kernels' plain versions run; on a CUDA tensor
  every step is a kernel.
- ``"plain"``: the broadcast flux form (`_upd3`/`_upd2`) then
  `local_update_halo`, in plain PyTorch (the JAX package's ``"xla"``).

Not ported yet (each raises `NotSupportedError`): ``overlap``, ``sr``,
a deep ``comm_every`` cadence and ``ensemble``.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..ops.alloc import zeros_g
from ..ops.cuda_stencil import (
    diffusion2d_step_exchange, diffusion3d_step, diffusion3d_step_exchange,
    diffusion3d_step_halo, fusable_halo_dims, pallas_supported, step_exchange_modes,
)
from ..ops.fields import block_slices
from ..ops.halo import DEFAULT_DIMS_ORDER, _dim_exchanges, local_update_halo
from ..ops.stencil import d_xa, d_xi, d_ya, d_yi, d_za, d_zi, inn
from ..ops.wire import resolve_comm_every
from ..parallel.topology import check_initialized, global_grid
from ..tools import coords_g, nx_g, ny_g, nz_g
from ..utils.exceptions import InvalidArgumentError, NotSupportedError
from .common import reject_deep

__all__ = ["DiffusionParams", "init_diffusion3d", "init_diffusion2d",
           "diffusion_step_local", "make_step", "make_run", "run_diffusion"]

_LATER = "a later slice of the PyTorch port"
IMPLS = ("cuda", "plain")


@dataclass(frozen=True)
class DiffusionParams:
    """Physics/numerics constants (the JAX package's fields; ``overlap``,
    ``sr`` and a deep ``comm_every`` cadence are not ported yet)."""
    lam: float
    dt: float
    dx: float
    dy: float = 1.0
    dz: float = 1.0
    overlap: bool = False
    sr: bool = False
    sr_seed: int = 0
    comm_every: int | str = 1


def check_supported(p: DiffusionParams) -> None:
    """Raise `NotSupportedError` for the options a later slice ports."""
    if p.overlap:
        raise NotSupportedError(f"DiffusionParams(overlap=True) is not ported yet ({_LATER}).")
    if p.sr:
        raise NotSupportedError(f"DiffusionParams(sr=True) is not ported yet ({_LATER}).")
    reject_deep(p.comm_every, "DiffusionParams")


def init_diffusion3d(*, lam=1.0, cp_min=1.0, lx=10.0, ly=10.0, lz=10.0,
                     dtype=None, overlap=False, sr=False, sr_seed=0,
                     comm_every=None):
    """Build ``(T, Cp, params)`` with the reference example's initial
    conditions (two Gaussian anomalies each) as stacked tensors on the
    grid's device. ``dtype=None`` is torch's default float dtype."""
    import torch

    check_initialized()
    p_opts = dict(overlap=overlap, sr=sr, sr_seed=sr_seed,
                  comm_every=str(resolve_comm_every(comm_every)))
    dx = lx / (nx_g() - 1)
    dy = ly / (ny_g() - 1)
    dz = lz / (nz_g() - 1)
    dt = min(dx * dx, dy * dy, dz * dz) * cp_min / lam / 8.1
    p = DiffusionParams(lam=lam, dt=dt, dx=dx, dy=dy, dz=dz, **p_opts)
    check_supported(p)

    Tz = zeros_g(dtype=dtype)
    x, y, z = (torch.as_tensor(v, device=Tz.device).to(Tz.dtype)
               for v in coords_g(dx, dy, dz, Tz))
    Cp = cp_min \
        + 5 * torch.exp(-((x - lx / 1.5) ** 2) - ((y - ly / 2) ** 2) - ((z - lz / 1.5) ** 2)) \
        + 5 * torch.exp(-((x - lx / 3.0) ** 2) - ((y - ly / 2) ** 2) - ((z - lz / 1.5) ** 2))
    T = 100 * torch.exp(-(((x - lx / 2) / 2) ** 2) - (((y - ly / 2) / 2) ** 2) - (((z - lz / 3.0) / 2) ** 2)) \
        + 50 * torch.exp(-(((x - lx / 2) / 2) ** 2) - (((y - ly / 2) / 2) ** 2) - (((z - lz / 1.5) / 2) ** 2))
    T = T.expand(Tz.shape).to(Tz.dtype).contiguous()
    Cp = Cp.expand(Tz.shape).to(Tz.dtype).contiguous()
    return T, Cp, p


def init_diffusion2d(*, lam=1.0, cp_min=1.0, lx=10.0, ly=10.0, dtype=None):
    """2-D variant."""
    import torch

    check_initialized()
    gg = global_grid()
    dx = lx / (nx_g() - 1)
    dy = ly / (ny_g() - 1)
    dt = min(dx * dx, dy * dy) * cp_min / lam / 4.1
    Tz = zeros_g(tuple(int(n) for n in gg.nxyz[:2]), dtype=dtype)
    x, y = (torch.as_tensor(v, device=Tz.device).to(Tz.dtype)
            for v in coords_g(dx, dy, 1.0, Tz)[:2])
    Cp = cp_min + 5 * torch.exp(-((x - lx / 1.5) ** 2) - ((y - ly / 2) ** 2))
    T = 100 * torch.exp(-(((x - lx / 2) / 2) ** 2) - (((y - ly / 2) / 2) ** 2))
    T = T.expand(Tz.shape).to(Tz.dtype).contiguous()
    Cp = Cp.expand(Tz.shape).to(Tz.dtype).contiguous()
    return T, Cp, DiffusionParams(lam=lam, dt=dt, dx=dx, dy=dy)


def _plain_consts(p: DiffusionParams, T):
    """The parameters as 0-d tensors of the state's dtype on its device (the
    JAX package's weakly-typed Python scalars take the array's dtype), so
    every division is a true division on every device."""
    import torch

    return {k: torch.tensor(float(getattr(p, k)), dtype=T.dtype, device=T.device)
            for k in ("lam", "dt", "dx", "dy", "dz")}


def _upd3(Tb, Cpb, c):
    """The 3-D flux/divergence/update stencil of one block (the JAX
    package's `_upd3`); returns the increment of the interior."""
    qx = -c["lam"] * d_xi(Tb) / c["dx"]
    qy = -c["lam"] * d_yi(Tb) / c["dy"]
    qz = -c["lam"] * d_zi(Tb) / c["dz"]
    dTdt = (-d_xa(qx) / c["dx"] - d_ya(qy) / c["dy"]
            - d_za(qz) / c["dz"]) / inn(Cpb)
    return c["dt"] * dTdt


def _upd2(Tb, Cpb, c):
    """2-D variant of `_upd3`."""
    qx = -c["lam"] * d_xi(Tb) / c["dx"]
    qy = -c["lam"] * d_yi(Tb) / c["dy"]
    dTdt = (-d_xa(qx) / c["dx"] - d_ya(qy) / c["dy"]) / inn(Cpb)
    return c["dt"] * dTdt


def _plain_step(T, Cp, p, loc):
    """Every block's interior updated by the broadcast flux form (the JAX
    package runs it per shard inside `shard_map`), into a new tensor."""
    c = _plain_consts(p, T)
    upd = _upd3 if T.dim() == 3 else _upd2
    out = T.clone()
    for sl in block_slices(T.shape, loc):
        inn(out[sl]).add_(upd(T[sl], Cp[sl], c))
    return out


def _local_shape(gg, T):
    return tuple(int(s) // int(gg.dims[d]) for d, s in enumerate(T.shape))


def _cuda_step3(T, Cp, p, gg, loc, out):
    """The 3-D kernel route, in the JAX package's order."""
    kw = dict(lam=p.lam, dt=p.dt, dx=p.dx, dy=p.dy, dz=p.dz, block=loc, out=out)
    hws = tuple(int(h) for h in gg.halowidths)
    fuse = fusable_halo_dims(gg)
    covers_all = fuse is not None and not any(
        _dim_exchanges(gg, loc, hws, d) for d in range(3) if not fuse[d])
    if covers_all:
        # every exchanging dim is self-neighbour: the halo updates fold into
        # the step's output pass
        return diffusion3d_step_halo(T, Cp, fuse=fuse, **kw)
    modes = step_exchange_modes(gg, loc)
    if modes is not None:
        # multi-rank (or mixed) exchange fused with the step: send slabs
        # computed from the current state, delivered in the step's pass
        return diffusion3d_step_exchange(T, Cp, gg, modes, **kw)
    if fuse is not None:
        # a self-neighbour prefix of the z, x, y order folds in; the
        # remaining dims (the suffix) are exchanged afterwards
        T = diffusion3d_step_halo(T, Cp, fuse=fuse, **kw)
        rem = tuple(d for d in DEFAULT_DIMS_ORDER if not fuse[d])
        return local_update_halo(T, dims=rem)
    return local_update_halo(diffusion3d_step(T, Cp, **kw))


def _cuda_step2(T, Cp, p, gg, loc, out):
    """The 2-D kernel route: K5 with the exchange fused where
    `step_exchange_modes` admits the grid, else K5 alone then the
    exchange."""
    modes = step_exchange_modes(gg, loc)
    T = diffusion2d_step_exchange(T, Cp, gg, modes or (False, False), lam=p.lam,
                                  dt=p.dt, dx=p.dx, dy=p.dy, block=loc, out=out)
    return T if modes is not None else local_update_halo(T)


def diffusion_step_local(T, Cp, p: DiffusionParams, impl: str = "plain",
                         out=None):
    """One time step of stacked ``T`` (every rank's block) followed by the
    halo exchange. ``impl`` is "cuda" (the kernel route) or "plain".
    ``out`` is a spare buffer the kernel route may write the new state into
    (it must not alias ``T``); the result is returned either way."""
    check_supported(p)
    if impl not in IMPLS:
        raise InvalidArgumentError(f"impl must be one of {IMPLS}; got {impl!r}.")
    if T.dim() not in (2, 3):
        raise InvalidArgumentError(f"diffusion runs on 2-D and 3-D fields; got {T.dim()}-D.")
    gg = global_grid()
    loc = _local_shape(gg, T)
    if impl == "cuda":
        if T.dim() == 2:
            return _cuda_step2(T, Cp, p, gg, loc, out)
        if pallas_supported(loc):
            return _cuda_step3(T, Cp, p, gg, loc, out)
        if T.device.type != "cpu":
            raise NotSupportedError(
                f"the step kernels need blocks of >= 3 planes; got {loc}.")
    return local_update_halo(_plain_step(T, Cp, p, loc))


def _resolve_impl(impl):
    """An explicit ``impl`` wins; else the kernel route while every
    ``IGG_USE_PALLAS`` flag of the grid is on (the JAX package's rule, on
    every device here: on the CPU the kernels' plain versions run), in 3-D
    and in 2-D."""
    if impl is not None:
        if impl not in IMPLS:
            raise InvalidArgumentError(f"impl must be one of {IMPLS}; got {impl!r}.")
        return impl
    gg = global_grid()
    return "cuda" if bool(gg.use_pallas.all()) else "plain"


def _reject_ensemble(ensemble):
    if ensemble is not None:
        raise NotSupportedError(f"ensemble batching is not ported yet ({_LATER}).")


def make_step(p: DiffusionParams, ndim: int = 3, impl: str | None = None):
    """A single step on stacked tensors: ``T = step(T, Cp)``."""
    check_initialized()
    check_supported(p)
    impl = _resolve_impl(impl)

    def step(T, Cp):
        return diffusion_step_local(T, Cp, p, impl)

    return step


def make_run(p: DiffusionParams, nt_chunk: int, ndim: int = 3,
             impl: str | None = None, ensemble: int | None = None):
    """A runner advancing ``nt_chunk`` steps: ``(T, Cp) = run(T, Cp)``
    (pass ``donate=True`` to let it overwrite the input ``T``)."""
    from .common import make_state_runner

    _reject_ensemble(ensemble)
    check_supported(p)
    impl = _resolve_impl(impl)

    def step(state, spare):
        T, Cp = state
        return (diffusion_step_local(T, Cp, p, impl, out=spare), Cp), T

    return make_state_runner(step, nt_chunk=nt_chunk)


def run_diffusion(T, Cp, p: DiffusionParams, nt: int, *, nt_chunk: int = 100,
                  impl: str | None = None, ensemble: int | None = None):
    """Advance ``nt`` steps and return the new ``T`` (the input is not
    written). Returns after the device has drained."""
    from .common import run_chunked

    _reject_ensemble(ensemble)
    T, Cp = run_chunked(lambda c: make_run(p, c, T.dim(), impl), (T, Cp),
                        nt, nt_chunk)
    return T
