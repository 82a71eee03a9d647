"""3-D (and 2-D) heat diffusion — the main path of the port.

Counterpart of `implicitglobalgrid_tpu/models/diffusion.py`: the reference
example's hot loop

    q = -λ ∇T;   δT/δt = -∇·q / cₚ;   T += dt δT/δt;   update_halo(T)

on the stacked tensors of each process's box of ranks (the whole grid on
the virtual mesh). Two routes (``impl``):

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
  `local_update_halo`, in plain PyTorch (the JAX package's ``"xla"``);
  with ``overlap=True`` the step goes interior-first through
  `ops.overlap.hide_communication` (the exchange of the shells on a side
  stream under the interior update). The kernel route ignores ``overlap``,
  as the JAX package's Pallas route does.

A deep ``comm_every`` cadence runs the communication-avoiding super-step
(`deep_step`, `make_run_deep`): masked sub-steps on the plain route, each
axis's k-wide exchange once per k_d sub-steps. ``sr=True`` on a bfloat16
state runs stochastic-rounding storage (`make_run_sr`, the plain route:
float32 flux, an unbiased round to bfloat16 with the bits of
`ops.precision.sr_bits`, then the exchange). ``ensemble=E`` advances E
members (each state tensor leads with the member axis,
`common.ensemble_state`) on the plain route: the update broadcasts over
the members, and every member crosses in one K8 + K7 launch a dim; deep
cadences and ``overlap=True`` compose with it, ``sr=True`` and
``impl="cuda"`` raise, as in the JAX package.
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
from ..ops.overlap import hide_communication
from ..ops.precision import sr_bits, stochastic_round_bf16
from ..ops.staggered import const_tensors
from ..ops.stencil import d_xa, d_xi, d_ya, d_yi, d_za, d_zi, inn
from ..ops.wire import resolve_comm_every
from ..parallel.topology import check_initialized, global_grid
from ..tools import coords_g, nx_g, ny_g, nz_g
from ..utils.exceptions import InvalidArgumentError, NotSupportedError
from .common import (
    check_ensemble, fresh_mask, reject_comm_every, resolve_ensemble_impl, run_deep,
    traced_run, validate_deep_halo,
)

__all__ = ["DiffusionParams", "init_diffusion3d", "init_diffusion2d",
           "diffusion_step_local", "make_step", "make_run", "make_run_sr", "make_run_deep",
           "deep_step", "run_diffusion"]

IMPLS = ("cuda", "plain")


@dataclass(frozen=True)
class DiffusionParams:
    """Physics/numerics constants (the JAX package's fields). ``sr`` stores
    a bfloat16 state by stochastic rounding (seeded ``sr_seed``; the
    runner `make_run_sr`). ``overlap`` takes the plain route interior-first;
    ``comm_every`` (an int, a per-axis spec such as ``"z:2"``) is the deep-halo
    cadence: needs a grid with ``overlaps[d] >= 2*k_d`` and ``halowidths[d]
    >= k_d`` on the exchanging dims; the trajectory equals cadence 1's."""
    lam: float
    dt: float
    dx: float
    dy: float = 1.0
    dz: float = 1.0
    overlap: bool = False
    sr: bool = False
    sr_seed: int = 0
    comm_every: int | str = 1


def _fresh_mask(shape, retreat):
    """Diffusion's deep-halo sub-step mask: the interior update retreats
    ``retreat`` cells per neighbour side (a scalar, or one per dim),
    ``[1 + r_d*L, n-1 - r_d*R)`` per dim (`common.fresh_mask`)."""
    return fresh_mask(shape, retreat, (1,) * len(shape), (1,) * len(shape))


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
    return const_tensors({k: getattr(p, k) for k in ("lam", "dt", "dx", "dy", "dz")}, T)


def _upd3(Tb, Cpb, c, lead=0):
    """The 3-D flux/divergence/update stencil of one block (the JAX
    package's `_upd3`); returns the increment of the interior. ``lead``:
    leading member axes, broadcast over."""
    k = dict(lead=lead)
    qx = -c["lam"] * d_xi(Tb, **k) / c["dx"]
    qy = -c["lam"] * d_yi(Tb, **k) / c["dy"]
    qz = -c["lam"] * d_zi(Tb, **k) / c["dz"]
    dTdt = (-d_xa(qx, **k) / c["dx"] - d_ya(qy, **k) / c["dy"]
            - d_za(qz, **k) / c["dz"]) / inn(Cpb, **k)
    return c["dt"] * dTdt


def _upd2(Tb, Cpb, c, lead=0):
    """2-D variant of `_upd3`."""
    k = dict(lead=lead)
    qx = -c["lam"] * d_xi(Tb, **k) / c["dx"]
    qy = -c["lam"] * d_yi(Tb, **k) / c["dy"]
    dTdt = (-d_xa(qx, **k) / c["dx"] - d_ya(qy, **k) / c["dy"]) / inn(Cpb, **k)
    return c["dt"] * dTdt


def _plain_step(T, Cp, p, loc, lead=0):
    """Every block's interior updated by the broadcast flux form (the JAX
    package runs it per shard inside `shard_map`), into a new tensor;
    ``lead`` leading member axes broadcast over."""
    c = _plain_consts(p, T)
    upd = _upd3 if T.dim() - lead == 3 else _upd2
    out = T.clone()
    whole = (slice(None),) * lead
    for sl in block_slices(T.shape[lead:], loc):
        sl = whole + sl
        inn(out[sl], lead=lead).add_(upd(T[sl], Cp[sl], c, lead))
    return out


def _block_update(p, T, lead=0):
    """The update of one block (or slab of one) as `hide_communication`
    takes it: `_plain_step`'s arithmetic, into a new tensor."""
    c = _plain_consts(p, T)
    upd = _upd3 if T.dim() - lead == 3 else _upd2

    def fn(Tb, Cpb):
        out = Tb.clone()
        inn(out, lead=lead).add_(upd(Tb, Cpb, c, lead))
        return out

    return fn


def _local_shape(gg, T, lead=0):
    """The LOCAL block shape of a stacked tensor of this process's box
    (after ``lead`` leading member axes)."""
    return tuple(int(s) // int(gg.box[d]) for d, s in enumerate(T.shape[lead:]))


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


def _sr_step(T, Cp, p, gg, loc, n):
    """The stochastic-rounding step: the plain route's arithmetic in
    float32, rounded to bfloat16 with the bits of global step ``n``
    (`sr_bits`: a function of the seed, ``n`` and each block's mesh
    coordinates), then the exchange."""
    import torch

    Tf = _plain_step(T.to(torch.float32), Cp.to(torch.float32), p, loc)
    nd = T.dim()
    bits = sr_bits(tuple(T.shape), loc, tuple(int(c) for c in gg.coords[:nd]),
                   tuple(int(d) for d in gg.dims[:nd]), p.sr_seed, n, T.device)
    return local_update_halo(stochastic_round_bf16(Tf, bits))


def diffusion_step_local(T, Cp, p: DiffusionParams, impl: str = "plain",
                         out=None, sr_step=None, members: int | None = None):
    """One time step of stacked ``T`` (every rank's block) followed by the
    halo exchange. ``impl`` is "cuda" (the kernel route) or "plain".
    ``out`` is a spare buffer the kernel route may write the new state into
    (it must not alias ``T``); the result is returned either way.
    ``sr_step`` (with ``p.sr`` and a bfloat16 state) is the global step
    number of the stochastic-rounding step (`make_run_sr` threads it); such
    a state without it raises `InvalidArgumentError`. ``members``: ``T``
    and ``Cp`` are an ensemble's, leading with that many members (the
    plain route only)."""
    import torch

    if members is not None:
        return _ensemble_step(T, Cp, p, impl, int(members))
    if p.sr and T.dtype == torch.bfloat16 and T.dim() in (2, 3):
        if sr_step is None:
            raise InvalidArgumentError(
                "DiffusionParams(sr=True) with a bfloat16 state needs the stochastic-rounding "
                "runner: use run_diffusion or make_run_sr (make_step/make_run cannot thread "
                "the global step the rounding bits depend on).")
        gg = global_grid()
        return _sr_step(T, Cp, p, gg, _local_shape(gg, T), int(sr_step))
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
    if p.overlap:
        return hide_communication(_block_update(p, T), T, Cp, radius=1)
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


def _ensemble_step(T, Cp, p, impl, members):
    """One plain-route step of an ensemble's ``T`` (leading with
    ``members`` members): the update broadcast over the members, then one
    exchange of every member (interior-first with ``p.overlap``)."""
    resolve_ensemble_impl(impl, "diffusion")
    if T.dim() not in (3, 4) or int(T.shape[0]) != members:
        raise InvalidArgumentError(
            f"an ensemble's diffusion state leads with its {members} members; got shape "
            f"{tuple(T.shape)}.")
    gg = global_grid()
    if p.overlap:
        return hide_communication(_block_update(p, T, 1), T, Cp, radius=1, members=members)
    return local_update_halo(_plain_step(T, Cp, p, _local_shape(gg, T, 1), 1),
                             members=members)


def _check_ensemble_params(p: DiffusionParams, T, ensemble):
    """The JAX package's checks of an ensemble run: no ``sr``, ``T``
    leading with the members. Returns the member count."""
    if p.sr:
        raise InvalidArgumentError(
            "ensemble batching does not support sr=True (stochastic-rounding storage is a "
            "solo-run feature).")
    return check_ensemble((T,), ensemble)


def make_step(p: DiffusionParams, ndim: int = 3, impl: str | None = None):
    """A single step on stacked tensors: ``T = step(T, Cp)``."""
    reject_comm_every(p.comm_every, "DiffusionParams", "make_step",
                      "run_diffusion or make_run_deep")
    check_initialized()
    impl = _resolve_impl(impl)

    def step(T, Cp):
        return diffusion_step_local(T, Cp, p, impl)

    return step


def make_run(p: DiffusionParams, nt_chunk: int, ndim: int = 3,
             impl: str | None = None, ensemble: int | None = None):
    """A runner advancing ``nt_chunk`` steps: ``(T, Cp) = run(T, Cp)``
    (pass ``donate=True`` to let it overwrite the input ``T``).
    ``ensemble=E``: the state leads with E members (the plain route)."""
    from .common import make_state_runner

    reject_comm_every(p.comm_every, "DiffusionParams", "make_run",
                      "run_diffusion or make_run_deep")
    impl = _resolve_impl(impl) if ensemble is None \
        else resolve_ensemble_impl(impl, "diffusion")
    members = None if ensemble is None else int(ensemble)

    def step(state, spare):
        T, Cp = state
        return (diffusion_step_local(T, Cp, p, impl, out=spare, members=members), Cp), T

    return make_state_runner(step, nt_chunk=nt_chunk, ensemble=ensemble)


def make_run_sr(p: DiffusionParams, nt_chunk: int, ndim: int = 3):
    """The stochastic-rounding runner: the state is ``(T, Cp, n)`` with
    ``n`` the GLOBAL step counter (an int), so the rounding bits of step
    ``n`` never repeat across chunk calls: ``(T, Cp, n) = run(T, Cp, n)``.
    The plain route; the input is never written."""
    from .common import make_state_runner

    def step(state, spare):
        T, Cp, n = state
        return (diffusion_step_local(T, Cp, p, "plain", sr_step=n), Cp, int(n) + 1), None

    return make_state_runner(step, nt_chunk=nt_chunk)


def deep_step(p: DiffusionParams, ndim: int = 3, members: int | None = None):
    """The communication-avoiding super-step: ``cycle`` (the lcm of the
    per-axis cadences) masked sub-steps of the plain route (`_fresh_mask`,
    per-dim retreats), each axis's k-wide exchange issued after the
    sub-steps its cadence makes it due (`CommCadence.due_dims`). Validates
    the grid's halos against the cadence; returns ``(step, cycle)``, where
    ``step((T, Cp)) -> (T, Cp)`` advances ``cycle`` physical steps of the
    stacked tensors (leading with ``members`` members: an ensemble's)."""
    import torch

    check_initialized()
    gg = global_grid()
    cad = resolve_comm_every(p.comm_every)
    validate_deep_halo(gg, ndim, cad)
    lead = int(members is not None)

    def step(state):
        T, Cp = state
        loc = _local_shape(global_grid(), T, lead)
        for j in range(cad.cycle):
            Tn = _plain_step(T, Cp, p, loc, lead)
            r = cad.retreats(j, ndim)
            T = torch.where(_fresh_mask(loc, r), Tn, T) if any(r) else Tn
            due = cad.due_dims(j, ndim)
            if due:
                T = local_update_halo(T, dims=due, members=members)
        return T, Cp

    return step, cad.cycle


def make_run_deep(p: DiffusionParams, nt_chunk_super: int, ndim: int = 3,
                  ensemble: int | None = None):
    """The communication-avoiding runner: ``(T, Cp) = run(T, Cp)`` advances
    ``nt_chunk_super`` super-steps (`deep_step`), each ``cycle`` physical
    steps. The input is never written. ``ensemble=E``: the state leads with
    E members."""
    from .common import make_state_runner

    step, _ = deep_step(p, ndim, None if ensemble is None else int(ensemble))
    return make_state_runner(lambda state, spare: (step(state), None),
                             nt_chunk=nt_chunk_super, ensemble=ensemble)


@traced_run
def run_diffusion(T, Cp, p: DiffusionParams, nt: int, *, nt_chunk: int = 100,
                  impl: str | None = None, ensemble: int | None = None):
    """Advance ``nt`` steps and return the new ``T`` (the input is not
    written). Returns after the device has drained. A deep ``comm_every``
    cadence runs `make_run_deep` (``nt`` a multiple of its cycle); ``sr``
    with a bfloat16 state runs `make_run_sr` from step 0 (the plain route:
    another ``impl`` raises `InvalidArgumentError`, as does a deep
    cadence). ``ensemble=E``: ``T`` and ``Cp`` lead with E members
    (`common.ensemble_state`); one exchange a dim carries them all."""
    import torch

    from .common import run_chunked

    if ensemble is not None:
        E = _check_ensemble_params(p, T, ensemble)
        ndim = T.dim() - 1
        if resolve_comm_every(p.comm_every).deep:
            return run_deep(lambda c: make_run_deep(p, c, ndim, ensemble=E), (T, Cp), p, nt,
                            nt_chunk, impl)[0]
        return run_chunked(lambda c: make_run(p, c, ndim, impl, ensemble=E), (T, Cp), nt,
                           nt_chunk)[0]
    sr = p.sr and T.dtype == torch.bfloat16
    if resolve_comm_every(p.comm_every).deep:
        if sr:
            raise InvalidArgumentError(
                "a deep comm_every cadence with sr=True is not supported (the deep-halo "
                "runner does not thread the rounding bits' step counter).")
        return run_deep(lambda c: make_run_deep(p, c, T.dim()), (T, Cp), p, nt, nt_chunk,
                        impl)[0]
    if sr:
        if impl is not None and impl != "plain":
            raise InvalidArgumentError(
                f"impl={impl!r} is incompatible with DiffusionParams(sr=True) on a bfloat16 "
                "state: stochastic-rounding storage runs only the plain route.")
        return run_chunked(lambda c: make_run_sr(p, c, T.dim()), (T, Cp, 0), nt,
                           nt_chunk)[0]
    T, Cp = run_chunked(lambda c: make_run(p, c, T.dim(), impl), (T, Cp),
                        nt, nt_chunk)
    return T
