"""Shared model machinery: the step loop and the chunked runner.

Counterpart of `implicitglobalgrid_tpu/models/common.py`. The JAX package
compiles a chunk of steps into one program (`lax.fori_loop`); PyTorch runs
eagerly, so a chunk is a Python loop over the step, and the runner
ping-pongs two buffers: a step writes its new state into the buffer the
step before last wrote, so a run allocates two buffers at most and never
writes the caller's input.

The deep-halo machinery of the three models lives here too
(`validate_deep_halo`, `fresh_mask` on the stacked layout, `run_deep`),
`interior_first_step`, the entry of their ``overlap=True`` steps, and the
ensemble axis (`ensemble_state`, `ensemble_partition_spec`,
`resolve_ensemble_impl`, ``make_state_runner(ensemble=)``): E scenario
members advanced together, each state tensor leading with a member axis.
The JAX package vmaps its step over that axis; here the plain route's
arithmetic broadcasts over it and the exchange carries every member in
one K8 + K7 launch a dim (`ops.halo.local_update_halo(members=)`).
"""

from __future__ import annotations

import functools

from ..analysis import record as _record
from ..ops.wire import resolve_comm_every
from ..parallel.topology import check_initialized, global_grid, live_epochs
from ..utils.exceptions import IncoherentArgumentError, InvalidArgumentError
from ..utils.profiling import label, profiler_active

__all__ = ["make_state_runner", "resolve_once", "run_chunked", "traced_run",
           "resolve_comm_every", "fresh_mask", "validate_deep_halo", "interior_first_step",
           "reject_comm_every", "run_deep", "ensemble_partition_spec", "ensemble_state",
           "resolve_ensemble_impl", "check_ensemble"]

# fresh masks by grid and request: the live epochs' only (`live_epochs`)
_masks: dict = {}


def fresh_mask(shape, retreat, base_lo, base_hi):
    """Update-region mask of the deep-halo sub-steps (True: the cell's
    stencil dependencies are fresh), as ONE boolean tensor of the stacked
    shape of this process's box of ``shape`` blocks, on the grid's device.

    Per dim ``d`` of each block: ``[base_lo[d] + r_d*L, n_d - base_hi[d] -
    r_d*R)``, where L/R flag a neighbour on that side of the block (its
    GLOBAL block coordinate, the box's first rank ``gg.coords`` plus its
    position in the box; a periodic side always has one). ``base_lo/hi``
    give the scheme's update region when fresh; ``retreat`` is the
    sub-steps of staleness, a scalar or one per dim (`CommCadence.retreats`).
    The skipped cells keep stale values, which that axis's next k-wide
    exchange overwrites. Built once per grid and request, as the JAX
    package's per-shard `lax.axis_index` mask."""
    import numpy as np
    import torch

    gg = global_grid()
    nd = len(shape)
    ret = tuple(int(r) for r in retreat) if np.iterable(retreat) else (int(retreat),) * nd
    key = (gg.epoch, str(gg.device), tuple(int(s) for s in shape), ret,
           tuple(int(b) for b in base_lo), tuple(int(b) for b in base_hi),
           tuple(int(c) for c in gg.coords[:nd]), tuple(int(b) for b in gg.box[:nd]),
           tuple(int(p) for p in gg.periods[:nd]))
    m = _masks.get(key)
    if m is not None:
        return m
    live = live_epochs()
    for k in [k for k in _masks if k[0] not in live]:
        del _masks[k]
    mask = None
    for d in range(nd):
        n, per = int(shape[d]), bool(int(gg.periods[d]))
        g = int(gg.coords[d]) + np.arange(int(gg.box[d]))  # global block coordinates
        lo = base_lo[d] + np.where((g > 0) | per, ret[d], 0)
        hi = n - base_hi[d] - np.where((g < int(gg.dims[d]) - 1) | per, ret[d], 0)
        i = np.arange(n)
        md = ((i >= lo[:, None]) & (i < hi[:, None])).reshape(-1)
        md = md.reshape([-1 if dd == d else 1 for dd in range(nd)])
        mask = md if mask is None else mask & md
    _masks[key] = m = torch.from_numpy(np.ascontiguousarray(mask)).to(gg.device)
    return m


def validate_deep_halo(gg, ndim: int, k, depth_per_step: int = 1) -> None:
    """The ``comm_every`` coherence checks (the JAX package's). ``k`` is the
    cadence (an int, a spec or a `CommCadence`); ``depth_per_step`` the
    scheme's dependency radius a sub-step (1: diffusion and the acoustic
    leapfrog; 2: the Stokes PT iteration). Every exchanging dim ``d`` needs
    halowidth >= depth_per_step*k_d and local size >= overlap +
    depth_per_step*k_d (the send slabs must lie inside the last sub-step's
    freshly updated region, or an interior block ships stale values)."""
    cad = resolve_comm_every(k)
    for d in range(ndim):
        need = depth_per_step * cad.for_dim(d)
        if not (int(gg.dims[d]) > 1 or int(gg.periods[d])):
            continue
        if int(gg.halowidths[d]) < need:
            raise IncoherentArgumentError(
                f"comm_every={cad} needs halowidths[{d}] >= {need} on every exchanging "
                f"dim (got {int(gg.halowidths[d])}): init the grid with overlaps[{d}] >= "
                f"{2 * need} and halowidths[{d}] = {need}.")
        n_d, ol_d = int(gg.nxyz[d]), int(gg.overlaps[d])
        if n_d < ol_d + need:
            raise IncoherentArgumentError(
                f"comm_every={cad} needs local size >= overlap + {need} on dim {d} (got "
                f"n={n_d}, overlap={ol_d}): the send slabs would leave the freshly-updated "
                "region.")


def interior_first_step(update_fn, outs, aux=(), *, radius: int = 1,
                        n_exchange: int | None = None, coalesce=None, wire_dtype=None,
                        members: int | None = None):
    """The interior-first shape of a step (every model's ``overlap=True``
    route): boundary shells, then ONE exchange round of the first
    ``n_exchange`` of ``outs`` on a side stream while the interior runs,
    then the stitch. A thin, named entry over the multi-field form of
    `ops.overlap.hide_communication`; the same values as
    ``local_update_halo(*update_fn(*outs, *aux))`` per block. ``members``:
    an ensemble's state (`ops.overlap.hide_communication`)."""
    from ..ops.overlap import hide_communication

    return hide_communication(update_fn, tuple(outs), *aux, radius=radius,
                              n_exchange=n_exchange, coalesce=coalesce, wire_dtype=wire_dtype,
                              members=members)


def ensemble_partition_spec(ndim: int) -> tuple:
    """The layout of an ensemble's field of ``ndim`` physical axes, as the
    JAX package's ``PartitionSpec`` names it: a leading member axis that no
    mesh axis splits (every block holds all members), then the mesh axes
    of the physical ones, ``(None, "gx", "gy", "gz")[:ndim + 1]``."""
    from ..parallel.topology import AXIS_NAMES

    return (None, *AXIS_NAMES[:int(ndim)])


def ensemble_state(state, members: int, *, perturb: float = 0.0):
    """``members`` copies of stacked field(s) along a NEW leading member
    axis, on the grid's device: the state an ensemble runner
    (``run_*(..., ensemble=members)``) advances. ``state`` is one tensor
    (or anything `torch.as_tensor` takes), a tuple/list or a dict of them;
    the container is kept. ``perturb`` scales member ``m`` by ``1 +
    perturb * m`` (computed in float32, cast to the state's dtype): member 0
    stays bitwise the base state, so it compares with the solo run."""
    import torch

    check_initialized()
    gg = global_grid()
    E = int(members)
    if E < 1:
        raise InvalidArgumentError(f"ensemble_state: members must be >= 1; got {members}.")

    def one(A):
        A = torch.as_tensor(A, device=gg.device)
        stacked = A.unsqueeze(0).expand((E,) + tuple(A.shape)).contiguous()
        if perturb:
            fac = (1.0 + float(perturb) * torch.arange(E, dtype=torch.float32,
                                                       device=gg.device)).to(A.dtype)
            stacked = stacked * fac.reshape((E,) + (1,) * A.dim())
        return stacked

    if isinstance(state, dict):
        return {k: one(v) for k, v in state.items()}
    if isinstance(state, (tuple, list)):
        return type(state)(one(v) for v in state)
    return one(state)


def resolve_ensemble_impl(impl, model: str = "step") -> str:
    """The ensemble's route: its members broadcast through the plain
    route's arithmetic (the JAX package runs its XLA tier under ``vmap``);
    ``None``/"plain" resolve to "plain", an explicit kernel route raises
    `InvalidArgumentError` rather than run another route."""
    if impl is not None and impl != "plain":
        raise InvalidArgumentError(
            f"impl={impl!r} is incompatible with ensemble batching: the ensemble axis "
            f"currently runs the {model} step's plain route (the fused kernels take one "
            "member). Pass impl=None/'plain' or drop ensemble=.")
    return "plain"


def check_ensemble(state, ensemble: int, ndim_min: int = 2) -> int:
    """``ensemble`` as an int after the JAX package's checks: ``>= 1`` and
    every tensor of ``state`` leading with that many members (build it
    with `ensemble_state`)."""
    E = int(ensemble)
    if E < 1:
        raise InvalidArgumentError(f"ensemble must be >= 1; got {ensemble}.")
    for A in state:
        if A.dim() < ndim_min or int(A.shape[0]) != E:
            raise InvalidArgumentError(
                f"ensemble={E} expects the state to lead with the member axis (shape (E, "
                f"...)); got {tuple(A.shape)} — build the state with "
                "models.common.ensemble_state.")
    return E


def make_state_runner(step_local, *, nt_chunk: int, ensemble: int | None = None,
                      post_chunk=None, key=None):
    """A runner ``run(*state, donate=False) -> state`` advancing
    ``nt_chunk`` steps.

    ``step_local(state, spare) -> (state, old)`` advances one step: it may
    write the new state into ``spare`` (a buffer it may overwrite, or None
    to allocate) and returns the new state and the buffer it no longer needs
    (which becomes the next step's ``spare``). The caller's input is used as
    a spare only with ``donate=True``. ``ensemble``: the member count of an
    ensemble's state (``>= 1``; the step carries the member axis).

    Under a recording (`analysis.record`) each step's collectives carry
    the step's index, and the hook's carry none.

    ``post_chunk(state) -> aux``: the hook after the chunk's last step (the
    health guard, `runtime.health`; the in-situ reducers,
    `io.reducers.make_reduced_post_chunk`): ``run`` returns ``(*state,
    aux)``, ``aux`` a float32 tensor on the state's device, equal on every
    process. An ensemble runner calls it as ``post_chunk(state,
    members=ensemble)`` and it gives an ``(E, n)`` matrix, one row a
    member. ``key`` is accepted for parity with the JAX package's callers
    (its compiled-runner cache key); nothing is cached here.

    While a profiler capture runs, a call is an ``igg::chunk`` span and each
    step an ``igg::step`` span (`utils.profiling`); ``run`` picks the traced
    loop once a call, and without a capture no step takes a span."""
    check_initialized()
    if ensemble is not None and int(ensemble) < 1:
        raise InvalidArgumentError(f"make_state_runner: ensemble must be >= 1; got {ensemble}.")
    nt_chunk = int(nt_chunk)

    def traced_step(state, spare):
        with label("igg::step"):
            return step_local(state, spare)

    def steps(state, donate, step):
        spare = None
        for k in range(nt_chunk):
            if _record.ACTIVE is not None:  # a recording: ops by step
                _record.ACTIVE.begin_step(k)
            state, old = step(state, spare)
            spare = old if (k > 0 or donate) else None
        if _record.ACTIVE is not None:
            _record.ACTIVE.end_steps()
        return state

    def run(*state, donate: bool = False):
        with label("igg::chunk"):
            state = steps(tuple(state), donate,
                          traced_step if profiler_active() else step_local)
            if post_chunk is None:
                return state
            aux = post_chunk(state) if ensemble is None \
                else post_chunk(state, members=int(ensemble))
            return (*state, aux)

    return run


def resolve_once(resolve):
    """A ``step_local`` for `make_state_runner` whose route ``resolve(state)``
    (a ``fn(state, out) -> state``) is resolved once for the current grid
    and the state's shapes, dtypes and devices, not every step (a route
    may keep buffers of the state's dtype on its device)."""
    from ..parallel.topology import global_grid

    resolved = [None, None, None]  # grid, state layout, route

    def step(state, spare):
        gg, layout = global_grid(), tuple((a.shape, a.dtype, a.device) for a in state)
        if resolved[0] is not gg or resolved[1] != layout:
            resolved[:] = gg, layout, resolve(state)
        return resolved[2](state, spare), state

    return step


def run_chunked(runner_factory, state, nt: int, nt_chunk: int):
    """Advance ``nt`` steps with ``runner_factory(chunk_size)``, in chunks
    of ``nt_chunk`` (the JAX package's compile boundary; kept for API
    parity). Returns after the device has drained. While a profiler capture
    runs, the drain is an ``igg::drain`` span (`utils.profiling`)."""
    from ..utils.timing import sync

    full, rem = divmod(int(nt), int(nt_chunk))
    donate = False
    if full:
        run = runner_factory(nt_chunk)
        for _ in range(full):
            state = run(*state, donate=donate)
            donate = True
    if rem:
        state = runner_factory(rem)(*state, donate=donate)
    with label("igg::drain"):
        return sync(state)


def traced_run(run_fn):
    """A model's ``run_*`` whose call, from entry to the return after the
    drain, is an ``igg::run`` span while a profiler capture runs
    (`utils.profiling`; one check a call)."""
    @functools.wraps(run_fn)
    def run(*args, **kwargs):
        with label("igg::run"):
            return run_fn(*args, **kwargs)

    return run


def reject_comm_every(comm_every, params: str, runner: str, deep_runners: str) -> None:
    """A runner that exchanges every step refuses a deep cadence
    (`InvalidArgumentError`, the JAX package's rule) rather than silently
    ignore it."""
    if resolve_comm_every(comm_every).deep:
        raise InvalidArgumentError(
            f"{params}(comm_every={comm_every!r}) needs the deep-halo runner: use "
            f"{deep_runners} ({runner} exchanges every step and cannot honor the cadence).")


def run_deep(make_run_deep, state, p, nt: int, nt_chunk: int, impl):
    """The deep branch of the models' ``run_*``: ``nt`` steps of params
    ``p``'s deep cadence as ``nt / cycle`` super-steps of
    ``make_run_deep(chunk)``, in chunks of ``nt_chunk`` steps. Deep stepping
    runs the plain route only (an explicit other ``impl`` raises, as the JAX
    package's non-XLA impls do), and ``nt`` must be a multiple of the cycle
    (the cadence defines the trajectory)."""
    cad = resolve_comm_every(p.comm_every)
    if impl is not None and impl != "plain":
        raise InvalidArgumentError(
            f"impl={impl!r} is incompatible with comm_every={cad}: deep-halo stepping runs "
            "only the plain route.")
    if int(nt) % cad.cycle:
        raise InvalidArgumentError(
            f"nt={nt} must be a multiple of the cadence cycle {cad.cycle} (comm_every={cad} "
            "defines the trajectory).")
    return run_chunked(make_run_deep, state, int(nt) // cad.cycle,
                       max(1, int(nt_chunk) // cad.cycle))
