"""Grid lifecycle: `init_global_grid`, `finalize_global_grid`, `select_device`.

Counterpart of `implicitglobalgrid_tpu/parallel/grid.py`, with every argument
check of its `init_global_grid` (same messages). The JAX package takes its
ranks from a device pool; here the rank count comes from ``dimx*dimy*dimz``
or, where dims are left at 0, from the pool through `dims_create`: an
explicit device list (``devices=``, the JAX package's pool, one entry a
rank) or a rank count (``nranks``). Each process of a `torch.distributed`
group owns a box of the ranks (`parallel.mesh.process_boxes`) on one device.
One process owns every rank (the virtual mesh).
"""

from __future__ import annotations

import os

import numpy as np

from ..utils.config import read_env_config
from ..utils.exceptions import (
    AlreadyInitializedError, IncoherentArgumentError, InvalidArgumentError, NotLoadedError,
    NotSupportedError,
)
from . import topology as top
from .mesh import (
    _dcn_factorization, box_device, build_mesh, controller_coords_of, process_boxes,
    process_grid, resolve_device, resolve_pool,
)
from .topology import GlobalGrid, NDIMS, dims_create, set_global_grid

__all__ = ["init_global_grid", "finalize_global_grid", "select_device"]

DEVICE_TYPE_NONE = "none"
DEVICE_TYPE_AUTO = "auto"
SUPPORTED_DEVICE_TYPES = ("gpu", "cpu")


def init_global_grid(
    nx: int, ny: int = 1, nz: int = 1, *,
    dimx: int = 0, dimy: int = 0, dimz: int = 0,
    periodx: int = 0, periody: int = 0, periodz: int = 0,
    overlaps=(2, 2, 2),
    halowidths=None,
    disp: int = 1,
    reorder: int = 1,
    nranks: int | None = None,
    devices=None,
    init_dist: bool | None = None,
    device_type: str | None = None,
    select_device: bool = True,
    quiet: bool = False,
):
    """Initialize the Cartesian grid of ranks, implicitly defining the
    global grid.

    ``nx, ny, nz`` are the size of each LOCAL block; ``dimx/y/z`` fix ranks
    per dimension (0 = choose with `dims_create`); ``periodx/y/z`` make
    dimensions periodic; ``overlaps``/``halowidths``/``disp`` as in the JAX
    package. ``reorder`` is accepted for API parity; ranks are laid out over
    processes in plain order, or along ``IGG_TPU_DCN_AXES``
    (`parallel.mesh`).

    Port-specific:

    - ``devices``: the rank pool as a device list, as the JAX package takes
      it: ``torch.device``s or strings torch takes, entry ``r`` holding rank
      ``r``. Its length fills the dims left at 0 (the largest usable part
      of it, with a warning, where it is no multiple of the fixed dims); a
      grid larger than the list raises. The entries decide the device:
      ``["cpu"] * 8`` is a CPU grid, ``[torch.device("cuda", 0)] * 8`` a
      grid on that card. A process holds its box as one tensor on one
      device, so the entries of its ranks must all name it (else
      `NotSupportedError`) and, with ``select_device``, name the card it
      binds. Across processes the list is the whole grid's pool, a
      multiple of the process count long.
    - ``nranks``: the number of ranks when some dims are left at 0, without
      a device list (the JAX package uses its device count there); a
      multiple of the process count. Default: the process count, or
      ``len(devices)``.
    - ``init_dist``: start the `torch.distributed` process group (from
      ``torchrun``'s environment: ``MASTER_ADDR``, ``MASTER_PORT``,
      ``RANK``, ``WORLD_SIZE``), with NCCL on a CUDA grid and gloo on the
      CPU. ``None`` starts it where ``MASTER_ADDR`` and ``WORLD_SIZE`` are
      set and no group is up; ``False`` uses a group the caller started, if
      any. `finalize_global_grid(finalize_dist=True)` ends the group.
    - ``device_type``: "gpu" (the default without ``devices``; "auto" means
      the same) puts every field on the current CUDA device and raises
      `NotLoadedError` when CUDA is absent; "cpu" (or "none") runs on the
      CPU. With ``devices`` the entries decide, and a ``device_type`` that
      contradicts them raises.

    Returns ``(me, dims, nprocs, coords, mesh)``.
    """
    if top.grid_is_initialized():
        raise AlreadyInitializedError("The global grid has already been initialized.")

    cfg = read_env_config()

    nxyz = np.array([nx, ny, nz], dtype=np.int64)
    dims = np.array([dimx, dimy, dimz], dtype=np.int64)
    periods = np.array([periodx, periody, periodz], dtype=np.int64)
    overlaps = np.array(list(overlaps), dtype=np.int64)
    if overlaps.shape != (NDIMS,):
        raise InvalidArgumentError("overlaps must have 3 entries.")
    if halowidths is None:
        halowidths = np.maximum(1, overlaps // 2)
    halowidths = np.array(list(halowidths), dtype=np.int64)
    if halowidths.shape != (NDIMS,):
        raise InvalidArgumentError("halowidths must have 3 entries.")

    if device_type not in (None, DEVICE_TYPE_NONE, DEVICE_TYPE_AUTO) + SUPPORTED_DEVICE_TYPES:
        raise InvalidArgumentError(
            f"Argument `device_type`: invalid value obtained ({device_type}). Valid values "
            f"are: {', '.join(SUPPORTED_DEVICE_TYPES + (DEVICE_TYPE_NONE, DEVICE_TYPE_AUTO))}"
        )
    if np.any(nxyz < 1):
        raise InvalidArgumentError("Invalid arguments: nx, ny, and nz cannot be less than 1.")
    if np.any(dims < 0):
        raise InvalidArgumentError("Invalid arguments: dimx, dimy, and dimz cannot be negative.")
    if np.any(~np.isin(periods, (0, 1))):
        raise InvalidArgumentError(
            "Invalid arguments: periodx, periody, and periodz must be either 0 or 1."
        )
    if np.any(halowidths < 1):
        raise InvalidArgumentError("Invalid arguments: halowidths cannot be less than 1.")
    if nx == 1:
        raise InvalidArgumentError("Invalid arguments: nx can never be 1.")
    if ny == 1 and nz > 1:
        raise InvalidArgumentError("Invalid arguments: ny cannot be 1 if nz is greater than 1.")
    if np.any((nxyz == 1) & (dims > 1)):
        raise IncoherentArgumentError(
            "Incoherent arguments: if nx, ny, or nz is 1, then the corresponding dimx, dimy "
            "or dimz must not be set (or set 0 or 1)."
        )
    if np.any((nxyz < 2 * overlaps - 1) & (periods > 0)):
        raise IncoherentArgumentError(
            "Incoherent arguments: if nx, ny, or nz is smaller than 2*overlaps[d]-1, then the "
            "corresponding periodx, periody or periodz must not be set (or set 0)."
        )
    if np.any((overlaps > 0) & (halowidths > overlaps // 2)):
        raise IncoherentArgumentError(
            "Incoherent arguments: if overlap is greater than 0, then halowidth cannot be "
            "greater than overlap//2, in each dimension."
        )
    dims[(nxyz == 1) & (dims == 0)] = 1

    pool = None
    if devices is None:
        device, resolved_type = resolve_device(device_type or "gpu")
    else:
        pool, resolved_type = resolve_pool(devices, device_type)
        if nranks is not None and int(nranks) != len(pool):
            raise IncoherentArgumentError(
                f"nranks={nranks} contradicts the {len(pool)} entries of devices=; "
                "pass one of the two.")
        nranks = len(pool)
        import torch

        # the type alone until this process's box picks its entry (`_pool_device`)
        device = torch.device("cpu" if resolved_type == "cpu" else "cuda")
    _init_dist(init_dist, resolved_type)
    from .transport import transport_for

    transport = transport_for(device)
    world = transport.world
    if nranks is None:
        nranks = world
    if int(nranks) < 1:
        raise InvalidArgumentError(f"nranks must be >= 1; got {nranks}.")
    if pool is not None and len(pool) % world:
        raise IncoherentArgumentError(
            f"devices= holds {len(pool)} entries, not a multiple of the {world} processes: "
            "across processes it is the whole grid's pool.")

    if np.all(dims > 0):
        nprocs = int(np.prod(dims))
    else:
        nprocs = int(nranks)
        fixed = int(np.prod(dims[dims > 0])) if np.any(dims > 0) else 1
        if fixed > nprocs:
            raise InvalidArgumentError(
                f"The fixed dims require {fixed} shard(s) but only {nprocs} device(s) are "
                "available; reduce dimx/dimy/dimz or pass a larger device pool via devices=."
                if pool is not None else
                f"The fixed dims require {fixed} rank(s) but nranks is "
                f"{nprocs}; reduce dimx/dimy/dimz or raise nranks.")
        if nprocs % fixed != 0:
            import warnings

            new = (nprocs // fixed) * fixed
            warnings.warn(
                f"Device pool of {nprocs} is not a multiple of the fixed dims product "
                f"({fixed}); using {new} device(s) — {nprocs - new} idle. Adjust "
                "dimx/dimy/dimz or pass devices= to use the full pool."
                if pool is not None else
                f"nranks={nprocs} is not a multiple of the fixed dims "
                f"product ({fixed}); using {new} rank(s).")
            nprocs = new
    dims = dims_create(nprocs, dims)
    if pool is not None and int(np.prod(dims)) > len(pool):
        raise InvalidArgumentError(
            f"Grid of {int(np.prod(dims))} shards exceeds the {len(pool)} available device(s).")
    if nprocs % world:
        raise IncoherentArgumentError(
            f"The grid's {nprocs} rank(s) are not a multiple of the {world} processes.")

    mesh = build_mesh(dims)
    me = transport.rank
    box, firsts = process_boxes(dims, world, cfg.dcn_axes if world > 1 else ())
    coords = controller_coords_of(firsts, me)
    if pool is not None:
        device = transport.device = _pool_device(
            pool, mesh, box, firsts[me], resolved_type, select_device, transport)
    if world > 1 and cfg.dcn_axes:
        dcn_granules, _ = _dcn_factorization(dims, cfg.dcn_axes, world)
    else:
        dcn_granules = tuple(int(g) for g in cfg.dcn_granules)
        for d in range(NDIMS):
            if dcn_granules[d] > 1 and int(dims[d]) % dcn_granules[d]:
                raise IncoherentArgumentError(
                    f"IGG_TPU_DCN_GRANULES: {dcn_granules[d]} granule(s) along "
                    f"{'xyz'[d]} do not divide the axis' {int(dims[d])} shard(s).")
    nxyz_g = dims * (nxyz - overlaps) + overlaps * (periods == 0)

    gg = GlobalGrid(
        nxyz_g=nxyz_g, nxyz=nxyz, dims=dims, overlaps=overlaps,
        halowidths=halowidths, nprocs=nprocs, me=me, coords=coords,
        periods=periods, disp=int(disp), reorder=int(reorder), mesh=mesh,
        device_type=resolved_type, device=device,
        # CUDA kernel tier: on unless IGG_USE_PALLAS[_DIM*]=0. On the CPU
        # the kernels' wrappers run their plain PyTorch versions.
        use_pallas=np.array([True if v is None else v for v in cfg.use_pallas],
                            dtype=bool),
        quiet=bool(quiet), box=box, procs=process_grid(dims, box, firsts),
        transport=transport, dcn_axes=tuple(cfg.dcn_axes), dcn_granules=dcn_granules,
    )
    set_global_grid(gg)

    if not quiet and me == 0:
        print(
            f"Global grid: {int(nxyz_g[0])}x{int(nxyz_g[1])}x{int(nxyz_g[2])} "
            f"(nprocs: {nprocs}, dims: {int(dims[0])}x{int(dims[1])}x{int(dims[2])}; "
            f"device support: {resolved_type})"
        )

    if select_device and resolved_type == "gpu" and pool is None:
        gg.device = transport.device = _select_device()

    from ..utils.timing import init_timing_functions

    init_timing_functions()
    return me, dims.copy(), nprocs, coords.copy(), mesh


def _pool_device(pool, mesh, box, first, resolved_type, select_device, transport):
    """This process's device from the pool entries of its box
    (`mesh.box_device`), checked on every process together so that all
    raise or none: a CUDA entry must exist on this host and, with
    ``select_device``, be the card `_select_device` binds."""
    import torch

    problem, device = None, None
    try:
        device = box_device(pool, mesh, box, first)
        if resolved_type == "gpu":
            if not torch.cuda.is_available():
                raise NotLoadedError(
                    "devices= names CUDA devices, but CUDA is not available. Pass CPU "
                    "devices to run on the CPU.")
            if device.index >= torch.cuda.device_count():
                raise InvalidArgumentError(
                    f"devices= names {device}, but this host has "
                    f"{torch.cuda.device_count()} CUDA device(s).")
    except (NotSupportedError, NotLoadedError, InvalidArgumentError) as e:
        problem = e
    if problem is None and resolved_type == "gpu" and select_device:
        bound = _select_device(transport)
        if bound != device:
            problem = IncoherentArgumentError(
                f"devices= gives this process {device}, but select_device binds {bound} "
                "(its node-local rank); list the bound card or pass select_device=False.")
    problems = transport.all_gather_object(problem) if transport.world > 1 else [problem]
    for p, got in enumerate(problems):
        if got is not None:
            raise got if transport.world == 1 else type(got)(f"process {p}: {got}")
    return device


def _init_dist(init_dist, resolved_type) -> None:
    """Start the process group where ``init_dist`` asks (the JAX package's
    rule for `jax.distributed`)."""
    import torch.distributed as dist

    up = dist.is_available() and dist.is_initialized()
    if init_dist is None:
        init_dist = bool(os.environ.get("MASTER_ADDR") and os.environ.get("WORLD_SIZE")) \
            and not up
    if not init_dist:
        return
    if up:
        raise AlreadyInitializedError(
            "torch.distributed is already initialized. Pass init_dist=False.")
    try:
        dist.init_process_group(backend="nccl" if resolved_type == "gpu" else "gloo")
    except (RuntimeError, ValueError) as e:
        raise AlreadyInitializedError(
            f"torch.distributed failed to initialize: {e}. If the process group was "
            "already set up, pass init_dist=False.") from e


def finalize_global_grid(*, finalize_dist: bool = False) -> None:
    """Finalize the global grid: reset the singleton and the chronometer;
    with ``finalize_dist``, end the process group."""
    top.check_initialized()
    from ..utils import timing

    gg = top.global_grid()
    timing._t0 = None
    if finalize_dist:
        gg.transport.shutdown()
    set_global_grid(None)


def node_local_rank(transport=None):
    """(node-local rank, processes on this host, CUDA devices on this host):
    the analog of the reference's shared-memory communicator split.
    ``transport``: the process group's (default: the grid's).

    COLLECTIVE where a process group is up: every process must call it.
    Processes are grouped by host name (an all-gather); the rank is this
    process's index among its host's processes in process order. One
    process returns ``(0, 1, local device count)`` without a collective."""
    import hashlib
    import socket

    import torch

    n_local = torch.cuda.device_count()
    tr = transport if transport is not None else top.global_grid().transport
    if tr.world == 1:
        return 0, 1, n_local
    h = hashlib.sha1(socket.gethostname().encode()).hexdigest()
    rows = tr.all_gather_object((h, n_local))
    same = [i for i, r in enumerate(rows) if r[0] == h]
    return same.index(tr.rank), len(same), int(rows[same[0]][1])


def _select_device(transport=None):
    """Bind this process to the CUDA device of its node-local rank
    (`torch.cuda.set_device`) and return that device. COLLECTIVE where a
    process group is up (`node_local_rank`)."""
    import torch

    me_l, n_procs_node, dev_on_node = node_local_rank(transport)
    if n_procs_node > dev_on_node or me_l >= dev_on_node:
        raise IncoherentArgumentError(
            f"This host runs {n_procs_node} process(es) but only {dev_on_node} CUDA "
            "device(s): it is not possible to run more processes per node than there "
            "are devices on it."
        )
    torch.cuda.set_device(me_l)
    return torch.device("cuda", me_l)


def select_device() -> int:
    """Bind and return the device index of this process (the CPU grid
    reports 0)."""
    top.check_initialized()
    gg = top.global_grid()
    if gg.device_type != "gpu":
        return 0
    gg.device = gg.transport.device = _select_device()
    return gg.device.index
