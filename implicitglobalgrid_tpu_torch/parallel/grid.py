"""Grid lifecycle: `init_global_grid`, `finalize_global_grid`, `select_device`.

Counterpart of `implicitglobalgrid_tpu/parallel/grid.py`, with every argument
check of its `init_global_grid` (same messages). The JAX package takes its
ranks from the devices of a JAX mesh; here the ranks are virtual
(`parallel.mesh`): their number comes from ``dimx*dimy*dimz`` or, where dims
are left at 0, from ``nranks`` through `dims_create`.
"""

from __future__ import annotations

import os

import numpy as np

from ..utils.config import read_env_config
from ..utils.exceptions import (
    AlreadyInitializedError, IncoherentArgumentError, InvalidArgumentError,
)
from . import topology as top
from .mesh import build_mesh, controller_coords_of, resolve_device
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
    nranks: int = 1,
    device_type: str = "gpu",
    select_device: bool = True,
    quiet: bool = False,
):
    """Initialize the Cartesian grid of virtual ranks, implicitly defining
    the global grid.

    ``nx, ny, nz`` are the size of each LOCAL block; ``dimx/y/z`` fix ranks
    per dimension (0 = choose with `dims_create`); ``periodx/y/z`` make
    dimensions periodic; ``overlaps``/``halowidths``/``disp`` as in the JAX
    package. ``reorder`` is accepted for API parity; the virtual mesh is
    always the identity layout.

    Port-specific:

    - ``nranks``: the number of virtual ranks when some dims are left at 0
      (the JAX package uses its device count there).
    - ``device_type``: "gpu" (the default; "auto" means the same) puts every
      field on the current CUDA device and raises `NotLoadedError` when
      CUDA is absent; "cpu" (or "none") runs on the CPU.

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

    if device_type not in (DEVICE_TYPE_NONE, DEVICE_TYPE_AUTO) + SUPPORTED_DEVICE_TYPES:
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

    if int(nranks) < 1:
        raise InvalidArgumentError(f"nranks must be >= 1; got {nranks}.")
    device, resolved_type = resolve_device(device_type)

    if np.all(dims > 0):
        nprocs = int(np.prod(dims))
    else:
        nprocs = int(nranks)
        fixed = int(np.prod(dims[dims > 0])) if np.any(dims > 0) else 1
        if fixed > nprocs:
            raise InvalidArgumentError(
                f"The fixed dims require {fixed} rank(s) but nranks is "
                f"{nprocs}; reduce dimx/dimy/dimz or raise nranks."
            )
        if nprocs % fixed != 0:
            import warnings

            new = (nprocs // fixed) * fixed
            warnings.warn(
                f"nranks={nprocs} is not a multiple of the fixed dims "
                f"product ({fixed}); using {new} rank(s).")
            nprocs = new
    dims = dims_create(nprocs, dims)

    mesh = build_mesh(dims)
    me = 0  # one process holds every virtual rank
    coords = controller_coords_of(mesh, me)
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
        quiet=bool(quiet),
    )
    set_global_grid(gg)

    if not quiet and me == 0:
        print(
            f"Global grid: {int(nxyz_g[0])}x{int(nxyz_g[1])}x{int(nxyz_g[2])} "
            f"(nprocs: {nprocs}, dims: {int(dims[0])}x{int(dims[1])}x{int(dims[2])}; "
            f"device support: {resolved_type})"
        )

    if select_device and resolved_type == "gpu":
        gg.device = _select_device()

    from ..utils.timing import init_timing_functions

    init_timing_functions()
    return me, dims.copy(), nprocs, coords.copy(), mesh


def finalize_global_grid() -> None:
    """Finalize the global grid: reset the singleton and the chronometer."""
    top.check_initialized()
    from ..utils import timing

    timing._t0 = None
    set_global_grid(None)


def node_local_rank():
    """(node-local rank, processes on this host, CUDA devices on this
    host). One process holds every virtual rank, so the rank is
    ``LOCAL_RANK`` when a launcher sets it, else 0."""
    import torch

    return int(os.environ.get("LOCAL_RANK", 0)), 1, torch.cuda.device_count()


def _select_device():
    """Bind this process to the CUDA device of its node-local rank
    (`torch.cuda.set_device`) and return that device."""
    import torch

    me_l, n_procs_node, dev_on_node = node_local_rank()
    if n_procs_node > dev_on_node or me_l >= dev_on_node:
        raise IncoherentArgumentError(
            f"Node-local rank {me_l} of {n_procs_node} process(es) has no "
            f"CUDA device: this host has {dev_on_node}."
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
    gg.device = _select_device()
    return gg.device.index
