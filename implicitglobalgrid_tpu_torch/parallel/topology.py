"""Cartesian topology and the GlobalGrid singleton.

Counterpart of `implicitglobalgrid_tpu/parallel/topology.py`. The global grid
is never allocated; it exists only through the implicit-global-grid formula

    nxyz_g = dims * (nxyz - overlaps) + overlaps * (periods == 0)

Each process owns a BOX of ranks of the Cartesian grid (`parallel.mesh.
process_boxes`): their blocks live in one stacked tensor of shape ``box *
local_shape`` on the process's ``torch.device``. A halo "send/recv" between
two ranks of one box is a tensor copy between block views (`ops.halo`); one
between boxes goes through the grid's transport (`parallel.transport`). One
process (the virtual mesh) owns the whole grid: ``box == dims``.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any

import numpy as np

from ..utils.exceptions import (
    IncoherentArgumentError,
    InvalidArgumentError,
    ModuleInternalError,
    NotInitializedError,
)

__all__ = [
    "NDIMS", "NNEIGHBORS_PER_DIM", "PROC_NULL", "AXIS_NAMES",
    "GlobalGrid", "global_grid", "set_global_grid", "grid_is_initialized",
    "check_initialized", "get_global_grid", "grid_epoch",
    "swap_global_grid", "retain_epoch", "release_epoch", "live_epochs",
    "dims_create", "cart_rank", "cart_coords", "cart_shift", "neighbors_table",
    "ol", "axis_perm_pairs", "crosses",
    "StagedDirection", "StagedWireLayout", "staged_wire_layout",
]

NDIMS = 3
NNEIGHBORS_PER_DIM = 2
PROC_NULL = -1
AXIS_NAMES = ("gx", "gy", "gz")


@dataclass
class GlobalGrid:
    """Singleton grid state. Vectors are numpy arrays and the dataclass is
    mutable on purpose (tests simulate topologies by editing it)."""
    nxyz_g: np.ndarray          # implicit global grid size (3,)
    nxyz: np.ndarray            # local block size (3,)
    dims: np.ndarray            # ranks per dimension (3,), the whole grid's
    overlaps: np.ndarray        # (3,)
    halowidths: np.ndarray      # (3,)
    nprocs: int                 # number of ranks = prod(dims)
    me: int                     # this process's rank in the process group (0 alone)
    coords: np.ndarray          # coords of this process's first rank
    periods: np.ndarray         # (3,) of 0/1
    disp: int
    reorder: int
    mesh: Any                   # int ndarray of ranks, shape dims (parallel.mesh)
    device_type: str            # "gpu" | "cpu"
    device: Any                 # torch.device every field of the grid lives on
    use_pallas: np.ndarray      # (3,) bool — CUDA kernel tier per dim
    quiet: bool
    epoch: int = 0              # bumped at every init
    box: Any = None             # (3,) ranks per dim this process owns (None: dims)
    procs: Any = None           # process rank of each box position, shape dims // box
    transport: Any = None       # parallel.transport: InProcess or Dist
    dcn_axes: tuple = ()        # grid axes the processes split (IGG_TPU_DCN_AXES)
    dcn_granules: tuple = (1, 1, 1)  # granules (processes) per dim

    def __post_init__(self):
        if self.box is None:
            self.box = np.array(self.dims, dtype=np.int64).copy()
        if self.procs is None:
            self.procs = np.zeros((1, 1, 1), dtype=np.int64)

    def __iter__(self):  # me, dims, nprocs, coords, mesh unpacking
        return iter((self.me, self.dims, self.nprocs, self.coords, self.mesh))


_global_grid: GlobalGrid | None = None
_epoch_counter: int = 0


def global_grid() -> GlobalGrid:
    check_initialized()
    return _global_grid


def set_global_grid(gg: GlobalGrid | None) -> None:
    global _global_grid, _epoch_counter
    if gg is not None:
        _epoch_counter += 1
        gg.epoch = _epoch_counter
    _global_grid = gg


def grid_is_initialized() -> bool:
    return _global_grid is not None and _global_grid.nprocs > 0


def check_initialized() -> None:
    if not grid_is_initialized():
        raise NotInitializedError(
            "No function of the module can be called before init_global_grid() "
            "or after finalize_global_grid()."
        )


def get_global_grid() -> GlobalGrid:
    """Return a deep copy of the global grid."""
    check_initialized()
    return copy.deepcopy(_global_grid)


def grid_epoch() -> int:
    check_initialized()
    return _global_grid.epoch


# ---------------------------------------------------------------------------
# Grid multiplexing (context switches between live grids)
# ---------------------------------------------------------------------------
# An init assigns a FRESH epoch (`set_global_grid` bumps the counter), which
# is what retires the epoch-keyed caches after a re-init. Code that keeps
# SEVERAL live grids over one device (`telemetry.tune_config` swaps the
# caller's grid aside while it builds its candidates') switches between them
# with `swap_global_grid`; each keeps the epoch it was born with. The caches
# learn which epochs are live via `retain_epoch`/`live_epochs` and evict
# only the dead ones.

_retained_epochs: set = set()


def swap_global_grid(gg: GlobalGrid | None) -> GlobalGrid | None:
    """Make ``gg`` the current grid WITHOUT assigning a new epoch, and
    return the previously current grid (or None). The swapped-in grid keeps
    its epoch, so the epoch-keyed caches keep serving it. Ordinary code
    wants `init_global_grid` / `finalize_global_grid`; only hold several
    grids over the SAME device and process group."""
    global _global_grid
    old = _global_grid
    _global_grid = gg
    return old


def retain_epoch(epoch: int) -> None:
    """Mark ``epoch`` as belonging to a live (swapped-out) grid: the
    epoch-keyed caches do not evict its entries while retained."""
    _retained_epochs.add(int(epoch))


def release_epoch(epoch: int) -> None:
    """Drop the retention of ``epoch`` (no-op if not retained); its cache
    entries become evictable at the next miss."""
    _retained_epochs.discard(int(epoch))


def live_epochs() -> frozenset:
    """Epochs whose cache entries must survive: the current grid's (if any)
    plus every retained one."""
    live = set(_retained_epochs)
    if _global_grid is not None:
        live.add(_global_grid.epoch)
    return frozenset(live)


# ---------------------------------------------------------------------------
# Topology math (analog of MPI_Dims_create / Cart_create / Cart_shift)
# ---------------------------------------------------------------------------

def dims_create(nprocs: int, dims) -> np.ndarray:
    """Fill the zero entries of ``dims`` with a balanced factorization of
    ``nprocs`` (the `MPI_Dims_create` analog): fixed entries are kept, the
    remaining factor is split as evenly as possible, larger factors first."""
    dims = np.asarray(dims, dtype=np.int64).copy()
    if dims.shape != (NDIMS,):
        raise InvalidArgumentError(f"dims must have {NDIMS} entries, got {dims.shape}.")
    if np.any(dims < 0):
        raise InvalidArgumentError("Invalid arguments: dimx, dimy, and dimz cannot be negative.")
    fixed = int(np.prod(dims[dims > 0])) if np.any(dims > 0) else 1
    if nprocs % fixed != 0:
        raise IncoherentArgumentError(
            f"nprocs ({nprocs}) is not divisible by the product of the fixed dims ({fixed})."
        )
    rem = nprocs // fixed
    free = [i for i in range(NDIMS) if dims[i] == 0]
    if not free:
        if rem != 1:
            raise IncoherentArgumentError(
                f"prod(dims) ({fixed}) does not equal nprocs ({nprocs})."
            )
        return dims
    best = None
    k = len(free)
    divs = []
    f = 1
    while f * f <= rem:
        if rem % f == 0:
            divs.append(f)
            if f != rem // f:
                divs.append(rem // f)
        f += 1
    divs.sort(reverse=True)

    def search(remaining, max_factor, acc):
        nonlocal best
        if len(acc) == k - 1:
            if remaining <= max_factor:
                cand = tuple(acc + [remaining])
                score = (max(cand) - min(cand), max(cand))
                if best is None or score < best[0]:
                    best = (score, cand)
            return
        for f in divs:
            if f <= max_factor and remaining % f == 0:
                search(remaining // f, f, acc + [f])

    search(rem, rem, [])
    if best is None:  # pragma: no cover - rem>=1 always factorizable
        raise ModuleInternalError("dims_create failed to factorize.")
    for i, f in zip(free, best[1]):
        dims[i] = f
    return dims


def cart_rank(coords, dims) -> int:
    """Row-major Cartesian rank (MPI cart order)."""
    c, d = np.asarray(coords), np.asarray(dims)
    return int((c[0] * d[1] + c[1]) * d[2] + c[2])


def cart_coords(rank: int, dims) -> np.ndarray:
    d = np.asarray(dims)
    cz = rank % d[2]
    cy = (rank // d[2]) % d[1]
    cx = rank // (d[1] * d[2])
    return np.array([cx, cy, cz], dtype=np.int64)


def cart_shift(coords, dim: int, disp: int, dims, periods):
    """Left/right neighbor ranks of ``coords`` along ``dim`` (the
    `MPI.Cart_shift` analog), PROC_NULL where no neighbor exists."""
    coords = np.asarray(coords)
    dims = np.asarray(dims)
    out = []
    for sgn in (-1, +1):
        c = coords.copy()
        t = c[dim] + sgn * disp
        if periods[dim]:
            c[dim] = t % dims[dim]
            out.append(cart_rank(c, dims))
        elif 0 <= t < dims[dim]:
            c[dim] = t
            out.append(cart_rank(c, dims))
        else:
            out.append(PROC_NULL)
    return tuple(out)


def neighbors_table(coords, dims=None, periods=None, disp=None) -> np.ndarray:
    """2x3 neighbor table of the rank at ``coords``: row 0 = left
    neighbors, row 1 = right."""
    if dims is None:
        gg = global_grid()
        dims, periods, disp = gg.dims, gg.periods, gg.disp
    tbl = np.full((NNEIGHBORS_PER_DIM, NDIMS), PROC_NULL, dtype=np.int64)
    for d in range(NDIMS):
        tbl[0, d], tbl[1, d] = cart_shift(coords, d, disp, dims, periods)
    return tbl


def axis_perm_pairs(D: int, periodic, disp: int):
    """The (forward, backward) (source, target) block pairs of an
    exchanging axis: wrap-around when periodic, truncated chains (PROC_NULL
    edges) when not."""
    D, disp = int(D), int(disp)
    if periodic:
        return ([(i, (i + disp) % D) for i in range(D)],
                [(i, (i - disp) % D) for i in range(D)])
    if disp >= D:
        return [], []
    return ([(i, i + disp) for i in range(D - disp)],
            [(i, i - disp) for i in range(disp, D)])


def crosses(gg, dim: int) -> bool:
    """Whether ``dim`` is split across processes, so that its halo exchange
    goes through the transport at the box's edges."""
    return dim < NDIMS and int(gg.procs.shape[dim]) > 1


# ---------------------------------------------------------------------------
# Topology-staged wire layout (the JAX package's hierarchical exchange routes)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class StagedDirection:
    """One direction's routes of a staged axis exchange. ``axis_pairs``
    are the flat single-axis pairs this direction would ship unstaged;
    they partition into ``intra_pairs`` (same granule — stay a flat
    single-axis ppermute) and ``cross_pairs`` (granule-crossing — replaced
    by the gather/dcn/scatter pipeline). All ``*_lin``/``gather``/``dcn``/
    ``scatter`` pair lists are LINEARIZED over the full mesh (row-major
    over ``dims``, the index space of a ppermute over the whole axis-name
    tuple and of a compiled collective-permute's source_target_pairs)."""

    name: str            # "+" (data moves toward +dim) or "-"
    axis_pairs: tuple    # flat single-axis pairs, axis index space
    intra_pairs: tuple   # same-granule subset, axis index space
    cross_pairs: tuple   # granule-crossing subset, axis index space
    intra_pairs_lin: tuple
    gather_pairs: tuple  # gather_dim k -> k-1 shifts on sending planes
    dcn_pairs: tuple     # leader -> leader across the granule boundary
    scatter_pairs: tuple  # gather_dim k -> k+1 shifts on receiving planes
    cross_sources: tuple  # axis coords that send across a boundary
    cross_targets: tuple  # axis coords that receive across a boundary


@dataclass(frozen=True)
class StagedWireLayout:
    """The staged exchange's complete route table for one mesh axis:
    which single-axis pairs cross a DCN granule boundary, which ICI axis
    the per-granule leaders fold over (``gather_dim``, fold ``fold``),
    and the exact linearized pair set of every stage in both directions.
    Derived once from the grid geometry by `staged_wire_layout` and read
    by the grouping and the static plan (`ops.halo`)."""

    dim: int             # the staged (DCN-crossing) grid dimension
    gather_dim: int      # the perpendicular pure-ICI dim leaders fold over
    fold: int            # dims[gather_dim] — the DCN message-count fold
    granules: int        # DCN granules along `dim`
    block: int           # devices per granule along `dim`
    dims: tuple          # full mesh shape (linearization basis)
    directions: tuple    # (StagedDirection, ...) — "+" then "-"

    @property
    def dcn_pair_count(self) -> int:
        return sum(len(d.dcn_pairs) for d in self.directions)


def staged_wire_layout(gg, dim: int):
    """Derive the staged wire layout of grid dimension ``dim`` from the
    grid's granule metadata, or ``None`` when staging is degenerate there
    (single granule, granule count not dividing the axis, no perpendicular
    pure-ICI axis with extent >= 2, or no granule-crossing pair), as the
    JAX package decides. The granules are the grid's ``dcn_granules``
    (``IGG_TPU_DCN_GRANULES``, or the processes along the axes of
    ``IGG_TPU_DCN_AXES``)."""
    import itertools

    dims = tuple(int(v) for v in gg.dims)
    dim = int(dim)
    D = dims[dim]
    granules = tuple(int(v) for v in getattr(gg, "dcn_granules", (1, 1, 1)))
    G = granules[dim] if dim < len(granules) else 1
    if D < 2 or G < 2 or D % G != 0:
        return None
    # the gather axis: the largest perpendicular pure-ICI axis
    cands = [g for g in range(NDIMS)
             if g != dim and granules[g] == 1 and dims[g] > 1]
    if not cands:
        return None
    gather_dim = max(cands, key=lambda g: (dims[g], -g))
    F = dims[gather_dim]
    if F < 2:
        return None
    B = D // G
    periodic = bool(gg.periods[dim])
    disp = int(gg.disp)
    perm_p, perm_m = axis_perm_pairs(D, periodic, disp)
    other_dims = [d for d in range(NDIMS) if d not in (dim, gather_dim)]
    other_ranges = [range(dims[d]) for d in other_dims]

    def lin(axis_c, gather_c, other_c):
        c = [0] * NDIMS
        c[dim] = axis_c
        c[gather_dim] = gather_c
        for d, v in zip(other_dims, other_c):
            c[d] = v
        return cart_rank(c, dims)

    directions = []
    for name, pairs in (("+", perm_p), ("-", perm_m)):
        intra = tuple((s, t) for s, t in pairs if s // B == t // B)
        cross = tuple((s, t) for s, t in pairs if s // B != t // B)
        srcs = tuple(sorted({s for s, _ in cross}))
        tgts = tuple(sorted({t for _, t in cross}))
        intra_lin, gather, dcn, scatter = [], [], [], []
        for oc in itertools.product(*other_ranges):
            for s, t in intra:
                for k in range(F):
                    intra_lin.append((lin(s, k, oc), lin(t, k, oc)))
            for s in srcs:
                for k in range(1, F):
                    gather.append((lin(s, k, oc), lin(s, k - 1, oc)))
            for s, t in cross:
                dcn.append((lin(s, 0, oc), lin(t, 0, oc)))
            for t in tgts:
                for k in range(F - 1):
                    scatter.append((lin(t, k, oc), lin(t, k + 1, oc)))
        directions.append(StagedDirection(
            name=name, axis_pairs=tuple(pairs), intra_pairs=intra,
            cross_pairs=cross, intra_pairs_lin=tuple(intra_lin),
            gather_pairs=tuple(gather), dcn_pairs=tuple(dcn),
            scatter_pairs=tuple(scatter), cross_sources=srcs,
            cross_targets=tgts))
    if not any(d.cross_pairs for d in directions):
        return None
    return StagedWireLayout(dim=dim, gather_dim=gather_dim, fold=F,
                            granules=G, block=B, dims=dims,
                            directions=tuple(directions))


def ol(dim: int, local_shape=None) -> int:
    """Overlap of a field along ``dim`` (0-based); a staggered field's
    overlap grows by its size difference (``overlaps[dim] + (size(A, dim) -
    nxyz[dim])``)."""
    gg = global_grid()
    if local_shape is None:
        return int(gg.overlaps[dim])
    size_d = local_shape[dim] if dim < len(local_shape) else 1
    return int(gg.overlaps[dim] + (size_d - gg.nxyz[dim]))
