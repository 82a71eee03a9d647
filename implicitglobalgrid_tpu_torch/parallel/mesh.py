"""The mesh: how ranks are laid out over processes and which device holds
them.

Counterpart of `implicitglobalgrid_tpu/parallel/mesh.py`. Where the JAX
package arranges devices into a `jax.sharding.Mesh`, the port gives each
process a BOX of ranks (`process_boxes`): the ranks of the JAX package's
layout for the same process count, so each process's blocks are a view of
one stacked tensor on its device. One process holds every rank (the
virtual mesh), so a 2x2x2 grid runs on one GPU or on the CPU.

- Plain order (the JAX package's ``reorder=0`` layout): process ``p`` owns
  ranks ``[p*k, (p+1)*k)`` in Cartesian order, ``k = nprocs / world``; the
  chunk must be a box.
- ``IGG_TPU_DCN_AXES``: the processes split the named axes by
  `_dcn_factorization` (the JAX package's multi-slice layout); process ``g``
  owns the box at ``unravel(g, dcn_shape) * ici_shape``.

An explicit device list (``init_global_grid(devices=)``, `resolve_pool`) is
the rank pool, as the JAX package's device list is: entry ``r`` holds rank
``r``. A process holds its box as one stacked tensor on one device, so the
entries of its box must all name that device (`box_device`).
"""

from __future__ import annotations

import numpy as np

from ..utils.exceptions import (
    IncoherentArgumentError, InvalidArgumentError, NotLoadedError, NotSupportedError,
)
from .topology import NDIMS, cart_coords

__all__ = ["build_mesh", "resolve_device", "resolve_pool", "box_device",
           "controller_coords_of", "process_boxes", "process_grid"]

# why a process's ranks share one device: every kernel route reads a box as
# one stacked tensor (`ops.fields.block_view`)
_ONE_DEVICE = ("a process holds its box of blocks as one stacked tensor on one device "
               "(ops.fields.block_view), and every kernel route reads it so; give each "
               "process's ranks that process's device.")


def resolve_device(device_type: str):
    """``(torch.device, resolved_type)`` for ``device_type``: "gpu" (and
    "auto") is the current CUDA device and raises `NotLoadedError` without
    one; "cpu" (and "none") is the CPU."""
    import torch

    if device_type in ("cpu", "none"):
        return torch.device("cpu"), "cpu"
    if not torch.cuda.is_available():
        raise NotLoadedError(
            f"device_type {device_type!r}: CUDA is not available. Pass "
            "device_type='cpu' to run on the CPU.")
    return torch.device("cuda", torch.cuda.current_device()), "gpu"


def resolve_pool(devices, device_type=None):
    """``(pool, resolved_type)`` of an explicit device list: each entry a
    ``torch.device`` or a string torch takes ("cpu", "cuda:0"). The entries'
    type decides the grid's ("gpu" for CUDA, "cpu"); a CUDA entry without an
    index names the current CUDA device where CUDA is available. Raises
    `InvalidArgumentError` for an empty list or an entry torch refuses,
    `NotSupportedError` for a list that mixes CUDA and CPU or names another
    device type, and `IncoherentArgumentError` where an explicit
    ``device_type`` ("gpu", "cpu", "none") contradicts the entries."""
    import torch

    try:
        pool = [d if isinstance(d, torch.device) else torch.device(d) for d in devices]
    except (RuntimeError, TypeError, ValueError) as e:
        raise InvalidArgumentError(f"devices=: an entry is no torch device ({e}).") from e
    if not pool:
        raise InvalidArgumentError("devices= is empty; pass at least one device.")
    types = sorted({d.type for d in pool})
    if any(t not in ("cuda", "cpu") for t in types):
        raise NotSupportedError(
            f"devices= names {', '.join(types)} devices; the port runs on CUDA or the CPU.")
    if len(types) > 1:
        raise NotSupportedError(f"devices= mixes CUDA and CPU entries: {_ONE_DEVICE}")
    resolved = "gpu" if types[0] == "cuda" else "cpu"
    wanted = {"gpu": "gpu", "cpu": "cpu", "none": "cpu"}.get(device_type)
    if wanted is not None and wanted != resolved:
        raise IncoherentArgumentError(
            f"device_type={device_type!r} contradicts devices=, whose entries are "
            f"{types[0]} devices; leave device_type out or make them agree.")
    if resolved == "cpu":
        return [torch.device("cpu")] * len(pool), resolved
    if torch.cuda.is_available():
        cur = torch.cuda.current_device()
        pool = [torch.device("cuda", cur if d.index is None else d.index) for d in pool]
    return pool, resolved


def box_device(pool, mesh, box, first):
    """The one device of the pool entries of a process's box (``box`` ranks
    from ``first``; entry ``r`` holds rank ``mesh[c] == r``). Raises
    `NotSupportedError` where they name more than one device."""
    sl = tuple(slice(int(c), int(c) + int(b)) for c, b in zip(first, box))
    own = sorted({str(pool[int(r)]) for r in np.asarray(mesh)[sl].ravel()})
    if len(own) > 1:
        raise NotSupportedError(
            f"devices= spans {', '.join(own)} over the ranks of one process's box: "
            f"{_ONE_DEVICE}")
    return pool[int(np.asarray(mesh)[sl].ravel()[0])]


def build_mesh(dims) -> np.ndarray:
    """The rank of every Cartesian position: ``mesh[c] == cart_rank(c)``."""
    dims = tuple(int(d) for d in dims)
    if len(dims) != NDIMS or any(d < 1 for d in dims):
        raise InvalidArgumentError(f"dims must have {NDIMS} positive entries.")
    return np.arange(int(np.prod(dims)), dtype=np.int64).reshape(dims)


def _dcn_factorization(dims, dcn_axes, n_slices):
    """Split ``dims`` into per-axis (dcn, ici) factors: the product of the
    dcn factors over ``dcn_axes`` must equal ``n_slices``, each dividing its
    axis' dims, factors as balanced as possible (fewest boundary crossings
    per axis). A copy of the JAX package's function of the same name."""
    axis_ids = {"x": 0, "y": 1, "z": 2}
    sel = [axis_ids[a] for a in dcn_axes]
    best = None

    def search(i, rem, acc):
        nonlocal best
        if i == len(sel):
            if rem == 1:
                cand = tuple(acc)
                score = (max(cand) - min(cand), max(cand))
                if best is None or score < best[0]:
                    best = (score, cand)
            return
        for f in range(1, min(int(dims[sel[i]]), rem) + 1):
            if rem % f == 0 and int(dims[sel[i]]) % f == 0:
                search(i + 1, rem // f, acc + [f])

    search(0, int(n_slices), [])
    if best is None:
        raise IncoherentArgumentError(
            f"Cannot distribute {n_slices} slice(s) over DCN axes {dcn_axes} "
            f"with dims {tuple(int(x) for x in dims)}: the slice count must "
            "factor into the dims of the designated axes."
        )
    dcn = [1, 1, 1]
    for d, f in zip(sel, best[1]):
        dcn[d] = f
    return tuple(dcn), tuple(int(dims[d]) // dcn[d] for d in range(NDIMS))


def process_boxes(dims, world: int, dcn_axes=()):
    """``(box, firsts)``: the box shape in ranks that each of ``world``
    processes owns, and the Cartesian coordinates of each process's first
    rank (list indexed by process rank). Raises `NotSupportedError` where
    the plain-order chunk of a process is not a box."""
    dims = tuple(int(d) for d in dims)
    n = int(np.prod(dims))
    world = int(world)
    if world == 1:
        return np.array(dims, dtype=np.int64), [np.zeros(NDIMS, dtype=np.int64)]
    if n % world:
        raise IncoherentArgumentError(
            f"The grid's {n} rank(s) do not divide over {world} processes.")
    if dcn_axes:
        dcn, ici = _dcn_factorization(dims, dcn_axes, world)
        firsts = [np.array(np.unravel_index(g, dcn), dtype=np.int64) * np.array(ici)
                  for g in range(world)]
        return np.array(ici, dtype=np.int64), firsts
    k = n // world
    box, rem = [1, 1, 1], k
    for d in (2, 1, 0):
        if rem == 1:
            break
        if rem % dims[d] == 0:
            box[d], rem = dims[d], rem // dims[d]
        elif dims[d] % rem == 0:
            box[d], rem = rem, 1
        else:
            break
    if rem != 1:
        raise NotSupportedError(
            f"In plain order each of {world} processes owns {k} consecutive ranks of the "
            f"{dims[0]}x{dims[1]}x{dims[2]} grid, which do not form a box; choose dims "
            "whose trailing axes hold a whole number of chunks, or set IGG_TPU_DCN_AXES.")
    return np.array(box, dtype=np.int64), [cart_coords(p * k, dims) for p in range(world)]


def process_grid(dims, box, firsts) -> np.ndarray:
    """The process rank of every box position: shape ``dims // box``."""
    shape = tuple(int(d) // int(b) for d, b in zip(dims, box))
    procs = np.full(shape, -1, dtype=np.int64)
    for p, c in enumerate(firsts):
        procs[tuple(int(ci) // int(b) for ci, b in zip(c, box))] = p
    return procs


def controller_coords_of(firsts, process_index: int) -> np.ndarray:
    """This process's Cartesian coordinates: the position of its first rank
    (``firsts`` from `process_boxes`), as the JAX package takes its first
    addressable device's mesh position. Zeros on the virtual mesh."""
    return np.array(firsts[int(process_index)], dtype=np.int64).copy()
