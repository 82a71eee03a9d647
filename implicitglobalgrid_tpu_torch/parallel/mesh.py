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
"""

from __future__ import annotations

import numpy as np

from ..utils.exceptions import (
    IncoherentArgumentError, InvalidArgumentError, NotLoadedError, NotSupportedError,
)
from .topology import NDIMS, cart_coords

__all__ = ["build_mesh", "resolve_device", "controller_coords_of", "process_boxes",
           "process_grid"]


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
