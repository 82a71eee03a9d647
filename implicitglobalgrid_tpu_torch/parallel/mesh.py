"""The virtual mesh: how ranks are laid out and which device holds them.

Counterpart of `implicitglobalgrid_tpu/parallel/mesh.py`. Where the JAX
package arranges real devices into a `jax.sharding.Mesh`, the port runs every
rank in this one process: the mesh is the identity (``reorder``-free) layout
of ranks in row-major Cartesian order, and every rank's block is a view of
one stacked tensor on ``device``. So a 2x2x2 grid runs on one GPU or on the
CPU.
"""

from __future__ import annotations

import numpy as np

from ..utils.exceptions import InvalidArgumentError, NotLoadedError
from .topology import NDIMS

__all__ = ["build_mesh", "resolve_device", "controller_coords_of"]


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


def controller_coords_of(mesh: np.ndarray, rank: int) -> np.ndarray:
    """Cartesian coordinates of ``rank`` in ``mesh``."""
    return np.array(np.unravel_index(int(rank), mesh.shape), dtype=np.int64)
