"""Allocation of stacked fields on the grid's device.

Counterpart of `implicitglobalgrid_tpu/ops/alloc.py`: pass the LOCAL block
shape a reference user would pass (``zeros_g((nx+1, ny, nz))``); the result
is this process's box, one tensor of shape ``box * local_shape`` on its
device (``dims * local_shape`` on the virtual mesh).

A tensor carries no sharding, so `sharding_of` returns the layout these
functions allocate with (`FieldSharding`): where the JAX package returns a
``NamedSharding`` over its mesh, the port describes the partition spec, the
grid, this process's box and its device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np

from ..parallel.topology import NDIMS, check_initialized, global_grid
from ..utils.exceptions import InvalidArgumentError
from .fields import field_partition_spec, is_global_shape, stacked_shape

__all__ = ["zeros_g", "ones_g", "full_g", "sharding_of", "device_put_g", "FieldSharding"]


@dataclass(frozen=True)
class FieldSharding:
    """How a stacked ``ndim``-D field is laid over the grid: ``spec`` names
    the mesh axis that splits each array axis (JAX's ``PartitionSpec`` as a
    tuple, member axes leading as None), ``dims`` the ranks per grid dim,
    ``box`` the ranks this process holds per dim from ``coords`` (its first
    rank's), all on ``device``."""

    spec: tuple
    dims: tuple
    box: tuple
    coords: tuple
    device: Any

    def stacked_shape(self, local_shape) -> tuple:
        """The shape of this process's tensor of ``local_shape`` blocks, as
        `zeros_g`, `full_g` and `device_put_g` allocate it: each axis that
        ``spec`` splits holds ``box`` blocks, a member axis stays whole."""
        local_shape = tuple(int(s) for s in local_shape)
        if len(local_shape) != len(self.spec):
            raise InvalidArgumentError(
                f"A {len(self.spec)}-D layout takes a {len(self.spec)}-D local shape; got "
                f"{local_shape}.")
        lead = len(local_shape) - min(len(local_shape), NDIMS)
        return local_shape[:lead] + tuple(
            int(self.box[d]) * s for d, s in enumerate(local_shape[lead:]))


def sharding_of(ndim: int) -> FieldSharding:
    """The layout of a stacked ``ndim``-D field on the grid (`FieldSharding`),
    the counterpart of the JAX package's ``NamedSharding``."""
    check_initialized()
    gg = global_grid()
    return FieldSharding(spec=field_partition_spec(ndim),
                         dims=tuple(int(d) for d in gg.dims),
                         box=tuple(int(b) for b in gg.box),
                         coords=tuple(int(c) for c in gg.coords), device=gg.device)


def full_g(local_shape=None, fill_value=0.0, dtype=None):
    """Stacked tensor of this process's box with every block a
    ``local_shape`` block of ``fill_value``. ``local_shape=None`` uses the grid's ``(nx, ny, nz)``;
    ``dtype=None`` is torch's default float dtype."""
    import torch

    check_initialized()
    gg = global_grid()
    if local_shape is None:
        local_shape = tuple(int(n) for n in gg.nxyz)
    local_shape = tuple(int(s) for s in local_shape)
    if len(local_shape) < 1 or len(local_shape) > 3:
        raise InvalidArgumentError("local_shape must have 1 to 3 dimensions.")
    return torch.full(stacked_shape(local_shape), fill_value, dtype=dtype,
                      device=gg.device)


def zeros_g(local_shape=None, dtype=None):
    """`zeros(nx, ny, nz)` analog."""
    return full_g(local_shape, 0.0, dtype)


def ones_g(local_shape=None, dtype=None):
    return full_g(local_shape, 1.0, dtype)


def device_put_g(A):
    """A contiguous copy of host array or tensor ``A`` on the grid's device,
    with its dtype: the whole grid's stacked array (``dims * local``, as
    the JAX package takes it) gives this process's box of it; a box-shaped
    array (``box * local``, `fields.is_global_shape`) is taken as it is.
    Always a copy, so the in-place halo writes never reach the caller's
    array."""
    import torch

    check_initialized()
    gg = global_grid()
    if not isinstance(A, torch.Tensor):
        A = torch.from_numpy(np.ascontiguousarray(A))
    if is_global_shape(A.shape):
        A = A[tuple(slice(int(c) * (int(s) // int(D)), (int(c) + int(b)) * (int(s) // int(D)))
                    for s, D, b, c in zip(A.shape, gg.dims, gg.box, gg.coords))]
    return A.to(gg.device, copy=True).contiguous()
