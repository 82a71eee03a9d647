"""Allocation of stacked fields on the grid's device.

Counterpart of `implicitglobalgrid_tpu/ops/alloc.py`: pass the LOCAL block
shape a reference user would pass (``zeros_g((nx+1, ny, nz))``); the result
is this process's box, one tensor of shape ``box * local_shape`` on its
device (``dims * local_shape`` on the virtual mesh).
"""

from __future__ import annotations

import numpy as np

from ..parallel.topology import check_initialized, global_grid
from ..utils.exceptions import InvalidArgumentError
from .fields import is_global_shape, stacked_shape

__all__ = ["zeros_g", "ones_g", "full_g", "device_put_g"]


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
