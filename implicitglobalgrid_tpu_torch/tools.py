"""Global-grid queries: sizes and coordinates.

Counterpart of the size and coordinate helpers of `implicitglobalgrid_tpu/
tools.py`: ``nx_g/ny_g/nz_g`` (with per-array overloads for staggered
fields), ``x_g/y_g/z_g`` (global coordinate of a 0-based local index,
including the staggering offset and the periodic ghost-cell shift and wrap)
and the vectorized builders ``x_g_vec``/``coords_g`` for initial conditions.
Coordinates are computed on the host in float64 numpy. A stacked index is
one of this process's box, whose first rank sits at ``coords``, so the
coordinates of every process's box are global.

``python -m implicitglobalgrid_tpu_torch.tools`` is the operator CLI: its
parser and commands live in `cli.py` (`_cli` here runs them).
"""

from __future__ import annotations

import numpy as np

from .ops.fields import local_shape_of
from .parallel.topology import NDIMS, check_initialized, global_grid
from .utils.exceptions import InvalidArgumentError

__all__ = [
    "nx_g", "ny_g", "nz_g", "x_g", "y_g", "z_g",
    "x_g_vec", "y_g_vec", "z_g_vec", "coords_g",
]


def _shape_of(A):
    if A is None:
        return None
    if hasattr(A, "shape"):
        return tuple(int(s) for s in A.shape)
    raise InvalidArgumentError(f"Expected an array, got {type(A)}.")


def _n_g(dim: int, A=None, layout=None) -> int:
    """Global size along ``dim``; with an array, its own global size
    including staggering (``nx_g() + (size(A, 1) - nx)``)."""
    gg = global_grid()
    if A is None:
        return int(gg.nxyz_g[dim])
    loc = local_shape_of(_shape_of(A), layout)
    size_d = loc[dim] if dim < len(loc) else 1
    return int(gg.nxyz_g[dim]) + (size_d - int(gg.nxyz[dim]))


def nx_g(A=None, *, layout=None) -> int:
    """Size of the global grid in dimension x (or array ``A``'s)."""
    return _n_g(0, A, layout)


def ny_g(A=None, *, layout=None) -> int:
    """Size of the global grid in dimension y (or array ``A``'s)."""
    return _n_g(1, A, layout)


def nz_g(A=None, *, layout=None) -> int:
    """Size of the global grid in dimension z (or array ``A``'s)."""
    return _n_g(2, A, layout)


def _coord_g(i0, dim: int, dcoord, size_d: int, coord):
    """Global coordinate of 0-based local index ``i0`` (scalar or numpy
    vector) of the rank at ``coord`` along ``dim``: staggered arrays shift
    by ``x0``; periodic dims shift left by one (ghost) cell and wrap into
    ``[0, nxyz_g*d)``."""
    gg = global_grid()
    n = int(gg.nxyz[dim])
    olp = int(gg.overlaps[dim])
    n_gl = int(gg.nxyz_g[dim])
    x0 = 0.5 * (n - size_d) * dcoord
    x = (coord * (n - olp) + i0) * dcoord + x0
    if bool(gg.periods[dim]):
        x = x - dcoord
        if np.isscalar(x) or isinstance(x, (int, float, np.generic)):
            if x > (n_gl - 1) * dcoord:
                x = x - n_gl * dcoord
            if x < 0:
                x = x + n_gl * dcoord
        else:
            x = np.where(x > (n_gl - 1) * dcoord, x - n_gl * dcoord, x)
            x = np.where(x < 0, x + n_gl * dcoord, x)
    return x


def _x_g(ix, dcoord, A, dim: int, coords=None, layout=None):
    """Global coordinate of index ``ix`` of ``A`` along ``dim``: a stacked
    index of this process's box for a stacked array, else a local index of
    the rank at ``coords`` (required for a local block: there is no
    implicit current rank outside the JAX package's shard_map)."""
    check_initialized()
    gg = global_grid()
    shape = _shape_of(A)
    loc = local_shape_of(shape, layout)
    size_d = loc[dim] if dim < len(loc) else 1
    shape_d = shape[dim] if dim < len(shape) else 1
    if layout is None:
        stacked = shape_d != size_d or int(gg.box[dim]) == 1
    else:
        stacked = layout == "stacked" or int(gg.box[dim]) == 1
    if stacked and coords is None:
        coord, i_local = divmod(int(ix), size_d)
        return _coord_g(i_local, dim, dcoord, size_d, coord + int(gg.coords[dim]))
    if coords is None:
        raise InvalidArgumentError(
            "x_g/y_g/z_g on a local block requires the rank's coordinate: "
            "pass coords=<Cartesian coordinate(s)>.")
    coord = coords[dim] if np.iterable(coords) else coords
    return _coord_g(ix, dim, dcoord, size_d, int(coord))


def x_g(ix, dx, A, coords=None, *, layout=None):
    """Global x-coordinate of 0-based index ``ix`` in array ``A``."""
    return _x_g(ix, dx, A, 0, coords, layout)


def y_g(iy, dy, A, coords=None, *, layout=None):
    """Global y-coordinate."""
    return _x_g(iy, dy, A, 1, coords, layout)


def z_g(iz, dz, A, coords=None, *, layout=None):
    """Global z-coordinate."""
    return _x_g(iz, dz, A, 2, coords, layout)


def _x_g_vec(dcoord, A, dim: int, layout=None):
    """Stacked 1-D coordinate vector along ``dim``: entry ``i`` is the
    global coordinate of stacked index ``i`` of this process's box (float64
    numpy)."""
    check_initialized()
    shape = _shape_of(A) if hasattr(A, "shape") else tuple(A)
    loc = local_shape_of(shape, layout)
    gg = global_grid()
    size_d = loc[dim] if dim < len(loc) else 1
    n_stack = int(gg.box[dim]) * size_d if dim < NDIMS else size_d
    idx = np.arange(n_stack)
    coord, i_local = idx // size_d + int(gg.coords[dim]), idx % size_d
    return _coord_g(i_local.astype(np.float64), dim, dcoord, size_d,
                    coord.astype(np.float64))


def x_g_vec(dx, A, *, layout=None):
    """Vector of global x-coordinates for every stacked index of ``A`` (this
    process's box)."""
    return _x_g_vec(dx, A, 0, layout)


def y_g_vec(dy, A, *, layout=None):
    return _x_g_vec(dy, A, 1, layout)


def z_g_vec(dz, A, *, layout=None):
    return _x_g_vec(dz, A, 2, layout)


def coords_g(dx, dy, dz, A):
    """Broadcastable (x, y, z) global-coordinate numpy arrays for stacked
    array (or shape) ``A`` of this process's box: shapes (nx,1,1),
    (1,ny,1), (1,1,nz)."""
    shape = _shape_of(A) if hasattr(A, "shape") else tuple(A)
    nd = len(shape)
    outs = []
    for dim, d in zip(range(min(nd, NDIMS)), (dx, dy, dz)):
        v = np.asarray(_x_g_vec(d, shape, dim))
        sh = [1] * nd
        sh[dim] = v.shape[0]
        outs.append(v.reshape(sh))
    return tuple(outs)


def _cli(argv=None) -> int:
    """``python -m implicitglobalgrid_tpu_torch.tools``: the operator CLI
    (subcommands, device rules and the flags that raise: `cli.py`)."""
    from .cli import main

    return main(argv)


if __name__ == "__main__":  # python -m implicitglobalgrid_tpu_torch.tools ...
    import sys

    sys.exit(_cli(sys.argv[1:]))
