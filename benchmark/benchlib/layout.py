"""The block layout of the program's fields, worked out by the benchmark.

A process holds its box of blocks as one tensor, the blocks stacked along
each axis (block ``(i, j, k)`` of local shape ``m`` at ``[i*m0:(i+1)*m0,
...]``). On a non-periodic implicit global grid, block ``i`` of a field of
local size ``m`` along a dim holds the global cells ``[i*s, i*s + m)``,
with ``s = n - ol`` the block stride (``n`` the base local size, ``ol``
its overlap): a staggered field (``m = n + 1``) has the same stride. So a
global field made by the benchmark maps onto the program's layout by
slicing, and every stored cell, halos included, has one global value.
"""

from __future__ import annotations

import itertools


class Grid:
    """The implicit global grid of ``dims`` non-periodic blocks of
    ``local`` cells overlapping by ``overlaps``."""

    def __init__(self, local, dims, overlaps):
        self.local = tuple(int(n) for n in local)
        self.dims = tuple(int(d) for d in dims)
        self.overlaps = tuple(int(o) for o in overlaps)
        self.stride = tuple(n - o for n, o in zip(self.local, self.overlaps))
        self.global_shape = self.global_of(self.local)

    @property
    def blocks(self) -> int:
        out = 1
        for d in self.dims:
            out *= d
        return out

    def global_of(self, local_shape) -> tuple:
        """The global shape of a field of local shape ``local_shape``."""
        return tuple(d * s + (int(m) - s)
                     for d, s, m in zip(self.dims, self.stride, local_shape))

    def stacked_of(self, local_shape) -> tuple:
        return tuple(d * int(m) for d, m in zip(self.dims, local_shape))

    def _pairs(self, local_shape):
        """(stacked index, global index) of every block."""
        for idx in itertools.product(*(range(d) for d in self.dims)):
            dst = tuple(slice(i * m, (i + 1) * m) for i, m in zip(idx, local_shape))
            src = tuple(slice(i * s, i * s + m)
                        for i, s, m in zip(idx, self.stride, local_shape))
            yield (Ellipsis, *dst), (Ellipsis, *src)

    def stack(self, G, local_shape=None):
        """Global field ``G`` (any leading axes, then 3) in the program's
        stacked layout, as a new tensor."""
        local_shape = tuple(local_shape or self.local)
        if tuple(G.shape[-3:]) != self.global_of(local_shape):
            raise ValueError(f"a field of local shape {local_shape} is "
                             f"{self.global_of(local_shape)} globally; got {tuple(G.shape)}")
        out = G.new_empty(tuple(G.shape[:-3]) + self.stacked_of(local_shape))
        for dst, src in self._pairs(local_shape):
            out[dst] = G[src]
        return out
