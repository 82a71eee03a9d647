"""Stencil difference helpers on tensors.

Counterpart of `implicitglobalgrid_tpu/ops/stencil.py`: ``d_xa``/``d_ya``/
``d_za`` difference along an axis over the full extent of the others;
``d_xi``/``d_yi``/``d_zi`` over the INNER extent of the others; ``inn`` the
interior. They return views or new tensors and work for 1-D to 3-D blocks.
"""

from __future__ import annotations

__all__ = ["d_xa", "d_ya", "d_za", "d_xi", "d_yi", "d_zi", "inn"]


def _d_a(A, axis: int):
    n = A.shape[axis]
    return A.narrow(axis, 1, n - 1) - A.narrow(axis, 0, n - 1)


def _inner_others(A, axis: int):
    for ax in range(A.dim()):
        if ax != axis:
            A = A.narrow(ax, 1, A.shape[ax] - 2)
    return A


def d_xa(A):
    """``A[1:] - A[:-1]`` along x."""
    return _d_a(A, 0)


def d_ya(A):
    return _d_a(A, 1)


def d_za(A):
    return _d_a(A, 2)


def d_xi(A):
    """Difference along x over the inner extent of the other dims."""
    return _d_a(_inner_others(A, 0), 0)


def d_yi(A):
    return _d_a(_inner_others(A, 1), 1)


def d_zi(A):
    return _d_a(_inner_others(A, 2), 2)


def inn(A):
    """Interior of ``A`` (a view)."""
    for ax in range(A.dim()):
        A = A.narrow(ax, 1, A.shape[ax] - 2)
    return A
