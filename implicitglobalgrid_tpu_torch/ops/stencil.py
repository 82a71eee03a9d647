"""Stencil difference helpers on tensors.

Counterpart of `implicitglobalgrid_tpu/ops/stencil.py`: ``d_xa``/``d_ya``/
``d_za`` difference along an axis over the full extent of the others;
``d_xi``/``d_yi``/``d_zi`` over the INNER extent of the others; ``inn`` the
interior. They return views or new tensors and work for 1-D to 3-D blocks,
with ``lead`` leading axes (an ensemble's members) left whole.
"""

from __future__ import annotations

__all__ = ["d_xa", "d_ya", "d_za", "d_xi", "d_yi", "d_zi", "inn"]


def _d_a(A, axis: int):
    n = A.shape[axis]
    return A.narrow(axis, 1, n - 1) - A.narrow(axis, 0, n - 1)


def _inner_others(A, axis: int, lead: int):
    for ax in range(lead, A.dim()):
        if ax != axis:
            A = A.narrow(ax, 1, A.shape[ax] - 2)
    return A


def d_xa(A, *, lead: int = 0):
    """``A[1:] - A[:-1]`` along x. ``lead``: axes before the block's (an
    ensemble's members), which every helper leaves whole."""
    return _d_a(A, lead)


def d_ya(A, *, lead: int = 0):
    return _d_a(A, lead + 1)


def d_za(A, *, lead: int = 0):
    return _d_a(A, lead + 2)


def d_xi(A, *, lead: int = 0):
    """Difference along x over the inner extent of the other dims."""
    return _d_a(_inner_others(A, lead, lead), lead)


def d_yi(A, *, lead: int = 0):
    return _d_a(_inner_others(A, lead + 1, lead), lead + 1)


def d_zi(A, *, lead: int = 0):
    return _d_a(_inner_others(A, lead + 2, lead), lead + 2)


def inn(A, *, lead: int = 0):
    """Interior of ``A`` (a view)."""
    for ax in range(lead, A.dim()):
        A = A.narrow(ax, 1, A.shape[ax] - 2)
    return A
