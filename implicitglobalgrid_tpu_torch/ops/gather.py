"""Gather a stacked field to the host: `gather`, `gather_interior`.

Counterpart of `implicitglobalgrid_tpu/ops/gather.py`. The stacked tensor
already IS the concatenation of every rank's block, so `gather` is a copy to
host memory; `gather_interior` strips the overlap duplication and returns
the implicit global grid (size ``nxyz_g``). One process holds every virtual
rank, so it is the root.
"""

from __future__ import annotations

import numpy as np

from ..parallel.topology import check_initialized, global_grid
from ..utils.exceptions import IncoherentArgumentError, InvalidArgumentError
from .fields import local_shape_of

__all__ = ["gather", "gather_interior"]


def _to_host(A) -> np.ndarray:
    """Host numpy copy of tensor ``A``. bfloat16 (which numpy lacks) comes
    back widened to float32, an exact conversion."""
    import torch

    if not isinstance(A, torch.Tensor):
        raise InvalidArgumentError("gather expects a torch.Tensor.")
    A = A.detach()
    if A.dtype == torch.bfloat16:
        A = A.float()
    return A.cpu().numpy().copy()


def gather(A, A_global=None, *, root: int = 0, layout: str | None = None):
    """Gather stacked field ``A`` to the host: the full stacked array (shape
    ``dims * local_shape``). With ``A_global`` (numpy) the result is written
    into it in place. ``root`` is accepted for API parity (this process is
    the only one, rank 0)."""
    check_initialized()
    gg = global_grid()
    host = _to_host(A)
    if A_global is not None:
        loc = local_shape_of(A.shape, layout)
        expected = tuple(
            int(gg.dims[d]) * int(loc[d]) if d < 3 else int(loc[d])
            for d in range(len(loc))
        )
        if tuple(int(s) for s in A_global.shape) != expected:
            raise IncoherentArgumentError(
                "The size of the global array `size(A_global)` must be equal to the "
                f"product of `size(A)` and `dims` (expected {expected}, got "
                f"{tuple(A_global.shape)})."
            )
        np.copyto(np.asarray(A_global), host)
        return A_global
    return host


def gather_interior(A, *, root: int = 0, layout: str | None = None):
    """Gather ``A`` and strip the overlap duplication: local cell ``i`` of
    the rank at ``c`` is global cell ``c*(n - ol) + i`` (non-periodic; later
    ranks win ties); periodic dims shift by one ghost cell and wrap."""
    check_initialized()
    gg = global_grid()
    host = _to_host(A)
    loc = local_shape_of(host.shape, layout)
    nd = len(loc)
    out_shape = []
    for d in range(nd):
        n = int(loc[d])
        if d >= 3 or int(gg.dims[d]) == 1 and not gg.periods[d]:
            dd, ol_d, per = 1, 0, False
        else:
            dd = int(gg.dims[d])
            ol_d = int(gg.overlaps[d] + (n - gg.nxyz[d]))
            per = bool(gg.periods[d])
        out_shape.append(dd * (n - ol_d) if per else dd * (n - ol_d) + ol_d)

    out = np.empty(tuple(out_shape), dtype=host.dtype)
    dims3 = [int(gg.dims[d]) if d < 3 else 1 for d in range(nd)]
    for cidx in np.ndindex(*dims3):
        src = [slice(None)] * nd
        dst = [slice(None)] * nd
        ok = True
        for d in range(nd):
            n = int(loc[d])
            dd = dims3[d]
            ol_d = int(gg.overlaps[d] + (n - gg.nxyz[d])) if d < 3 else 0
            per = bool(gg.periods[d]) if d < 3 else False
            c = cidx[d]
            if per:
                start_g = (c * (n - ol_d)) % out_shape[d]
                src[d] = slice(1, n - ol_d + 1)
                dst[d] = slice(start_g, start_g + (n - ol_d))
            else:
                keep = n if c == dd - 1 else n - ol_d
                src[d] = slice(0, keep)
                dst[d] = slice(c * (n - ol_d), c * (n - ol_d) + keep)
            src[d] = slice(c * n + src[d].start, c * n + src[d].stop)
            ok = ok and (dst[d].stop <= out_shape[d])
        if not ok:
            _copy_wrapped(out, host, src, dst, out_shape)
        else:
            out[tuple(dst)] = host[tuple(src)]
    return out


def _copy_wrapped(out, host, src, dst, out_shape):
    """Copy with modulo wrap along dims whose destination crosses the end."""
    for d in range(len(out_shape)):
        if dst[d].stop > out_shape[d]:
            n1 = out_shape[d] - dst[d].start
            a_src, a_dst, b_src, b_dst = list(src), list(dst), list(src), list(dst)
            a_src[d] = slice(src[d].start, src[d].start + n1)
            a_dst[d] = slice(dst[d].start, out_shape[d])
            b_src[d] = slice(src[d].start + n1, src[d].stop)
            b_dst[d] = slice(0, dst[d].stop - out_shape[d])
            _copy_wrapped(out, host, a_src, a_dst, out_shape)
            _copy_wrapped(out, host, b_src, b_dst, out_shape)
            return
    out[tuple(dst)] = host[tuple(src)]
