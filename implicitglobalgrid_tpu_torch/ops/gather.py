"""Gather a stacked field to the host: `gather`, `gather_interior`,
`gather_sub`.

Counterpart of `implicitglobalgrid_tpu/ops/gather.py`. Each process holds a
box of the stacked field; the boxes go to ``root`` (a process rank) over the
grid's transport and are placed by their position, which gives the whole
grid's stacked array (every rank's block, halos included). On the virtual
mesh the one box IS that array, so `gather` is a copy to host memory.
`gather_interior` strips the overlap duplication and returns the implicit
global grid (size ``nxyz_g``); `gather_sub` returns the blocks of a box of
rank coordinates and moves only the processes' boxes that meet it. Only
``root`` returns an array; the others return None. Every process must call
them, as any collective.
"""

from __future__ import annotations

import numpy as np

from ..analysis import record as _record
from ..parallel.topology import check_initialized, global_grid
from ..utils.exceptions import IncoherentArgumentError, InvalidArgumentError
from .fields import local_shape_of

__all__ = ["gather", "gather_interior", "gather_sub"]


def _host_dtype(dtype):
    """The numpy dtype of a gathered ``dtype``: `ml_dtypes.bfloat16` for
    bfloat16 where ml_dtypes imports (numpy has no bfloat16), else float32,
    an exact widening."""
    import torch

    if dtype != torch.bfloat16:
        return None
    try:
        import ml_dtypes
    except ImportError:
        return np.float32
    return ml_dtypes.bfloat16


def _numpy(t) -> np.ndarray:
    """A host numpy copy of tensor ``t`` (bfloat16: `_host_dtype`)."""
    import torch

    t = t.detach().cpu().contiguous()
    hd = _host_dtype(t.dtype)
    if hd is None:
        return t.numpy().copy()
    if hd is np.float32:
        return t.float().numpy()
    return t.view(torch.int16).numpy().view(hd).copy()


def _check_tensor(A):
    import torch

    if not isinstance(A, torch.Tensor):
        raise InvalidArgumentError("gather expects a torch.Tensor.")
    return A.detach()


def _boxes_to_host(A, root, loc, sel=None):
    """COLLECTIVE: the whole grid's stacked array of ``A`` (every process's
    box, blocks of ``loc``) on ``root``, None elsewhere; with ``sel`` (per
    dim ``(lo, hi)`` rank ranges) only the selected blocks, moving only the
    boxes that meet them."""
    gg = global_grid()
    nd = len(loc)
    box = [int(gg.box[d]) if d < 3 else 1 for d in range(nd)]
    dims = [int(gg.dims[d]) if d < 3 else 1 for d in range(nd)]
    sel = sel or [(0, D) for D in dims]
    tr = gg.transport
    firsts = {int(p): [int(c) * b for c, b in zip(np.argwhere(gg.procs == p)[0], gg.box)]
              for p in range(tr.world)}

    def part_of(p):
        """The slices of process ``p``'s box and of the result it fills, or
        None where its box misses the selection."""
        src, dst = [], []
        for d in range(nd):
            f = firsts[p][d] if d < 3 else 0
            lo, hi = max(f, sel[d][0]), min(f + box[d], sel[d][1])
            if lo >= hi:
                return None
            n = int(loc[d])
            src.append(slice((lo - f) * n, (hi - f) * n))
            dst.append(slice((lo - sel[d][0]) * n, (hi - sel[d][0]) * n))
        return tuple(src), tuple(dst)

    parts = {p: part_of(p) for p in range(tr.world)}
    if _record.ACTIVE is not None:  # the whole selection, to the host
        whole = tuple((hi - lo) * int(n) for (lo, hi), n in zip(sel, loc))
        _record.ACTIVE.all_gather(A, whole, site="gather")
        _record.ACTIVE.host_transfer(_record.Shape(_record.hlo_dtype(A.dtype), whole),
                                     site="gather")
    got = tr.gather(A.contiguous(), root, [p for p, pt in parts.items() if pt is not None])
    if gg.me != root:
        return None
    out = None
    for p, boxed in got.items():
        src, dst = parts[p]
        host = _numpy(boxed[src])
        if out is None:
            out = np.empty(tuple((hi - lo) * int(n) for (lo, hi), n in zip(sel, loc)),
                           dtype=host.dtype)
        out[dst] = host
    return out


def gather(A, A_global=None, *, root: int = 0, layout: str | None = None):
    """Gather stacked field ``A`` (this process's box) to the host.

    Returns the whole grid's stacked array (shape ``dims * local_shape``) on
    process ``root``, None on the others. With ``A_global`` (numpy) the
    result is written into it in place. COLLECTIVE: every process must call
    it (before any check on root can raise)."""
    check_initialized()
    gg = global_grid()
    A = _check_tensor(A)
    loc = local_shape_of(A.shape, layout)
    host = _boxes_to_host(A, int(root), loc)
    if gg.me != root:
        return None
    if A_global is not None:
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


def gather_sub(A, box, A_global=None, *, root: int = 0, layout: str | None = None):
    """Gather only the blocks whose Cartesian coordinates lie in ``box``: a
    per-dimension sequence of ``(lo, hi)`` half-open rank ranges (up to 3
    entries; omitted or None entries mean the full axis). The result on
    ``root`` is the stacked array of the selected blocks, shape ``(hi-lo) *
    local_shape`` per dimension; the other processes return None. Only the
    processes' boxes that meet ``box`` are moved. ``A_global`` (numpy)
    receives the result in place like `gather`. COLLECTIVE (the JAX
    package's `gather_sub`)."""
    check_initialized()
    gg = global_grid()
    A = _check_tensor(A)
    loc = local_shape_of(A.shape, layout)
    nd = len(loc)
    for d in range(min(nd, 3)):
        if int(A.shape[d]) != int(gg.box[d]) * int(loc[d]):
            raise InvalidArgumentError(
                "gather_sub requires a STACKED array (this process's box * local "
                f"size); got shape {tuple(A.shape)} (local along dimension {d}). The "
                "coordinate box selects blocks of the stacked layout."
            )
    box = list(box) + [None] * (3 - len(list(box)))
    if any(b is not None for b in box[nd:]):
        raise InvalidArgumentError(
            f"gather_sub box selects dimension(s) beyond the array's rank "
            f"({nd}-D): {tuple(box)}."
        )
    ranges = []
    for d in range(nd):
        D = int(gg.dims[d]) if d < 3 else 1
        sel = box[d] if d < 3 else None
        if sel is None:
            ranges.append((0, D))
            continue
        lo, hi = (int(sel[0]), int(sel[1]))
        if not (0 <= lo < hi <= D):
            raise InvalidArgumentError(
                f"gather_sub box along dimension {d} must satisfy "
                f"0 <= lo < hi <= dims[{d}]={D}; got ({lo}, {hi})."
            )
        ranges.append((lo, hi))
    sub = _boxes_to_host(A, int(root), loc, ranges)
    if gg.me != root:
        return None
    if A_global is not None:
        if tuple(int(s) for s in A_global.shape) != sub.shape:
            raise IncoherentArgumentError(
                f"gather_sub: A_global shape {tuple(A_global.shape)} does "
                f"not match the selected block shape {sub.shape}."
            )
        np.copyto(np.asarray(A_global), sub)
        return A_global
    return sub


def gather_interior(A, *, root: int = 0, layout: str | None = None):
    """Gather ``A`` and strip the overlap duplication, returning the implicit
    global grid on ``root`` (None elsewhere): local cell ``i`` of the rank
    at ``c`` is global cell ``c*(n - ol) + i`` (non-periodic; later ranks
    win ties); periodic dims shift by one ghost cell and wrap. COLLECTIVE."""
    check_initialized()
    gg = global_grid()
    A = _check_tensor(A)
    loc = local_shape_of(A.shape, layout)
    host = _boxes_to_host(A, int(root), loc)
    if gg.me != root:
        return None
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
