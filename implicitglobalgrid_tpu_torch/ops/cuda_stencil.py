"""The diffusion kernels of `csrc/stencil.cu` and their plain versions.

Counterpart of `implicitglobalgrid_tpu/ops/pallas_stencil.py`:

- K1 `diffusion3d_step_halo` for `diffusion3d_step_halo_pallas`,
  `diffusion3d_step_pallas` and `diffusion3d_step_halo_pallas_mp` (one
  function): the 3-D step with the self-neighbour halo updates folded in.
- K4 `diffusion3d_step_recv` and K5 `diffusion2d_step_recv`: the step plus
  the delivery of received halo slabs, the kernels of
  `diffusion3d_step_exchange_pallas` and `diffusion2d_step_exchange_pallas`.
  `diffusion3d_step_exchange` / `diffusion2d_step_exchange` are those entry
  points: the send slabs and the exchange pipeline, then K4 or K5.
- K4s `exchange_slabs`: the received slabs of one exchanging dim for every
  block (the JAX package's `_xla_update_slab` + slab pipeline, in XLA there),
  and `update_slab`, the updated state on a range of every block.

Fields are stacked: ``block`` is the per-rank block shape and every block is
stepped independently (one launch for all of them). On a CUDA tensor a
wrapper launches its kernel (or raises); on a CPU tensor it runs the plain
PyTorch version beside it, in the JAX package's accumulation order.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..utils.exceptions import InvalidArgumentError, NotSupportedError
from .cuda_build import check_rc, count_launch, library
from .fields import block_slices

__all__ = ["diffusion3d_step_halo", "diffusion3d_step",
           "diffusion3d_step_halo_plain", "pallas_supported",
           "fusable_halo_dims", "step_exchange_modes", "Move", "update_slab",
           "update_slab_plain", "exchange_slabs", "exchange_slabs_plain",
           "move_slabs_plain",
           "diffusion3d_step_recv", "diffusion3d_step_recv_plain",
           "diffusion2d_step_recv", "diffusion2d_step_recv_plain",
           "diffusion3d_step_exchange", "diffusion2d_step_exchange"]


def pallas_supported(shape) -> bool:
    """Whether the step kernel takes a block of this LOCAL shape (the JAX
    gate of the same name: 3-D with at least 3 planes)."""
    return len(shape) == 3 and int(shape[0]) >= 3


def fusable_halo_dims(gg, ndim: int = 3):
    """Which dims' halo exchange can fold into the step's output pass:
    self-neighbour dims (periodic, one rank) with overlap 2, halowidth 1 and
    disp 1, as a prefix of the z, x, y order (a dim after a non-fusable
    exchanging dim cannot fuse). Returns (fuse_x, fuse_y, fuse_z) or None."""
    if ndim != 3:
        return None
    fuse = [False, False, False]
    for dim in (2, 0, 1):
        D = int(gg.dims[dim])
        periodic = bool(gg.periods[dim])
        if D == 1 and not periodic:
            continue
        if (D == 1 and periodic and int(gg.overlaps[dim]) == 2
                and int(gg.halowidths[dim]) == 1 and int(gg.disp) == 1):
            fuse[dim] = True
        else:
            break
    if not any(fuse):
        return None
    return tuple(fuse)


def step_exchange_modes(gg, shape):
    """Participation modes of the fused step + exchange (K4, K5) for a
    block of this LOCAL shape, or None (the JAX gate of the same name).

    Eligible when every exchanging dim has overlap 2 and halowidth 1 and
    the block is unstaggered (``shape == nxyz``), with at least one
    exchanging dim; self and multi-rank dims mix freely. 2-D blocks return
    a 3-tuple with ``modes[2] = False``."""
    shape = tuple(int(s) for s in shape)
    if len(shape) not in (2, 3) or shape[0] < 3:
        return None
    if shape != tuple(int(n) for n in gg.nxyz[:len(shape)]):
        return None
    modes = [False, False, False]
    for dim in range(len(shape)):
        D = int(gg.dims[dim])
        periodic = bool(gg.periods[dim])
        disp = int(gg.disp)
        if D == 1 and not periodic:
            continue
        if D > 1 and not periodic and disp >= D:
            continue
        if int(gg.overlaps[dim]) != 2 or int(gg.halowidths[dim]) != 1:
            return None
        modes[dim] = True
    if not any(modes):
        return None
    return tuple(modes)


def _torch():
    import torch

    return torch


def _dtype_code(dtype) -> int:
    torch = _torch()
    codes = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
    if dtype not in codes:
        raise InvalidArgumentError(
            f"the diffusion kernels take float32, float64 or bfloat16; got {dtype}.")
    return codes[dtype]


def _stencil_plane(tm, tc, tp, cp, *, lam, dt, dx, dy, dz):
    """The flux-form update of planes (y/z derivatives over the LAST two
    axes), in the JAX package's accumulation order. bfloat16 inputs compute
    in float32 and round back. The constants are 0-d tensors of the compute
    dtype on the inputs' device, so every division is a true division."""
    torch = _torch()
    F = torch.nn.functional
    out_dt = tc.dtype
    if out_dt == torch.bfloat16:
        tm, tc, tp, cp = (a.float() for a in (tm, tc, tp, cp))
    qxr = -lam * (tp - tc) / dx
    qxl = -lam * (tc - tm) / dx
    acc = -((qxr - qxl) / dx)
    qy = -lam * (tc[..., 1:, :] - tc[..., :-1, :]) / dy
    acc = acc - F.pad((qy[..., 1:, :] - qy[..., :-1, :]) / dy, (0, 0, 1, 1))
    qz = -lam * (tc[..., :, 1:] - tc[..., :, :-1]) / dz
    acc = acc - F.pad((qz[..., :, 1:] - qz[..., :, :-1]) / dz, (1, 1))
    return (tc + dt * (acc / cp)).to(out_dt)


def _stencil_row(tm, tc, tp, cp, *, lam, dt, dx, dy):
    """The 2-D flux-form update of rows (the y derivative over the LAST
    axis), `_stencil_row`'s order in the JAX package."""
    torch = _torch()
    F = torch.nn.functional
    out_dt = tc.dtype
    if out_dt == torch.bfloat16:
        tm, tc, tp, cp = (a.float() for a in (tm, tc, tp, cp))
    qxr = -lam * (tp - tc) / dx
    qxl = -lam * (tc - tm) / dx
    acc = -((qxr - qxl) / dx)
    qy = -lam * (tc[..., 1:] - tc[..., :-1]) / dy
    acc = acc - F.pad((qy[..., 1:] - qy[..., :-1]) / dy, (1, 1))
    return (tc + dt * (acc / cp)).to(out_dt)


def _source_index(n: int, fuse: bool, device):
    """Source index of every output index along a dim: with the fused halo
    update, 0 reads n-2 and n-1 reads 1 (`_sigma`)."""
    torch = _torch()
    idx = torch.arange(n, device=device)
    if fuse:
        idx[0], idx[n - 1] = n - 2, 1
    return idx


def _interior(shape, device, offset=(0, 0, 0), extent=None):
    """Mask of the cells of a block (or a part of it: local positions start
    at ``offset``, block extents ``extent``) off its boundary."""
    torch = _torch()
    extent = shape if extent is None else extent
    m = None
    for d, s in enumerate(shape):
        pos = torch.arange(s, device=device) + offset[d]
        md = ((pos > 0) & (pos < extent[d] - 1)).view(
            [-1 if e == d else 1 for e in range(len(shape))])
        m = md if m is None else m & md
    return m


def _step_block_plain(Tb, Cb, consts, fuse=(False, False, False)):
    torch = _torch()
    tm = torch.cat([Tb[:1], Tb[:-1]])
    tp = torch.cat([Tb[1:], Tb[-1:]])
    stencil = _stencil_plane if Tb.dim() == 3 else _stencil_row
    U = torch.where(_interior(Tb.shape, Tb.device), stencil(tm, Tb, tp, Cb, **consts), Tb)
    for d, n in enumerate(Tb.shape):
        if fuse[d]:
            U = U.index_select(d, _source_index(n, True, Tb.device))
    return U


def _consts(dtype, device, **kw):
    """The kernel constants as 0-d tensors: float32 for float32 and
    bfloat16 states (bf16 constants would bias every flux term), float64
    for float64."""
    torch = _torch()
    cdt = torch.float64 if dtype == torch.float64 else torch.float32
    return {k: torch.tensor(float(v), dtype=cdt, device=device)
            for k, v in kw.items()}


def diffusion3d_step_halo_plain(T, Cp, *, lam, dt, dx, dy, dz, fuse,
                                block=None, out=None):
    """Plain PyTorch version of K1 (same arguments as
    `diffusion3d_step_halo`)."""
    block = tuple(T.shape) if block is None else tuple(int(b) for b in block)
    consts = _consts(T.dtype, T.device, lam=lam, dt=dt, dx=dx, dy=dy, dz=dz)
    fuse = tuple(bool(f) for f in fuse)
    if out is None:
        out = _torch().empty_like(T)
    for sl in block_slices(T.shape, block):
        out[sl] = _step_block_plain(T[sl], Cp[sl], consts, fuse)
    return out


def _check_state(T, Cp, ndim, block, out, name):
    """Validate a stacked state (T, Cp) of ``ndim`` dims, its ``block`` and
    ``out``; returns the block tuple."""
    torch = _torch()
    if not (isinstance(T, torch.Tensor) and isinstance(Cp, torch.Tensor)):
        raise InvalidArgumentError(f"{name} takes torch tensors.")
    if T.dim() != ndim or tuple(Cp.shape) != tuple(T.shape):
        raise InvalidArgumentError(
            f"{name}: T and Cp must be {ndim}-D of one shape; got {tuple(T.shape)} "
            f"and {tuple(Cp.shape)}.")
    _dtype_code(T.dtype)
    if Cp.dtype != T.dtype or Cp.device != T.device:
        raise InvalidArgumentError(f"{name}: T and Cp must share dtype and device.")
    if not (T.is_contiguous() and Cp.is_contiguous()):
        raise InvalidArgumentError(f"{name}: T and Cp must be contiguous.")
    block = tuple(T.shape) if block is None else tuple(int(b) for b in block)
    if len(block) != ndim or any(b < 1 or s % b for s, b in zip(T.shape, block)):
        raise InvalidArgumentError(
            f"{name}: block {block} does not tile the stacked shape {tuple(T.shape)}.")
    if out is not None:
        if (tuple(out.shape) != tuple(T.shape) or out.dtype != T.dtype
                or out.device != T.device or not out.is_contiguous()):
            raise InvalidArgumentError(f"{name}: out must be a contiguous tensor like T.")
        if out.data_ptr() in (T.data_ptr(), Cp.data_ptr()):
            raise InvalidArgumentError(
                f"{name}: out must not alias T or Cp: the step reads T at its neighbours.")
    return block


def _check_step_args(T, Cp, fuse, block, out):
    block = _check_state(T, Cp, 3, block, out, "diffusion3d_step_halo")
    if not pallas_supported(block):
        raise InvalidArgumentError(
            f"the step kernel needs blocks of >= 3 planes; got {block}.")
    if len(fuse) != 3 or any(f and n < 3 for f, n in zip(fuse, block)):
        raise InvalidArgumentError(
            f"fuse {tuple(fuse)} needs >= 3 cells along each fused dim; block {block}.")
    return block


def _on_card(t):
    """False for a CPU tensor (the plain version runs); True for a CUDA one;
    raises for any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise NotSupportedError(f"no kernel for device {t.device}.")
    return True


def _stream(t):
    torch = _torch()
    return torch.cuda.current_stream(t.device).cuda_stream


def diffusion3d_step_halo(T, Cp, *, lam, dt, dx, dy, dz, fuse, block=None,
                          out=None):
    """One diffusion step of every ``block`` of stacked ``T`` (with ``Cp``),
    the halo updates of the dims flagged in ``fuse`` (from
    `fusable_halo_dims`) folded into the output pass. Boundary cells keep
    their input. Out of place: writes ``out`` (allocated when None) and
    returns it."""
    block = _check_step_args(T, Cp, fuse, block, out)
    if not _on_card(T):
        return diffusion3d_step_halo_plain(T, Cp, lam=lam, dt=dt, dx=dx, dy=dy,
                                           dz=dz, fuse=fuse, block=block, out=out)
    torch = _torch()
    if out is None:
        out = torch.empty_like(T)
    lib = library()
    with torch.cuda.device(T.device):
        rc = lib.igg_diffusion3d_step_halo(
            _dtype_code(T.dtype), T.data_ptr(), Cp.data_ptr(), out.data_ptr(),
            *(int(s) for s in T.shape), *block,
            float(lam), float(dt), float(dx), float(dy), float(dz),
            *(int(bool(f)) for f in fuse), _stream(T))
    check_rc(rc, "diffusion3d_step_halo")
    count_launch("diffusion3d_step_halo")
    return out


def diffusion3d_step(T, Cp, *, lam, dt, dx, dy, dz, block=None, out=None):
    """One diffusion step without halo updates: the ``fuse=(F, F, F)`` case
    of `diffusion3d_step_halo` (one kernel, so the accumulation order cannot
    diverge between the two)."""
    return diffusion3d_step_halo(T, Cp, lam=lam, dt=dt, dx=dx, dy=dy, dz=dz,
                                 fuse=(False, False, False), block=block, out=out)


# ---------------------------------------------------------------------------
# K4s: send slabs and the received slabs of one exchanging dim.
# ---------------------------------------------------------------------------

class Move(NamedTuple):
    """Where one received slab comes from: block ``t`` takes the slab at
    local ``start`` of block ``t + shift`` (mod D on a periodic axis); on a
    PROC_NULL edge (no such block) its own block's slab at local ``own``."""
    start: int
    own: int
    shift: int


def update_slab_plain(T, Cp, dim, start, size, *, block, lam, dt, dx, dy, dz=1.0):
    """The updated state on ``[start, start+size)`` along ``dim`` of every
    block (full extent elsewhere), in the stacked slab layout; cells on a
    block's boundary keep their input. The JAX package's `_xla_update_slab`
    per block: a thin slab grown by the stencil radius, edge-cloned x
    neighbours, the global-interior mask."""
    torch = _torch()
    block = tuple(int(b) for b in block)
    consts = _consts(T.dtype, T.device, lam=lam, dt=dt, dx=dx, dy=dy,
                     **({"dz": dz} if T.dim() == 3 else {}))
    stencil = _stencil_plane if T.dim() == 3 else _stencil_row
    n = block[dim]
    lo, hi = max(start - 1, 0), min(start + size + 1, n)
    oshape = list(T.shape)
    oshape[dim] = T.shape[dim] // n * size
    oblock = list(block)
    oblock[dim] = size
    out = torch.empty(oshape, dtype=T.dtype, device=T.device)
    offset = [lo if d == dim else 0 for d in range(T.dim())]
    for sl, osl in zip(block_slices(T.shape, block), block_slices(oshape, oblock)):
        Ts = T[sl].narrow(dim, lo, hi - lo)
        Cs = Cp[sl].narrow(dim, lo, hi - lo)
        tm = torch.cat([Ts[:1], Ts[:-1]])
        tp = torch.cat([Ts[1:], Ts[-1:]])
        m = _interior(Ts.shape, T.device, offset, block)
        u = torch.where(m, stencil(tm, Ts, tp, Cs, **consts), Ts)
        out[osl] = u.narrow(dim, start - lo, size)
    return out


def _slab_view(A, dim, n, start, size):
    """The ``[start, start+size)`` range along ``dim`` of every block
    (length ``n``) of stacked ``A``, as a view of shape (..., D, size, ...)."""
    return A.unflatten(dim, (A.shape[dim] // n, n)).narrow(dim + 1, start, size)


def move_slabs_plain(get_slab, shape, device, dim, hw, moves, *, block, periodic,
                     earlier=()):
    """The slab pipeline of one dim in plain PyTorch: ``get_slab(start)``
    returns the send slab of every block at local ``start`` (K2's layout of
    a field of stacked ``shape``); patch it with the earlier dims' received
    values, then move it between blocks (`Move`; on a PROC_NULL edge the
    block's own slab at ``own``)."""
    from .cuda_halo import halo_write_plain

    torch = _torch()
    block = tuple(int(b) for b in block)
    n = block[dim]
    D = shape[dim] // n

    def slab(start):
        s = get_slab(start)
        for e, hw_e, (rl, rr) in earlier:
            rl_s = _slab_view(rl, dim, n, start, hw).flatten(dim, dim + 1)
            rr_s = _slab_view(rr, dim, n, start, hw).flatten(dim, dim + 1)
            halo_write_plain(s, rl_s.contiguous(), rr_s.contiguous(), dim=e, hw=hw_e,
                             block=block[e])
        return s.unflatten(dim, (D, hw))

    out = []
    for m in moves:
        src = torch.arange(D, device=device) + int(m.shift)
        if periodic:
            recv = slab(m.start).index_select(dim, src % D)
        else:
            reached = (src >= 0) & (src < D)
            recv = slab(m.start).index_select(dim, src.clamp(0, D - 1))
            mask = reached.view([-1 if d == dim else 1 for d in range(len(shape) + 1)])
            recv = torch.where(mask, recv, slab(m.own))
        out.append(recv.flatten(dim, dim + 1).contiguous())
    return tuple(out)


def exchange_slabs_plain(A, dim, hw, moves, *, block, periodic, earlier=(),
                         Cp=None, consts=None):
    """Plain PyTorch version of K4s (same arguments as `exchange_slabs`),
    the JAX package's slab pipeline for one dim: get the slab (a slice, or
    `update_slab_plain` with ``Cp``), patch it with the earlier dims'
    received values, then move it between blocks."""
    torch = _torch()
    block = tuple(int(b) for b in block)
    n = block[dim]

    def get_slab(start):
        if Cp is None:
            return _slab_view(A, dim, n, start, hw).flatten(dim, dim + 1).clone(
                memory_format=torch.contiguous_format)
        return update_slab_plain(A, Cp, dim, start, hw, block=block, **consts)

    return move_slabs_plain(get_slab, tuple(A.shape), A.device, dim, hw, moves,
                            block=block, periodic=periodic, earlier=earlier)


def _shape3(shape):
    """The 3-D layout the kernels take for a stacked shape: (S0, S1, S2);
    2-D (S0, S1) as (S0, 1, S1), so that the 2-D y derivative runs along
    the contiguous axis in the z slot; 1-D (S0,) as (S0, 1, 1)."""
    shape = tuple(int(s) for s in shape)
    return {3: shape, 2: (shape[0], 1, shape[-1]), 1: (shape[0], 1, 1)}[len(shape)]


def _dim3(d, ndim):
    return d if ndim == 3 else (0, 2)[d]


def _check_slabs(A, dim, hw, moves, block, earlier, Cp, consts):
    torch = _torch()
    if not isinstance(A, torch.Tensor) or not 1 <= A.dim() <= 3 or not A.is_contiguous():
        raise InvalidArgumentError("exchange_slabs needs a contiguous 1-D to 3-D tensor.")
    block = tuple(int(b) for b in block)
    if len(block) != A.dim() or any(b < 1 or s % b for s, b in zip(A.shape, block)):
        raise InvalidArgumentError(
            f"exchange_slabs: block {block} does not tile {tuple(A.shape)}.")
    dim, hw = int(dim), int(hw)
    if not (0 <= dim < A.dim()) or hw < 1 or not 1 <= len(moves) <= 2:
        raise InvalidArgumentError(
            f"exchange_slabs: dim {dim}, hw {hw}, {len(moves)} moves unsupported.")
    n = block[dim]
    for m in moves:
        if not (0 <= m.start <= n - hw and 0 <= m.own <= n - hw):
            raise InvalidArgumentError(
                f"exchange_slabs: slab {m} of width {hw} leaves a block of {n}.")
    if len(earlier) > 2 or any(e == dim for e, _, _ in earlier):
        raise InvalidArgumentError("exchange_slabs: at most two earlier dims, not dim itself.")
    for e, hw_e, pair in earlier:
        want = list(A.shape)
        want[e] = A.shape[e] // block[e] * int(hw_e)
        for s in pair:
            if (list(s.shape) != want or s.dtype != A.dtype or s.device != A.device
                    or not s.is_contiguous()):
                raise InvalidArgumentError(
                    f"exchange_slabs: earlier slabs of dim {e} must be contiguous "
                    f"{tuple(want)} {A.dtype}; got {tuple(s.shape)} {s.dtype}.")
    if Cp is not None:
        if A.dim() == 1:
            raise InvalidArgumentError("exchange_slabs: the step runs on 2-D and 3-D fields.")
        _check_state(A, Cp, A.dim(), block, None, "exchange_slabs")
        if consts is None:
            raise InvalidArgumentError("exchange_slabs: a step slab needs its constants.")
    return dim, hw, block


def exchange_slabs(A, dim, hw, moves, *, block, periodic, earlier=(), Cp=None,
                   consts=None):
    """K4s: the received slabs of width ``hw`` along ``dim`` for every block
    of stacked ``A`` (blocks of shape ``block``), one for each `Move`, in
    one launch. Each is the send slab of the source block: a copy of ``A``
    (``Cp`` None) or the updated state of a diffusion step (``Cp`` and
    ``consts``, 3-D or 2-D), patched with the slabs that block received
    along ``earlier`` dims (``[(dim, hw, (recv_l, recv_r)), ...]``, in
    exchange order). Returns a tuple of new contiguous slabs in K2's layout
    (the stacked shape with ``dim`` at D*hw)."""
    dim, hw, block = _check_slabs(A, dim, hw, moves, block, earlier, Cp, consts)
    if not _on_card(A):
        return exchange_slabs_plain(A, dim, hw, moves, block=block, periodic=periodic,
                                    earlier=earlier, Cp=Cp, consts=consts)
    torch = _torch()
    nd = A.dim()
    shape = list(A.shape)
    shape[dim] = A.shape[dim] // block[dim] * hw
    outs = [torch.empty(shape, dtype=A.dtype, device=A.device) for _ in moves]
    S3, blk3 = _shape3(A.shape), _shape3(block)
    mv = [tuple(int(x) for x in m) for m in moves] + [(0, 0, 0)] * (2 - len(moves))
    ptrs = [o.data_ptr() for o in outs] + [None] * (2 - len(outs))
    ear = []
    for e, hw_e, (rl, rr) in earlier:
        ear += [_dim3(e, nd), int(hw_e), rl.data_ptr(), rr.data_ptr()]
    ear += [-1, 0, None, None] * (2 - len(earlier))
    c = consts or {}
    mode = 0 if Cp is None else (1 if nd == 3 else 2)
    lib = library()
    with torch.cuda.device(A.device):
        rc = lib.igg_exchange_slabs(
            mode, _dtype_code(A.dtype) if mode else 0, A.element_size(),
            A.data_ptr(), None if Cp is None else Cp.data_ptr(), *ptrs,
            *S3, *blk3, _dim3(dim, nd), hw, int(bool(periodic)),
            *mv[0], *mv[1], *ear,
            *(float(c.get(k, 1.0)) for k in ("lam", "dt", "dx", "dy", "dz")),
            _stream(A))
    check_rc(rc, "exchange_slabs")
    count_launch("exchange_slabs", f"{('copy', 'step', 'step2d')[mode]}/{dim}")
    return tuple(outs)


def update_slab(T, Cp, dim, starts, size, *, block, lam, dt, dx, dy, dz=1.0):
    """The updated state on ``[start, start+size)`` along ``dim`` of every
    block, for each of ``starts`` (K4s with the identity move, two ranges a
    launch); returns a list of slabs. Cells on a block's boundary keep
    their input."""
    consts = dict(lam=lam, dt=dt, dx=dx, dy=dy, dz=dz)
    moves = [Move(int(s), int(s), 0) for s in starts]
    out = []
    for k in range(0, len(moves), 2):
        out += exchange_slabs(T, dim, size, moves[k:k + 2], block=block, periodic=True,
                              Cp=Cp, consts=consts)
    return out


# ---------------------------------------------------------------------------
# K4 and K5: the step plus the delivery of received slabs.
# ---------------------------------------------------------------------------

def _check_recvs(T, recvs, block, name):
    """Received slabs of halowidth 1 in K2's layout, for dims < T.dim()."""
    for d, pair in recvs.items():
        if not 0 <= d < T.dim() or len(pair) != 2:
            raise InvalidArgumentError(f"{name}: no dim {d} in a {T.dim()}-D field.")
        want = list(T.shape)
        want[d] = T.shape[d] // block[d]
        for s in pair:
            if (list(s.shape) != want or s.dtype != T.dtype or s.device != T.device
                    or not s.is_contiguous()):
                raise InvalidArgumentError(
                    f"{name}: the slabs of dim {d} must be contiguous {tuple(want)} "
                    f"{T.dtype} on {T.device}; got {tuple(s.shape)} {s.dtype}.")
            if s.untyped_storage().data_ptr() == T.untyped_storage().data_ptr():
                raise InvalidArgumentError(f"{name}: a slab must not alias T.")
        if block[d] < 2:
            raise InvalidArgumentError(f"{name}: halos overlap in blocks of {block[d]}.")


def diffusion3d_step_recv_plain(T, Cp, recvs, *, lam, dt, dx, dy, dz, block=None,
                                out=None):
    """Plain PyTorch version of K4: K1's unfused step, then the received
    slabs written in the z, x, y order."""
    from .cuda_halo import halo_write_plain

    block = tuple(T.shape) if block is None else tuple(int(b) for b in block)
    out = diffusion3d_step_halo_plain(T, Cp, lam=lam, dt=dt, dx=dx, dy=dy, dz=dz,
                                      fuse=(False, False, False), block=block, out=out)
    for d in (2, 0, 1):
        if d in recvs:
            halo_write_plain(out, *recvs[d], dim=d, hw=1, block=block[d])
    return out


def diffusion3d_step_recv(T, Cp, recvs, *, lam, dt, dx, dy, dz, block=None, out=None):
    """K4: one diffusion step of every block of stacked ``T`` with the
    received slabs ``recvs`` (``{dim: (recv_l, recv_r)}``, halowidth 1, K2's
    layout) delivered in the same pass: a y-halo row takes its received
    value, else an x-halo plane, else a z-halo lane. Out of place."""
    block = _check_state(T, Cp, 3, block, out, "diffusion3d_step_exchange")
    _check_recvs(T, recvs, block, "diffusion3d_step_exchange")
    if not _on_card(T):
        return diffusion3d_step_recv_plain(T, Cp, recvs, lam=lam, dt=dt, dx=dx, dy=dy,
                                           dz=dz, block=block, out=out)
    torch = _torch()
    if out is None:
        out = torch.empty_like(T)
    slabs = [p.data_ptr() if d in recvs else None
             for d in (0, 1, 2) for p in recvs.get(d, (None, None))]
    lib = library()
    with torch.cuda.device(T.device):
        rc = lib.igg_diffusion3d_step_exchange(
            _dtype_code(T.dtype), T.data_ptr(), Cp.data_ptr(), out.data_ptr(),
            *(int(s) for s in T.shape), *block,
            float(lam), float(dt), float(dx), float(dy), float(dz), *slabs, _stream(T))
    check_rc(rc, "diffusion3d_step_exchange")
    count_launch("diffusion3d_step_exchange")
    return out


def diffusion2d_step_recv_plain(T, Cp, recvs, *, lam, dt, dx, dy, block=None, out=None):
    """Plain PyTorch version of K5: the 2-D step of every block in
    `_stencil_row`'s order, then the received x rows, then the y lanes."""
    from .cuda_halo import halo_write_plain

    torch = _torch()
    block = tuple(T.shape) if block is None else tuple(int(b) for b in block)
    consts = _consts(T.dtype, T.device, lam=lam, dt=dt, dx=dx, dy=dy)
    if out is None:
        out = torch.empty_like(T)
    for sl in block_slices(T.shape, block):
        out[sl] = _step_block_plain(T[sl], Cp[sl], consts)
    for d in (0, 1):
        if d in recvs:
            halo_write_plain(out, *recvs[d], dim=d, hw=1, block=block[d])
    return out


def diffusion2d_step_recv(T, Cp, recvs, *, lam, dt, dx, dy, block=None, out=None):
    """K5: one 2-D diffusion step of every block of stacked ``T`` with the
    received slabs ``recvs`` (``{dim: (recv_l, recv_r)}``, halowidth 1)
    delivered in the same pass: y lanes over x rows over the computed
    value. ``recvs`` may be empty: the step alone. Out of place."""
    block = _check_state(T, Cp, 2, block, out, "diffusion2d_step_exchange")
    _check_recvs(T, recvs, block, "diffusion2d_step_exchange")
    if not _on_card(T):
        return diffusion2d_step_recv_plain(T, Cp, recvs, lam=lam, dt=dt, dx=dx, dy=dy,
                                           block=block, out=out)
    torch = _torch()
    if out is None:
        out = torch.empty_like(T)
    slabs = [p.data_ptr() if d in recvs else None
             for d in (0, 1) for p in recvs.get(d, (None, None))]
    lib = library()
    with torch.cuda.device(T.device):
        rc = lib.igg_diffusion2d_step_exchange(
            _dtype_code(T.dtype), T.data_ptr(), Cp.data_ptr(), out.data_ptr(),
            *(int(s) for s in T.shape), *block,
            float(lam), float(dt), float(dx), float(dy), *slabs, _stream(T))
    check_rc(rc, "diffusion2d_step_exchange")
    count_launch("diffusion2d_step_exchange")
    return out


def _recv_slabs(T, Cp, gg, modes, block, consts):
    """The received slabs of the fused step: send slabs by K4s from the
    current state, through the exchange pipeline and the halo wire format
    of ``IGG_HALO_WIRE_DTYPE`` (as the JAX package's fused tiers read it)."""
    from .halo import exchange_recv_slabs
    from .precision import resolve_wire_dtype

    def slab_fn(dim, hw, moves, periodic, earlier):
        return exchange_slabs(T, dim, hw, moves, block=block, periodic=periodic,
                              earlier=earlier, Cp=Cp, consts=consts)

    return exchange_recv_slabs(gg, block, (1,) * T.dim(), modes, slab_fn,
                               wire=resolve_wire_dtype(None))


def diffusion3d_step_exchange(T, Cp, gg, modes, *, lam, dt, dx, dy, dz, block=None,
                              out=None):
    """Fused diffusion step + full halo exchange of every block of stacked
    ``T`` (`diffusion3d_step_exchange_pallas`): the send slabs (K4s, one
    launch per exchanging dim), then K4. ``modes`` from
    `step_exchange_modes`."""
    block = tuple(T.shape) if block is None else tuple(int(b) for b in block)
    consts = dict(lam=lam, dt=dt, dx=dx, dy=dy, dz=dz)
    recvs = _recv_slabs(T, Cp, gg, modes, block, consts)
    return diffusion3d_step_recv(T, Cp, recvs, block=block, out=out, **consts)


def diffusion2d_step_exchange(T, Cp, gg, modes, *, lam, dt, dx, dy, block=None,
                              out=None):
    """The 2-D form of `diffusion3d_step_exchange`
    (`diffusion2d_step_exchange_pallas`): K4s, then K5. ``modes`` (False,
    False) is the step alone."""
    block = tuple(T.shape) if block is None else tuple(int(b) for b in block)
    consts = dict(lam=lam, dt=dt, dx=dx, dy=dy)
    recvs = _recv_slabs(T, Cp, gg, tuple(modes)[:2] + (False,), block, consts)
    return diffusion2d_step_recv(T, Cp, recvs, block=block, out=out, **consts)


def step_bytes(T) -> int:
    """Least bytes the step must move: read T and Cp once, write T once."""
    return 3 * int(np.prod(T.shape)) * T.element_size()
