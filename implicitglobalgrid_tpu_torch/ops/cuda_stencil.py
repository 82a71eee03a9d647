"""The diffusion step kernel K1 (`csrc/stencil.cu`) and its plain version.

Counterpart of `implicitglobalgrid_tpu/ops/pallas_stencil.py` for the
entry points on this slice's path: `diffusion3d_step_halo_pallas`,
`diffusion3d_step_pallas` and `diffusion3d_step_halo_pallas_mp` all compute
one function, which `diffusion3d_step_halo` computes here with one CUDA
kernel. Fields are stacked: ``block`` is the per-rank block shape and every
block is stepped independently (one launch for all of them).

On a CUDA tensor the wrapper launches the kernel (or raises); on a CPU
tensor it runs `diffusion3d_step_halo_plain`, the same function in plain
PyTorch with `_stencil_plane`'s accumulation order.
"""

from __future__ import annotations

import numpy as np

from ..utils.exceptions import InvalidArgumentError, NotSupportedError
from .cuda_build import check_rc, count_launch, library
from .fields import block_slices

__all__ = ["diffusion3d_step_halo", "diffusion3d_step",
           "diffusion3d_step_halo_plain", "pallas_supported",
           "fusable_halo_dims"]


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


def _torch():
    import torch

    return torch


def _dtype_code(dtype) -> int:
    torch = _torch()
    codes = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
    if dtype not in codes:
        raise InvalidArgumentError(
            f"diffusion3d_step_halo takes float32, float64 or bfloat16; got {dtype}.")
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


def _source_index(n: int, fuse: bool, device):
    """Source index of every output index along a dim: with the fused halo
    update, 0 reads n-2 and n-1 reads 1 (`_sigma`)."""
    torch = _torch()
    idx = torch.arange(n, device=device)
    if fuse:
        idx[0], idx[n - 1] = n - 2, 1
    return idx


def _step_block_plain(Tb, Cb, consts, fuse):
    torch = _torch()
    n0, n1, n2 = Tb.shape
    tm = torch.cat([Tb[:1], Tb[:-1]])
    tp = torch.cat([Tb[1:], Tb[-1:]])
    upd = _stencil_plane(tm, Tb, tp, Cb, **consts)
    dev = Tb.device
    ii = torch.arange(n0, device=dev).view(-1, 1, 1)
    jj = torch.arange(n1, device=dev).view(1, -1, 1)
    kk = torch.arange(n2, device=dev).view(1, 1, -1)
    interior = ((ii > 0) & (ii < n0 - 1) & (jj > 0) & (jj < n1 - 1)
                & (kk > 0) & (kk < n2 - 1))
    U = torch.where(interior, upd, Tb)
    for d, n in enumerate((n0, n1, n2)):
        if fuse[d]:
            U = U.index_select(d, _source_index(n, True, dev))
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


def _check_step_args(T, Cp, fuse, block, out):
    torch = _torch()
    if not (isinstance(T, torch.Tensor) and isinstance(Cp, torch.Tensor)):
        raise InvalidArgumentError("diffusion3d_step_halo takes torch tensors.")
    if T.dim() != 3 or tuple(Cp.shape) != tuple(T.shape):
        raise InvalidArgumentError(
            f"T and Cp must be 3-D of one shape; got {tuple(T.shape)} and "
            f"{tuple(Cp.shape)}.")
    _dtype_code(T.dtype)
    if Cp.dtype != T.dtype or Cp.device != T.device:
        raise InvalidArgumentError("T and Cp must share dtype and device.")
    if not (T.is_contiguous() and Cp.is_contiguous()):
        raise InvalidArgumentError("T and Cp must be contiguous.")
    block = tuple(T.shape) if block is None else tuple(int(b) for b in block)
    if len(block) != 3 or any(b < 1 or s % b for s, b in zip(T.shape, block)):
        raise InvalidArgumentError(
            f"block {block} does not tile the stacked shape {tuple(T.shape)}.")
    if not pallas_supported(block):
        raise InvalidArgumentError(
            f"the step kernel needs blocks of >= 3 planes; got {block}.")
    if len(fuse) != 3 or any(f and n < 3 for f, n in zip(fuse, block)):
        raise InvalidArgumentError(
            f"fuse {tuple(fuse)} needs >= 3 cells along each fused dim; block {block}.")
    if out is not None:
        if (tuple(out.shape) != tuple(T.shape) or out.dtype != T.dtype
                or out.device != T.device or not out.is_contiguous()):
            raise InvalidArgumentError("out must be a contiguous tensor like T.")
        if out.data_ptr() in (T.data_ptr(), Cp.data_ptr()):
            raise InvalidArgumentError(
                "out must not alias T or Cp: the step reads T at its neighbours.")
    return block


def diffusion3d_step_halo(T, Cp, *, lam, dt, dx, dy, dz, fuse, block=None,
                          out=None):
    """One diffusion step of every ``block`` of stacked ``T`` (with ``Cp``),
    the halo updates of the dims flagged in ``fuse`` (from
    `fusable_halo_dims`) folded into the output pass. Boundary cells keep
    their input. Out of place: writes ``out`` (allocated when None) and
    returns it."""
    block = _check_step_args(T, Cp, fuse, block, out)
    if T.device.type == "cpu":
        return diffusion3d_step_halo_plain(T, Cp, lam=lam, dt=dt, dx=dx, dy=dy,
                                           dz=dz, fuse=fuse, block=block, out=out)
    if T.device.type != "cuda":
        raise NotSupportedError(f"no kernel for device {T.device}.")
    torch = _torch()
    if out is None:
        out = torch.empty_like(T)
    lib = library()
    with torch.cuda.device(T.device):
        rc = lib.igg_diffusion3d_step_halo(
            _dtype_code(T.dtype), T.data_ptr(), Cp.data_ptr(), out.data_ptr(),
            *(int(s) for s in T.shape), *block,
            float(lam), float(dt), float(dx), float(dy), float(dz),
            *(int(bool(f)) for f in fuse),
            torch.cuda.current_stream(T.device).cuda_stream)
    check_rc(rc, "diffusion3d_step_halo")
    count_launch("diffusion3d_step_halo")
    return out


def diffusion3d_step(T, Cp, *, lam, dt, dx, dy, dz, block=None, out=None):
    """One diffusion step without halo updates: the ``fuse=(F, F, F)`` case
    of `diffusion3d_step_halo` (one kernel, so the accumulation order cannot
    diverge between the two)."""
    return diffusion3d_step_halo(T, Cp, lam=lam, dt=dt, dx=dx, dy=dy, dz=dz,
                                 fuse=(False, False, False), block=block, out=out)


def step_bytes(T) -> int:
    """Least bytes the step must move: read T and Cp once, write T once."""
    return 3 * int(np.prod(T.shape)) * T.element_size()
