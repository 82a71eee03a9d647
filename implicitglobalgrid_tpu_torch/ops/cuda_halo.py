"""The halo copy kernels K2, K3 and K6 (`csrc/halo.cu`) and their plain versions.

Counterpart of `implicitglobalgrid_tpu/ops/pallas_halo.py` for the entry
points on this slice's path:

- `halo_write` (K2) for `halo_write_inplace`: write received slabs of width
  ``hw`` into the left and right halos of every block along ``dim``, in
  place. The TPU kernel serves dims 0 and 1 (dim 2 is a lane-tiling
  artefact there); K2 serves all three.
- `halo_self_exchange` (K3) for `halo_self_exchange_pallas`: every
  self-neighbour halo (halowidth 1) of every block in one read+write pass,
  out of place.
- `halo_write_combined` (K6) for `halo_write_combined_pallas`: every
  exchanging dim's received slabs into every block's halos in one launch,
  in place, touching only halo cells.

Both are pure copies and match their plain versions bitwise. On a CUDA
tensor the wrapper launches the kernel (or raises); on a CPU tensor it runs
the plain version.
"""

from __future__ import annotations

from ..utils.exceptions import InvalidArgumentError, NotSupportedError
from .cuda_build import check_rc, count_launch, library
from .fields import block_slices

__all__ = ["halo_write_supported", "halo_write", "halo_write_plain",
           "self_exchange_supported", "halo_self_exchange",
           "halo_self_exchange_plain", "combined_write_supported",
           "halo_write_combined", "halo_write_combined_plain"]


def halo_write_supported(shape, dim: int, hw: int) -> bool:
    """Whether `halo_write` takes halos of width ``hw`` along ``dim`` of a
    block of this LOCAL shape: 1-D to 3-D with disjoint left and right
    halos. (The TPU kernel is 3-D only, a tiling matter; a 1-D or 2-D field
    runs here as a 3-D one with unit trailing dims.)"""
    return 1 <= len(shape) <= 3 and 0 <= dim < len(shape) \
        and int(shape[dim]) >= 2 * int(hw)


def _check_write(a, slab_l, slab_r, dim, hw, block):
    import torch

    if not all(isinstance(x, torch.Tensor) for x in (a, slab_l, slab_r)):
        raise InvalidArgumentError("halo_write takes torch tensors.")
    if not 1 <= a.dim() <= 3 or not a.is_contiguous():
        raise InvalidArgumentError("halo_write needs a contiguous 1-D to 3-D tensor.")
    dim, hw = int(dim), int(hw)
    if not 0 <= dim < a.dim():
        raise InvalidArgumentError(f"halo_write: no dim {dim} in shape {tuple(a.shape)}.")
    n = int(a.shape[dim]) if block is None else int(block)
    if hw < 1 or n < 1 or a.shape[dim] % n:
        raise InvalidArgumentError(
            f"halo_write: dim {dim}, hw {hw}, block {n} do not fit shape "
            f"{tuple(a.shape)}.")
    if not halo_write_supported(tuple(a.shape[:dim]) + (n,) + tuple(a.shape[dim + 1:]),
                                dim, hw):
        raise InvalidArgumentError(
            f"halo_write: halos of width {hw} overlap in blocks of {n} along dim {dim}.")
    want = list(a.shape)
    want[dim] = a.shape[dim] // n * hw
    for s in (slab_l, slab_r):
        if list(s.shape) != want or s.dtype != a.dtype or s.device != a.device \
                or not s.is_contiguous():
            raise InvalidArgumentError(
                f"halo_write: slabs must be contiguous {tuple(want)} {a.dtype} on "
                f"{a.device}; got {tuple(s.shape)} {s.dtype} on {s.device}.")
        if s.untyped_storage().data_ptr() == a.untyped_storage().data_ptr():
            raise InvalidArgumentError("halo_write: a slab must not alias the field.")
    return dim, hw, n


def halo_write_plain(a, slab_l, slab_r, *, dim: int, hw: int, block=None):
    """Plain PyTorch version of K2: slice `copy_` into every block's halos."""
    n = int(a.shape[dim]) if block is None else int(block)
    nb = a.shape[dim] // n
    v = a.unflatten(dim, (nb, n))
    v.narrow(dim + 1, 0, hw).copy_(slab_l.unflatten(dim, (nb, hw)))
    v.narrow(dim + 1, n - hw, hw).copy_(slab_r.unflatten(dim, (nb, hw)))
    return a


def halo_write(a, slab_l, slab_r, *, dim: int, hw: int, block=None):
    """Write ``slab_l`` into the ``[0, hw)`` halo and ``slab_r`` into the
    ``[n-hw, n)`` halo along ``dim`` of every block (length ``block``,
    default the whole extent) of stacked ``a``, in place; returns ``a``.
    Slab ``c`` of width ``hw`` along ``dim`` goes to block ``c``."""
    dim, hw, n = _check_write(a, slab_l, slab_r, dim, hw, block)
    if a.device.type == "cpu":
        return halo_write_plain(a, slab_l, slab_r, dim=dim, hw=hw, block=n)
    if a.device.type != "cuda":
        raise NotSupportedError(f"no kernel for device {a.device}.")
    import torch

    shape = tuple(int(s) for s in a.shape) + (1,) * (3 - a.dim())
    lib = library()
    with torch.cuda.device(a.device):
        rc = lib.igg_halo_write(
            a.element_size(), a.data_ptr(), slab_l.data_ptr(), slab_r.data_ptr(),
            *shape, dim, n, hw,
            torch.cuda.current_stream(a.device).cuda_stream)
    check_rc(rc, "halo_write")
    count_launch("halo_write")
    return a


def self_exchange_supported(shape, modes, hws) -> bool:
    """Whether `halo_self_exchange` can run on a block of this LOCAL shape:
    3-D, at least one participating dim, halowidth 1 on each, and >= 3
    planes when dim 0 participates (the JAX gate of the same name)."""
    if len(shape) != 3 or not any(modes):
        return False
    if any(m and int(h) != 1 for m, h in zip(modes, hws)):
        return False
    return not (modes[0] and int(shape[0]) < 3)


def _self_source(n: int, ol: int, device):
    import torch

    idx = torch.arange(n, device=device)
    idx[0], idx[n - 1] = n - ol, ol - 1
    return idx


def _check_self(a, modes, ols, block):
    import torch

    if not isinstance(a, torch.Tensor) or a.dim() != 3 or not a.is_contiguous():
        raise InvalidArgumentError("halo_self_exchange needs a contiguous 3-D tensor.")
    block = tuple(a.shape) if block is None else tuple(int(b) for b in block)
    modes = tuple(bool(m) for m in modes)
    ols = tuple(int(o) for o in ols)
    if len(block) != 3 or any(b < 1 or s % b for s, b in zip(a.shape, block)):
        raise InvalidArgumentError(
            f"block {block} does not tile the stacked shape {tuple(a.shape)}.")
    if len(modes) != 3 or len(ols) != 3 or not self_exchange_supported(
            block, modes, (1, 1, 1)):
        raise InvalidArgumentError(
            f"halo_self_exchange: modes {modes} unsupported for block {block}.")
    if any(m and not (2 <= o <= n - 1) for m, o, n in zip(modes, ols, block)):
        raise InvalidArgumentError(
            f"halo_self_exchange: overlaps {ols} must lie in [2, n-1] for block {block}.")
    return block, modes, ols


def halo_self_exchange_plain(a, *, modes, ols, block=None):
    """Plain PyTorch version of K3: each block's index remap as
    `index_select`s into a new tensor."""
    import torch

    block, modes, ols = _check_self(a, modes, ols, block)
    out = torch.empty_like(a)
    for sl in block_slices(a.shape, block):
        u = a[sl]
        for d in range(3):
            if modes[d]:
                u = u.index_select(d, _self_source(block[d], ols[d], a.device))
        out[sl] = u
    return out


def halo_self_exchange(a, *, modes, ols, block=None):
    """Exchange every self-neighbour halo (halowidth 1) of every block of
    stacked ``a`` in one pass: ``modes[d]`` flags a periodic single-rank
    dim, ``ols[d]`` its overlap. Out of place: returns a new tensor."""
    block, modes, ols = _check_self(a, modes, ols, block)
    if a.device.type == "cpu":
        return halo_self_exchange_plain(a, modes=modes, ols=ols, block=block)
    if a.device.type != "cuda":
        raise NotSupportedError(f"no kernel for device {a.device}.")
    import torch

    out = torch.empty_like(a)
    lib = library()
    with torch.cuda.device(a.device):
        rc = lib.igg_halo_self_exchange(
            a.element_size(), a.data_ptr(), out.data_ptr(),
            *(int(s) for s in a.shape), *block, *(int(m) for m in modes), *ols,
            torch.cuda.current_stream(a.device).cuda_stream)
    check_rc(rc, "halo_self_exchange")
    count_launch("halo_self_exchange")
    return out


def combined_write_supported(shape, modes, hws) -> bool:
    """Whether `halo_write_combined` delivers the received slabs of a block
    of this LOCAL shape (the JAX gate of the same name): 3-D, dim 2
    exchanging, halowidth 1 on dims 1 and 2, and disjoint dim-0 halos."""
    if len(shape) != 3 or not modes[2]:
        return False
    if (modes[1] and int(hws[1]) != 1) or int(hws[2]) != 1:
        return False
    if modes[0] and int(shape[0]) < 2 * int(hws[0]):
        return False
    return True


def _check_combined(a, recvs, modes, hws, block):
    import torch

    if not isinstance(a, torch.Tensor) or a.dim() != 3 or not a.is_contiguous():
        raise InvalidArgumentError("halo_write_combined needs a contiguous 3-D tensor.")
    block = tuple(int(b) for b in block)
    modes = tuple(bool(m) for m in modes)
    hws = tuple(int(h) for h in hws)
    if len(block) != 3 or any(b < 1 or s % b for s, b in zip(a.shape, block)):
        raise InvalidArgumentError(
            f"block {block} does not tile the stacked shape {tuple(a.shape)}.")
    if not combined_write_supported(block, modes, hws) or any(
            m and block[d] < 2 * hws[d] for d, m in enumerate(modes)):
        raise InvalidArgumentError(
            f"halo_write_combined: modes {modes}, halowidths {hws} unsupported for "
            f"block {block}.")
    for d in range(3):
        if not modes[d]:
            continue
        want = list(a.shape)
        want[d] = a.shape[d] // block[d] * hws[d]
        for s in recvs[d]:
            if (list(s.shape) != want or s.dtype != a.dtype or s.device != a.device
                    or not s.is_contiguous()):
                raise InvalidArgumentError(
                    f"halo_write_combined: the slabs of dim {d} must be contiguous "
                    f"{tuple(want)} {a.dtype}; got {tuple(s.shape)} {s.dtype}.")
            if s.untyped_storage().data_ptr() == a.untyped_storage().data_ptr():
                raise InvalidArgumentError("halo_write_combined: a slab must not alias the field.")
    return block, modes, hws


def halo_write_combined_plain(a, recvs, *, modes, hws, block=None):
    """Plain PyTorch version of K6: K2's plain writes in the z, x, y order."""
    block = tuple(a.shape) if block is None else tuple(int(b) for b in block)
    for d in (2, 0, 1):
        if modes[d]:
            halo_write_plain(a, *recvs[d], dim=d, hw=int(hws[d]), block=block[d])
    return a


def halo_write_combined(a, recvs, *, modes, hws, block=None):
    """Write the received slabs ``recvs[d] = (recv_l, recv_r)`` of every
    dim flagged in ``modes`` (width ``hws[d]``, K2's layout) into the halos
    of every block of stacked ``a``, in one pass, in place; returns ``a``. A
    y-halo row takes its received value, else an x-halo plane, else a
    z-halo lane: the reference's z, x, y write order."""
    block, modes, hws = _check_combined(
        a, recvs, modes, hws, tuple(a.shape) if block is None else block)
    if a.device.type == "cpu":
        return halo_write_combined_plain(a, recvs, modes=modes, hws=hws, block=block)
    if a.device.type != "cuda":
        raise NotSupportedError(f"no kernel for device {a.device}.")
    import torch

    slabs = [p.data_ptr() if modes[d] else None
             for d in range(3) for p in (recvs[d] if modes[d] else (None, None))]
    lib = library()
    with torch.cuda.device(a.device):
        rc = lib.igg_halo_write_combined(
            a.element_size(), a.data_ptr(), *slabs, *(int(s) for s in a.shape), *block,
            hws[0], torch.cuda.current_stream(a.device).cuda_stream)
    check_rc(rc, "halo_write_combined")
    count_launch("halo_write_combined")
    return a
