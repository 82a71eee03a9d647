"""The calibration kernel of `csrc/calibrate.cu` and its plain version.

`fma_chain` runs ``iters`` x 64 dependent single-rounding multiply-adds
``x <- x * a + b`` on every element of a float32 tensor, in place: the FLOP
rate fit of `telemetry.calibrate.calibrate_machine`. It replaces no TPU
kernel (the JAX package's chain is one fused XLA loop; eager PyTorch would
make each multiply-add a pass over memory). On a CUDA tensor the wrapper
launches the kernel or raises; on a CPU tensor it runs `fma_chain_plain`,
which rounds each multiply-add once through float64 (the product of two
float32 values is exact there) and equals the kernel but where the float64
sum lands on a float32 midpoint (double rounding: one ulp, about once in
2^29 operations).
"""

from __future__ import annotations

from ..utils.exceptions import InvalidArgumentError
from .cuda_build import check_rc, count_launch, library
from .cuda_halo import _on_card, _stream

__all__ = ["fma_chain", "fma_chain_plain", "FMA_PER_ITER"]

FMA_PER_ITER = 64  # dependent multiply-adds an iteration (the JAX package's chain)


def _check(x, iters):
    import torch

    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32 \
            or not x.is_contiguous():
        raise InvalidArgumentError("fma_chain needs a contiguous float32 tensor.")
    if int(iters) < 0:
        raise InvalidArgumentError(f"fma_chain: iters must be >= 0; got {iters}.")


def fma_chain_plain(x, iters: int, a: float, b: float):
    """The plain version: ``iters`` x 64 multiply-adds on ``x`` in place,
    each rounded once to float32 through float64. Returns ``x``."""
    import torch

    _check(x, iters)
    a32 = float(torch.tensor(a, dtype=torch.float32))
    b32 = float(torch.tensor(b, dtype=torch.float32))
    v = x.double()
    for _ in range(int(iters) * FMA_PER_ITER):
        v = (v * a32 + b32).float().double()
    x.copy_(v)
    return x


def fma_chain(x, iters: int, a: float = 1.000001, b: float = 1e-9):
    """``iters`` x 64 dependent multiply-adds ``x * a + b`` on every element
    of float32 ``x``, in place; returns ``x``."""
    _check(x, iters)
    if not _on_card(x):
        return fma_chain_plain(x, iters, a, b)
    import torch

    lib = library()
    with torch.cuda.device(x.device):
        rc = lib.igg_fma_chain(x.data_ptr(), x.numel(), int(iters), float(a), float(b),
                               _stream(x))
    check_rc(rc, "fma_chain")
    count_launch("fma_chain")
    return x
