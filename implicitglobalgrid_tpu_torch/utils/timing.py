"""Synchronized timing: `tic`/`toc`/`barrier`/`sync`.

Counterpart of `implicitglobalgrid_tpu/utils/timing.py`. PyTorch enqueues
CUDA work and returns, so every barrier here synchronizes the grid's CUDA
device before the host clock is read; where a process group is up, `tic`
then waits for every process (`transport.barrier`), and `toc` returns the
longest span over the processes (`transport.all_max`), so that a span
covers the slowest process.
"""

from __future__ import annotations

import time

from ..parallel.topology import check_initialized, global_grid, grid_is_initialized

__all__ = ["tic", "toc", "barrier", "sync", "init_timing_functions"]

_t0 = None


def _device_barrier(processes: bool = False) -> None:
    """Drain the grid's device; with ``processes``, then wait for every
    process of the grid (COLLECTIVE)."""
    import torch

    if grid_is_initialized():
        gg = global_grid()
        if gg.device.type == "cuda":
            torch.cuda.synchronize(gg.device)
        if processes:
            gg.transport.barrier()
    elif torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def sync(tree):
    """Wait until every computation queued on the grid's device has
    finished, and return ``tree`` (any tensors or containers of them)."""
    _device_barrier()
    return tree


def barrier(sync_on=None) -> None:
    """Block until the grid's device has drained its queue and every process
    has reached the barrier. ``sync_on`` is accepted for API parity: the
    whole device is synchronized. COLLECTIVE."""
    check_initialized()
    _device_barrier(processes=True)


def tic(sync_on=None) -> None:
    """Start the chronometer once the device has drained and every process
    has reached it. COLLECTIVE."""
    global _t0
    check_initialized()
    _device_barrier(processes=True)
    _t0 = time.perf_counter()


def toc(sync_on=None) -> float:
    """Seconds since `tic`, read once the CUDA stream has drained: the
    longest such span over the processes, so every process returns one
    span that covers the slowest (a process that leaves `tic`'s barrier
    late still reports the span of one that left it early). COLLECTIVE."""
    check_initialized()
    if _t0 is None:
        from .exceptions import InvalidArgumentError

        raise InvalidArgumentError(
            "toc() called with no running chronometer: call tic() first "
            "(finalize_global_grid resets it).")
    _device_barrier()
    span = time.perf_counter() - _t0
    return global_grid().transport.all_max([span])[0]


def init_timing_functions() -> None:
    """Run the pair once at init, like the JAX package pre-compiles it."""
    tic()
    toc()
