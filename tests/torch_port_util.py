"""Shared helpers of the PyTorch-port parity tests (`tests/test_torch_*.py`).

Each test file imports `clean_torch_grid` (an autouse fixture) so that no
grid of the port leaks between tests; the JAX grid is cleaned by
`conftest.py`.
"""

import os
import pathlib

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _worker_threads():
    """The torch threads of a pytest-xdist worker (the tier-1 run: several
    workers on one host's cores): an equal share of the cores; None outside
    xdist. torch's OpenMP threads spin while they wait for each other, so
    workers that each start one a core thrash: the three example files side
    by side on three workers ran over ten minutes at the default, 96 s at two
    threads a worker."""
    n = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 0)
    return max(1, (os.cpu_count() or 1) // n) if n > 1 else None


WORKER_THREADS = _worker_threads()
if WORKER_THREADS is not None:
    import torch

    torch.set_num_threads(WORKER_THREADS)


def child_env(env: dict) -> dict:
    """``env`` for a subprocess a test starts: under xdist its OpenMP threads
    are the worker's share too."""
    if WORKER_THREADS is None:
        return env
    return dict(env, OMP_NUM_THREADS=str(WORKER_THREADS))


@pytest.fixture(autouse=True)
def clean_torch_grid():
    import implicitglobalgrid_tpu_torch as tg

    if tg.grid_is_initialized():
        tg.finalize_global_grid()
    yield
    if tg.grid_is_initialized():
        tg.finalize_global_grid()


def to_np(t) -> np.ndarray:
    """Host numpy copy of a tensor (bfloat16 widened to float32)."""
    import torch

    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def init_both(*args, nranks=8, **kw):
    """Init the JAX grid (8 CPU devices) and the port's grid (``nranks``
    virtual ranks, CPU) with the same arguments."""
    import implicitglobalgrid_tpu as igg
    import implicitglobalgrid_tpu_torch as tg

    igg.init_global_grid(*args, quiet=True, **kw)
    tg.init_global_grid(*args, quiet=True, nranks=nranks, device_type="cpu", **kw)


def stacked_from_global_index(n, ol, dims, periods, fn):
    """A whole-grid stacked numpy array whose every cell is ``fn(gx, gy, gz)``
    of its INTEGER global index (`tests/test_comm_avoid.py`'s
    `_stacked_per_dim`): the same value lands on the same physical cell
    whatever the overlap, so halos, overlapping faces of staggered fields and
    two decompositions of one implicit grid all start consistent. Per dim:
    ``g = ix + b*(n-ol)``; a periodic dim shifts by one ghost cell and wraps
    ``g`` modulo the global size. ``n`` and ``ol`` are per dim; a staggered
    field passes ``n + 1`` and ``ol + 1`` along its face dim."""
    S = np.zeros(tuple(d * m for d, m in zip(dims, n)))

    def gidx(b, d):
        g = np.arange(n[d]) + b * (n[d] - ol[d])
        if periods[d]:
            g = (g - 1) % (dims[d] * (n[d] - ol[d]))
        return g

    for bx in range(dims[0]):
        for by in range(dims[1]):
            for bz in range(dims[2]):
                S[bx * n[0]:(bx + 1) * n[0], by * n[1]:(by + 1) * n[1],
                  bz * n[2]:(bz + 1) * n[2]] = fn(
                      gidx(bx, 0)[:, None, None], gidx(by, 1)[None, :, None],
                      gidx(bz, 2)[None, None, :])
    return S


def example_env() -> dict:
    """The environment of an example run as a subprocess from the repository
    root's package: no JAX flags, no process-group variables."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "MASTER_ADDR", "WORLD_SIZE")}
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return child_env(env)
