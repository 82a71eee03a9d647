"""Shared helpers of the PyTorch-port parity tests (`tests/test_torch_*.py`).

Each test file imports `clean_torch_grid` (an autouse fixture) so that no
grid of the port leaks between tests; the JAX grid is cleaned by
`conftest.py`.
"""

import numpy as np
import pytest


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
