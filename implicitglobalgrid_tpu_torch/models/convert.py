"""Carry a diffusion state from the JAX package into the port.

The system has no weights; its "weights" are the state and the parameters.
`state_from_numpy` takes the JAX package's stacked arrays as numpy
(``np.asarray(T)``) and its parameters as a dict
(``dataclasses.asdict(p)``) and returns the port's stacked tensors and
`DiffusionParams`. It imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .diffusion import DiffusionParams, check_supported

__all__ = ["state_from_numpy"]


def _tensor_from_numpy(a, device):
    """A contiguous tensor on ``device`` with ``a``'s values and dtype;
    numpy bfloat16 (an extension dtype) is carried bit for bit."""
    import torch

    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device).contiguous()


def state_from_numpy(T, Cp, params: dict, device):
    """``(T, Cp, DiffusionParams)`` on ``device`` from numpy arrays and a
    parameter dict (unknown keys are ignored)."""
    names = {f.name for f in dataclasses.fields(DiffusionParams)}
    kw = {k: v for k, v in params.items() if k in names}
    if str(kw.get("comm_every", 1)) == "1":  # the JAX package stores "1"
        kw["comm_every"] = 1
    p = DiffusionParams(**kw)
    check_supported(p)
    return _tensor_from_numpy(T, device), _tensor_from_numpy(Cp, device), p
