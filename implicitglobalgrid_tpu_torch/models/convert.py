"""Carry a model state from the JAX package into the port.

The system has no weights; its "weights" are the state and the parameters.
`state_from_numpy` (diffusion), `acoustic_state_from_numpy` and
`stokes_state_from_numpy` take the JAX package's stacked arrays as numpy (``np.asarray(T)``) and its parameters as
a dict (``dataclasses.asdict(p)``) and return the port's stacked tensors and
parameters. They import nothing of JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .acoustic import AcousticParams
from .diffusion import DiffusionParams
from .stokes import StokesParams

__all__ = ["state_from_numpy", "acoustic_state_from_numpy", "stokes_state_from_numpy"]


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


def _params(cls, params: dict):
    """``cls`` from a parameter dict (unknown keys are ignored; the JAX
    package stores ``comm_every`` as the string "1")."""
    names = {f.name for f in dataclasses.fields(cls)}
    kw = {k: v for k, v in params.items() if k in names}
    if str(kw.get("comm_every", 1)) == "1":
        kw["comm_every"] = 1
    return cls(**kw)


def state_from_numpy(T, Cp, params: dict, device):
    """``(T, Cp, DiffusionParams)`` on ``device`` from numpy arrays and a
    parameter dict (unknown keys are ignored)."""
    p = _params(DiffusionParams, params)
    return _tensor_from_numpy(T, device), _tensor_from_numpy(Cp, device), p


def acoustic_state_from_numpy(P, Vx, Vy, Vz, params: dict, device):
    """``((P, Vx, Vy, Vz), AcousticParams)`` on ``device`` from the JAX
    package's stacked numpy arrays and a parameter dict."""
    p = _params(AcousticParams, params)
    return tuple(_tensor_from_numpy(a, device) for a in (P, Vx, Vy, Vz)), p


def stokes_state_from_numpy(P, Vx, Vy, Vz, dVx, dVy, dVz, rhog, params: dict, device):
    """``((P, Vx, Vy, Vz, dVx, dVy, dVz, rhog), StokesParams)`` on ``device``
    from the JAX package's stacked numpy arrays and a parameter dict."""
    p = _params(StokesParams, params)
    return tuple(_tensor_from_numpy(a, device)
                 for a in (P, Vx, Vy, Vz, dVx, dVy, dVz, rhog)), p
