"""Environment configuration (`IGG_*` flags).

Counterpart of `implicitglobalgrid_tpu/utils/config.py`. The port reads:

- ``IGG_USE_PALLAS`` (+ ``_DIMX/_DIMY/_DIMZ``): the kernel tier. The name is
  kept from the JAX package, where it selects the Pallas kernels; here it
  selects the hand-written CUDA kernels. On by default; ``IGG_USE_PALLAS=0``
  forces the plain PyTorch path (also on the GPU).

Variables that make no sense for this package are rejected with a message,
like the reference rejects its legacy variables.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from .exceptions import InvalidArgumentError

__all__ = ["EnvConfig", "read_env_config"]

_REJECTED_ENV_VARS = {
    "IGG_CUDAAWARE_MPI": "the virtual mesh moves halos device-to-device without MPI.",
    "IGG_ROCMAWARE_MPI": "the virtual mesh moves halos device-to-device without MPI.",
    "IGG_LOOPVECTORIZATION": "Environment variable IGG_LOOPVECTORIZATION is not supported. Use IGG_USE_PALLAS instead.",
    "IGG_USE_POLYESTER": "Environment variable IGG_USE_POLYESTER does not apply here. Use IGG_USE_PALLAS instead.",
}

_DIM_SUFFIXES = ("_DIMX", "_DIMY", "_DIMZ")


def _env_flag(name: str) -> bool | None:
    if name not in os.environ:
        return None
    try:
        return int(os.environ[name]) > 0
    except ValueError as e:
        raise InvalidArgumentError(
            f"Environment variable {name}: expected an integer, got {os.environ[name]!r}."
        ) from e


@dataclass
class EnvConfig:
    # tri-state per dim: None = unset (resolved at init to True), True/False
    # = explicit env setting
    use_pallas: list = field(default_factory=lambda: [None, None, None])


def read_env_config() -> EnvConfig:
    """Read and validate the environment (called from `init_global_grid`)."""
    for var, msg in _REJECTED_ENV_VARS.items():
        if var in os.environ:
            raise InvalidArgumentError(f"Environment variable {var} is not supported: {msg}")
        for sfx in _DIM_SUFFIXES:
            if var + sfx in os.environ:
                raise InvalidArgumentError(f"Environment variable {var + sfx} is not supported: {msg}")

    cfg = EnvConfig()
    g = _env_flag("IGG_USE_PALLAS")
    if g is not None:
        cfg.use_pallas = [g, g, g]
    for d, sfx in enumerate(_DIM_SUFFIXES):
        v = _env_flag("IGG_USE_PALLAS" + sfx)
        if v is not None:
            cfg.use_pallas[d] = v
    return cfg
