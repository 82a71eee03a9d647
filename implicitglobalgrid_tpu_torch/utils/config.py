"""Environment configuration (`IGG_*` flags).

Counterpart of `implicitglobalgrid_tpu/utils/config.py`. The port reads:

- ``IGG_USE_PALLAS`` (+ ``_DIMX/_DIMY/_DIMZ``): the kernel tier. The name is
  kept from the JAX package, where it selects the Pallas kernels; here it
  selects the hand-written CUDA kernels. On by default; ``IGG_USE_PALLAS=0``
  forces the plain PyTorch path (also on the GPU).
- ``IGG_TPU_DCN_AXES`` ("z", "y,z"): the grid axes that processes split
  (`parallel.mesh.process_layout`), as the JAX package lays slices out.
- ``IGG_TPU_DCN_GRANULES`` ("z:2"): the granule count a single-process grid
  declares per axis (`GlobalGrid.dcn_granules`).

Variables that make no sense for this package are rejected with a message,
like the reference rejects its legacy variables.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from .exceptions import InvalidArgumentError

__all__ = ["EnvConfig", "read_env_config"]

_REJECTED_ENV_VARS = {
    "IGG_CUDAAWARE_MPI": "halos move through torch.distributed, not MPI.",
    "IGG_ROCMAWARE_MPI": "halos move through torch.distributed, not MPI.",
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
    dcn_axes: tuple = ()                   # IGG_TPU_DCN_AXES
    dcn_granules: tuple = (1, 1, 1)        # IGG_TPU_DCN_GRANULES


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
    cfg.dcn_axes = _dcn_axes()
    cfg.dcn_granules = _dcn_granules()
    return cfg


def _dcn_axes() -> tuple:
    """``IGG_TPU_DCN_AXES``: axis names x, y, z, comma separated."""
    axes = os.environ.get("IGG_TPU_DCN_AXES", "")
    names = tuple(a.strip() for a in axes.split(",") if a.strip())
    bad = [a for a in names if a not in ("x", "y", "z")]
    if bad:
        raise InvalidArgumentError(
            f"Environment variable IGG_TPU_DCN_AXES: invalid axis name(s) {bad}; valid "
            "names are x, y, z.")
    if len(set(names)) != len(names):
        raise InvalidArgumentError(
            f"Environment variable IGG_TPU_DCN_AXES: duplicate axis name(s) in {names}.")
    return names


def _dcn_granules() -> tuple:
    """``IGG_TPU_DCN_GRANULES``: ``<axis>:<count>`` entries, comma separated."""
    per_dim = [1, 1, 1]
    seen = set()
    for part in os.environ.get("IGG_TPU_DCN_GRANULES", "").split(","):
        part = part.strip()
        if not part:
            continue
        if ":" not in part:
            raise InvalidArgumentError(
                f"Environment variable IGG_TPU_DCN_GRANULES: entry {part!r} must be "
                "'<axis>:<count>' (e.g. 'z:2').")
        axis, cnt = (v.strip() for v in part.split(":", 1))
        dim = {"x": 0, "y": 1, "z": 2}.get(axis)
        if dim is None:
            raise InvalidArgumentError(
                f"Environment variable IGG_TPU_DCN_GRANULES: invalid axis name {axis!r}; "
                "valid names are x, y, z.")
        if dim in seen:
            raise InvalidArgumentError(
                f"Environment variable IGG_TPU_DCN_GRANULES: duplicate axis name {axis!r}.")
        seen.add(dim)
        try:
            n = int(cnt)
        except ValueError as e:
            raise InvalidArgumentError(
                f"Environment variable IGG_TPU_DCN_GRANULES: granule count for axis {axis!r} "
                f"must be an integer >= 1, got {cnt!r}.") from e
        if n < 1:
            raise InvalidArgumentError(
                f"Environment variable IGG_TPU_DCN_GRANULES: granule count for axis {axis!r} "
                f"must be >= 1, got {n}.")
        per_dim[dim] = n
    return tuple(per_dim)
