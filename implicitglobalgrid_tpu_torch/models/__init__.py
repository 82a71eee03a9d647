"""Models on the virtual mesh: 3-D/2-D heat diffusion."""

from .diffusion import (
    DiffusionParams, diffusion_step_local, init_diffusion2d, init_diffusion3d,
    make_run, make_step, run_diffusion,
)
from .convert import state_from_numpy

__all__ = ["DiffusionParams", "init_diffusion3d", "init_diffusion2d",
           "diffusion_step_local", "make_step", "make_run", "run_diffusion",
           "state_from_numpy"]
