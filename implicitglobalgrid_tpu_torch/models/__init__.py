"""Models on the grid's stacked boxes: 3-D/2-D heat diffusion, the 3-D acoustic
wave and the 3-D pseudo-transient Stokes solver."""

from .common import ensemble_partition_spec, ensemble_state
from .diffusion import (
    DiffusionParams, diffusion_step_local, init_diffusion2d, init_diffusion3d,
    make_run, make_run_deep, make_run_sr, make_step, run_diffusion,
)
from .acoustic import (
    AcousticParams, acoustic_step_local, init_acoustic3d, make_acoustic_run,
    make_acoustic_run_deep, run_acoustic,
)
from .stokes import (
    StokesParams, init_stokes3d, make_stokes_run, make_stokes_run_deep, run_stokes,
    stokes_residuals, stokes_step_local,
)
from .convert import acoustic_state_from_numpy, state_from_numpy, stokes_state_from_numpy

__all__ = ["DiffusionParams", "init_diffusion3d", "init_diffusion2d",
           "diffusion_step_local", "make_step", "make_run", "make_run_deep", "make_run_sr",
           "run_diffusion",
           "AcousticParams", "init_acoustic3d", "acoustic_step_local",
           "make_acoustic_run", "make_acoustic_run_deep", "run_acoustic",
           "StokesParams", "init_stokes3d", "stokes_step_local", "make_stokes_run",
           "make_stokes_run_deep", "run_stokes", "stokes_residuals",
           "state_from_numpy", "acoustic_state_from_numpy", "stokes_state_from_numpy",
           "ensemble_partition_spec", "ensemble_state"]
