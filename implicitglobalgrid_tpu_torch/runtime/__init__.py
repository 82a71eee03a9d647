"""The resilient runtime: supervised long runs over the chunked runner.

Counterpart of `implicitglobalgrid_tpu/runtime/`: the health guard computed
after each chunk (`health`), fault injection (`faults`), the recovery policy
with the elastic restart (`recovery`), and the supervised run loop that
composes them with the checkpoints and snapshots (`driver`: `run_resilient`,
the resumable `ResilientRun`, its knob set `RunSpec`).
"""

from .driver import ResilientRun, run_resilient
from .faults import (
    CheckpointCorruption, NaNPoke, ProcessLoss, corrupt_checkpoint,
    poke_nan,
)
from .health import GuardConfig, HealthReport, make_guarded_runner
from .recovery import RecoveryPolicy, elastic_restart
from .spec import RunSpec

__all__ = [
    "run_resilient", "ResilientRun", "RunSpec",
    "GuardConfig", "HealthReport", "make_guarded_runner",
    "RecoveryPolicy", "elastic_restart",
    "NaNPoke", "CheckpointCorruption", "ProcessLoss",
    "poke_nan", "corrupt_checkpoint",
]
