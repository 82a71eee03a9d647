"""The resilient runtime's parts that stand alone: the health guard computed
after each chunk (`health`), fault injection (`faults`) and the recovery
policy with the elastic restart (`recovery`).

Counterpart of `implicitglobalgrid_tpu/runtime/`; its supervised run loop
(`run_resilient`, `ResilientRun`, `RunSpec`) is not ported yet.
"""

from .faults import (
    CheckpointCorruption, NaNPoke, ProcessLoss, corrupt_checkpoint,
    poke_nan,
)
from .health import GuardConfig, HealthReport, make_guarded_runner
from .recovery import RecoveryPolicy, elastic_restart

__all__ = [
    "GuardConfig", "HealthReport", "make_guarded_runner",
    "RecoveryPolicy", "elastic_restart",
    "NaNPoke", "CheckpointCorruption", "ProcessLoss",
    "poke_nan", "corrupt_checkpoint",
]
