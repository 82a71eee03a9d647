"""On-device elastic resharding.

Counterpart of `implicitglobalgrid_tpu/reshard/`. An elastic ``dims`` change
as a scheduled move on the card instead of a disk round trip:
`build_reshard_plan` derives the exact block-overlap transfer plan from the
same implicit-global-grid block arithmetic the checkpoint-based elastic
restore uses (`utils.checkpoint.AxisRedistribution`, one copy of the math)
and schedules it into partial-permutation rounds; `reshard_state` runs it as
block-view copies on the card (`reshard.program`) and re-initializes the
grid, bitwise `restore_checkpoint_elastic` (which stays the verified
fallback and the oracle).

The move is contract-audited (`reshard_contract` / `audit_reshard_program`,
the golden dump of the JAX package's program parses and checks here too),
priced statically (`telemetry.predict_reshard`) and surfaced in the driver
as `runtime.ResilientRun.resize(dims)`.
"""

from .plan import (
    Piece, ReshardPlan, Round, SigPlan, apply_plan_host,
    build_reshard_plan, fields_of_state, live_topology, reshard_contract,
)
from .program import (
    ReshardProgram, audit_reshard_program, clear_program_cache,
    compile_reshard_program, reshard_state,
)

__all__ = [
    "ReshardPlan", "SigPlan", "Round", "Piece",
    "build_reshard_plan", "live_topology", "fields_of_state",
    "apply_plan_host", "reshard_contract",
    "ReshardProgram", "reshard_state", "compile_reshard_program",
    "audit_reshard_program", "clear_program_cache",
]
