"""Static analysis of the collectives a program moves (the communication audit).

Counterpart of `implicitglobalgrid_tpu/analysis/`. The framework's core
claims — the reference's pack/send/recv/unpack machinery collapses into one
collective-permute pair per exchanging mesh axis and exchange round, and the
guard and reducers into exactly one sum per chunk — are checked here:

- `hlo` — `parse_program`/`parse_text`: HLO and StableHLO text -> `ProgramIR`
  (the port's own copy of the parser; the JAX package's golden dumps parse
  here too);
- `record` — the port's counterpart of lowering: `recording()` /
  `record_program` build a ``"record"``-dialect `ProgramIR` from what the
  port's exchange routes, the transport's sum and the gathers move;
- `contracts` — `CollectiveContract` derived from the static wire plan
  (`halo_comm_plan` + `STEP_WORKLOADS` rounds + grid routes) and
  `check_contract`; `perfmodel_crosscheck` proves `predict_step`'s pricing
  against the program;
- `lints` — the implicit-global-grid hazard rules (`LINT_RULES`);
- `audit` — `audit_program` / `audit_model` / `audit_chunk_program`: what the
  tests, the chip smoke and `run_resilient(audit=True)` call.
"""

from .audit import (
    AuditReport, audit_chunk_program, audit_model, audit_program,
)
from .contracts import (
    AuditFinding, CollectiveContract, axis_routes, check_contract,
    exchange_contract, guard_contract, measure_axes, model_contract,
    perfmodel_crosscheck,
)
from .hlo import HloOp, ProgramIR, Shape, parse_program, parse_text
from .lints import (
    DEFAULT_LINTS, LINT_RULES, LintConfig, default_lint_config, run_lints,
)
from .record import Recording, record_program, recording

__all__ = [
    "Shape", "HloOp", "ProgramIR", "parse_text", "parse_program",
    "Recording", "recording", "record_program",
    "AuditFinding", "CollectiveContract", "axis_routes", "measure_axes",
    "exchange_contract", "model_contract", "guard_contract",
    "check_contract", "perfmodel_crosscheck",
    "LintConfig", "default_lint_config", "run_lints", "LINT_RULES",
    "DEFAULT_LINTS",
    "AuditReport", "audit_program", "audit_model", "audit_chunk_program",
]
