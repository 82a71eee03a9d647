"""`RunSpec` — the supervised run's knob set as one value.

Counterpart of `implicitglobalgrid_tpu/runtime/spec.py`, field for field and
default for default: `run_resilient` takes its ~25 keyword knobs
(checkpointing, snapshots, reducers, live metrics, perf oracle, audit,
ensemble, tuning, deadline) either as keywords or pre-packed as one frozen
dataclass whose defaults ARE `run_resilient`'s defaults, which a multi-run
scheduler can embed per job unchanged:

    spec = RunSpec(nt_chunk=50, checkpoint_dir="/ckpt/run42",
                   snapshot_dir="/snaps/run42")
    state, reports = igg.run_resilient(step, state, nt, spec=spec)

Field semantics are documented on `run_resilient` (the single reference).
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Any

__all__ = ["RunSpec"]


@dataclass(frozen=True)
class RunSpec:
    """Every `run_resilient` keyword knob, as one immutable value (defaults
    identical to the function's). Group map:

    - chunking/caching: ``nt_chunk``, ``key``, ``check_vma``, ``unroll``
    - recovery: ``checkpoint_dir``, ``checkpoint_every``, ``guard``,
      ``policy``, ``faults``, ``on_report``
    - io pipeline: ``snapshot_dir``, ``snapshot_every``,
      ``snapshot_fields``, ``snapshot_queue``, ``snapshot_policy``,
      ``reducers``, ``on_reduce``
    - live metrics endpoint: ``metrics_port``, ``healthz_max_age_s``
    - perf oracle: ``perf_model``, ``perf_window``, ``perf_zmax``
    - communication audit: ``audit``, ``audit_lints`` (the recorded first
      chunk of each distinct length against the guard contract and the
      lints, `analysis.audit_chunk_program`)
    - ensemble axis: ``ensemble`` (E scenario members batched through one
      chunk program; every state array leads with the member axis — build
      with `models.common.ensemble_state` — and the guard trips per
      member)
    - deadline: ``deadline_s`` (wall-clock budget from the run's start;
      crossing it fires ONE ``deadline_missed`` flight event + the
      ``igg_job_deadline_missed_total`` counter at the next step
      boundary — observability, never a kill: the run completes. The
      scheduler fills it from ``JobSpec.deadline_s`` minus queue wait)
    - auto-tuner: ``tuned`` (a `telemetry.TunedConfig`, its JSON dict, or
      a path to one; either package's file).
    """

    nt_chunk: int = 100
    key: Any = None
    checkpoint_dir: Any = None
    checkpoint_every: int | None = None
    guard: Any = None
    policy: Any = None
    faults: tuple = ()
    on_report: Any = None
    check_vma: bool | None = None
    unroll: int | None = None
    snapshot_dir: Any = None
    snapshot_every: int | None = None
    snapshot_fields: Any = None
    snapshot_queue: int = 2
    snapshot_policy: str = "block"
    reducers: tuple = ()
    on_reduce: Any = None
    metrics_port: int | None = None
    healthz_max_age_s: float | None = None
    perf_model: Any = None
    perf_window: int = 16
    perf_zmax: float = 4.0
    audit: bool = False
    audit_lints: Any = None
    ensemble: int | None = None
    tuned: Any = None
    deadline_s: float | None = None

    def to_json(self) -> dict:
        """JSON-able summary of the NON-DEFAULT, serializable knobs (for
        flight/journal records; callables and arrays are elided by name)."""
        out = {}
        for f in fields(self):
            v = getattr(self, f.name)
            if v == f.default:
                continue
            if callable(v):
                v = getattr(v, "__qualname__", repr(v))
            elif isinstance(v, (list, tuple)):
                v = [str(x) for x in v]
            elif not isinstance(v, (int, float, str, bool, type(None))):
                v = str(v)
            out[f.name] = v
        return out
