"""Multi-run scheduler: the card as a persistent simulation service.

Counterpart of `implicitglobalgrid_tpu/service/`. `MeshScheduler` owns the
card and multiplexes QUEUED jobs through it in chunk-granular time slices:
every job gets its own grid (different models and grid sizes share one
card, each a virtual mesh), its own `runtime.ResilientRun` (checkpoints,
snapshots, reducers, perf watch, audit, per tenant) and its own flight
JSONL; the scheduler owns the long-lived /metrics + /healthz endpoint with
per-job labeled gauges. `service_report`/`export_service_trace` reconstruct
the interleaved schedule post-hoc (one Perfetto track per job).

Producers outside the scheduler process reach it through a `QueueBackend`
(`DirectoryBackend` = queue-JSON records + the control-file protocol under
one directory, atomic-rename claims so N schedulers partition jobs without
double-admission; the JAX package's format, so each package's scheduler
consumes the other's queue directories); `jobspec_from_json` is the one
record-to-`JobSpec` code path. Jobs with a ``deadline_s`` are priced at
admission (`telemetry.predict_step`) and REJECTED when their completion
provably busts the budget.

The closed loop: `MeshScheduler(autoscale=AutoscalePolicy(...))` runs an
`Autoscaler` at every slice boundary: it reads the live signals (deadline
slack, queue pressure), generates candidate ``dims`` moves inside per-job
`ScaleBounds` and the rank pool (``MeshScheduler(nranks=)``), prices each
with `telemetry.predict_step` + `predict_reshard`, damps bounced signals
with hysteresis + cooldown, actuates through the control-file path,
re-tunes the resized job at the boundary, and journals every decision as
``autoscale_decision`` records that `service_report` and
`explain_autoscale` reconstruct.
"""

from .autoscale import Autoscaler, AutoscalePolicy, ScaleBounds
from .backend import DirectoryBackend, QueueBackend
from .job import (
    BUILTIN_MODELS, Job, JobSpec, JobState, builtin_setup,
    jobspec_from_json,
)
from .policies import (
    FairSharePolicy, FifoPolicy, POLICIES, RoundRobinPolicy,
    SchedulingPolicy, resolve_policy,
)
from .report import (
    explain_autoscale, export_service_trace, is_service_dir,
    service_report,
)
from .scheduler import MeshScheduler

__all__ = [
    "MeshScheduler",
    "JobSpec", "Job", "JobState", "builtin_setup", "BUILTIN_MODELS",
    "jobspec_from_json",
    "QueueBackend", "DirectoryBackend",
    "SchedulingPolicy", "FifoPolicy", "RoundRobinPolicy",
    "FairSharePolicy", "POLICIES", "resolve_policy",
    "service_report", "export_service_trace", "is_service_dir",
    "Autoscaler", "AutoscalePolicy", "ScaleBounds", "explain_autoscale",
]
