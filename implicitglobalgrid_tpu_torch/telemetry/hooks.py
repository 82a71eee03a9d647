"""Framework-side instrumentation hooks: the one place the hot paths call.

Counterpart of `implicitglobalgrid_tpu/telemetry/hooks.py` (all of it but
the runner cache's hook, below): the same metric family names and label
sets, so `prometheus_snapshot` of the same run reads the same in both
packages. Each hook bumps the process metrics
registry (always on — a few dict ops under a lock) and appends a
flight-recorder event when a recorder is active (a no-op None-check
otherwise). Keeping the metric names and label sets here, instead of
scattered over the driver, the checkpoint layer and the snapshot writer,
means the exported surface is greppable in one module and a rename can
never desynchronize producers.

Every module of the JAX package is ported, and the port calls every hook
here: the resilient driver (`record_health_event`, `note_heartbeat`,
`note_deadline_*`, `observe_member_health`, `observe_reducers`,
`observe_audit`, `observe_reshard`; `observe_perf` through `PerfWatch`),
`ops.halo.update_halo` (`account_halo_exchange`, every call),
`utils.checkpoint` (`observe_checkpoint`), `io.snapshot.SnapshotWriter`
(`note_io_queue`, `observe_snapshot`), `telemetry.server`
(`note_metrics_server_port`, `note_http_request`), the live plane
(`note_alert`, `note_flight_file_bytes`) and the mesh service (the
scheduler's and the autoscaler's hooks). The JAX package's
`note_runner_cache` has no counterpart: it counts that package's
compiled-runner cache, and the port builds no compiled runner.
"""

from __future__ import annotations

import time

from .recorder import record_event
from .registry import metrics_registry

__all__ = ["account_halo_exchange",
           "record_health_event",
           "observe_checkpoint", "observe_snapshot", "note_io_queue",
           "observe_reducers", "note_heartbeat", "observe_perf",
           "note_metrics_server_port", "observe_audit",
           "note_scheduler_heartbeat", "note_queue_depth", "job_gauges",
           "observe_job_slice", "clear_scheduler_heartbeat",
           "note_job_transition", "observe_member_health",
           "observe_reshard", "note_deadline_slack", "note_queue_backlog",
           "note_alert", "note_autoscale_decision",
           "note_job_target_devices", "note_http_request",
           "note_flight_file_bytes"]

# Metric family names (the exported contract; see docs/observability.md).
HEALTH_EVENTS = "igg_health_events_total"
HALO_EXCHANGES = "igg_halo_exchanges_total"
HALO_PPERMUTES = "igg_halo_ppermutes_total"
HALO_WIRE_BYTES = "igg_halo_wire_bytes_total"
HALO_LOCAL_BYTES = "igg_halo_local_copy_bytes_total"
CKPT_SECONDS = "igg_checkpoint_seconds"
SNAP_TOTAL = "igg_snapshots_total"
SNAP_BYTES = "igg_snapshot_bytes_total"
SNAP_SECONDS = "igg_snapshot_seconds"
IO_QUEUE_DEPTH = "igg_io_queue_depth"
REDUCER_VALUE = "igg_reducer_value"
HEARTBEAT_TS = "igg_driver_heartbeat_timestamp_seconds"
HEARTBEAT_STEP = "igg_driver_step"
PERF_STEP_S = "igg_perf_step_seconds"
PERF_RATIO = "igg_perf_model_ratio"
PERF_Z = "igg_perf_zscore"
PERF_REGRESSIONS = "igg_perf_regressions_total"
METRICS_SERVER_PORT = "igg_metrics_server_port"
AUDIT_FINDINGS = "igg_audit_findings_total"
# multi-run scheduler (service/): the per-tenant ops surface
SCHED_HEARTBEAT_TS = "igg_scheduler_heartbeat_timestamp_seconds"
SCHED_SLICES = "igg_scheduler_slices_total"
QUEUE_DEPTH = "igg_jobs_queued"
JOBS_RUNNING = "igg_jobs_running"
JOBS_TOTAL = "igg_jobs_total"
JOB_HEARTBEAT_TS = "igg_job_heartbeat_timestamp_seconds"
JOB_STEP = "igg_job_step"
JOB_PERF_STEP_S = "igg_job_perf_step_seconds"
JOB_PERF_RATIO = "igg_job_perf_model_ratio"
JOB_AUDIT_FINDINGS = "igg_job_audit_findings_total"
JOB_SLICE_SECONDS = "igg_job_slice_seconds"
JOB_WAIT_SECONDS = "igg_job_wait_seconds"
DEADLINE_MISSED = "igg_job_deadline_missed_total"
# ensemble axis: per-member guard verdicts as labeled series
# (the igg_job_* twins are the scheduler's per-tenant scoped mirrors —
# distinct family names because a ScopedRegistry view adds the job label
# to the family's labelnames, and one family cannot carry both shapes)
# on-device elastic resharding: resize downtime + wire volume
RESHARD_BYTES = "igg_reshard_bytes_total"
RESHARD_SECONDS = "igg_reshard_seconds"
RESHARD_ROUNDS = "igg_reshard_rounds"
MEMBER_RMS = "igg_member_rms"
MEMBER_NONFINITE = "igg_member_nonfinite_cells"
MEMBER_TRIPS = "igg_member_guard_trips_total"
JOB_MEMBER_RMS = "igg_job_member_rms"
JOB_MEMBER_NONFINITE = "igg_job_member_nonfinite_cells"
JOB_MEMBER_TRIPS = "igg_job_member_guard_trips_total"
# live observability plane: deadline slack, queue pressure,
# alert transitions (scoped igg_job_* twin per the label-shape rule above)
DEADLINE_SLACK = "igg_deadline_slack_seconds"
JOB_DEADLINE_SLACK = "igg_job_deadline_slack_seconds"
QUEUE_PENDING = "igg_queue_pending"
QUEUE_OLDEST = "igg_queue_oldest_age_seconds"
ALERTS_TOTAL = "igg_alerts_total"
# closed-loop autoscaler: policy verdicts + the per-job
# target-geometry gauge (scoped per the label-shape rule above)
AUTOSCALE_DECISIONS = "igg_autoscale_decisions_total"
AUTOSCALE_RESIZES = "igg_autoscale_resizes_total"
AUTOSCALE_REJECTED = "igg_autoscale_rejected_total"
JOB_TARGET_DEVICES = "igg_job_target_devices"
# serving-tier self-measurement: HTTP access telemetry on
# every routed surface + flight-file growth from the tail checkpoints
HTTP_REQUESTS = "igg_http_requests_total"
HTTP_REQUEST_SECONDS = "igg_http_request_seconds"
FLIGHT_FILE_BYTES = "igg_flight_file_bytes"


def record_health_event(kind: str, n: int = 1) -> None:
    """Bump the resilient-runtime ``igg_health_events_total{kind=...}``
    counter by ``n`` (`runtime.run_resilient`: kinds include ``chunks``,
    ``guard_trips``, ``rollbacks``, ``checkpoints_saved``, ``restores``,
    ``restore_fallbacks``, ``elastic_restarts``, ``escalations``,
    ``resizes``). Read
    the family via ``igg.metrics_registry()`` or
    ``igg.prometheus_snapshot()``."""
    metrics_registry().counter(
        HEALTH_EVENTS,
        "Resilient-runtime events by kind (chunks, guard_trips, rollbacks, "
        "checkpoints_saved, restores, restore_fallbacks, elastic_restarts, "
        "escalations, resizes).", ("kind",)).inc(int(n), kind=str(kind))


def account_halo_exchange(plan: dict) -> None:
    """Record one `update_halo` call from its static wire plan
    (`ops.halo.halo_comm_plan`): bytes-on-wire and collective counts per
    mesh axis, derived at trace time from shapes/overlaps/wire dtype —
    zero device syncs (the reference's printed GB/s estimate, computed
    instead of measured)."""
    reg = metrics_registry()
    reg.counter(HALO_EXCHANGES, "update_halo calls accounted.").inc(1)
    pperm = reg.counter(
        HALO_PPERMUTES,
        "collective-permute ops issued by halo exchanges, per mesh axis.",
        ("axis",))
    wire = reg.counter(
        HALO_WIRE_BYTES,
        "Halo payload bytes crossing the interconnect (all links summed), "
        "per mesh axis and on-wire dtype.", ("axis", "dtype"))
    for axis, rec in plan["axes"].items():
        if rec["ppermutes"]:
            pperm.inc(rec["ppermutes"], axis=axis)
        for dt, b in rec["by_dtype"].items():
            wire.inc(b, axis=axis, dtype=dt)
    if plan["local_copy_bytes"]:
        reg.counter(
            HALO_LOCAL_BYTES,
            "Halo bytes moved by self-neighbor local copies (no wire)."
        ).inc(plan["local_copy_bytes"])
    record_event("halo_exchange", fields=plan["fields"],
                 ppermutes=plan["ppermutes"],
                 wire_bytes=plan["wire_bytes"],
                 local_copy_bytes=plan["local_copy_bytes"])


def observe_checkpoint(op: str, dur_s: float, *, path: str,
                       step=None, **fields) -> None:
    """Record a checkpoint save/restore latency (``op``: ``save`` |
    ``save_sharded`` | ``restore`` | ``restore_sharded`` |
    ``restore_elastic``)."""
    metrics_registry().histogram(
        CKPT_SECONDS, "Checkpoint save/restore wall time by operation.",
        ("op",)).observe(dur_s, op=op)
    kind = "checkpoint_save" if op.startswith("save") else \
        "checkpoint_restore"
    record_event(kind, op=op, dur_s=dur_s, path=str(path), step=step,
                 **fields)


def observe_snapshot(result: str, dur_s: float | None = None, *,
                     path: str, step=None, nbytes: int = 0,
                     queue_depth=None, **fields) -> None:
    """Record one async-snapshot outcome (``result``: ``written`` |
    ``dropped`` | ``error``) from `io.snapshot.SnapshotWriter`. Bytes are
    THIS process's committed shard payload (the O(shard) volume that
    actually moved); the flight event kind is ``snapshot_write`` /
    ``snapshot_drop`` / ``snapshot_error``."""
    reg = metrics_registry()
    reg.counter(SNAP_TOTAL, "Async snapshot outcomes.",
                ("result",)).inc(1, result=result)
    if result == "written":
        if nbytes:
            reg.counter(
                SNAP_BYTES,
                "Snapshot payload bytes written (this process's shard "
                "blocks).").inc(nbytes)
        if dur_s is not None:
            reg.histogram(
                SNAP_SECONDS,
                "Background snapshot serialize+fsync+commit wall time."
            ).observe(dur_s)
        record_event("snapshot_write", step=step, path=str(path),
                     dur_s=dur_s, nbytes=nbytes,
                     queue_depth=queue_depth, **fields)
    elif result == "dropped":
        record_event("snapshot_drop", step=step, path=str(path),
                     queue_depth=queue_depth, **fields)
    else:
        record_event("snapshot_error", step=step, path=str(path),
                     **fields)


def note_io_queue(depth: int) -> None:
    """Track the snapshot writer's live queue depth (gauge: the
    backpressure signal an operator watches before picking ``block`` vs
    ``drop_oldest``)."""
    metrics_registry().gauge(
        IO_QUEUE_DEPTH,
        "Snapshots queued for the background writer right now.").set(depth)


def note_heartbeat(step) -> None:
    """Stamp the driver's liveness: wall time of the last completed chunk
    boundary plus the last committed step. Two gauge writes (dict ops
    under the registry lock) — the whole step-loop cost of the live
    `/healthz` endpoint (`telemetry.server`), whether or not a server is
    actually running."""
    reg = metrics_registry()
    reg.gauge(HEARTBEAT_TS,
              "Wall-clock time of the resilient driver's last chunk "
              "boundary (unix seconds).").set(time.time())
    reg.gauge(HEARTBEAT_STEP,
              "Last step the resilient driver committed.").set(step)


def observe_perf(per_step_s: float, *, ratio=None, z=None,
                 regression: bool = False) -> None:
    """Record one chunk boundary's perf-oracle observation
    (`telemetry.perfmodel.PerfWatch`): the measured per-step time, the
    measured/modeled ratio (when a model prediction backs the run), the
    rolling robust z-score vs the chunk baseline, and the regression
    counter. Gauge writes only — the whole per-boundary cost of the live
    drift detector."""
    reg = metrics_registry()
    reg.gauge(PERF_STEP_S,
              "Measured per-step execution time of the last chunk "
              "(exec_s / steps).").set(per_step_s)
    if ratio is not None:
        reg.gauge(PERF_RATIO,
                  "Measured / modeled per-step time (perfmodel."
                  "predict_step backing the run).").set(ratio)
    if z is not None:
        reg.gauge(PERF_Z,
                  "Rolling robust z-score of the last chunk's per-step "
                  "time vs the median+MAD baseline.").set(z)
    if regression:
        reg.counter(PERF_REGRESSIONS,
                    "Chunks flagged by the perf drift detector "
                    "(perf_regression flight events).").inc(1)


def note_metrics_server_port(port: int) -> None:
    """Expose the ACTUAL bound port of the live metrics endpoint (the
    ephemeral-port contract: start with port=0, read the gauge — or the
    returned server's ``.port`` — instead of hard-coding)."""
    metrics_registry().gauge(
        METRICS_SERVER_PORT,
        "TCP port the live /metrics+/healthz endpoint is bound to "
        "(0 = no server started yet this process).").set(int(port))


def observe_audit(report, *, program: str = "chunk",
                  audit_s: float | None = None) -> None:
    """Record one static-analysis audit of a compiled program
    (`analysis.AuditReport`, from `run_resilient(audit=True)` or any
    caller of `analysis.audit_program`): every finding bumps the
    ``igg_audit_findings_total{rule,severity}`` family and the full
    report streams to the flight recorder as an ``audit`` event —
    `run_report`'s ``"audit"`` section is reconstructed from that event
    alone. ``audit_s`` (host seconds the audit itself took — trace +
    lower + parse + check) rides on the event when the caller timed
    it, keeping chunk ``build_s`` attribution honest."""
    reg = metrics_registry()
    fam = reg.counter(
        AUDIT_FINDINGS,
        "Static-analysis findings from compiled-program audits "
        "(analysis.audit_program), by rule and severity.",
        ("rule", "severity"))
    for f in report.findings:
        fam.inc(1, rule=f.rule, severity=f.severity)
    rules = report.by_rule()
    extra = {} if audit_s is None else {"audit_s": audit_s}
    record_event("audit", program=program, dialect=report.dialect,
                 ok=report.ok, errors=report.errors,
                 warnings=report.warnings, rules=rules,
                 findings=[f.to_json() for f in report.findings],
                 collectives=report.collectives,
                 crosscheck_ok=(None if report.crosscheck is None
                                else bool(report.crosscheck.get("ok"))),
                 **extra)


def note_scheduler_heartbeat(granted: bool = False) -> None:
    """Stamp the multi-run scheduler's liveness (one gauge write per
    scheduling decision — idle polls included, they prove the loop is
    alive). When this gauge is live, `/healthz` judges THE SCHEDULER by
    it — a single wedged job must not 503 the whole service (per-job
    staleness is the labeled `igg_job_heartbeat_*` family). The slice
    counter moves only when a slice was actually ``granted``, so it
    reconciles exactly against the journal's slice events."""
    reg = metrics_registry()
    reg.gauge(SCHED_HEARTBEAT_TS,
              "Wall-clock time of the scheduler's last scheduling "
              "decision (unix seconds).").set(time.time())
    if granted:
        reg.counter(SCHED_SLICES,
                    "Chunk-granular slices the scheduler has granted."
                    ).inc(1)


def clear_scheduler_heartbeat() -> None:
    """Retire the scheduler heartbeat series (scheduler close): /healthz
    falls back to judging the plain driver heartbeat again."""
    metrics_registry().reset(SCHED_HEARTBEAT_TS)


def note_queue_depth(queued: int, running: int) -> None:
    """Track the scheduler's admission queue (gauges: jobs waiting for
    their first slice, jobs currently multiplexed)."""
    reg = metrics_registry()
    reg.gauge(QUEUE_DEPTH,
              "Jobs queued behind the scheduler (admitted, not yet "
              "granted their first slice).").set(queued)
    reg.gauge(JOBS_RUNNING,
              "Jobs currently being multiplexed through the mesh."
              ).set(running)


def note_job_transition(state: str) -> None:
    """Count one job lifecycle transition (``done``/``failed``/
    ``cancelled``/``submitted``)."""
    metrics_registry().counter(
        JOBS_TOTAL, "Job lifecycle transitions by terminal state.",
        ("state",)).inc(1, state=state)


def note_deadline_missed() -> None:
    """Count one run crossing its ``deadline_s`` budget (the driver
    fires it at most once per run, with the ``deadline_missed`` flight
    event — the alertable twin of the journal record)."""
    metrics_registry().counter(
        DEADLINE_MISSED,
        "Runs that crossed their deadline_s budget while running."
        ).inc(1)


def note_deadline_slack(slack_s: float) -> None:
    """Stamp the driver's live deadline slack (remaining budget minus the
    priced cost of the remaining steps) — the signal the deadline-slack
    burn alert and next arc's preemption policy subscribe to. One gauge
    write per chunk boundary, only on deadline-budgeted runs."""
    metrics_registry().gauge(
        DEADLINE_SLACK,
        "Remaining deadline budget minus predicted remaining work "
        "(seconds; negative = provable bust).").set(slack_s)


def note_queue_backlog(pending: int, oldest_age_s: float | None) -> None:
    """Track the submission-queue BACKLOG (jobs filed on the queue
    backend, not yet claimed by any scheduler — upstream of
    `note_queue_depth`'s admitted-jobs gauges): pending count and the age
    of the oldest unclaimed record, the queue-pressure pair the ROADMAP
    autoscaler watches."""
    reg = metrics_registry()
    reg.gauge(QUEUE_PENDING,
              "Unclaimed job records on the submission queue backend."
              ).set(int(pending))
    if oldest_age_s is not None:
        reg.gauge(QUEUE_OLDEST,
                  "Age of the oldest unclaimed queue record (seconds)."
                  ).set(float(oldest_age_s))


def note_alert(rule: str, severity: str, state: str) -> None:
    """Count one alert state-machine transition
    (``igg_alerts_total{rule,severity,state}``; ``state``: ``firing`` |
    ``resolved``). The journal's ``alert`` event is the detailed twin."""
    metrics_registry().counter(
        ALERTS_TOTAL,
        "Alert-engine state transitions by rule, severity, and new state.",
        ("rule", "severity", "state")).inc(
        1, rule=str(rule), severity=str(severity), state=str(state))


def note_autoscale_decision(action: str, verdict: str,
                            reason: str | None = None) -> None:
    """Count one autoscaler policy verdict
    (``igg_autoscale_decisions_total{action,verdict}``; ``action``:
    ``grow`` | ``shrink``, ``verdict``: ``filed`` | ``rejected``). A
    filed move also bumps ``igg_autoscale_resizes_total``; a rejection
    bumps ``igg_autoscale_rejected_total{reason}`` (``hysteresis`` /
    ``cooldown`` / ``priced_out`` / ...). The journal's
    ``autoscale_decision`` event is the detailed twin carrying the full
    signal snapshot and pricing breakdown."""
    reg = metrics_registry()
    reg.counter(
        AUTOSCALE_DECISIONS,
        "Autoscaler policy verdicts by candidate action and outcome.",
        ("action", "verdict")).inc(
        1, action=str(action), verdict=str(verdict))
    if verdict == "filed":
        reg.counter(
            AUTOSCALE_RESIZES,
            "Resizes the autoscaler filed through the control path."
            ).inc(1)
    elif verdict == "rejected":
        reg.counter(
            AUTOSCALE_REJECTED,
            "Autoscale candidates rejected before actuation, by reason.",
            ("reason",)).inc(1, reason=str(reason or "unknown"))


def note_job_target_devices(scope, devices: int) -> None:
    """Stamp the device count the autoscaler currently targets for one
    job (its `ScopedRegistry` view — the gauge an operator compares
    against the mesh's pool size to see the policy's live allocation)."""
    scope.gauge(
        JOB_TARGET_DEVICES,
        "Devices this job's decomposition currently targets (product of "
        "its dims; moved by autoscale resizes).").set(int(devices))


def job_gauges(registry, job: str):
    """The per-job labeled families, as a `ScopedRegistry` view bound to
    one tenant — what `/metrics` serves across job lifetimes (step,
    heartbeat, perf, slice/wait latencies; a finished job's final values
    stay scrapeable while the service lives) and what the scheduler
    retires via ``remove_scope()`` when IT closes."""
    return (registry or metrics_registry()).scoped(job=str(job))


def observe_job_slice(scope, *, step, slice_s: float, wait_s: float,
                      perf_step_s=None, perf_ratio=None,
                      audit_findings: float = 0.0,
                      slack_s=None) -> None:
    """Record one granted slice for one job into its scoped gauge view
    (`job_gauges`): committed step + heartbeat, slice/wait latency
    histograms, and the perf-oracle mirrors (the process-wide
    ``igg_perf_*`` gauges flap between tenants under multiplexing — the
    per-job labeled copies are the ones an operator alerts on).
    ``slack_s`` mirrors the driver's live deadline slack into the
    per-job label (same label-shape rule as the perf pair: the
    process-wide ``igg_deadline_slack_seconds`` flaps between
    tenants)."""
    scope.gauge(JOB_STEP, "Last step this job committed.").set(step)
    scope.gauge(JOB_HEARTBEAT_TS,
                "Wall-clock time of this job's last granted slice "
                "(unix seconds).").set(time.time())
    scope.histogram(JOB_SLICE_SECONDS,
                    "Wall time of this job's granted slices (one "
                    "chunk-boundary iteration each).").observe(slice_s)
    scope.histogram(JOB_WAIT_SECONDS,
                    "Time this job waited between slices (queue + other "
                    "tenants' slices).").observe(wait_s)
    if perf_step_s is not None:
        scope.gauge(JOB_PERF_STEP_S,
                    "Measured per-step execution time of this job's last "
                    "chunk.").set(perf_step_s)
    if perf_ratio is not None:
        scope.gauge(JOB_PERF_RATIO,
                    "Measured / modeled per-step time for this job."
                    ).set(perf_ratio)
    if audit_findings:
        scope.counter(JOB_AUDIT_FINDINGS,
                      "Static-analysis findings attributed to this job's "
                      "compile-time audits.").inc(audit_findings)
    if slack_s is not None:
        scope.gauge(JOB_DEADLINE_SLACK,
                    "This job's remaining deadline budget minus predicted "
                    "remaining work (seconds; negative = provable bust)."
                    ).set(slack_s)


def observe_member_health(reports, scope=None) -> None:
    """Per-member ensemble health as labeled series: stacked-layout RMS
    and non-finite cell counts per (member, field) gauge, and a
    per-member guard-trip counter. ``reports`` are the chunk's per-member
    `HealthReport`s (`runtime.health.ensemble_reports_from_stats`);
    ``scope`` routes into a job's `ScopedRegistry` view (the scheduler
    mirrors the last chunk's members there, so batched jobs expose
    per-member series under their own job label)."""
    reg = scope if scope is not None else metrics_registry()
    scoped = scope is not None
    rms = reg.gauge(JOB_MEMBER_RMS if scoped else MEMBER_RMS,
                    "Stacked-layout RMS per ensemble member and field.",
                    ("member", "field"))
    nonf = reg.gauge(JOB_MEMBER_NONFINITE if scoped else MEMBER_NONFINITE,
                     "Non-finite cell count per ensemble member and "
                     "field.", ("member", "field"))
    trips = reg.counter(JOB_MEMBER_TRIPS if scoped else MEMBER_TRIPS,
                        "Guard trips attributed to one ensemble member.",
                        ("member",))
    for rep in reports:
        m = str(rep.member)
        for field, v in rep.rms.items():
            rms.set(v, member=m, field=field)
        for field, v in rep.nonfinite.items():
            nonf.set(float(v), member=m, field=field)
        if not rep.ok:
            trips.inc(1, member=m)


def observe_reshard(dur_s: float, *, via: str, new_dims, step=None,
                    rounds=None, wire_bytes=None, local_bytes=None,
                    **fields) -> None:
    """Record one elastic resize (`runtime.ResilientRun.resize`): wall
    time by path (``via``: ``device`` | ``checkpoint``), the collective
    program's wire/local byte volume and scheduled round count (device
    path only — the checkpoint path's volume is its restore's), and the
    ``resize`` flight event the run report / Perfetto trace render as a
    span."""
    reg = metrics_registry()
    reg.histogram(
        RESHARD_SECONDS,
        "Elastic resize wall time (state re-blocked onto new dims), "
        "by path.", ("via",)).observe(dur_s, via=str(via))
    bytes_fam = reg.counter(
        RESHARD_BYTES,
        "Bytes moved by on-device reshard programs, wire (padded "
        "all-links ppermute payloads) vs local (same-device copies).",
        ("kind",))
    if wire_bytes:
        bytes_fam.inc(int(wire_bytes), kind="wire")
    if local_bytes:
        bytes_fam.inc(int(local_bytes), kind="local")
    if rounds is not None:
        reg.gauge(
            RESHARD_ROUNDS,
            "Scheduled ppermute slice rounds of the last on-device "
            "reshard program.").set(int(rounds))
    record_event("resize", via=str(via), new_dims=list(new_dims),
                 dur_s=dur_s, step=step, rounds=rounds,
                 wire_bytes=wire_bytes, local_bytes=local_bytes, **fields)


def observe_reducers(step, values: dict, *, ok: bool = True) -> None:
    """Record one chunk boundary's in-situ reducer results: scalar values
    land in the ``igg_reducer_value`` gauge family (labeled by reducer
    name; per-stat sub-labeled ``name:stat``), every value streams to the
    flight recorder (``reducers`` event — slices included, they are
    axis-sized)."""
    g = metrics_registry().gauge(
        REDUCER_VALUE,
        "Latest in-situ reducer results (probes, stats).", ("name",))
    for name, v in values.items():
        if isinstance(v, dict):
            for stat, sv in v.items():
                g.set(sv, name=f"{name}:{stat}")
        elif not hasattr(v, "__len__"):
            g.set(float(v), name=name)
    record_event("reducers", step=step, ok=ok, values=values)


def note_http_request(route: str, method: str, code: int,
                      dur_s: float, scope=None) -> None:
    """Account one routed HTTP request on the serving tier
    (`telemetry.server.MetricsServer` dispatch — token-gate 401s
    included).  ``route`` is the NORMALIZED route pattern (job names
    collapsed to ``{name}``), keeping label cardinality bounded;
    ``scope`` routes into the registry the answering server serves."""
    reg = scope if scope is not None else metrics_registry()
    reg.counter(
        HTTP_REQUESTS,
        "Routed HTTP requests by route pattern, method, and status code.",
        ("route", "method", "code")).inc(
            1, route=str(route), method=str(method), code=str(int(code)))
    reg.histogram(
        HTTP_REQUEST_SECONDS,
        "Routed HTTP request handling wall time.", ("route",)
    ).observe(float(dur_s), route=str(route))


def note_flight_file_bytes(file: str, nbytes: int) -> None:
    """Stamp one flight/journal stream's on-disk size (gauge, labeled by
    basename) — fed from the live tail's byte-offset checkpoints
    (`telemetry.live.FlightTail`), so recorder growth is visible before
    it becomes a disk incident (``tools flight du`` is the CLI twin)."""
    metrics_registry().gauge(
        FLIGHT_FILE_BYTES,
        "Bytes consumed so far by each flight/journal JSONL stream.",
        ("file",)).set(int(nbytes), file=str(file))
