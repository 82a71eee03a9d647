"""`MeshScheduler` — the virtual mesh as a persistent, multiplexed resource.

Counterpart of `implicitglobalgrid_tpu/service/scheduler.py`: the same
journal, control channel, policies, admission pricing, alerts, autoscaler
and trace stamping, so both packages' schedulers journal the same event,
job and slice sequence for the same jobs. `run_resilient` owns the grid for
exactly one job; the scheduler inverts that: IT owns the card (and the ops
surface — the long-lived /metrics + /healthz endpoint, the flight journal)
and advances QUEUED jobs through it in chunk-granular slices:

    sched = tg.service.MeshScheduler(policy="fair", flight_dir="/logs/q",
                                     metrics_port=9100)
    sched.submit(tg.service.JobSpec(name="a", setup=..., nt=2000,
                                    grid=dict(nx=64, ny=64, nz=64,
                                              dimx=2, dimy=2, dimz=2)))
    sched.submit(...)                      # different model/grid size: fine
    sched.run()                            # drain the queue
    final_states = sched.results()

Mechanics, in one paragraph: every job gets its OWN grid (`init_global_grid`
at admission: jobs may have different models, grid sizes and
decompositions; on one card each is a virtual mesh whose blocks all live on
it) and its own `ResilientRun` (checkpoint slots, snapshot writer, perf
watch, audit budgets, flight recorder). A context switch is two pointer
swaps: `topology.swap_global_grid` makes the job's grid current WITHOUT a
new epoch, and `use_flight_recorder` routes the driver's events into the
job's JSONL. The port's epoch-keyed caches (the halo plans `update_halo`
charges, `ops.halo._plan_cache`; the deep cadences' fresh masks,
`models.common._masks`) keep serving a retained epoch
(`topology.retain_epoch`) across switches and drop a finished job's entries
at once (`_evict_epoch_caches`). The other caches of the exchange (the
K2/K6 and K7/K8 call checks in `ops.cuda_halo`, the reshard programs) are
keyed by everything their result depends on, never by a grid, so a
re-admitted grid of the same shape can reuse them and never finds a stale
entry.

Isolation: a guard trip, rollback, elastic restart or injected fault in one
job runs entirely inside that job's slice, against that job's checkpoints,
on that job's grid: the other tenants' trajectories are bitwise their solo
runs (tests/test_torch_service.py, and `chip_smoke.py`'s service phase at
full width on the card). A job that exhausts its retry budget FAILS alone;
the scheduler records the error and keeps serving the rest. A finished job's
state is drained (`utils.timing.sync`) before its epoch is released.

The rank pool: the JAX package sizes the autoscaler's pool from its device
count. On the port's virtual mesh the count of devices bounds nothing (one
card holds every rank; `reshard.plan`'s note), so ``nranks`` gives the pool,
as `init_global_grid(nranks=)` gives the rank count where dims are left at
0. A job whose grid has more ranks than the pool fails at admission, as the
JAX package's grid of more shards than devices does. With no pool, the mesh
utilization is not reported and growth is bounded by
`ScaleBounds.max_devices` and the card's free memory
(`reshard.check_device_memory`).

Preemption is only ever at chunk boundaries (one `advance()` per granted
slice), so the scheduling policy (`fifo` | `round_robin` | `fair`) affects
latency and fairness, never results.
"""

from __future__ import annotations

import os
import time

from ..parallel import topology as top
from ..runtime.driver import ResilientRun
from ..telemetry import hooks
from ..telemetry.live import AlertEngine
from ..telemetry.recorder import FlightRecorder, use_flight_recorder
from ..telemetry.tracectx import TraceContext
from ..utils.exceptions import InvalidArgumentError
from .autoscale import Autoscaler, AutoscalePolicy
from .backend import DirectoryBackend, QueueBackend
from .job import Job, JobSpec, JobState, jobspec_from_json
from .policies import resolve_policy

__all__ = ["MeshScheduler"]


class _DeadlineRejected(Exception):
    """Internal control flow: `_admit`'s deadline pricing refused the
    job. Carries the journaled verdict record; `_slice` turns it into
    `JobState.REJECTED` (a verdict, not a failure)."""

    def __init__(self, verdict: dict):
        super().__init__(
            f"admission rejected: priced {verdict['admit_price_s']:.3g}s "
            f"of mesh time > {verdict['budget_s']:.3g}s left of "
            f"deadline_s={verdict['deadline_s']:.6g}")
        self.verdict = verdict


def _evict_epoch_caches(epoch: int) -> None:
    """Drop a finished job's entries from every epoch-keyed cache NOW
    (release_epoch alone only makes them evictable at the next miss): the
    halo plans `update_halo` charges and the deep cadences' fresh masks.
    The port caches no compiled runner, exchange program or drain probe
    (the JAX package's other three epoch-keyed caches)."""
    from ..models import common
    from ..ops import halo

    for cache in (common._masks, halo._plan_cache):
        for k in [k for k in cache if k[0] == epoch]:
            del cache[k]


class MeshScheduler:
    """Single-process persistent-mesh scheduler (see module docstring).

    ``policy``: ``"fifo"`` | ``"round_robin"`` | ``"fair"`` (or a
    `SchedulingPolicy` instance). ``flight_dir``: per-job flight JSONLs
    (``job_<name>.jsonl``) plus the scheduler's own journal
    (``scheduler.jsonl``) land here — `igg.run_report(flight_dir)`
    reconstructs the interleaved schedule and
    `service.export_service_trace` renders one Perfetto track per job;
    the directory doubles as the control channel (cancel, drain and resize
    request files, the JAX package's `tools jobs` format, polled at slice
    boundaries).
    ``metrics_port`` starts the scheduler-OWNED live endpoint for the
    scheduler's lifetime: per-job labeled gauges, queue depth, and a
    /healthz that judges the SCHEDULER heartbeat (a wedged single job
    must not 503 the service; its staleness shows in
    ``igg_job_heartbeat_timestamp_seconds{job=...}``). A
    `run_resilient(metrics_port=...)` running under (or next to) the
    scheduler ATTACHES to this server instead of failing to bind.

    ``nranks`` is the rank pool the autoscaler may grow a job into, the
    mesh utilization is read against and a job's grid must fit (the JAX
    package's device count; module docstring). None: no pool.

    The scheduler is a context manager; `close()` releases every job's
    resources and restores whatever grid was current at construction."""

    def __init__(self, *, policy="fifo", flight_dir=None,
                 metrics_port: int | None = None,
                 healthz_max_age_s: float | None = None,
                 queue: QueueBackend | None = None,
                 alerts=None, alert_sinks=(), autoscale=None,
                 nranks: int | None = None):
        if nranks is not None and int(nranks) < 1:
            raise InvalidArgumentError(
                f"nranks is the rank pool (>= 1) or None; got {nranks!r}.")
        self.nranks = None if nranks is None else int(nranks)
        self.policy = resolve_policy(policy)
        self.flight_dir = None if flight_dir is None else str(flight_dir)
        self.jobs: dict = {}
        self._order: list = []
        self._n_submitted = 0
        self.slices = 0
        self._closed = False
        # per-tenant audit attribution baseline: slices are serialized, so
        # the global finding-counter's growth during a slice belongs to
        # the job that ran it — ONE scheduler-level baseline (a per-job
        # zero would hand each first slice every earlier tenant's total)
        self._audit_seen = self._audit_total()
        self._draining = False
        self._journal = None
        self._server = None
        if self.flight_dir is not None:
            os.makedirs(self.flight_dir, exist_ok=True)
            self._journal = FlightRecorder(
                os.path.join(self.flight_dir, "scheduler.jsonl"),
                run_id="scheduler")
        # the queue backend: where out-of-process producers (the JAX
        # package's CLI and serve.JobApiServer, a peer scheduler's
        # overflow) enqueue job records and file control requests. A
        # flight_dir implies the directory backend over it (the
        # control-file protocol); an explicit
        # backend can be SHARED between schedulers (atomic-rename claims
        # partition the jobs, zero double-admissions).
        if queue is not None and not isinstance(queue, QueueBackend):
            raise InvalidArgumentError(
                f"queue must be a service.QueueBackend; got "
                f"{type(queue).__name__}.")
        self.queue = queue
        if queue is None and self.flight_dir is not None:
            self.queue = DirectoryBackend(self.flight_dir)
        # the in-process alert engine: ``alerts=True`` turns
        # on the default rule pack, an iterable of AlertRules customizes
        # it, a ready AlertEngine is adopted as-is (sinks appended). It
        # evaluates over the scheduler's OWN live state after every
        # granted slice and journals every transition through the
        # scheduler's single-writer journal — `telemetry.LiveAggregate`
        # is the observer-side twin tailing the same directory.
        self.alert_engine = None
        if isinstance(alerts, AlertEngine):
            self.alert_engine = alerts
            self.alert_engine.sinks.extend(alert_sinks)
            if self.alert_engine.journal is None:
                self.alert_engine.journal = self._log
        elif alerts is True or alerts == "default":
            self.alert_engine = AlertEngine(sinks=alert_sinks,
                                            journal=self._log)
        elif alerts:
            self.alert_engine = AlertEngine(list(alerts),
                                            sinks=alert_sinks,
                                            journal=self._log)
        elif alert_sinks:
            raise InvalidArgumentError(
                "alert_sinks without alerts: pass alerts=True (default "
                "rule pack), a rule list, or an AlertEngine.")
        if self.alert_engine is not None \
                and getattr(self.alert_engine, "tracer", None) is None:
            # alert transitions join the affected job's trace (a fresh
            # child span) BEFORE journal+sinks, so an alert-driven
            # control action can carry the alert's span as its parent
            self.alert_engine.tracer = self._alert_trace
        # the closed-loop autoscaler: ``autoscale=True`` turns
        # on the default policy, an AutoscalePolicy (or its kwargs dict)
        # customizes it, a ready Autoscaler is adopted as-is. It
        # evaluates over the SAME live snapshot as the alert engine after
        # every granted slice and actuates through the control path —
        # priced, hysteresis-damped, journaled (service.autoscale).
        self.autoscaler = None
        if isinstance(autoscale, Autoscaler):
            self.autoscaler = autoscale
        elif isinstance(autoscale, (AutoscalePolicy, dict)):
            self.autoscaler = Autoscaler(autoscale)
        elif autoscale is True or autoscale == "default":
            self.autoscaler = Autoscaler()
        elif autoscale:
            raise InvalidArgumentError(
                "autoscale must be True (default policy), an "
                "AutoscalePolicy (or its kwargs dict), or an Autoscaler; "
                f"got {type(autoscale).__name__}.")
        if self.autoscaler is not None:
            self.autoscaler.attach(self)
        try:
            if metrics_port is not None:
                from ..telemetry.server import start_metrics_server

                self._server = start_metrics_server(
                    int(metrics_port),
                    healthz_max_age_s=healthz_max_age_s)
            elif healthz_max_age_s is not None:
                raise InvalidArgumentError(
                    "healthz_max_age_s needs metrics_port (it configures "
                    "the /healthz endpoint the scheduler starts).")
        except BaseException:
            if self._journal is not None:
                self._journal.close()
            raise
        hooks.note_scheduler_heartbeat()
        self._log("scheduler_start", policy=self.policy.name,
                  wall=time.time(),
                  metrics_port=None if self._server is None
                  else self._server.port,
                  queue_owner=None if self.queue is None
                  else getattr(self.queue, "owner", None),
                  autoscale=None if self.autoscaler is None
                  else self.autoscaler.policy.describe())

    @staticmethod
    def _audit_total() -> float:
        fam = hooks.metrics_registry().get(hooks.AUDIT_FINDINGS)
        return sum(v for _, v in fam.samples()) if fam is not None else 0.0

    # -- journal -----------------------------------------------------------

    def _log(self, kind: str, **fields) -> None:
        if self._journal is None:
            return
        # the ONE trace-stamping chokepoint: every job-scoped journal
        # event (claim, admission verdict, slices, resize chains, alert
        # transitions, state changes) becomes a fresh CHILD span of the
        # job's root context. Explicit trace fields in the call win;
        # untraced jobs journal byte-identically to before.
        if "trace_id" not in fields and fields.get("job") is not None:
            job = self.jobs.get(fields["job"])
            tr = getattr(job, "trace", None)
            if tr is not None:
                fields.update(tr.child().fields())
        self._journal.event(kind, **fields)

    # -- submission --------------------------------------------------------

    def submit(self, spec: JobSpec, *,
               trace: TraceContext | None = None) -> Job:
        """Queue one job. Admission (grid + state construction) is LAZY —
        it happens inside the job's first granted slice, so its cost is
        attributed to the job that pays it, not to the submitter.
        ``trace`` is the job's ROOT span (`telemetry.tracectx`) — set by
        the queue-claim path from the record's ``traceparent``; every
        journal event and flight span of the job becomes its child."""
        self._check_open()
        if not isinstance(spec, JobSpec):
            raise InvalidArgumentError(
                f"submit takes a JobSpec; got {type(spec).__name__}.")
        if spec.name in self.jobs:
            raise InvalidArgumentError(
                f"A job named {spec.name!r} was already submitted "
                "(names key flight files and metric labels).")
        if self._draining:
            raise InvalidArgumentError(
                "The scheduler is draining — no new admissions.")
        job = Job(spec, self._n_submitted)
        job.trace = trace
        self._n_submitted += 1
        job.submitted_t = time.time()
        job.last_end_t = time.monotonic()
        self.jobs[spec.name] = job
        self._order.append(job)
        hooks.note_job_transition("submitted")
        self._update_queue_gauges()
        # NB "run" is the flight recorder's reserved run-id key — the
        # spec payload must travel under its own name
        self._log("job_submitted", job=spec.name, nt=int(spec.nt),
                  priority=int(spec.priority),
                  deadline_s=spec.deadline_s, grid=dict(spec.grid),
                  run_spec=spec.run.to_json())
        return job

    # -- queries -----------------------------------------------------------

    def job(self, name: str) -> Job:
        if name not in self.jobs:
            raise InvalidArgumentError(
                f"No job named {name!r} (have "
                f"{[j.name for j in self._order]}).")
        return self.jobs[name]

    def runnable(self) -> list:
        """Jobs that can take a slice right now, in submission order."""
        return [j for j in self._order if not j.finished]

    def results(self) -> dict:
        """``name -> final state dict`` of every DONE job."""
        return {j.name: j.result for j in self._order
                if j.state == JobState.DONE}

    def status(self) -> dict:
        """JSON-able service snapshot (queue depths + per-job records)."""
        states: dict = {}
        for j in self._order:
            states[j.state] = states.get(j.state, 0) + 1
        return {"policy": self.policy.name, "slices": self.slices,
                "jobs": [j.status() for j in self._order],
                "states": states,
                "metrics_port": None if self._server is None
                else self._server.port}

    # -- lifecycle ---------------------------------------------------------

    def cancel(self, name: str) -> Job:
        """Cancel a job: immediately when QUEUED; at its next slice
        boundary when RUNNING (the current chunk, if one is mid-flight in
        another caller's slice, completes — preemption stays
        chunk-granular)."""
        self._check_open()
        job = self.job(name)
        if job.finished:
            raise InvalidArgumentError(
                f"Job {name!r} already finished ({job.state}).")
        if job.state == JobState.QUEUED:
            self._finalize(job, JobState.CANCELLED)
        else:
            job.cancel_requested = True
        return job

    def resize(self, name: str, new_dims, *, via: str = "auto") -> Job:
        """Request an elastic resize of one job: at its NEXT slice
        boundary the scheduler re-blocks the job's state onto
        ``new_dims`` (`runtime.ResilientRun.resize` — the on-device
        HBM-to-HBM collective program, falling back to the
        checkpoint-based elastic restore), swaps the job's grid epoch,
        and journals ``job_resized``. The resize consumes that slice;
        preemption stays chunk-granular and the job's trajectory is
        bit-identical to its unresized run (the redistribution is
        exact). This is the SCHEDULER-decision form of the autoscaling
        primitive: shrink a tenant under load, grow it when the mesh
        frees up — a resize control file is the same request from outside
        the process."""
        self._check_open()
        job = self.job(name)
        if job.finished:
            raise InvalidArgumentError(
                f"Job {name!r} already finished ({job.state}).")
        new_dims = tuple(int(d) for d in new_dims)
        if len(new_dims) != 3 or any(d < 1 for d in new_dims):
            raise InvalidArgumentError(
                f"resize: new_dims must be 3 positive ints; got "
                f"{new_dims}.")
        if via not in ("auto", "device", "checkpoint"):
            raise InvalidArgumentError(
                f"resize: via must be auto|device|checkpoint; got "
                f"{via!r}.")
        job.resize_requested = (new_dims, via)
        self._log("resize_requested", job=name, new_dims=list(new_dims),
                  via=via)
        return job

    def drain(self) -> None:
        """Stop admitting: cancel every still-QUEUED job, let RUNNING jobs
        finish. (`run()` afterwards completes the running set.)"""
        self._check_open()
        self._draining = True
        self._log("drain")
        for j in list(self._order):
            if j.state == JobState.QUEUED:
                self._finalize(j, JobState.CANCELLED)

    def close(self) -> None:
        """Release everything: running jobs' resources (their runs are
        closed, NOT completed — submitted snapshots drain, checkpoints
        stay restorable), the per-job metric scopes, the scheduler
        heartbeat, the journal, and the metrics endpoint. Idempotent."""
        if self._closed:
            return
        self._closed = True
        for j in self._order:
            if not j.finished:
                self._finalize(j, JobState.CANCELLED)
        self._log("scheduler_stop", slices=self.slices,
                  jobs=len(self._order))
        # the per-job labeled series die WITH the service (during its
        # lifetime a finished job's final step/latencies stay scrapeable)
        for j in self._order:
            if j.scope is not None:
                j.scope.remove_scope()
        hooks.clear_scheduler_heartbeat()
        if self._journal is not None:
            self._journal.close()
        if self._server is not None:
            from ..telemetry.server import stop_metrics_server

            stop_metrics_server()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def _check_open(self) -> None:
        if self._closed:
            raise InvalidArgumentError("The scheduler is closed.")

    # -- the scheduling loop ----------------------------------------------

    def step(self) -> bool:
        """One scheduling decision: poll control requests, pick a job
        under the policy, grant it ONE chunk-boundary slice. Returns True
        when a slice was granted (False = nothing runnable — the queue is
        drained)."""
        self._check_open()
        self._poll_control()
        self._poll_queue()
        self._update_backlog_gauges()
        cands = self.runnable()
        for j in [j for j in cands if j.cancel_requested]:
            self._finalize(j, JobState.CANCELLED)
        cands = self.runnable()
        if not cands:
            hooks.note_scheduler_heartbeat()
            return False
        job = self.policy.pick(cands)
        self._slice(job)
        if self.alert_engine is not None:
            # the slice boundary IS the alert-evaluation cadence:
            # signals only change when a slice ran, and a sink's control
            # file lands before the very next _poll_control
            self.alert_engine.evaluate(self._live_signals())
        if self.autoscaler is not None:
            # after the alert engine: a hard alert action (cancel) filed
            # this boundary lands in _poll_control before any autoscale
            # move of the SAME job can waste a slice on it
            self.autoscaler.evaluate(self._live_signals())
        hooks.note_scheduler_heartbeat(granted=True)
        return True

    def run(self, max_slices: int | None = None) -> "MeshScheduler":
        """Drain the queue: grant slices until nothing is runnable (or
        ``max_slices`` was granted). Returns self."""
        granted = 0
        while max_slices is None or granted < max_slices:
            if not self.step():
                break
            granted += 1
        return self

    # -- internals ---------------------------------------------------------

    def _update_queue_gauges(self) -> None:
        hooks.note_queue_depth(
            sum(1 for j in self._order if j.state == JobState.QUEUED),
            sum(1 for j in self._order if j.state == JobState.RUNNING))

    def _update_backlog_gauges(self) -> None:
        """Queue-pressure pair from the backend: unclaimed records +
        oldest-record age (upstream of the admitted-jobs gauges)."""
        if self.queue is None:
            return
        hooks.note_queue_backlog(self.queue.pending_count(),
                                 self.queue.oldest_age_s())

    def _live_signals(self) -> dict:
        """The scheduler-side live snapshot the in-process alert engine
        evaluates against — same shape (``jobs`` / ``procs`` / ``queue``
        / ``scheduler`` keys, same signal names) as
        `telemetry.LiveAggregate.snapshot`, built from direct state
        instead of tailed files. ``procs`` is empty here (barrier
        spreads need the multi-process tail view); the straggler rule
        simply stays silent in-process."""
        jobs = {}
        for j in self._order:
            run, st = j.run, j.status()
            watch = None if run is None else getattr(run, "watch", None)
            jobs[j.name] = {
                "state": st["state"], "step": st["step"],
                "nt": st["nt"], "slices": st["slices"],
                "guard_trips": st["guard_trips"],
                "deadline_slack_s": None if run is None
                else getattr(run, "deadline_slack_s", None),
                "deadline_missed": bool(
                    run is not None
                    and getattr(run, "deadline_missed", False)),
                "perf_regressions": 0 if watch is None
                else getattr(watch, "regressions", 0),
                "priority": int(j.spec.priority),
                "devices": None if j.gg is None
                else int(j.gg.dims[0]) * int(j.gg.dims[1])
                * int(j.gg.dims[2]),
            }
        queue = {
            "queued": sum(1 for j in self._order
                          if j.state == JobState.QUEUED),
            "running": sum(1 for j in self._order
                           if j.state == JobState.RUNNING),
        }
        if self.queue is not None:
            queue["pending"] = self.queue.pending_count()
            queue["oldest_age_s"] = self.queue.oldest_age_s()
        return {"t": time.time(), "jobs": jobs, "procs": {},
                "queue": queue,
                "scheduler": {"slices": self.slices,
                              "draining": self._draining}}

    def _poll_control(self) -> None:
        """Control channel: cancel, drain and resize requests filed
        through the queue backend (the JAX package's CLI and HTTP API, an
        alert sink); a live scheduler consumes them at slice boundaries."""
        if self.queue is None:
            return
        for req in self.queue.poll_control():
            kind = req["request"]
            if kind == "drain":
                self._log("control", request="drain")
                self.drain()
            elif kind == "cancel":
                name, payload = req["job"], req.get("payload")
                # a cancel filed WITH a trace (the HTTP API's request
                # span, or the alert span a ControlFileSink acted on)
                # parents the control event — "why was my job
                # cancelled" is one trace walk back to the decider
                ctx = self._parse_traceparent(payload)
                self._log("control", request="cancel", job=name,
                          **(ctx.fields() if ctx is not None else {}))
                job = self.jobs.get(name)
                if job is not None and not job.finished:
                    self.cancel(name)
            elif kind == "resize":
                name, payload = req["job"], req.get("payload")
                ctx = self._parse_traceparent(payload)
                if isinstance(payload, dict):
                    payload = {k: v for k, v in payload.items()
                               if k != "traceparent"}
                self._log("control", request="resize", job=name,
                          payload=payload,
                          **(ctx.fields() if ctx is not None else {}))
                job = self.jobs.get(name)
                if job is None or job.finished \
                        or not isinstance(payload, dict):
                    # never drop an operator request silently
                    self._log("resize_rejected", job=name,
                              error=("malformed control payload"
                                     if not isinstance(payload, dict) else
                                     "unknown or finished job"))
                    continue
                try:
                    self.resize(name, payload.get("new_dims", ()),
                                via=payload.get("via", "auto"))
                except (InvalidArgumentError, ValueError, TypeError) as e:
                    # ValueError/TypeError: non-integer new_dims in a
                    # hand-written control file — an operator typo must
                    # not take the scheduler (and every tenant) down
                    self._log("resize_rejected", job=name, error=str(e))

    def _alert_trace(self, transition: dict) -> dict:
        """`AlertEngine.tracer` hook: the transition as a child span of
        the affected job's trace (empty for untraced/unattributed)."""
        job = self.jobs.get(transition.get("job"))
        tr = getattr(job, "trace", None)
        return tr.child().fields() if tr is not None else {}

    @staticmethod
    def _parse_traceparent(rec) -> TraceContext | None:
        """A queue record's / control payload's ``traceparent`` as a
        fresh CHILD context of the requester's span; None when absent or
        malformed (a bad header degrades to an untraced job — it never
        rejects work)."""
        tp = rec.get("traceparent") if isinstance(rec, dict) else None
        if not tp:
            return None
        try:
            return TraceContext.parse(str(tp)).child()
        except InvalidArgumentError:
            return None

    def _poll_queue(self) -> None:
        """Claim at most ONE pending record from the queue backend per
        scheduling decision — claims interleave with slices, so N
        schedulers sharing a backend each take work at the rate they
        can serve it (and the atomic-rename claim guarantees every
        record is admitted by exactly one of them)."""
        if self.queue is None or self._draining:
            return
        claimed = self.queue.claim()
        if claimed is None:
            return
        name = claimed["name"]
        if claimed.get("record") is None:
            self._log("submit_rejected", job=name,
                      error=claimed.get("error") or "unreadable record")
            return
        # the record's traceparent (the API's submit span) becomes the
        # job's ROOT context: job_claimed IS the root span, its parent
        # the HTTP submit — one connected tree from request to slices
        trace = self._parse_traceparent(claimed["record"])
        self._log("job_claimed", job=name,
                  owner=getattr(self.queue, "owner", None),
                  **(trace.fields() if trace is not None else {}))
        try:
            spec = jobspec_from_json(claimed["record"],
                                     where=f"queue record {name!r}")
            if spec.name != name:
                raise InvalidArgumentError(
                    f"queue record {name!r} names job {spec.name!r} — "
                    "the record key and its 'name' must agree.")
            self.submit(spec, trace=trace)
        except InvalidArgumentError as e:
            # a malformed record must not take the scheduler (and every
            # tenant) down — journal the rejection and keep serving
            self._log("submit_rejected", job=name, error=str(e))

    def _admit(self, job: Job) -> None:
        """First slice grant: build the job's grid over the shared device
        pool, run its setup under that grid, construct its `ResilientRun`.
        All of it streams into the job's own flight recorder; the cost is
        journaled as ``admit_s`` (the admission analog of a cold chunk).

        A tuned job (``RunSpec.tuned`` — `telemetry.tune_config` output)
        is LOADED-AND-APPLIED here: the config's trace-time knobs
        (``IGG_COMM_EVERY`` / wire dtype / coalescing) scope the setup —
        so a setup that consults the environment (the builtin model
        inits do) builds the tuned step — a tuned ``ensemble`` fills an
        unset ``RunSpec.ensemble`` (the guard then trips per member),
        and the applied knob set is journaled as ``job_tuned``. The
        `ResilientRun` keeps scoping the same knobs around every slice's
        chunks."""
        import contextlib
        import dataclasses

        from ..parallel.grid import init_global_grid
        from ..telemetry.tune import _scoped_env, resolve_tuned

        t0 = time.monotonic()
        # the gauge scope first: it cannot fail, and the failure path
        # below accounts the slice through it (a raising recorder/grid/
        # setup must fail THIS job, never crash the scheduler)
        job.scope = hooks.job_gauges(None, job.name)
        if self.flight_dir is not None:
            job.recorder = FlightRecorder(
                os.path.join(self.flight_dir, f"job_{job.name}.jsonl"),
                run_id=job.name)
            # every driver event of this job (run/chunk/guard_trip/
            # resize) joins the job's trace as a child of its root span
            job.recorder.trace = job.trace
        run_spec = job.spec.run
        tuned = resolve_tuned(run_spec.tuned)
        if tuned is not None and run_spec.ensemble is None \
                and tuned.ensemble is not None:
            run_spec = dataclasses.replace(run_spec,
                                           ensemble=int(tuned.ensemble))
        knob_scope = (_scoped_env(tuned.env()) if tuned is not None
                      else contextlib.nullcontext())
        prev = top.swap_global_grid(None)
        try:
            init_global_grid(**{"quiet": True, **job.spec.grid})
            job.gg = top.global_grid()
            top.retain_epoch(job.gg.epoch)
            if self.nranks is not None and job.gg.nprocs > self.nranks:
                # the JAX package's device pool refuses such a grid at init
                raise InvalidArgumentError(
                    f"Grid of {job.gg.nprocs} ranks exceeds the rank pool "
                    f"of {self.nranks} (MeshScheduler(nranks=)).")
            with use_flight_recorder(job.recorder), knob_scope:
                step_local, state = job.spec.setup()
                unit_price_s = self._price_admission(job, run_spec,
                                                     tuned, state)
                if unit_price_s is not None \
                        and run_spec.perf_model is None:
                    # hand the admission price to the driver as its
                    # perf model: the deadline-slack gauge then prices
                    # remaining work from the first boundary instead of
                    # waiting for a warm measured baseline
                    run_spec = dataclasses.replace(
                        run_spec, perf_model=float(unit_price_s))
                if job.spec.deadline_s is not None \
                        and run_spec.deadline_s is None:
                    # hand the REMAINING budget to the runtime surface:
                    # the driver fires deadline_missed (event + counter)
                    # when an admitted job crosses it anyway
                    left = float(job.spec.deadline_s) - max(
                        0.0, time.time() - (job.submitted_t
                                            or time.time()))
                    run_spec = dataclasses.replace(
                        run_spec, deadline_s=max(1e-9, left))
                job.run = ResilientRun(step_local, state,
                                       int(job.spec.nt), run_spec)
        except BaseException:
            if job.gg is not None:
                top.release_epoch(job.gg.epoch)
                _evict_epoch_caches(job.gg.epoch)
                job.gg = None
            raise
        finally:
            top.swap_global_grid(prev)
        job.state = JobState.RUNNING
        job.started_t = time.time()
        job.admit_s = time.monotonic() - t0
        self._update_queue_gauges()
        if tuned is not None:
            self._log("job_tuned", job=job.name, model=tuned.model,
                      **tuned.knobs(), speedup=tuned.speedup)
        self._log("job_admitted", job=job.name, admit_s=job.admit_s,
                  epoch=int(job.gg.epoch))
        hooks.note_job_target_devices(
            job.scope, int(job.gg.dims[0]) * int(job.gg.dims[1])
            * int(job.gg.dims[2]))

    def _price_admission(self, job: Job, run_spec, tuned, state):
        """Deadline-aware admission (runs under the job's grid, state
        built): price the job's expected mesh-seconds with the
        cost model — ``predict_step`` on the job's OWN field shapes,
        honoring its tuned knob set and ensemble width — and refuse a
        job whose priced completion provably busts what is left of its
        ``deadline_s`` budget. Every verdict (admit AND reject) is
        journaled as ``admission_priced`` with the full pricing inputs,
        so `service_report` can defend it post-hoc. Unpriceable jobs
        (no ``model``, a non-workload model, a cost-model refusal)
        always admit — admission only rejects what it can PROVE.

        Returns the priced per-nt-unit step cost (seconds) on a priced
        admit, None otherwise — `_admit` hands it to the driver as the
        run's perf model when the spec left one unset."""
        spec = job.spec
        if spec.deadline_s is None:
            return None
        from ..telemetry.perfmodel import (
            STEP_WORKLOADS, default_machine_profile, predict_step,
        )

        waited_s = max(0.0, time.time() - (job.submitted_t
                                           or time.time()))
        budget_s = float(spec.deadline_s) - waited_s
        if spec.model not in STEP_WORKLOADS:
            self._log("admission_priced", job=job.name, verdict="admit",
                      priced_by="unpriceable", model=spec.model,
                      deadline_s=float(spec.deadline_s),
                      waited_s=waited_s, budget_s=budget_s)
            return None
        from ..models.common import resolve_comm_every

        E = run_spec.ensemble
        # per-member stacked shapes in canonical state order (the
        # builtin setups build the dict in exactly that order); an
        # ensemble state carries members on a leading axis predict_step
        # must not read as geometry
        from ..telemetry.tune import _Spec

        fields = tuple(
            _Spec(tuple(v.shape[1:] if E else v.shape), v.dtype)
            for v in state.values())
        knobs = dict(comm_every=1, overlap=False, coalesce=None,
                     wire_dtype=None, wire_stage=None)
        if tuned is not None:
            knobs = dict(comm_every=tuned.comm_every,
                         overlap=bool(tuned.overlap),
                         coalesce=tuned.coalesce,
                         wire_dtype=tuned.wire_dtype,
                         wire_stage=tuned.wire_stage)
        try:
            pred = predict_step(spec.model, fields,
                                profile=default_machine_profile(),
                                ensemble=E, **knobs)
        except Exception as e:
            # the cost model refusing a geometry is not a admission
            # failure — an unpriceable job admits (and says why)
            self._log("admission_priced", job=job.name, verdict="admit",
                      priced_by="unpriceable", model=spec.model,
                      error=f"{type(e).__name__}: {e}",
                      deadline_s=float(spec.deadline_s),
                      waited_s=waited_s, budget_s=budget_s)
            return None
        cadence = resolve_comm_every(knobs["comm_every"])
        # a deep cadence makes the job's step the SUPER-STEP (the
        # builtin setups' rule): one nt unit = cadence.cycle physical
        # steps, each priced at step_s
        steps_per_unit = cadence.cycle if cadence.deep else 1
        price_s = pred["step_s"] * steps_per_unit * int(spec.nt)
        verdict = "admit" if price_s <= budget_s else "reject"
        rec = dict(job=job.name, verdict=verdict,
                   admit_price_s=price_s, step_price_s=pred["step_s"],
                   nt=int(spec.nt), steps_per_unit=steps_per_unit,
                   deadline_s=float(spec.deadline_s), waited_s=waited_s,
                   budget_s=budget_s, bound=pred.get("bound"),
                   profile_source=pred.get("profile_source"),
                   model=spec.model, ensemble=E,
                   priced_by="predict_step")
        self._log("admission_priced", **rec)
        if verdict == "reject":
            raise _DeadlineRejected(rec)
        return pred["step_s"] * steps_per_unit

    def _retune(self, job: Job, reason) -> bool:
        """Boundary re-tune (the autoscale loop's closing rung): re-RUN
        `telemetry.tune_config` against the job's LIVE geometry —
        model-only (``measure=False``; a measured calibration run would
        stall every tenant) — and apply the winner to the running job
        (`ResilientRun.apply_tuned`). Structural knobs are FROZEN at
        their live values: ``comm_every`` is baked into the
        step body at setup, ``overlap`` schedules that body, and
        ``ensemble`` shapes the state — only re-admission could change
        them. ``wire_dtype`` is frozen too: a re-tune must never switch
        a tenant onto a lossy wire mid-run (trajectories stay
        bit-identical to the solo reference). What IS searched are the
        bit-exact transport knobs — halo coalescing and the
        topology-staged wire. Journals ``job_retuned`` (or
        ``job_retune_failed``) and re-prices the driver so deadline
        slack tracks the tuned geometry. Returns True when a config was
        applied."""
        from ..models.common import resolve_comm_every
        from ..telemetry.tune import _MODEL_STAGGER, tune_config

        model = job.spec.model
        if model not in _MODEL_STAGGER or job.run is None \
                or job.gg is None:
            return False
        t0 = time.monotonic()
        gg = job.gg
        run = job.run
        tuned = run.tuned
        cur = dict(comm_every=1, overlap=False, coalesce=True,
                   wire_dtype=None, wire_stage=None)
        if tuned is not None:
            cur = dict(comm_every=tuned.comm_every,
                       overlap=bool(tuned.overlap),
                       coalesce=tuned.coalesce,
                       wire_dtype=tuned.wire_dtype,
                       wire_stage=tuned.wire_stage)
        n = tuple(int(v) for v in gg.nxyz)
        grid = dict(nx=n[0], ny=n[1], nz=n[2],
                    dimx=int(gg.dims[0]), dimy=int(gg.dims[1]),
                    dimz=int(gg.dims[2]),
                    periodx=int(gg.periods[0]),
                    periody=int(gg.periods[1]),
                    periodz=int(gg.periods[2]),
                    overlaps=tuple(int(o) for o in gg.overlaps),
                    halowidths=tuple(int(h) for h in gg.halowidths),
                    device_type=gg.device_type)
        dtype = next(iter(run.state.values())).dtype
        try:
            cfg = tune_config(
                model, grid, dtype=dtype,
                comm_every_options=(cur["comm_every"],),
                wire_dtype_options=(cur["wire_dtype"],),
                wire_stage_options=tuple(dict.fromkeys(
                    [cur["wire_stage"], None, "z:staged"])),
                coalesce_options=tuple(dict.fromkeys(
                    [cur["coalesce"], True, False])),
                overlap_options=(cur["overlap"],),
                ensemble_options=(run.ensemble,),
                measure=False)
            run.apply_tuned(cfg)
        except Exception as e:
            self._log("job_retune_failed", job=job.name, model=model,
                      reason=reason, error=f"{type(e).__name__}: {e}")
            return False
        search_s = time.monotonic() - t0
        self._log("job_retuned", job=job.name, model=model,
                  reason=reason, **cfg.knobs(),
                  predicted_step_s=cfg.predicted_step_s,
                  search_s=search_s)
        if cfg.predicted_step_s:
            cadence = resolve_comm_every(cfg.comm_every)
            spu = cadence.cycle if cadence.deep else 1
            try:
                run.reprice(float(cfg.predicted_step_s) * spu,
                            source="autoscale_retune")
            except InvalidArgumentError:
                pass
        return True

    def _slice(self, job: Job) -> None:
        """Grant ``job`` one chunk-boundary slice (admitting it first if
        this is its first grant). A raising slice FAILS the job alone."""
        t_pick = time.monotonic()
        wait_s = max(0.0, t_pick - (job.last_end_t or t_pick))
        chunks0 = 0 if job.run is None else len(job.run.reports)
        resized = False
        try:
            if job.state == JobState.QUEUED:
                self._admit(job)
            resize_req, job.resize_requested = job.resize_requested, None
            prev = top.swap_global_grid(job.gg)
            try:
                with use_flight_recorder(job.recorder):
                    if resize_req is not None:
                        # the resize consumes this slice: one epoch-
                        # swapping re-block at the chunk boundary, then
                        # the job resumes its schedule next grant. A
                        # FAILED resize rejects the request and keeps
                        # the tenant running — one fat-fingered dims
                        # request must not kill a long-lived job (the
                        # driver restores its grid on device-path
                        # failures and the checkpoint fallback is
                        # non-destructive)
                        new_dims, via = resize_req
                        try:
                            rec = job.run.resize(new_dims, via=via)
                        except Exception as e:
                            self._log("resize_rejected", job=job.name,
                                      new_dims=list(new_dims), via=via,
                                      error=f"{type(e).__name__}: {e}")
                            more = not job.run.done
                            if self.autoscaler is not None:
                                self.autoscaler.on_resize_rejected(job)
                        else:
                            resized = True
                            more = not job.run.done
                            self._log("job_resized", job=job.name,
                                      new_dims=list(new_dims),
                                      via=rec.get("via"),
                                      dur_s=rec.get("seconds"),
                                      rounds=rec.get("rounds"),
                                      wire_bytes=rec.get("wire_bytes"),
                                      step=job.step)
                            if self.autoscaler is not None:
                                # the policy repriced this geometry when
                                # it filed the move: hand the driver the
                                # priced unit cost so slack converges
                                self.autoscaler.on_resized(job, new_dims)
                    else:
                        more = job.run.advance()
                # a resize or elastic restart inside the slice re-inits
                # the grid: track the NEW one (retire the dead epoch)
                cur = top._global_grid
                if cur is not job.gg and cur is not None:
                    old = job.gg
                    job.gg = cur
                    top.retain_epoch(cur.epoch)
                    top.release_epoch(old.epoch)
                    _evict_epoch_caches(old.epoch)
                    if job.scope is not None:
                        hooks.note_job_target_devices(
                            job.scope,
                            int(cur.dims[0]) * int(cur.dims[1])
                            * int(cur.dims[2]))
            finally:
                top.swap_global_grid(prev)
        except _DeadlineRejected as e:
            # an admission verdict, not a failure: the job never ran
            job.error = str(e)
            self._account_slice(job, t_pick, wait_s, chunks0)
            self._finalize(job, JobState.REJECTED)
            return
        except Exception as e:
            job.error = f"{type(e).__name__}: {e}"
            self._account_slice(job, t_pick, wait_s, chunks0)
            self._finalize(job, JobState.FAILED)
            return
        self._account_slice(job, t_pick, wait_s, chunks0)
        # a running job crossing its deadline (the driver flagged it at
        # a chunk boundary): journal it ONCE — the admission verdict
        # said yes, the operator deserves to see where it went wrong
        if job.run is not None \
                and getattr(job.run, "deadline_missed", False) \
                and not job.deadline_logged:
            job.deadline_logged = True
            # the budget the driver actually watched (run-level, which
            # _admit derives from the job deadline when unset)
            self._log("deadline_missed", job=job.name, step=job.step,
                      deadline_s=job.run.deadline_s)
        # re-tune trigger (ROADMAP tuner rung c): a resize or PerfWatch
        # drift marked the applied TunedConfig stale. With the
        # autoscaler's closed loop on (policy.retune), the scheduler
        # re-RUNS the tuner against the live geometry right here at the
        # boundary — model-only, trace-time knobs — and applies the
        # winner; otherwise (or when the re-tune itself fails) it falls
        # back to clearing the stale config (journaled; the operator
        # re-runs `tune_config`). A resize of a never-tuned job re-tunes
        # too: the new geometry deserves a knob search either way.
        retune_on = self.autoscaler is not None \
            and self.autoscaler.policy.retune and not job.finished
        if job.run is not None and getattr(job.run, "tuned_stale", False):
            reason = job.run.tuned_stale_reason
            if not (retune_on and self._retune(job, reason)):
                job.run.clear_tuned()
                self._log("job_tuned_cleared", job=job.name,
                          reason=reason)
        elif resized and retune_on and job.run is not None \
                and not job.run.done:
            self._retune(job, "resize")
        if not more:
            self._finalize(job, JobState.DONE)

    def _account_slice(self, job: Job, t_pick: float, wait_s: float,
                       chunks0: int) -> None:
        t_end = time.monotonic()
        slice_s = t_end - t_pick
        job.slices += 1
        job.slice_s_total += slice_s
        job.wait_s_total += wait_s
        job.last_end_t = t_end
        self.slices += 1
        self.policy.granted(job, slice_s)
        # mirror the perf oracle's process-wide gauges (they flap between
        # tenants under multiplexing) into this job's labeled copies —
        # only when THIS slice actually ran a chunk (a fault-boundary or
        # elastic-restart iteration dispatches none, and the global gauge
        # still holds the PREVIOUS tenant's value) — and attribute audit
        # findings by diffing the global family against the scheduler's
        # baseline (slices are serialized, so the growth is this job's)
        ran_chunk = job.run is not None and len(job.run.reports) > chunks0
        reg = hooks.metrics_registry()
        perf_step_s = perf_ratio = None
        if ran_chunk and job.run.watch is not None:
            fam = reg.get(hooks.PERF_STEP_S)
            if fam is not None:
                samples = fam.samples()
                if samples:
                    perf_step_s = samples[0][1]
            if job.run.watch.model_step_s:
                fam = reg.get(hooks.PERF_RATIO)
                if fam is not None:
                    samples = fam.samples()
                    if samples:
                        perf_ratio = samples[0][1]
        total = self._audit_total()
        findings = total - self._audit_seen
        self._audit_seen = total
        slack_s = None if job.run is None \
            else getattr(job.run, "deadline_slack_s", None)
        hooks.observe_job_slice(
            job.scope, step=job.step, slice_s=slice_s, wait_s=wait_s,
            perf_step_s=perf_step_s, perf_ratio=perf_ratio,
            audit_findings=max(0.0, findings), slack_s=slack_s)
        # batched (ensemble) jobs: mirror the LAST chunk's per-member
        # guard verdicts into this job's scoped registry — the global
        # igg_member_* series flap between tenants exactly like the perf
        # gauges; the job-labeled copies are the per-scenario surface an
        # operator watches
        # the RUN's member count (a tuned config may have filled an
        # unset RunSpec.ensemble at admission — the spec alone is stale)
        E = None if job.run is None else job.run.ensemble
        if ran_chunk and E:
            members = job.run.reports[-int(E):]
            if len(members) == int(E) and all(
                    r.member is not None for r in members):
                hooks.observe_member_health(members, scope=job.scope)
        self._log("slice", job=job.name, slice=self.slices - 1,
                  step=job.step, dur_s=slice_s, wait_s=wait_s,
                  policy=self.policy.name, slack_s=slack_s)

    def _finalize(self, job: Job, state: str) -> None:
        """Move a job to a terminal state and release its resources (run
        close → snapshot drain; epoch release → cache eviction; recorder
        close). The job's labeled metric series survive until the
        SCHEDULER closes — a finished tenant's final step/latencies stay
        scrapeable across job lifetimes."""
        if job.finished:
            return
        if job.resize_requested is not None:
            # never drop an operator request silently: a job reaching a
            # terminal state with a resize still pending journals the
            # rejection (the control-poll path's rule)
            new_dims, via = job.resize_requested
            job.resize_requested = None
            self._log("resize_rejected", job=job.name,
                      new_dims=list(new_dims), via=via,
                      error=f"job reached terminal state {state} before "
                            "the resize slice")
            if self.autoscaler is not None:
                self.autoscaler.on_resize_rejected(job)
        if job.run is not None:
            if state == JobState.DONE:
                from ..utils.timing import sync

                prev = top.swap_global_grid(job.gg)
                try:
                    job.result = sync(job.run.state)
                finally:
                    top.swap_global_grid(prev)
            job.reports = job.run.reports
            with use_flight_recorder(job.recorder):
                job.run.close()
        job.state = state
        job.finished_t = time.time()
        if job.recorder is not None:
            job.recorder.close()
        if job.gg is not None:
            top.release_epoch(job.gg.epoch)
            _evict_epoch_caches(job.gg.epoch)
        hooks.note_job_transition(state)
        self._update_queue_gauges()
        self._log("job_" + state, job=job.name, step=job.step,
                  slices=job.slices, slice_s_total=job.slice_s_total,
                  wait_s_total=job.wait_s_total, error=job.error)
