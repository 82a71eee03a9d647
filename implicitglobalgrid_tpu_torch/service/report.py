"""Post-hoc service view: the interleaved schedule, reconstructed.

Counterpart of `implicitglobalgrid_tpu/service/report.py`, whole, on the
port's own `telemetry.report` and `telemetry.trace_export`: it reads either
package's scheduler directories. A scheduler run leaves one directory of
JSONLs behind: the scheduler's own journal (``scheduler.jsonl`` —
submissions, admissions, every granted slice, terminal transitions) plus one
flight stream per job (``job_<name>.jsonl`` — the same driver lifecycle a
solo `run_resilient` records). Everything here is reconstructed from those files ALONE, hours
after the process died:

- `service_report(dir)` — the ``"service"`` record: per-tenant accounting
  (slices, mesh-time share, wait fractions, cold compiles, terminal
  state), the interleaved slice schedule, queue-depth trajectory, and a
  per-tenant straggler summary; each job's full `telemetry.run_report`
  rides along under ``jobs.<name>.report``. `run_report(dir)`
  delegates here when it sees a scheduler journal.
- `export_service_trace(dir)` — Chrome/Perfetto trace JSON with ONE TRACK
  PER JOB (each job's chunk/checkpoint/snapshot spans and guard markers,
  exactly as `telemetry.export_chrome_trace` draws a process) plus a
  scheduler track whose slice spans show who owned the mesh when — the
  interleaving is visible as non-overlapping chunk spans across job
  tracks. All streams share one process's monotonic clock, so no
  cross-clock alignment is needed (unlike the multi-process aggregate).
"""

from __future__ import annotations

import json
import os

from ..telemetry.recorder import read_flight_events
from ..utils.exceptions import InvalidArgumentError

__all__ = ["service_report", "export_service_trace", "read_journal",
           "explain_autoscale"]

_JOURNAL = "scheduler.jsonl"
_TERMINAL_KINDS = {"job_done": "done", "job_failed": "failed",
                   "job_cancelled": "cancelled",
                   "job_rejected": "rejected"}


def journal_path(flight_dir) -> str:
    return os.path.join(os.fspath(flight_dir), _JOURNAL)


def is_service_dir(path) -> bool:
    """True when ``path`` is a scheduler flight directory (has a
    journal) — how `run_report` decides to delegate here."""
    try:
        return os.path.isfile(journal_path(path))
    except (TypeError, ValueError):
        return False


def read_journal(source) -> list:
    """Journal events from a flight directory or a journal file path."""
    src = os.fspath(source)
    if os.path.isdir(src):
        src = journal_path(src)
    if not os.path.isfile(src):
        raise InvalidArgumentError(
            f"No scheduler journal at {src} (expected a MeshScheduler "
            "flight_dir or its scheduler.jsonl).")
    return read_flight_events(src)


def _job_file(flight_dir, name: str) -> str | None:
    p = os.path.join(os.fspath(flight_dir), f"job_{name}.jsonl")
    return p if os.path.isfile(p) else None


def _autoscale_moves(events: list) -> list:
    """Reconstruct every autoscaler-FILED move's actuation chain from
    the journal alone: ``autoscale_decision`` (verdict filed) ->
    ``control`` -> ``resize_requested`` -> ``job_resized`` ->
    ``job_retuned`` — the proof each resize went through the same
    control path an operator's would, with its pricing attached."""
    moves: list = []
    pending: dict = {}
    for e in events:
        k = e.get("kind")
        name = e.get("job")
        if k == "autoscale_decision" and e.get("verdict") == "filed":
            rec = {"job": name, "action": e.get("action"),
                   "dims": e.get("dims"), "new_dims": e.get("new_dims"),
                   "t_decided": e.get("t"), "via": e.get("via"),
                   "streak": e.get("streak"),
                   "signals": e.get("signals"),
                   "pricing": e.get("pricing"),
                   "applied": False, "chain": ["autoscale_decision"]}
            pending[name] = rec
            moves.append(rec)
            continue
        rec = pending.get(name)
        if rec is None:
            continue
        if k == "control" and e.get("request") == "resize" \
                and not rec["applied"]:
            rec["chain"].append("control")
        elif k == "resize_requested" and not rec["applied"]:
            rec["chain"].append("resize_requested")
        elif k == "job_resized":
            if list(e.get("new_dims") or ()) \
                    == list(rec["new_dims"] or ()):
                rec.update(applied=True, t_applied=e.get("t"),
                           resize_s=e.get("dur_s"), step=e.get("step"))
                rec["chain"].append("job_resized")
        elif k == "resize_rejected" and not rec["applied"]:
            rec["rejected"] = e.get("error")
            rec["chain"].append("resize_rejected")
            del pending[name]
        elif k == "job_retuned" and rec["applied"]:
            rec["retuned"] = {key: v for key, v in e.items()
                              if key not in ("kind", "t", "run", "job")}
            rec["chain"].append("job_retuned")
            del pending[name]
        elif k == "job_retune_failed" and rec["applied"]:
            rec["retune_failed"] = e.get("error")
            rec["chain"].append("job_retune_failed")
            del pending[name]
    return moves


def _autoscale_section(events: list):
    """The ``"autoscale"`` report section (None when the run had no
    autoscaler and no decisions): policy echo, verdict counts,
    rejection histogram, and the reconstructed move chains."""
    start = next((e for e in events
                  if e.get("kind") == "scheduler_start"), None)
    decisions = [e for e in events
                 if e.get("kind") == "autoscale_decision"]
    policy = (start or {}).get("autoscale")
    if not decisions and policy is None:
        return None
    reasons: dict = {}
    filed = rejected = 0
    for e in decisions:
        if e.get("verdict") == "filed":
            filed += 1
        elif e.get("verdict") == "rejected":
            rejected += 1
            r = str(e.get("reason"))
            reasons[r] = reasons.get(r, 0) + 1
    return {"policy": policy, "decisions": len(decisions),
            "filed": filed, "rejected": rejected,
            "rejected_by_reason": reasons,
            "moves": _autoscale_moves(events)}


def explain_autoscale(source) -> dict:
    """WHY did the mesh resize itself — reconstructed from the journal
    ALONE (the engine of the JAX package's ``tools autoscale explain``). The
    `_autoscale_section` record (policy echo, verdict counts, every
    filed move's full actuation chain with its pricing breakdown) plus
    ``jobs``: each job's complete decision history — every journaled
    verdict with its signal snapshot, so a rejection ("hysteresis",
    "cooldown", "priced_out", ...) is as explainable as a move."""
    events = read_journal(source)
    sec = _autoscale_section(events) or {
        "policy": None, "decisions": 0, "filed": 0, "rejected": 0,
        "rejected_by_reason": {}, "moves": []}
    per_job: dict = {}
    for e in events:
        if e.get("kind") != "autoscale_decision":
            continue
        per_job.setdefault(str(e.get("job")), []).append(
            {k: v for k, v in e.items()
             if k not in ("kind", "run")})
    sec["jobs"] = per_job
    return sec


def service_report(source, *, include_jobs: bool = True) -> dict:
    """The unified service record for one scheduler run (see module
    docstring). ``source`` is the scheduler ``flight_dir`` (or its
    journal file — then per-job reports are attached only if the job
    files sit next to it). ``include_jobs=False`` skips the per-job
    `run_report` attachments (the journal-derived accounting remains)."""
    src = os.fspath(source)
    flight_dir = src if os.path.isdir(src) else os.path.dirname(src)
    events = read_journal(src)

    start = next((e for e in events if e.get("kind") == "scheduler_start"),
                 None)
    stop = next((e for e in events if e.get("kind") == "scheduler_stop"),
                None)
    jobs: dict = {}
    order: list = []

    def rec(name):
        if name not in jobs:
            jobs[name] = {"name": name, "state": "queued", "slices": 0,
                          "slice_s_total": 0.0, "wait_s_total": 0.0,
                          "admit_s": None, "step": None, "error": None}
            order.append(name)
        return jobs[name]

    schedule: list = []
    submit_rejected: list = []
    alerts: list = []
    switches = 0
    prev_job = None
    queued = running = 0
    max_queued = 0
    for e in events:
        k = e.get("kind")
        if k == "job_submitted":
            r = rec(e["job"])
            r.update(nt=e.get("nt"), priority=e.get("priority"),
                     deadline_s=e.get("deadline_s"), grid=e.get("grid"),
                     run_spec=e.get("run_spec"), submitted_t=e.get("t"))
            queued += 1
            max_queued = max(max_queued, queued)
        elif k == "job_admitted":
            r = rec(e["job"])
            r["admit_s"] = e.get("admit_s")
            r["state"] = "running"
            queued -= 1
            running += 1
        elif k == "job_claimed":
            # the record arrived through a queue backend (CLI drop /
            # HTTP POST) — who claimed it, for multi-scheduler forensics
            r = rec(e["job"])
            r["claimed_by"] = e.get("owner")
            if e.get("trace_id") is not None:
                # the distributed-trace identity the submitter's
                # traceparent seeded — the handle for export_otlp
                # --trace-id / any collector query
                r["trace_id"] = e.get("trace_id")
        elif k == "admission_priced":
            # the deadline-admission verdict WITH its pricing inputs —
            # the journal defends every reject (and every admit)
            rec(e["job"])["admission"] = {
                key: v for key, v in e.items()
                if key not in ("kind", "t", "run", "job")}
        elif k == "deadline_missed":
            r = rec(e["job"])
            r["deadline_missed"] = {"step": e.get("step"),
                                    "deadline_s": e.get("deadline_s")}
        elif k == "submit_rejected":
            submit_rejected.append({"job": e.get("job"),
                                    "error": e.get("error")})
        elif k == "alert":
            alerts.append(e)
            if e.get("job"):
                rec(e["job"]).setdefault("alerts", []).append(
                    {"rule": e.get("rule"), "state": e.get("state"),
                     "severity": e.get("severity"), "t": e.get("t")})
        elif k == "job_resized":
            r = rec(e["job"])
            r["resizes"] = r.get("resizes", 0) + 1
            r["dims"] = e.get("new_dims")
        elif k == "job_retuned":
            r = rec(e["job"])
            r["retunes"] = r.get("retunes", 0) + 1
        elif k == "slice":
            r = rec(e["job"])
            r["slices"] += 1
            r["slice_s_total"] += float(e.get("dur_s", 0.0) or 0.0)
            r["wait_s_total"] += float(e.get("wait_s", 0.0) or 0.0)
            r["step"] = e.get("step")
            if e.get("slack_s") is not None:
                r["slack_s_last"] = e["slack_s"]
            schedule.append({"t": e.get("t"), "job": e["job"],
                             "slice": e.get("slice"), "step": e.get("step"),
                             "dur_s": e.get("dur_s"),
                             "wait_s": e.get("wait_s")})
            if prev_job is not None and e["job"] != prev_job:
                switches += 1
            prev_job = e["job"]
        elif k in _TERMINAL_KINDS:
            r = rec(e["job"])
            was = r["state"]
            r["state"] = _TERMINAL_KINDS[k]
            r["step"] = e.get("step", r["step"])
            r["error"] = e.get("error")
            if was == "running":
                running -= 1
            elif was == "queued":
                queued -= 1

    mesh_s = sum(r["slice_s_total"] for r in jobs.values())
    for r in jobs.values():
        r["mesh_share"] = (r["slice_s_total"] / mesh_s) if mesh_s else 0.0
        busy = r["slice_s_total"] + r["wait_s_total"]
        r["wait_frac"] = (r["wait_s_total"] / busy) if busy else 0.0
    # per-tenant straggler attribution: who holds the mesh longest per
    # granted slice (the single-process analog of the cross-process
    # barrier-spread report — a tenant with outsized slices delays every
    # other tenant's next grant)
    slowest = None
    for r in jobs.values():
        if r["slices"]:
            mean = r["slice_s_total"] / r["slices"]
            if slowest is None or mean > slowest[1]:
                slowest = (r["name"], mean)
    ts = [e["t"] for e in events if "t" in e]

    report = {
        "policy": (start or {}).get("policy"),
        "jobs_submitted": len(jobs),
        "states": {s: sum(1 for r in jobs.values() if r["state"] == s)
                   for s in sorted({r["state"] for r in jobs.values()})},
        "slices": len(schedule),
        "switches": switches,
        "mesh_busy_s": mesh_s,
        "makespan_s": (max(ts) - min(ts)) if ts else None,
        "max_queue_depth": max_queued,
        "slowest_tenant": None if slowest is None
        else {"job": slowest[0], "mean_slice_s": slowest[1]},
        "jobs": {name: jobs[name] for name in order},
        "schedule": schedule,
    }
    from ..telemetry.report import _alerts_section

    report["alerts"] = _alerts_section(alerts)
    autoscale = _autoscale_section(events)
    if autoscale is not None:
        report["autoscale"] = autoscale
    if submit_rejected:
        report["submit_rejected"] = submit_rejected
    if stop is not None:
        report["closed"] = True
    if include_jobs:
        from ..telemetry.report import run_report

        for name in order:
            path = _job_file(flight_dir, name)
            if path is not None:
                jobs[name]["report"] = run_report(
                    path, include_metrics=False)
    return report


def export_service_trace(source, out=None):
    """Chrome/Perfetto trace of one scheduler run: track 0 is the
    SCHEDULER (each granted slice as a span named by its job — mesh
    ownership over time), and every job gets ITS OWN track carrying the
    full per-run rendering (chunk spans with build/exec nesting,
    checkpoint/snapshot spans, guard-trip/rollback/fault instant
    markers, counter tracks). With ``out``, writes the JSON and returns
    the path; otherwise returns the trace dict. Open at
    https://ui.perfetto.dev."""
    from ..telemetry.trace_export import (
        _emit_event, _span_start, _track_meta,
    )

    src = os.fspath(source)
    flight_dir = src if os.path.isdir(src) else os.path.dirname(src)
    journal = read_journal(src)
    names: list = []
    for e in journal:
        if e.get("kind") == "job_submitted" and e["job"] not in names:
            names.append(e["job"])
    streams = {}
    for name in names:
        path = _job_file(flight_dir, name)
        if path is not None:
            streams[name] = read_flight_events(path)

    starts = [s for s in map(_span_start, journal) if s is not None]
    for evs in streams.values():
        starts.extend(s for s in map(_span_start, evs) if s is not None)
    if not starts:
        raise InvalidArgumentError(
            "export_service_trace: no timestamped events.")
    t0 = min(starts)

    def us(t: float) -> float:
        return (float(t) - t0) * 1e6

    trace: list = []
    trace.append({"ph": "M", "pid": 0, "name": "process_name",
                  "args": {"name": "scheduler"}})
    trace.append({"ph": "M", "pid": 0, "tid": 0, "name": "thread_name",
                  "args": {"name": "slices"}})
    queued = 0
    admitted: set = set()
    for e in journal:
        k = e.get("kind")
        if "t" not in e:
            continue
        t = float(e["t"])
        if k == "slice":
            dur = float(e.get("dur_s", 0.0) or 0.0)
            trace.append({"ph": "X", "pid": 0, "tid": 0, "cat": "slice",
                          "name": e.get("job"), "ts": us(t - dur),
                          "dur": dur * 1e6,
                          "args": {"job": e.get("job"),
                                   "step": e.get("step"),
                                   "wait_s": e.get("wait_s")}})
        elif k == "job_submitted":
            queued += 1
            trace.append({"ph": "C", "pid": 0, "name": "igg_jobs_queued",
                          "ts": us(t), "args": {"jobs": queued}})
        elif k == "job_admitted":
            admitted.add(e.get("job"))
            queued -= 1
            trace.append({"ph": "C", "pid": 0, "name": "igg_jobs_queued",
                          "ts": us(t), "args": {"jobs": queued}})
        elif k == "alert":
            trace.append({"ph": "i", "pid": 0, "tid": 0, "cat": "alert",
                          "name": (f"alert {e.get('rule')} "
                                   f"{e.get('state')}"),
                          "ts": us(t), "s": "p",
                          "args": {"rule": e.get("rule"),
                                   "severity": e.get("severity"),
                                   "state": e.get("state"),
                                   "job": e.get("job"),
                                   "value": e.get("value")}})
        elif k in ("job_done", "job_failed", "job_cancelled",
                   "job_rejected", "deadline_missed", "drain",
                   "scheduler_start", "scheduler_stop", "control"):
            if k in _TERMINAL_KINDS and e.get("job") not in admitted:
                # cancelled (or admission-failed) while still QUEUED:
                # it leaves the queue here, not at an admission
                queued -= 1
                trace.append({"ph": "C", "pid": 0,
                              "name": "igg_jobs_queued", "ts": us(t),
                              "args": {"jobs": queued}})
            trace.append({"ph": "i", "pid": 0, "tid": 0, "cat": "event",
                          "name": (f"{k} {e.get('job')}" if e.get("job")
                                   else k),
                          "ts": us(t), "s": "p"})

    for i, name in enumerate(names):
        pid = i + 1
        _track_meta(trace, pid, f"job {name}")
        wire_cum = {pid: 0}
        for e in streams.get(name, ()):
            if "t" not in e or e.get("kind") is None:
                continue
            _emit_event(trace, e, pid, us, wire_cum)

    doc = {
        "traceEvents": trace,
        "displayTimeUnit": "ms",
        "otherData": {
            "source": "implicitglobalgrid_tpu_torch multi-run scheduler",
            "jobs": names,
        },
    }
    if out is None:
        return doc
    out = os.fspath(out)
    with open(out, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    return out
