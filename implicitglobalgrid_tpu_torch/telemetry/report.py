"""The unified run report: flight-recorder JSONL -> one structured record.

Counterpart of `implicitglobalgrid_tpu/telemetry/report.py`: `run_report`
reconstructs a supervised run's full event sequence (chunks, guard trips,
rollbacks, checkpoint saves/restores, escalations, elastic restarts,
snapshots) from the flight-recorder stream ALONE — either package's — and
optionally merges the live metrics registry plus a profiler capture's
`overlap_stats`/`op_breakdown`, so one JSON object answers "what happened,
what did it cost, and where did the time go" for a run that may have died
hours ago.

The port reads one process's stream (a file, or its parsed events). A
directory of per-process streams and a stream of several processes need the
JAX package's `telemetry.aggregate`, a scheduler journal its `service`:
both raise `NotSupportedError` until those modules are ported. Sections
for what the port does not emit (``runner_cache``, ``halo``, ``audit``)
read what its stream holds: a port run caches no compiled runner, so its
``runner_cache`` counts stay 0 and no chunk is cold.
"""

from __future__ import annotations

import os

from ..utils.exceptions import InvalidArgumentError, NotSupportedError
from .recorder import read_flight_events
from .registry import metrics_registry

__all__ = ["run_report"]

# Event kinds that belong in the reconstructed sequence, with the fields
# worth carrying (everything else stays in the raw stream).
_SEQ_FIELDS = {
    "run_begin": ("nt", "nt_chunk", "checkpoint_every", "names"),
    "fault_injected": ("fault", "step", "name"),
    "chunk": ("chunk", "step_begin", "step_end", "ok", "reasons",
              "build_s", "exec_s", "cold"),
    "guard_trip": ("step_end", "reasons", "retries"),
    "escalation": ("retries", "nt_chunk", "step"),
    "rollback": ("to_step", "fallback"),
    "checkpoint_save": ("op", "step", "dur_s"),
    "checkpoint_restore": ("op", "step", "dur_s"),
    "elastic_restart": ("new_dims", "to_step"),
    "snapshot": ("step", "displaced"),
    "snapshot_write": ("step", "dur_s", "nbytes", "queue_depth"),
    "snapshot_drop": ("step", "queue_depth"),
    "snapshot_error": ("step", "error"),
    "snapshot_writer_close": ("submitted", "written", "staged", "dropped",
                              "errors", "bytes"),
    "reducers": ("step", "ok", "values"),
    "audit": ("program", "dialect", "ok", "errors", "warnings", "rules",
              "audit_s"),
    "audit_failed": ("error", "audit_s", "attempt"),
    "perf_model": ("step_s", "bound", "source"),
    "tuned": ("model", "comm_every", "wire_dtype", "coalesce", "overlap",
              "ensemble", "speedup"),
    "perf_regression": ("chunk", "step_begin", "step_end", "per_step_s",
                        "baseline_s", "z", "ratio"),
    "resize": ("via", "new_dims", "step", "dur_s", "rounds",
               "wire_bytes"),
    "tuned_stale": ("reason", "model"),
    "deadline_slack": ("step", "slack_s", "budget_s", "priced_step_s",
                       "priced_by", "remaining_steps"),
    "deadline_missed": ("step", "deadline_s", "elapsed_s", "slack_s"),
    "alert": ("rule", "severity", "state", "job", "signal", "value",
              "threshold"),
    "run_end": ("completed", "chunks"),
}


def _perf_section(chunks: list, perf_model: dict | None,
                  regressions: list) -> dict:
    """The report's ``"perf"`` block: the per-step time series of the OK
    warm chunks (cold chunks pay the XLA compile inside their dispatch
    and would skew every quantile), the attached model prediction with
    the measured/modeled ratio, and the drift detector's verdicts."""
    from statistics import median

    per_step = sorted(
        c["exec_s"] / max(1, c.get("n", 1)) for c in chunks
        if c.get("ok") and not c.get("cold")
        and "exec_s" in c and c.get("n"))
    med = median(per_step) if per_step else None
    out = {
        "chunks": len(per_step),
        "step_s_median": med,
        "step_s_min": per_step[0] if per_step else None,
        "step_s_max": per_step[-1] if per_step else None,
        "regressions": len(regressions),
        "worst_z": max((r.get("z", 0.0) for r in regressions),
                       default=None),
    }
    if perf_model is not None:
        out["model_step_s"] = perf_model.get("step_s")
        out["bound"] = perf_model.get("bound")
        out["model_source"] = perf_model.get("source")
        if med and perf_model.get("step_s"):
            out["model_ratio_median"] = med / float(perf_model["step_s"])
    return out


def _audit_section(audits: list, failures: list = ()) -> dict:
    """The report's ``"audit"`` block: the compile-time static-analysis
    verdicts `run_resilient(audit=True)` streamed (one ``audit`` event per
    audited program — one per run, plus one per elastic restart, whose
    rebuilt program re-audits), reconstructed from the flight JSONL alone
    like every other section. ``findings`` carries the full structured
    records of the LAST audit (re-audits supersede earlier ones);
    ``rules`` merges finding counts by rule across all of them;
    ``failed`` counts audits that crashed (``audit_failed`` events — the
    audit degrades, the run continues) with their error strings;
    ``audit_s`` totals the audits' own host cost — successful AND failed
    attempts (each event stamps its trace+lower+parse+check seconds,
    kept out of chunk ``build_s``)."""
    rules: dict = {}
    for a in audits:
        for rule, n in (a.get("rules") or {}).items():
            rules[rule] = rules.get(rule, 0) + int(n)
    last = audits[-1] if audits else None
    out = {
        "programs": len(audits),
        "ok": (all(a.get("ok", False) for a in audits)
               if audits else None),
        "errors": sum(int(a.get("errors", 0)) for a in audits),
        "warnings": sum(int(a.get("warnings", 0)) for a in audits),
        "rules": dict(sorted(rules.items())),
        "crosscheck_ok": None if last is None else last.get("crosscheck_ok"),
        "findings": [] if last is None else list(last.get("findings") or ()),
        "audit_s": (sum(float(a["audit_s"])
                        for a in (*audits, *failures)
                        if a.get("audit_s") is not None)
                    if any(a.get("audit_s") is not None
                           for a in (*audits, *failures))
                    else None),
    }
    if failures:
        out["failed"] = len(failures)
        out["failed_errors"] = [f.get("error") for f in failures]
        out["ok"] = False
    return out


def _alerts_section(alerts: list) -> dict:
    """The report's ``"alerts"`` block from the journaled ``alert``
    transitions (`telemetry.live.AlertEngine` — scheduler-side
    in-process evaluation): transition counts per rule, and the set
    still FIRING at stream end (the last transition per (rule, job)
    wins — a resolve clears it)."""
    by_rule: dict = {}
    active: dict = {}
    for a in alerts:
        rule = a.get("rule", "?")
        rec = by_rule.setdefault(
            rule, {"firing": 0, "resolved": 0,
                   "severity": a.get("severity")})
        state = a.get("state")
        if state in rec:
            rec[state] += 1
        key = (rule, a.get("job"))
        if state == "firing":
            active[key] = {"rule": rule, "job": a.get("job"),
                           "severity": a.get("severity"),
                           "signal": a.get("signal"),
                           "value": a.get("value"), "t": a.get("t")}
        elif state == "resolved":
            active.pop(key, None)
    return {"transitions": len(alerts),
            "by_rule": dict(sorted(by_rule.items())),
            "active": list(active.values())}


def _pick(ev: dict, fields: tuple) -> dict:
    out = {"kind": ev["kind"], "t": ev.get("t")}
    for f in fields:
        if f in ev:
            out[f] = ev[f]
    return out


def run_report(source, *, run_id: str | None = None,
               trace_dir: str | None = None,
               include_metrics: bool = True) -> dict:
    """Build the unified report for one run.

    ``source`` is a flight-recorder JSONL path or an iterable of
    already-parsed event dicts, of ONE process (either package's stream);
    a directory or a multi-process stream raises `NotSupportedError` (the
    module docstring). ``run_id`` selects a run when the file holds several
    (default: the LAST run that appears). ``trace_dir`` merges a profiler
    capture's `overlap_stats` and `op_breakdown` (`utils.profiling`);
    ``include_metrics`` attaches a snapshot of the process metrics registry
    (meaningful in-process; read post-hoc, the registry is empty and the
    JSONL carries the truth)."""
    if isinstance(source, (str, os.PathLike)) \
            and os.path.isdir(os.fspath(source)):
        if os.path.exists(os.path.join(os.fspath(source), "scheduler.jsonl")):
            raise NotSupportedError(
                f"run_report: {os.fspath(source)} holds a multi-run scheduler "
                "journal; its service report needs the service module, not "
                "ported yet (ROADMAP Queue A item 5).")
        raise NotSupportedError(
            f"run_report: {os.fspath(source)} is a directory of per-process "
            "streams; merging them needs telemetry.aggregate, not ported yet "
            "(ROADMAP Queue A item 2). Pass one process's flight_p<i>.jsonl.")
    if isinstance(source, (str, os.PathLike)):
        events = read_flight_events(source)
    else:
        events = list(source)
    if not events:
        raise InvalidArgumentError("run_report: no events to report on.")

    runs = []
    for e in events:
        r = e.get("run")
        if r is not None and r not in runs:
            runs.append(r)
    rid = str(run_id) if run_id is not None else (runs[-1] if runs else None)
    if run_id is not None and rid not in runs:
        raise InvalidArgumentError(
            f"run_report: run id {rid!r} not present (have {runs}).")
    evs = [e for e in events if e.get("run") == rid]
    evs.sort(key=lambda e: (e.get("proc", 0), e.get("seq", 0)))

    procs = sorted({int(e.get("proc", 0)) for e in evs})
    if len(procs) > 1:
        raise NotSupportedError(
            f"run_report: run {rid!r} holds the events of processes {procs}; "
            "a multi-process report needs telemetry.aggregate, not ported yet "
            "(ROADMAP Queue A item 2). Report each process's stream alone.")

    # Cold-chunk attribution: a chunk following a runner-cache miss pays
    # its program's compile inside its first dispatch (the JAX package's
    # streams; the port's hold no runner_cache events).
    pending = None
    sequence = []
    chunks, cache = [], {"hits": 0, "misses": 0, "uncached": 0}
    saves, restores, rollbacks = [], [], []
    trips, escalations, elastic, resizes = [], [], [], []
    perf_model, perf_regressions = None, []
    audits, audit_failures = [], []
    alerts, slack_last, deadline_miss = [], None, None
    begin = end = None
    halo = {"exchanges": 0, "ppermutes": 0, "wire_bytes": 0}
    io = {"snapshots_submitted": 0, "snapshots_written": 0,
          "snapshots_staged": 0, "snapshots_dropped": 0,
          "snapshot_errors": 0, "snapshot_bytes": 0,
          "snapshot_write_s_total": 0.0, "reducer_points": 0}
    for e in evs:
        k = e.get("kind")
        if k == "runner_cache":
            res = e.get("result", "uncached")
            slot = {"hit": "hits", "miss": "misses"}.get(res, "uncached")
            cache[slot] = cache.get(slot, 0) + 1
            pending = res
            continue
        if k == "chunk":
            e = dict(e)
            e["cold"] = pending == "miss"
            pending = None
            chunks.append(e)
        elif k == "guard_trip":
            trips.append(e)
        elif k == "rollback":
            rollbacks.append(e)
        elif k == "checkpoint_save":
            saves.append(e)
        elif k == "checkpoint_restore":
            restores.append(e)
        elif k == "escalation":
            escalations.append(e)
        elif k == "elastic_restart":
            elastic.append(e)
        elif k == "resize":
            resizes.append(e)
        elif k == "halo_exchange":
            halo["exchanges"] += 1
            halo["ppermutes"] += e.get("ppermutes", 0)
            halo["wire_bytes"] += e.get("wire_bytes", 0)
        elif k == "snapshot":
            io["snapshots_submitted"] += 1
        elif k == "snapshot_write":
            io["snapshots_written"] += 1
            io["snapshot_bytes"] += e.get("nbytes", 0)
            io["snapshot_write_s_total"] += e.get("dur_s", 0.0) or 0.0
        elif k == "snapshot_stage":
            io["snapshots_staged"] += 1
        elif k == "snapshot_drop":
            io["snapshots_dropped"] += 1
        elif k == "snapshot_error":
            io["snapshot_errors"] += 1
        elif k == "reducers":
            io["reducer_points"] += 1
        elif k == "audit":
            audits.append(e)
        elif k == "audit_failed":
            audit_failures.append(e)
        elif k == "perf_model":
            perf_model = e
        elif k == "perf_regression":
            perf_regressions.append(e)
        elif k == "alert":
            alerts.append(e)
        elif k == "deadline_slack":
            slack_last = e
        elif k == "deadline_missed":
            deadline_miss = e
        elif k == "run_begin":
            begin = e
        elif k == "run_end":
            end = e
        if k in _SEQ_FIELDS:
            sequence.append(_pick(e, _SEQ_FIELDS[k]))

    reasons: dict = {}
    for t in trips:
        for r in t.get("reasons", ()):
            reasons[r] = reasons.get(r, 0) + 1
    ok = [c for c in chunks if c.get("ok")]
    exec_s = [c["exec_s"] for c in chunks if "exec_s" in c]
    ts = [e["t"] for e in evs if "t" in e]

    report = {
        "run_id": rid,
        "n_events": len(evs),
        "wall_s": (max(ts) - min(ts)) if ts else None,
        "steps": {
            "nt": begin.get("nt") if begin else None,
            "completed": (end.get("completed") if end else
                          (max((c["step_end"] for c in ok), default=None))),
        },
        "chunks": {
            "count": len(chunks),
            "ok": len(ok),
            "tripped": len(chunks) - len(ok),
            "cold": sum(1 for c in chunks if c.get("cold")),
            "exec_s_total": sum(exec_s) if exec_s else 0.0,
            "exec_s_max": max(exec_s) if exec_s else None,
        },
        "runner_cache": cache,
        "guards": {"trips": len(trips), "reasons": reasons},
        "checkpoints": {
            "saves": len(saves),
            "save_s_total": sum(s.get("dur_s", 0.0) for s in saves),
            "restores": len(restores),
            "restore_s_total": sum(r.get("dur_s", 0.0) for r in restores),
            "rollbacks": len(rollbacks),
        },
        "escalations": len(escalations),
        "elastic_restarts": [
            {"new_dims": e.get("new_dims"), "to_step": e.get("to_step")}
            for e in elastic],
        "resizes": [
            {"via": e.get("via"), "new_dims": e.get("new_dims"),
             "step": e.get("step"), "dur_s": e.get("dur_s"),
             "rounds": e.get("rounds"), "wire_bytes": e.get("wire_bytes")}
            for e in resizes],
        "halo": halo,
        "io": io,
        "audit": _audit_section(audits, audit_failures),
        "perf": _perf_section(chunks, perf_model, perf_regressions),
        "alerts": _alerts_section(alerts),
        "deadline": {
            "missed": deadline_miss is not None,
            "missed_step": None if deadline_miss is None
            else deadline_miss.get("step"),
            "slack_s_last": None if slack_last is None
            else slack_last.get("slack_s"),
            "priced_by": None if slack_last is None
            else slack_last.get("priced_by"),
        },
        "sequence": sequence,
    }
    if include_metrics:
        report["metrics"] = metrics_registry().collect()
    if trace_dir is not None:
        from ..utils.profiling import op_breakdown, overlap_stats

        report["overlap_stats"] = overlap_stats(trace_dir)
        report["op_breakdown"] = [
            {"op": k, "total_us": us, "count": c}
            for k, us, c in op_breakdown(trace_dir)]
    return report
