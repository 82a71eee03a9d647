"""Chrome/Perfetto trace-event export of an aggregated flight stream.

Counterpart of `implicitglobalgrid_tpu/telemetry/trace_export.py`.
`export_chrome_trace` renders the mesh-wide event sequence
(`telemetry.aggregate.aggregate_flight`) as Trace Event Format JSON, which
``chrome://tracing`` and the Perfetto UI open directly:

- one TRACK per process (trace ``pid`` = the process's rank), the driver
  loop on thread 0 (``chunk`` spans with their ``build``/``exec`` phases,
  checkpoint spans) and the snapshot writer on thread 1
  (``snapshot_write`` spans);
- guard trips, rollbacks, escalations, elastic restarts, fault injections
  and perf regressions as INSTANT events;
- COUNTER tracks per process for ``igg_io_queue_depth``, the cumulative
  halo wire bytes (``halo_exchange`` events, `update_halo`'s accounting)
  and the per-step execution time (``igg_perf_step_seconds``).

Timestamps are the aggregated stream's corrected wall clock, rebased to
the earliest event, in microseconds, so the per-process chunk spans end
together at the chunk-boundary barrier. The document is the JAX
package's: the same streams give the same trace in either package.
"""

from __future__ import annotations

import json
import os

from ..utils.exceptions import InvalidArgumentError
from .aggregate import aggregate_events, aggregate_flight
from .recorder import read_flight_events

__all__ = ["export_chrome_trace"]

# Instant-event kinds (the operator's red flags), with the scope chrome
# renders them at: process-wide bars.
_INSTANTS = ("guard_trip", "rollback", "escalation", "elastic_restart",
             "fault_injected", "snapshot_drop", "snapshot_error",
             "perf_regression", "tuned_stale", "deadline_missed")

_TID_DRIVER = 0
_TID_IO = 1


def _normalize(source, run_id):
    """source -> (events, meta): an `aggregate_flight` result, a
    directory/path-list (aggregated here), a single JSONL file, or an
    already-merged event iterable. Pre-loaded events and single files
    that turn out to span SEVERAL processes are clock-aligned too
    (`aggregate_events`) — per-process monotonic stamps are not
    comparable raw, and a Perfetto timeline drawn on them would be
    silently uncorrelatable across tracks."""
    if isinstance(source, dict):
        if "events" not in source:
            raise InvalidArgumentError(
                "export_chrome_trace: dict source must be an "
                "aggregate_flight result (no 'events' key).")
        return source["events"], source
    if isinstance(source, (str, os.PathLike)):
        src = os.fspath(source)
        if os.path.isdir(src):
            agg = aggregate_flight(src, run_id=run_id)
            return agg["events"], agg
        evs = read_flight_events(src, run_id=run_id)
    else:
        evs = list(source)
        if evs and isinstance(evs[0], (str, os.PathLike)):
            agg = aggregate_flight(evs, run_id=run_id)
            return agg["events"], agg
    if len({int(e.get("proc", 0)) for e in evs}) > 1:
        agg = aggregate_events(evs, run_id=run_id)
        return agg["events"], agg
    return evs, None


def _args(e: dict, skip=("t", "t_mono", "t_offset", "kind", "run", "pid",
                         "proc", "seq")) -> dict:
    return {k: v for k, v in e.items() if k not in skip}


def _span_start(e: dict) -> float | None:
    """Earliest timeline point an event reaches back to (its stamp is its
    END; spans carry their duration before it). None for unstamped
    events."""
    if "t" not in e:
        return None
    t = float(e["t"])
    for f in ("dur_s", "exec_s"):
        t -= float(e.get(f, 0.0) or 0.0)
    t -= float(e.get("build_s", 0.0) or 0.0) if "exec_s" in e else 0.0
    return t


def _track_meta(trace: list, pid: int, name: str) -> None:
    """Track metadata: one Perfetto process row per pid, with the driver
    and io-writer threads named."""
    trace.append({"ph": "M", "pid": pid, "name": "process_name",
                  "args": {"name": name}})
    trace.append({"ph": "M", "pid": pid, "tid": _TID_DRIVER,
                  "name": "thread_name", "args": {"name": "driver"}})
    trace.append({"ph": "M", "pid": pid, "tid": _TID_IO,
                  "name": "thread_name", "args": {"name": "io-writer"}})


def export_chrome_trace(source, out=None, *, run_id: str | None = None,
                        trace_id: str | None = None):
    """Render ``source`` as Chrome trace-event JSON.

    ``source``: an `aggregate_flight` result, a directory of per-process
    ``*.jsonl`` streams (aggregated here), a list of stream paths, one
    JSONL path, or an iterable of (already merged) event dicts.

    ``trace_id`` filters to the events stamped with ONE distributed
    trace id (a ``trace_id`` field; the JAX package's trace contexts stamp
    it, the port's streams carry none yet).

    With ``out`` (a path), writes the JSON there and returns the path;
    otherwise returns the trace dict (``{"traceEvents": [...], ...}``).
    Open the file at https://ui.perfetto.dev or ``chrome://tracing``."""
    events, agg = _normalize(source, run_id)
    if trace_id is not None:
        events = [e for e in events if e.get("trace_id") == trace_id]
        if not events:
            raise InvalidArgumentError(
                f"export_chrome_trace: no events carry trace_id "
                f"{trace_id!r}.")
    if not events:
        raise InvalidArgumentError("export_chrome_trace: no events.")
    # rebase to the earliest point on the timeline — span STARTS included
    starts = [s for s in map(_span_start, events) if s is not None]
    t0 = min(starts)

    def us(t: float) -> float:
        return (float(t) - t0) * 1e6

    trace: list = []
    procs = sorted({int(e.get("proc", 0)) for e in events})
    for p in procs:
        _track_meta(trace, p, f"igg process {p}")

    wire_cum = {p: 0 for p in procs}
    for e in events:
        if "t" not in e or e.get("kind") is None:
            continue
        _emit_event(trace, e, int(e.get("proc", 0)), us, wire_cum)

    doc = {
        "traceEvents": trace,
        "displayTimeUnit": "ms",
        "otherData": {
            # the stream format's name (version 1, shared by both packages)
            "source": "implicitglobalgrid_tpu flight recorder",
            "processes": procs,
        },
    }
    if trace_id is not None:
        doc["otherData"]["trace_id"] = trace_id
    if agg is not None:
        doc["otherData"]["run_id"] = agg.get("run_id")
        doc["otherData"]["offsets"] = {
            str(k): v for k, v in (agg.get("offsets") or {}).items()}
        doc["otherData"]["align"] = agg.get("align")
    if out is None:
        return doc
    out = os.fspath(out)
    with open(out, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    return out


def _emit_event(trace: list, e: dict, p: int, us, wire_cum: dict) -> None:
    """Render ONE flight event onto track ``p`` (trace pid, the process's
    rank)."""
    kind = e.get("kind")
    t = float(e["t"])
    if kind is not None:
        if kind == "chunk":
            build = float(e.get("build_s", 0.0) or 0.0)
            ex = float(e.get("exec_s", 0.0) or 0.0)
            start = t - ex - build
            args = _args(e)
            trace.append({"ph": "X", "pid": p, "tid": _TID_DRIVER,
                          "cat": "chunk",
                          "name": f"chunk {e.get('chunk')}",
                          "ts": us(start), "dur": (build + ex) * 1e6,
                          "args": args})
            if build > 0:
                trace.append({"ph": "X", "pid": p, "tid": _TID_DRIVER,
                              "cat": "chunk", "name": "build",
                              "ts": us(start), "dur": build * 1e6})
            if ex > 0:
                trace.append({"ph": "X", "pid": p, "tid": _TID_DRIVER,
                              "cat": "chunk", "name": "exec",
                              "ts": us(t - ex), "dur": ex * 1e6})
            # perf-oracle counter track: per-step execution time per
            # boundary — the drift an operator eyeballs next to the
            # perf_regression instant markers
            if e.get("n"):
                trace.append({"ph": "C", "pid": p,
                              "name": "igg_perf_step_seconds",
                              "ts": us(t),
                              "args": {"s": ex / max(1, int(e["n"]))}})
        elif kind == "resize":
            # the resize span: how long the mesh was re-
            # blocking instead of stepping — the downtime an operator
            # weighs against the disk path's
            dur = float(e.get("dur_s", 0.0) or 0.0)
            trace.append({"ph": "X", "pid": p, "tid": _TID_DRIVER,
                          "cat": "resize",
                          "name": f"resize {e.get('new_dims')} "
                                  f"[{e.get('via')}]",
                          "ts": us(t - dur), "dur": dur * 1e6,
                          "args": _args(e)})
        elif kind in ("checkpoint_save", "checkpoint_restore"):
            dur = float(e.get("dur_s", 0.0) or 0.0)
            trace.append({"ph": "X", "pid": p, "tid": _TID_DRIVER,
                          "cat": "checkpoint",
                          "name": e.get("op", kind),
                          "ts": us(t - dur), "dur": dur * 1e6,
                          "args": _args(e)})
        elif kind == "snapshot_write":
            dur = float(e.get("dur_s", 0.0) or 0.0)
            trace.append({"ph": "X", "pid": p, "tid": _TID_IO,
                          "cat": "io",
                          "name": f"snapshot step {e.get('step')}",
                          "ts": us(t - dur), "dur": dur * 1e6,
                          "args": _args(e)})
            if e.get("queue_depth") is not None:
                trace.append({"ph": "C", "pid": p,
                              "name": "igg_io_queue_depth", "ts": us(t),
                              "args": {"depth": e["queue_depth"]}})
        elif kind == "alert":
            # an alert transition (live plane): a named red flag so the
            # rule and new state read straight off the timeline
            trace.append({"ph": "i", "pid": p, "tid": _TID_DRIVER,
                          "cat": "alert",
                          "name": f"alert {e.get('rule')} "
                                  f"{e.get('state')}",
                          "ts": us(t), "s": "p", "args": _args(e)})
        elif kind == "deadline_slack":
            # the slack trajectory as a counter track — the burn an
            # operator eyeballs next to the deadline_missed instant
            if e.get("slack_s") is not None:
                trace.append({"ph": "C", "pid": p,
                              "name": "igg_deadline_slack_seconds",
                              "ts": us(t),
                              "args": {"s": float(e["slack_s"])}})
        elif kind in _INSTANTS:
            trace.append({"ph": "i", "pid": p, "tid": _TID_DRIVER,
                          "cat": "event", "name": kind, "ts": us(t),
                          "s": "p", "args": _args(e)})
            if kind == "snapshot_drop" \
                    and e.get("queue_depth") is not None:
                trace.append({"ph": "C", "pid": p,
                              "name": "igg_io_queue_depth", "ts": us(t),
                              "args": {"depth": e["queue_depth"]}})
        elif kind == "halo_exchange":
            wire_cum[p] += int(e.get("wire_bytes", 0) or 0)
            trace.append({"ph": "C", "pid": p,
                          "name": "igg_halo_wire_bytes_total",
                          "ts": us(t), "args": {"bytes": wire_cum[p]}})
        elif kind in ("run_begin", "run_end", "snapshot", "reducers",
                      "snapshot_writer_close"):
            trace.append({"ph": "i", "pid": p, "tid": _TID_DRIVER,
                          "cat": "run", "name": kind, "ts": us(t),
                          "s": "t", "args": _args(e)})
