"""OTLP/HTTP JSON export of traced journal and flight streams.

Counterpart of `implicitglobalgrid_tpu/telemetry/otlp.py`, whole: the same
documents from the same streams (either package's), scope name included.
`export_otlp` renders every trace-stamped event in a flight directory (the
scheduler journal plus the per-job flight recorders) as OTLP/HTTP JSON
``ResourceSpans``, the wire shape any OpenTelemetry collector's
``/v1/traces`` endpoint accepts, so the causal tree the scheduler stamped
(`telemetry.tracectx`) becomes one navigable distributed trace:

- one RESOURCE per (run, process): ``service.name`` is ``igg-scheduler`` for
  the journal and ``igg-job`` for per-job flight streams, with
  ``igg.run``/``igg.proc``/``igg.pid`` attributes;
- one SPAN per traced event; journal events carry their minted span id,
  flight events (which the recorder stamps with only the trace id and the
  job-root parent, `recorder.FlightRecorder.trace`) get a DETERMINISTIC
  export-time id derived from ``(trace, run, proc, seq)``;
- guard trips, alert transitions and autoscale verdicts double as span
  EVENTS on their parent span;
- each applied flight ``resize`` span LINKS back to the ``resize_requested``
  journal span that asked for it.

`OtlpSpanExporter` is the live half: a batched sink that never raises, fed
event dicts (a journal or alert sink), encoded with the same renderer and
POSTed to a collector endpoint through urllib, synchronously at each full
batch (no thread).

Everything is stdlib-only; timestamps are each stream's monotonic stamps
re-anchored to wall clock through its ``recorder_open`` record.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
import urllib.request

from ..utils.exceptions import InvalidArgumentError
from .recorder import read_flight_events

__all__ = ["export_otlp", "OtlpSpanExporter"]

_SCOPE = {"name": "implicitglobalgrid_tpu"}

# Reserved stream keys that never become span attributes.
_SKIP_ATTRS = ("t", "t_mono", "t_offset", "kind", "run", "pid", "proc",
               "seq", "trace_id", "span_id", "parent_span_id", "wall",
               "version")

# Kinds that ALSO attach as OTLP span events on their parent span.
_EVENT_KINDS = ("guard_trip", "alert", "autoscale_decision",
                "deadline_missed", "rollback", "escalation",
                "fault_injected", "perf_regression")


def _synth_span_id(trace_id: str, e: dict) -> str:
    """Deterministic span id for an event that carries no minted one
    (flight-recorder hot path): stable across exports, unique per
    (trace, run, proc, seq)."""
    key = f"{trace_id}:{e.get('run')}:{e.get('proc')}:{e.get('seq')}"
    return hashlib.sha256(key.encode()).hexdigest()[:16]


def _attr_value(v) -> dict:
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}  # OTLP/JSON renders int64 as string
    if isinstance(v, float):
        return {"doubleValue": v}
    if isinstance(v, str):
        return {"stringValue": v}
    return {"stringValue": json.dumps(v, default=str, sort_keys=True)}


def _attrs(d: dict, skip=_SKIP_ATTRS) -> list:
    return [{"key": k, "value": _attr_value(v)}
            for k, v in d.items() if k not in skip and v is not None]


def _span_window(e: dict) -> tuple[float, float]:
    """(start, end) on the stream's monotonic clock: the stamp is the
    END; spans reach back by their recorded duration(s)."""
    end = float(e["t"])
    start = end
    if "exec_s" in e:  # chunk spans: build + exec precede the stamp
        start -= float(e.get("exec_s") or 0.0)
        start -= float(e.get("build_s") or 0.0)
    else:
        start -= float(e.get("dur_s") or 0.0)
    return start, end


def _resolve_streams(source):
    """source -> list of (label, events) per JSONL stream.  Accepts a
    directory (``*.jsonl`` globbed), one path, a list of paths, or an
    iterable of already-loaded event dicts (one stream)."""
    if isinstance(source, (str, os.PathLike)):
        src = os.fspath(source)
        if os.path.isdir(src):
            paths = sorted(
                os.path.join(src, f) for f in os.listdir(src)
                if f.endswith(".jsonl"))
            if not paths:
                raise InvalidArgumentError(
                    f"export_otlp: no *.jsonl streams under {src!r}.")
        else:
            paths = [src]
        return [(p, read_flight_events(p)) for p in paths]
    evs = list(source)
    if evs and isinstance(evs[0], (str, os.PathLike)):
        return [(os.fspath(p), read_flight_events(os.fspath(p)))
                for p in evs]
    return [("<events>", evs)]


def _stream_anchor(events: list) -> float:
    """Wall-clock anchor for a stream's monotonic stamps: its
    ``recorder_open`` record carries both clocks."""
    for e in events:
        if e.get("kind") == "recorder_open" and "wall" in e and "t" in e:
            return float(e["wall"]) - float(e["t"])
    return 0.0


def encode_spans(streams, *, trace_id=None, job=None,
                 default_anchor=None):
    """Render ``streams`` (list of (label, events)) as an OTLP/HTTP JSON
    document ``{"resourceSpans": [...]}``.  ``trace_id``/``job`` filter
    to one trace / one job's events.  Events without a ``trace_id``
    stamp are skipped — they belong to no trace."""
    by_resource: dict = {}   # (run, proc, pid) -> list of span dicts
    span_index: dict = {}    # span_id -> span dict
    meta: list = []          # (kind, job, end_ns, span) for links/events

    for _label, events in streams:
        anchor = _stream_anchor(events)
        if anchor == 0.0 and default_anchor is not None:
            anchor = default_anchor
        for e in events:
            tid = e.get("trace_id")
            if tid is None or "t" not in e or e.get("kind") is None:
                continue
            if trace_id is not None and tid != trace_id:
                continue
            run = str(e.get("run", ""))
            ejob = e.get("job") if e.get("job") is not None else \
                (run if run not in ("", "scheduler") else None)
            if job is not None and ejob != job:
                continue
            start, end = _span_window(e)
            start_ns = int((anchor + start) * 1e9)
            end_ns = int((anchor + end) * 1e9)
            sid = e.get("span_id") or _synth_span_id(tid, e)
            span = {
                "traceId": tid,
                "spanId": sid,
                "name": str(e["kind"]),
                "kind": 1,  # SPAN_KIND_INTERNAL
                "startTimeUnixNano": str(start_ns),
                "endTimeUnixNano": str(end_ns),
                "attributes": _attrs(e),
            }
            if e.get("parent_span_id"):
                span["parentSpanId"] = e["parent_span_id"]
            key = (run, int(e.get("proc", 0) or 0), int(e.get("pid", 0)
                                                        or 0))
            by_resource.setdefault(key, []).append(span)
            span_index[sid] = span
            meta.append((str(e["kind"]), ejob, end_ns, span))

    # span EVENTS: pin red-flag kinds onto their parent span too
    for kind, _ejob, end_ns, span in meta:
        if kind in _EVENT_KINDS and span.get("parentSpanId"):
            parent = span_index.get(span["parentSpanId"])
            if parent is not None:
                parent.setdefault("events", []).append({
                    "timeUnixNano": str(end_ns), "name": kind,
                    "attributes": span["attributes"]})

    # LINKS: each applied flight resize span -> the resize_requested
    # journal span that asked for it (paired per job, in time order)
    reqs: dict = {}
    applies: dict = {}
    for kind, ejob, end_ns, span in meta:
        if kind == "resize_requested":
            reqs.setdefault(ejob, []).append((end_ns, span))
        elif kind == "resize":
            applies.setdefault(ejob, []).append((end_ns, span))
    for ejob, apps in applies.items():
        req_spans = sorted(reqs.get(ejob, []))
        for i, (_t, span) in enumerate(sorted(apps)):
            if i < len(req_spans):
                req = req_spans[i][1]
                span.setdefault("links", []).append({
                    "traceId": req["traceId"],
                    "spanId": req["spanId"],
                    "attributes": [{"key": "igg.link",
                                    "value": {"stringValue":
                                              "resize_requested"}}]})

    resource_spans = []
    for (run, proc, pid), spans in sorted(by_resource.items()):
        service = "igg-scheduler" if run == "scheduler" else "igg-job"
        res_attrs = {"service.name": service, "igg.run": run,
                     "igg.proc": proc, "igg.pid": pid}
        resource_spans.append({
            "resource": {"attributes": _attrs(res_attrs, skip=())},
            "scopeSpans": [{"scope": dict(_SCOPE), "spans": spans}],
        })
    return {"resourceSpans": resource_spans}


def export_otlp(source, out=None, *, trace_id: str | None = None,
                job: str | None = None):
    """Render ``source`` (a flight directory, stream path(s), or event
    iterable) as OTLP/HTTP JSON ``ResourceSpans``.

    With ``out`` (a path), writes the JSON there and returns the path;
    otherwise returns the document dict.  POST it verbatim to any OTel
    collector's ``/v1/traces`` (``content-type: application/json``)."""
    doc = encode_spans(_resolve_streams(source), trace_id=trace_id,
                       job=job)
    if not doc["resourceSpans"]:
        raise InvalidArgumentError(
            "export_otlp: no trace-stamped events matched "
            f"(trace_id={trace_id!r}, job={job!r}).")
    if out is None:
        return doc
    out = os.fspath(out)
    with open(out, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    return out


class OtlpSpanExporter:
    """Batched live exporter: feed it traced event dicts (a journal
    sink), it POSTs OTLP/HTTP JSON to ``endpoint`` every ``batch``
    events.  NEVER raises into the caller's hot path — failures are
    counted (`sent`/`failed`, `last_error`) and the batch dropped.

    Live events carry in-process monotonic stamps with no
    ``recorder_open`` in sight; the exporter anchors them to wall clock
    at construction (same process, same clocks)."""

    def __init__(self, endpoint: str, *, batch: int = 64,
                 timeout_s: float = 5.0, headers: dict | None = None):
        if not isinstance(endpoint, str) or not endpoint:
            raise InvalidArgumentError(
                "OtlpSpanExporter: endpoint must be a non-empty URL.")
        if int(batch) < 1:
            raise InvalidArgumentError(
                f"OtlpSpanExporter: batch must be >= 1, got {batch}.")
        self.endpoint = endpoint
        self.batch = int(batch)
        self.timeout_s = float(timeout_s)
        self.headers = dict(headers or {})
        self.sent = 0
        self.failed = 0
        self.last_error: str | None = None
        self._buf: list = []
        self._anchor = time.time() - time.monotonic()

    def add(self, event: dict) -> None:
        """Buffer one event; flushes automatically at the batch size.
        Untraced events (no ``trace_id``) are ignored."""
        if not isinstance(event, dict) or event.get("trace_id") is None:
            return
        self._buf.append(dict(event))
        if len(self._buf) >= self.batch:
            self.flush()

    __call__ = add  # usable directly as a journal/alert sink

    def flush(self) -> None:
        if not self._buf:
            return
        batch, self._buf = self._buf, []
        doc = encode_spans([("<live>", batch)],
                           default_anchor=self._anchor)
        if not doc["resourceSpans"]:
            return
        body = json.dumps(doc).encode()
        try:
            self._post(body)
            self.sent += len(batch)
        except Exception as exc:  # noqa: BLE001 — sink must not raise
            self.failed += len(batch)
            self.last_error = f"{type(exc).__name__}: {exc}"

    def _post(self, body: bytes) -> None:
        """One OTLP/HTTP POST; override in tests to capture payloads."""
        req = urllib.request.Request(
            self.endpoint, data=body, method="POST",
            headers={"Content-Type": "application/json", **self.headers})
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            resp.read()

    def close(self) -> None:
        self.flush()
