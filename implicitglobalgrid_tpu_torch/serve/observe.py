"""Streaming ops endpoints — the live observability plane's network
surface.

Counterpart of `implicitglobalgrid_tpu/serve/observe.py`: the same routes
and records over the port's `LiveAggregate`, which reads either package's
flight directories.

`ObservePlane` wraps one `telemetry.LiveAggregate` (the incremental
flight tailer + derived-signal windows) behind two `MetricsServer`
routes, mounted by `JobApiServer` (``observe=True``, the default) or
served standalone by `ObserveServer`:

- ``GET /v1/observe`` — one JSON snapshot of the live-derived signals:
  per-job rolling step-time quantiles + robust z, deadline slack, guard
  trips, snapshot/wire rates; persistent-straggler attribution;
  queue pressure; active + recent alerts (tailed from the scheduler
  journal, merged with this plane's own observer-side engine when one
  is configured). The record carries the current ``cursor`` — the
  ``live_seq`` high-water mark to resume the event stream from.
- ``GET /v1/events?since=<seq>`` — the merged, clock-aligned live event
  feed as chunked NDJSON: every line one flight event (``live_seq``
  stamped), heartbeat lines (``{"kind": "heartbeat", "cursor": n,
  "server_ts": unix_s, "last_seq": m}`` — ``last_seq`` ahead of the
  client's cursor means a stalled tail, not a quiet mesh)
  while idle so consumers distinguish quiet from dead, bounded by
  ``timeout_s`` per request. RESUMABLE: each response ends with a final
  heartbeat carrying the cursor; pass it back as ``since=`` and only
  newer events stream. Query knobs: ``since`` (exclusive ``live_seq``
  cursor; omit for the whole buffer), ``timeout_s`` (stream duration,
  default 10, capped), ``heartbeat_s`` (idle keep-alive cadence,
  default 2), ``max_events`` (end early after N events — the polling
  CLI uses 0 = unlimited).

The plane POLLS ITS TAILER ON DEMAND — each request drains whatever the
jobs appended since the last one; an idle plane costs nothing. An
optional OBSERVER-SIDE `AlertEngine` (``rules=``/``sinks=``) evaluates
over the tailed snapshot after every poll that merged new events —
off-process alerting with the same rule grammar as the scheduler's
in-process engine, including `ControlFileSink` (an observer can file a
cancel the scheduler consumes at its next slice boundary). Its
transitions are NOT journaled (the scheduler's journal has exactly one
writer); they surface in ``/v1/observe`` tagged ``source:
"observer"``.

SECURITY: inherits `MetricsServer`'s loopback-by-default bind, and the
``/v1`` surface can require a bearer token: pass ``api_token=``
(defaults from ``IGG_API_TOKEN``) and every request must carry
``Authorization: Bearer <token>`` (constant-time compare; 401
otherwise) — ``/metrics`` + ``/healthz`` stay open.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.parse
from collections import deque

from ..service.backend import QueueBackend
from ..telemetry.live import AlertEngine, LiveAggregate
from ..telemetry.server import MetricsServer, resolve_api_token
from ..utils.exceptions import InvalidArgumentError

__all__ = ["ObservePlane", "ObserveServer"]

_MAX_STREAM_S = 600.0   # one /v1/events request never outlives this
_POLL_SLEEP_S = 0.05    # tail cadence while a stream is idle


class ObservePlane:
    """The routes + the tailer (see module docstring). ``source`` is a
    flight directory (or one JSONL, or a list); ``backend`` adds queue
    pressure to snapshots; ``rules``/``sinks`` configure the optional
    observer-side engine (``rules=True`` = the default pack). Thread
    safe: the `MetricsServer` handles requests concurrently, the plane
    serializes tailer access."""

    def __init__(self, source, *, backend: QueueBackend | None = None,
                 rules=None, sinks=(), window: int = 16):
        if backend is not None and not isinstance(backend, QueueBackend):
            raise InvalidArgumentError(
                f"backend must be a service.QueueBackend; got "
                f"{type(backend).__name__}.")
        self.live = LiveAggregate(source, window=window, backend=backend)
        self.engine = None
        if rules or sinks:
            self.engine = AlertEngine(
                None if rules in (True, "default") else list(rules or ()),
                sinks=sinks, journal=None)
        self._transitions: deque = deque(maxlen=64)
        self._lock = threading.Lock()

    # -- polling -----------------------------------------------------------

    def poll(self) -> list:
        """Drain the tail once (thread safe); evaluates the observer
        engine when new events merged. Returns the new events."""
        with self._lock:
            return self._poll_locked()

    def _poll_locked(self) -> list:
        evs = self.live.poll()
        if evs and self.engine is not None:
            for tr in self.engine.evaluate(self.live.snapshot()):
                self._transitions.append(dict(tr, source="observer"))
        return evs

    def snapshot(self) -> dict:
        """Poll, then return the derived-signal record (the
        ``/v1/observe`` body)."""
        with self._lock:
            self._poll_locked()
            snap = self.live.snapshot()
            if self.engine is not None:
                snap["alerts"]["active"] = list(
                    snap["alerts"]["active"]) + [
                    dict(a, source="observer")
                    for a in self.engine.active()]
                snap["alerts"]["recent"] = list(
                    snap["alerts"]["recent"]) + list(self._transitions)
            return snap

    # -- routing -----------------------------------------------------------

    def routes(self, method: str, path: str, query: str, body: bytes):
        """The `MetricsServer` ``routes=`` callable (chainable: returns
        None for paths it does not own)."""
        if method != "GET":
            return None
        if path == "/v1/observe":
            return 200, json.dumps(self.snapshot(),
                                   default=str).encode(), \
                "application/json"
        if path == "/v1/events":
            try:
                params = self._stream_params(query)
            except (ValueError, TypeError) as e:
                return 400, json.dumps(
                    {"error": f"bad /v1/events query: {e}"}).encode(), \
                    "application/json"
            return 200, self._event_stream(**params), \
                "application/x-ndjson"
        return None

    @staticmethod
    def _stream_params(query: str) -> dict:
        q = urllib.parse.parse_qs(query or "")

        def one(key, cast, default):
            return cast(q[key][0]) if key in q else default

        timeout_s = min(max(0.0, one("timeout_s", float, 10.0)),
                        _MAX_STREAM_S)
        return {"since": one("since", int, None),
                "timeout_s": timeout_s,
                "heartbeat_s": max(0.1, one("heartbeat_s", float, 2.0)),
                "max_events": max(0, one("max_events", int, 0))}

    def _event_stream(self, *, since, timeout_s, heartbeat_s,
                      max_events):
        """The chunked-NDJSON generator behind ``GET /v1/events``."""
        deadline = time.monotonic() + timeout_s
        cursor = since
        last_emit = time.monotonic()
        sent = 0
        while True:
            with self._lock:
                self._poll_locked()
                evs, cursor = self.live.events_since(cursor)
            for e in evs:
                yield json.dumps(e, default=str).encode() + b"\n"
                sent += 1
                last_emit = time.monotonic()
                if max_events and sent >= max_events:
                    # resume from the last event actually SENT, not the
                    # batch high-water mark — the cut-off tail must
                    # stream again on the next request
                    yield self._hb(e.get("live_seq", cursor), done=True)
                    return
            now = time.monotonic()
            if now >= deadline:
                # the final heartbeat carries the resume cursor
                yield self._hb(cursor, done=True)
                return
            if not evs and now - last_emit >= heartbeat_s:
                yield self._hb(cursor)
                last_emit = now
            time.sleep(min(_POLL_SLEEP_S, max(0.0, deadline - now)))

    def _hb(self, cursor, done: bool = False) -> bytes:
        # server_ts + last_seq let a stream client tell "quiet mesh"
        # (last_seq == its cursor, server_ts advancing) from "stalled
        # tail" (last_seq ahead of what it received) — tools watch
        # surfaces the same lag
        rec = {"kind": "heartbeat", "cursor": cursor,
               "server_ts": time.time(), "last_seq": self.live.cursor}
        if done:
            rec["done"] = True
        return json.dumps(rec).encode() + b"\n"


class ObserveServer:
    """Standalone streaming ops endpoint over one flight directory —
    `ObservePlane` on its own `MetricsServer` (``/metrics`` +
    ``/healthz`` come free), for deployments that want the live plane
    without the job API. ``port=0`` binds an ephemeral port — read
    ``.port``. ``api_token`` requires ``Authorization: Bearer <token>``
    on the ``/v1`` routes (module docstring; defaults from
    ``IGG_API_TOKEN``; ``False`` = explicitly unauthenticated). Context
    manager; `close()` stops the server only (the flight files and any
    live scheduler are untouched)."""

    def __init__(self, flight_dir, port: int = 0, *,
                 host: str = "127.0.0.1",
                 backend: QueueBackend | None = None, rules=None,
                 sinks=(), window: int = 16, registry=None,
                 api_token=None):
        self.flight_dir = os.fspath(flight_dir)
        self.plane = ObservePlane(self.flight_dir, backend=backend,
                                  rules=rules, sinks=sinks,
                                  window=window)
        self._server = MetricsServer(
            port, host=host, registry=registry,
            routes=self.plane.routes,
            auth_token=resolve_api_token(api_token))
        self.host = self._server.host
        self.port = self._server.port

    def close(self) -> None:
        self._server.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
