"""Live metrics endpoint: a stdlib-only HTTP thread serving the registry.

Counterpart of `implicitglobalgrid_tpu/telemetry/server.py`, whole. Opt-in
(`start_metrics_server(port)` or `run_resilient(metrics_port=...)`) and
tiny: `http.server.ThreadingHTTPServer` on a daemon thread, no work on the
step loop (the loop's only related cost is the driver's heartbeat gauges at
each chunk boundary, `telemetry.hooks.note_heartbeat`; serving happens on
the server's own threads when a scraper connects):

- ``GET /metrics``: `prometheus_snapshot()` of the process registry, in the
  text exposition format;
- ``GET /healthz``: JSON liveness, the age of the driver's last heartbeat
  (the ``igg_driver_heartbeat_timestamp_seconds`` gauge) and the last
  committed step; 503 when ``healthz_max_age_s`` is set and the heartbeat is
  older (a wedged driver stops heartbeating: the signal a supervisor
  restarts on).

SECURITY: binds ``127.0.0.1`` by default. /metrics and /healthz are
unauthenticated by design (they expose only metrics). Extended ``routes``
surfaces can require a bearer token (``auth_token=``; `resolve_api_token`
reads ``IGG_API_TOKEN``): every routed request must carry ``Authorization:
Bearer <token>``, compared in constant time, or is answered 401.
"""

from __future__ import annotations

import hmac
import inspect
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..utils.exceptions import InvalidArgumentError
from .export import prometheus_snapshot
from .hooks import (
    HEARTBEAT_STEP, HEARTBEAT_TS, JOB_HEARTBEAT_TS, SCHED_HEARTBEAT_TS,
    note_http_request,
)
from .registry import metrics_registry

__all__ = ["MetricsServer", "start_metrics_server", "stop_metrics_server",
           "metrics_server", "resolve_api_token"]


def _route_label(path: str) -> str:
    """Bounded-cardinality route label: the third path segment of a
    ``/v1/...`` route is where job/resource NAMES live (``/v1/jobs/x``,
    ``/v1/jobs/x/cancel``) — collapse it to ``{name}`` so the
    ``igg_http_requests_total`` label set stays one series per route
    pattern, not per tenant."""
    segs = path.strip("/").split("/")
    if len(segs) >= 3 and segs[0] == "v1":
        segs[2] = "{name}"
        return "/" + "/".join(segs)
    return path


def _routes_take_headers(fn) -> bool:
    """Back-compat probe: does the ``routes`` callable accept a 5th
    positional argument (the request headers)?  Older 4-arg routes keep
    working unchanged — the traceparent-aware serve tier opts in."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    n = 0
    for p in sig.parameters.values():
        if p.kind == p.VAR_POSITIONAL:
            return True
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD):
            n += 1
    return n >= 5


def resolve_api_token(api_token) -> str | None:
    """The serve-tier servers' one token-resolution rule: ``None``
    defers to the ``IGG_API_TOKEN`` environment variable (unset or
    empty = unauthenticated), ``False`` forces an unauthenticated
    server even with the variable set, and a string is the token
    itself."""
    import os

    if api_token is False:
        return None
    if api_token is None:
        return os.environ.get("IGG_API_TOKEN") or None
    if not isinstance(api_token, str) or not api_token:
        raise InvalidArgumentError(
            "api_token must be a non-empty string, None (defer to "
            "IGG_API_TOKEN), or False (explicitly unauthenticated); "
            f"got {api_token!r}.")
    return api_token


class MetricsServer:
    """The running endpoint. ``port=0`` picks a free port (read ``.port``
    after construction — the pattern tests and parallel launchers use).
    Use as a context manager or call `close()`; the server thread is a
    daemon either way, so a crashed run never hangs on it.

    ``routes`` extends the surface beyond /metrics + /healthz (the
    serving tier's job API and snapshot query service ride on exactly
    this server): a callable ``(method, path, query, body) ->
    (code, body_bytes, ctype[, headers_dict]) | None`` — ``query`` is
    the RAW query string, ``body`` the request bytes (b"" for GET);
    return None to 404. A routes callable declaring a FIFTH positional
    parameter additionally receives the request headers (a mapping with
    ``.get``) — how the job API reads ``traceparent``; 4-arg routes are
    untouched. Every request is accounted in
    ``igg_http_requests_total{route,method,code}`` and the
    ``igg_http_request_seconds`` histogram (route label collapsed to
    its pattern, token-gate 401s included) in THIS server's registry. Route exceptions answer a JSON 500 (the server
    thread must survive any handler bug). ``auth_token`` gates the
    routed surface: every routed request (GET and POST alike) must
    carry ``Authorization: Bearer <token>`` or is answered 401 —
    /metrics and /healthz stay open.

    A route may return an ITERATOR of bytes instead of a body — the
    response then streams as HTTP/1.1 chunked transfer, one chunk per
    yielded block, flushed immediately (the ``/v1/events`` live feed).
    Exceptions raised while CREATING the iterator still 500 (raise them
    inside ``routes``, or build the generator's first state eagerly);
    once streaming began the status line is gone, so a mid-stream error
    or a hung-up consumer just ends the stream — resumable consumers
    re-request from their cursor."""

    def __init__(self, port: int = 0, *, host: str = "127.0.0.1",
                 registry=None, healthz_max_age_s: float | None = None,
                 routes=None, auth_token: str | None = None):
        reg = registry if registry is not None else metrics_registry()
        max_age = None if healthz_max_age_s is None \
            else float(healthz_max_age_s)
        if routes is not None and not callable(routes):
            raise InvalidArgumentError(
                "MetricsServer routes must be callable "
                "(method, path, query, body) -> response tuple or None.")
        # bearer auth covers the ROUTED surface only: /metrics and
        # /healthz stay open (scrapers and supervisors don't carry
        # credentials); the comparison is constant-time so the token
        # can't be recovered byte-by-byte from response timing
        token = None if auth_token is None else str(auth_token)
        if token == "":
            raise InvalidArgumentError(
                "auth_token must be a non-empty string (or None to "
                "serve the routed surface unauthenticated).")
        takes_headers = routes is not None and _routes_take_headers(routes)
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            # chunked transfer (the streaming routes) needs HTTP/1.1;
            # every fixed response carries Content-Length, so keep-alive
            # stays correct for plain scrapes too
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # no stderr chatter per scrape
                pass

            def _send(self, code: int, body: bytes, ctype: str,
                      headers: dict | None = None) -> None:
                self._resp_code = int(code)
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, str(v))
                self.end_headers()
                self.wfile.write(body)

            def _stream(self, code: int, chunks, ctype: str,
                        headers: dict | None = None) -> None:
                self._resp_code = int(code)
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Transfer-Encoding", "chunked")
                for k, v in (headers or {}).items():
                    self.send_header(k, str(v))
                self.end_headers()
                try:
                    for chunk in chunks:
                        if not chunk:
                            continue
                        data = chunk if isinstance(chunk, bytes) \
                            else str(chunk).encode("utf-8")
                        self.wfile.write(b"%x\r\n" % len(data)
                                         + data + b"\r\n")
                        self.wfile.flush()
                    self.wfile.write(b"0\r\n\r\n")
                except (ConnectionError, OSError):
                    # the consumer hung up mid-stream — its seq cursor
                    # resumes it; nothing to answer on a dead socket
                    self.close_connection = True
                except Exception:
                    # a generator bug after the status line went out:
                    # end the stream (the consumer sees truncation and
                    # re-requests); the server thread survives
                    self.close_connection = True

            def _route(self, method: str, body: bytes) -> None:
                path, _, query = self.path.partition("?")
                if routes is None:
                    self._send(404, b"not found\n", "text/plain")
                    return
                if token is not None:
                    auth = self.headers.get("Authorization") or ""
                    supplied = auth[7:].strip() \
                        if auth.startswith("Bearer ") else ""
                    if not hmac.compare_digest(supplied.encode("utf-8"),
                                               token.encode("utf-8")):
                        self._send(
                            401, json.dumps(
                                {"error": "missing or invalid bearer "
                                          "token"}).encode(),
                            "application/json",
                            {"WWW-Authenticate": "Bearer"})
                        return
                try:
                    resp = routes(method, path, query, body,
                                  self.headers) if takes_headers \
                        else routes(method, path, query, body)
                except Exception as e:
                    # a handler bug answers 500; the thread survives
                    self._send(500, json.dumps(
                        {"error": f"{type(e).__name__}: {e}"}).encode(),
                        "application/json")
                    return
                if resp is None:
                    self._send(404, json.dumps(
                        {"error": f"no route for {method} {path}"}
                        ).encode(), "application/json")
                    return
                code, payload, ctype = resp[0], resp[1], resp[2]
                headers = resp[3] if len(resp) > 3 else None
                if isinstance(payload, (bytes, bytearray)):
                    self._send(int(code), bytes(payload), ctype, headers)
                else:
                    self._stream(int(code), payload, ctype, headers)

            def do_GET(self):
                t0 = time.monotonic()
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    body = prometheus_snapshot(reg).encode()
                    self._send(200, body,
                               "text/plain; version=0.0.4; charset=utf-8")
                elif path == "/healthz":
                    code, rec = outer._healthz()
                    self._send(code, json.dumps(rec).encode(),
                               "application/json")
                else:
                    self._route("GET", b"")
                self._account("GET", path, t0)

            def do_POST(self):
                t0 = time.monotonic()
                try:
                    n = int(self.headers.get("Content-Length") or 0)
                except ValueError:
                    n = 0
                body = self.rfile.read(n) if n > 0 else b""
                self._route("POST", body)
                self._account("POST", self.path.partition("?")[0], t0)

            def _account(self, method: str, path: str, t0: float) -> None:
                # access telemetry for EVERY answered request (401s from
                # the token gate included); a streamed response accounts
                # its full stream lifetime. Never fails the request.
                try:
                    note_http_request(
                        _route_label(path), method,
                        getattr(self, "_resp_code", 0),
                        time.monotonic() - t0, scope=reg)
                except Exception:
                    pass

        self.registry = reg
        self.healthz_max_age_s = max_age
        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = int(self._httpd.server_address[1])
        # a short poll interval: `close` (`shutdown`) waits for the loop to
        # see it, up to one interval (the stdlib's 0.5 s default would add
        # up to half a second to the end of every run that serves)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.02},
            name=f"igg-metrics-server:{self.port}", daemon=True)
        self._thread.start()
        # ephemeral-port contract: port=0 binds a free port; the ACTUAL
        # port is readable from .port and from this gauge, so tests and
        # multi-tenant runs never hard-code (and collide on) a number
        from .hooks import note_metrics_server_port

        note_metrics_server_port(self.port)

    def _gauge_value(self, name):
        fam = self.registry.get(name)
        if fam is not None:
            samples = fam.samples()
            if samples:
                return samples[0][1]
        return None

    def _healthz(self):
        """(status_code, record): heartbeat age. When a scheduler owns the
        mesh its heartbeat (`igg_scheduler_heartbeat_timestamp_seconds`)
        is THE liveness — a single wedged job must not 503 the whole
        service — and per-job staleness moves to the labeled
        `igg_job_heartbeat_timestamp_seconds` gauges, echoed here as
        ``job_ages_s``. Plain supervised runs keep the driver gauge."""
        now = time.time()
        source = "driver"
        ts = self._gauge_value(SCHED_HEARTBEAT_TS)
        if ts is not None:
            source = "scheduler"
        else:
            ts = self._gauge_value(HEARTBEAT_TS)
        age = None if ts is None else now - ts
        step = self._gauge_value(HEARTBEAT_STEP)
        rec = {"ok": True, "heartbeat_age_s": age, "step": step,
               "max_age_s": self.healthz_max_age_s, "source": source}
        fam = self.registry.get(JOB_HEARTBEAT_TS)
        if fam is not None:
            jobs = {lbl.get("job", "?"): now - v
                    for lbl, v in fam.samples()}
            if jobs:
                rec["job_ages_s"] = dict(sorted(jobs.items()))
        if self.healthz_max_age_s is not None:
            rec["ok"] = age is not None and age <= self.healthz_max_age_s
        return (200 if rec["ok"] else 503), rec

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
        from .hooks import note_metrics_server_port

        note_metrics_server_port(0)  # gauge reads 0 while no endpoint lives

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


_current: MetricsServer | None = None
_refs = 0
_lock = threading.Lock()


def start_metrics_server(port: int = 0, *, host: str = "127.0.0.1",
                         registry=None,
                         healthz_max_age_s: float | None = None
                         ) -> MetricsServer:
    """Start THE process metrics server, or ATTACH to the one already
    running (one endpoint per process; starts are refcounted — each
    `start_metrics_server` is balanced by one `stop_metrics_server`, and
    the socket closes only when the last holder stops). Attachment is what
    lets a scheduler-owned long-lived endpoint persist across jobs while a
    concurrent `run_resilient(metrics_port=...)` inside it still
    'starts' its server: the second start joins the first instead of
    failing to bind. An attach must be compatible: ``port`` 0 or the
    running server's own, same ``host``, same ``registry`` — a genuinely
    conflicting request still raises. The FIRST start's
    ``healthz_max_age_s`` wins (attachers observe, the owner configures).

    ``port=0`` binds an ephemeral port; the ACTUAL port is the returned
    server's ``.port`` and the ``igg_metrics_server_port`` gauge (0 again
    after the last stop). Binds ``127.0.0.1`` unless ``host`` says
    otherwise (see the module docstring's security note)."""
    global _current, _refs
    with _lock:
        if _current is not None:
            if int(port) not in (0, _current.port):
                raise InvalidArgumentError(
                    f"A metrics server is already running on "
                    f"{_current.host}:{_current.port}; a second start can "
                    f"attach (port=0 or {_current.port}) but not rebind "
                    f"to port {int(port)}.")
            if host != _current.host:
                raise InvalidArgumentError(
                    f"A metrics server is already running on host "
                    f"{_current.host}; cannot attach with host {host!r}.")
            if registry is not None and registry is not _current.registry:
                raise InvalidArgumentError(
                    "A metrics server is already running over a different "
                    "registry; stop it before serving another.")
            _refs += 1
            return _current
        _current = MetricsServer(port, host=host, registry=registry,
                                 healthz_max_age_s=healthz_max_age_s)
        _refs = 1
        return _current


def stop_metrics_server() -> None:
    """Release one hold on the process metrics server; the socket closes
    when the LAST holder releases (no-op when none is running)."""
    global _current, _refs
    with _lock:
        if _current is None:
            return
        _refs -= 1
        if _refs <= 0:
            _current.close()
            _current = None
            _refs = 0


def metrics_server() -> MetricsServer | None:
    """The running process metrics server, or None."""
    return _current
