"""`JobApiServer` — the networked job front door (serving tier leg a).

Counterpart of `implicitglobalgrid_tpu/serve/api.py`: the same routes,
bodies and status codes, and the same queue records and control files, so
either package's `MeshScheduler` claims what either package's server
enqueued.

A versioned JSON HTTP surface over one scheduler flight directory. It
owns NO scheduler state: submissions become queue-backend records
(`service.DirectoryBackend` — the atomic-rename claim protocol a live
`MeshScheduler` polls), control verbs become the exact control files
``tools jobs cancel|resize|drain`` writes, and status is reconstructed
from the journal — the same source `service_report` reads. The API
writes exactly what the CLI writes, so a live scheduler needs zero new
hooks and the two can never diverge.

Routes (rides on `telemetry.MetricsServer`; ``/metrics`` + ``/healthz``
come free):

- ``POST /v1/jobs`` — submit: the ``tools jobs submit`` queue-JSON
  (``{"jobs": [{name, model, nt, grid?, dtype?, priority?, deadline_s?,
  perturb?, run?}]}`` — ``run`` takes every `RunSpec` knob incl.
  ``tuned``), or one bare job record. Every record is validated
  through `service.jobspec_from_json` BEFORE any is enqueued (400 on
  the first bad one; 409 on a name the service already knows), then
  all are enqueued: 202.
- ``GET /v1/jobs`` / ``GET /v1/jobs/<name>`` — journal-derived state
  and progress, merged with not-yet-claimed queue records (state
  ``"pending"``).
- ``POST /v1/jobs/<name>/cancel`` — a still-pending record is atomically
  discarded before any scheduler claims it; otherwise the control file
  (404 unknown name, 409 already terminal).
- ``POST /v1/jobs/<name>/resize`` — body ``{"new_dims": [dx,dy,dz],
  "via"?: "auto"|"device"|"checkpoint"}`` -> the resize control file.
- ``POST /v1/drain`` — the global drain request.
- ``GET /v1/observe`` / ``GET /v1/events?since=<seq>`` — the live
  observability plane (`serve.observe.ObservePlane`, mounted over the
  same flight directory unless ``observe=False``): the derived-signal
  snapshot and the resumable chunked-NDJSON event stream.

TRACING: every submit / cancel / resize accepts a W3C ``traceparent``
request header (or mints a fresh trace), echoes it on the response, and
stamps it into the queue record / control payload — the claiming
scheduler threads it through every journal event and flight span of the
job (`telemetry.tracectx`; export with ``tools trace --otlp``).

SECURITY: inherits `MetricsServer`'s loopback-by-default bind, and the
whole ``/v1`` surface — mutating AND read routes — can require a bearer
token: pass ``api_token=`` (defaults from the ``IGG_API_TOKEN``
environment variable) and every request must carry ``Authorization:
Bearer <token>`` (constant-time compare; 401 otherwise). ``/metrics``
and ``/healthz`` stay open for scrapers and supervisors.
"""

from __future__ import annotations

import json
import os

from ..service.backend import DirectoryBackend, QueueBackend
from ..service.job import jobspec_from_json
from ..service.report import is_service_dir, service_report
from ..telemetry.server import MetricsServer, resolve_api_token
from ..telemetry.tracectx import TraceContext
from ..utils.exceptions import InvalidArgumentError

__all__ = ["JobApiServer"]

_TERMINAL_STATES = ("done", "failed", "cancelled", "rejected")


class JobApiServer:
    """Serve the job API over one scheduler ``flight_dir`` (see module
    docstring). ``backend`` defaults to the `DirectoryBackend` over
    that directory — pass the shared backend instance when schedulers
    use a custom one. ``port=0`` binds an ephemeral port — read
    ``.port``. ``api_token`` requires ``Authorization: Bearer <token>``
    on every ``/v1`` route (module docstring; defaults from
    ``IGG_API_TOKEN``; pass ``api_token=False`` to force an
    unauthenticated server even with the variable set). Context
    manager; `close()` stops the server (the queue and any live
    scheduler are untouched — the API is stateless)."""

    def __init__(self, flight_dir, port: int = 0, *,
                 host: str = "127.0.0.1", backend: QueueBackend | None = None,
                 registry=None, observe: bool = True,
                 observe_window: int = 16, api_token=None):
        self.flight_dir = os.fspath(flight_dir)
        os.makedirs(self.flight_dir, exist_ok=True)
        if backend is not None and not isinstance(backend, QueueBackend):
            raise InvalidArgumentError(
                f"backend must be a service.QueueBackend; got "
                f"{type(backend).__name__}.")
        self.backend = (backend if backend is not None
                        else DirectoryBackend(self.flight_dir))
        # the live plane rides the same server: /v1/observe (derived
        # signals + alerts) and /v1/events (streaming feed) over the
        # same flight directory the job routes reconstruct state from
        self.observe = None
        if observe:
            from .observe import ObservePlane

            self.observe = ObservePlane(self.flight_dir,
                                        backend=self.backend,
                                        window=observe_window)
        self._server = MetricsServer(port, host=host, registry=registry,
                                     routes=self._route,
                                     auth_token=resolve_api_token(api_token))
        self.host = self._server.host
        self.port = self._server.port

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        self._server.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- journal view ------------------------------------------------------

    def _journal_jobs(self) -> dict:
        if not is_service_dir(self.flight_dir):
            return {}
        return service_report(self.flight_dir, include_jobs=False)["jobs"]

    def _jobs_view(self) -> dict:
        jobs = self._journal_jobs()
        for name in self.backend.pending():
            if name not in jobs:
                # enqueued, no scheduler has claimed it yet
                jobs[name] = {"name": name, "state": "pending"}
        return jobs

    # -- routing -----------------------------------------------------------

    @staticmethod
    def _json(code: int, rec: dict, headers: dict | None = None):
        resp = (code, json.dumps(rec, default=str).encode(),
                "application/json")
        return resp + (headers,) if headers else resp

    @staticmethod
    def _trace_ctx(headers) -> TraceContext:
        """The request's trace context: a CHILD of the caller's
        ``traceparent`` span, or a fresh root when the header is absent.
        A malformed header RESTARTS the trace (the W3C-recommended
        degradation) rather than failing the request."""
        tp = headers.get("traceparent") if headers is not None else None
        if tp:
            try:
                return TraceContext.parse(str(tp)).child()
            except InvalidArgumentError:
                pass
        return TraceContext.new()

    def _route(self, method: str, path: str, query: str, body: bytes,
               headers=None):
        if self.observe is not None:
            resp = self.observe.routes(method, path, query, body)
            if resp is not None:
                return resp
        if path == "/v1/drain" and method == "POST":
            self.backend.control("drain")
            return self._json(202, {"requested": "drain"})
        if path in ("/v1/jobs", "/v1/jobs/"):
            if method == "POST":
                return self._submit(body, self._trace_ctx(headers))
            return self._json(200, {"jobs": self._jobs_view()})
        prefix = "/v1/jobs/"
        if not path.startswith(prefix):
            return None
        rest = path[len(prefix):].split("/")
        if method == "GET" and len(rest) == 1 and rest[0]:
            job = self._jobs_view().get(rest[0])
            if job is None:
                return self._json(
                    404, {"error": f"no job named {rest[0]!r}",
                          "have": sorted(self._jobs_view())})
            return self._json(200, job)
        if method == "POST" and len(rest) == 2 and rest[0] \
                and rest[1] in ("cancel", "resize"):
            try:
                return self._control(rest[0], rest[1], body,
                                     self._trace_ctx(headers))
            except InvalidArgumentError as e:
                return self._json(400, {"error": str(e)})
        return None

    def _submit(self, body: bytes, ctx: TraceContext):
        try:
            doc = json.loads(body.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            return self._json(400, {"error": f"request body is not "
                                             f"JSON: {e}"})
        if isinstance(doc, dict) and "jobs" in doc:
            records = doc["jobs"]
        elif isinstance(doc, dict):
            records = [doc]  # one bare job record
        else:
            records = None
        if not isinstance(records, list) or not records:
            return self._json(
                400, {"error": "expected {'jobs': [...]} (the tools "
                               "jobs submit queue-JSON) or one job "
                               "record object."})
        # validate EVERYTHING before enqueueing ANYTHING — a bad record
        # in a batch must not half-submit it
        known = set(self._jobs_view())
        names = []
        for i, rec in enumerate(records):
            try:
                spec = jobspec_from_json(rec,
                                         where=f"POST /v1/jobs job #{i}")
            except InvalidArgumentError as e:
                return self._json(400, {"error": str(e)})
            if spec.name in known or spec.name in names:
                return self._json(
                    409, {"error": f"a job named {spec.name!r} already "
                                   "exists on this service (names key "
                                   "journals and queue records)."})
            names.append(spec.name)
        # the submit span's traceparent rides INSIDE each queue record:
        # `DirectoryBackend` round-trips it verbatim and the claiming
        # scheduler derives the job's root span from it — the causal
        # thread from this HTTP request to every collective under it
        tp = ctx.to_traceparent()
        for rec in records:
            rec = dict(rec)
            rec["traceparent"] = tp
            self.backend.submit(rec)
        return self._json(202, {"submitted": names, "traceparent": tp},
                          {"traceparent": tp})

    def _control(self, name: str, verb: str, body: bytes,
                 ctx: TraceContext):
        tp = ctx.to_traceparent()
        if verb == "cancel" and self.backend.discard(name):
            # atomically beat every scheduler to the pending record —
            # the job never existed as far as any journal is concerned
            return self._json(202, {"requested": "cancel", "job": name,
                                    "discarded": True},
                              {"traceparent": tp})
        job = self._jobs_view().get(name)
        if job is None:
            return self._json(404, {"error": f"no job named {name!r}",
                                    "have": sorted(self._jobs_view())})
        if job["state"] in _TERMINAL_STATES:
            return self._json(409, {"error": f"job {name!r} already "
                                             f"{job['state']}"})
        if verb == "cancel":
            self.backend.control("cancel", name, {"traceparent": tp})
            return self._json(202, {"requested": "cancel", "job": name},
                              {"traceparent": tp})
        # resize
        try:
            req = json.loads(body.decode("utf-8")) if body else {}
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            return self._json(400, {"error": f"resize body is not "
                                             f"JSON: {e}"})
        if not isinstance(req, dict):
            return self._json(400, {"error": "resize body must be "
                                             "{'new_dims': [dx,dy,dz], "
                                             "'via'?: ...}"})
        dims = req.get("new_dims")
        try:
            dims = [int(x) for x in (dims or ())]
        except (TypeError, ValueError):
            dims = []
        via = req.get("via", "auto")
        if len(dims) != 3 or any(d < 1 for d in dims):
            return self._json(400, {"error": "new_dims must be 3 "
                                             f"positive ints; got "
                                             f"{req.get('new_dims')!r}"})
        if via not in ("auto", "device", "checkpoint"):
            return self._json(400, {"error": f"via must be auto|device|"
                                             f"checkpoint; got {via!r}"})
        self.backend.control("resize", name,
                             {"new_dims": dims, "via": via,
                              "traceparent": tp})
        return self._json(202, {"requested": "resize", "job": name,
                                "new_dims": dims, "via": via},
                          {"traceparent": tp})
