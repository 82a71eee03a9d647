"""`SnapshotQueryServer` — the read-side front door (serving tier leg b).

Counterpart of `implicitglobalgrid_tpu/serve/query.py`: the same routes,
headers, bodies and status codes over either package's snapshot roots.

A stateless HTTP service over one COMMITTED snapshot root: clients read
any sub-box of the implicit global grid in O(box) — the paper's
analysis-side contract — without a filesystem mount, a card, or any
contact with the mesh (the reader is host-only numpy). N replicas
pointed at one root scale reads horizontally; the writer's atomic
staged-rename commit plus the reader's typed refusal of staging dirs mean
a replica can poll a LIVE root and never serve a torn read.

Routes (all GET; rides on `telemetry.MetricsServer`, so ``/metrics`` +
``/healthz`` come free):

- ``/v1/snapshots`` — committed snapshots (step, path, fields, global
  shapes) + block-cache stats.
- ``/v1/snapshots/<step>/<field>?box=i0:i1,j0:j1,k0:k1`` — the sub-box,
  streamed as ``.npy`` bytes (``np.load(BytesIO(body))`` on the client)
  with the geometry echoed in ``X-IGG-*`` headers. No ``box`` = the
  whole field; a missing axis spec (``i0:i1,,``) = that whole axis.
- ``/v1/snapshots/<step>/<field>?point=i,j,k`` — one cell, as JSON.

Answers are assembled by the lazy reader (`io.Snapshot`,
bit-identical to ``gather_interior``) through a bounded LRU
`BlockCache` (`serve.cache`): hot blocks are checksum-verified and
decoded once ACROSS clients. Errors map to transport codes: bad
request shapes 400, unknown step/field 404, a half-committed or
corrupt container 503 (retry after the writer commits).

Status codes aside, the server never touches the mesh — deploy it on
any host that can read the snapshot root. The ``/v1`` routes can require a bearer
token: pass ``api_token=`` (defaults from ``IGG_API_TOKEN``) and every
request must carry ``Authorization: Bearer <token>`` (constant-time
compare; 401 otherwise) — ``/metrics`` + ``/healthz`` stay open.
"""

from __future__ import annotations

import io
import json
import os

import numpy as np

from ..io.reader import list_snapshots
from ..telemetry.server import MetricsServer, resolve_api_token
from ..utils.exceptions import IncoherentArgumentError, InvalidArgumentError
from .cache import BlockCache, CachedSnapshot

__all__ = ["SnapshotQueryServer"]


def _parse_box(text: str, gshape: tuple):
    """``i0:i1,j0:j1,...`` -> per-dim (lo, hi) tuple (None entries for
    empty axis specs = whole axis). Validation beyond shape arity is
    `io.layout.normalize_box`'s job."""
    parts = text.split(",")
    if len(parts) != len(gshape):
        raise InvalidArgumentError(
            f"box={text!r} has {len(parts)} axis range(s); the field is "
            f"{len(gshape)}-D (global shape {tuple(gshape)}).")
    box = []
    for part in parts:
        part = part.strip()
        if not part:
            box.append(None)
            continue
        lo, sep, hi = part.partition(":")
        if not sep:
            raise InvalidArgumentError(
                f"box axis spec {part!r} is not 'lo:hi' (half-open "
                "global range).")
        try:
            box.append((int(lo), int(hi)))
        except ValueError as e:
            raise InvalidArgumentError(
                f"box axis spec {part!r} is not integer 'lo:hi'.") from e
    return tuple(box)


class SnapshotQueryServer:
    """Serve O(box) reads of the committed snapshots under ``root``
    (see module docstring). ``port=0`` binds an ephemeral port — read
    ``.port``. ``cache_bytes`` bounds the shared block LRU (sizing: a
    few times the hot fields' per-block bytes; stats on
    ``/v1/snapshots``). ``api_token`` requires ``Authorization: Bearer
    <token>`` on the ``/v1`` routes (defaults from ``IGG_API_TOKEN``;
    ``False`` = explicitly unauthenticated). Context manager; `close()`
    stops the server."""

    def __init__(self, root, port: int = 0, *, host: str = "127.0.0.1",
                 cache_bytes: int = 256 << 20, registry=None,
                 api_token=None):
        self.root = os.fspath(root)
        if not os.path.isdir(self.root):
            raise InvalidArgumentError(
                f"Snapshot root not found: {self.root}")
        self.cache = BlockCache(cache_bytes)
        self._server = MetricsServer(
            port, host=host, registry=registry, routes=self._route,
            auth_token=resolve_api_token(api_token))
        self.host = self._server.host
        self.port = self._server.port

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        self._server.close()
        self.cache.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- routing -----------------------------------------------------------

    @staticmethod
    def _json(code: int, rec: dict):
        return code, json.dumps(rec, default=str).encode(), \
            "application/json"

    def _route(self, method: str, path: str, query: str, body: bytes):
        if method != "GET":
            return self._json(405, {"error": f"{method} not allowed "
                                             "(read-side service)"})
        if path in ("/v1/snapshots", "/v1/snapshots/"):
            return self._list()
        prefix = "/v1/snapshots/"
        if not path.startswith(prefix):
            return None
        rest = path[len(prefix):].split("/")
        if len(rest) != 2 or not rest[0] or not rest[1]:
            return self._json(
                404, {"error": "expected /v1/snapshots/<step>/<field>"})
        try:
            return self._read(rest[0], rest[1], query)
        except InvalidArgumentError as e:
            return self._json(400, {"error": str(e)})
        except IncoherentArgumentError as e:
            # half-committed / corrupt container: the writer's problem,
            # not the client's — retryable after the next commit
            return self._json(503, {"error": str(e)})

    def _list(self):
        snaps = []
        for step, path in list_snapshots(self.root):
            rec = {"step": step, "path": path}
            try:
                snap = CachedSnapshot(path, self.cache)
                rec["fields"] = snap.names
                rec["global_shapes"] = {
                    n: list(snap.global_shape(n)) for n in snap.names}
            except (InvalidArgumentError, IncoherentArgumentError) as e:
                # a torn/corrupt dir degrades ITS entry, not the listing
                rec["error"] = str(e)
            snaps.append(rec)
        return self._json(200, {"root": self.root, "snapshots": snaps,
                                "cache": self.cache.stats()})

    def _read(self, step_s: str, field: str, query: str):
        from urllib.parse import parse_qs

        try:
            step = int(step_s)
        except ValueError:
            return self._json(404, {"error": f"step {step_s!r} is not "
                                             "an integer"})
        path = dict(list_snapshots(self.root)).get(step)
        if path is None:
            return self._json(
                404, {"error": f"no committed snapshot for step {step} "
                               f"under {self.root}"})
        snap = CachedSnapshot(path, self.cache)
        if field not in snap.names:
            return self._json(
                404, {"error": f"snapshot step {step} has no field "
                               f"{field!r} (have {snap.names})"})
        q = parse_qs(query, keep_blank_values=True)
        if "point" in q and "box" in q:
            raise InvalidArgumentError(
                "pass either ?box= or ?point=, not both.")
        hits0 = self.cache.hits
        if "point" in q:
            try:
                index = tuple(int(x) for x in q["point"][0].split(","))
            except ValueError as e:
                raise InvalidArgumentError(
                    f"point={q['point'][0]!r} is not a comma-separated "
                    "integer index.") from e
            value = snap.read_point(field, index)
            return self._json(200, {"step": step, "field": field,
                                    "index": list(index),
                                    "value": float(value),
                                    "dtype": str(snap.dtype(field)),
                                    "cache_hit": self.cache.hits > hits0})
        box = None
        if "box" in q:
            box = _parse_box(q["box"][0], snap.global_shape(field))
        arr = snap.read_global(field, box)
        buf = io.BytesIO()
        np.save(buf, arr)
        payload = buf.getvalue()
        headers = {
            "X-IGG-Step": step,
            "X-IGG-Field": field,
            "X-IGG-Shape": ",".join(str(s) for s in arr.shape),
            "X-IGG-Dtype": str(arr.dtype),
            "X-IGG-Box": ";".join(
                "all" if b is None else f"{b[0]}:{b[1]}"
                for b in (box if box is not None
                          else (None,) * arr.ndim)),
            # block-level attribution for THIS request: a warm re-read
            # of the same box answers entirely from the LRU
            "X-IGG-Cache-Hits": self.cache.hits - hits0,
        }
        return 200, payload, "application/octet-stream", headers
