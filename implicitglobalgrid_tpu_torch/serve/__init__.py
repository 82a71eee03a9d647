"""Serving tier: the port's networked front doors.

Counterpart of `implicitglobalgrid_tpu/serve/`, whole (host code; no
kernel of its own). Two stateless HTTP services turn a scheduler flight
directory and a snapshot root into network surfaces, so tenants and
dashboards need neither a filesystem mount nor a card:

- `JobApiServer` (`serve.api`): the WRITE side, a versioned JSON job API
  over one flight directory. Submissions become queue-backend records a
  live `service.MeshScheduler` claims (either package's); cancel, resize
  and drain become the control files ``tools jobs`` writes; status is
  re-derived from the journal (`service_report`'s source).
- `SnapshotQueryServer` (`serve.query`): the READ side, O(box) sub-box
  reads of any committed snapshot (either package's), streamed as ``.npy``
  bytes through a bounded `BlockCache` LRU (`serve.cache`) of
  checksum-verified decoded blocks.
- `ObservePlane` / `ObserveServer` (`serve.observe`): the LIVE side,
  ``GET /v1/observe`` (the derived-signal snapshot) and ``GET
  /v1/events?since=<seq>`` (the merged flight feed as resumable chunked
  NDJSON) over `telemetry.LiveAggregate`. Mounted on `JobApiServer` by
  default; `ObserveServer` serves it standalone.

All ride on `telemetry.MetricsServer` (``routes=``): every endpoint also
serves ``/metrics`` + ``/healthz``, binds loopback by default, and can
require a bearer token on its ``/v1`` routes (``api_token=``, default
``IGG_API_TOKEN``).
"""

from .api import JobApiServer
from .cache import BlockCache, CachedSnapshot
from .observe import ObservePlane, ObserveServer
from .query import SnapshotQueryServer

__all__ = [
    "JobApiServer", "SnapshotQueryServer", "BlockCache", "CachedSnapshot",
    "ObservePlane", "ObserveServer",
]
