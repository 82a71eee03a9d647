"""Run telemetry: metrics registry, flight recorder, hooks, exporter, run
report and the live drift detector.

Counterpart of the core of `implicitglobalgrid_tpu/telemetry/`, pure host
Python (no device work):

- `registry` — process-local, thread-safe metric families (counters,
  gauges, fixed-bucket histograms) with labels; the resilient runtime's
  ``igg_health_events_total`` family lives here.
- `recorder` — the span/event flight recorder: one append-only JSONL stream
  per run in the JAX package's format (version 1), so each package reads
  the other's streams.
- `hooks` — the metric-name contract the driver, the checkpoint layer and
  the snapshot writer call (the JAX package's names and label sets).
- `export` — Prometheus text-format snapshots.
- `report` — `run_report`: the unified record of one process's stream,
  merged with `overlap_stats`/`op_breakdown`.
- `perfmodel` — `robust_z` and `PerfWatch`, the driver's live drift
  detector.

Not ported yet (ROADMAP Queue A item 2): the metrics server, the live
plane, aggregate (multi-process streams), perfdb, otlp, tracectx,
trace_export, and the model half of `perfmodel` with `calibrate` and
`tune`.
"""

from .export import prometheus_snapshot
from .hooks import note_heartbeat, observe_checkpoint
from .perfmodel import PerfWatch, robust_z
from .recorder import (
    FlightRecorder, bind_thread_recorder, flight_recorder, read_flight_events,
    record_event, record_span, start_flight_recorder, stop_flight_recorder,
    use_flight_recorder,
)
from .registry import (
    DEFAULT_BUCKETS, Counter, Gauge, Histogram, MetricsRegistry,
    ScopedRegistry, metrics_registry, reset_metrics,
)
from .report import run_report

__all__ = [
    "MetricsRegistry", "ScopedRegistry", "Counter", "Gauge", "Histogram",
    "DEFAULT_BUCKETS", "metrics_registry", "reset_metrics",
    "FlightRecorder", "start_flight_recorder", "stop_flight_recorder",
    "flight_recorder", "record_event", "record_span", "read_flight_events",
    "use_flight_recorder", "bind_thread_recorder",
    "prometheus_snapshot", "run_report",
    "observe_checkpoint", "note_heartbeat",
    "PerfWatch", "robust_z",
]
