"""Run telemetry: metrics registry, flight recorder, hooks, exporter, run
report, the performance oracle, the live metrics endpoint and the mesh view.

Counterpart of `implicitglobalgrid_tpu/telemetry/`, host Python (the
calibration alone runs work on the device):

- `registry` — process-local, thread-safe metric families (counters,
  gauges, fixed-bucket histograms) with labels.
- `recorder` — the span/event flight recorder: one append-only JSONL stream
  per process in the JAX package's format (version 1), so each package
  reads the other's streams.
- `hooks` — the metric-name contract the driver, `update_halo`'s
  accounting, the checkpoint layer and the snapshot writer call (the JAX
  package's names and label sets).
- `export` — Prometheus text-format snapshots.
- `report` — `run_report`: the unified record of a run, from one stream,
  a multi-process stream or a directory of per-process streams (its
  ``"mesh"`` section), merged with `overlap_stats`/`op_breakdown`.
- `aggregate` — `aggregate_flight`/`aggregate_events` (per-process streams
  -> one clock-aligned sequence), `straggler_report`, `mesh_section`.
- `trace_export` — `export_chrome_trace`: a Perfetto timeline, a track a
  process.
- `server` — `start_metrics_server` & co.: ``/metrics`` and ``/healthz``.
- `perfmodel` — `MachineProfile`, `predict_step` (the analytical cost
  model), `predict_reshard` (a reshard plan's price) and `PerfWatch`, the
  driver's live drift detector.
- `calibrate` — `calibrate_machine`: a triad, an FMA chain (a hand-written
  kernel on the card) and per-axis link fits -> a `MachineProfile`.
- `perfdb` — the perf-history database and gate.
- `tune` — `tune_config`: the auto-tuner (priced, then measured) and its
  `TunedConfig`, applied by `runtime.RunSpec(tuned=)`.
- `live` — the live plane: `FlightTail` (byte-offset incremental tailing of
  flight JSONLs, torn-line and gap tolerant), `LiveAggregate` (rolling
  derived signals: step-time quantiles and robust z, deadline slack,
  barrier spreads and stragglers, byte rates, queue pressure) and the
  declarative `AlertRule`/`AlertEngine` with `default_rule_pack` and its
  sinks (`log_sink`, `ControlFileSink`, `WebhookSink`).
- `tracectx` / `otlp` — end-to-end tracing. `TraceContext` is the W3C
  ``traceparent`` context the scheduler stamps into its journal and each
  job's flight stream; `export_otlp` renders the streams as OTLP/HTTP JSON;
  `OtlpSpanExporter` is the batched live sink.
"""

from .aggregate import (
    aggregate_events, aggregate_flight, mesh_section, straggler_report,
)
from .calibrate import calibrate_machine
from .export import prometheus_snapshot
from .hooks import account_halo_exchange, note_heartbeat, observe_checkpoint
from .live import (
    AlertEngine, AlertRule, ControlFileSink, FlightTail, LiveAggregate,
    WebhookSink, default_rule_pack, log_sink,
)
from .otlp import OtlpSpanExporter, export_otlp
from .perfdb import metric_direction, perfdb_add, perfdb_check, perfdb_load
from .perfmodel import (
    STEP_WORKLOADS, MachineProfile, PerfWatch, StepWorkload,
    default_machine_profile, hierarchical_machine_profile,
    load_machine_profile, predict_reshard, predict_step, robust_z,
    save_machine_profile, ReshardPrediction,
)
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
from .server import (
    MetricsServer, metrics_server, resolve_api_token, start_metrics_server,
    stop_metrics_server,
)
from .trace_export import export_chrome_trace
from .tracectx import TraceContext
from .tune import (
    TunedConfig, load_tuned_config, resolve_tuned, save_tuned_config,
    tune_config, tuned_config_path,
)

__all__ = [
    "MetricsRegistry", "ScopedRegistry", "Counter", "Gauge", "Histogram",
    "DEFAULT_BUCKETS", "metrics_registry", "reset_metrics",
    "FlightRecorder", "start_flight_recorder", "stop_flight_recorder",
    "flight_recorder", "record_event", "record_span", "read_flight_events",
    "use_flight_recorder", "bind_thread_recorder",
    "prometheus_snapshot", "run_report",
    "aggregate_flight", "aggregate_events", "straggler_report",
    "mesh_section", "export_chrome_trace",
    "MetricsServer", "start_metrics_server", "stop_metrics_server",
    "metrics_server", "resolve_api_token",
    "account_halo_exchange", "observe_checkpoint", "note_heartbeat",
    "MachineProfile", "StepWorkload", "STEP_WORKLOADS", "PerfWatch",
    "robust_z", "default_machine_profile", "hierarchical_machine_profile",
    "load_machine_profile", "save_machine_profile", "predict_step",
    "predict_reshard", "ReshardPrediction",
    "calibrate_machine",
    "metric_direction", "perfdb_add", "perfdb_check", "perfdb_load",
    "TunedConfig", "tune_config", "save_tuned_config",
    "load_tuned_config", "resolve_tuned", "tuned_config_path",
    "FlightTail", "LiveAggregate", "AlertRule", "AlertEngine",
    "default_rule_pack", "log_sink", "ControlFileSink", "WebhookSink",
    "TraceContext", "export_otlp", "OtlpSpanExporter",
]
