"""implicitglobalgrid_tpu_torch — the PyTorch/CUDA port of implicitglobalgrid_tpu.

Stencil computations on an implicit global grid by Cartesian domain
decomposition, on PyTorch with hand-written CUDA kernels for Hopper
(`csrc/`). The JAX package `implicitglobalgrid_tpu` is the reference this
package is tested against; this package imports neither `jax` nor it.

Each process owns a box of ranks: their blocks are views of one stacked
tensor (shape ``box * local_shape``) on the process's device, and a halo
exchange between them is a copy between block views; between processes of a
`torch.distributed` group (``torchrun``, one process a card) the edge slabs
go through `parallel.transport`. One process owns every rank (the virtual
mesh, ``box == dims``). Entry points run on the current CUDA device unless
the caller passes ``device_type="cpu"``.

Public API — the reference's 13 exported symbols::

    init_global_grid, finalize_global_grid, update_halo, gather,
    select_device, nx_g, ny_g, nz_g, x_g, y_g, z_g, tic, toc

plus `local_update_halo`, `hide_communication`, `halo_comm_plan`, `stochastic_round_bf16`,
`zeros_g`/`ones_g`/`full_g`/`device_put_g`,
`coords_g`/`x_g_vec`, `gather_interior`, `gather_sub`, `barrier`/`sync`, the stencil
helpers (`d_xa` … `inn`), the `Field` wrapper, profiling (`trace`, `annotate`,
`overlap_stats`, `op_breakdown`) and the ensemble axis (`ensemble_state`,
`ensemble_partition_spec`), checkpoints (`save_checkpoint[_sharded]`,
`restore_checkpoint[_sharded|_elastic]`, `elastic_restart`), async snapshots
and their reader (`io`: `SnapshotWriter`, `open_snapshot`), and the health
guard and in-situ reducers after each chunk (`make_guarded_runner`, `Probe`,
`AxisSlice`, `Stats`), the supervised run (`run_resilient`, `ResilientRun`,
`RunSpec`) and its telemetry (`telemetry`: the metrics registry, the flight
recorder, `prometheus_snapshot`, `run_report`, `PerfWatch`), the
performance oracle (`MachineProfile`, `predict_step`, `calibrate_machine`,
`tune_config`, perfdb, `predict_reshard`), the metrics server
(`start_metrics_server`), the mesh view (`aggregate_flight`,
`straggler_report`, `export_chrome_trace`), the communication audit
(`analysis`: the recorder, contracts, lints, `audit_model`), on-device
elastic resharding (`reshard`: `build_reshard_plan`, `reshard_state`), the
live plane (`FlightTail`, `LiveAggregate`, `AlertEngine` and its sinks,
`TraceContext`, `export_otlp`), the persistent-mesh service (`service`:
`MeshScheduler`, `JobSpec`, `service_report`, the autoscaler) and the
serving tier (`serve`: `JobApiServer`, `SnapshotQueryServer` with its
`BlockCache`, `ObservePlane`/`ObserveServer`). The operator CLI is
``python -m implicitglobalgrid_tpu_torch.tools``.
Usage::

    import implicitglobalgrid_tpu_torch as igg
    me, dims, nprocs, coords, mesh = igg.init_global_grid(nx, ny, nz)
    T = igg.zeros_g()
    T = igg.update_halo(T)
    igg.finalize_global_grid()
"""

from .parallel.grid import init_global_grid, finalize_global_grid, select_device
from .parallel.topology import (
    AXIS_NAMES, NDIMS, PROC_NULL, GlobalGrid,
    global_grid, get_global_grid, grid_is_initialized, check_initialized,
    neighbors_table, ol, dims_create,
)
from .ops.halo import update_halo, local_update_halo, halo_comm_plan, DEFAULT_DIMS_ORDER
from .ops.overlap import hide_communication
from .ops.precision import stochastic_round_bf16
from .ops.gather import gather, gather_interior, gather_sub
from .ops.alloc import zeros_g, ones_g, full_g, device_put_g
from .ops.fields import Field, wrap_field, extract, local_shape_of, stacked_shape
from .ops.stencil import d_xa, d_ya, d_za, d_xi, d_yi, d_zi, inn
from .tools import (
    nx_g, ny_g, nz_g, x_g, y_g, z_g, x_g_vec, y_g_vec, z_g_vec, coords_g,
)
from .utils.timing import tic, toc, barrier, sync
from .utils.profiling import trace, annotate, overlap_stats, op_breakdown
from .utils import exceptions
from .models import (
    AcousticParams, acoustic_state_from_numpy, acoustic_step_local, init_acoustic3d,
    make_acoustic_run, run_acoustic, StokesParams, init_stokes3d, run_stokes,
    stokes_residuals, stokes_state_from_numpy, stokes_step_local, make_stokes_run,
)
from .models.common import ensemble_partition_spec, ensemble_state
from .utils.checkpoint import (
    save_checkpoint, restore_checkpoint, load_checkpoint,
    save_checkpoint_sharded, restore_checkpoint_sharded,
    restore_checkpoint_elastic, saved_topology, elastic_local_size,
)
from .runtime import (
    run_resilient, ResilientRun, RunSpec,
    GuardConfig, HealthReport, RecoveryPolicy, make_guarded_runner,
    NaNPoke, CheckpointCorruption, ProcessLoss,
    poke_nan, corrupt_checkpoint, elastic_restart,
)
from . import telemetry
from .telemetry import (
    MetricsRegistry, metrics_registry, reset_metrics, prometheus_snapshot,
    FlightRecorder, start_flight_recorder, stop_flight_recorder,
    flight_recorder, record_event, record_span, read_flight_events,
    run_report, PerfWatch, aggregate_flight, aggregate_events,
    straggler_report, export_chrome_trace,
    MetricsServer, start_metrics_server, stop_metrics_server, metrics_server,
    MachineProfile, StepWorkload, default_machine_profile,
    load_machine_profile, save_machine_profile, predict_step, predict_reshard,
    calibrate_machine, perfdb_add, perfdb_check,
    TunedConfig, tune_config, save_tuned_config, load_tuned_config,
)
from . import analysis
from .analysis import (
    AuditFinding, AuditReport, CollectiveContract, ProgramIR,
    audit_model, audit_program, check_contract, exchange_contract,
    model_contract, parse_program,
)
from . import reshard
from .reshard import ReshardPlan, build_reshard_plan, reshard_contract, reshard_state
from . import io
from .io import (
    SnapshotWriter, write_snapshot, open_snapshot, list_snapshots,
    Probe, AxisSlice, Stats,
)
from .telemetry import (
    FlightTail, LiveAggregate, AlertRule, AlertEngine, default_rule_pack,
    log_sink, ControlFileSink, WebhookSink,
    TraceContext, export_otlp, OtlpSpanExporter,
)
from . import service
from .service import (
    MeshScheduler, JobSpec, JobState, service_report, export_service_trace,
)
from . import serve
from .serve import (
    BlockCache, CachedSnapshot, JobApiServer, ObservePlane, ObserveServer,
    SnapshotQueryServer,
)

__version__ = "0.1.0"

__all__ = [
    "init_global_grid", "finalize_global_grid", "update_halo", "gather",
    "select_device", "nx_g", "ny_g", "nz_g", "x_g", "y_g", "z_g", "tic", "toc",
    "local_update_halo", "hide_communication", "halo_comm_plan", "gather_interior", "gather_sub", "barrier",
    "sync", "stochastic_round_bf16", "trace", "annotate", "overlap_stats", "op_breakdown",
    "ensemble_state", "ensemble_partition_spec",
    "zeros_g", "ones_g", "full_g", "device_put_g",
    "Field", "wrap_field", "extract", "local_shape_of", "stacked_shape",
    "x_g_vec", "y_g_vec", "z_g_vec", "coords_g",
    "d_xa", "d_ya", "d_za", "d_xi", "d_yi", "d_zi", "inn",
    "AXIS_NAMES", "NDIMS", "PROC_NULL", "GlobalGrid", "global_grid",
    "get_global_grid", "grid_is_initialized", "check_initialized",
    "neighbors_table", "ol", "dims_create", "DEFAULT_DIMS_ORDER",
    "exceptions", "AcousticParams", "init_acoustic3d", "acoustic_step_local",
    "make_acoustic_run", "run_acoustic", "acoustic_state_from_numpy",
    "StokesParams", "init_stokes3d", "stokes_step_local", "make_stokes_run", "run_stokes",
    "stokes_residuals", "stokes_state_from_numpy",
    "save_checkpoint", "restore_checkpoint", "load_checkpoint",
    "save_checkpoint_sharded", "restore_checkpoint_sharded",
    "restore_checkpoint_elastic", "saved_topology", "elastic_local_size",
    "run_resilient", "ResilientRun", "RunSpec",
    "GuardConfig", "HealthReport", "RecoveryPolicy", "make_guarded_runner",
    "NaNPoke", "CheckpointCorruption", "ProcessLoss",
    "poke_nan", "corrupt_checkpoint", "elastic_restart",
    "io", "SnapshotWriter", "write_snapshot", "open_snapshot", "list_snapshots",
    "Probe", "AxisSlice", "Stats",
    "MetricsRegistry", "metrics_registry", "reset_metrics", "prometheus_snapshot",
    "FlightRecorder", "start_flight_recorder", "stop_flight_recorder",
    "flight_recorder", "record_event", "record_span", "read_flight_events",
    "run_report", "PerfWatch", "aggregate_flight", "aggregate_events",
    "straggler_report", "export_chrome_trace",
    "MetricsServer", "start_metrics_server", "stop_metrics_server", "metrics_server",
    "MachineProfile", "StepWorkload", "default_machine_profile",
    "load_machine_profile", "save_machine_profile", "predict_step",
    "calibrate_machine", "perfdb_add", "perfdb_check",
    "TunedConfig", "tune_config", "save_tuned_config", "load_tuned_config",
    "predict_reshard",
    "analysis", "AuditFinding", "AuditReport", "CollectiveContract", "ProgramIR",
    "audit_model", "audit_program", "check_contract", "exchange_contract",
    "model_contract", "parse_program",
    "reshard", "ReshardPlan", "build_reshard_plan", "reshard_contract", "reshard_state",
    "service", "MeshScheduler", "JobSpec", "JobState", "service_report",
    "export_service_trace",
    "FlightTail", "LiveAggregate", "AlertRule", "AlertEngine",
    "default_rule_pack", "log_sink", "ControlFileSink", "WebhookSink",
    "TraceContext", "export_otlp", "OtlpSpanExporter",
    "serve", "JobApiServer", "SnapshotQueryServer", "BlockCache",
    "CachedSnapshot", "ObservePlane", "ObserveServer",
]
