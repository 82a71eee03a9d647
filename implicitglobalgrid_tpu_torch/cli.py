"""The operator CLI: ``python -m implicitglobalgrid_tpu_torch.tools``.

Counterpart of the JAX package's ``python -m implicitglobalgrid_tpu.tools``
(its `tools._cli` and command functions): the same subcommands, flags,
printed text or JSON and exit codes. `main` is `tools._cli`. Subcommands:

- ``report <run.jsonl|dir> [--trace DIR] [--run-id ID] [--indent N]
  [--no-metrics]``: the unified `telemetry.run_report` (post-hoc).
- ``prom``: this process's Prometheus metrics snapshot.
- ``snapshots <root>``: the COMMITTED snapshots under a `SnapshotWriter`
  root (step, path, fields, implicit-global shapes, bytes). Host-only.
- ``probe <root|snapshot> <field> i [j [k]]``: one implicit-global cell
  from every snapshot under a root (``step value`` lines) or from one
  snapshot directory; O(one block) a snapshot. Host-only.
- ``aggregate``, ``trace`` (``--otlp``, ``--trace-id``, ``--job``; a
  scheduler directory renders one track a job) and ``stragglers``: the
  mesh view of per-process flight streams. Host-only.
- ``watch <flight_dir> [--once] [--json]``: the live terminal dashboard
  (`telemetry.LiveAggregate`); ``alerts <flight_dir> [--ack RULE[:JOB]]``:
  the journaled alert transitions, acks in ``alerts_ack.json``; ``flight
  du``: per-stream bytes. Host-only.
- ``perfdb add|check <rows.json> --db HISTORY.jsonl``: the perf history;
  ``check`` exits 1 on a regression. Host-only.
- ``calibrate [--out profile.json]``: measure this machine's profile
  (`telemetry.calibrate_machine`: memory bandwidth, the FLOP rate by the
  FMA chain kernel on a card, per-axis links) on a self-initialized grid;
  ``--preset hierarchical`` prints a canned profile host-only.
- ``tune <model>``: the auto-tuner (`telemetry.tune_config`); ``tune show
  <tuned.json>`` prints a persisted config host-only.
- ``reshard plan|run``: the transfer plan and its static price
  (host-only), or the re-block run on a self-initialized grid, audited and
  held bitwise against the host oracle (exit 1 on a finding or mismatch).
- ``autoscale explain <dir>``: every journaled autoscale decision.
- ``jobs submit|list|status|cancel|drain|resize``: the scheduler's
  operator surface (exit 1 unless every submitted job finishes; 3 an
  unknown job, 4 a finished one).
- ``audit [model ...] [--hlo FILE] [--json]``: the communication audit of
  each model's recorded step on a self-initialized grid, or of a captured
  HLO/StableHLO dump host-only (the port's own parser); exit 1 on an
  error finding.

The device-touching commands (``calibrate``, ``tune <model>``, ``audit
<model>``, ``reshard run``, ``jobs submit``) run on the current CUDA device.
``--cpu`` runs them on the CPU (``device_type="cpu"``); without it and
without a card they exit 2 with a message, never quietly on the CPU. Their
``--nranks`` (default 8, the size of the JAX package's ``--cpu`` mesh) is
the rank count the JAX package takes from its device count: the dims of a
self-initialized grid (`dims_create`), the rank pool of ``jobs submit``'s
scheduler and of each job grid that leaves dims at 0, and the transfer mesh
``reshard run`` may use. The same command line gives the same dims in both
packages. Flags that mean nothing to the port raise `InvalidArgumentError`
with the reason: ``audit --lowered`` (no compiled program: the port records
what its routes move), ``audit --impl pallas_interpret`` (a CUDA kernel has
no interpret mode; ``--impl xla`` is the plain route, ``--impl pallas`` the
kernel routes). ``audit --wire-stage`` audits the staged wire as the port
runs it (`analysis.audit.audit_model`: staged by process, held to the flat
contract).
"""

from __future__ import annotations

import json
import os
import sys

from .utils.exceptions import InvalidArgumentError

__all__ = ["main"]

PROG = "python -m implicitglobalgrid_tpu_torch.tools"
DEFAULT_NRANKS = 8  # the JAX package's --cpu mesh: the same dims either way


def _add_device_args(p, what: str) -> None:
    p.add_argument("--cpu", action="store_true",
                   help=f"{what} on the CPU (device_type='cpu') instead of "
                        "the current CUDA device")
    p.add_argument("--nranks", type=int, default=DEFAULT_NRANKS,
                   help="rank count of the self-initialized grid (dims by "
                        "dims_create) and the rank pool (default 8: the "
                        "JAX package's --cpu mesh)")


def _build_parser():
    import argparse

    ap = argparse.ArgumentParser(
        prog=PROG, description="implicitglobalgrid_tpu_torch operator tools")
    sub = ap.add_subparsers(dest="cmd", required=True)
    jp = sub.add_parser(
        "jobs", help="multi-run scheduler: submit a job queue, inspect "
                     "or control a service flight directory")
    jobs_sub = jp.add_subparsers(dest="jobs_cmd", required=True)
    js = jobs_sub.add_parser(
        "submit", help="run a JSON-described job queue through one "
                       "MeshScheduler (exit 1 unless every job finishes)")
    js.add_argument("spec", help="queue JSON: {policy?, jobs: [{name, "
                                 "model, nt, grid?, dtype?, priority?, "
                                 "deadline_s?, run?}]}")
    js.add_argument("--flight-dir", default=None,
                    help="journal + per-job flight JSONLs land here "
                         "(enables list/status/report afterwards)")
    js.add_argument("--policy", default=None,
                    help="override the spec's policy (fifo | round_robin "
                         "| fair)")
    js.add_argument("--metrics-port", type=int, default=None,
                    help="serve the scheduler-owned /metrics + /healthz "
                         "for the duration (0 = ephemeral)")
    _add_device_args(js, "run the jobs")
    js.add_argument("--json", action="store_true")
    jl = jobs_sub.add_parser(
        "list", help="jobs of a service flight directory (post-hoc, "
                     "from the journal alone)")
    jl.add_argument("flight_dir")
    jl.add_argument("--json", action="store_true")
    jst = jobs_sub.add_parser(
        "status", help="one job's record (exit 3 when unknown)")
    jst.add_argument("flight_dir")
    jst.add_argument("name")
    jst.add_argument("--indent", type=int, default=2)
    jc = jobs_sub.add_parser(
        "cancel", help="file a cancel request a LIVE scheduler consumes "
                       "at its next slice boundary (exit 3 unknown job, "
                       "4 already finished)")
    jc.add_argument("flight_dir")
    jc.add_argument("name")
    jd = jobs_sub.add_parser(
        "drain", help="file a drain request: cancel queued jobs, finish "
                      "running ones")
    jd.add_argument("flight_dir")
    jrs = jobs_sub.add_parser(
        "resize", help="file an elastic-resize request a LIVE scheduler "
                       "applies at the job's next slice boundary "
                       "(on-device re-block, checkpoint-elastic "
                       "fallback; exit 3 unknown job, 4 already "
                       "finished)")
    jrs.add_argument("flight_dir")
    jrs.add_argument("name")
    jrs.add_argument("dims", help="new decomposition, e.g. 1,2,2")
    jrs.add_argument("--via", default="auto",
                     choices=["auto", "device", "checkpoint"],
                     help="force the on-device or checkpoint path "
                          "(default: device with fallback)")
    rp = sub.add_parser("report", help="unified run report from a "
                                       "flight-recorder JSONL stream")
    rp.add_argument("jsonl", help="flight-recorder .jsonl file")
    rp.add_argument("--trace", default=None,
                    help="profiler capture dir to merge "
                         "(overlap_stats/op_breakdown)")
    rp.add_argument("--run-id", default=None,
                    help="run id when the file holds several runs "
                         "(default: the last run)")
    rp.add_argument("--indent", type=int, default=2)
    rp.add_argument("--no-metrics", action="store_true",
                    help="omit the (empty, post-hoc) registry snapshot")
    sub.add_parser("prom", help="Prometheus text-format metrics snapshot")
    sp = sub.add_parser("snapshots",
                        help="list committed snapshots under a root")
    sp.add_argument("root", help="SnapshotWriter root directory")
    sp.add_argument("--json", action="store_true",
                    help="one JSON object per snapshot instead of a table")
    pp = sub.add_parser(
        "probe", help="point time-series from snapshots (O(1 block) "
                      "reads, no grid, no gather)")
    pp.add_argument("path", help="snapshot root (time series over every "
                                 "snapshot) or a single snapshot dir")
    pp.add_argument("field", help="field name in the snapshots")
    pp.add_argument("index", nargs="+", type=int,
                    help="implicit-global cell index (one per dimension)")
    pp.add_argument("--json", action="store_true")
    agp = sub.add_parser(
        "aggregate", help="merge per-process flight streams into one "
                          "clock-aligned mesh-wide sequence")
    agp.add_argument("src", nargs="+",
                     help="directory of flight_p*.jsonl streams, or the "
                          "stream files themselves")
    agp.add_argument("--run-id", default=None)
    agp.add_argument("--out", default=None,
                     help="also write the merged event sequence as JSONL")
    agp.add_argument("--indent", type=int, default=2)
    tp = sub.add_parser(
        "trace", help="Chrome/Perfetto trace-event JSON from per-process "
                      "flight streams (open at ui.perfetto.dev)")
    tp.add_argument("src", nargs="+",
                    help="directory of flight_p*.jsonl streams, or the "
                         "stream files themselves")
    tp.add_argument("-o", "--out", default="trace.json")
    tp.add_argument("--run-id", default=None)
    tp.add_argument("--otlp", action="store_true",
                    help="emit OTLP/HTTP JSON ResourceSpans (the span-"
                         "tree view any OpenTelemetry collector ingests) "
                         "instead of Perfetto trace-event JSON")
    tp.add_argument("--trace-id", default=None,
                    help="filter to ONE distributed trace (32-hex id "
                         "from a traceparent) — the causal slice of a "
                         "single request")
    tp.add_argument("--job", default=None,
                    help="with --otlp: filter to one job's spans")
    stp = sub.add_parser(
        "stragglers", help="cross-process straggler & imbalance report")
    stp.add_argument("src", nargs="+",
                     help="directory of flight_p*.jsonl streams, or the "
                          "stream files themselves")
    stp.add_argument("--run-id", default=None)
    stp.add_argument("--window", type=int, default=8,
                     help="rolling window (chunks) for persistent-"
                          "straggler flags")
    stp.add_argument("--share", type=float, default=0.5,
                     help="slowest-share above which a window flags")
    stp.add_argument("--indent", type=int, default=2)
    wp = sub.add_parser(
        "watch", help="live terminal dashboard over a flight directory "
                      "(incremental tail, rolling derived signals, "
                      "active alerts)")
    wp.add_argument("flight_dir",
                    help="directory of per-run flight JSONLs (a live "
                         "run's flight dir or a scheduler's service dir)")
    wp.add_argument("--interval", type=float, default=2.0,
                    help="seconds between polls/redraws")
    wp.add_argument("--window", type=int, default=16,
                    help="rolling window (boundaries) for the derived "
                         "signals")
    wp.add_argument("--once", action="store_true",
                    help="poll once, print one frame, exit (no screen "
                         "clear — the scripting/test mode)")
    wp.add_argument("--json", action="store_true",
                    help="emit the raw snapshot JSON instead of the "
                         "table")
    al = sub.add_parser(
        "alerts", help="list journaled alert transitions of a flight "
                       "directory; acknowledge with --ack")
    al.add_argument("flight_dir")
    al.add_argument("--ack", default=None, metavar="RULE[:JOB]",
                    help="acknowledge an alert (recorded in the side "
                         "file alerts_ack.json, never in the journal)")
    al.add_argument("--json", action="store_true")
    fl = sub.add_parser(
        "flight", help="flight-directory hygiene (disk usage of the "
                       "recorder streams)")
    fl_sub = fl.add_subparsers(dest="flight_cmd", required=True)
    fdu = fl_sub.add_parser(
        "du", help="per-stream on-disk bytes of a flight directory, "
                   "largest first — recorder growth before it becomes "
                   "an incident (the igg_flight_file_bytes gauges are "
                   "the live twin)")
    fdu.add_argument("flight_dir")
    fdu.add_argument("--json", action="store_true")
    pdb = sub.add_parser(
        "perfdb", help="perf-history database: append bench runs, gate "
                       "regressions vs the trailing window")
    pdb_sub = pdb.add_subparsers(dest="perfdb_cmd", required=True)
    pda = pdb_sub.add_parser("add", help="append a bench run to the "
                                         "history JSONL")
    pda.add_argument("rows", help="bench rows JSON (a list of metric "
                                  "rows)")
    pda.add_argument("--db", required=True, help="history JSONL path")
    pda.add_argument("--note", default=None,
                     help="free-form note stored in the record's meta")
    pdc = pdb_sub.add_parser(
        "check", help="gate a bench run against the trailing history "
                      "(exit 1 on regression)")
    pdc.add_argument("rows", help="bench rows JSON (a list of metric "
                                  "rows)")
    pdc.add_argument("--db", required=True, help="history JSONL path")
    pdc.add_argument("--window", type=int, default=5,
                     help="trailing history records forming the baseline")
    pdc.add_argument("--threshold", type=float, default=0.30,
                     help="relative change in the worse direction that "
                          "fails a metric")
    pdc.add_argument("--min-history", type=int, default=2,
                     help="history points a metric needs before it gates")
    pdc.add_argument("--indent", type=int, default=2)
    tu = sub.add_parser(
        "tune", help="closed-loop auto-tuner: search the cost model over "
                     "comm_every/wire_dtype/wire_stage/coalesce/overlap/"
                     "ensemble, validate with short measured runs, "
                     "persist the winning TunedConfig")
    tu.add_argument("model",
                    help="model family to tune (diffusion3d, acoustic3d, "
                         "stokes3d) — or 'show' to inspect a persisted "
                         "config")
    tu.add_argument("path", nargs="?", default=None,
                    help="with 'show': the tuned-config JSON to print")
    tu.add_argument("--profile", default=None,
                    help="calibrated MachineProfile JSON "
                         "(tools calibrate --out); default: grid-derived "
                         "spec coefficients. A profile path also sets "
                         "the default persist location (tuned_<model>."
                         "json next to it)")
    tu.add_argument("--out", default=None,
                    help="persist the winning TunedConfig JSON here")
    tu.add_argument("--nx", type=int, default=32,
                    help="base local block edge of the tuning grid")
    _add_device_args(tu, "tune")
    tu.add_argument("--no-measure", action="store_true",
                    help="model-only search (skip the measured "
                         "validation runs)")
    tu.add_argument("--top-k", type=int, default=2,
                    help="predicted candidates to validate with "
                         "measured runs")
    tu.add_argument("--comm-every-options", default=None,
                    help="comma-separated cadence candidates (e.g. "
                         "'1,2,z:2,z:4'); default: 1, 2, and each "
                         "exchanging axis's solo cadence")
    tu.add_argument("--wire-options", default=None,
                    help="comma-separated wire-policy candidates (e.g. "
                         "'off,z:int8,z:int8,x:f32' — entries with ':' "
                         "are kept whole per policy segment; use ';' to "
                         "separate multi-axis policies)")
    tu.add_argument("--wire-stage-options", default=None,
                    help="comma-separated staged-wire candidates (e.g. "
                         "'off,z:staged'): priced only — the port's "
                         "transport does not stage, so a staged winner "
                         "runs the flat exchange")
    tu.add_argument("--ensemble-options", default=None,
                    help="comma-separated ensemble sizes to sweep "
                         "(e.g. '1,4,8'; 1 = solo)")
    tu.add_argument("--overlap", action="store_true",
                    help="include overlap=True candidates")
    tu.add_argument("--indent", type=int, default=2)
    cal = sub.add_parser(
        "calibrate", help="measure this machine's profile (membw, flops, "
                          "per-axis link bw/latency) for the cost model")
    cal.add_argument("--out", default=None,
                     help="also persist the profile JSON here")
    cal.add_argument("--nx", type=int, default=32,
                     help="local block edge of the calibration grid")
    _add_device_args(cal, "profile")
    cal.add_argument("--ensemble", type=int, default=None,
                     help="calibrate the per-axis link fit in the "
                          "E-member ensemble payload regime (payload "
                          "sizes scale by E; recorded in the profile "
                          "meta)")
    cal.add_argument("--preset", default=None, choices=("hierarchical",),
                     help="skip measurement and emit a canned profile "
                          "instead: 'hierarchical' is the two-link-class "
                          "preset (the card's links on x and y, a slower "
                          "class on z) that makes staged-vs-flat wire "
                          "pricing meaningful (host-only: no grid, no "
                          "card)")
    cal.add_argument("--indent", type=int, default=2)
    rs = sub.add_parser(
        "reshard", help="on-device elastic resharding: print a transfer "
                        "plan host-only, or run + contract-audit + "
                        "verify the re-block (exit 1 on violation)")
    rs_sub = rs.add_subparsers(dest="reshard_cmd", required=True)
    for prs, what in ((rs_sub.add_parser(
            "plan", help="derive and print the (src -> dst) transfer "
                         "plan + its static price (host-only: no grid, "
                         "no card)"), "plan"),
            (rs_sub.add_parser(
                "run", help="execute the re-block on a self-initialized "
                            "grid, audit its recording against the plan "
                            "contract, verify vs the host oracle (exit 1 "
                            "on any error finding or mismatch)"), "run")):
        prs.add_argument("--src-dims", required=True,
                         help="source decomposition, e.g. 2,2,1")
        prs.add_argument("--dst-dims", required=True,
                         help="destination decomposition, e.g. 1,2,2")
        prs.add_argument("--nx", type=int, default=8,
                         help="base local block edge on the source dims")
        prs.add_argument("--fields", type=int, default=2,
                         help="number of state fields (field 1 is "
                              "x-staggered, exercising a second "
                              "signature)")
        prs.add_argument("--dtype", default="float32")
        prs.add_argument("--ensemble", type=int, default=None,
                         help="lead every field with an E-member axis "
                              "(the batched-state pass-through)")
        prs.add_argument("--periods", default="0,0,0")
        prs.add_argument("--overlaps", default="2,2,2")
        prs.add_argument("--indent", type=int, default=2)
        prs.add_argument("--json", action="store_true")
        if what == "run":
            _add_device_args(prs, "run")
        if what == "plan":
            prs.add_argument("--nt-remaining", type=int, default=None,
                             help="steps left in the job's horizon: "
                                  "amortize the priced transfer against "
                                  "them (needs --old-step-s and "
                                  "--new-step-s; prints the same "
                                  "break_even record the autoscaler and "
                                  "service_report carry)")
            prs.add_argument("--old-step-s", type=float, default=None,
                             help="per-step seconds on the SOURCE dims "
                                  "(e.g. predict_step or a measured "
                                  "baseline)")
            prs.add_argument("--new-step-s", type=float, default=None,
                             help="per-step seconds on the DESTINATION "
                                  "dims")
    asp = sub.add_parser(
        "autoscale", help="the closed-loop autoscaler's operator "
                          "surface: reconstruct WHY the mesh resized "
                          "itself from a scheduler journal alone")
    as_sub = asp.add_subparsers(dest="autoscale_cmd", required=True)
    ax = as_sub.add_parser(
        "explain", help="every journaled autoscale_decision: the policy "
                        "echo, verdict counts, rejection histogram, and "
                        "each filed move's actuation chain "
                        "(autoscale_decision -> control -> "
                        "resize_requested -> job_resized -> job_retuned) "
                        "with its full pricing breakdown")
    ax.add_argument("flight_dir",
                    help="MeshScheduler flight directory (or its "
                         "scheduler.jsonl)")
    ax.add_argument("--job", default=None,
                    help="only this job's decisions and moves")
    ax.add_argument("--indent", type=int, default=2)
    aud = sub.add_parser(
        "audit", help="static analysis of recorded step programs: "
                      "collective contract + implicit-grid lints + "
                      "perfmodel cross-check (exit 1 on error findings)")
    aud.add_argument("models", nargs="*",
                     help="model steps to record and audit (diffusion3d, "
                          "diffusion2d, acoustic3d, stokes3d); omit with "
                          "--hlo")
    aud.add_argument("--hlo", default=None,
                     help="audit a captured HLO/StableHLO text dump "
                          "host-only instead of recording a model")
    aud.add_argument("--contract", default=None,
                     help="CollectiveContract JSON to check --hlo against "
                          "(default: lints only)")
    aud.add_argument("--impl", default="xla",
                     help="model step route: xla (or plain, the default) "
                          "records the plain route, pallas (or cuda) the "
                          "kernel routes, under the same byte-exact "
                          "contract + crosscheck; pallas_interpret "
                          "raises (a CUDA kernel has no interpret mode)")
    aud.add_argument("--wire-dtype", default=None,
                     help="reduced-precision wire format the exchange was "
                          "built with — float casts (bfloat16/float16), "
                          "quantized (int8/int4), or a per-axis policy "
                          "like z:int8,x:f32 (audits the narrowing "
                          "reached each axis's wire)")
    aud.add_argument("--wire-stage", default=None,
                     help="topology-staged wire policy (e.g. z:staged): "
                          "audits the step the port runs with it, staged "
                          "by process (one transport message a neighbour "
                          "process, side and dim)")
    aud.add_argument("--lowered", action="store_true",
                     help="audit a pre-backend program: raises (the port "
                          "records what its routes move; there is no "
                          "compiled program)")
    aud.add_argument("--ensemble", type=int, default=None,
                     help="audit the E-member BATCHED step: the same "
                          "per-axis permute counts as solo with "
                          "byte-exact E-scaled payloads")
    aud.add_argument("--comm-every", default=None,
                     help="audit the deep-halo SUPER-STEP at this "
                          "cadence (int or per-axis, e.g. z:2): its "
                          "per-axis permute counts and k-wide payload "
                          "bytes must match the super-cycle contract "
                          "(the self-initialized grid gets the cadence's "
                          "halo geometry; plain route)")
    aud.add_argument("--no-crosscheck", action="store_true",
                     help="skip the predict_step pricing cross-check")
    aud.add_argument("--json", action="store_true",
                     help="machine-readable report instead of the summary")
    _add_device_args(aud, "audit")
    aud.add_argument("--nx", type=int, default=16,
                     help="local block edge of the self-initialized grid")
    aud.add_argument("--indent", type=int, default=2)
    return ap


def main(argv=None) -> int:
    """Parse ``argv`` and run the subcommand; returns the exit code."""
    args = _build_parser().parse_args(argv)
    handler = {"audit": _cli_audit, "reshard": _cli_reshard,
               "autoscale": _cli_autoscale, "jobs": _cli_jobs,
               "tune": _cli_tune, "watch": _cli_watch,
               "alerts": _cli_alerts, "flight": _cli_flight,
               "perfdb": _cli_perfdb, "calibrate": _cli_calibrate,
               "aggregate": _cli_aggregate, "trace": _cli_trace,
               "stragglers": _cli_stragglers, "prom": _cli_prom,
               "snapshots": _cli_snapshots, "probe": _cli_probe,
               "report": _cli_report}[args.cmd]
    return handler(args)


# -- device-touching commands: where and on how many ranks ------------------

def _device_type(args, what: str):
    """``"cpu"`` with ``--cpu``; else ``"gpu"`` where a card is visible;
    else None after saying why on stderr (the caller exits 2)."""
    if args.nranks < 1:
        raise InvalidArgumentError(
            f"tools {what}: --nranks must be >= 1; got {args.nranks}.")
    if args.cpu:
        return "cpu"
    import torch

    if not torch.cuda.is_available():
        print(f"tools {what}: no CUDA device is visible; pass --cpu to run "
              "on the CPU.", file=sys.stderr)
        return None
    return "gpu"


def _dims(nranks: int) -> list:
    from .parallel.topology import dims_create

    return [int(d) for d in dims_create(int(nranks), (0, 0, 0))]


# -- host-only commands ------------------------------------------------------

def _cli_report(args) -> int:
    from .telemetry import run_report

    rep = run_report(args.jsonl, run_id=args.run_id, trace_dir=args.trace,
                     include_metrics=not args.no_metrics)
    print(json.dumps(rep, indent=args.indent, default=str))
    return 0


def _cli_prom(args) -> int:
    from .telemetry import prometheus_snapshot

    sys.stdout.write(prometheus_snapshot())
    return 0


def _cli_snapshots(args) -> int:
    from .io import list_snapshots, open_snapshot

    for step, path in list_snapshots(args.root):
        snap = open_snapshot(path)
        nbytes = sum(
            os.path.getsize(os.path.join(path, f))
            for f in os.listdir(path)
            if f.endswith(".npz"))
        rec = {"step": step, "path": path, "fields": snap.names,
               "global_shapes": {n: list(snap.global_shape(n))
                                 for n in snap.names},
               "bytes": nbytes}
        if args.json:
            print(json.dumps(rec))
        else:
            shapes = ", ".join(
                f"{n}{tuple(snap.global_shape(n))}"
                for n in snap.names)
            print(f"step {step:>10}  {nbytes:>12} B  {shapes}  {path}")
    return 0


def _cli_probe(args) -> int:
    from .io import list_snapshots, open_snapshot

    if os.path.exists(os.path.join(args.path, "meta.npz")):
        series = [(None, args.path)]
    else:
        series = list_snapshots(args.path)
    for _step, path in series:
        snap = open_snapshot(path)
        v = snap.read_point(args.field, args.index)
        step = snap.step if snap.step is not None else _step
        if args.json:
            print(json.dumps({"step": step, "field": args.field,
                              "index": list(args.index),
                              "value": float(v)}))
        else:
            print(f"{step} {float(v)!r}")
    return 0


def _agg_source(args):
    return args.src[0] if len(args.src) == 1 else args.src


def _cli_aggregate(args) -> int:
    from .telemetry import aggregate_flight

    agg = aggregate_flight(_agg_source(args), run_id=args.run_id)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            for e in agg["events"]:
                f.write(json.dumps(e, default=str) + "\n")
    summary = {k: v for k, v in agg.items() if k != "events"}
    summary["events"] = len(agg["events"])
    if args.out:
        summary["out"] = args.out
    print(json.dumps(summary, indent=args.indent, default=str))
    return 0


def _cli_trace(args) -> int:
    from .service.report import is_service_dir
    from .telemetry import export_chrome_trace

    src = _agg_source(args)
    if args.otlp:
        from .telemetry import export_otlp

        print(export_otlp(src, args.out, trace_id=args.trace_id,
                          job=args.job))
        return 0
    if isinstance(src, str) and is_service_dir(src):
        if args.trace_id is not None:
            # one trace is one request's causal slice across the journal
            # and the job recorders: filter first, then the single-run
            # exporter applies (same-host monotonic stamps)
            import glob

            from .telemetry.recorder import read_flight_events

            evs = []
            for p in sorted(glob.glob(os.path.join(src, "*.jsonl"))):
                try:
                    evs.extend(read_flight_events(p, offset=0)[0])
                except InvalidArgumentError:
                    continue
            print(export_chrome_trace(evs, args.out,
                                      trace_id=args.trace_id))
            return 0
        # a scheduler directory: jobs are tenants, not mesh processes —
        # one Perfetto track a job instead of refusing the mixed run ids
        from .service import export_service_trace

        print(export_service_trace(src, args.out))
        return 0
    print(export_chrome_trace(src, args.out, run_id=args.run_id,
                              trace_id=args.trace_id))
    return 0


def _cli_stragglers(args) -> int:
    from .telemetry import aggregate_flight, straggler_report

    agg = aggregate_flight(_agg_source(args), run_id=args.run_id)
    rep = straggler_report(agg, window=args.window, share=args.share)
    print(json.dumps(rep, indent=args.indent, default=str))
    return 0


def _cli_perfdb(args) -> int:
    from .telemetry import perfdb_add, perfdb_check

    if args.perfdb_cmd == "add":
        meta = {"note": args.note} if args.note else None
        rec = perfdb_add(args.db, args.rows, meta=meta)
        print(json.dumps({"db": args.db, "ts": rec["ts"],
                          "metrics": len(rec["metrics"])}))
        return 0
    rep = perfdb_check(args.db, args.rows, window=args.window,
                       threshold=args.threshold,
                       min_history=args.min_history)
    print(json.dumps(rep, indent=args.indent, default=str))
    return 0 if rep["ok"] else 1


def _fmt_s(v, unit="s") -> str:
    if v is None:
        return "-"
    return f"{float(v):.3g}{unit}"


def _render_watch(snap: dict) -> str:
    """One dashboard frame from a `LiveAggregate.snapshot()`: pure string
    building, so a test asserts on a frame without a terminal."""
    lines = []
    q = snap.get("queue") or {}
    sched = snap.get("scheduler") or {}
    hdr = f"igg watch  cursor={snap.get('cursor')}"
    tail = snap.get("tail") or {}
    if tail.get("lag_s") is not None:
        # age of the newest merged event: a growing lag on a run that
        # should be stepping means the tail (or the run) stalled
        hdr += f"  lag={_fmt_s(tail['lag_s'])}"
    if sched:
        hdr += (f"  scheduler[slices={sched.get('slices')}"
                f" draining={sched.get('draining')}]")
    if q and "pending" in q:
        hdr += (f"  queue[pending={q.get('pending')}"
                f" oldest={_fmt_s(q.get('oldest_age_s'))}]")
    gaps = snap.get("gaps") or []
    if gaps:
        hdr += f"  gaps={len(gaps)}"
    lines.append(hdr)
    jobs = snap.get("jobs") or {}
    if jobs:
        lines.append(f"{'JOB':<16} {'STATE':<9} {'STEP':>11} "
                     f"{'P50':>8} {'P90':>8} {'Z':>6} {'SLACK':>8} "
                     f"{'TRIPS':>5} {'QD':>3} {'DROP':>4}")
        for name in sorted(jobs):
            j = jobs[name]
            nt = j.get("nt")
            step = f"{j.get('step', 0)}/{nt}" if nt else str(
                j.get("step", 0))
            z = j.get("z")
            lines.append(
                f"{name[:16]:<16} {str(j.get('state', '?'))[:9]:<9} "
                f"{step:>11} {_fmt_s(j.get('step_s_p50')):>8} "
                f"{_fmt_s(j.get('step_s_p90')):>8} "
                f"{('-' if z is None else f'{z:+.1f}'):>6} "
                f"{_fmt_s(j.get('deadline_slack_s')):>8} "
                f"{j.get('guard_trips', 0):>5} "
                f"{j.get('snapshot_queue_depth', 0) or 0:>3} "
                f"{j.get('snapshot_drops', 0):>4}")
    else:
        lines.append("(no jobs yet)")
    procs = snap.get("procs") or {}
    shares = {p: r.get("slowest_share") for p, r in procs.items()
              if r.get("slowest_share") is not None}
    if shares:
        lines.append("stragglers: " + "  ".join(
            f"p{p}={shares[p]:.0%}" for p in sorted(shares)))
    alerts = snap.get("alerts") or {}
    for a in alerts.get("active") or []:
        lines.append(
            f"ALERT {a.get('severity', '?').upper():<8} "
            f"{a.get('rule')}  job={a.get('job') or '-'}  "
            f"value={a.get('value')}")
    return "\n".join(lines) + "\n"


def _cli_watch(args) -> int:
    """A live terminal dashboard: each tick polls the incremental tailer
    (byte offsets carry over, so a redraw reads only what the run appended
    since the last one) and redraws."""
    import time

    from .telemetry.live import LiveAggregate

    agg = LiveAggregate(args.flight_dir, window=args.window)
    try:
        while True:
            agg.poll()
            snap = agg.snapshot()
            if args.json:
                print(json.dumps(snap, default=str))
            else:
                frame = _render_watch(snap)
                if not args.once:
                    sys.stdout.write("\x1b[2J\x1b[H")
                sys.stdout.write(frame)
                sys.stdout.flush()
            if args.once:
                return 0
            time.sleep(max(0.05, args.interval))
    except KeyboardInterrupt:
        return 0


def _cli_alerts(args) -> int:
    """The alert transitions journaled in a flight directory's streams,
    folded to the current state a (rule, job), with acks in the SIDE file
    ``alerts_ack.json`` (journals are append-only and seq-validated)."""
    import glob
    import time

    from .telemetry.recorder import read_flight_events

    transitions = []
    for p in sorted(glob.glob(os.path.join(args.flight_dir, "*.jsonl"))):
        try:
            evs, _off = read_flight_events(p, offset=0)
        except InvalidArgumentError:
            continue
        transitions.extend(e for e in evs if e.get("kind") == "alert")
    transitions.sort(key=lambda e: float(e.get("t", 0.0)))

    ack_path = os.path.join(args.flight_dir, "alerts_ack.json")
    acks = {}
    if os.path.exists(ack_path):
        with open(ack_path, encoding="utf-8") as f:
            acks = json.load(f)
    if args.ack:
        rule, _, job = args.ack.partition(":")
        acks[f"{rule}|{job}"] = {"t": time.time()}
        tmp = ack_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(acks, f, indent=2)
        os.replace(tmp, ack_path)

    # fold to the current state a (rule, job): the LAST transition wins
    current: dict = {}
    for e in transitions:
        current[(e.get("rule"), e.get("job") or "")] = e
    rows = []
    for (rule, job), e in sorted(current.items()):
        rows.append({"rule": rule, "job": job or None,
                     "state": e.get("state"),
                     "severity": e.get("severity"),
                     "value": e.get("value"), "t": e.get("t"),
                     "acked": f"{rule}|{job}" in acks,
                     "transitions": sum(
                         1 for x in transitions
                         if x.get("rule") == rule
                         and (x.get("job") or "") == job)})
    if args.json:
        print(json.dumps({"alerts": rows,
                          "transitions": len(transitions)}, default=str))
        return 0
    if not rows:
        print("no alerts journaled")
        return 0
    print(f"{'RULE':<26} {'JOB':<12} {'STATE':<9} {'SEV':<9} "
          f"{'N':>3} {'ACK':<3}")
    for r in rows:
        print(f"{str(r['rule'])[:26]:<26} "
              f"{str(r['job'] or '-')[:12]:<12} "
              f"{str(r['state'])[:9]:<9} {str(r['severity'])[:9]:<9} "
              f"{r['transitions']:>3} {'yes' if r['acked'] else 'no':<3}")
    return 0


def _cli_flight(args) -> int:
    """``flight du``: per-stream on-disk sizes of a flight directory,
    largest first (the CLI twin of the ``igg_flight_file_bytes`` gauges)."""
    import glob

    rows = []
    total = 0
    for p in sorted(glob.glob(os.path.join(args.flight_dir, "*.jsonl"))):
        try:
            n = os.path.getsize(p)
        except OSError:
            continue  # rotated/removed between glob and stat
        rows.append({"file": os.path.basename(p), "bytes": int(n)})
        total += int(n)
    rows.sort(key=lambda r: (-r["bytes"], r["file"]))
    if args.json:
        print(json.dumps({"dir": args.flight_dir, "files": rows,
                          "total_bytes": total}))
        return 0
    for r in rows:
        print(f"{r['bytes']:>12}  {r['file']}")
    print(f"{total:>12}  total ({len(rows)} streams)")
    return 0


def _cli_autoscale(args) -> int:
    """``autoscale explain``: every journaled decision and each filed
    move's actuation chain, from the scheduler journal alone; ``--job``
    narrows to one tenant."""
    from .service.report import explain_autoscale

    rec = explain_autoscale(args.flight_dir)
    if args.job is not None:
        rec = {"policy": rec["policy"], "job": args.job,
               "moves": [m for m in rec["moves"]
                         if m.get("job") == args.job],
               "decisions": rec["jobs"].get(args.job, [])}
    print(json.dumps(rec, indent=args.indent, default=str))
    return 0


# -- the oracle: calibrate and tune ------------------------------------------

def _cli_calibrate(args) -> int:
    if args.preset is not None:
        # canned profile: host-only, nothing measured
        from .telemetry import save_machine_profile
        from .telemetry.perfmodel import hierarchical_machine_profile

        profile = hierarchical_machine_profile()
        if args.out:
            save_machine_profile(profile, args.out)
        print(json.dumps(profile.to_json(), indent=args.indent))
        return 0
    from .parallel.grid import finalize_global_grid, init_global_grid
    from .parallel.topology import grid_is_initialized
    from .telemetry import calibrate_machine

    owns_grid = not grid_is_initialized()
    if owns_grid:
        device_type = _device_type(args, "calibrate")
        if device_type is None:
            return 2
        dims = _dims(args.nranks)
        init_global_grid(args.nx, args.nx, args.nx, dimx=dims[0],
                         dimy=dims[1], dimz=dims[2], periodx=1,
                         periody=1, periodz=1, device_type=device_type,
                         quiet=True)
    try:
        profile = calibrate_machine(args.out, ensemble=args.ensemble)
    finally:
        if owns_grid:
            finalize_global_grid()
    print(json.dumps(profile.to_json(), indent=args.indent))
    return 0


def _cli_tune(args) -> int:
    """Run the auto-tuner on a grid of ``--nranks`` ranks (produce mode),
    or print a persisted config (``tune show tuned.json``, host-only).
    Pass ``--out`` (or a ``--profile`` path, whose directory becomes the
    default home) to persist the winner where ``jobs submit``'s ``tuned``
    run knob loads it."""
    if args.model == "show":
        from .telemetry import load_tuned_config

        if not args.path:
            raise InvalidArgumentError(
                "tools tune show: name the tuned-config JSON to print.")
        print(json.dumps(load_tuned_config(args.path).to_json(),
                         indent=args.indent))
        return 0
    if args.path:
        raise InvalidArgumentError(
            f"tools tune: unexpected argument {args.path!r} (the "
            "positional path belongs to 'tune show').")

    def _split(spec):
        # ';' separates entries so multi-axis policies like 'z:int8,x:f32'
        # stay whole; a ';'-free spec splits on ','
        parts = spec.split(";") if ";" in spec else spec.split(",")
        return tuple(p.strip() for p in parts if p.strip())

    device_type = _device_type(args, "tune")
    if device_type is None:
        return 2
    from .telemetry import tune_config

    dims = _dims(args.nranks)
    grid = dict(nx=args.nx, ny=args.nx, nz=args.nx,
                dimx=dims[0], dimy=dims[1], dimz=dims[2],
                periodx=1, periody=1, periodz=1, device_type=device_type)
    kw = {}
    if args.comm_every_options:
        kw["comm_every_options"] = _split(args.comm_every_options)
    if args.wire_options:
        kw["wire_dtype_options"] = tuple(
            None if w.lower() in ("off", "none", "") else w
            for w in _split(args.wire_options))
    if args.wire_stage_options:
        kw["wire_stage_options"] = tuple(
            None if w.lower() in ("off", "none", "flat", "") else w
            for w in _split(args.wire_stage_options))
    if args.ensemble_options:
        kw["ensemble_options"] = tuple(
            None if int(e) <= 1 else int(e)
            for e in _split(args.ensemble_options))
    if args.overlap:
        kw["overlap_options"] = (False, True)
    cfg = tune_config(args.model, grid, args.profile,
                      measure=not args.no_measure,
                      top_k=args.top_k, path=args.out, **kw)
    print(json.dumps(cfg.to_json(), indent=args.indent))
    return 0


# -- reshard -----------------------------------------------------------------

def _np_dtype(name: str):
    import numpy as np

    if str(name) == "bfloat16":
        try:
            import ml_dtypes
        except ImportError as e:
            raise InvalidArgumentError(
                "tools reshard: --dtype bfloat16 needs ml_dtypes for its "
                "host oracle.") from e
        return np.dtype(ml_dtypes.bfloat16)
    return np.dtype(name)


def _cli_reshard(args) -> int:
    """``plan`` is host-only: derive the transfer plan for a synthetic
    state and print it with its `predict_reshard` price. ``run`` also
    executes it: a grid on the source dims (its device), the state, the
    on-device re-block (`reshard.reshard_state` with the contract audit
    on), the result held bitwise against the host oracle
    (`apply_plan_host`); exit 1 when an error finding or a single
    differing byte survives."""
    import numpy as np

    from .reshard import apply_plan_host, build_reshard_plan
    from .telemetry import predict_reshard

    def _triple(spec, what):
        out = tuple(int(x) for x in str(spec).split(","))
        if len(out) != 3:
            raise InvalidArgumentError(
                f"tools reshard: {what} must be 3 comma-separated ints; "
                f"got {spec!r}.")
        return out

    src_dims = _triple(args.src_dims, "--src-dims")
    dst_dims = _triple(args.dst_dims, "--dst-dims")
    per = _triple(args.periods, "--periods")
    ol = _triple(args.overlaps, "--overlaps")
    nx = max(int(args.nx), 2 * max(ol))
    lead = () if args.ensemble is None else (int(args.ensemble),)
    topo = {"nxyz": np.array([nx] * 3), "dims": np.array(src_dims),
            "overlaps": np.array(ol), "periods": np.array(per),
            "halowidths": np.maximum(1, np.array(ol) // 2)}
    fields = {}
    for i in range(max(1, int(args.fields))):
        stag = 1 if i == 1 else 0   # field 1 x-staggered: a 2nd signature
        shape = lead + (src_dims[0] * (nx + stag),
                        src_dims[1] * nx, src_dims[2] * nx)
        fields[f"f{i}"] = (shape, str(_np_dtype(args.dtype)), len(lead))
    plan = build_reshard_plan(topo, dst_dims, fields)
    pred = predict_reshard(plan)
    rec = {"plan": plan.to_json(), "predicted": pred}

    if args.reshard_cmd == "plan":
        be_args = (args.nt_remaining, args.old_step_s, args.new_step_s)
        if any(a is not None for a in be_args):
            if any(a is None for a in be_args):
                raise InvalidArgumentError(
                    "tools reshard plan: --nt-remaining, --old-step-s, "
                    "and --new-step-s go together (the amortized "
                    "break-even needs all three).")
            # the one shared break-even arithmetic (telemetry.
            # ReshardPrediction): what the autoscaler prices and
            # service_report carries
            rec["break_even"] = pred.amortized_break_even_steps(
                args.nt_remaining, args.old_step_s, args.new_step_s)
        print(json.dumps(rec, indent=args.indent, default=str))
        return 0

    # -- run: execute + audit + verify -------------------------------------
    from .models.common import ensemble_state
    from .ops.alloc import device_put_g
    from .ops.gather import _numpy
    from .parallel.grid import finalize_global_grid, init_global_grid
    from .parallel.topology import grid_is_initialized
    from .reshard import fields_of_state, reshard_state

    if plan.n_flat > args.nranks:
        raise InvalidArgumentError(
            f"tools reshard run: the transfer mesh needs {plan.n_flat} "
            f"rank(s), {args.nranks} available (--nranks).")
    if grid_is_initialized():
        raise InvalidArgumentError(
            "tools reshard run re-initializes the global grid; run it "
            "in a fresh process.")
    device_type = _device_type(args, "reshard run")
    if device_type is None:
        return 2
    init_global_grid(nx, nx, nx, dimx=src_dims[0], dimy=src_dims[1],
                     dimz=src_dims[2], periodx=per[0], periody=per[1],
                     periodz=per[2], overlaps=ol, device_type=device_type,
                     quiet=True)
    try:
        rng = np.random.default_rng(14)
        state = {}
        for name, (shape, dtype, nlead) in fields.items():
            host = rng.normal(size=shape[nlead:]).astype(dtype)
            arr = device_put_g(host)
            if nlead:
                arr = ensemble_state(arr, shape[0], perturb=0.01)
            state[name] = arr
        host_state = {k: _numpy(v) for k, v in state.items()}
        plan = build_reshard_plan(topo, dst_dims, fields_of_state(state))
        expect = apply_plan_host(plan, host_state)
        new_state, info = reshard_state(state, dst_dims, audit=True)
        report = info.pop("audit_report")
        mismatch = [k for k in state
                    if not np.array_equal(
                        _numpy(new_state[k]).view(np.uint8),
                        np.ascontiguousarray(expect[k]).view(np.uint8))]
        ok = bool(report is not None and report.ok and not mismatch)
        rec.update(
            audit=None if report is None else report.to_json(),
            audit_error=info.get("audit_error"),
            verified=not mismatch, mismatched_fields=mismatch, ok=ok)
    finally:
        if grid_is_initialized():
            finalize_global_grid()
    if args.json:
        print(json.dumps(rec, indent=args.indent, default=str))
    else:
        a = rec["audit"]
        print(f"reshard {src_dims} -> {dst_dims}: "
              f"{'OK' if ok else 'FAIL'} rounds={plan.rounds} "
              f"wire_bytes={plan.wire_bytes} "
              f"audit={'ok' if a and a['ok'] else 'FAIL'} "
              f"verify={'bit-identical' if not mismatch else mismatch}")
        if a:
            for f in a["findings"]:
                print(f"  [{f['severity']}] {f['rule']}: {f['message']}")
    return 0 if ok else 1


# -- the service -------------------------------------------------------------

def _cli_jobs(args) -> int:
    """The scheduler's operator surface.

    - ``submit QUEUE.json``: one `service.MeshScheduler` (rank pool
      ``--nranks``) runs every described job (builtin models by name, a
      grid a job; ``--cpu`` puts each grid on the CPU, and a grid that
      leaves dims at 0 takes ``--nranks``); exit 0 only when EVERY job
      finished (``done``), else 1.
    - ``list DIR`` / ``status DIR NAME``: post-hoc, from the journal alone.
    - ``cancel DIR NAME`` / ``drain DIR`` / ``resize DIR NAME dx,dy,dz``:
      control files under ``DIR/control/`` that a LIVE scheduler (either
      package's) consumes at its next slice boundary.
    """
    from .service.report import read_journal, service_report

    if args.jobs_cmd == "submit":
        device_type = _device_type(args, "jobs submit")
        if device_type is None:
            return 2
        from .service import JobState, MeshScheduler, jobspec_from_json

        with open(args.spec, encoding="utf-8") as f:
            queue = json.load(f)
        if not isinstance(queue, dict) or not queue.get("jobs"):
            raise InvalidArgumentError(
                f"{args.spec}: expected {{'jobs': [...]}} with at least "
                "one job.")
        policy = args.policy or queue.get("policy", "fifo")
        sched = MeshScheduler(policy=policy, flight_dir=args.flight_dir,
                              metrics_port=args.metrics_port,
                              nranks=args.nranks)
        try:
            for i, rec in enumerate(queue["jobs"]):
                if isinstance(rec, dict):
                    # the rank count of dims left at 0 and the device: the
                    # JAX package's device count and platform (a record's
                    # own keys win)
                    rec = dict(rec, grid={"nranks": args.nranks,
                                          "device_type": device_type,
                                          **(rec.get("grid") or {})})
                # one schema, one code path with POST /v1/jobs
                # (service.jobspec_from_json): the CLI and the HTTP API
                # cannot diverge
                sched.submit(jobspec_from_json(
                    rec, where=f"{args.spec}: job #{i}"))
            sched.run()
            status = sched.status()
        finally:
            sched.close()
        ok = all(j["state"] == JobState.DONE for j in status["jobs"])
        if args.json:
            print(json.dumps({"ok": ok, **status}, default=str))
        else:
            for j in status["jobs"]:
                err = f"  ({j['error']})" if j.get("error") else ""
                print(f"{j['name']}: {j['state']} step {j['step']}/"
                      f"{j['nt']} in {j['slices']} slice(s){err}")
        return 0 if ok else 1

    if args.jobs_cmd == "list":
        rep = service_report(args.flight_dir, include_jobs=False)
        if args.json:
            print(json.dumps(rep, default=str))
        else:
            for name, j in rep["jobs"].items():
                print(f"{name:<20} {j['state']:<10} "
                      f"step {j.get('step') or 0:>8}  "
                      f"slices {j['slices']:>5}  "
                      f"mesh {j['slice_s_total']:.3f}s "
                      f"({100 * j['mesh_share']:.0f}%)")
        return 0
    if args.jobs_cmd == "status":
        rep = service_report(args.flight_dir)
        job = rep["jobs"].get(args.name)
        if job is None:
            print(json.dumps({"error": f"no job named {args.name!r}",
                              "have": list(rep["jobs"])}))
            return 3
        print(json.dumps(job, indent=args.indent, default=str))
        return 0

    # control-channel commands: validated against the journal, consumed by
    # the live scheduler at its next slice boundary
    ctl = os.path.join(args.flight_dir, "control")
    if args.jobs_cmd in ("cancel", "resize"):
        jobs = service_report(args.flight_dir,
                              include_jobs=False)["jobs"]
        job = jobs.get(args.name)
        if job is None:
            print(json.dumps({"error": f"no job named {args.name!r}",
                              "have": list(jobs)}))
            return 3
        if job["state"] not in ("queued", "running"):
            print(json.dumps({"error": f"job {args.name!r} already "
                                       f"{job['state']}"}))
            return 4
    if args.jobs_cmd == "cancel":
        os.makedirs(ctl, exist_ok=True)
        path = os.path.join(ctl, f"cancel_{args.name}")
        with open(path, "w", encoding="utf-8"):
            pass
        print(json.dumps({"requested": "cancel", "job": args.name,
                          "control": path}))
        return 0
    if args.jobs_cmd == "resize":
        try:
            dims = [int(x) for x in str(args.dims).split(",")]
        except ValueError:
            dims = []
        if len(dims) != 3 or any(d < 1 for d in dims):
            raise InvalidArgumentError(
                f"tools jobs resize: dims must be 3 positive "
                f"comma-separated ints; got {args.dims!r}.")
        os.makedirs(ctl, exist_ok=True)
        path = os.path.join(ctl, f"resize_{args.name}")
        # atomic: the scheduler polls this directory at slice boundaries
        # and must never read (and consume) a half-written request
        with open(path + ".tmp", "w", encoding="utf-8") as f:
            json.dump({"new_dims": dims, "via": args.via}, f)
        os.replace(path + ".tmp", path)
        print(json.dumps({"requested": "resize", "job": args.name,
                          "new_dims": dims, "via": args.via,
                          "control": path}))
        return 0
    # drain
    read_journal(args.flight_dir)  # validates the directory
    os.makedirs(ctl, exist_ok=True)
    path = os.path.join(ctl, "drain")
    with open(path, "w", encoding="utf-8"):
        pass
    print(json.dumps({"requested": "drain", "control": path}))
    return 0


# -- the audit ---------------------------------------------------------------

_IMPLS = {"xla": "plain", "plain": "plain", "pallas": "cuda", "cuda": "cuda"}


def _cli_audit(args) -> int:
    """Record-and-audit model steps, or parse a captured dump host-only.
    Exit 1 when an error-severity finding survives (warnings never
    gate)."""
    if args.hlo is None and not args.models:
        raise InvalidArgumentError(
            "tools audit: name at least one model (diffusion3d, "
            "diffusion2d, acoustic3d, stokes3d) or pass --hlo FILE.")
    if args.hlo is not None and args.models:
        raise InvalidArgumentError(
            "tools audit: --hlo and model names are mutually exclusive "
            "(a dump is audited host-only, models are recorded here).")

    reports = []  # (name, AuditReport)
    if args.hlo is not None:
        from .analysis import (
            CollectiveContract, audit_program, default_lint_config,
        )

        contract = None
        if args.contract is not None:
            with open(args.contract, encoding="utf-8") as f:
                contract = CollectiveContract.from_json(f.read())
        with open(args.hlo, encoding="utf-8") as f:
            text = f.read()
        # --wire-dtype applies to a captured dump too: its absence from
        # the parsed permute payloads is the wire-downcast-missing lint
        # (the recording knobs --impl/--no-crosscheck mean nothing for a
        # captured text and are ignored here, as in the JAX package)
        cfg = default_lint_config(wire_dtype=args.wire_dtype) \
            if args.wire_dtype else None
        reports.append((args.hlo, audit_program(
            text, contract=contract, lint_config=cfg,
            meta={"source": args.hlo})))
    else:
        if args.lowered:
            raise InvalidArgumentError(
                "tools audit --lowered: the port compiles no program (it "
                "records what its routes move), so there is no pre-backend "
                "form to audit.")
        impl = _IMPLS.get(str(args.impl))
        if impl is None:
            raise InvalidArgumentError(
                f"tools audit --impl {args.impl!r}: the port's routes are "
                "xla (= plain) and pallas (= cuda, the kernel routes); "
                + ("a CUDA kernel has no interpret mode (on a CPU grid the "
                   "kernel routes run their plain versions: pass --impl "
                   "pallas)." if args.impl == "pallas_interpret" else
                   "no other route exists."))
        from .analysis import audit_model
        from .parallel.grid import finalize_global_grid, init_global_grid
        from .parallel.topology import grid_is_initialized

        owns_grid = not grid_is_initialized()
        if owns_grid:
            device_type = _device_type(args, "audit")
            if device_type is None:
                return 2
            dims = _dims(args.nranks)
            gkw = {}
            if args.comm_every is not None:
                # the cadence's halo geometry: per axis, hw = depth*k_d
                # (depth 2 where a Stokes step is audited) and the block
                # sized to carry it
                from .ops.wire import resolve_comm_every
                from .telemetry.perfmodel import STEP_WORKLOADS

                cad = resolve_comm_every(args.comm_every)
                depth = max((STEP_WORKLOADS[m].deep_halo_depth
                             for m in args.models
                             if m in STEP_WORKLOADS), default=1)
                hw = tuple(depth * cad.for_dim(d) for d in range(3))
                ol = tuple(2 * h for h in hw)
                gkw = {"overlaps": ol, "halowidths": hw}
                nx = [max(args.nx, 2 * o) for o in ol]
            else:
                nx = [args.nx] * 3
            init_global_grid(nx[0], nx[1], nx[2], dimx=dims[0],
                             dimy=dims[1], dimz=dims[2], periodx=1,
                             periody=1, periodz=1, device_type=device_type,
                             quiet=True, **gkw)
        try:
            for model in args.models:
                reports.append((model, audit_model(
                    model, impl=impl, wire_dtype=args.wire_dtype,
                    wire_stage=args.wire_stage,
                    crosscheck=not args.no_crosscheck,
                    ensemble=args.ensemble,
                    comm_every=args.comm_every)))
        finally:
            if owns_grid:
                finalize_global_grid()

    ok = all(rep.ok for _, rep in reports)
    if args.json:
        print(json.dumps(
            {"ok": ok,
             "programs": [dict(rep.to_json(), name=name)
                          for name, rep in reports]},
            indent=args.indent, default=str))
    else:
        for name, rep in reports:
            cc = rep.crosscheck
            cc_txt = "" if cc is None else \
                f"  crosscheck={'ok' if cc['ok'] else 'DRIFT'}"
            print(f"{name}: {'OK' if rep.ok else 'FAIL'} "
                  f"[{rep.dialect}] errors={rep.errors} "
                  f"warnings={rep.warnings} "
                  f"collectives={rep.collectives['permutes']}p/"
                  f"{rep.collectives['all_reduces']}ar/"
                  f"{rep.collectives['all_gathers']}ag{cc_txt}")
            for f in rep.findings:
                anchor = f" @{f.computation}:{f.op}" if f.op else ""
                print(f"  [{f.severity}] {f.rule}{anchor}: {f.message}")
    return 0 if ok else 1
