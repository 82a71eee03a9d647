"""The port's mesh view and live endpoint on the CPU, held against the JAX
package's (`tests/test_mesh_observability.py`, and the server cases of
`tests/test_perfmodel.py`):

- cross-process flight aggregation (clock offsets recovered at the chunk
  barriers, run-id and sequence validation), the straggler and imbalance
  analysis, the Chrome/Perfetto export and the ``mesh`` section of
  `run_report`, on synthetic per-process streams with exact skews (JAX's
  cases on the port);
- both packages' `aggregate_flight`, `straggler_report`, `mesh_section`,
  `run_report` and `export_chrome_trace` give equal records on the same
  streams: the synthetic ones, and two streams derived from a real port
  run (the second one's ``proc``/``pid`` bumped, a constant added to every
  ``t``, its ``recorder_open`` wall shifted, its chunks' ``exec_s``
  shortened by a delay: a late dispatcher), read from either package's
  JSONL;
- the metrics server: ``/metrics`` equals `prometheus_snapshot()`,
  ``/healthz`` answers 503 on a stale heartbeat, starts attach and are
  refcounted, and `run_resilient(metrics_port=0)` is scraped mid-run.

Left for later: the CLI case (the tools).
"""

import json
import math
import os
import urllib.error
import urllib.request

import pytest
import torch

import implicitglobalgrid_tpu as igg
import implicitglobalgrid_tpu_torch as tg
from implicitglobalgrid_tpu_torch import telemetry
from implicitglobalgrid_tpu_torch.utils.exceptions import InvalidArgumentError

from torch_port_util import clean_torch_grid  # noqa: F401

pytestmark = [pytest.mark.mesh, pytest.mark.telemetry]


@pytest.fixture(autouse=True)
def _clean_telemetry():
    for pkg in (tg, igg):
        pkg.stop_flight_recorder()
        while pkg.metrics_server() is not None:
            pkg.stop_metrics_server()
        pkg.reset_metrics()
    yield
    for pkg in (tg, igg):
        pkg.stop_flight_recorder()
        while pkg.metrics_server() is not None:
            pkg.stop_metrics_server()
        pkg.reset_metrics()


# ---------------------------------------------------------------------------
# Synthetic per-process streams with exact ground truth (JAX's helper)
# ---------------------------------------------------------------------------

def _write_stream(dirpath, proc, *, clock0, wall0, n_chunks=6, start_delay=0.0,
                  compute=0.1, worst_delay=0.05, run_id="r1", drop_last_chunk=False,
                  extra=()):
    """One process's flight JSONL with a barrier-consistent chunk schedule:
    every chunk's barrier release is common to all processes; this process
    dispatches ``start_delay`` after the boundary, so its ``exec_s`` is the
    release minus its own start. ``clock0`` is its monotonic origin,
    ``wall0`` its wall clock at recorder open."""
    path = os.path.join(dirpath, f"flight_p{proc}.jsonl")
    seq = 0
    recs = []

    def ev(kind, t, **kw):
        nonlocal seq
        recs.append({"t": t, "kind": kind, "run": run_id, "pid": 10 + proc,
                     "proc": proc, "seq": seq, **kw})
        seq += 1

    t = clock0
    ev("recorder_open", t, wall=wall0, version=1)
    ev("run_begin", t, nt=n_chunks * 10, nt_chunk=10, names=["T"], checkpoint_every=10)
    for c in range(n_chunks):
        start = t + start_delay
        t = t + worst_delay + compute
        if drop_last_chunk and c == n_chunks - 1:
            continue
        ev("chunk", t, chunk=c, step_begin=c * 10, step_end=(c + 1) * 10,
           n=10, ok=True, reasons=[], build_s=0.004, exec_s=t - start)
    for kind, kw in extra:
        ev(kind, t, **kw)
    ev("run_end", t, completed=n_chunks * 10, chunks=n_chunks)
    ev("recorder_close", t)
    with open(path, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
    return path


def _two_proc_dir(tmp_path, **kw):
    d = str(tmp_path / "flights")
    os.makedirs(d, exist_ok=True)
    _write_stream(d, 0, clock0=1000.0, wall0=5000.0, **kw)
    _write_stream(d, 1, clock0=987654.0, wall0=5000.25, start_delay=0.05, **kw)
    return d


EXTRA = [("guard_trip", {"step_end": 60, "reasons": ["nonfinite:T"], "retries": 1}),
         ("checkpoint_save", {"op": "save_sharded", "step": 60, "dur_s": 0.02, "path": "x"}),
         ("snapshot_write", {"step": 60, "dur_s": 0.01, "nbytes": 4096, "queue_depth": 1,
                             "path": "y"}),
         ("halo_exchange", {"fields": 1, "ppermutes": 6, "wire_bytes": 1234,
                            "local_copy_bytes": 0}),
         ("perf_regression", {"chunk": 5, "z": 9.0, "per_step_s": 0.1}),
         ("tuned", {"model": "diffusion3d", "comm_every": "1", "speedup": 1.2})]


def _same_views(d, **kw):
    """Both packages' aggregate, straggler report, mesh section, report
    (without the live registry) and Chrome trace of ``d`` are equal."""
    aj, at = igg.aggregate_flight(d, **kw), tg.aggregate_flight(d, **kw)
    assert at == aj
    if len(at["processes"]) > 1 and all(at["per_process"][p]["chunks"]
                                        for p in at["processes"][:2]):
        assert tg.straggler_report(at, window=4) == igg.straggler_report(aj, window=4)
        assert telemetry.mesh_section(at) == igg.telemetry.mesh_section(aj)
    rt = tg.run_report(d, include_metrics=False, **kw)
    rj = igg.run_report(d, include_metrics=False, **kw)
    assert rt == rj
    assert tg.export_chrome_trace(at) == igg.export_chrome_trace(aj)
    return at, rt


# ---------------------------------------------------------------------------
# aggregate_flight
# ---------------------------------------------------------------------------

def test_aggregate_recovers_offsets_and_merges(tmp_path):
    d = _two_proc_dir(tmp_path)
    agg = tg.aggregate_flight(d)
    assert agg["run_id"] == "r1"
    assert agg["processes"] == [0, 1] and agg["anchor_proc"] == 0
    assert agg["align"]["method"] == {0: "anchor", 1: "chunk-barrier"}
    assert agg["offsets"][0] == 0.0 and abs(agg["offsets"][1] - 0.25) < 1e-6
    assert agg["align"]["residual_s"][1] < 1e-9
    assert agg["align"]["chunks_used"][1] == 6
    evs = agg["events"]
    ts = [e["t"] for e in evs if "t" in e]
    assert ts == sorted(ts)
    for c in range(6):
        pair = [e for e in evs if e.get("kind") == "chunk" and e.get("chunk") == c]
        assert len(pair) == 2 and abs(pair[0]["t"] - pair[1]["t"]) < 1e-6
    assert all("t_mono" in e and "t_offset" in e for e in evs)
    assert agg["per_process"][0]["chunks"] == agg["per_process"][1]["chunks"] == 6
    _same_views(d)


def test_aggregate_accepts_explicit_paths_and_single_file(tmp_path):
    d = _two_proc_dir(tmp_path)
    paths = sorted(os.path.join(d, f) for f in os.listdir(d))
    assert tg.aggregate_flight(paths)["processes"] == [0, 1]
    one = tg.aggregate_flight(paths[0])
    assert one["processes"] == [0] and one["offsets"] == {0: 0.0}
    assert one == igg.aggregate_flight(paths[0])


def test_aggregate_validation_errors(tmp_path):
    d = str(tmp_path / "bad")
    os.makedirs(d)
    with pytest.raises(InvalidArgumentError, match="no .*jsonl"):
        tg.aggregate_flight(d)
    _write_stream(d, 0, clock0=0.0, wall0=100.0)
    _write_stream(d, 1, clock0=0.0, wall0=100.0, run_id="OTHER")
    with pytest.raises(InvalidArgumentError, match="run ids"):
        tg.aggregate_flight(d)
    assert tg.aggregate_flight(d, run_id="OTHER")["processes"] == [1]
    with pytest.raises(InvalidArgumentError, match="no events"):
        tg.aggregate_flight(d, run_id="nope")
    gap = str(tmp_path / "gap")
    os.makedirs(gap)
    p = _write_stream(gap, 0, clock0=0.0, wall0=100.0)
    lines = open(p).read().splitlines()
    open(p, "w").write("\n".join(lines[:3] + lines[4:]) + "\n")
    with pytest.raises(InvalidArgumentError, match="gaps"):
        tg.aggregate_flight(gap)
    dup = str(tmp_path / "dup")
    os.makedirs(dup)
    p = _write_stream(dup, 0, clock0=0.0, wall0=100.0)
    first = open(p).read().splitlines()
    open(p, "a").write(first[1] + "\n")
    with pytest.raises(InvalidArgumentError, match="duplicate"):
        tg.aggregate_flight(dup)
    head = str(tmp_path / "head")
    os.makedirs(head)
    p = _write_stream(head, 0, clock0=0.0, wall0=100.0)
    lines = open(p).read().splitlines()
    open(p, "w").write("\n".join(lines[3:]) + "\n")
    with pytest.raises(InvalidArgumentError, match="start at 0"):
        tg.aggregate_flight(head)


def test_aggregate_events_resumes_incrementally(tmp_path):
    """The incremental form: a first batch, then the rest with ``resume``,
    aligns as one full read does (the JAX package's record too)."""
    d = _two_proc_dir(tmp_path)
    events = []
    for f in sorted(os.listdir(d)):
        events.extend(tg.read_flight_events(os.path.join(d, f)))
    first = [e for e in events if e["seq"] < 5]
    rest = [e for e in events if e["seq"] >= 5]
    a1 = tg.aggregate_events(first)
    a2 = tg.aggregate_events(rest, resume=a1["resume"])
    full = tg.aggregate_events(events)
    assert a2["offsets"] == pytest.approx(full["offsets"])
    assert [e["t"] for e in a1["events"] + a2["events"]] == pytest.approx(
        sorted(e["t"] for e in full["events"]))
    j1 = igg.aggregate_events(first)
    assert igg.aggregate_events(rest, resume=j1["resume"]) == a2
    assert tg.aggregate_events([], resume=a2["resume"])["events"] == []


def test_run_report_aligns_preloaded_multiprocess_events(tmp_path):
    d = _two_proc_dir(tmp_path)
    events = []
    for f in sorted(os.listdir(d)):
        events.extend(tg.read_flight_events(os.path.join(d, f)))
    rep = tg.run_report(events, include_metrics=False)
    assert rep["mesh"]["summary"]["worst_proc"] == 1
    assert abs(rep["mesh"]["offsets"][1] - 0.25) < 1e-6
    assert rep["chunks"]["count"] == 6
    assert rep == igg.run_report(events, include_metrics=False)
    assert abs(tg.aggregate_events(events)["offsets"][1] - 0.25) < 1e-6


# ---------------------------------------------------------------------------
# straggler_report
# ---------------------------------------------------------------------------

def test_straggler_attribution_and_imbalance(tmp_path):
    d = _two_proc_dir(tmp_path)
    rep = tg.straggler_report(tg.aggregate_flight(d), window=4)
    assert rep["processes"] == [0, 1]
    assert rep["slowest_counts"] == {0: 0, 1: 6}
    assert rep["summary"]["worst_proc"] == 1
    assert abs(rep["summary"]["spread_s_mean"] - 0.05) < 1e-6
    for ch in rep["chunks"]:
        assert ch["slowest"] == 1 and abs(ch["spread_s"] - 0.05) < 1e-6
        assert abs(ch["arrival_s"][1] - 0.05) < 1e-6 and ch["arrival_s"][0] == 0.0
        assert abs(ch["compute_s"] - 0.1) < 1e-6
    imb = rep["imbalance"]
    assert imb[1]["wait_s_total"] < 1e-9
    assert abs(imb[0]["wait_s_total"] - 6 * 0.05) < 1e-6
    assert 0.3 < imb[0]["wait_frac"] < 0.4
    assert rep["persistent"] == [{"proc": 1, "first_chunk": 0, "last_chunk": 5,
                                  "chunks": 6, "share": 1.0}]
    assert rep["perf_regressions"] is None


def test_straggler_needs_two_processes_and_common_chunks(tmp_path):
    d = str(tmp_path / "one")
    os.makedirs(d)
    _write_stream(d, 0, clock0=0.0, wall0=100.0)
    with pytest.raises(InvalidArgumentError, match="two"):
        tg.straggler_report(tg.aggregate_flight(d))
    d2 = str(tmp_path / "partial")
    os.makedirs(d2)
    _write_stream(d2, 0, clock0=0.0, wall0=100.0)
    _write_stream(d2, 1, clock0=0.0, wall0=100.0, start_delay=0.05, drop_last_chunk=True)
    rep = tg.straggler_report(tg.aggregate_flight(d2))
    assert rep["summary"]["chunks"] == 5 and rep["slowest_counts"] == {0: 0, 1: 5}
    d3 = str(tmp_path / "nocommon")
    os.makedirs(d3)
    _write_stream(d3, 0, clock0=0.0, wall0=100.0)
    _write_stream(d3, 1, clock0=50.0, wall0=100.0, start_delay=0.05)
    _write_stream(d3, 2, clock0=0.0, wall0=100.0, drop_last_chunk=True, n_chunks=1)
    agg3 = tg.aggregate_flight(d3)
    assert agg3["align"]["method"] == {0: "anchor", 1: "chunk-barrier", 2: "wall-anchor"}
    assert agg3["align"]["residual_s"][2] is None
    assert agg3["align"]["residual_s"][1] is not None
    assert agg3 == igg.aggregate_flight(d3)


def test_straggler_single_process_stream_explicit(tmp_path):
    d = str(tmp_path / "solo")
    os.makedirs(d)
    _write_stream(d, 0, clock0=10.0, wall0=100.0)
    agg = tg.aggregate_flight(d)
    with pytest.raises(InvalidArgumentError, match="at least two"):
        tg.straggler_report(agg)
    assert telemetry.mesh_section(agg["events"]) is None
    rep = tg.run_report(d)
    assert "mesh" not in rep and rep["chunks"]["count"] == 6


def test_straggler_process_missing_middle_chunk_events(tmp_path):
    d = str(tmp_path / "hole")
    os.makedirs(d)
    _write_stream(d, 0, clock0=0.0, wall0=100.0)
    path = _write_stream(d, 1, clock0=0.0, wall0=100.0, start_delay=0.05)
    recs = [json.loads(ln) for ln in open(path)]
    recs = [r for r in recs if not (r["kind"] == "chunk" and r.get("chunk") == 3)]
    for seq, r in enumerate(recs):
        r["seq"] = seq
    with open(path, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
    rep = tg.straggler_report(tg.aggregate_flight(d))
    assert rep["summary"]["chunks"] == 5
    assert [c["chunk"] for c in rep["chunks"]] == [0, 1, 2, 4, 5]
    assert rep["slowest_counts"] == {0: 0, 1: 5}


def test_zero_chunk_crashed_at_start_stream(tmp_path):
    d = str(tmp_path / "crash")
    os.makedirs(d)
    _write_stream(d, 0, clock0=0.0, wall0=100.0)
    _write_stream(d, 1, clock0=0.0, wall0=100.0, start_delay=0.05)
    _write_stream(d, 2, clock0=500.0, wall0=100.1, n_chunks=0)
    agg = tg.aggregate_flight(d)
    assert agg["processes"] == [0, 1, 2]
    assert agg["per_process"][2]["chunks"] == 0
    assert agg["align"]["method"][2] == "wall-anchor"
    rep = tg.straggler_report(agg)
    assert rep["processes"] == [0, 1] and rep["summary"]["chunks"] == 6
    assert 2 not in rep["imbalance"]
    assert sorted(tg.export_chrome_trace(agg)["otherData"]["processes"]) == [0, 1, 2]
    _same_views(d)


def _synthetic_two_proc(perf_procs=(1,), n_chunks=10, reg_chunk=7):
    """`tests/test_perfmodel.py`'s two clock-aligned streams with one
    ``perf_regression`` chunk flagged by ``perf_procs``."""
    events = []
    for proc in (0, 1):
        seq = 0

        def ev(kind, t, **kw):
            nonlocal seq
            e = {"kind": kind, "t": t, "run": "r1", "proc": proc, "seq": seq, **kw}
            seq += 1
            return e

        events.append(ev("recorder_open", 0.0, wall=1000.0))
        for c in range(n_chunks):
            t = 1.0 + c
            events.append(ev("chunk", t, chunk=c, step_begin=c * 5, step_end=c * 5 + 5,
                             n=5, ok=True, exec_s=0.5, build_s=0.001))
            if c == reg_chunk and proc in perf_procs:
                events.append(ev("perf_regression", t, chunk=c, step_begin=c * 5,
                                 step_end=c * 5 + 5, per_step_s=0.5, baseline_s=0.1,
                                 z=9.0, ratio=None))
    return events


@pytest.mark.parametrize("perf_procs,mesh_wide,localized",
                         [((1,), 0, 1), ((0, 1), 1, 0), ((), None, None)])
def test_straggler_report_classifies_perf_regressions(perf_procs, mesh_wide, localized):
    evs = _synthetic_two_proc(perf_procs=perf_procs)
    rep = tg.straggler_report(tg.aggregate_events(evs)["events"])
    assert rep == igg.straggler_report(igg.aggregate_events(evs)["events"])
    pr = rep["perf_regressions"]
    if mesh_wide is None:
        assert pr is None
        return
    assert pr["mesh_wide"] == mesh_wide and pr["localized"] == localized
    assert pr["per_process"] == {p: 1 for p in perf_procs}
    assert pr["chunks"][0]["scope"] == ("mesh-wide" if mesh_wide else "process")
    assert rep["summary"]["chunks"] == 10


# ---------------------------------------------------------------------------
# export_chrome_trace
# ---------------------------------------------------------------------------

def test_chrome_trace_structure_and_barrier_alignment(tmp_path):
    d = _two_proc_dir(tmp_path, extra=EXTRA)
    out = str(tmp_path / "trace.json")
    assert tg.export_chrome_trace(d, out) == out
    doc = json.load(open(out))
    evs = doc["traceEvents"]
    assert doc["otherData"]["run_id"] == "r1" and doc["otherData"]["processes"] == [0, 1]
    names = {(e["pid"], e["args"]["name"]) for e in evs
             if e.get("ph") == "M" and e["name"] == "process_name"}
    assert names == {(0, "igg process 0"), (1, "igg process 1")}
    for c in range(6):
        spans = [e for e in evs if e.get("ph") == "X" and e["name"] == f"chunk {c}"]
        assert len(spans) == 2 and {s["pid"] for s in spans} == {0, 1}
        ends = [s["ts"] + s["dur"] for s in spans]
        assert abs(ends[0] - ends[1]) < 5
        assert all(s["ts"] >= 0 and s["dur"] > 0 for s in spans)
    assert any(e.get("ph") == "X" and e["name"] == "exec" for e in evs)
    ck = next(e for e in evs if e.get("ph") == "X" and e["name"] == "save_sharded")
    assert ck["cat"] == "checkpoint" and ck["dur"] == pytest.approx(2e4)
    snap = next(e for e in evs if e.get("ph") == "X" and e["cat"] == "io")
    assert snap["tid"] != ck["tid"]
    assert any(e.get("ph") == "i" and e["name"] == "guard_trip" for e in evs)
    assert any(e.get("ph") == "i" and e["name"] == "perf_regression" for e in evs)
    depth = [e for e in evs if e.get("ph") == "C" and e["name"] == "igg_io_queue_depth"]
    assert depth and depth[0]["args"]["depth"] == 1
    wire = [e for e in evs if e.get("ph") == "C" and e["name"] == "igg_halo_wire_bytes_total"]
    assert wire and wire[-1]["args"]["bytes"] == 1234
    assert len(tg.export_chrome_trace(tg.aggregate_flight(d))["traceEvents"]) == len(evs)
    assert doc == json.loads(json.dumps(igg.export_chrome_trace(d)))  # the file's JSON keys
    _same_views(d)
    with pytest.raises(InvalidArgumentError, match="trace_id"):
        tg.export_chrome_trace(d, trace_id="nope")
    with pytest.raises(InvalidArgumentError, match="aggregate_flight result"):
        tg.export_chrome_trace({"x": 1})


def test_chrome_trace_aligns_single_file_and_event_list(tmp_path):
    d = _two_proc_dir(tmp_path)
    cat = str(tmp_path / "all.jsonl")
    with open(cat, "w") as out:
        for f in sorted(os.listdir(d)):
            out.write(open(os.path.join(d, f)).read())
    for source in (cat, tg.read_flight_events(cat)):
        doc = tg.export_chrome_trace(source)
        assert doc["otherData"]["align"]["method"][1] == "chunk-barrier"
        for c in range(6):
            ends = [e["ts"] + e["dur"] for e in doc["traceEvents"]
                    if e.get("ph") == "X" and e["name"] == f"chunk {c}"]
            assert len(ends) == 2 and abs(ends[0] - ends[1]) < 5
        assert doc == igg.export_chrome_trace(source)


# ---------------------------------------------------------------------------
# run_report: the "mesh" section
# ---------------------------------------------------------------------------

def test_run_report_mesh_section_from_directory(tmp_path):
    d = _two_proc_dir(tmp_path, extra=EXTRA)
    rep = tg.run_report(d, include_metrics=False)
    assert rep["run_id"] == "r1"
    mesh = rep["mesh"]
    assert mesh["processes"] == [0, 1] and mesh["summary"]["worst_proc"] == 1
    assert abs(mesh["offsets"][1] - 0.25) < 1e-6
    assert mesh["persistent_stragglers"][0]["proc"] == 1
    assert rep["chunks"]["count"] == 6
    kinds = [e["kind"] for e in rep["sequence"]]
    assert kinds.count("run_begin") == 1 and kinds.count("run_end") == 1
    assert rep["halo"] == {"exchanges": 1, "ppermutes": 6, "wire_bytes": 1234}
    assert "mesh" not in tg.run_report(os.path.join(d, "flight_p0.jsonl"),
                                       include_metrics=False)
    assert rep == igg.run_report(d, include_metrics=False)
    (tmp_path / "flights" / "scheduler.jsonl").write_text("")
    svc = tg.run_report(d)   # a scheduler journal: the service record, as JAX's
    assert "mesh" not in svc and svc == igg.run_report(d)


# ---------------------------------------------------------------------------
# Streams derived from a real port run, read by both packages
# ---------------------------------------------------------------------------

def _derived_dir(tmp_path, skew=123.0, wall_shift=0.4, delay=0.002):
    """flight_p0.jsonl of a real supervised run of the port (2x2x1 mesh of
    6^3 blocks, 12 steps in chunks of 3) and flight_p1.jsonl derived from
    it: ``proc``/``pid`` bumped, ``skew`` added to every ``t`` (another
    monotonic clock), the ``recorder_open`` wall moved by ``wall_shift``
    (another wall clock) and every chunk's ``exec_s`` shortened by
    ``delay`` (it dispatched later, then left the same barrier)."""
    from implicitglobalgrid_tpu_torch.models import diffusion_step_local, init_diffusion3d

    d = tmp_path / "derived"
    d.mkdir()
    tg.init_global_grid(6, 6, 6, dimx=2, dimy=2, dimz=1, quiet=True, device_type="cpu")
    T, Cp, p = init_diffusion3d(dtype=torch.float64)

    def step(s):
        return {"T": diffusion_step_local(s["T"], s["Cp"], p, "plain"), "Cp": s["Cp"]}

    tg.start_flight_recorder(str(d), run_id="derived")
    tg.run_resilient(step, {"T": T, "Cp": Cp}, 12, nt_chunk=3)
    tg.update_halo(T)
    path = tg.stop_flight_recorder()
    assert os.path.basename(path) == "flight_p0.jsonl"
    out = []
    for e in tg.read_flight_events(path):
        e = dict(e, proc=1, pid=e["pid"] + 1, t=e["t"] + skew)
        if e["kind"] == "recorder_open":
            e["wall"] += wall_shift
        if e["kind"] == "chunk":
            e["exec_s"] -= delay
        out.append(e)
    with open(d / "flight_p1.jsonl", "w") as f:
        for e in out:
            f.write(json.dumps(e) + "\n")
    return str(d)


def test_derived_streams_align_equal_in_both_packages(tmp_path):
    d = _derived_dir(tmp_path)
    agg, rep = _same_views(d)
    assert agg["processes"] == [0, 1] and agg["align"]["method"][1] == "chunk-barrier"
    # the second stream's wall clock is 0.4 s ahead: the barrier fit finds it
    # (to the float64 rounding of stamps ~1e9 s)
    assert agg["offsets"][1] == pytest.approx(0.4, abs=1e-6)
    assert all(math.isfinite(v) for v in agg["offsets"].values())
    srep = tg.straggler_report(agg)
    assert srep["summary"]["worst_proc"] == 1
    assert srep["imbalance"][1]["wait_frac"] == pytest.approx(0.0, abs=1e-12)
    doc = tg.export_chrome_trace(agg)
    for c in range(4):
        ends = [e["ts"] + e["dur"] for e in doc["traceEvents"]
                if e.get("ph") == "X" and e["name"] == f"chunk {c}"]
        assert len(ends) == 2 and abs(ends[0] - ends[1]) < 1e3  # < 1 ms
    assert rep["mesh"]["processes"] == [0, 1]
    assert rep["halo"]["exchanges"] == 1  # the one update_halo after the run


def test_jax_written_derived_streams_read_by_the_port(tmp_path):
    """The same derivation from a JAX run's stream: the port's views equal
    the JAX package's."""
    import numpy as np

    from implicitglobalgrid_tpu.models import diffusion_step_local, init_diffusion3d

    d = tmp_path / "jax_derived"
    d.mkdir()
    igg.init_global_grid(6, 6, 6, dimx=2, dimy=2, dimz=1, quiet=True)
    T, Cp, p = init_diffusion3d(dtype=np.float64)

    def step(s):
        return {"T": diffusion_step_local(s["T"], s["Cp"], p, "xla"), "Cp": s["Cp"]}

    igg.start_flight_recorder(str(d), run_id="jaxrun")
    igg.run_resilient(step, {"T": T, "Cp": Cp}, 6, nt_chunk=3, key="port_reads_jax")
    path = igg.stop_flight_recorder()
    with open(d / "flight_p1.jsonl", "w") as f:
        for e in igg.read_flight_events(path):
            e = dict(e, proc=1, pid=e["pid"] + 1, t=e["t"] + 50.0)
            if e["kind"] == "recorder_open":
                e["wall"] += 0.1
            f.write(json.dumps(e) + "\n")
    agg, _ = _same_views(str(d))
    assert agg["offsets"][1] == pytest.approx(0.1, abs=1e-6)


# ---------------------------------------------------------------------------
# Live metrics endpoint
# ---------------------------------------------------------------------------

def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read().decode(), r.headers


def test_metrics_server_serves_prometheus_and_healthz():
    tg.metrics_registry().counter("mesh_test_total", "t").inc(3)
    srv = tg.start_metrics_server(0)
    try:
        assert tg.metrics_server() is srv and srv.port > 0 and srv.host == "127.0.0.1"
        snapshot = tg.prometheus_snapshot()  # a request is accounted after its answer
        status, body, headers = _get(f"http://127.0.0.1:{srv.port}/metrics")
        assert status == 200 and headers["Content-Type"].startswith("text/plain")
        assert "# TYPE mesh_test_total counter" in body and "mesh_test_total 3" in body
        assert body == snapshot
        status, body, _ = _get(f"http://127.0.0.1:{srv.port}/healthz")
        rec = json.loads(body)
        assert status == 200 and rec["ok"] is True and rec["heartbeat_age_s"] is None
        telemetry.note_heartbeat(70)
        rec = json.loads(_get(f"http://127.0.0.1:{srv.port}/healthz")[1])
        assert rec["step"] == 70 and 0 <= rec["heartbeat_age_s"] < 60
        assert rec["source"] == "driver"
        assert tg.start_metrics_server(0) is srv
        assert tg.start_metrics_server(srv.port) is srv
        with pytest.raises(InvalidArgumentError, match="already running"):
            tg.start_metrics_server(srv.port + 1)
        tg.stop_metrics_server()
        tg.stop_metrics_server()
        assert tg.metrics_server() is srv
        assert _get(f"http://127.0.0.1:{srv.port}/metrics")[0] == 200
        with pytest.raises(urllib.error.HTTPError) as exc:
            _get(f"http://127.0.0.1:{srv.port}/v1/nothing")
        assert exc.value.code == 404
    finally:
        tg.stop_metrics_server()
    assert tg.metrics_server() is None
    tg.stop_metrics_server()  # idempotent


def test_healthz_stale_heartbeat_returns_503():
    import time

    from implicitglobalgrid_tpu_torch.telemetry.hooks import HEARTBEAT_TS

    srv = tg.start_metrics_server(0, healthz_max_age_s=2.0)
    try:
        with pytest.raises(urllib.error.HTTPError) as exc:
            _get(f"http://127.0.0.1:{srv.port}/healthz")
        assert exc.value.code == 503
        telemetry.note_heartbeat(1)
        status, body, _ = _get(f"http://127.0.0.1:{srv.port}/healthz")
        assert status == 200 and json.loads(body)["ok"] is True
        tg.metrics_registry().gauge(HEARTBEAT_TS, "").set(time.time() - 5.0)
        with pytest.raises(urllib.error.HTTPError) as exc:
            _get(f"http://127.0.0.1:{srv.port}/healthz")
        assert exc.value.code == 503
        assert json.loads(exc.value.read().decode())["ok"] is False
    finally:
        tg.stop_metrics_server()


def test_metrics_server_routes_and_token():
    """The routed surface: a route answers, a missing bearer token is 401,
    /metrics stays open; requests are accounted."""
    def routes(method, path, query, body):
        if path == "/v1/echo":
            return 200, (method + query).encode(), "text/plain"
        return None

    from implicitglobalgrid_tpu_torch.telemetry.server import MetricsServer, resolve_api_token

    with MetricsServer(0, routes=routes, auth_token="s3cret") as srv:
        with pytest.raises(urllib.error.HTTPError) as exc:
            _get(f"http://127.0.0.1:{srv.port}/v1/echo?a=1")
        assert exc.value.code == 401
        req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/v1/echo?a=1",
                                     headers={"Authorization": "Bearer s3cret"})
        with urllib.request.urlopen(req, timeout=10) as r:
            assert r.read() == b"GETa=1"
        assert _get(f"http://127.0.0.1:{srv.port}/metrics")[0] == 200
    fam = tg.metrics_registry().get("igg_http_requests_total")
    codes = {lbl["code"] for lbl, _ in fam.samples()}
    assert {"200", "401"} <= codes
    assert resolve_api_token(False) is None and resolve_api_token("t") == "t"
    with pytest.raises(InvalidArgumentError):
        resolve_api_token("")


def test_metrics_server_ephemeral_port_gauge():
    srv = tg.start_metrics_server(0)
    try:
        assert srv.port > 0
        assert tg.metrics_registry().get("igg_metrics_server_port").value() == srv.port
    finally:
        tg.stop_metrics_server()
    assert tg.metrics_registry().get("igg_metrics_server_port").value() == 0


def test_run_resilient_metrics_port_serves_during_run(tmp_path):
    """`run_resilient(metrics_port=0)`: the endpoint is live during the run
    (scraped from ``on_report``), carries the heartbeat and the health
    counters, answers /healthz with the forwarded age limit, and stops
    with the run; ``healthz_max_age_s`` alone is refused before anything
    starts."""
    from implicitglobalgrid_tpu_torch.models import diffusion_step_local, init_diffusion3d
    from implicitglobalgrid_tpu_torch.telemetry.hooks import HEARTBEAT_STEP

    tg.init_global_grid(6, 6, 6, dimx=2, dimy=2, dimz=1, quiet=True, device_type="cpu")
    T, Cp, p = init_diffusion3d(dtype=torch.float64)

    def step(s):
        return {"T": diffusion_step_local(s["T"], s["Cp"], p, "plain"), "Cp": s["Cp"]}

    scraped = []

    def on_report(rep):
        srv = tg.metrics_server()
        assert srv is not None and srv.healthz_max_age_s == 120.0
        assert tg.metrics_registry().get("igg_metrics_server_port").value() == srv.port
        _, metrics, _ = _get(f"http://127.0.0.1:{srv.port}/metrics")
        _, health, _ = _get(f"http://127.0.0.1:{srv.port}/healthz")
        scraped.append((metrics, json.loads(health)))

    with pytest.raises(InvalidArgumentError, match="metrics_port"):
        tg.run_resilient(step, {"T": T, "Cp": Cp}, 6, nt_chunk=2,
                         checkpoint_dir=str(tmp_path / "ck"), healthz_max_age_s=120.0)
    assert not (tmp_path / "ck").exists()
    tg.run_resilient(step, {"T": T, "Cp": Cp}, 6, nt_chunk=2, on_report=on_report,
                     metrics_port=0, healthz_max_age_s=120.0)
    assert len(scraped) == 3
    metrics, health = scraped[-1]
    assert "igg_driver_heartbeat_timestamp_seconds" in metrics
    assert "igg_health_events_total" in metrics
    assert health["heartbeat_age_s"] is not None and health["step"] == 4.0
    assert tg.metrics_server() is None
    assert tg.metrics_registry().get(HEARTBEAT_STEP).value() == 6


def test_run_resilient_attaches_to_a_live_server():
    """A server already up (refcounted): the run attaches and leaves it up."""
    from implicitglobalgrid_tpu_torch.models import diffusion_step_local, init_diffusion3d

    tg.init_global_grid(6, 6, 6, dimx=2, dimy=2, dimz=1, quiet=True, device_type="cpu")
    T, Cp, p = init_diffusion3d(dtype=torch.float64)
    srv = tg.start_metrics_server(0)
    try:
        tg.run_resilient(lambda s: {"T": diffusion_step_local(s["T"], s["Cp"], p, "plain"),
                                    "Cp": s["Cp"]}, {"T": T, "Cp": Cp}, 2, nt_chunk=2,
                         metrics_port=0)
        assert tg.metrics_server() is srv
    finally:
        tg.stop_metrics_server()
    assert tg.metrics_server() is None
