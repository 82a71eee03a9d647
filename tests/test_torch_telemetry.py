"""The port's telemetry core (`implicitglobalgrid_tpu_torch.telemetry`) on the
CPU: the tests of `tests/test_telemetry.py` that touch only the ported
modules (the metrics registry, `prometheus_snapshot`, the flight recorder
and `run_report`), on the port, and the two packages' streams read across:

- each package's `read_flight_events` and `run_report` read the other's
  JSONL of the same faulted run (the same seeded float64 diffusion state,
  the same faults), and the reports' sections agree in counts and event
  kinds, not times. Left out of the comparison, as the port does not emit
  them: the JAX package's ``runner_cache`` events (its compiled-runner
  cache; the port's ``runner_cache`` section reads 0 and no chunk is cold)
  and the audit (not ported);
- the ``igg_health_events_total`` family of `prometheus_snapshot` reads the
  same after the same run on either package.
"""

import json
import os
import re
import threading

import numpy as np
import pytest
import torch

import implicitglobalgrid_tpu as igg
import implicitglobalgrid_tpu_torch as tg
from implicitglobalgrid_tpu_torch import telemetry
from implicitglobalgrid_tpu_torch.telemetry.registry import MetricsRegistry
from implicitglobalgrid_tpu_torch.utils.exceptions import InvalidArgumentError

from torch_port_util import clean_torch_grid, init_both  # noqa: F401

pytestmark = pytest.mark.telemetry

# event kinds only the JAX package emits (module docstring)
JAX_ONLY_KINDS = {"runner_cache", "audit", "audit_failed"}


@pytest.fixture(autouse=True)
def _clean_telemetry():
    for pkg in (tg, igg):
        pkg.stop_flight_recorder()
        pkg.reset_metrics()
    yield
    for pkg in (tg, igg):
        pkg.stop_flight_recorder()
        pkg.reset_metrics()


def _init(dimx=2, dimy=2, dimz=1):
    tg.init_global_grid(6, 6, 6, dimx=dimx, dimy=dimy, dimz=dimz, quiet=True,
                        device_type="cpu")


def _diffusion_step():
    from implicitglobalgrid_tpu_torch.models import diffusion_step_local, init_diffusion3d

    T, Cp, p = init_diffusion3d(dtype=torch.float64)

    def step(s):
        return {"T": diffusion_step_local(s["T"], s["Cp"], p, "plain"), "Cp": s["Cp"]}

    return step, {"T": T, "Cp": Cp}


# ---------------------------------------------------------------------------
# Metrics registry
# ---------------------------------------------------------------------------

def test_registry_counter_gauge_histogram_basics():
    reg = MetricsRegistry()
    c = reg.counter("c_total", "a counter", ("kind",))
    c.inc(1, kind="a")
    c.inc(2.5, kind="a")
    c.inc(1, kind="b")
    assert c.value(kind="a") == 3.5 and c.value(kind="b") == 1
    g = reg.gauge("g", "a gauge")
    g.set(7)
    g.add(-2)
    assert g.value() == 5
    h = reg.histogram("h_seconds", "a histogram", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 0.5, 100.0):
        h.observe(v)
    ((labels, st),) = h.samples()
    assert labels == {} and st["count"] == 4
    assert st["counts"] == [1, 2, 0, 1]  # <=0.1, <=1, <=10, +Inf
    assert abs(st["sum"] - 101.05) < 1e-9


def test_registry_registration_conflicts_and_validation():
    reg = MetricsRegistry()
    c = reg.counter("x_total", "h", ("a",))
    assert reg.counter("x_total", "h", ("a",)) is c  # idempotent
    with pytest.raises(InvalidArgumentError, match="already registered"):
        reg.gauge("x_total")
    with pytest.raises(InvalidArgumentError, match="already registered"):
        reg.counter("x_total", "h", ("b",))
    with pytest.raises(InvalidArgumentError, match="Invalid metric name"):
        reg.counter("bad name")
    with pytest.raises(InvalidArgumentError, match="Invalid label name"):
        reg.counter("ok_total", "h", ("bad-label",))
    with pytest.raises(InvalidArgumentError, match="takes labels"):
        c.inc(1, wrong="z")
    with pytest.raises(InvalidArgumentError, match="cannot decrease"):
        c.inc(-1, a="z")
    with pytest.raises(InvalidArgumentError, match="strictly increasing"):
        reg.histogram("h2", "h", buckets=(1.0, 1.0))


def test_registry_thread_safety():
    """Concurrent counter/histogram writes (plus a snapshotting reader)
    never lose an increment or crash."""
    reg = MetricsRegistry()
    c = reg.counter("threads_total", "t", ("worker",))
    h = reg.histogram("threads_seconds", "t", buckets=(0.5, 1.0))
    n_threads, n_iter = 8, 2000
    errs = []

    def writer(w):
        try:
            for i in range(n_iter):
                c.inc(1, worker=str(w % 4))
                h.observe((i % 3) * 0.4)
        except Exception as e:  # pragma: no cover - failure path
            errs.append(e)

    def reader():
        try:
            for _ in range(200):
                telemetry.prometheus_snapshot(reg)
                reg.collect()
        except Exception as e:  # pragma: no cover - failure path
            errs.append(e)

    threads = [threading.Thread(target=writer, args=(w,))
               for w in range(n_threads)] + [threading.Thread(target=reader)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    assert sum(v for _, v in c.samples()) == n_threads * n_iter
    assert sum(st["count"] for _, st in h.samples()) == n_threads * n_iter


def test_health_events_family_in_registry():
    from implicitglobalgrid_tpu_torch.telemetry.hooks import record_health_event

    assert not hasattr(tg, "health_counters")
    record_health_event("chunks")
    record_health_event("chunks", 2)
    record_health_event("rollbacks")
    fam = tg.metrics_registry().get("igg_health_events_total")
    assert fam is not None and fam.value(kind="chunks") == 3
    assert fam.value(kind="rollbacks") == 1
    other = tg.metrics_registry().counter("unrelated_total", "x")
    other.inc(5)
    tg.metrics_registry().reset("igg_health_events_total")
    fam = tg.metrics_registry().get("igg_health_events_total")
    assert fam is None or not list(fam.samples())
    assert other.value() == 5
    assert "unrelated_total 5" in telemetry.prometheus_snapshot()


# ---------------------------------------------------------------------------
# Prometheus exposition format
# ---------------------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})? "
    r"([+-]?(?:\d+\.?\d*(?:[eE][+-]?\d+)?|Inf|NaN))$")
_LABEL_ITEM_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def test_prometheus_snapshot_parses_with_escaped_labels():
    reg = MetricsRegistry()
    nasty = 'he said "hi"\\there\nnewline'
    reg.counter("esc_total", "counts\nwith newline help", ("who",)).inc(4, who=nasty)
    reg.gauge("level", "plain").set(2.5)
    reg.histogram("lat_seconds", "latency", buckets=(0.1, 1.0)).observe(0.3)
    text = telemetry.prometheus_snapshot(reg)
    assert text.endswith("\n")
    types, samples = {}, []
    for line in text.splitlines():
        if line.startswith("# HELP "):
            assert "\n" not in line[len("# HELP "):].split(" ", 1)[1]
            continue
        if line.startswith("# TYPE "):
            name, kind = line[len("# TYPE "):].split(" ")
            assert kind in ("counter", "gauge", "histogram")
            types[name] = kind
            continue
        m = _SAMPLE_RE.match(line)
        assert m, f"unparseable sample line: {line!r}"
        samples.append(m.groups())
    assert types == {"esc_total": "counter", "level": "gauge", "lat_seconds": "histogram"}
    for name, labels, _ in samples:
        base = re.sub(r"_(bucket|sum|count)$", "", name)
        assert name in types or base in types, name
        for k, v in _LABEL_ITEM_RE.findall(labels or ""):
            if k == "who":
                unescaped = (v.replace("\\\\", "\0").replace('\\"', '"')
                             .replace("\\n", "\n").replace("\0", "\\"))
                assert unescaped == nasty
    hist = {n: float(v) for n, l, v in samples if n.startswith("lat_")}
    cum = [float(v) for n, l, v in samples if n == "lat_seconds_bucket"]
    assert cum == sorted(cum) and cum[-1] == hist["lat_seconds_count"] == 1
    assert abs(hist["lat_seconds_sum"] - 0.3) < 1e-9
    # the JAX package renders the same registry contents to the same text
    from implicitglobalgrid_tpu.telemetry import prometheus_snapshot as j_snap
    from implicitglobalgrid_tpu.telemetry.registry import MetricsRegistry as JReg

    jreg = JReg()
    jreg.counter("esc_total", "counts\nwith newline help", ("who",)).inc(4, who=nasty)
    jreg.gauge("level", "plain").set(2.5)
    jreg.histogram("lat_seconds", "latency", buckets=(0.1, 1.0)).observe(0.3)
    assert j_snap(jreg) == text


def test_prometheus_snapshot_golden_label_escaping():
    reg = MetricsRegistry()
    c = reg.counter("edge_total", "h", ("v",))
    c.inc(1, v='quote"end')
    c.inc(2, v="line\nbreak")
    c.inc(3, v="back\\slash")
    c.inc(4, v='all\\"of\nit')
    text = telemetry.prometheus_snapshot(reg)
    assert 'edge_total{v="quote\\"end"} 1' in text
    assert 'edge_total{v="line\\nbreak"} 2' in text
    assert 'edge_total{v="back\\\\slash"} 3' in text
    assert 'edge_total{v="all\\\\\\"of\\nit"} 4' in text


def test_prometheus_snapshot_golden_inf_nan_gauges():
    reg = MetricsRegistry()
    g = reg.gauge("extreme", "h", ("which",))
    g.set(float("inf"), which="pos")
    g.set(float("-inf"), which="neg")
    g.set(float("nan"), which="nan")
    g.set(-0.0, which="negzero")
    text = telemetry.prometheus_snapshot(reg)
    assert 'extreme{which="pos"} +Inf' in text
    assert 'extreme{which="neg"} -Inf' in text
    assert 'extreme{which="nan"} NaN' in text
    assert 'extreme{which="negzero"} 0' in text
    assert "inf\n" not in text and "nan\n" not in text


def test_prometheus_snapshot_empty_registry_golden():
    reg = MetricsRegistry()
    assert telemetry.prometheus_snapshot(reg) == ""
    reg.counter("lonely_total", "no samples yet")
    assert telemetry.prometheus_snapshot(reg) == (
        "# HELP lonely_total no samples yet\n"
        "# TYPE lonely_total counter\n")


# ---------------------------------------------------------------------------
# Flight recorder
# ---------------------------------------------------------------------------

def test_flight_recorder_roundtrip(tmp_path):
    p = str(tmp_path / "run.jsonl")
    rec = tg.start_flight_recorder(p, run_id="r1")
    tg.record_event("alpha", x=1, arr=np.int64(7), frac=np.float32(0.33))
    with tg.record_span("beta", label="timed"):
        pass
    rec.event("gamma")
    path = tg.stop_flight_recorder()
    assert path == p
    evs = tg.read_flight_events(path)
    assert [e["kind"] for e in evs] == ["recorder_open", "alpha", "beta", "gamma",
                                        "recorder_close"]
    ts = [e["t"] for e in evs]
    assert ts == sorted(ts)
    assert [e["seq"] for e in evs] == list(range(len(evs)))
    assert all(e["run"] == "r1" and e["pid"] == os.getpid() and e["proc"] == 0
               for e in evs)
    assert evs[1]["x"] == 1 and evs[1]["arr"] == 7
    assert abs(evs[1]["frac"] - 0.33) < 1e-6
    assert evs[2]["dur_s"] >= 0 and evs[2]["label"] == "timed"
    assert evs[0]["wall"] > 0 and evs[0]["version"] == 1


def test_record_event_is_noop_without_recorder(tmp_path):
    assert tg.flight_recorder() is None
    tg.record_event("nothing", x=1)
    with tg.record_span("nothing_timed"):
        pass
    assert list(tmp_path.iterdir()) == []
    assert tg.stop_flight_recorder() is None


def test_read_tolerates_torn_final_line_only(tmp_path):
    p = tmp_path / "torn.jsonl"
    p.write_text(json.dumps({"kind": "a", "run": "r"}) + "\n" + '{"kind": "b", "run')
    assert [e["kind"] for e in tg.read_flight_events(str(p))] == ["a"]
    p2 = tmp_path / "corrupt.jsonl"
    p2.write_text('garbage\n' + json.dumps({"kind": "a"}) + "\n")
    with pytest.raises(InvalidArgumentError, match="interior"):
        tg.read_flight_events(str(p2))
    with pytest.raises(InvalidArgumentError, match="not found"):
        tg.read_flight_events(str(tmp_path / "missing.jsonl"))
    # the resumable form leaves the torn tail unconsumed
    evs, off = tg.read_flight_events(str(p), offset=0)
    assert [e["kind"] for e in evs] == ["a"] and off == len(p.read_text().split("\n")[0]) + 1


def test_failed_recorder_open_keeps_active_recorder(tmp_path):
    r = tg.start_flight_recorder(str(tmp_path / "ok.jsonl"), run_id="keep")
    with pytest.raises(OSError):
        tg.start_flight_recorder(str(tmp_path / "no" / "such" / "x.jsonl"))
    assert tg.flight_recorder() is r
    tg.record_event("still_alive")
    path = tg.stop_flight_recorder()
    assert any(e["kind"] == "still_alive" for e in tg.read_flight_events(path))


def test_recorder_thread_safety(tmp_path):
    tg.start_flight_recorder(str(tmp_path / "mt.jsonl"), run_id="mt")
    n_threads, n_iter = 6, 300

    def writer(w):
        for i in range(n_iter):
            tg.record_event("w", worker=w, i=i)

    threads = [threading.Thread(target=writer, args=(w,)) for w in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    evs = tg.read_flight_events(tg.stop_flight_recorder())
    assert len([e for e in evs if e["kind"] == "w"]) == n_threads * n_iter
    assert sorted(e["seq"] for e in evs) == list(range(len(evs)))


def test_recorder_into_directory_and_multi_run_filter(tmp_path):
    """A directory path follows the per-process convention
    (``flight_p<rank>.jsonl``); `run_report` of the directory aggregates its
    streams (two runs in it need ``run_id``); a scheduler journal there
    makes it the service record, as the JAX package's."""
    tg.start_flight_recorder(str(tmp_path), run_id="runA")
    tg.record_event("a")
    path = tg.stop_flight_recorder()
    assert os.path.basename(path) == "flight_p0.jsonl"
    tg.start_flight_recorder(path, run_id="runB")
    tg.record_event("b")
    tg.stop_flight_recorder()
    assert {e["run"] for e in tg.read_flight_events(path)} == {"runA", "runB"}
    assert {e["run"] for e in tg.read_flight_events(path, run_id="runB")} == {"runB"}
    assert tg.run_report(path, include_metrics=False)["run_id"] == "runB"
    assert tg.run_report(path, run_id="runA", include_metrics=False)["run_id"] == "runA"
    with pytest.raises(InvalidArgumentError, match="not present"):
        tg.run_report(path, run_id="nope")
    with pytest.raises(InvalidArgumentError, match="run ids"):
        tg.run_report(str(tmp_path))
    rep = tg.run_report(str(tmp_path), run_id="runA", include_metrics=False)
    assert rep["run_id"] == "runA" and "mesh" not in rep
    (tmp_path / "scheduler.jsonl").write_text("")
    rep = tg.run_report(str(tmp_path))
    assert rep == igg.run_report(str(tmp_path))
    assert rep["jobs"] == {} and rep["slices"] == 0 and "run_id" not in rep


def test_update_halo_charges_plan_to_registry():
    """JAX's case, on both packages: every `update_halo` call charges its
    signature's wire plan (`halo_comm_plan`), and the counters of both
    packages agree after the same calls."""
    igg.init_global_grid(6, 6, 6, dimx=2, dimy=2, dimz=2, periodx=1, periody=1, periodz=1,
                         quiet=True)
    tg.init_global_grid(6, 6, 6, dimx=2, dimy=2, dimz=2, periodx=1, periody=1, periodz=1,
                        quiet=True, device_type="cpu")
    for pkg, T in ((igg, igg.ones_g(dtype=np.float32)),
                   (tg, tg.ones_g(dtype=torch.float32))):
        plan = pkg.halo_comm_plan(T)
        reg = pkg.metrics_registry()
        base = reg.counter("igg_halo_exchanges_total").value()
        T = pkg.update_halo(T)
        T = pkg.update_halo(T)
        assert reg.counter("igg_halo_exchanges_total").value() == base + 2
        assert sum(v for _, v in reg.get("igg_halo_wire_bytes_total").samples()) \
            == 2 * plan["wire_bytes"]
        assert sum(v for _, v in reg.get("igg_halo_ppermutes_total").samples()) \
            == 2 * plan["ppermutes"]
    halo = re.compile(r"^igg_halo_\w+(\{.*\})? ")
    snap = {pkg: sorted(ln for ln in pkg.prometheus_snapshot().splitlines() if halo.match(ln))
            for pkg in (igg, tg)}
    assert snap[tg] == snap[igg] and snap[tg]


@pytest.mark.parametrize("case", ["coalesced_int8", "self_neighbour", "per_dim_hw2"])
def test_update_halo_counters_equal_jax(case):
    """The same `update_halo` calls on both packages leave the same
    ``igg_halo_*`` counters: a coalesced group under an int8 wire, a
    single block's self-neighbour exchange (local copies, no wire), and
    per-field halowidths."""
    if case == "self_neighbour":
        grid = dict(dimx=1, dimy=1, dimz=1, periodx=1, periody=1, periodz=1)
        n, nranks = 6, 1
    else:
        grid = dict(dimx=2, dimy=2, dimz=2, periodx=1, periodz=1)
        n, nranks = 8, 8
    init_both(n, n, n, overlaps=(4, 4, 4) if case == "per_dim_hw2" else (2, 2, 2),
              nranks=nranks, **grid)
    shape = tuple(n * d for d in (grid["dimx"], grid["dimy"], grid["dimz"]))
    for pkg, mk in ((igg, lambda: igg.ones_g(dtype=np.float32)),
                    (tg, lambda: torch.ones(shape, dtype=torch.float32))):
        if case == "coalesced_int8":
            pkg.update_halo(mk(), mk(), mk(), wire_dtype="int8")
        elif case == "per_dim_hw2":
            pkg.update_halo((mk(), (2, 2, 2)), mk())
        else:
            pkg.update_halo(mk())
        pkg.update_halo(mk())
    halo = re.compile(r"^igg_halo_\w+(\{.*\})? ")
    snap = {pkg: sorted(ln for ln in pkg.prometheus_snapshot().splitlines() if halo.match(ln))
            for pkg in (igg, tg)}
    assert snap[tg] == snap[igg] and len(snap[tg]) >= 2


def test_update_halo_accounting_streams_and_local_exchange_charges_nothing(tmp_path):
    """A recorder open: one ``halo_exchange`` event a call, as JAX's; the
    models' `local_update_halo` charges nothing; the plan is computed once
    a signature."""
    from implicitglobalgrid_tpu_torch.ops import halo

    _init()
    T = tg.ones_g(dtype=torch.float32)
    tg.start_flight_recorder(str(tmp_path / "fr.jsonl"))
    T = tg.local_update_halo(T)
    fam = tg.metrics_registry().get("igg_halo_exchanges_total")
    assert fam is None or fam.value() == 0  # reset_metrics keeps registrations
    halo._plan_cache.clear()
    for _ in range(3):
        T = tg.update_halo(T)
    assert len(halo._plan_cache) == 1
    path = tg.stop_flight_recorder()
    evs = [e for e in tg.read_flight_events(path) if e["kind"] == "halo_exchange"]
    plan = tg.halo_comm_plan(T)
    assert len(evs) == 3 and all(
        e["wire_bytes"] == plan["wire_bytes"] and e["ppermutes"] == plan["ppermutes"]
        and e["fields"] == 1 and e["local_copy_bytes"] == plan["local_copy_bytes"]
        for e in evs)
    assert tg.run_report(path, include_metrics=False)["halo"] == {
        "exchanges": 3, "ppermutes": 3 * plan["ppermutes"],
        "wire_bytes": 3 * plan["wire_bytes"]}
    # a finalized grid's plans are evicted at the next miss
    tg.finalize_global_grid()
    _init()
    tg.update_halo(tg.ones_g(dtype=torch.float32))
    assert len(halo._plan_cache) == 1


def test_recorder_proc_is_the_grid_rank_and_thread_binding(tmp_path):
    """``proc`` is the live grid's transport rank (0 on the virtual mesh);
    a thread bound to a recorder keeps writing to it under another
    current recorder (the snapshot writer's case)."""
    _init()
    a = tg.telemetry.FlightRecorder(str(tmp_path / "a.jsonl"), run_id="a")
    tg.start_flight_recorder(str(tmp_path / "b.jsonl"), run_id="b")

    def bound():
        tg.telemetry.bind_thread_recorder(a)
        tg.record_event("from_thread")

    t = threading.Thread(target=bound)
    t.start()
    t.join()
    with tg.telemetry.use_flight_recorder(None):
        tg.record_event("silenced")
    tg.record_event("from_main")
    a.close()
    tg.stop_flight_recorder()
    ka = [e["kind"] for e in tg.read_flight_events(str(tmp_path / "a.jsonl"))]
    kb = [e["kind"] for e in tg.read_flight_events(str(tmp_path / "b.jsonl"))]
    assert "from_thread" in ka and "from_thread" not in kb
    assert "from_main" in kb and "silenced" not in ka + kb
    assert a._proc == 0


# ---------------------------------------------------------------------------
# The unified run report
# ---------------------------------------------------------------------------

def test_run_report_reconstructs_fault_injected_run(tmp_path):
    _init()
    step, state = _diffusion_step()
    tg.start_flight_recorder(str(tmp_path / "run.jsonl"), run_id="faulty")
    out, reports = tg.run_resilient(
        step, state, 20, nt_chunk=5, key="tel_fault", checkpoint_dir=str(tmp_path / "ck"),
        faults=[tg.NaNPoke(step=12, name="T", index=(0, 0, 0))])
    path = tg.stop_flight_recorder()

    rep = tg.run_report(path, include_metrics=False)
    assert rep["run_id"] == "faulty"
    assert rep["steps"] == {"nt": 20, "completed": 20}
    assert rep["chunks"]["count"] == len(reports)
    assert rep["chunks"]["tripped"] == 1
    assert rep["guards"] == {"trips": 1, "reasons": {"nonfinite:T": 1}}
    assert rep["checkpoints"]["rollbacks"] == 1
    assert rep["checkpoints"]["restores"] == 1
    assert rep["checkpoints"]["saves"] >= 3
    assert rep["checkpoints"]["save_s_total"] > 0
    assert rep["chunks"]["exec_s_total"] > 0
    # the port caches no compiled runner: no cache outcome, no cold chunk
    assert rep["runner_cache"] == {"hits": 0, "misses": 0, "uncached": 0}
    assert rep["chunks"]["cold"] == 0

    kinds = [e["kind"] for e in rep["sequence"]]
    assert kinds[0] == "run_begin" and kinds[-1] == "run_end"
    i_fault = kinds.index("fault_injected")
    i_trip = kinds.index("guard_trip")
    i_restore = kinds.index("checkpoint_restore")
    i_roll = kinds.index("rollback")
    assert i_fault < i_trip < i_restore < i_roll < len(kinds) - 1
    tripped = [e for e in rep["sequence"] if e["kind"] == "chunk" and not e["ok"]]
    assert len(tripped) == 1 and tripped[0]["step_begin"] == 12
    roll = next(e for e in rep["sequence"] if e["kind"] == "rollback")
    assert roll["to_step"] == 10 and roll["fallback"] is False
    spans = [(e["step_begin"], e["step_end"]) for e in rep["sequence"] if e["kind"] == "chunk"]
    assert spans[0] == (0, 5) and (10, 12) in spans and spans[-1] == (15, 20)


def test_run_report_merges_trace_and_metrics(tmp_path):
    _init()
    step, state = _diffusion_step()
    tg.start_flight_recorder(str(tmp_path / "run.jsonl"))
    with tg.trace(str(tmp_path / "trace")):
        tg.run_resilient(step, state, 4, nt_chunk=2, key="tel_trace")
    path = tg.stop_flight_recorder()
    rep = tg.run_report(path, trace_dir=str(tmp_path / "trace"))
    assert "overlap_stats" in rep and "op_breakdown" in rep
    assert isinstance(rep["op_breakdown"], list) and rep["op_breakdown"]
    names = {fam["name"] for fam in rep["metrics"]}
    assert "igg_health_events_total" in names
    assert "igg_runner_cache_total" not in names  # no runner cache in the port


def test_run_report_sequence_carries_snapshot_writer_close(tmp_path):
    tg.start_flight_recorder(str(tmp_path / "run.jsonl"), run_id="wc")
    tg.record_event("run_begin", nt=10, nt_chunk=5, names=["T"])
    tg.record_event("chunk", chunk=0, step_begin=0, step_end=10, ok=True,
                    reasons=[], build_s=0.01, exec_s=0.1)
    tg.record_event("snapshot_writer_close", submitted=3, written=2,
                    staged=0, dropped=1, errors=0, bytes=4096)
    tg.record_event("run_end", completed=10, chunks=1)
    rep = tg.run_report(tg.stop_flight_recorder(), include_metrics=False)
    close = next(e for e in rep["sequence"] if e["kind"] == "snapshot_writer_close")
    assert close == {"kind": "snapshot_writer_close", "t": close["t"],
                     "submitted": 3, "written": 2, "staged": 0,
                     "dropped": 1, "errors": 0, "bytes": 4096}
    _init()
    step, state = _diffusion_step()
    tg.start_flight_recorder(str(tmp_path / "run2.jsonl"), run_id="wc2")
    tg.run_resilient(step, state, 4, nt_chunk=2, key="tel_wc",
                     snapshot_dir=str(tmp_path / "snaps"))
    rep2 = tg.run_report(tg.stop_flight_recorder(), include_metrics=False)
    close2 = [e for e in rep2["sequence"] if e["kind"] == "snapshot_writer_close"]
    assert len(close2) == 1 and close2[0]["written"] == 2
    assert close2[0]["submitted"] == 2 and "bytes" in close2[0]


def test_run_report_refuses_a_multi_process_stream(tmp_path):
    """A stream of several processes is clock-aligned and reported with a
    ``mesh`` section (`telemetry.aggregate`); one whose chunks carry no
    ``exec_s`` has no barrier arrivals and is refused, as the JAX package
    refuses it."""
    evs = [{"kind": "chunk", "run": "r", "proc": p, "seq": 0, "t": 0.0} for p in (0, 1)]
    for pkg in (tg, igg):
        with pytest.raises(pkg.exceptions.InvalidArgumentError if pkg is tg
                           else igg.utils.exceptions.InvalidArgumentError,
                           match="at least two processes"):
            pkg.run_report(evs, include_metrics=False)
    evs = [{"kind": "chunk", "run": "r", "proc": p, "seq": 0, "t": 1.0 + p, "chunk": 0,
            "n": 2, "exec_s": 0.5 - 0.1 * p, "build_s": 0.0} for p in (0, 1)]
    rep = tg.run_report(evs, include_metrics=False)
    assert rep["mesh"]["processes"] == [0, 1] and rep["chunks"]["count"] == 1
    assert rep == igg.run_report(evs, include_metrics=False)


# ---------------------------------------------------------------------------
# Both packages' streams of the same run, read across
# ---------------------------------------------------------------------------

_SECTIONS = ("steps", "guards", "escalations", "elastic_restarts", "io")
_CHECKPOINT_COUNTS = ("saves", "restores", "rollbacks")
_IO_COUNTS = ("snapshots_submitted", "snapshots_written", "snapshots_staged",
              "snapshots_dropped", "snapshot_errors", "snapshot_bytes", "reducer_points")


def _report_summary(rep):
    """A report's sections in counts and event kinds (times left out)."""
    out = {k: rep[k] for k in _SECTIONS if k != "io"}
    out["io"] = {k: rep["io"][k] for k in _IO_COUNTS}
    out["checkpoints"] = {k: rep["checkpoints"][k] for k in _CHECKPOINT_COUNTS}
    out["chunks"] = {k: rep["chunks"][k] for k in ("count", "ok", "tripped")}
    seq = []
    for e in rep["sequence"]:
        e = {k: v for k, v in e.items()
             if k not in ("t", "dur_s", "build_s", "exec_s", "cold", "values")}
        seq.append(e)
    out["sequence"] = seq
    return out


@pytest.fixture
def both_streams(tmp_path):
    """The same faulted run (seeded float64 state, a NaN at step 7, a
    snapshot a chunk, a probe) on both packages, each into its own flight
    recorder; each package's health family snapshot after its run."""
    from implicitglobalgrid_tpu.models import diffusion_step_local as j_step
    from implicitglobalgrid_tpu.models import init_diffusion3d as j_init
    from implicitglobalgrid_tpu_torch.models import diffusion_step_local as t_step
    from implicitglobalgrid_tpu_torch.models import init_diffusion3d as t_init

    init_both(6, 6, 6, dimx=2, dimy=2, dimz=1, nranks=4)
    g = np.random.default_rng(31)
    T, Cp = 1 + g.random((12, 12, 6)), 1 + g.random((12, 12, 6))
    _, _, pj = j_init(dtype=np.float64)
    _, _, pt = t_init(dtype=torch.float64)
    kw = dict(nt_chunk=4, snapshot_every=4, perf_window=0)
    paths = {}
    for name, pkg, step, p, impl in (("jax", igg, j_step, pj, "xla"),
                                      ("torch", tg, t_step, pt, "plain")):
        pkg.reset_metrics()
        paths[name] = str(tmp_path / f"{name}.jsonl")
        pkg.start_flight_recorder(paths[name], run_id=f"cross_{name}")
        pkg.run_resilient(
            lambda s, step=step, p=p, impl=impl: {"T": step(s["T"], s["Cp"], p, impl),
                                                  "Cp": s["Cp"]},
            {"T": pkg.device_put_g(T), "Cp": pkg.device_put_g(Cp)}, 12, key="cross",
            checkpoint_dir=str(tmp_path / f"ck_{name}"),
            snapshot_dir=str(tmp_path / f"snaps_{name}"),
            reducers=[pkg.Probe("T", (3, 4, 2))],
            faults=[pkg.NaNPoke(step=7, name="T", index=(3, 3, 3))], **kw)
        pkg.stop_flight_recorder()
        paths[f"{name}_health"] = [ln for ln in pkg.prometheus_snapshot().splitlines()
                                   if "igg_health_events_total" in ln]
    return paths


def test_flight_streams_read_across_packages(both_streams):
    """Each package's reader and `run_report` read the other's stream; the
    four reports (two streams x two readers) agree in counts and event
    kinds, once the JAX-only kinds are left out."""
    pj, pt = both_streams["jax"], both_streams["torch"]
    evs = {("jax", "jax"): igg.read_flight_events(pj), ("jax", "torch"): tg.read_flight_events(pj),
           ("torch", "jax"): igg.read_flight_events(pt),
           ("torch", "torch"): tg.read_flight_events(pt)}
    assert evs[("jax", "jax")] == evs[("jax", "torch")]
    assert evs[("torch", "jax")] == evs[("torch", "torch")]
    kinds_j = [e["kind"] for e in evs[("jax", "jax")] if e["kind"] not in JAX_ONLY_KINDS]
    kinds_t = [e["kind"] for e in evs[("torch", "torch")]]
    assert "runner_cache" in {e["kind"] for e in evs[("jax", "jax")]}
    assert not JAX_ONLY_KINDS & set(kinds_t)
    # the snapshot writer's thread interleaves its events with the driver's
    assert sorted(kinds_j) == sorted(kinds_t)
    assert {e["proc"] for e in evs[("torch", "torch")]} == {0}
    reports = {(src, rd): _report_summary(pkg.run_report(path, include_metrics=False))
               for src, path in (("jax", pj), ("torch", pt))
               for rd, pkg in (("jax", igg), ("torch", tg))}
    assert reports[("jax", "jax")] == reports[("jax", "torch")]
    assert reports[("torch", "jax")] == reports[("torch", "torch")]
    rj, rt = reports[("jax", "torch")], reports[("torch", "torch")]
    for k in rj:
        if k == "sequence":
            continue
        assert rj[k] == rt[k], k
    assert sorted(json.dumps(e, sort_keys=True) for e in rj["sequence"]) == \
        sorted(json.dumps(e, sort_keys=True) for e in rt["sequence"])
    assert rt["guards"] == {"trips": 1, "reasons": {"nonfinite:T": 1}}
    assert rt["checkpoints"]["rollbacks"] == 1 and rt["io"]["snapshots_written"] == 3
    full_t = tg.run_report(pt, include_metrics=False)
    full_j = igg.run_report(pj, include_metrics=False)
    assert full_t["runner_cache"] == {"hits": 0, "misses": 0, "uncached": 0}
    assert full_j["runner_cache"]["misses"] >= 1  # the JAX run compiled its chunks


def test_health_family_reads_the_same(both_streams):
    """The ``igg_health_events_total`` family of `prometheus_snapshot` after
    the same run, on either package."""
    assert both_streams["torch_health"] == both_streams["jax_health"]
    assert any('kind="rollbacks"} 1' in ln for ln in both_streams["torch_health"])


def test_checkpoint_operations_observed(tmp_path):
    """Every checkpoint save and restore records its latency histogram and
    its flight event at the JAX package's places: ``save``, ``restore``,
    ``save_sharded``, ``restore_sharded`` (also the elastic restore's
    same-grid delegation) and ``restore_elastic``."""
    _init()
    T = tg.ones_g()
    tg.start_flight_recorder(str(tmp_path / "ck.jsonl"))
    tg.save_checkpoint(str(tmp_path / "one.npz"), {"T": T}, step=1)
    tg.restore_checkpoint(str(tmp_path / "one.npz"))
    tg.save_checkpoint_sharded(str(tmp_path / "sh"), {"T": T}, step=2)
    tg.restore_checkpoint_sharded(str(tmp_path / "sh"))
    tg.restore_checkpoint_elastic(str(tmp_path / "sh"))  # same grid: the sharded restore
    tg.elastic_restart(str(tmp_path / "sh"), (1, 2, 2))
    tg.stop_flight_recorder()
    ops = [(e["kind"], e["op"], e["step"])
           for e in tg.read_flight_events(str(tmp_path / "ck.jsonl")) if "op" in e]
    assert ops == [("checkpoint_save", "save", 1), ("checkpoint_restore", "restore", 1),
                   ("checkpoint_save", "save_sharded", 2),
                   ("checkpoint_restore", "restore_sharded", 2),
                   ("checkpoint_restore", "restore_sharded", 2),
                   ("checkpoint_restore", "restore_elastic", 2)]
    hist = dict((l["op"], st["count"]) for l, st in
                tg.metrics_registry().get("igg_checkpoint_seconds").samples())
    assert hist == {"save": 1, "restore": 1, "save_sharded": 1, "restore_sharded": 2,
                    "restore_elastic": 1}
