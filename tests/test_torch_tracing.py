"""The port's end-to-end tracing on the CPU, held against the JAX package's
(`tests/test_telemetry.py`'s tracing cases: `TraceContext`, the recorder's
trace stamping, the OTLP golden span tree, its filters and errors, and the
exporter that never raises).

Each case runs the same assertions on both packages' telemetry
(``lib``), and `encode_spans` of the same streams gives equal JSON in both
packages: the golden directory, the directories of real scheduler runs of
either package (one span tree a job, under the context it was submitted
with), and a recorder of one package stamped with the other's context.
"""

import hashlib
import json
import re

import pytest

import implicitglobalgrid_tpu as igg
import implicitglobalgrid_tpu_torch as tg
from implicitglobalgrid_tpu import telemetry as jax_tel
from implicitglobalgrid_tpu.telemetry import otlp as jax_otlp
from implicitglobalgrid_tpu_torch import telemetry as torch_tel
from implicitglobalgrid_tpu_torch.telemetry import otlp as torch_otlp

from torch_port_util import clean_torch_grid  # noqa: F401

pytestmark = pytest.mark.telemetry

_PKGS = {"torch": (tg, torch_tel), "jax": (igg, jax_tel)}


@pytest.fixture(params=["torch", "jax"])
def lib(request):
    """(package, its `telemetry` package)."""
    return _PKGS[request.param]


@pytest.fixture(autouse=True)
def _clean_telemetry():
    for pkg in (tg, igg):
        pkg.stop_flight_recorder()
        pkg.reset_metrics()
    yield
    for pkg in (tg, igg):
        pkg.stop_flight_recorder()
        pkg.reset_metrics()


def test_trace_context_parse_format_child_fields(lib):
    """The W3C traceparent round trip: mint, render, parse, derive."""
    _, tel = lib
    root = tel.TraceContext.new()
    assert len(root.trace_id) == 32 and len(root.span_id) == 16
    assert root.parent_span_id is None and root.flags == "01"
    hdr = root.to_traceparent()
    assert re.fullmatch(rf"00-{root.trace_id}-{root.span_id}-01", hdr)
    back = tel.TraceContext.parse(hdr)
    assert (back.trace_id, back.span_id) == (root.trace_id, root.span_id)
    assert tel.TraceContext.parse("  " + hdr.upper() + " ").span_id == root.span_id
    kid = root.child()
    assert kid.trace_id == root.trace_id and kid.parent_span_id == root.span_id
    assert kid.span_id != root.span_id
    assert kid.fields() == {"trace_id": root.trace_id, "span_id": kid.span_id,
                            "parent_span_id": root.span_id}
    assert root.fields() == {"trace_id": root.trace_id, "span_id": root.span_id}


def test_trace_context_rejects_malformed(lib):
    pkg, tel = lib
    err = pkg.exceptions.InvalidArgumentError
    good = tel.TraceContext.new().to_traceparent()
    for bad in ("", "nonsense", good[:-3], "ff" + good[2:], "00-" + "0" * 32 + good[35:],
                good[:36] + "0" * 16 + good[52:], good.replace("-", "_")):
        with pytest.raises(err):
            tel.TraceContext.parse(bad)
    with pytest.raises(err):
        tel.TraceContext.parse(None)
    with pytest.raises(err):
        tel.TraceContext(trace_id="xyz")
    with pytest.raises(err):
        tel.TraceContext(trace_id="a" * 32, span_id="0" * 16)


def test_trace_contexts_render_and_parse_across():
    """A header one package renders parses in the other to the same ids."""
    for a, b in ((torch_tel, jax_tel), (jax_tel, torch_tel)):
        ctx = a.TraceContext.new().child()
        back = b.TraceContext.parse(ctx.to_traceparent())
        assert (back.trace_id, back.span_id, back.flags) == (ctx.trace_id, ctx.span_id,
                                                            ctx.flags)
        kid = back.child()
        assert kid.fields()["parent_span_id"] == ctx.span_id


def _drive(rec):
    rec.event("run_begin", nt=8)
    rec.event("chunk", chunk=0, step_begin=0, step_end=4, ok=True, exec_s=0.25,
              build_s=0.5, n=4)
    rec.event("guard_trip", chunk=0, reason="nonfinite")
    rec.close()


@pytest.mark.parametrize("ctx_pkg", ["torch", "jax"])
def test_flight_recorder_trace_stamping_off_is_byte_identical(tmp_path, lib, ctx_pkg):
    """An untraced recorder writes no trace key at all; a traced one (given
    either package's context) differs only by the two stamp keys, and
    ``recorder_open`` stays untraced."""
    _, tel = lib
    p_off = tmp_path / "off.jsonl"
    _drive(tel.FlightRecorder(str(p_off), run_id="tr_off"))
    raw = p_off.read_text()
    assert "trace_id" not in raw and "span_id" not in raw
    tr = _PKGS[ctx_pkg][1].TraceContext.new().child()
    p_on = tmp_path / "on.jsonl"
    rec = tel.FlightRecorder(str(p_on), run_id="tr_on")
    rec.trace = tr
    _drive(rec)
    off = tel.read_flight_events(str(p_off))
    on = tel.read_flight_events(str(p_on))
    assert [e["kind"] for e in off] == [e["kind"] for e in on]
    for e_off, e_on in zip(off, on):
        if e_on["kind"] == "recorder_open":
            assert "trace_id" not in e_on
            extra = set()
        else:
            assert e_on["trace_id"] == tr.trace_id
            assert e_on["parent_span_id"] == tr.span_id
            assert "span_id" not in e_on
            extra = {"trace_id", "parent_span_id"}
        assert set(e_on) - set(e_off) == extra


_TID = "0af7651916cd43dd8448eb211c80319c"
_API = "b7ad6b7169203331"   # the requester's span (dangling parent)
_ROOT = "00f067aa0ba902b7"  # job_claimed: the job's root span


def _golden_trace_dir(tmp_path):
    """Hand-written journal and flight stream of one traced job."""
    tid = _TID

    def w(path, evs):
        with open(path, "w", encoding="utf-8") as f:
            for e in evs:
                f.write(json.dumps(e) + "\n")

    def j(kind, t, seq, **kw):
        return {"kind": kind, "t": t, "run": "scheduler", "pid": 1, "proc": 0, "seq": seq,
                **kw}

    w(tmp_path / "journal.jsonl", [
        j("recorder_open", 100.0, 0, wall=2000.0),
        j("job_claimed", 101.0, 1, job="j1", owner="sched-1", trace_id=tid,
          span_id=_ROOT, parent_span_id=_API),
        j("admission_priced", 102.0, 2, job="j1", price=3, trace_id=tid,
          span_id="1111111111111111", parent_span_id=_ROOT),
        j("alert", 103.0, 3, job="j1", rule="deadline_slack_burn", state="firing",
          trace_id=tid, span_id="2222222222222222", parent_span_id=_ROOT),
        j("autoscale_decision", 103.5, 4, job="j1", verdict="grow", trace_id=tid,
          span_id="3333333333333333", parent_span_id=_ROOT),
        j("resize_requested", 104.0, 5, job="j1", new_dims=[2, 2, 1], trace_id=tid,
          span_id="4444444444444444", parent_span_id=_ROOT),
        # a DIFFERENT job on the same journal: the job= filter's foil
        j("job_claimed", 105.0, 6, job="other", trace_id="beef" * 8,
          span_id="5555555555555555"),
    ])

    def f(kind, t, seq, **kw):
        return {"kind": kind, "t": t, "run": "j1", "pid": 2, "proc": 0, "seq": seq, **kw}

    w(tmp_path / "job_j1.jsonl", [
        f("recorder_open", 10.0, 0, wall=1910.0),
        f("chunk", 11.5, 1, chunk=0, n=4, exec_s=1.0, build_s=0.5, ok=True, trace_id=tid,
          parent_span_id=_ROOT),
        f("guard_trip", 11.75, 2, chunk=0, reason="nonfinite", trace_id=tid,
          parent_span_id=_ROOT),
        f("resize", 12.0, 3, dur_s=0.25, new_dims=[2, 2, 1], via="disk", trace_id=tid,
          parent_span_id=_ROOT),
        f("run_end", 12.5, 4, completed=8),   # untraced: no span
    ])
    return tmp_path


def _all_spans(doc):
    return [s for rs in doc["resourceSpans"] for ss in rs["scopeSpans"] for s in ss["spans"]]


def test_export_otlp_golden_span_tree(tmp_path, lib):
    """Exact wall-anchored nanosecond windows, int64-as-string attributes,
    one resource per (run, proc), red-flag kinds as span events on their
    parent, the resize link, and one parent-connected tree."""
    _, tel = lib
    doc = tel.export_otlp(str(_golden_trace_dir(tmp_path)), trace_id=_TID)
    services = {}
    for rs in doc["resourceSpans"]:
        attrs = {a["key"]: a["value"] for a in rs["resource"]["attributes"]}
        services[attrs["igg.run"]["stringValue"]] = attrs["service.name"]["stringValue"]
    assert services == {"scheduler": "igg-scheduler", "j1": "igg-job"}
    spans = _all_spans(doc)
    by_name = {s["name"]: s for s in spans}
    assert set(by_name) == {"job_claimed", "admission_priced", "alert", "autoscale_decision",
                            "resize_requested", "chunk", "guard_trip", "resize"}
    assert all(s["traceId"] == _TID and s["kind"] == 1 for s in spans)
    ids = {s["spanId"] for s in spans}
    assert len(ids) == len(spans)
    roots = [s for s in spans if s.get("parentSpanId") not in ids]
    assert [s["name"] for s in roots] == ["job_claimed"]
    assert roots[0]["spanId"] == _ROOT and roots[0]["parentSpanId"] == _API
    chunk = by_name["chunk"]
    assert chunk["startTimeUnixNano"] == str(int(1910.0 * 1e9))
    assert chunk["endTimeUnixNano"] == str(int(1911.5 * 1e9))
    claimed = by_name["job_claimed"]
    assert claimed["startTimeUnixNano"] == claimed["endTimeUnixNano"] == str(int(2001.0 * 1e9))
    rz = by_name["resize"]
    assert rz["startTimeUnixNano"] == str(int(1911.75 * 1e9))
    assert chunk["spanId"] == hashlib.sha256(f"{_TID}:j1:0:1".encode()).hexdigest()[:16]
    priced = {a["key"]: a["value"] for a in by_name["admission_priced"]["attributes"]}
    assert priced["price"] == {"intValue": "3"} and priced["job"] == {"stringValue": "j1"}
    assert "t" not in priced and "trace_id" not in priced
    chunk_attrs = {a["key"]: a["value"] for a in chunk["attributes"]}
    assert chunk_attrs["ok"] == {"boolValue": True}
    assert chunk_attrs["exec_s"] == {"doubleValue": 1.0}
    assert {"alert", "autoscale_decision", "guard_trip"} <= {
        e["name"] for e in claimed.get("events", ())}
    links = rz.get("links", [])
    assert len(links) == 1 and links[0]["spanId"] == by_name["resize_requested"]["spanId"]
    assert links[0]["attributes"] == [
        {"key": "igg.link", "value": {"stringValue": "resize_requested"}}]


def test_export_otlp_filters_and_errors(tmp_path, lib):
    pkg, tel = lib
    err = pkg.exceptions.InvalidArgumentError
    d = _golden_trace_dir(tmp_path)
    assert all(s["traceId"] == _TID for s in _all_spans(tel.export_otlp(str(d), job="j1")))
    assert {s["traceId"] for s in _all_spans(tel.export_otlp(str(d)))} == {_TID, "beef" * 8}
    with pytest.raises(err):
        tel.export_otlp(str(d), trace_id="c0de" * 8)
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(err):
        tel.export_otlp(str(empty))
    out = tel.export_otlp(str(d), str(tmp_path / "o.json"), trace_id=_TID)
    assert json.loads(open(out).read())["resourceSpans"]


def test_otlp_exporter_batches_and_never_raises(lib):
    """The live sink: auto-flush at the batch size, failures counted (never
    raised into the caller), untraced events ignored."""
    pkg, tel = lib
    err = pkg.exceptions.InvalidArgumentError

    class Capture(tel.OtlpSpanExporter):
        def __init__(self, **kw):
            super().__init__("http://collector.invalid/v1/traces", **kw)
            self.bodies = []
            self.boom = False

        def _post(self, body):
            if self.boom:
                raise OSError("collector down")
            self.bodies.append(json.loads(body.decode()))

    exp = Capture(batch=2)
    ev = {"kind": "slice", "t": 1.0, "run": "scheduler", "job": "j", "trace_id": _TID,
          "span_id": "1212121212121212"}
    exp.add(dict(ev, seq=0))
    assert not exp.bodies
    exp.add({"kind": "slice", "t": 1.0})
    exp(dict(ev, seq=1))
    assert len(exp.bodies) == 1 and exp.sent == 2
    spans = _all_spans(exp.bodies[0])
    assert len(spans) == 2 and spans[0]["traceId"] == _TID
    exp.boom = True
    exp.add(dict(ev, seq=2))
    exp.close()
    assert exp.failed == 1 and "collector down" in exp.last_error
    assert len(exp.bodies) == 1
    with pytest.raises(err):
        tel.OtlpSpanExporter("")
    with pytest.raises(err):
        tel.OtlpSpanExporter("http://x", batch=0)


def test_otlp_exporter_posts_to_a_local_collector():
    """The exporter's real POST reaches a localhost collector the test owns
    (a `MetricsServer` route), and a refused connection is counted."""
    got = []

    def routes(method, path, query, body):
        if method == "POST" and path == "/v1/traces":
            got.append(json.loads(body))
            return 200, b"{}", "application/json"
        return None

    with tg.telemetry.MetricsServer(0, routes=routes) as srv:
        exp = torch_tel.OtlpSpanExporter(f"http://127.0.0.1:{srv.port}/v1/traces",
                                         batch=1, timeout_s=5.0)
        exp.add({"kind": "slice", "t": 1.0, "run": "scheduler", "seq": 0,
                 "trace_id": _TID, "span_id": "1212121212121212"})
        port = srv.port
    assert exp.sent == 1 and exp.failed == 0
    assert _all_spans(got[0])[0]["spanId"] == "1212121212121212"
    dead = torch_tel.OtlpSpanExporter(f"http://127.0.0.1:{port}/v1/traces", batch=1,
                                      timeout_s=2.0)
    dead.add({"kind": "slice", "t": 1.0, "seq": 0, "trace_id": _TID})
    assert (dead.sent, dead.failed) == (0, 1) and dead.last_error


def test_encode_spans_equal_across_packages(tmp_path):
    """`encode_spans` of the same streams gives equal JSON in both
    packages, filtered and not, anchored and re-anchored."""
    d = _golden_trace_dir(tmp_path)
    streams = torch_otlp._resolve_streams(str(d))
    assert streams == jax_otlp._resolve_streams(str(d))
    for kw in ({}, {"trace_id": _TID}, {"job": "j1"}, {"default_anchor": 5.0}):
        a = torch_otlp.encode_spans(streams, **kw)
        b = jax_otlp.encode_spans(streams, **kw)
        assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True), kw
    assert torch_tel.export_otlp(str(d)) == jax_tel.export_otlp(str(d))


_GRID = dict(nx=8, ny=8, nz=8, dimx=2, dimy=2, dimz=1, periodx=1)


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_scheduler_run_exports_one_span_tree_per_job(tmp_path, writer):
    """A real scheduler run of either package, two jobs submitted with
    their own `TraceContext`s: `export_otlp` of its directory gives one
    parent-connected span tree a job under the submitted context (the
    journal's events and the job's flight events), equal in both
    packages."""
    pkg = _PKGS[writer][0]
    svc = pkg.service
    dev = {"device_type": "cpu"} if pkg is tg else {}
    ctxs = {n: pkg.TraceContext.new() for n in ("a", "b")}
    with svc.MeshScheduler(policy="round_robin", flight_dir=str(tmp_path)) as s:
        for n, model in (("a", "diffusion3d"), ("b", "acoustic3d")):
            s.submit(svc.JobSpec(name=n, setup=svc.builtin_setup(model), nt=4,
                                 grid=dict(_GRID, **dev), run=pkg.RunSpec(nt_chunk=2)),
                     trace=ctxs[n])
        s.run()
    docs = [tel.export_otlp(str(tmp_path)) for tel in (torch_tel, jax_tel)]
    assert docs[0] == docs[1]
    spans = _all_spans(docs[0])
    for n, ctx in ctxs.items():
        mine = [s for s in spans if s["traceId"] == ctx.trace_id]
        ids = {s["spanId"] for s in mine}
        # every span's parent is in the tree or is the submitted root span
        assert all(s.get("parentSpanId") in ids | {ctx.span_id} for s in mine)
        names = {s["name"] for s in mine}
        assert {"job_submitted", "job_admitted", "slice", "chunk", "job_done"} <= names
        # the job's flight events hang off the job's root span
        assert all(s["parentSpanId"] == ctx.span_id for s in mine if s["name"] == "chunk")
    assert {s["traceId"] for s in spans} == {c.trace_id for c in ctxs.values()}
