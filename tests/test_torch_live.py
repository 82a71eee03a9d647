"""The port's live plane on the CPU, held against the JAX package's
(`tests/test_live.py`, every case but the CLI's, which waits for the port's
tools):

- `FlightTail`: incremental offsets and new files, a torn final line, a
  truncation and a sequence gap, a corrupt interior line;
- `LiveAggregate`: the derived signals (incremental equals one-shot), two
  processes' alignment and the straggler, a mid-stream attach, the
  scheduler journal and queue pressure;
- `AlertRule` / `AlertEngine` (every kind, hysteresis, wildcard fan-out,
  metric signals, ``igg_alerts_total``) and the sinks (control file, a
  webhook against a local endpoint the test owns, error containment);
- the metrics server's ``routes=`` error paths and chunked streaming.

Each synthetic case runs the same assertions on both packages' classes
(``live`` is the port's module or the JAX package's), so the two agree
exactly where the assertions are exact. The cross reads: both packages'
`LiveAggregate` over one flight directory written by a real scheduler run
of either package give equal snapshots (wall-clock fields aside), and the
same snapshot sequence fed to both `AlertEngine`s gives identical
transitions.
"""

import json
import os
import urllib.error
import urllib.request

import pytest

import implicitglobalgrid_tpu as igg
import implicitglobalgrid_tpu_torch as tg
from implicitglobalgrid_tpu.telemetry import live as jax_live
from implicitglobalgrid_tpu_torch.telemetry import live as torch_live
from implicitglobalgrid_tpu_torch.telemetry.server import MetricsServer

from torch_port_util import clean_torch_grid  # noqa: F401

pytestmark = pytest.mark.telemetry

_PKGS = {"torch": (tg, torch_live), "jax": (igg, jax_live)}


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


@pytest.fixture(params=["torch", "jax"])
def lib(request):
    """(package, its `telemetry.live` module)."""
    return _PKGS[request.param]


def _errors(pkg):
    return pkg.exceptions


# ---------------------------------------------------------------------------
# Synthetic streams (appendable — the tail's whole point)
# ---------------------------------------------------------------------------

class _Stream:
    """One flight JSONL written record by record, so tests control exactly
    what is on disk between polls."""

    def __init__(self, path, run_id, *, proc=0, wall0=5000.0, clock0=100.0):
        self.path = str(path)
        self.run = run_id
        self.proc = proc
        self.seq = 0
        self.t = clock0
        self.append("recorder_open", wall=wall0, version=1)

    def append(self, kind, *, dt=0.0, raw=None, seq=None, **kw):
        self.t += dt
        rec = {"t": self.t, "kind": kind, "run": self.run, "pid": 1,
               "proc": self.proc, "seq": self.seq if seq is None else seq, **kw}
        self.seq = rec["seq"] + 1
        with open(self.path, "a") as f:
            f.write((json.dumps(rec) if raw is None else raw) + "\n")
        return rec

    def chunk(self, c, *, n=4, exec_s=0.4, ok=True, dt=0.5, **kw):
        return self.append("chunk", dt=dt, chunk=c, step_begin=c * n,
                           step_end=(c + 1) * n, n=n, ok=ok, reasons=[],
                           build_s=0.01, exec_s=exec_s, **kw)


# ---------------------------------------------------------------------------
# FlightTail
# ---------------------------------------------------------------------------

def test_tail_incremental_offsets_and_new_files(tmp_path, lib):
    """Polls return only what was appended since the last poll, and a file
    created between polls joins the tail."""
    _, live = lib
    d = str(tmp_path)
    s = _Stream(os.path.join(d, "job_a.jsonl"), "a")
    s.append("run_begin", nt=8)
    tail = live.FlightTail(d)
    first = tail.poll()
    assert [e["kind"] for e in first] == ["recorder_open", "run_begin"]
    assert all(e["_file"].endswith("job_a.jsonl") for e in first)
    assert tail.poll() == []
    s.chunk(0)
    s2 = _Stream(os.path.join(d, "job_b.jsonl"), "b")
    more = tail.poll()
    assert {(e["run"], e["kind"]) for e in more} == {("a", "chunk"), ("b", "recorder_open")}
    assert tail.gaps == [] and tail.events_read == 4
    assert s2.seq == 1


def test_tail_torn_final_line_reread_next_poll(tmp_path, lib):
    """A torn final line is not consumed; the completed record arrives on a
    later poll intact, and no gap is recorded."""
    _, live = lib
    p = str(tmp_path / "job_a.jsonl")
    s = _Stream(p, "a")
    tail = live.FlightTail(p)
    assert len(tail.poll()) == 1
    rec = {"t": s.t + 1, "kind": "chunk", "run": "a", "pid": 1, "proc": 0, "seq": 1,
           "chunk": 0}
    line = json.dumps(rec)
    with open(p, "a") as f:
        f.write(line[:13])
    assert tail.poll() == [] and tail.gaps == []
    with open(p, "a") as f:
        f.write(line[13:] + "\n")
    evs = tail.poll()
    assert [e["seq"] for e in evs] == [1] and evs[0]["chunk"] == 0
    assert tail.gaps == []


def test_tail_truncation_and_seq_gap_are_observations(tmp_path, lib):
    """A shrunk file restarts from its head with a ``truncated`` gap; a
    sequence jump records a ``seq_gap``; neither raises."""
    _, live = lib
    p = str(tmp_path / "job_a.jsonl")
    s = _Stream(p, "a")
    s.chunk(0)
    tail = live.FlightTail(p)
    assert len(tail.poll()) == 2
    os.truncate(p, 0)
    s.seq = 0
    s.append("recorder_open", wall=6000.0)
    assert [e["kind"] for e in tail.poll()] == ["recorder_open"]
    assert [g["kind"] for g in tail.gaps] == ["truncated"]
    s.append("chunk", seq=3, chunk=3, n=4, ok=True, exec_s=0.1)
    assert [e["seq"] for e in tail.poll()] == [3]
    assert [g["kind"] for g in tail.gaps] == ["truncated", "seq_gap"]
    assert tail.gaps[-1] == {"file": p, "run": "a", "proc": 0, "kind": "seq_gap",
                             "expected": 1, "got": 3, "t": tail.gaps[-1]["t"]}


def test_tail_corrupt_interior_skips_file_not_tail(tmp_path, lib):
    """Interior corruption records one ``corrupt`` gap and skips that file
    to its end; the other streams are unaffected and the bad file resumes
    from later appends."""
    _, live = lib
    d = str(tmp_path)
    s = _Stream(os.path.join(d, "job_a.jsonl"), "a")
    with open(s.path, "a") as f:
        f.write("{not json}\n")
    s.append("chunk", chunk=0, n=4, ok=True, exec_s=0.1)
    b = _Stream(os.path.join(d, "job_b.jsonl"), "b")
    tail = live.FlightTail(d)
    assert {e["run"] for e in tail.poll()} == {"b"}
    assert [g["kind"] for g in tail.gaps] == ["corrupt"]
    s.append("chunk", chunk=1, n=4, ok=True, exec_s=0.1)
    assert [(e["run"], e["chunk"]) for e in tail.poll()] == [("a", 1)]
    assert b.seq == 1


# ---------------------------------------------------------------------------
# LiveAggregate: derived signals
# ---------------------------------------------------------------------------

def _single_run_ops(path):
    s = _Stream(path, "a")
    ops = [lambda: s.append("run_begin", nt=32, nt_chunk=4)]
    for c in range(6):
        ex = 0.4 if c < 5 else 4.0   # the last chunk is 10x slower
        ops.append(lambda c=c, ex=ex: s.chunk(c, exec_s=ex))
    ops += [
        lambda: s.append("checkpoint_save", op="save", dur_s=0.2),
        lambda: s.append("snapshot_write", step=20, nbytes=1000, queue_depth=2,
                         dur_s=0.01, dt=1.0),
        lambda: s.append("snapshot_write", step=24, nbytes=3000, queue_depth=1,
                         dur_s=0.01, dt=1.0),
        lambda: s.append("snapshot_drop", step=28, queue_depth=4),
        lambda: s.append("deadline_slack", step=24, slack_s=3.5, budget_s=10.0,
                         priced_step_s=0.1, priced_by="measured", remaining_steps=8),
        lambda: s.append("run_end", completed=32, chunks=6),
    ]
    return ops


def test_live_aggregate_derived_signals_and_incremental_equivalence(tmp_path, lib):
    """The rolling per-job signals polled after every append match the
    one-shot read of the finished file."""
    _, live = lib
    inc = live.LiveAggregate(str(tmp_path / "inc.jsonl"), window=8, min_samples=4)
    for op in _single_run_ops(str(tmp_path / "inc.jsonl")):
        op()
        inc.poll()
    snap = inc.snapshot()
    oneshot = live.LiveAggregate(str(tmp_path / "one.jsonl"), window=8, min_samples=4)
    for op in _single_run_ops(str(tmp_path / "one.jsonl")):
        op()
    oneshot.poll()

    j = snap["jobs"]["a"]
    assert j["state"] == "done" and j["nt"] == 32
    assert j["chunks"] == 6 and j["step"] == 24
    assert j["step_s_last"] == pytest.approx(1.0)
    assert j["step_s_p50"] == pytest.approx(0.1)
    assert j["step_s_p90"] == pytest.approx(1.0)
    assert j["z"] is not None and j["z"] > 10
    assert j["deadline_slack_s"] == 3.5 and j["deadline_budget_s"] == 10
    assert j["checkpoint_s"] == pytest.approx(0.2)
    assert j["snapshot_drops"] == 1 and j["snapshot_queue_depth"] == 4
    assert j["snapshot_bytes_total"] == 4000
    assert j["snapshot_bytes_rate"] == pytest.approx(3000.0)
    assert snap["cursor"] == 13
    s2 = oneshot.snapshot()
    for k in ("jobs", "procs", "queue", "gaps"):
        assert snap[k] == s2[k], k
    evs, cur = inc.events_since(5)
    assert [e["live_seq"] for e in evs] == list(range(6, 14))
    assert cur == 13
    assert inc.events_since(cur) == ([], cur)


def test_live_aggregate_two_proc_alignment_and_straggler(tmp_path, lib):
    """Two processes with different monotonic origins and a known wall
    skew merge onto one clock, and the barrier-spread window names the
    persistent straggler (proc 1)."""
    _, live = lib
    d = str(tmp_path)
    a = _Stream(os.path.join(d, "flight_p0.jsonl"), "r", proc=0, wall0=5000.0, clock0=1000.0)
    b = _Stream(os.path.join(d, "flight_p1.jsonl"), "r", proc=1, wall0=5000.25,
                clock0=987654.0)
    agg = live.LiveAggregate(d, straggler_window=4)
    for c in range(5):
        a.chunk(c, dt=0.55, exec_s=0.55)
        b.chunk(c, dt=0.55, exec_s=0.50)
        agg.poll()
    snap = agg.snapshot()
    assert snap["gaps"] == []
    assert snap["align"]["r"]["anchor_proc"] == 0
    assert snap["procs"][1]["slowest_share"] > 0.6
    assert snap["procs"][0]["slowest_share"] < 0.5
    evs, _ = agg.events_since(None)
    ts = [e["t"] for e in evs]
    assert ts == sorted(ts)


def test_live_aggregate_mid_stream_attach_degrades_not_raises(tmp_path, lib):
    """Attaching to a stream that lost its head (no ``recorder_open``
    anchor) still tails, through the shift-only fallback."""
    _, live = lib
    p = str(tmp_path / "job_a.jsonl")
    s = _Stream(p, "a")
    for c in range(3):
        s.chunk(c)
    with open(p) as f:
        lines = f.readlines()
    with open(p, "w") as f:
        f.writelines(lines[2:])
    agg = live.LiveAggregate(p)
    assert [e["kind"] for e in agg.poll()] == ["chunk", "chunk"]
    assert agg.snapshot()["jobs"]["a"]["chunks"] == 2
    s.chunk(3)
    assert [e["chunk"] for e in agg.poll()] == [3]


def test_live_aggregate_scheduler_journal_and_queue_pressure(tmp_path, lib):
    """The scheduler journal drives job states, slice counts, slack mirrors
    and alert records; a `DirectoryBackend` adds the queue pressure."""
    pkg, live = lib
    d = str(tmp_path)
    backend = pkg.service.DirectoryBackend(d)
    backend.submit({"name": "queued1", "model": "diffusion3d", "nt": 4})
    s = _Stream(os.path.join(d, "scheduler.jsonl"), "scheduler")
    s.append("scheduler_start", policy="fifo")
    s.append("job_submitted", job="a", nt=8, priority=1)
    s.append("job_admitted", job="a")
    s.append("slice", job="a", slice=0, step=4, dur_s=0.4, wait_s=0.0, policy="fifo",
             slack_s=2.5)
    for state in ("firing", "resolved"):
        s.append("alert", rule="guard_trip_storm", severity="critical", state=state,
                 job="a", signal="jobs.*.guard_trips", value=1.0, threshold=1.0)
    s.append("job_done", job="a")
    agg = live.LiveAggregate(d, backend=backend)
    agg.poll()
    snap = agg.snapshot()
    j = snap["jobs"]["a"]
    assert j["state"] == "done" and j["slices"] == 1
    assert j["step"] == 4 and j["deadline_slack_s"] == 2.5
    assert snap["scheduler"]["slices"] == 1
    assert snap["queue"]["pending"] == 1 and snap["queue"]["oldest_age_s"] >= 0
    assert snap["alerts"]["active"] == []
    assert [a["state"] for a in snap["alerts"]["recent"]] == ["firing", "resolved"]


# ---------------------------------------------------------------------------
# AlertRule / AlertEngine
# ---------------------------------------------------------------------------

def test_alert_rule_validation(lib):
    pkg, live = lib
    err = _errors(pkg).InvalidArgumentError
    with pytest.raises(err, match="kind"):
        live.AlertRule("r", "jobs.*.z", kind="nope")
    with pytest.raises(err, match="op"):
        live.AlertRule("r", "jobs.*.z", op="~")
    with pytest.raises(err, match="wildcard"):
        live.AlertRule("r", "jobs.*.sub.*.z")
    with pytest.raises(err, match="name"):
        live.AlertRule("", "jobs.*.z")
    with pytest.raises(err, match=">= 1"):
        live.AlertRule("r", "jobs.*.z", for_count=0)
    with pytest.raises(err, match="duplicate"):
        live.AlertEngine([live.AlertRule("r", "a"), live.AlertRule("r", "b")])
    with pytest.raises(err, match="AlertRule"):
        live.AlertEngine(["not a rule"])
    pack = live.default_rule_pack()
    assert len(pack) == 6 and len({r.name for r in pack}) == 6


def test_default_rule_packs_equal():
    """Both packages ship the same six rules, field for field."""
    def rows(live):
        return [dict(vars(r)) if not hasattr(r, "__dataclass_fields__")
                else {f: getattr(r, f) for f in r.__dataclass_fields__}
                for r in live.default_rule_pack()]

    assert rows(torch_live) == rows(jax_live)


def _snap(t, **jobs):
    return {"t": t, "jobs": jobs, "procs": {}, "queue": {}, "scheduler": {}}


def test_threshold_hysteresis_fire_and_resolve(lib):
    """for_count consecutive breaches fire; resolve_count consecutive clears
    resolve; flapping below either count transitions nothing."""
    _, live = lib
    eng = live.AlertEngine([live.AlertRule("hot", "jobs.*.z", op=">", threshold=3.0,
                                           for_count=2, resolve_count=2)])
    assert eng.evaluate(_snap(1, a={"z": 5.0})) == []
    trs = eng.evaluate(_snap(2, a={"z": 6.0}))
    assert [(t["state"], t["job"]) for t in trs] == [("firing", "a")]
    assert eng.active()[0]["rule"] == "hot"
    assert eng.evaluate(_snap(3, a={"z": 1.0})) == []
    assert eng.evaluate(_snap(4, a={"z": 9.0})) == []
    assert eng.evaluate(_snap(5, a={"z": 0.0})) == []
    assert [t["state"] for t in eng.evaluate(_snap(6, a={"z": 0.0}))] == ["resolved"]
    assert eng.active() == []
    assert eng.evaluate(_snap(7)) == []
    assert eng.transitions == 2 and eng.evaluations == 7


def test_rate_burn_rate_zscore_and_metric_signals(lib):
    pkg, live = lib
    reg = pkg.metrics_registry()
    eng = live.AlertEngine([
        live.AlertRule("trips", "jobs.*.guard_trips", kind="rate", threshold=1.0, window=4),
        live.AlertRule("slack", "jobs.*.deadline_slack_s", kind="burn_rate", horizon_s=60.0),
        live.AlertRule("ckpt", "jobs.*.checkpoint_s", kind="zscore", threshold=4.0,
                       min_samples=3),
        live.AlertRule("metric", "metric:igg_live_test_total", kind="threshold", op=">=",
                       threshold=2.0),
    ], registry=reg)
    c = reg.counter("igg_live_test_total", "t", ("k",))

    def ev(t, trips, slack, ck):
        return eng.evaluate(_snap(t, a={"guard_trips": trips, "deadline_slack_s": slack,
                                        "checkpoint_s": ck}))

    for t in range(1, 5):
        assert ev(t, 0, 1e4, 0.2) == []
    assert [t["rule"] for t in ev(5, 1, 1e4, 0.2)] == ["trips"]
    trs = ev(6, 1, 50.0, 0.2)
    assert [t["rule"] for t in trs] == ["slack"]
    assert trs[0]["severity"] == "warning" and trs[0]["job"] == "a"
    assert [t["rule"] for t in ev(7, 1, 30.0, 2.5)] == ["ckpt"]
    c.inc(1, k="x")
    c.inc(1, k="y")
    trs = eng.evaluate(_snap(8))
    assert [t["rule"] for t in trs] == ["metric"] and trs[0]["job"] is None
    counted = {lbl["rule"]: v for lbl, v in reg.get("igg_alerts_total").samples()}
    assert counted == {"trips": 1, "slack": 1, "ckpt": 1, "metric": 1}


def test_burn_rate_fires_immediately_on_negative_slack(lib):
    _, live = lib
    eng = live.AlertEngine([live.AlertRule("slack", "jobs.*.deadline_slack_s",
                                           kind="burn_rate")])
    trs = eng.evaluate(_snap(1, a={"deadline_slack_s": -0.5}))
    assert [(t["rule"], t["state"]) for t in trs] == [("slack", "firing")]


def test_wildcard_fanout_is_per_job_state(lib):
    """One rule, independent state machines per wildcard match."""
    _, live = lib
    eng = live.AlertEngine([live.AlertRule("hot", "jobs.*.z", threshold=3.0)])
    trs = eng.evaluate(_snap(1, a={"z": 0.1}, b={"z": 9.0}))
    assert [(t["job"], t["state"]) for t in trs] == [("b", "firing")]
    trs = eng.evaluate(_snap(2, a={"z": 9.0}, b={"z": 9.0}))
    assert [(t["job"], t["state"]) for t in trs] == [("a", "firing")]
    assert {a["job"] for a in eng.active()} == {"a", "b"}


def test_engine_journals_transitions_and_contains_sink_errors(lib):
    """Transitions reach the journal as ``alert`` events; a raising sink is
    counted, journaled once, and never propagates."""
    _, live = lib
    journaled = []

    def journal(kind, **fields):
        journaled.append({"kind": kind, **fields})

    def bad_sink(tr):
        raise RuntimeError("boom")

    good = []
    eng = live.AlertEngine([live.AlertRule("hot", "jobs.*.z", threshold=3.0)],
                           sinks=(bad_sink, good.append), journal=journal)
    eng.evaluate(_snap(1, a={"z": 9.0}))
    eng.evaluate(_snap(2, b={"z": 9.0}))
    alerts = [e for e in journaled if e["kind"] == "alert"]
    assert [(e["rule"], e["job"], e["state"]) for e in alerts] == [
        ("hot", "a", "firing"), ("hot", "b", "firing")]
    assert "t" not in alerts[0]
    errs = [e for e in journaled if e["kind"] == "alert_sink_error"]
    assert len(errs) == 1 and "boom" in errs[0]["error"]
    assert eng.sink_errors == 2
    assert [tr["job"] for tr in good] == ["a", "b"]


def test_alert_engines_give_identical_transitions():
    """The same snapshot sequence fed to both packages' engines (the default
    rule pack plus every rule kind) gives identical transitions, journal
    records and sink deliveries."""
    def engine(live, pkg):
        got = {"journal": [], "sink": []}
        rules = live.default_rule_pack() + [
            live.AlertRule("hot", "jobs.*.z", threshold=3.0, for_count=2, resolve_count=2),
            live.AlertRule("trips_rate", "jobs.*.guard_trips", kind="rate", threshold=1.0,
                           window=3),
            live.AlertRule("ck_z", "jobs.*.checkpoint_s", kind="zscore", threshold=4.0,
                           min_samples=3),
        ]
        eng = live.AlertEngine(rules, sinks=(got["sink"].append,),
                               journal=lambda kind, **f: got["journal"].append((kind, f)),
                               registry=pkg.metrics_registry())
        return eng, got

    seq = []
    for t in range(1, 16):
        seq.append({
            "t": 1000.0 + t, "procs": {}, "scheduler": {"slices": t, "draining": False},
            "queue": {"queued": t % 3, "running": 2},
            "jobs": {
                "a": {"state": "running", "z": 5.0 if 3 <= t <= 6 else 0.5,
                      "guard_trips": t // 5, "checkpoint_s": 0.2 if t < 12 else 3.0,
                      "deadline_slack_s": 100.0 - 9.0 * t, "perf_regressions": t // 7,
                      "snapshot_queue_depth": t % 5},
                "b": {"state": "running", "z": 0.1, "guard_trips": 0,
                      "checkpoint_s": 0.3, "deadline_slack_s": None},
            }})
    (et, gt), (ej, gj) = engine(torch_live, tg), engine(jax_live, igg)
    trs_t = [et.evaluate(json.loads(json.dumps(s))) for s in seq]
    trs_j = [ej.evaluate(json.loads(json.dumps(s))) for s in seq]
    assert trs_t == trs_j
    assert sum(map(len, trs_t)) >= 5
    assert gt == gj
    assert et.active() == ej.active()
    assert (et.transitions, et.evaluations) == (ej.transitions, ej.evaluations)


def test_default_pack_clocked_rules_fire_identically():
    """The default pack's four rules on wall-clock readings (a checkpoint
    seconds z-score, a perf-regression streak, a deadline-slack burn and a
    persistent straggler) each fire, and resolve where their signal
    recovers, with identical transitions in both packages' engines."""
    seq = []
    for t in range(1, 15):
        seq.append({
            "t": 2000.0 + t, "scheduler": {}, "queue": {},
            "procs": {"0": {"slowest_share": 0.2},
                      "1": {"slowest_share": 0.9 if 4 <= t <= 7 else 0.1}},
            "jobs": {"a": {"state": "running", "checkpoint_s": 2.5 if t == 9 else 0.2,
                           "perf_regressions": 0 if t < 6 else 4,
                           "deadline_slack_s": 1e4 if t < 11 else -1.0}}})

    def run(live):
        eng = live.AlertEngine(live.default_rule_pack())
        return [[(tr["rule"], tr["state"], tr["job"]) for tr in
                 eng.evaluate(json.loads(json.dumps(s)))] for s in seq]

    got_t, got_j = run(torch_live), run(jax_live)
    assert got_t == got_j
    fired = {rule for trs in got_t for rule, state, _ in trs if state == "firing"}
    assert fired == {"checkpoint_latency_blowout", "perf_regression_streak",
                     "deadline_slack_burn", "persistent_straggler"}


def test_control_file_sink_files_cancel_once(tmp_path, lib):
    pkg, live = lib
    err = _errors(pkg).InvalidArgumentError
    backend = pkg.service.DirectoryBackend(str(tmp_path))
    sink = live.ControlFileSink(backend, rules=("deadline_slack_burn",))
    fire = {"rule": "deadline_slack_burn", "state": "firing", "job": "a"}
    sink(fire)
    sink(fire)
    sink(dict(fire, rule="other_rule"))
    sink(dict(fire, state="resolved"))
    sink(dict(fire, job=None))
    assert sink.filed == [{"rule": "deadline_slack_burn", "job": "a", "action": "cancel"}]
    assert backend.poll_control() == [{"request": "cancel", "job": "a"}]
    with pytest.raises(err, match="resize"):
        live.ControlFileSink(backend, action="resize")
    with pytest.raises(err, match="action"):
        live.ControlFileSink(backend, action="nuke")


def test_control_file_sink_read_across(tmp_path):
    """A control file one package's sink files is consumed by the other
    package's backend, both ways."""
    for writer, reader in (("torch", "jax"), ("jax", "torch")):
        (wpkg, wlive), (rpkg, _) = _PKGS[writer], _PKGS[reader]
        d = str(tmp_path / writer)
        sink = wlive.ControlFileSink(wpkg.service.DirectoryBackend(d))
        sink({"rule": "guard_trip_storm", "state": "firing", "job": "x"})
        got = rpkg.service.DirectoryBackend(d).poll_control()
        assert [(r["request"], r["job"]) for r in got] == [("cancel", "x")]


def test_webhook_sink_posts_and_swallows_errors(lib):
    """Delivery to a local endpoint the test owns (a `MetricsServer` route);
    an unknown route is swallowed and counted."""
    _, live = lib
    seen = []

    def routes(method, path, query, body):
        if method == "POST" and path == "/hook":
            seen.append(json.loads(body))
            return 200, b"{}", "application/json"
        return None

    with MetricsServer(0, routes=routes) as srv:
        sink = live.WebhookSink(f"http://127.0.0.1:{srv.port}/hook")
        sink({"rule": "hot", "state": "firing", "job": "a"})
        assert sink.delivered == 1 and sink.errors == 0
        assert seen == [{"rule": "hot", "state": "firing", "job": "a"}]
        bad = live.WebhookSink(f"http://127.0.0.1:{srv.port}/nope", timeout_s=2.0)
        bad({"rule": "hot", "state": "firing"})
        assert (bad.delivered, bad.errors) == (0, 1)
        assert "404" in bad.last_error


# ---------------------------------------------------------------------------
# MetricsServer routes=: error paths + chunked streaming
# ---------------------------------------------------------------------------

def _get(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read(), dict(r.headers)


def test_routes_error_paths_500_404_and_server_survives():
    """A raising handler answers a JSON 500 and the server survives; an
    unowned path answers a JSON 404; a standalone routed server never
    touches the refcounted process server."""
    def routes(method, path, query, body):
        if path == "/boom":
            raise RuntimeError("handler bug")
        if path == "/ok":
            return 200, b'{"ok": true}', "application/json"
        return None

    assert tg.metrics_server() is None
    with MetricsServer(0, routes=routes) as srv:
        u = f"http://127.0.0.1:{srv.port}"
        with pytest.raises(urllib.error.HTTPError) as exc:
            _get(u + "/boom")
        assert exc.value.code == 500
        assert "RuntimeError" in json.loads(exc.value.read())["error"]
        with pytest.raises(urllib.error.HTTPError) as exc:
            _get(u + "/unknown")
        assert exc.value.code == 404
        assert "no route" in json.loads(exc.value.read())["error"]
        status, body, _ = _get(u + "/ok")
        assert (status, json.loads(body)) == (200, {"ok": True})
        assert _get(u + "/metrics")[0] == 200
        assert tg.metrics_server() is None
    tg.stop_metrics_server()


def test_routes_iterator_payload_streams_chunked():
    """A route returning a bytes iterator streams as chunked transfer."""
    def routes(method, path, query, body):
        if path == "/stream":
            return 200, (f"line {i}\n".encode() for i in range(5)), "application/x-ndjson"
        return None

    with MetricsServer(0, routes=routes) as srv:
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/stream", timeout=10) as r:
            assert r.status == 200
            assert r.headers.get("Transfer-Encoding") == "chunked"
            assert r.headers.get("Content-Length") is None
            lines = [ln.decode().strip() for ln in r]
    assert lines == [f"line {i}" for i in range(5)]


# ---------------------------------------------------------------------------
# Cross reads of real scheduler directories
# ---------------------------------------------------------------------------

_GRID = dict(nx=8, ny=8, nz=8, dimx=2, dimy=2, dimz=2, periodx=1)


def _scheduler_dir(pkg, d, device_kw):
    """A real scheduler run of ``pkg`` into flight directory ``d``: two
    tenants (diffusion with a NaN poke that trips the guard, acoustic),
    the default alert rules, one traced job."""
    svc = pkg.service
    rs = pkg.RunSpec
    poke = pkg.NaNPoke(step=6, name="T", index=(4, 4, 4))
    trace = pkg.TraceContext.parse("00-" + "4b" * 16 + "-" + "00f067aa0ba902b7" + "-01")
    with svc.MeshScheduler(policy="round_robin", flight_dir=d, alerts=True) as s:
        s.submit(svc.JobSpec(name="diff", setup=svc.builtin_setup("diffusion3d"), nt=12,
                             grid=dict(_GRID, **device_kw),
                             run=rs(nt_chunk=4, checkpoint_every=1,
                                    checkpoint_dir=os.path.join(d, "ck"), faults=[poke])),
                 trace=trace)
        s.submit(svc.JobSpec(name="wave", setup=svc.builtin_setup("acoustic3d"), nt=8,
                             grid=dict(_GRID, **device_kw), run=rs(nt_chunk=4)))
        s.run()
        assert s.status()["states"] == {"done": 2}
    return d


@pytest.fixture(scope="module")
def sched_dirs(tmp_path_factory):
    """One scheduler directory written by each package (module scope: each
    run costs about a second)."""
    root = tmp_path_factory.mktemp("live_dirs")
    try:
        out = {"jax": _scheduler_dir(igg, str(root / "jax"), {}),
               "torch": _scheduler_dir(tg, str(root / "torch"), {"device_type": "cpu"})}
    finally:
        for pkg in (tg, igg):
            pkg.stop_flight_recorder()
            pkg.reset_metrics()
    return out


def _strip_clock(snap):
    """A snapshot without the fields read off the wall clock at poll or
    snapshot time."""
    snap = json.loads(json.dumps(snap))
    snap.pop("t")
    snap["tail"].pop("lag_s")
    for g in snap["gaps"]:
        g.pop("t", None)
    snap["queue"].pop("oldest_age_s", None)
    return snap


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_live_aggregate_cross_reads_scheduler_dirs(sched_dirs, writer):
    """Both packages' `LiveAggregate` over one scheduler directory (written
    by ``writer``) give equal snapshots, incrementally and in one shot,
    and equal merged feeds; the snapshot holds both jobs done, the guard
    trip and the alert the scheduler journaled."""
    d = sched_dirs[writer]
    snaps, feeds = [], []
    for live in (torch_live, jax_live):
        agg = live.LiveAggregate(d)
        agg.poll()
        snaps.append(_strip_clock(agg.snapshot()))
        feeds.append(agg.events_since(None))
    assert snaps[0] == snaps[1]
    assert feeds[0] == feeds[1]
    jobs = snaps[0]["jobs"]
    assert {k: jobs[k]["state"] for k in ("diff", "wave")} == {"diff": "done",
                                                                 "wave": "done"}
    assert jobs["diff"]["guard_trips"] >= 1 and jobs["wave"]["guard_trips"] == 0
    assert snaps[0]["scheduler"]["slices"] == sum(jobs[k]["slices"] for k in ("diff", "wave"))
    rules = {(a["rule"], a["job"], a["state"]) for a in snaps[0]["alerts"]["recent"]}
    assert ("guard_trip_storm", "diff", "firing") in rules


def test_scheduler_dirs_agree_across_packages(sched_dirs):
    """The same jobs in both packages give the same live picture: job
    states, steps, chunks, slices, guard trips and the alert transitions."""
    def picture(d):
        agg = torch_live.LiveAggregate(d)
        agg.poll()
        snap = agg.snapshot()
        jobs = {n: {k: snap["jobs"][n].get(k)
                    for k in ("state", "step", "nt", "chunks", "slices", "guard_trips")}
                for n in ("diff", "wave")}
        alerts = [(a["rule"], a["job"], a["state"]) for a in snap["alerts"]["recent"]]
        return jobs, alerts, snap["scheduler"]["slices"]

    assert picture(sched_dirs["torch"]) == picture(sched_dirs["jax"])
