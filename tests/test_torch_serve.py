"""The port's serving tier on the CPU, held against the JAX package's
(`tests/test_serve.py`'s tier-1 cases, the port's grids on
``device_type="cpu"`` at 6³ blocks):

- the queue backend's two-owner claim partition (also one port owner and
  one JAX owner over one directory) and its control protocol;
- the block LRU's eviction and stats; the reader's refusal of staging and
  torn directories;
- the HTTP end-to-end run: three jobs POSTed to the port's `JobApiServer`
  under a live port `MeshScheduler` (one snapshotting and bitwise its
  CLI-submitted twin, one resized and one cancelled over HTTP), then a
  sub-box read of the committed snapshot through `SnapshotQueryServer`
  byte-identical to `read_global`, the second read from the LRU;
- deadline rejection and unpriceable admission; two schedulers on one
  backend; the job API's and the query server's validation; the observe
  snapshot and the resumable event stream; alerts whose sink cancels a job;
  one ``traceparent`` from the HTTP submit to the OTLP span tree; the API
  token;
- across packages: a job record one package's `JobApiServer` wrote runs
  under the other package's scheduler, and the writer's API reports it from
  the other's journal; a snapshot either package wrote is served
  byte-identical by both query servers; both `ObservePlane`s give the same
  snapshot and feed of one scheduler directory (wall-clock fields aside).

Gathered data compare bitwise within a package; across packages the final
states are within the JAX suite's float64 run bound (1e-12).
"""

import io
import json
import os
import shutil
import urllib.error
import urllib.request

import numpy as np
import pytest

import implicitglobalgrid_tpu as igg
import implicitglobalgrid_tpu_torch as tg
from implicitglobalgrid_tpu_torch.parallel import topology as ttop
from implicitglobalgrid_tpu_torch.serve import (
    BlockCache, CachedSnapshot, JobApiServer, ObserveServer, SnapshotQueryServer,
)
from implicitglobalgrid_tpu_torch.service import (
    DirectoryBackend, JobSpec, JobState, MeshScheduler, QueueBackend, builtin_setup,
    jobspec_from_json,
)
from implicitglobalgrid_tpu_torch.utils.exceptions import (
    IncoherentArgumentError, InvalidArgumentError,
)

from torch_port_util import clean_torch_grid, to_np  # noqa: F401

pytestmark = pytest.mark.serve

GRID_A = dict(nx=6, ny=6, nz=6, dimx=2, dimy=2, dimz=1)
CPU = {"device_type": "cpu"}
TOL64 = dict(rtol=1e-12, atol=1e-12)


@pytest.fixture(autouse=True)
def _clean_service():
    for pkg in (tg, igg):
        pkg.stop_flight_recorder()
        while pkg.metrics_server() is not None:
            pkg.stop_metrics_server()
        pkg.reset_metrics()
    ttop._retained_epochs.clear()
    yield
    ttop._retained_epochs.clear()
    for pkg in (tg, igg):
        pkg.stop_flight_recorder()
        while pkg.metrics_server() is not None:
            pkg.stop_metrics_server()


def _record(name, nt=8, nt_chunk=4, dev=CPU, **extra):
    """One queue-JSON job record (the schema of ``tools jobs submit`` and
    ``POST /v1/jobs``), float64 so interiors compare bitwise; ``dev`` is
    the port's CPU grid, ``{}`` for a JAX consumer."""
    rec = {"name": name, "model": "diffusion3d", "nt": nt,
           "grid": dict(GRID_A, **dev), "dtype": "float64",
           "run": {"nt_chunk": nt_chunk}}
    rec.update(extra)
    return rec


def _interior(sched, name, pkg=tg):
    """Gathered interior of a finished job's result, under ITS grid."""
    top = ttop if pkg is tg else igg.parallel.topology
    job = sched.job(name)
    prev = top.swap_global_grid(job.gg)
    try:
        out = pkg.gather_interior(job.result["T"])
    finally:
        top.swap_global_grid(prev)
    return np.asarray(out)


_TWIN: dict = {}


def _twin_interior(tmp_path, nt=8, nt_chunk=4):
    """The CLI-submitted twin: the same record through `jobspec_from_json`
    and a solo port scheduler (the ``tools jobs submit`` code path)."""
    key = (nt, nt_chunk)
    if key not in _TWIN:
        with MeshScheduler(flight_dir=str(tmp_path / "twin")) as sched:
            sched.submit(jobspec_from_json(_record("twin", nt, nt_chunk)))
            sched.run()
            assert sched.job("twin").state == JobState.DONE
            _TWIN[key] = _interior(sched, "twin")
    return _TWIN[key]


def _health():
    fam = tg.metrics_registry().get("igg_health_events_total")
    return {} if fam is None else {lbl["kind"]: int(v) for lbl, v in fam.samples()}


def _get(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read(), dict(r.headers)


def _post(url, payload=None, timeout=10, headers=None):
    body = b"" if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=body, method="POST", headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get_code(url, token=None):
    req = urllib.request.Request(url)
    if token is not None:
        req.add_header("Authorization", f"Bearer {token}")
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


# ---------------------------------------------------------------------------
# Exports, queue backend, block cache, reader coherence
# ---------------------------------------------------------------------------

def test_public_api_exports():
    for sym in ("serve", "JobApiServer", "SnapshotQueryServer", "BlockCache",
                "CachedSnapshot", "ObservePlane", "ObserveServer"):
        assert hasattr(tg, sym) and sym in tg.__all__, sym
    assert sorted(tg.serve.__all__) == sorted(igg.serve.__all__)
    assert sorted(set(igg.__all__) - set(tg.__all__)) == ["sharding_of"]


@pytest.mark.parametrize("second", ["torch", "jax"])
def test_two_owner_claim_partition_no_double_admission(tmp_path, second):
    """Two consumers over ONE directory (the second a port or a JAX
    backend): every record claimed by exactly one owner, none twice, none
    lost, across 20 jobs."""
    b1 = DirectoryBackend(tmp_path, owner="s1")
    b2 = (DirectoryBackend if second == "torch" else igg.service.DirectoryBackend)(
        tmp_path, owner="s2")
    names = [f"job{i:02d}" for i in range(20)]
    for n in names:
        b1.submit(_record(n))
    assert b2.pending() == sorted(names)
    with pytest.raises((InvalidArgumentError, igg.exceptions.InvalidArgumentError),
                       match="already enqueued"):
        b2.submit(_record(names[0]))
    claims = {"s1": [], "s2": []}
    backends = [("s1", b1), ("s2", b2)]
    i = 0
    while True:
        owner, b = backends[i % 2]
        i += 1
        got = b.claim()
        if got is None:
            if all(b.claim() is None for _, b in backends):
                break
            continue
        assert got["record"]["name"] == got["name"]
        claims[owner].append(got["name"])
    assert not set(claims["s1"]) & set(claims["s2"])
    assert sorted(claims["s1"] + claims["s2"]) == sorted(names)
    assert claims["s1"] and claims["s2"]
    assert b1.discard(names[0]) is False
    b1.submit(_record("late"))
    assert b2.discard("late") is True
    assert b1.pending() == []


def test_backend_control_protocol_roundtrip(tmp_path):
    b = DirectoryBackend(tmp_path)
    b.control("cancel", "a")
    b.control("drain")
    b.control("resize", "b", {"new_dims": [1, 2, 2], "via": "auto"})
    (tmp_path / "control" / "resize_torn").write_text("{not json")
    (tmp_path / "control" / "resize_staged.tmp").write_text("{}")
    reqs = DirectoryBackend(tmp_path).poll_control()
    assert {r["request"] for r in reqs} == {"drain", "cancel", "resize"}
    by = {(r["request"], r.get("job")): r for r in reqs}
    assert by[("resize", "b")]["payload"] == {"new_dims": [1, 2, 2], "via": "auto"}
    assert by[("resize", "torn")]["payload"] is None
    assert ("resize", "staged") not in by
    assert b.poll_control() == []
    with pytest.raises(InvalidArgumentError, match="payload"):
        b.control("resize", "x")
    with pytest.raises(InvalidArgumentError, match="Unknown control"):
        b.control("pause", "x")
    with pytest.raises(InvalidArgumentError, match="QueueBackend"):
        MeshScheduler(queue="nope")
    assert isinstance(b, QueueBackend)


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_block_cache_lru_eviction_and_stats(pkg):
    """The same operations give the same stats in both packages' caches."""
    cls = BlockCache if pkg == "torch" else igg.BlockCache
    blk = lambda: np.zeros(128, dtype=np.float64)  # noqa: E731 (1 KiB)
    c = cls(max_bytes=3 * 1024)
    for k in ("a", "b", "c"):
        assert c.get(k) is None
        c.put(k, blk())
    assert c.get("a") is not None
    c.put("d", blk())
    assert c.get("b") is None and c.get("a") is not None
    st = c.stats()
    assert st == {"entries": 3, "bytes": 3 * 1024, "max_bytes": 3 * 1024, "hits": 2,
                  "misses": 4, "evictions": 1}
    c.put("huge", np.zeros(4096, dtype=np.float64))
    assert c.get("huge") is None and c.stats()["entries"] == 3
    c.clear()
    assert c.stats()["entries"] == 0 and c.stats()["bytes"] == 0


def test_block_cache_validation():
    with pytest.raises(InvalidArgumentError, match="positive"):
        BlockCache(0)
    with pytest.raises(InvalidArgumentError, match="BlockCache"):
        CachedSnapshot("/nonexistent", cache="nope")


def test_reader_refuses_staging_and_torn_snapshot_dirs(tmp_path):
    tg.init_global_grid(**GRID_A, **CPU, quiet=True)
    T = tg.zeros_g()
    root = tmp_path / "snaps"
    tg.write_snapshot(str(root), step=1, state={"T": T})
    step, path = tg.list_snapshots(str(root))[0]
    stage = root / "step_0000000007.tmp-deadbeef"
    shutil.copytree(path, stage)
    with pytest.raises(IncoherentArgumentError, match="staging"):
        tg.open_snapshot(str(stage))
    assert [s for s, _ in tg.list_snapshots(str(root))] == [1]
    torn = root / "step_0000000009"
    shutil.copytree(path, torn)
    (torn / "meta.npz").write_bytes(b"PK\x03\x04 truncated")
    (torn / "meta.npz.sha256").unlink()
    with pytest.raises(IncoherentArgumentError, match="half-committed"):
        tg.open_snapshot(str(torn))
    # the query server lists the torn entry with its error, not a 500
    with SnapshotQueryServer(str(root)) as q:
        _, body, _ = _get(f"http://{q.host}:{q.port}/v1/snapshots")
    snaps = json.loads(body)["snapshots"]
    assert [s["step"] for s in snaps] == [1, 9]
    assert "fields" in snaps[0] and "half-committed" in snaps[1]["error"]


# ---------------------------------------------------------------------------
# HTTP submit -> live scheduler -> HTTP control -> bitwise -> query + LRU
# ---------------------------------------------------------------------------

def test_http_job_e2e_bit_identical_with_query_service(tmp_path):
    """Three jobs POSTed to the port's job API run under a live port
    scheduler polling the same backend: h1 (snapshotting) ends bitwise its
    CLI-submitted twin, h2 is resized over HTTP, h3 cancelled over HTTP
    mid-run; then the query server answers a sub-box of h1's snapshot
    byte-identical to `read_global`, from the LRU on the second read."""
    d = str(tmp_path / "svc")
    snapdir = str(tmp_path / "snaps_h1")
    ref = _twin_interior(tmp_path)

    with JobApiServer(d) as api, \
            MeshScheduler(policy="round_robin", flight_dir=d) as sched:
        u = f"http://{api.host}:{api.port}"
        code, rec = _post(u + "/v1/jobs", {"jobs": [
            _record("h1", run={"nt_chunk": 4, "snapshot_dir": snapdir,
                               "snapshot_every": 4}),
            _record("h2"), _record("h3")]})
        assert (code, rec["submitted"]) == (202, ["h1", "h2", "h3"])
        _, body, _ = _get(u + "/v1/jobs")
        assert {n: j["state"] for n, j in json.loads(body)["jobs"].items()} == {
            "h1": "pending", "h2": "pending", "h3": "pending"}
        status, body, _ = _get(u + "/metrics")
        assert status == 200 and b"igg_" in body

        def _step_until_running(name, budget=50):
            for _ in range(budget):
                if name in sched.jobs and sched.job(name).state == JobState.RUNNING:
                    return
                sched.step()
            raise AssertionError(f"{name} never reached RUNNING")

        _step_until_running("h2")
        code, rec = _post(u + "/v1/jobs/h2/resize", {"new_dims": [1, 2, 2]})
        assert (code, rec["requested"]) == (202, "resize")
        _step_until_running("h3")
        code, rec = _post(u + "/v1/jobs/h3/cancel")
        assert (code, rec["requested"]) == (202, "cancel") and "discarded" not in rec
        sched.run()

        assert sched.job("h1").state == JobState.DONE
        assert sched.job("h2").state == JobState.DONE
        assert sched.job("h3").state == JobState.CANCELLED
        assert tuple(int(x) for x in sched.job("h2").gg.dims) == (1, 2, 2)
        assert np.array_equal(_interior(sched, "h1"), ref)
        assert np.array_equal(_interior(sched, "h2"), ref)

        _, body, _ = _get(u + "/v1/jobs/h1")
        h1 = json.loads(body)
        assert h1["state"] == "done" and "claimed_by" in h1
        assert _post(u + "/v1/jobs/h1/cancel")[0] == 409
        assert _post(u + "/v1/jobs/nope/cancel")[0] == 404

    with SnapshotQueryServer(snapdir) as q:
        uq = f"http://{q.host}:{q.port}"
        _, body, _ = _get(uq + "/v1/snapshots")
        listing = json.loads(body)
        assert [s["step"] for s in listing["snapshots"]] == [4, 8]
        assert listing["snapshots"][0]["global_shapes"]["T"] == [10, 10, 6]
        box = (slice(1, 7), slice(2, 9), slice(0, 4))
        path8 = dict(tg.list_snapshots(snapdir))[8]
        expect = tg.open_snapshot(path8).read_global(
            "T", tuple((s.start, s.stop) for s in box))
        status, body, hdrs = _get(uq + "/v1/snapshots/8/T?box=1:7,2:9,0:4")
        arr = np.load(io.BytesIO(body))
        assert status == 200 and hdrs["X-IGG-Shape"] == "6,7,4"
        assert hdrs["X-IGG-Box"] == "1:7;2:9;0:4"
        assert arr.dtype == np.float64
        assert np.array_equal(arr, expect) and np.array_equal(arr, ref[box])
        status, body2, hdrs2 = _get(uq + "/v1/snapshots/8/T?box=1:7,2:9,0:4")
        assert int(hdrs["X-IGG-Cache-Hits"]) == 0 and int(hdrs2["X-IGG-Cache-Hits"]) > 0
        assert body2 == body and q.cache.stats()["hits"] > 0
        _, body, _ = _get(uq + "/v1/snapshots/8/T?point=3,4,2")
        assert json.loads(body)["value"] == float(ref[3, 4, 2])
        for bad, code in (("/v1/snapshots/8/T?box=banana", 400),
                          ("/v1/snapshots/8/T?box=0:2", 400),
                          ("/v1/snapshots/8/nope", 404),
                          ("/v1/snapshots/99/T", 404),
                          ("/v1/snapshots/8/T?box=0:2,0:2,0:2&point=1,1,1", 400)):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _get(uq + bad)
            assert ei.value.code == code, bad


# ---------------------------------------------------------------------------
# Deadline-aware admission
# ---------------------------------------------------------------------------

def test_deadline_rejection_priced_and_journaled(tmp_path):
    d = str(tmp_path / "svc")
    with MeshScheduler(policy="fifo", flight_dir=d) as sched:
        sched.submit(jobspec_from_json(
            _record("over", nt=10_000_000, nt_chunk=1_000_000, deadline_s=0.5)))
        sched.submit(jobspec_from_json(
            _record("ok", nt=4, nt_chunk=2, deadline_s=3600.0,
                    run={"nt_chunk": 2, "deadline_s": 1e-6})))
        sched.run()
        over = sched.job("over")
        assert over.state == JobState.REJECTED and "admission rejected" in over.error
        assert sched.job("ok").state == JobState.DONE
        assert sched.job("ok").run.deadline_missed is True
    fam = tg.metrics_registry().get("igg_job_deadline_missed_total")
    assert fam is not None and fam.value() >= 1
    for pkg in (tg, igg):  # both packages' reports of the port's journal
        rep = pkg.service_report(d)
        assert rep["states"] == {"rejected": 1, "done": 1}
        adm = rep["jobs"]["over"]["admission"]
        assert adm["verdict"] == "reject" and adm["priced_by"] == "predict_step"
        assert adm["admit_price_s"] > adm["budget_s"]
        assert adm["nt"] == 10_000_000 and adm["deadline_s"] == 0.5
        assert adm["step_price_s"] > 0 and adm["bound"]
        assert f"{adm['admit_price_s']:.3g}" in rep["jobs"]["over"]["error"]
        ok = rep["jobs"]["ok"]
        assert ok["admission"]["verdict"] == "admit" and ok["state"] == "done"
        assert ok["deadline_missed"]["deadline_s"] == 1e-6


def test_deadline_validation_and_unpriceable_jobs_admit(tmp_path):
    from implicitglobalgrid_tpu_torch.models import diffusion_step_local, init_diffusion3d

    with pytest.raises(InvalidArgumentError, match="deadline_s"):
        jobspec_from_json(_record("x", deadline_s=-1.0))

    def _setup():
        import torch

        T, Cp, p = init_diffusion3d(dtype=torch.float64)

        def step(s):
            return {"T": diffusion_step_local(s["T"], s["Cp"], p, "plain"), "Cp": s["Cp"]}

        return step, {"T": T, "Cp": Cp}

    tg.init_global_grid(**GRID_A, **CPU, quiet=True)
    step, state = _setup()
    with pytest.raises(InvalidArgumentError, match="deadline_s"):
        tg.run_resilient(step, state, 2, nt_chunk=2, deadline_s=0.0)
    tg.finalize_global_grid()
    d = str(tmp_path / "svc")
    with MeshScheduler(flight_dir=d) as sched:
        sched.submit(JobSpec(name="custom", setup=_setup, nt=4, grid=dict(GRID_A, **CPU),
                             deadline_s=0.5, run=tg.RunSpec(nt_chunk=2)))
        sched.run()
        assert sched.job("custom").state == JobState.DONE
    adm = tg.service_report(d)["jobs"]["custom"]["admission"]
    assert adm["verdict"] == "admit" and adm["priced_by"] == "unpriceable"


# ---------------------------------------------------------------------------
# Two schedulers, one backend
# ---------------------------------------------------------------------------

def test_two_schedulers_share_backend_fault_isolated_bit_identical(tmp_path):
    """Two live port schedulers drain one queue: every record admitted by
    exactly one, a NaNPoke in one tenant trips ITS guard only, and every
    tenant ends bitwise the CLI twin."""
    ref = _twin_interior(tmp_path)
    tg.reset_metrics()
    qroot = str(tmp_path / "q")
    b1, b2 = DirectoryBackend(qroot, owner="s1"), DirectoryBackend(qroot, owner="s2")
    for n in ("t1", "t2", "t3"):
        b1.submit(_record(n))
    d1, d2 = str(tmp_path / "svc1"), str(tmp_path / "svc2")
    with MeshScheduler(policy="round_robin", flight_dir=d1, queue=b1) as s1, \
            MeshScheduler(policy="round_robin", flight_dir=d2, queue=b2) as s2:
        s1.submit(JobSpec(
            name="tfault", setup=builtin_setup("diffusion3d", "float64"), nt=8,
            grid=dict(GRID_A, **CPU), model="diffusion3d",
            run=tg.RunSpec(nt_chunk=4, checkpoint_dir=str(tmp_path / "ck"),
                           faults=(tg.NaNPoke(step=6, name="T", index=(4, 4, 3)),))))
        for _ in range(200):
            p1, p2 = s1.step(), s2.step()
            if not p1 and not p2 and not b1.pending():
                break
        assert not b1.pending()
        done = {}
        for sched in (s1, s2):
            for name, job in sched.jobs.items():
                assert job.state == JobState.DONE, (name, job.state)
                done[name] = _interior(sched, name)
        assert set(done) == {"t1", "t2", "t3", "tfault"} and "tfault" in s1.jobs
        assert s1.jobs and s2.jobs
        h = _health()
        assert h.get("guard_trips") == 1 and h.get("rollbacks") == 1
        for name, interior in done.items():
            assert np.array_equal(interior, ref), name
    claimed = {}
    for dd in (d1, d2):
        for name, r in tg.service_report(dd)["jobs"].items():
            if "claimed_by" in r:
                assert name not in claimed, f"{name} claimed twice"
                claimed[name] = r["claimed_by"]
    assert set(claimed) == {"t1", "t2", "t3"} and set(claimed.values()) <= {"s1", "s2"}


# ---------------------------------------------------------------------------
# Validation (no mesh)
# ---------------------------------------------------------------------------

def test_job_api_validation_and_status_merge(tmp_path):
    d = str(tmp_path / "svc")
    with JobApiServer(d) as api:
        u = f"http://{api.host}:{api.port}"
        code, rec = _post(u + "/v1/jobs", {"jobs": [{"name": "a"}]})
        assert code == 400 and "missing required" in rec["error"]
        code, rec = _post(u + "/v1/jobs", {"jobs": [_record("a"),
                                                    _record("b", run={"bogus": 1})]})
        assert code == 400 and "bad 'run' knob" in rec["error"]
        assert api.backend.pending() == []
        code, rec = _post(u + "/v1/jobs", _record("a"))
        assert (code, rec["submitted"]) == (202, ["a"])
        assert _post(u + "/v1/jobs", _record("a"))[0] == 409
        code, rec = _post(u + "/v1/jobs", {"jobs": [_record("c"), _record("c")]})
        assert code == 409 and api.backend.pending() == ["a"]
        code, rec = _post(u + "/v1/jobs/a/resize", {"new_dims": [1, 2]})
        assert code == 400 and "new_dims" in rec["error"]
        code, rec = _post(u + "/v1/jobs/a/resize", {"new_dims": [1, 2, 2], "via": "magic"})
        assert code == 400 and "via" in rec["error"]
        assert _post(u + "/v1/jobs/zzz/cancel")[0] == 404
        assert _post(u + "/v1/nope")[0] == 404
        assert _post(u + "/v1/jobs", None)[0] == 400
        code, rec = _post(u + "/v1/jobs/a/cancel")
        assert (code, rec.get("discarded")) == (202, True)
        assert api.backend.pending() == []
        code, rec = _post(u + "/v1/drain")
        assert (code, rec["requested"]) == (202, "drain")
        assert DirectoryBackend(d).poll_control() == [{"request": "drain"}]


def test_query_server_validation(tmp_path):
    with pytest.raises(InvalidArgumentError, match="root"):
        SnapshotQueryServer(str(tmp_path / "nope"))
    root = tmp_path / "empty"
    root.mkdir()
    with SnapshotQueryServer(str(root), cache_bytes=1024) as q:
        u = f"http://{q.host}:{q.port}"
        _, body, _ = _get(u + "/v1/snapshots")
        rec = json.loads(body)
        assert rec["snapshots"] == [] and rec["cache"]["max_bytes"] == 1024
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(u + "/v1/snapshots/3/T")
        assert ei.value.code == 404
        assert _post(u + "/v1/snapshots")[0] == 405


def test_parse_box_matches_jax():
    from implicitglobalgrid_tpu.serve.query import _parse_box as jax_parse
    from implicitglobalgrid_tpu_torch.serve.query import _parse_box

    for text, shape in (("1:7,2:9,0:4", (10, 10, 6)), (",0:2,", (4, 4, 4)), ("0:3", (5,))):
        assert _parse_box(text, shape) == jax_parse(text, shape)
    for text, shape in (("1:7,2:9", (10, 10, 6)), ("1,2,3", (4, 4, 4)), ("a:b", (4,))):
        with pytest.raises(InvalidArgumentError):
            _parse_box(text, shape)


# ---------------------------------------------------------------------------
# The live plane over HTTP
# ---------------------------------------------------------------------------

def _obs_rec(kind, t, seq, **kw):
    return {"t": t, "kind": kind, "run": "j1", "pid": 1, "proc": 0, "seq": seq, **kw}


def _obs_append(path, recs):
    with open(path, "a") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")


def _chunk(t, seq, c):
    return _obs_rec("chunk", t, seq, chunk=c, step_begin=4 * c, step_end=4 * c + 4, n=4,
                    ok=True, reasons=[], build_s=0.01, exec_s=0.4)


def test_observe_endpoints_snapshot_and_resumable_stream(tmp_path):
    """The job API mounts the live plane: ``/v1/observe`` serves the
    derived snapshot, ``/v1/events`` the merged feed as chunked NDJSON,
    heartbeat-terminated, ``since=`` resumable with no gap and no
    duplicate, a ``max_events`` cut resuming at the unsent tail; a bad
    query is a 400. `ObserveServer` serves the same plane alone;
    ``observe=False`` unmounts it."""
    d = str(tmp_path / "svc")
    os.makedirs(d)
    p = os.path.join(d, "flight_j1.jsonl")
    _obs_append(p, [_obs_rec("recorder_open", 100.0, 0, wall=5000.0), _chunk(100.5, 1, 0),
                    _chunk(101.0, 2, 1),
                    _obs_rec("deadline_slack", 101.1, 3, step=8, slack_s=-1.5)])
    with JobApiServer(d) as api:
        u = f"http://{api.host}:{api.port}"
        snap = json.loads(_get(u + "/v1/observe")[1])
        assert snap["cursor"] == 3
        assert snap["jobs"]["j1"]["deadline_slack_s"] == -1.5
        assert snap["jobs"]["j1"]["step_s_p50"] == pytest.approx(0.1)
        status, body, hdrs = _get(u + "/v1/events?since=-1&timeout_s=0.2&heartbeat_s=0.05")
        assert status == 200 and hdrs["Content-Type"] == "application/x-ndjson"
        assert hdrs.get("Transfer-Encoding") == "chunked"
        lines = [json.loads(x) for x in body.splitlines()]
        evs = [e for e in lines if e["kind"] != "heartbeat"]
        assert [e["live_seq"] for e in evs] == [0, 1, 2, 3]
        assert [e["kind"] for e in evs] == ["recorder_open", "chunk", "chunk",
                                            "deadline_slack"]
        assert (lines[-1]["kind"], lines[-1]["cursor"], lines[-1]["done"]) == \
            ("heartbeat", 3, True)
        _, body, _ = _get(u + "/v1/events?since=-1&max_events=2&timeout_s=5")
        lines = [json.loads(x) for x in body.splitlines()]
        assert [e.get("live_seq") for e in lines[:2]] == [0, 1]
        assert (lines[-1]["cursor"], lines[-1]["done"]) == (1, True)
        _, body, _ = _get(u + f"/v1/events?since={lines[-1]['cursor']}&timeout_s=0.2")
        assert [e["live_seq"] for e in map(json.loads, body.splitlines())
                if e["kind"] != "heartbeat"] == [2, 3]
        _obs_append(p, [_chunk(101.5, 4, 2)])
        _, body, _ = _get(u + "/v1/events?since=3&timeout_s=0.2")
        assert [e["live_seq"] for e in map(json.loads, body.splitlines())
                if e["kind"] != "heartbeat"] == [4]
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(u + "/v1/events?since=abc")
        assert ei.value.code == 400
        assert "bad /v1/events" in json.loads(ei.value.read())["error"]
    with ObserveServer(d) as obs:
        uo = f"http://{obs.host}:{obs.port}"
        snap = json.loads(_get(uo + "/v1/observe")[1])
        assert snap["jobs"]["j1"]["deadline_slack_s"] == -1.5 and snap["cursor"] == 4
        status, body, _ = _get(uo + "/metrics")
        assert status == 200 and b"igg_" in body
    with JobApiServer(d, observe=False) as api2:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(f"http://{api2.host}:{api2.port}/v1/observe")
        assert ei.value.code == 404


def test_alerts_fire_sink_cancels_bust_job_survivors_bit_identical(tmp_path):
    """A live port scheduler with the default rule pack and a
    `ControlFileSink`: ``guard_trip_storm`` fires for the poked tenant and
    ``deadline_slack_burn`` for the over-budget one, whose cancel the sink
    files and the scheduler consumes mid-run; the survivors end bitwise the
    CLI twin; ``/v1/observe`` and ``/v1/events`` show both alerts."""
    from implicitglobalgrid_tpu_torch.telemetry.live import ControlFileSink

    ref = _twin_interior(tmp_path)
    tg.reset_metrics()
    d = str(tmp_path / "svc")
    backend = DirectoryBackend(d)
    sink = ControlFileSink(backend, rules=("deadline_slack_burn",))
    with MeshScheduler(policy="round_robin", flight_dir=d, queue=backend, alerts=True,
                       alert_sinks=(sink,)) as sched:
        sched.submit(jobspec_from_json(_record("good")))
        sched.submit(JobSpec(
            name="poked", setup=builtin_setup("diffusion3d", "float64"), nt=8,
            grid=dict(GRID_A, **CPU), model="diffusion3d",
            run=tg.RunSpec(nt_chunk=4, checkpoint_dir=str(tmp_path / "ck"),
                           faults=(tg.NaNPoke(step=6, name="T", index=(4, 4, 3)),))))
        sched.submit(jobspec_from_json(_record("bust", deadline_s=3600.0,
                                               run={"nt_chunk": 4, "deadline_s": 1e-6})))
        sched.run()
        assert sched.job("good").state == JobState.DONE
        assert sched.job("poked").state == JobState.DONE
        assert sched.job("bust").state == JobState.CANCELLED and sched.job("bust").run.step < 8
        assert sink.filed == [{"rule": "deadline_slack_burn", "job": "bust",
                               "action": "cancel"}]
        h = _health()
        assert h.get("guard_trips") == 1 and h.get("rollbacks") == 1
        assert np.array_equal(_interior(sched, "good"), ref)
        assert np.array_equal(_interior(sched, "poked"), ref)
    alerts = tg.service_report(d)["alerts"]
    fired = {(a["rule"], a["job"]) for a in alerts["active"]}
    assert {("deadline_slack_burn", "bust"), ("guard_trip_storm", "poked")} <= fired
    with ObserveServer(d, backend=DirectoryBackend(d)) as obs:
        u = f"http://{obs.host}:{obs.port}"
        snap = json.loads(_get(u + "/v1/observe")[1])
        active = {(a["rule"], a.get("job")) for a in snap["alerts"]["active"]}
        assert {("deadline_slack_burn", "bust"), ("guard_trip_storm", "poked")} <= active
        assert snap["jobs"]["bust"]["deadline_slack_s"] < 0
        _, body, _ = _get(u + "/v1/events?since=-1&timeout_s=0.3")
        trans = {(e["rule"], e.get("job")) for e in map(json.loads, body.splitlines())
                 if e["kind"] == "alert"}
        assert {("deadline_slack_burn", "bust"), ("guard_trip_storm", "poked")} <= trans


def test_traceparent_e2e_http_submit_to_otlp_span_tree(tmp_path):
    """A client ``traceparent`` POSTed with a job is echoed, rides the queue
    record, roots the port scheduler's journal (``job_claimed`` parented on
    the API's span), stamps every later journal event and flight chunk, and
    `export_otlp` rebuilds one connected span tree."""
    d = str(tmp_path / "svc")
    client = tg.TraceContext.new()
    with JobApiServer(d) as api:
        u = f"http://{api.host}:{api.port}"
        req = urllib.request.Request(
            u + "/v1/jobs", method="POST",
            data=json.dumps({"jobs": [_record("tr1", deadline_s=3600.0)]}).encode(),
            headers={"traceparent": client.to_traceparent()})
        with urllib.request.urlopen(req, timeout=10) as r:
            code, rec, echoed = r.status, json.loads(r.read()), r.headers.get("traceparent")
        assert code == 202 and rec["submitted"] == ["tr1"] and rec["traceparent"] == echoed
        api_ctx = tg.TraceContext.parse(echoed)
        assert api_ctx.trace_id == client.trace_id and api_ctx.span_id != client.span_id
        code, rec = _post(u + "/v1/jobs", {"jobs": [_record("fresh")]})
        assert code == 202
        assert tg.TraceContext.parse(rec["traceparent"]).trace_id != client.trace_id
    with MeshScheduler(policy="round_robin", flight_dir=d) as sched:
        sched.run()
        assert sched.job("tr1").state == JobState.DONE
    tid = client.trace_id
    journal = tg.read_flight_events(os.path.join(d, "scheduler.jsonl"))
    tr1 = [e for e in journal if e.get("job") == "tr1"]
    assert tr1 and all(e.get("trace_id") == tid for e in tr1)
    assert {"job_claimed", "job_submitted", "job_admitted", "slice", "job_done"} <= \
        {e["kind"] for e in tr1}
    claimed = [e for e in tr1 if e["kind"] == "job_claimed"]
    assert len(claimed) == 1 and claimed[0]["parent_span_id"] == api_ctx.span_id
    root = claimed[0]["span_id"]
    for e in tr1:
        if e["kind"] != "job_claimed":
            assert (e["parent_span_id"], e["trace_id"]) == (root, tid)
    chunks = [e for e in tg.read_flight_events(os.path.join(d, "job_tr1.jsonl"))
              if e["kind"] == "chunk"]
    assert chunks and all((e["trace_id"], e["parent_span_id"]) == (tid, root)
                          for e in chunks)
    doc = tg.export_otlp(d, trace_id=tid)
    spans = [s for rs in doc["resourceSpans"] for ss in rs["scopeSpans"] for s in ss["spans"]]
    ids = {s["spanId"] for s in spans}
    assert len(ids) == len(spans)
    roots = [s for s in spans if s.get("parentSpanId") not in ids]
    assert [s["name"] for s in roots] == ["job_claimed"]
    assert roots[0]["parentSpanId"] == api_ctx.span_id
    assert doc == igg.export_otlp(d, trace_id=tid)  # the JAX exporter reads it alike


def test_api_token_gates_routed_surface(tmp_path, monkeypatch):
    monkeypatch.delenv("IGG_API_TOKEN", raising=False)
    d = str(tmp_path / "svc")
    with JobApiServer(d, api_token="s3cret") as api:
        u = f"http://{api.host}:{api.port}"
        assert _get_code(u + "/v1/jobs") == 401
        assert _get_code(u + "/v1/jobs", token="wrong") == 401
        assert _get_code(u + "/v1/jobs", token="s3cret") == 200
        assert _get_code(u + "/v1/observe", token="s3cret") == 200
        assert _get_code(u + "/metrics") == 200 and _get_code(u + "/healthz") == 200
        assert _post(u + "/v1/drain")[0] == 401
    monkeypatch.setenv("IGG_API_TOKEN", "envtok")
    with JobApiServer(d) as api:
        u = f"http://{api.host}:{api.port}"
        assert _get_code(u + "/v1/jobs") == 401
        assert _get_code(u + "/v1/jobs", token="envtok") == 200
    with JobApiServer(d, api_token=False) as api:
        assert _get_code(f"http://{api.host}:{api.port}/v1/jobs") == 200
    monkeypatch.delenv("IGG_API_TOKEN", raising=False)
    with ObserveServer(d, api_token="obs") as obs:
        u = f"http://{obs.host}:{obs.port}"
        assert _get_code(u + "/v1/observe") == 401
        assert _get_code(u + "/v1/observe", token="obs") == 200
    root = tmp_path / "snaps"
    root.mkdir()
    with SnapshotQueryServer(str(root), api_token="q") as q:
        u = f"http://{q.host}:{q.port}"
        assert _get_code(u + "/v1/snapshots") == 401
        assert _get_code(u + "/v1/snapshots", token="q") == 200
    with pytest.raises(InvalidArgumentError, match="token"):
        JobApiServer(d, api_token="")


# ---------------------------------------------------------------------------
# Across packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_job_record_crosses_packages(tmp_path, writer):
    """A job POSTed to one package's `JobApiServer` runs under the other
    package's scheduler (polling the same directory); the writer's API then
    reports it done from the consumer's journal, and its final state is
    within the float64 run bound of the other package's run of the same
    record."""
    api_cls, consumer, other = ((igg.JobApiServer, tg, igg) if writer == "jax"
                                else (JobApiServer, igg, tg))
    dev = CPU if consumer is tg else {}
    d = str(tmp_path / "svc")
    with api_cls(d) as api:
        u = f"http://{api.host}:{api.port}"
        code, rec = _post(u + "/v1/jobs", _record("x", dev=dev))
        assert (code, rec["submitted"]) == (202, ["x"])
        with consumer.service.MeshScheduler(policy="fifo", flight_dir=d) as sched:
            sched.run()
            assert sched.job("x").state == "done"
            got = _interior(sched, "x", consumer)
        job = json.loads(_get(u + "/v1/jobs/x")[1])
        assert job["state"] == "done" and job["step"] == 8 and "claimed_by" in job
    odev = CPU if other is tg else {}
    with other.service.MeshScheduler(flight_dir=str(tmp_path / "twin")) as sched:
        sched.submit(other.service.jobspec_from_json(_record("x", dev=odev)))
        sched.run()
        want = _interior(sched, "x", other)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float64
    np.testing.assert_allclose(got, want, **TOL64)


@pytest.fixture(scope="module")
def snapshot_roots(tmp_path_factory):
    """One snapshot root written by each package: a float64 T, a float32
    staggered Vx, two steps."""
    root = tmp_path_factory.mktemp("snap_roots")
    out = {}
    rng = np.random.default_rng(3)
    T0 = rng.normal(size=(12, 12, 6))
    V0 = rng.normal(size=(14, 12, 6)).astype(np.float32)
    for key, pkg, dev in (("torch", tg, CPU), ("jax", igg, {})):
        pkg.init_global_grid(**GRID_A, **dev, quiet=True)
        T, V = pkg.device_put_g(T0), pkg.device_put_g(V0)
        for step in (2, 4):
            pkg.write_snapshot(str(root / key), step=step, state={"T": T * step, "Vx": V})
        pkg.finalize_global_grid()
        out[key] = str(root / key)
    return out


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_snapshot_served_byte_identical_across_packages(snapshot_roots, writer):
    """Both packages' query servers answer the same listing and the same
    bytes for a point, a z plane and a whole field of a snapshot one
    package wrote, equal to both readers' `read_global`; each second read
    comes from its cache."""
    root = snapshot_roots[writer]
    bodies = {}
    for key, cls, pkg in (("torch", SnapshotQueryServer, tg),
                          ("jax", igg.SnapshotQueryServer, igg)):
        with cls(root) as q:
            u = f"http://{q.host}:{q.port}"
            listing = json.loads(_get(u + "/v1/snapshots")[1])
            listing.pop("cache")
            got = {"listing": listing}
            for name, query in (("point", "T?box=3:4,5:6,2:3"), ("plane", "T?box=,,4:5"),
                                ("whole", "T"), ("stag", "Vx?box=0:11,1:9,")):
                _, body, hdrs = _get(u + f"/v1/snapshots/4/{query}")
                _, body2, hdrs2 = _get(u + f"/v1/snapshots/4/{query}")
                assert body2 == body and int(hdrs2["X-IGG-Cache-Hits"]) > 0
                got[name] = (body, {k: v for k, v in hdrs.items()
                                    if k.startswith("X-IGG") and k != "X-IGG-Cache-Hits"})
            got["value"] = json.loads(_get(u + "/v1/snapshots/2/T?point=3,5,2")[1])
            got["value"].pop("cache_hit")
            path = dict(pkg.list_snapshots(root))[4]
            whole = pkg.open_snapshot(path).read_global("T")
            assert np.array_equal(np.load(io.BytesIO(got["whole"][0])), whole)
            assert np.array_equal(np.load(io.BytesIO(got["plane"][0])), whole[:, :, 4:5])
        bodies[key] = got
    assert bodies["torch"] == bodies["jax"]


def _strip_clock(snap):
    """A snapshot without the fields read off the wall clock."""
    snap = json.loads(json.dumps(snap, default=str))
    snap.pop("t")
    snap["tail"].pop("lag_s")
    for g in snap["gaps"]:
        g.pop("t", None)
    snap["queue"].pop("oldest_age_s", None)
    return snap


@pytest.fixture(scope="module")
def sched_dirs(tmp_path_factory):
    """One scheduler directory (alerts on, a NaN poke, a queue backend)
    written by each package."""
    root = tmp_path_factory.mktemp("serve_dirs")
    out = {}
    try:
        for key, pkg, dev in (("jax", igg, {}), ("torch", tg, CPU)):
            d = str(root / key)
            svc = pkg.service
            with svc.MeshScheduler(policy="round_robin", flight_dir=d, alerts=True) as s:
                s.submit(svc.JobSpec(
                    name="diff", setup=svc.builtin_setup("diffusion3d", "float64"), nt=8,
                    grid=dict(GRID_A, **dev), model="diffusion3d",
                    run=pkg.RunSpec(nt_chunk=4, checkpoint_dir=os.path.join(d, "ck"),
                                    faults=[pkg.NaNPoke(step=6, name="T", index=(4, 4, 3))])))
                s.submit(svc.JobSpec(name="wave", setup=svc.builtin_setup("acoustic3d"), nt=4,
                                     grid=dict(GRID_A, **dev), run=pkg.RunSpec(nt_chunk=2)))
                s.run()
                assert s.status()["states"] == {"done": 2}
            svc.DirectoryBackend(d).submit(_record("waiting", dev=dev))
            out[key] = d
    finally:
        for pkg in (tg, igg):
            pkg.stop_flight_recorder()
            pkg.reset_metrics()
    return out


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_observe_planes_agree_across_packages(sched_dirs, writer):
    """Both packages' `ObservePlane`s over one scheduler directory (with a
    queue backend: a pending record) give the same snapshot, wall-clock
    fields aside, and the same merged feed; the job APIs list the same
    jobs."""
    d = sched_dirs[writer]
    snaps, feeds, jobs = [], [], []
    for pkg, api_cls in ((tg, JobApiServer), (igg, igg.JobApiServer)):
        plane = pkg.ObservePlane(d, backend=pkg.service.DirectoryBackend(d))
        snaps.append(_strip_clock(plane.snapshot()))
        feeds.append(plane.live.events_since(None))
        with api_cls(d) as api:
            jobs.append(json.loads(_get(f"http://{api.host}:{api.port}/v1/jobs")[1]))
    assert snaps[0] == snaps[1]
    assert json.loads(json.dumps(feeds[0], default=str)) == \
        json.loads(json.dumps(feeds[1], default=str))
    assert snaps[0]["queue"]["pending"] == 1
    assert {k: snaps[0]["jobs"][k]["state"] for k in ("diff", "wave")} == \
        {"diff": "done", "wave": "done"}
    assert any(a["rule"] == "guard_trip_storm" for a in snaps[0]["alerts"]["recent"])

    def states(rec):
        return {n: j["state"] for n, j in rec["jobs"].items()}

    assert states(jobs[0]) == states(jobs[1]) == {"diff": "done", "wave": "done",
                                                 "waiting": "pending"}
