"""The port's operator CLI (``python -m implicitglobalgrid_tpu_torch.tools``)
on the CPU, held against the JAX package's (`tests/test_tools.py`'s audit and
jobs cases, the CLI cases of `tests/test_tune.py`, `tests/test_live.py`,
`tests/test_mesh_observability.py`, `tests/test_reshard.py` and
`tests/test_perfmodel.py`'s perfdb gate):

- every host-only command (``report``, ``snapshots``, ``probe``,
  ``aggregate``, ``trace``, ``stragglers``, ``watch --once [--json]``,
  ``alerts`` [``--ack``], ``flight du``, ``perfdb``, ``tune show``,
  ``reshard plan``, ``autoscale explain``, ``audit --hlo`` and ``jobs
  list|status|cancel|drain|resize``) run by both packages' ``_cli`` on the
  same directory or file prints the same text or JSON (wall-clock fields
  aside) and returns the same exit code, on inputs either package wrote;
- the device-touching commands with ``--cpu`` at a small size: ``jobs
  submit`` (exit 1 when a job fails, the grid beyond the rank pool),
  ``audit <models>``, ``reshard run``, ``tune``, and ``calibrate``, whose
  profile JAX's `predict_step` reads; without ``--cpu`` and without a card
  they exit 2; the flags that mean nothing to the port raise.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import implicitglobalgrid_tpu as igg
import implicitglobalgrid_tpu_torch as tg
from implicitglobalgrid_tpu.tools import _cli as jax_cli
from implicitglobalgrid_tpu_torch.parallel import topology as ttop
from implicitglobalgrid_tpu_torch.tools import _cli as torch_cli
from implicitglobalgrid_tpu_torch.utils.exceptions import InvalidArgumentError

from torch_port_util import ROOT, child_env, clean_torch_grid  # noqa: F401

GRID_A = dict(nx=6, ny=6, nz=6, dimx=2, dimy=2, dimz=1)
CPU = {"device_type": "cpu"}
QUEUE = {"policy": "fifo", "jobs": [
    {"name": "ok", "model": "diffusion3d", "dtype": "float64", "nt": 4,
     "grid": dict(GRID_A), "run": {"nt_chunk": 2}},
    # 16 ranks > the pool of 8: fails at admission in both packages
    {"name": "toobig", "model": "diffusion3d", "nt": 4,
     "grid": {"nx": 6, "ny": 6, "nz": 6, "dimx": 16, "dimy": 1, "dimz": 1}},
]}


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


def _both(argv, capsys, norm=None):
    """Run the port's then JAX's ``_cli`` on ``argv``: equal exit codes and
    equal output (after ``norm``). Returns (rc, port output)."""
    rt = torch_cli(list(argv))
    ot = capsys.readouterr().out
    rj = jax_cli(list(argv))
    oj = capsys.readouterr().out
    assert rt == rj, (argv, rt, rj)
    if norm is not None:
        ot, oj = norm(ot), norm(oj)
    assert ot == oj, argv
    return rt, ot


def _json_without(*keys):
    def norm(out):
        rec = json.loads(out)
        for k in keys:
            rec.pop(k, None)
        return rec
    return norm


# ---------------------------------------------------------------------------
# jobs: submit (device), list/status/cancel/resize/drain (host-only)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def svc_dirs(tmp_path_factory):
    """The same queue submitted through each package's CLI (the port's with
    ``--cpu``): one flight directory each."""
    root = tmp_path_factory.mktemp("cli_svc")
    q = root / "queue.json"
    q.write_text(json.dumps(QUEUE))
    out = {}
    for key, cli, extra in (("torch", torch_cli, ["--cpu"]), ("jax", jax_cli, [])):
        d = str(root / key)
        assert cli(["jobs", "submit", str(q), "--flight-dir", d, "--json"] + extra) == 1
        out[key] = d
    for pkg in (tg, igg):
        pkg.reset_metrics()
    return out


def test_jobs_cli_submit_list_status_control(tmp_path, capsys):
    """`tools jobs` on the port, exit codes included: submit runs the queue
    (rc 1: the grid beyond the pool fails at admission, the good job
    completes), list/status answer from the journal (rc 3 unknown),
    cancel/drain file control requests (rc 4 finished); a typo'd or
    missing key raises."""
    fd = str(tmp_path / "fd")
    queue = tmp_path / "queue.json"
    queue.write_text(json.dumps(QUEUE))
    rc = torch_cli(["jobs", "submit", str(queue), "--flight-dir", fd, "--cpu", "--json"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 1 and out["ok"] is False
    by = {j["name"]: j for j in out["jobs"]}
    assert by["ok"]["state"] == "done" and by["ok"]["step"] == 4
    assert by["toobig"]["state"] == "failed"
    assert "InvalidArgumentError" in by["toobig"]["error"]
    assert torch_cli(["jobs", "list", fd]) == 0
    listing = capsys.readouterr().out
    assert "ok" in listing and "toobig" in listing
    assert torch_cli(["jobs", "status", fd, "ok"]) == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec["state"] == "done" and rec["report"]["steps"]["completed"] == 4
    assert torch_cli(["jobs", "status", fd, "nope"]) == 3
    assert torch_cli(["jobs", "cancel", fd, "nope"]) == 3
    assert torch_cli(["jobs", "cancel", fd, "ok"]) == 4
    assert torch_cli(["jobs", "drain", fd]) == 0
    capsys.readouterr()
    assert os.path.exists(os.path.join(fd, "control", "drain"))
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"jobs": [{"name": "x", "model": "diffusion3d", "nt": 4,
                                         "nt_chunk": 2}]}))
    with pytest.raises(InvalidArgumentError, match="unknown key"):
        torch_cli(["jobs", "submit", str(bad), "--cpu"])
    bad.write_text(json.dumps({"jobs": [{"name": "x", "nt": 4}]}))
    with pytest.raises(InvalidArgumentError, match="missing required"):
        torch_cli(["jobs", "submit", str(bad), "--cpu"])


def test_jobs_submit_outcomes_match_jax(svc_dirs):
    """Both packages' submissions of one queue end in the same states,
    steps and slices (each journal read by the other package too)."""
    def summary(rep):
        return {n: (j["state"], j.get("step"), j["slices"]) for n, j in rep["jobs"].items()}

    reps = [pkg.service_report(svc_dirs[w]) for w in ("torch", "jax") for pkg in (tg, igg)]
    assert all(summary(r) == summary(reps[0]) for r in reps)
    assert summary(reps[0]) == {"ok": ("done", 4, 2), "toobig": ("failed", 0, 1)}


# (subcommand and its arguments after the directory, exit code)
_JOBS_ARGVS = [
    (("list",), 0), (("list", "--json"), 0), (("status", "ok"), 0), (("status", "toobig"), 0),
    (("status", "nope"), 3), (("cancel", "nope"), 3), (("cancel", "ok"), 4),
    (("resize", "nope", "1,2,2"), 3), (("resize", "ok", "1,2,2"), 4), (("drain",), 0),
]


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("argv, code", _JOBS_ARGVS, ids=["-".join(a) for a, _ in _JOBS_ARGVS])
def test_jobs_host_commands_match_jax(svc_dirs, writer, argv, code, capsys):
    rc, _ = _both(["jobs", argv[0], svc_dirs[writer], *argv[1:]], capsys)
    assert rc == code


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_service_dir_views_match_jax(svc_dirs, writer, tmp_path, capsys):
    """``report``, ``autoscale explain``, ``flight du``, ``alerts``,
    ``watch --once [--json]`` and ``trace`` (the one-track-a-job service
    trace; ``--otlp`` of untraced jobs) of a scheduler directory."""
    d = svc_dirs[writer]
    _both(["report", d, "--no-metrics"], capsys)
    _both(["autoscale", "explain", d], capsys)
    _both(["autoscale", "explain", d, "--job", "ok"], capsys)
    _both(["flight", "du", d], capsys)
    _both(["flight", "du", d, "--json"], capsys)
    _both(["alerts", d], capsys)
    _both(["alerts", d, "--json"], capsys)
    _both(["watch", d, "--once", "--json"], capsys, norm=lambda o: _strip_clock(json.loads(o)))
    _both(["watch", d, "--once"], capsys, norm=_strip_lag)
    docs = []
    for cli in (torch_cli, jax_cli):
        out = str(tmp_path / f"t_{len(docs)}.json")
        assert cli(["trace", d, "-o", out]) == 0
        assert capsys.readouterr().out.strip() == out
        docs.append(json.load(open(out)))
    # the exporter names its own package in the document's source
    assert [doc["otherData"].pop("source") for doc in docs] == [
        "implicitglobalgrid_tpu_torch multi-run scheduler",
        "implicitglobalgrid_tpu multi-run scheduler"]
    assert docs[0] == docs[1] and docs[0]["otherData"]["jobs"] == ["ok", "toobig"]
    # jobs submitted by the CLI carry no trace: both OTLP exports refuse alike
    for cli, exc in ((torch_cli, InvalidArgumentError),
                     (jax_cli, igg.exceptions.InvalidArgumentError)):
        with pytest.raises(exc, match="no trace-stamped events"):
            cli(["trace", d, "--otlp", "-o", str(tmp_path / "otlp.json")])


def _strip_clock(snap):
    snap.pop("t")
    snap["tail"].pop("lag_s")
    snap["queue"].pop("oldest_age_s", None)
    return snap


def _strip_lag(frame):
    import re

    return re.sub(r"  lag=\S+", "", frame)


# ---------------------------------------------------------------------------
# snapshots, probe, report of a run (host-only)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def run_dirs(tmp_path_factory):
    """A supervised run of each package with snapshots and a flight JSONL."""
    root = tmp_path_factory.mktemp("cli_run")
    out = {}
    for key, pkg, dev in (("torch", tg, CPU), ("jax", igg, {})):
        pkg.init_global_grid(**GRID_A, **dev, quiet=True)
        T, Cp, p = pkg.models.init_diffusion3d()
        route = "plain" if pkg is tg else "xla"
        d = root / key
        jsonl = str(d / "fr.jsonl")
        os.makedirs(d)
        pkg.start_flight_recorder(jsonl)
        pkg.run_resilient(
            lambda s, pkg=pkg, p=p, route=route: {
                "T": pkg.models.diffusion_step_local(s["T"], s["Cp"], p, route),
                "Cp": s["Cp"]},
            {"T": T, "Cp": Cp}, 8, nt_chunk=4, snapshot_dir=str(d / "snaps"), snapshot_every=4)
        pkg.stop_flight_recorder()
        pkg.finalize_global_grid()
        out[key] = (str(d / "snaps"), jsonl)
    return out


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_snapshot_and_report_commands_match_jax(run_dirs, writer, capsys):
    snaps, jsonl = run_dirs[writer]
    rc, out = _both(["snapshots", snaps], capsys)
    assert rc == 0 and out.count("step ") == 2
    _both(["snapshots", snaps, "--json"], capsys)
    rc, out = _both(["probe", snaps, "T", "3", "4", "2"], capsys)
    assert [line.split()[0] for line in out.splitlines()] == ["4", "8"]
    _both(["probe", snaps, "T", "3", "4", "2", "--json"], capsys)
    one = tg.list_snapshots(snaps)[-1][1]
    _both(["probe", one, "T", "0", "0", "0"], capsys)
    _both(["report", jsonl, "--no-metrics"], capsys)
    _both(["report", jsonl, "--no-metrics", "--indent", "0"], capsys)


# ---------------------------------------------------------------------------
# the mesh view and the live plane (host-only)
# ---------------------------------------------------------------------------

def test_mesh_cli_subcommands_match_jax(tmp_path, capsys):
    from test_torch_mesh_observability import _two_proc_dir

    d = _two_proc_dir(tmp_path)
    merged = str(tmp_path / "merged.jsonl")
    files = []
    for cli in (torch_cli, jax_cli):
        assert cli(["aggregate", d, "--out", merged]) == 0
        files.append((capsys.readouterr().out, open(merged).read()))
    assert files[0] == files[1]
    summary = json.loads(files[0][0])
    assert summary["processes"] == [0, 1] and summary["out"] == merged
    assert summary["events"] == len(files[0][1].splitlines()) > 0
    docs = []
    for cli in (torch_cli, jax_cli):
        out = str(tmp_path / f"t{len(docs)}.json")
        assert cli(["trace", d, "-o", out]) == 0
        assert capsys.readouterr().out.strip() == out
        docs.append(json.load(open(out)))
    assert docs[0] == docs[1] and docs[0]["traceEvents"]
    rc, out = _both(["stragglers", d, "--window", "4"], capsys)
    rep = json.loads(out)
    assert rep["summary"]["worst_proc"] == 1 and rep["slowest_counts"] == {"0": 0, "1": 6}


def test_watch_and_alerts_match_jax(tmp_path, capsys):
    """The live dashboard frame and JSON, the alert listing, an ack into
    the side file and the acked listing, on a synthetic flight directory."""
    from test_torch_live import _Stream

    d = str(tmp_path)
    s = _Stream(os.path.join(d, "job_a.jsonl"), "a")
    s.append("run_begin", nt=8)
    s.chunk(0)
    s.append("deadline_slack", step=4, slack_s=-1.5, budget_s=2.0)
    j = _Stream(os.path.join(d, "scheduler.jsonl"), "scheduler")
    j.append("scheduler_start", policy="fifo")
    j.append("alert", rule="deadline_slack_burn", severity="critical", state="firing",
             job="a", value=-1.5, threshold=0.0)
    _, frame = _both(["watch", d, "--once"], capsys, norm=_strip_lag)
    assert "JOB" in frame and "-1.5s" in frame and "\x1b[2J" not in frame
    assert "ALERT CRITICAL deadline_slack_burn" in frame
    _, snap = _both(["watch", d, "--once", "--json"], capsys,
                    norm=lambda o: _strip_clock(json.loads(o)))
    assert snap["jobs"]["a"]["deadline_slack_s"] == -1.5
    _, out = _both(["alerts", d], capsys)
    assert "deadline_slack_burn" in out and "firing" in out
    _both(["alerts", d, "--ack", "deadline_slack_burn:a"], capsys)
    _, out = _both(["alerts", d, "--json"], capsys)
    assert json.loads(out)["alerts"][0]["acked"] is True
    assert os.path.exists(os.path.join(d, "alerts_ack.json"))
    _both(["flight", "du", d], capsys)


# ---------------------------------------------------------------------------
# perfdb, tune show, reshard plan, audit --hlo (host-only)
# ---------------------------------------------------------------------------

def test_perfdb_cli_gate_matches_jax(tmp_path, capsys):
    """`perfdb check` exits 1 on an injected 30% regression, 0 on noise, in
    both packages alike; `perfdb add` appends one record."""
    from test_torch_perfmodel import _history

    db = str(tmp_path / "hist.jsonl")
    _history(tg, db)
    good, bad = str(tmp_path / "good.json"), str(tmp_path / "bad.json")
    metric = "diffusion3D_f32_cell_updates_per_s_per_chip"
    json.dump([{"metric": metric, "value": 102.0}], open(good, "w"))
    json.dump([{"metric": metric, "value": 65.0}], open(bad, "w"))
    rc, out = _both(["perfdb", "check", good, "--db", db], capsys)
    assert rc == 0 and json.loads(out)["ok"] is True
    rc, out = _both(["perfdb", "check", bad, "--db", db], capsys)
    assert rc == 1 and json.loads(out)["regressions"][0]["metric"] == metric
    rc, _ = _both(["perfdb", "add", good, "--db", db, "--note", "ci"], capsys,
                  norm=_json_without("ts"))
    hist = tg.telemetry.perfdb_load(db)
    assert len(hist) == 8 and hist[-1]["meta"]["note"] == "ci"


def test_reshard_plan_matches_jax(capsys):
    argv = ["reshard", "plan", "--src-dims", "2,2,1", "--dst-dims", "1,2,2", "--nx", "6",
            "--indent", "0"]
    rt = torch_cli(argv)
    rec = json.loads(capsys.readouterr().out)
    assert rt == jax_cli(argv) == 0
    jrec = json.loads(capsys.readouterr().out)
    # the plan is the same; the price follows each package's default profile
    assert rec["plan"] == jrec["plan"] and rec["plan"]["rounds"] > 0
    assert rec["plan"]["src_dims"] == [2, 2, 1] and rec["predicted"]["seconds"] > 0
    assert set(rec["predicted"]) == set(jrec["predicted"])
    with pytest.raises(InvalidArgumentError, match="go together"):
        torch_cli(argv + ["--nt-remaining", "10"])


def test_audit_hlo_host_only_matches_jax(tmp_path, capsys):
    """An injected contract violation on a captured dump exits 1 and names
    the broken rule; the dump lints clean without it; a claimed bf16 wire
    is a caught downcast-missing error: the same JSON in both packages."""
    fixture = ROOT / "tests" / "data" / "hlo" / "exchange_single_axis.hlo.txt"
    contract = tmp_path / "contract.json"
    contract.write_text(json.dumps({"allreduces": 1, "allreduce_payload": ["f32", 4]}))
    rc, out = _both(["audit", "--hlo", str(fixture), "--contract", str(contract), "--json"],
                    capsys)
    rec = json.loads(out)
    assert rc == 1 and rec["ok"] is False
    assert "allreduce-count" in [f["rule"] for f in rec["programs"][0]["findings"]]
    rc, out = _both(["audit", "--hlo", str(fixture), "--json"], capsys)
    assert rc == 0 and json.loads(out)["ok"] is True
    rc, out = _both(["audit", "--hlo", str(fixture), "--wire-dtype", "bfloat16", "--json"],
                    capsys)
    assert rc == 1
    assert [f["rule"] for f in json.loads(out)["programs"][0]["findings"]] == \
        ["wire-downcast-missing"]
    _both(["audit", "--hlo", str(fixture)], capsys)


def test_tune_show_matches_jax(tmp_path, capsys):
    """A model-only tuned config the port's CLI produced (``--cpu``)
    prints the same through both packages' ``tune show``."""
    out = str(tmp_path / "tuned_diffusion3d.json")
    assert torch_cli(["tune", "diffusion3d", "--cpu", "--nx", "12", "--no-measure",
                      "--comm-every-options", "1;z:2", "--out", out]) == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec["model"] == "diffusion3d" and os.path.exists(out)
    _, shown = _both(["tune", "show", out], capsys)
    rec["meta"].pop("path")  # where the producer persisted it: not in the file
    assert json.loads(shown) == rec
    with pytest.raises(InvalidArgumentError, match="name the tuned-config"):
        torch_cli(["tune", "show"])


# ---------------------------------------------------------------------------
# device-touching commands with --cpu; their device rules
# ---------------------------------------------------------------------------

def test_audit_cli_json_schema_and_model_smoke(capsys):
    """`tools audit` on the port's current grid (both families in one call):
    rc 0, and the --json schema carries the contract verdict, the findings,
    the collective summary and the crosscheck a program; the summary form
    also exits 0."""
    tg.init_global_grid(8, 8, 8, dimx=2, dimy=2, dimz=2, periodx=1, periody=1, periodz=1,
                        device_type="cpu", quiet=True)
    rc = torch_cli(["audit", "diffusion3d", "acoustic3d", "--json"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0 and out["ok"] is True
    assert [p["name"] for p in out["programs"]] == ["diffusion3d", "acoustic3d"]
    for prog in out["programs"]:
        assert prog["ok"] is True and prog["dialect"] == "record"
        assert prog["errors"] == 0 and prog["findings"] == []
        assert prog["collectives"]["all_gathers"] == 0
        assert prog["collectives"]["permutes"] > 0
        assert prog["crosscheck"]["ok"] is True
        assert set(prog["crosscheck"]["axes"]) == {"gx", "gy", "gz"}
    assert torch_cli(["audit", "diffusion3d", "--impl", "pallas"]) == 0
    assert "diffusion3d: OK" in capsys.readouterr().out
    assert tg.grid_is_initialized()  # the caller's grid stays


def test_audit_cli_self_initialized_three_families(capsys):
    rc = torch_cli(["audit", "diffusion3d", "acoustic3d", "stokes3d", "--cpu", "--json",
                    "--impl", "pallas", "--nx", "8"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0 and out["ok"] and len(out["programs"]) == 3
    assert not tg.grid_is_initialized()
    rc = torch_cli(["audit", "diffusion3d", "--cpu", "--comm-every", "z:2", "--json"])
    assert rc == 0 and json.loads(capsys.readouterr().out)["programs"][0]["ok"]


@pytest.mark.parametrize("stage", ["z:staged", "staged"])
def test_audit_cli_wire_stage_audits_what_the_port_runs(stage, capsys, monkeypatch):
    """`tools audit diffusion3d --cpu --wire-stage` (granules declared along
    z on the self-initialized 2x2x2 grid): rc 0 in both packages, the stage
    in each report's meta and crosscheck spelled alike; the port's
    recording holds the flat exchange (two permutes a dim), JAX's staged
    program more (its gather and scatter stages)."""
    monkeypatch.setenv("IGG_TPU_DCN_GRANULES", "z:2")
    got = {}
    for name, cli in (("jax", jax_cli), ("torch", torch_cli)):
        rc = cli(["audit", "diffusion3d", "--cpu", "--wire-stage", stage, "--json"])
        out = json.loads(capsys.readouterr().out)
        assert rc == 0 and out["ok"], (name, out)
        got[name] = out["programs"][0]
    j, t = got["jax"], got["torch"]
    assert t["meta"]["wire_stage"] == j["meta"]["wire_stage"]
    assert t["crosscheck"]["wire_stage"] == j["crosscheck"]["wire_stage"]
    assert t["collectives"]["permutes"] == 6 < j["collectives"]["permutes"]
    assert not tg.grid_is_initialized()


@pytest.mark.parametrize("flags, match", [
    ([], "name at least one model"),
    (["diffusion3d", "--hlo", "x.txt"], "mutually exclusive"),
    (["diffusion3d", "--cpu", "--lowered"], "no pre-backend"),
    (["diffusion3d", "--cpu", "--impl", "pallas_interpret"], "interpret mode"),
    (["diffusion3d", "--cpu", "--impl", "mosaic"], "no other route"),
])
def test_audit_cli_argument_validation(flags, match):
    with pytest.raises(InvalidArgumentError, match=match):
        torch_cli(["audit", *flags])


def test_reshard_run_audits_and_verifies(capsys):
    """`reshard run --cpu` (an ensemble state, both signatures): the
    recording's audit ok and the moved state bitwise the host oracle."""
    rc = torch_cli(["reshard", "run", "--src-dims", "2,2,1", "--dst-dims", "1,2,2",
                    "--nx", "6", "--ensemble", "2", "--cpu", "--json"])
    rec = json.loads(capsys.readouterr().out)
    assert rc == 0 and rec["ok"] and rec["verified"] and rec["audit"]["ok"]
    assert rec["plan"]["rounds"] > 0 and not tg.grid_is_initialized()
    with pytest.raises(InvalidArgumentError, match="transfer mesh needs"):
        torch_cli(["reshard", "run", "--src-dims", "2,2,2", "--dst-dims", "4,2,2",
                   "--cpu", "--nranks", "8"])


def test_calibrate_cpu_profile_read_by_jax(tmp_path, capsys):
    """`calibrate --cpu` writes a profile in the JAX schema: JAX's
    `load_machine_profile` and `predict_step` read it."""
    prof = str(tmp_path / "p.json")
    assert torch_cli(["calibrate", "--cpu", "--nx", "8", "--out", prof]) == 0
    printed = json.loads(capsys.readouterr().out)
    assert json.load(open(prof)) == printed
    jp = igg.load_machine_profile(prof)
    igg.init_global_grid(8, 8, 8, dimx=2, dimy=2, dimz=2, periodx=1, quiet=True)
    T, Cp, _ = igg.models.init_diffusion3d()
    pred = igg.predict_step("diffusion3d", (T, Cp), profile=jp)
    assert pred["step_s"] > 0 if isinstance(pred, dict) else pred.step_s > 0
    igg.finalize_global_grid()
    assert torch_cli(["calibrate", "--preset", "hierarchical"]) == 0
    canned = json.loads(capsys.readouterr().out)
    assert set(canned["axes"]) == {"gx", "gy", "gz"}


def test_device_commands_need_a_card_or_cpu(tmp_path, capsys, monkeypatch):
    """Without ``--cpu`` and without a card each device-touching command
    exits 2 with a message and touches nothing."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    q = tmp_path / "q.json"
    q.write_text(json.dumps(QUEUE))
    for argv in (["jobs", "submit", str(q), "--flight-dir", str(tmp_path / "fd")],
                 ["calibrate"], ["tune", "diffusion3d", "--no-measure"],
                 ["audit", "diffusion3d"],
                 ["reshard", "run", "--src-dims", "2,2,1", "--dst-dims", "1,2,2"]):
        assert torch_cli(argv) == 2, argv
        assert "pass --cpu" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "fd") and not tg.grid_is_initialized()


def test_jobs_resize_cli_consumed_by_live_schedulers(tmp_path, capsys):
    """``jobs resize`` filed by either package's CLI is consumed by a live
    port scheduler at its next slice boundary (the job re-blocks on the
    device path and ends bitwise its unresized twin); then unknown and
    finished jobs exit 3 and 4."""
    from implicitglobalgrid_tpu_torch.service import JobSpec, MeshScheduler, builtin_setup

    def twin():
        with MeshScheduler(flight_dir=str(tmp_path / "twin")) as s:
            s.submit(JobSpec(name="t", setup=builtin_setup("diffusion3d", "float64"), nt=12,
                             grid=dict(GRID_A, **CPU), run=tg.RunSpec(nt_chunk=3)))
            s.run()
            job = s.job("t")
            prev = ttop.swap_global_grid(job.gg)
            try:
                return np.asarray(tg.gather_interior(job.result["T"]))
            finally:
                ttop.swap_global_grid(prev)

    ref = twin()
    for i, cli in enumerate((torch_cli, jax_cli)):
        fd = str(tmp_path / f"fd{i}")
        with MeshScheduler(policy="round_robin", flight_dir=fd) as sched:
            for name in ("a", "b"):
                sched.submit(JobSpec(name=name, setup=builtin_setup("diffusion3d", "float64"),
                                     nt=12, grid=dict(GRID_A, **CPU),
                                     run=tg.RunSpec(nt_chunk=3)))
            for _ in range(3):
                sched.step()
            assert cli(["jobs", "resize", fd, "a", "1,2,2"]) == 0
            req = json.loads(capsys.readouterr().out)
            assert req["requested"] == "resize" and req["new_dims"] == [1, 2, 2]
            sched.run()
            assert sched.job("a").state == sched.job("b").state == "done"
            assert tuple(int(x) for x in sched.job("a").gg.dims) == (1, 2, 2)
            job = sched.job("a")
            prev = ttop.swap_global_grid(job.gg)
            try:
                assert np.array_equal(np.asarray(tg.gather_interior(job.result["T"])), ref)
            finally:
                ttop.swap_global_grid(prev)
        evs = [json.loads(x) for x in open(os.path.join(fd, "scheduler.jsonl"))]
        jr = next(e for e in evs if e.get("kind") == "job_resized")
        assert jr["job"] == "a" and jr["new_dims"] == [1, 2, 2] and jr["via"] == "device"
        assert cli(["jobs", "resize", fd, "nope", "1,2,2"]) == 3
        assert cli(["jobs", "resize", fd, "a", "2,2,1"]) == 4
        capsys.readouterr()


def test_tune_cli_subprocess_produce_and_show(tmp_path):
    """`tools tune` produce (``--cpu``) and ``show`` in fresh processes."""
    out = str(tmp_path / "tuned_diffusion3d.json")
    env = child_env(dict(os.environ))
    r = subprocess.run(
        [sys.executable, "-m", "implicitglobalgrid_tpu_torch.tools", "tune", "diffusion3d",
         "--cpu", "--nx", "12", "--no-measure", "--comm-every-options", "1;z:2", "--out", out],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout)["model"] == "diffusion3d" and os.path.exists(out)
    r2 = subprocess.run([sys.executable, "-m", "implicitglobalgrid_tpu_torch.tools", "tune",
                         "show", out], capture_output=True, text=True, env=env, timeout=120,
                        cwd=ROOT)
    assert r2.returncode == 0 and json.loads(r2.stdout)["model"] == "diffusion3d"


def test_prom_prints_the_port_registry(capsys):
    tg.metrics_registry().counter("igg_cli_test_total", "t").inc(1)
    assert torch_cli(["prom"]) == 0
    assert "igg_cli_test_total" in capsys.readouterr().out
