"""The port's closed-loop autoscaler on the CPU, held against the JAX
package's (`tests/test_autoscale.py`, every case but
`test_autoscale_drill_hlo_untouched`, an identity of compiled XLA programs
with no counterpart here):

- the policy and bounds validation, the fair policy's slack boost, the
  hysteresis (a bounced signal files nothing; a constant one matures, and
  the journal dedups), the vote reset;
- the rank pool (`MeshScheduler(nranks=)`, the JAX package's device count):
  one resolver for the candidate bound and the mesh utilization;
- the drill: a starved high-priority tenant grown and an idle one shrunk
  with no operator input, on the device path of `ResilientRun.resize`,
  every move priced, journaled, re-tuned and explained, both results
  bitwise their no-autoscale runs; and the same drill in both packages
  (the JAX package's 8 devices, the port's pool of 8 ranks) gives the same
  decisions: action, new dims, verdict and reason, boundary by boundary.
"""

import json
import os
import types

import numpy as np
import pytest

import implicitglobalgrid_tpu as igg
import implicitglobalgrid_tpu_torch as tg
from implicitglobalgrid_tpu_torch.parallel import topology as ttop
from implicitglobalgrid_tpu_torch.service import (
    Autoscaler, AutoscalePolicy, FairSharePolicy, Job, JobSpec, MeshScheduler,
    ScaleBounds, explain_autoscale, service_report,
)
from implicitglobalgrid_tpu_torch.telemetry import hooks
from implicitglobalgrid_tpu_torch.utils.exceptions import InvalidArgumentError

from torch_port_util import clean_torch_grid, to_np  # noqa: F401

pytestmark = pytest.mark.service

# hot: one block with room to grow (the global span 32 a dim re-blocks
# evenly at dims 1/2/4; at 16 the cost model prices the grow out); idle: a
# small grid spread over 4 ranks it does not need
GRID_HOT = dict(nx=34, ny=34, nz=34, dimx=1, dimy=1, dimz=1, overlaps=(2, 2, 2))
GRID_IDLE = dict(nx=10, ny=10, nz=10, dimx=2, dimy=2, dimz=1, overlaps=(2, 2, 2))
CPU = {"device_type": "cpu"}
NT, NT_CHUNK = 24, 3


@pytest.fixture(autouse=True)
def _clean_service():
    for pkg in (tg, igg):
        pkg.stop_flight_recorder()
        pkg.reset_metrics()
    ttop._retained_epochs.clear()
    yield
    ttop._retained_epochs.clear()


def _signals(slack, *, pending=0, name="hot", devices=1, priority=2):
    """A `MeshScheduler._live_signals`-shaped synthetic snapshot."""
    return {"jobs": {name: {"state": "running", "deadline_slack_s": slack,
                            "priority": priority, "devices": devices}},
            "queue": {"pending": pending, "queued": 0}}


class _StubSched:
    """The scheduler surface the policy engine touches."""

    def __init__(self, nranks=None):
        self.jobs = {}
        self.queue = None
        self.events = []
        self.nranks = nranks

    def _log(self, kind, **fields):
        self.events.append(dict(kind=kind, **fields))


def test_public_api_exports():
    for sym in ("Autoscaler", "AutoscalePolicy", "ScaleBounds", "explain_autoscale"):
        assert hasattr(tg.service, sym) and sym in tg.service.__all__, sym


def test_policy_and_bounds_validation(tmp_path):
    with pytest.raises(InvalidArgumentError, match="min_devices"):
        ScaleBounds(0)
    with pytest.raises(InvalidArgumentError, match="max_devices"):
        ScaleBounds(4, 2)
    with pytest.raises(InvalidArgumentError, match="via"):
        AutoscalePolicy(via="teleport")
    with pytest.raises(InvalidArgumentError, match="hysteresis"):
        AutoscalePolicy(hysteresis_slices=0)
    with pytest.raises(InvalidArgumentError, match="cooldown"):
        AutoscalePolicy(cooldown_slices=-1)
    with pytest.raises(InvalidArgumentError, match="ScaleBounds"):
        AutoscalePolicy(bounds={"a": (1, 2)})
    with pytest.raises(InvalidArgumentError, match="AutoscalePolicy"):
        Autoscaler(42)
    pol = AutoscalePolicy(bounds={"a": ScaleBounds(2, 4)})
    assert pol.bounds_for("a") == ScaleBounds(2, 4)
    assert pol.bounds_for("z") == ScaleBounds()
    assert pol.describe() == igg.service.AutoscalePolicy(
        bounds={"a": igg.service.ScaleBounds(2, 4)}).describe()
    assert Autoscaler({"hysteresis_slices": 3}).policy.hysteresis_slices == 3
    with pytest.raises(InvalidArgumentError, match="autoscale"):
        MeshScheduler(flight_dir=str(tmp_path), autoscale=123)


def test_fair_share_slack_boost_reprioritizes():
    pol = FairSharePolicy(low_slack_s=10.0, slack_boost=4.0, slack_horizon_s=20.0)
    jobs = []
    for i, slack in enumerate([None, 25.0, -15.0]):
        j = Job(JobSpec(name=f"j{i}", setup=lambda: None, nt=10), i)
        j.run = types.SimpleNamespace(deadline_slack_s=slack)
        jobs.append(j)
    for j in jobs:
        pol.granted(j, 8.0)
    assert (pol._boost(jobs[0]), pol._boost(jobs[1]), pol._boost(jobs[2])) == (1.0, 1.0, 5.0)
    assert pol.pick(jobs) is jobs[2]
    jobs[2].run.deadline_slack_s = 11.0
    assert pol._boost(jobs[2]) == 1.0
    assert pol.pick(jobs) is jobs[0]
    with pytest.raises(InvalidArgumentError, match="slack_boost"):
        FairSharePolicy(slack_boost=-1)
    with pytest.raises(InvalidArgumentError, match="slack_horizon_s"):
        FairSharePolicy(slack_horizon_s=0)


def test_bounced_signal_never_files_thrash_proof():
    a = Autoscaler(AutoscalePolicy(grow_slack_s=0.0, hysteresis_slices=3))
    reasons = []
    for i in range(12):
        for d in a.evaluate(_signals(-1.0 if i % 2 == 0 else 1.0)):
            reasons.append((d["verdict"], d["reason"]))
    assert reasons and set(reasons) == {("rejected", "hysteresis")}
    assert a.moves_filed == 0 and a.evaluations == 12
    assert a.decision_s_total > 0 and a.last_decision_s >= 0


def test_constant_pressure_matures_and_journal_dedups():
    reg = tg.metrics_registry()
    reg.reset(hooks.AUTOSCALE_DECISIONS)
    reg.reset(hooks.AUTOSCALE_REJECTED)
    sched = _StubSched()
    a = Autoscaler(AutoscalePolicy(grow_slack_s=0.0, hysteresis_slices=2), scheduler=sched)
    verdicts = [d["reason"] for _ in range(5) for d in a.evaluate(_signals(-1.0))]
    assert verdicts == ["hysteresis"] + ["no_live_job"] * 4
    assert [e["reason"] for e in sched.events if e["kind"] == "autoscale_decision"] == [
        "hysteresis", "no_live_job"]
    assert reg.get(hooks.AUTOSCALE_DECISIONS).value(action="grow", verdict="rejected") == 5.0
    rej = reg.get(hooks.AUTOSCALE_REJECTED)
    assert rej.value(reason="hysteresis") == 1.0 and rej.value(reason="no_live_job") == 4.0


def test_vote_reset_on_non_consecutive_boundary():
    a = Autoscaler(AutoscalePolicy(grow_slack_s=0.0, hysteresis_slices=2))
    assert a.evaluate(_signals(-1.0))[0]["streak"] == 1
    assert a.evaluate(_signals(5.0)) == []
    assert a.evaluate(_signals(-1.0))[0]["streak"] == 1


def test_same_pressure_sequence_same_decisions_and_pool():
    """A pressure sequence (slack, backlog, two jobs) gives the same
    decision records in both packages' engines, signals and utilization
    included, when the port's pool is the JAX package's device count (8);
    without a pool the utilization is None and nothing else changes."""
    def run(svc, sched):
        a = svc.Autoscaler(svc.AutoscalePolicy(grow_slack_s=2.0, hysteresis_slices=2,
                                               cooldown_slices=1), scheduler=sched)
        out = []
        for i in range(10):
            sig = {"jobs": {"hot": {"state": "running", "deadline_slack_s": 1.0 - i % 4,
                                    "priority": 2, "devices": 1},
                            "cold": {"state": "running", "deadline_slack_s": None,
                                     "priority": 1, "devices": 4}},
                   "queue": {"pending": i % 3, "queued": 0, "oldest_age_s": None}}
            out.append(a.evaluate(sig))
        return out, sched.events

    jax_sched = _StubSched()
    got_j = run(igg.service, jax_sched)
    assert got_j == run(tg.service, _StubSched(nranks=8))
    assert got_j[0][0][0]["signals"]["mesh_utilization"] == 5 / 8
    nopool = run(tg.service, _StubSched())
    assert nopool[0][0][0]["signals"]["mesh_utilization"] is None
    strip = json.loads(json.dumps(nopool).replace('"mesh_utilization": null',
                                                  '"mesh_utilization": 0.625'))
    assert strip == json.loads(json.dumps(got_j))


def test_rank_pool_bounds_the_candidates():
    """`Autoscaler.pool` (the scheduler's ``nranks``) caps a grow's
    candidates; without a pool only the job's `ScaleBounds` do."""
    tg.init_global_grid(**GRID_HOT, quiet=True, **CPU)
    job = types.SimpleNamespace(name="hot", gg=ttop.global_grid())
    for nranks, bounds, want in ((8, ScaleBounds(), {2}), (1, ScaleBounds(), set()),
                                 (None, ScaleBounds(), {2}), (None, ScaleBounds(1, 1), set())):
        a = Autoscaler(AutoscalePolicy(bounds={"hot": bounds}),
                       scheduler=_StubSched(nranks=nranks))
        assert a.pool() == nranks
        got = {c[0] * c[1] * c[2] for c, _ in a._candidate_dims(job, "grow")}
        assert got == want, (nranks, bounds)


# ---------------------------------------------------------------------------
# The drill
# ---------------------------------------------------------------------------

def _drill_specs(svc, RunSpec, dev):
    return [svc.JobSpec(name=name, setup=svc.builtin_setup("diffusion3d"), model="diffusion3d",
                        nt=NT, grid=dict(grid, **dev), run=RunSpec(nt_chunk=NT_CHUNK),
                        priority=pr, deadline_s=dl)
            for name, grid, pr, dl in (("hot", GRID_HOT, 2, 120.0), ("idle", GRID_IDLE, 1, None))]


def _drill_policy(svc):
    return svc.AutoscalePolicy(grow_slack_s=1e9, shrink_queue_pending=1, hysteresis_slices=2,
                               cooldown_slices=2, bounds={"hot": svc.ScaleBounds(1, 2),
                                                          "idle": svc.ScaleBounds(2, 8)})


def _decisions(d):
    return [(e["job"], e["action"], e["verdict"], e.get("reason"), e.get("new_dims"))
            for e in map(json.loads, open(os.path.join(d, "scheduler.jsonl")))
            if e["kind"] == "autoscale_decision"]


def _interior(pkg, sched, name):
    """Gathered interior of a finished job's result, under ITS grid."""
    top = ttop if pkg is tg else pkg.parallel.topology
    job = sched.job(name)
    prev = top.swap_global_grid(job.gg)
    try:
        return np.asarray(pkg.gather_interior(job.result["T"]))
    finally:
        top.swap_global_grid(prev)


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    """The drill in both packages (round robin, so the boundaries are the
    same), and the port's two tenants without the autoscaler."""
    root = tmp_path_factory.mktemp("drill")
    out = {}
    try:
        tg.reset_metrics()
        d = str(root / "torch")
        with MeshScheduler(policy="round_robin", flight_dir=d, autoscale=_drill_policy(tg.service),
                           nranks=8) as s:
            for spec in _drill_specs(tg.service, tg.RunSpec, CPU):
                s.submit(spec)
            s.run()
            tgt = tg.metrics_registry().get(hooks.JOB_TARGET_DEVICES)
            out["torch"] = dict(
                dir=d, states={n: (s.job(n).state, s.job(n).error) for n in ("hot", "idle")},
                dims={n: tuple(int(x) for x in s.job(n).gg.dims) for n in ("hot", "idle")},
                T={n: _interior(tg, s, n) for n in ("hot", "idle")},
                target={n: tgt.value(job=n) for n in ("hot", "idle")},
                counters={f: [(dict(lbl), v) for lbl, v in
                              tg.metrics_registry().get(f).samples()]
                          for f in (hooks.AUTOSCALE_DECISIONS, hooks.AUTOSCALE_RESIZES)})
        with MeshScheduler(policy="round_robin") as s:
            for spec in _drill_specs(tg.service, tg.RunSpec, CPU):
                s.submit(spec)
            s.run()
            out["solo"] = {n: _interior(tg, s, n) for n in ("hot", "idle")}
        d = str(root / "jax")
        with igg.service.MeshScheduler(policy="round_robin", flight_dir=d,
                                       autoscale=_drill_policy(igg.service)) as s:
            for spec in _drill_specs(igg.service, igg.RunSpec, {}):
                s.submit(spec)
            s.run()
            out["jax"] = dict(dir=d, T={n: _interior(igg, s, n) for n in ("hot", "idle")})
    finally:
        for pkg in (tg, igg):
            pkg.stop_flight_recorder()
        ttop._retained_epochs.clear()
    return out


def test_drill_grows_and_shrinks_bitwise(drill):
    """The loop converged with no operator input (hot 2x1x1, idle 1x2x1),
    through the device path of the resize, and both results are bitwise
    their no-autoscale runs; the per-job target gauge tracks the final
    allocation."""
    t = drill["torch"]
    assert t["states"] == {"hot": ("done", None), "idle": ("done", None)}
    assert t["dims"] == {"hot": (2, 1, 1), "idle": (1, 2, 1)}
    assert t["target"] == {"hot": 2.0, "idle": 2.0}
    for n in ("hot", "idle"):
        assert np.array_equal(t["T"][n], drill["solo"][n]), n
    resized = [e for e in map(json.loads, open(os.path.join(t["dir"], "scheduler.jsonl")))
               if e["kind"] == "job_resized"]
    assert resized and {e["via"] for e in resized} == {"device"}


def test_drill_decisions_equal_jax(drill):
    """Boundary by boundary, the same decisions (job, action, verdict,
    reason, new dims) in both packages, and final states within the JAX
    suite's float32 run bound."""
    dt, dj = _decisions(drill["torch"]["dir"]), _decisions(drill["jax"]["dir"])
    assert dt == dj
    assert {(j, a) for j, a, v, *_ in dt if v == "filed"} == {("hot", "grow"),
                                                              ("idle", "shrink")}
    for n in ("hot", "idle"):
        np.testing.assert_allclose(drill["torch"]["T"][n], drill["jax"]["T"][n],
                                   rtol=1e-5, atol=1e-4)


def test_drill_explainable_from_the_journal(drill):
    """`explain_autoscale` and `service_report` reconstruct every move's
    chain from the journal alone; every applied resize was priced, went
    through the control path and re-tuned; the counters track the
    journal."""
    d = drill["torch"]["dir"]
    rec = explain_autoscale(d)
    assert rec["policy"]["grow_slack_s"] == 1e9
    assert rec["filed"] >= 2 and rec["decisions"] > rec["filed"]
    assert rec["rejected_by_reason"].get("hysteresis", 0) >= 1
    applied = [m for m in rec["moves"] if m["applied"]]
    assert {(m["job"], m["action"]) for m in applied} >= {("hot", "grow"), ("idle", "shrink")}
    for m in applied:
        assert m["chain"] == ["autoscale_decision", "control", "resize_requested",
                              "job_resized", "job_retuned"], m
        be = m["pricing"]["break_even"]
        if m["action"] == "grow":
            assert be["within_horizon"] is True
            assert be["break_even_steps"] <= be["nt_remaining"]
        assert m["pricing"]["new_dims"] == m["new_dims"]
        assert m["signals"]["queue"] is not None
        assert m["signals"]["mesh_utilization"] is not None
    events = [json.loads(x) for x in open(os.path.join(d, "scheduler.jsonl"))]
    assert len([e for e in events if e["kind"] == "job_resized"]) == len(applied)
    retuned = [e for e in events if e["kind"] == "job_retuned"]
    assert len([e for e in retuned if e["reason"] == "resize"]) == len(applied)
    assert all("predicted_step_s" in e for e in retuned)
    rep = service_report(d, include_jobs=False)
    assert rep["autoscale"]["filed"] == rec["filed"]
    assert rep["jobs"]["hot"]["resizes"] >= 1 and rep["jobs"]["idle"]["resizes"] >= 1
    assert explain_autoscale(d) == igg.service.explain_autoscale(d)
    counters = {f: sum(v for _, v in c) for f, c in drill["torch"]["counters"].items()}
    assert counters[hooks.AUTOSCALE_DECISIONS] >= rec["decisions"]
    assert counters[hooks.AUTOSCALE_RESIZES] == rec["filed"]
