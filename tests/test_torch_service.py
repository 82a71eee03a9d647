"""The port's persistent-mesh service on the CPU, held against the JAX
package's (`tests/test_service.py`'s tier-1 cases and the scheduler halves
of `tests/test_tune.py`'s application cases):

- the policies, the scoped registry, `JobSpec` validation and the RunSpec
  shim;
- three tenants multiplexed through one scheduler with a fault in one: each
  tenant bitwise its solo `run_resilient`, the fault contained, the service
  report and the one-track-a-job trace;
- failure containment, cancel and drain, an elastic restart inside one
  tenant's slice, the slice counter, snapshot events attributed to their
  job, the scheduler-owned metrics server;
- the port's epoch-keyed caches: a finished job leaves no entry behind, and
  a re-admitted grid of the same shape never reuses a stale plan;
- tuned jobs (`RunSpec(tuned=)`, a tuned ensemble);
- both packages: the same `JobSpec`s and policy give the same journal
  sequence (event, job and slice, timestamps stripped) and final states
  within the JAX suite's run bounds (float32 rtol 1e-5 / atol 1e-4, float64
  rtol and atol 1e-12; `tests/test_torch_diffusion.py`), and a queue
  directory either package wrote is consumed by the other's scheduler.

The JAX jobs step its ``"xla"`` route; the port's builtin jobs step its
plain route (the same arithmetic).
"""

import json
import os
import urllib.request

import numpy as np
import pytest
import torch

import implicitglobalgrid_tpu as igg
import implicitglobalgrid_tpu_torch as tg
from implicitglobalgrid_tpu_torch.parallel import topology as ttop
from implicitglobalgrid_tpu_torch.service import (
    FairSharePolicy, FifoPolicy, Job, JobSpec, JobState, MeshScheduler,
    RoundRobinPolicy,
)
from implicitglobalgrid_tpu_torch.utils.exceptions import InvalidArgumentError

from torch_port_util import clean_torch_grid, to_np  # noqa: F401

pytestmark = pytest.mark.service

TOL = {np.float32: dict(rtol=1e-5, atol=1e-4),
       np.float64: dict(rtol=1e-12, atol=1e-12)}
GRID_A = dict(nx=6, ny=6, nz=6, dimx=2, dimy=2, dimz=1)
GRID_B = dict(nx=8, ny=8, nz=8, dimx=2, dimy=2, dimz=1)
CPU = {"device_type": "cpu"}


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


def _diffusion_setup():
    from implicitglobalgrid_tpu_torch.models import diffusion_step_local, init_diffusion3d

    T, Cp, p = init_diffusion3d(dtype=torch.float64)

    def step(s):
        return {"T": diffusion_step_local(s["T"], s["Cp"], p, "plain"), "Cp": s["Cp"]}

    return step, {"T": T, "Cp": Cp}


_SOLO: dict = {}


def _solo_reference(grid: dict, nt: int, nt_chunk: int):
    """Gathered interior of the port's uninterrupted solo `run_resilient`
    of one job configuration (memoized)."""
    key = (tuple(sorted(grid.items())), nt, nt_chunk)
    if key not in _SOLO:
        tg.init_global_grid(quiet=True, **grid, **CPU)
        step, state = _diffusion_setup()
        out, reports = tg.run_resilient(step, state, nt, nt_chunk=nt_chunk)
        assert all(r.ok for r in reports)
        _SOLO[key] = tg.gather_interior(out["T"])
        tg.finalize_global_grid()
    return _SOLO[key]


def _job(name, grid, nt, nt_chunk, *, priority=1, **run_kwargs):
    return JobSpec(name=name, setup=_diffusion_setup, nt=nt, grid=dict(grid, **CPU),
                   priority=priority, run=tg.RunSpec(nt_chunk=nt_chunk, **run_kwargs))


def _interior(sched, name):
    """Gathered interior of a finished job's result, under ITS grid."""
    job = sched.job(name)
    prev = ttop.swap_global_grid(job.gg)
    try:
        return tg.gather_interior(job.result["T"])
    finally:
        ttop.swap_global_grid(prev)


def _health():
    fam = tg.metrics_registry().get("igg_health_events_total")
    return {} if fam is None else {lbl["kind"]: int(v) for lbl, v in fam.samples()}


# ---------------------------------------------------------------------------
# Public API / RunSpec / JobSpec
# ---------------------------------------------------------------------------

def test_public_api_exports():
    for sym in ("service", "MeshScheduler", "JobSpec", "JobState", "RunSpec",
                "ResilientRun", "service_report", "export_service_trace"):
        assert hasattr(tg, sym) and sym in tg.__all__, sym
    missing = sorted(set(igg.__all__) - set(tg.__all__))
    assert missing == ["sharding_of"]
    assert sorted(tg.service.__all__) == sorted(igg.service.__all__)


def test_runspec_shim_and_validation():
    tg.init_global_grid(**GRID_A, quiet=True, **CPU)
    step, state = _diffusion_setup()
    with pytest.raises(InvalidArgumentError, match="not both"):
        tg.run_resilient(step, state, 4, spec=tg.RunSpec(), nt_chunk=2)
    with pytest.raises(TypeError):
        tg.run_resilient(step, state, 4, nt_chunkz=2)
    with pytest.raises(InvalidArgumentError, match="RunSpec"):
        JobSpec(name="x", setup=_diffusion_setup, nt=4, run={"nt_chunk": 2})
    with pytest.raises(InvalidArgumentError, match="priority"):
        JobSpec(name="x", setup=_diffusion_setup, nt=4, priority=0)
    with pytest.raises(InvalidArgumentError, match="name"):
        JobSpec(name="a/b", setup=_diffusion_setup, nt=4)
    with pytest.raises(InvalidArgumentError, match="deadline"):
        JobSpec(name="x", setup=_diffusion_setup, nt=4, deadline_s=0)
    assert tg.RunSpec(nt_chunk=7, audit=True).to_json() == {"nt_chunk": 7, "audit": True}


def test_jobspec_from_json_matches_jax():
    """One queue record gives the same spec in both packages, and the same
    typed errors for a typo'd knob or key."""
    rec = {"name": "j", "model": "acoustic3d", "nt": 6, "grid": {"nx": 8},
           "priority": 2, "deadline_s": 50.0, "run": {"nt_chunk": 3},
           "traceparent": "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"}
    a = tg.service.jobspec_from_json(dict(rec))
    b = igg.service.jobspec_from_json(dict(rec))
    for f in ("name", "nt", "grid", "priority", "deadline_s", "model"):
        assert getattr(a, f) == getattr(b, f), f
    assert a.run.to_json() == b.run.to_json()
    assert a.setup.__qualname__ == b.setup.__qualname__
    for bad, match in (({**rec, "run": {"nt_chunkz": 1}}, "run"),
                       ({**rec, "colour": 1}, "unknown"),
                       ({"name": "j"}, "missing"),
                       ({**rec, "model": "nope"}, "Unknown model")):
        with pytest.raises(InvalidArgumentError, match=match):
            tg.service.jobspec_from_json(bad)
        with pytest.raises(igg.exceptions.InvalidArgumentError, match=match):
            igg.service.jobspec_from_json(bad)


# ---------------------------------------------------------------------------
# Policies (host-only)
# ---------------------------------------------------------------------------

def _fake_jobs(*priorities):
    return [Job(JobSpec(name=f"j{i}", setup=lambda: None, nt=10, priority=pr), i)
            for i, pr in enumerate(priorities)]


def test_fifo_runs_to_completion_in_order():
    jobs = _fake_jobs(1, 1, 1)
    pol = FifoPolicy()
    assert pol.pick(jobs) is jobs[0] and pol.pick(jobs) is jobs[0]
    jobs[0].state = JobState.DONE
    assert pol.pick(jobs[1:]) is jobs[1]


def test_round_robin_cycles():
    jobs = _fake_jobs(1, 1, 1)
    pol = RoundRobinPolicy()
    assert [pol.pick(jobs).name for _ in range(6)] == ["j0", "j1", "j2"] * 2
    assert [pol.pick([jobs[0], jobs[2]]).name for _ in range(3)] == ["j0", "j2", "j0"]


def test_fair_share_weights_mesh_time_by_priority():
    jobs = _fake_jobs(1, 3)
    pol = FairSharePolicy()
    granted = {"j0": 0, "j1": 0}
    for _ in range(40):
        j = pol.pick(jobs)
        granted[j.name] += 1
        pol.granted(j, 0.1)
    assert granted["j1"] == 3 * granted["j0"]
    late = _fake_jobs(1, 1, 1)[2]
    late.index = 99
    assert pol.pick(jobs + [late]) is not late
    early = _fake_jobs(1)[0]
    early.index = 50
    pol._share[early.index] = 0.001
    later = _fake_jobs(1)[0]
    later.index = 100
    pol.pick(jobs + [later])
    assert pol._share[later.index] == min(pol._share[j.index] for j in jobs)


def test_policies_pick_as_jax_does():
    """Both packages' policies pick the same job sequence from the same
    table under the same feedback (slice seconds and deadline slack)."""
    def picks(svc):
        jobs = [svc.Job(svc.JobSpec(name=f"j{i}", setup=lambda: None, nt=10,
                                    priority=pr), i) for i, pr in enumerate((1, 2, 3, 1))]
        out = {}
        for name in ("fifo", "round_robin", "fair"):
            pol = svc.resolve_policy(name)
            seq = []
            for k in range(30):
                cands = [j for j in jobs if not (name == "fifo" and k > 10 and j.index == 0)]
                j = pol.pick(cands)
                seq.append(j.name)
                pol.granted(j, 0.05 * (1 + j.index % 3))
            out[name] = seq
        return out

    assert picks(tg.service) == picks(igg.service)


def test_resolve_policy_errors():
    from implicitglobalgrid_tpu_torch.service import resolve_policy

    assert resolve_policy("fair").name == "fair"
    assert resolve_policy(FifoPolicy).name == "fifo"
    with pytest.raises(InvalidArgumentError, match="Unknown scheduling"):
        resolve_policy("sjf")


def test_scoped_registry_namespaces_series():
    reg = tg.MetricsRegistry()
    a, b = reg.scoped(job="a"), reg.scoped(job="b")
    ga, gb = a.gauge("svc_step", "s"), b.gauge("svc_step", "s")
    ga.set(5)
    gb.set(9)
    fam = reg.get("svc_step")
    assert fam.labelnames == ("job",)
    assert {tuple(lbl.items()): v for lbl, v in fam.samples()} == {
        (("job", "a"),): 5.0, (("job", "b"),): 9.0}
    a.counter("svc_evt", "e", ("kind",)).inc(2, kind="x")
    assert reg.get("svc_evt").value(kind="x", job="a") == 2.0
    with pytest.raises(InvalidArgumentError, match="fixed by the registry"):
        ga.set(1, job="c")
    with pytest.raises(InvalidArgumentError, match="collide"):
        a.gauge("svc_bad", "x", ("job",))
    a.remove_scope()
    assert {lbl["job"] for lbl, _ in fam.samples()} == {"b"}
    with pytest.raises(InvalidArgumentError, match="at least one"):
        reg.scoped()


# ---------------------------------------------------------------------------
# Multiplexed tenants, fault isolation, bitwise identity
# ---------------------------------------------------------------------------

def test_three_jobs_multiplexed_fault_isolated_bitwise(tmp_path):
    """Three queued jobs (two grid sizes) multiplexed under round_robin; a
    NaN injected into job C trips C's guard only, C rolls back against its
    own checkpoints, and every job's final interior is bitwise its solo
    run. The directory reconstructs the interleaved schedule and renders
    one Perfetto track a job."""
    ref_a = _solo_reference(GRID_A, 12, 4)
    ref_b = _solo_reference(GRID_B, 12, 4)
    tg.reset_metrics()
    d = str(tmp_path / "svc")
    with MeshScheduler(policy="round_robin", flight_dir=d) as sched:
        sched.submit(_job("a", GRID_A, 12, 4))
        sched.submit(_job("b", GRID_B, 12, 4))
        sched.submit(_job("c", GRID_A, 12, 4, checkpoint_dir=str(tmp_path / "ck_c"),
                          faults=(tg.NaNPoke(step=8, name="T"),)))
        sched.run()
        assert sched.status()["states"] == {"done": 3}
        c = _health()
        assert c["guard_trips"] == 1 and c["rollbacks"] == 1
        assert all(r.ok for r in sched.job("a").reports)
        assert all(r.ok for r in sched.job("b").reports)
        assert sum(1 for r in sched.job("c").reports if not r.ok) == 1
        assert np.array_equal(_interior(sched, "a"), ref_a)
        assert np.array_equal(_interior(sched, "b"), ref_b)
        assert np.array_equal(_interior(sched, "c"), ref_a)
        assert sched.slices >= 9
    rep = tg.run_report(d)
    assert rep["policy"] == "round_robin" and set(rep["jobs"]) == {"a", "b", "c"}
    assert rep["switches"] > 0
    assert [s["job"] for s in rep["schedule"][:3]] == ["a", "b", "c"]
    assert rep["jobs"]["c"]["report"]["guards"]["trips"] == 1
    assert rep["jobs"]["a"]["report"]["guards"]["trips"] == 0
    assert rep["jobs"]["a"]["report"]["steps"]["completed"] == 12
    assert any(e["kind"] == "fault_injected" for e in rep["jobs"]["c"]["report"]["sequence"])
    assert not any(e["kind"] == "fault_injected"
                   for e in rep["jobs"]["a"]["report"]["sequence"])
    tr = tg.export_service_trace(d)
    assert tr["otherData"]["jobs"] == ["a", "b", "c"]
    assert {m["args"]["name"] for m in tr["traceEvents"]
            if m.get("name") == "process_name"} == {"scheduler", "job a", "job b", "job c"}
    assert len([e for e in tr["traceEvents"] if e.get("cat") == "slice"]) == rep["slices"]


def _journal_sequence(d):
    """The journal as (kind, job, slice, step) rows: no clock, no ids."""
    out = []
    for line in open(os.path.join(d, "scheduler.jsonl")):
        e = json.loads(line)
        if e["kind"] == "recorder_open":
            continue
        out.append((e["kind"], e.get("job"), e.get("slice"), e.get("step"),
                    e.get("state"), e.get("rule")))
    return out


_MODELS = (("diff", "diffusion3d", "float64", 12, dict(GRID_A, periodx=1)),
           ("wave", "acoustic3d", "float32", 10, GRID_B),
           ("stokes", "stokes3d", "float32", 6, GRID_A))


# The default rule pack's rules on wall-clock readings (checkpoint seconds,
# step-time regressions, deadline slack, barrier-arrival spreads): under load
# one package's timings can fire one of them where the other's do not, and the
# journals then differ by an alert record. Their firing is held in
# `tests/test_torch_live.py`; `guard_trip_storm`, which the NaN poke fires in
# both packages, stays in the comparison.
_CLOCKED_RULES = ("checkpoint_latency_blowout", "perf_regression_streak",
                  "deadline_slack_burn", "persistent_straggler")


def _unclocked_rule_pack(pkg):
    return [r for r in pkg.default_rule_pack() if r.name not in _CLOCKED_RULES]


def _builtin_run(pkg, d, policy, dev):
    svc = pkg.service
    ck = os.path.join(d, "ck")
    with svc.MeshScheduler(policy=policy, flight_dir=d,
                           alerts=_unclocked_rule_pack(pkg)) as s:
        for i, (name, model, dtype, nt, grid) in enumerate(_MODELS):
            faults = (pkg.NaNPoke(step=4, name="T", index=(3, 3, 3)),) if i == 0 else ()
            s.submit(svc.JobSpec(name=name, setup=svc.builtin_setup(model, dtype),
                                 nt=nt, grid=dict(grid, **dev), priority=1 + i % 2,
                                 model=model,
                                 run=pkg.RunSpec(nt_chunk=2, checkpoint_dir=ck + name,
                                                 checkpoint_every=1, faults=faults)))
        s.run()
        assert s.status()["states"] == {"done": 3}
        finals = {}
        for name, *_ in _MODELS:
            job = s.job(name)
            finals[name] = {k: (to_np(v) if pkg is tg else np.asarray(v))
                            for k, v in job.result.items()}
    return finals


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    """The same three builtin tenants (diffusion float64 with a NaN poke
    and a rollback, acoustic and Stokes float32) through both packages'
    round-robin schedulers (the fair policy picks by measured slice
    seconds, which differ between the packages)."""
    root = tmp_path_factory.mktemp("svc_both")
    out = {}
    try:
        for key, pkg, dev in (("jax", igg, {}), ("torch", tg, CPU)):
            d = str(root / key)
            out[key] = (d, _builtin_run(pkg, d, "round_robin", dev))
    finally:
        for pkg in (tg, igg):
            pkg.stop_flight_recorder()
        ttop._retained_epochs.clear()
    return out


def test_same_jobs_give_the_same_journal_sequence(both_runs):
    """Event, job and slice (and step, alert rule and state) of every
    journal record agree between the packages."""
    seq_t = _journal_sequence(both_runs["torch"][0])
    seq_j = _journal_sequence(both_runs["jax"][0])
    assert seq_t == seq_j
    kinds = {k for k, *_ in seq_t}
    assert {"job_submitted", "job_admitted", "slice", "job_done", "alert"} <= kinds


def test_final_states_within_the_run_bounds_of_jax(both_runs):
    """Every tenant's every field is within the JAX suite's run bound of
    JAX's final state (the poked tenant after its rollback included)."""
    ft, fj = both_runs["torch"][1], both_runs["jax"][1]
    for name, _, dtype, *_ in _MODELS:
        assert ft[name].keys() == fj[name].keys()
        for k in ft[name]:
            a, b = ft[name][k], fj[name][k]
            assert a.shape == b.shape and a.dtype == b.dtype, (name, k)
            assert np.all(np.isfinite(a))
            np.testing.assert_allclose(a, b, **TOL[np.dtype(dtype).type], err_msg=f"{name}.{k}")


def test_service_reports_agree_across_packages(both_runs):
    """Both packages' `service_report` read both directories to the same
    jobs, slices and guard trips (the per-job run reports included)."""
    def summary(rep):
        return ({n: (r["state"], r["slices"], r["step"], r["report"]["guards"]["trips"],
                     r["report"]["steps"]["completed"]) for n, r in rep["jobs"].items()},
                rep["slices"], rep["switches"], [s["job"] for s in rep["schedule"]])

    for key in ("torch", "jax"):
        d = both_runs[key][0]
        assert summary(tg.service_report(d)) == summary(igg.service_report(d))
    assert summary(tg.service_report(both_runs["torch"][0])) == \
        summary(tg.service_report(both_runs["jax"][0]))


def test_interleaved_builtin_tenants_bitwise_their_solo_runs(both_runs):
    """Each of the port's interleaved builtin tenants is bitwise its own
    solo `run_resilient` (the poked one after its rollback)."""
    ft = both_runs["torch"][1]
    for i, (name, model, dtype, nt, grid) in enumerate(_MODELS):
        tg.init_global_grid(quiet=True, **grid, **CPU)
        step, state = tg.service.builtin_setup(model, dtype)()
        out, _ = tg.run_resilient(step, state, nt, nt_chunk=2)
        for k, v in out.items():
            assert np.array_equal(to_np(v), ft[name][k]), (name, k)
        tg.finalize_global_grid()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_queue_directory_consumed_across_packages(tmp_path, writer):
    """A queue directory one package's `DirectoryBackend` wrote (two job
    records, one traced, and a cancel control file) is consumed by the
    other package's scheduler: the jobs run, the cancel lands, and the
    traced job's events carry the record's trace id."""
    consumer, wpkg = (tg, igg) if writer == "jax" else (igg, tg)
    d = str(tmp_path / "q")
    be = wpkg.service.DirectoryBackend(d)
    dev = CPU if consumer is tg else {}
    tid = "ab" * 16
    grid = dict(nx=8, ny=8, nz=8, dimx=2, dimy=1, dimz=1, **dev)
    be.submit({"name": "one", "model": "diffusion3d", "nt": 4, "grid": grid,
               "run": {"nt_chunk": 2}, "traceparent": f"00-{tid}-{'cd' * 8}-01"})
    be.submit({"name": "two", "model": "diffusion3d", "nt": 40, "grid": grid,
               "run": {"nt_chunk": 2}})
    with consumer.service.MeshScheduler(policy="round_robin", flight_dir=d) as s:
        s.run(max_slices=3)
        be.control("cancel", "two")
        s.run()
        assert s.job("one").state == "done"
        assert s.job("two").state == "cancelled"
    journal = [json.loads(x) for x in open(os.path.join(d, "scheduler.jsonl"))]
    claimed = [e for e in journal if e["kind"] == "job_claimed"]
    assert [e["job"] for e in claimed] == ["one", "two"]
    assert claimed[0]["trace_id"] == tid and "trace_id" not in claimed[1]
    assert be.pending_count() == 0


# ---------------------------------------------------------------------------
# Failure containment, cancel/drain, lifecycle
# ---------------------------------------------------------------------------

def _poisoned_setup():
    step, state = _diffusion_setup()
    state = dict(state)
    state["T"] = tg.poke_nan(state["T"], (0, 0, 0))
    return step, state


def test_failed_job_contained_cancel_and_drain(tmp_path):
    with MeshScheduler(policy="fifo", flight_dir=str(tmp_path / "svc")) as sched:
        sched.submit(JobSpec(name="bad", setup=_poisoned_setup, nt=8,
                             grid=dict(GRID_A, **CPU), run=tg.RunSpec(nt_chunk=4)))
        sched.submit(_job("good", GRID_A, 8, 4))
        sched.submit(_job("queued1", GRID_A, 8, 4))
        sched.submit(_job("queued2", GRID_B, 8, 4))
        sched.run(max_slices=2)
        assert sched.job("bad").state == JobState.FAILED
        assert "ResilienceError" in sched.job("bad").error
        assert sched.job("good").state == JobState.RUNNING
        sched.cancel("queued2")
        assert sched.job("queued2").state == JobState.CANCELLED
        sched.drain()
        assert sched.job("queued1").state == JobState.CANCELLED
        with pytest.raises(InvalidArgumentError, match="draining"):
            sched.submit(_job("late", GRID_A, 8, 4))
        sched.run()
        assert sched.status()["states"] == {"failed": 1, "done": 1, "cancelled": 2}
        assert sched.job("good").result is not None
    rep = tg.service_report(str(tmp_path / "svc"))
    assert rep["states"] == {"cancelled": 2, "done": 1, "failed": 1}
    assert rep["jobs"]["bad"]["error"]
    tr = tg.export_service_trace(str(tmp_path / "svc"))
    depths = [c["args"]["jobs"] for c in tr["traceEvents"] if c.get("name") == "igg_jobs_queued"]
    assert depths[-1] == 0 and min(depths) >= 0
    with pytest.raises(InvalidArgumentError, match="closed"):
        sched.submit(_job("x", GRID_A, 4, 2))


def test_elastic_restart_isolated(tmp_path):
    """Job B suffers a ProcessLoss (an elastic restart onto new dims inside
    B's slice); the scheduler tracks B's new grid, A keeps its own, and
    both end bitwise the solo run."""
    ref_a = _solo_reference(GRID_A, 12, 4)
    tg.reset_metrics()
    with MeshScheduler(policy="round_robin") as sched:
        sched.submit(_job("a", GRID_A, 12, 4))
        sched.submit(_job("b", GRID_A, 12, 4, checkpoint_dir=str(tmp_path / "ck_b"),
                          faults=(tg.ProcessLoss(step=8, new_dims=(1, 2, 2)),)))
        sched.run()
        assert sched.status()["states"] == {"done": 2}
        assert _health()["elastic_restarts"] == 1
        assert tuple(int(d) for d in sched.job("b").gg.dims) == (1, 2, 2)
        assert tuple(int(d) for d in sched.job("a").gg.dims) == (2, 2, 1)
        assert np.array_equal(_interior(sched, "a"), ref_a)
        assert np.array_equal(_interior(sched, "b"), ref_a)
        # the dead epoch of B's first grid is retired, the live ones held
        live = ttop.live_epochs()
        assert sched.job("a").gg.epoch not in live and sched.job("b").gg.epoch not in live


def test_scheduler_slice_counter_counts_grants_only():
    tg.reset_metrics()
    with MeshScheduler() as sched:
        assert sched.step() is False and sched.step() is False
        fam = tg.metrics_registry().get("igg_scheduler_slices_total")
        assert fam is None or fam.value() == 0
        assert tg.metrics_registry().get("igg_scheduler_heartbeat_timestamp_seconds").value() > 0


def test_async_snapshot_events_attributed_to_owning_job(tmp_path):
    d = str(tmp_path / "svc")
    with MeshScheduler(policy="round_robin", flight_dir=d) as sched:
        for name in ("a", "b"):
            sched.submit(_job(name, GRID_A, 8, 4, snapshot_dir=str(tmp_path / f"snaps_{name}"),
                              snapshot_every=4))
        sched.run()
        assert sched.status()["states"] == {"done": 2}
    for name in ("a", "b"):
        evs = tg.read_flight_events(os.path.join(d, f"job_{name}.jsonl"))
        writes = [e for e in evs if e["kind"] == "snapshot_write"]
        assert len(writes) == 2 and all(f"snaps_{name}" in e["path"] for e in writes)
        close = [e for e in evs if e["kind"] == "snapshot_writer_close"]
        assert len(close) == 1 and close[0]["written"] == 2


def test_submit_validation():
    with MeshScheduler() as sched:
        with pytest.raises(InvalidArgumentError, match="JobSpec"):
            sched.submit("nope")
        sched.submit(_job("a", GRID_A, 4, 2))
        with pytest.raises(InvalidArgumentError, match="already submitted"):
            sched.submit(_job("a", GRID_A, 4, 2))
        sched.cancel("a")
        assert sched.job("a").state == JobState.CANCELLED
        assert sched.run().status()["states"] == {"cancelled": 1}
    with pytest.raises(InvalidArgumentError, match="nranks"):
        MeshScheduler(nranks=0)


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read().decode()


def test_scheduler_owned_metrics_server_per_job_gauges():
    """The scheduler-owned endpoint outlives its jobs: per-job gauges and
    queue depth scrapeable after the tenants finished, /healthz judging
    the scheduler, a nested ``metrics_port`` attaching; all series and the
    server go with the scheduler."""
    tg.reset_metrics()
    with MeshScheduler(policy="round_robin", metrics_port=0) as sched:
        port = tg.metrics_server().port
        sched.submit(_job("a", GRID_A, 8, 4, metrics_port=0))
        sched.submit(_job("b", GRID_A, 8, 4))
        sched.run()
        assert tg.metrics_server() is not None
        status, body = _get(f"http://127.0.0.1:{port}/metrics")
        assert status == 200
        for line in ('igg_job_step{job="a"} 8', 'igg_job_step{job="b"} 8',
                     'igg_job_heartbeat_timestamp_seconds{job="a"}', "igg_jobs_queued 0",
                     "igg_scheduler_slices_total", 'igg_jobs_total{state="done"} 2'):
            assert line in body, line
        status, body = _get(f"http://127.0.0.1:{port}/healthz")
        rec = json.loads(body)
        assert status == 200 and rec["source"] == "scheduler"
        assert set(rec["job_ages_s"]) == {"a", "b"}
    assert tg.metrics_server() is None
    for name in ("igg_job_step", "igg_job_heartbeat_timestamp_seconds", "igg_job_slice_seconds"):
        fam = tg.metrics_registry().get(name)
        assert fam is None or fam.samples() == [], name


# ---------------------------------------------------------------------------
# Epoch-keyed caches and context switches
# ---------------------------------------------------------------------------

def _deep_setup():
    """A diffusion job on a deep cadence (fresh masks) that also calls the
    public `update_halo` (the charged plans) every step."""
    from implicitglobalgrid_tpu_torch.models import diffusion as D
    from implicitglobalgrid_tpu_torch.models import init_diffusion3d

    T, Cp, p = init_diffusion3d(dtype=torch.float64, comm_every=2)
    sstep, _ = D.deep_step(p)

    def step(s):
        T, Cp = sstep((s["T"], s["Cp"]))
        return {"T": tg.update_halo(T), "Cp": Cp}

    return step, {"T": T, "Cp": Cp}


def _epochs_cached():
    from implicitglobalgrid_tpu_torch.models import common
    from implicitglobalgrid_tpu_torch.ops import halo

    return {k[0] for k in halo._plan_cache} | {k[0] for k in common._masks}


def test_finished_jobs_leave_no_cache_entry_and_readmission_is_fresh():
    """Both jobs fill the port's epoch-keyed caches (the charged halo plans
    and the fresh masks) under their own epochs while they interleave; a
    finished job's entries are gone at once; a job re-admitted on a grid of
    the same shape gets a fresh epoch (no stale plan reused) and the same
    bitwise result."""
    grid = dict(nx=8, ny=8, nz=8, dimx=2, dimy=2, dimz=1, overlaps=(4, 4, 4),
                halowidths=(2, 2, 2), **CPU)
    seen = []
    with MeshScheduler(policy="round_robin") as sched:
        for name in ("a", "b"):
            sched.submit(JobSpec(name=name, setup=_deep_setup, nt=4, grid=grid,
                                 run=tg.RunSpec(nt_chunk=1)))
        while sched.step():
            seen.append(_epochs_cached())
        ea, eb = sched.job("a").gg.epoch, sched.job("b").gg.epoch
        assert ea != eb and any({ea, eb} <= s for s in seen)
        assert not ({ea, eb} & _epochs_cached())
        first = to_np(sched.job("a").result["T"])
        sched.submit(JobSpec(name="a2", setup=_deep_setup, nt=4, grid=grid,
                             run=tg.RunSpec(nt_chunk=1)))
        sched.step()
        e2 = sched.job("a2").gg.epoch
        assert e2 not in (ea, eb) and e2 in _epochs_cached()
        assert ea not in _epochs_cached()
        sched.run()
        assert np.array_equal(to_np(sched.job("a2").result["T"]), first)
        assert not _epochs_cached() & {e2}
    assert not ttop._retained_epochs


def test_swap_global_grid_preserves_epoch_and_outer_grid():
    tg.init_global_grid(**GRID_A, quiet=True, **CPU)
    outer = ttop.global_grid()
    epoch = outer.epoch
    with MeshScheduler() as sched:
        sched.submit(_job("a", GRID_A, 4, 2))
        sched.run()
        assert ttop.global_grid() is outer and outer.epoch == epoch
    assert tg.grid_is_initialized() and ttop.global_grid() is outer


def test_finished_result_is_drained_before_release(monkeypatch):
    """A finished job's state passes through `utils.timing.sync` (the
    card's drain) under the job's own grid before its epoch is released."""
    from implicitglobalgrid_tpu_torch.utils import timing

    calls = []
    real = timing.sync

    def spy(tree):
        calls.append((ttop.global_grid().epoch, ttop.global_grid().epoch in ttop.live_epochs()))
        return real(tree)

    monkeypatch.setattr(timing, "sync", spy)
    with MeshScheduler() as sched:
        sched.submit(_job("a", GRID_A, 4, 2))
        sched.run()
        assert calls == [(sched.job("a").gg.epoch, True)]


# ---------------------------------------------------------------------------
# Tuned jobs (the scheduler halves of tests/test_tune.py)
# ---------------------------------------------------------------------------

_TGRID = dict(nx=12, ny=12, nz=12, dimx=2, dimy=2, dimz=2, periodx=1, periody=1, periodz=1)


def _hier_profile(pkg):
    return pkg.MachineProfile(
        membw_GBps=800.0, flops_G=45000.0,
        axes={"gx": {"GBps": 45.0, "latency_s": 5e-6},
              "gy": {"GBps": 45.0, "latency_s": 5e-6},
              "gz": {"GBps": 2.0, "latency_s": 5e-4}})


def test_tune_runspec_scheduler_roundtrip(tmp_path):
    """tune_config -> persisted TunedConfig -> `RunSpec(tuned=path)` ->
    the scheduler loads and applies it at admission: the job runs the deep
    super-step on the tuned geometry, ``job_tuned`` is journaled, the
    driver records ``tuned``, and the result is bitwise the solo deep
    run."""
    from implicitglobalgrid_tpu_torch.models import init_diffusion3d, run_diffusion
    from implicitglobalgrid_tpu_torch.service import builtin_setup

    path = os.path.join(tmp_path, "tuned_diffusion3d.json")
    cfg = tg.tune_config("diffusion3d", dict(_TGRID, **CPU), _hier_profile(tg),
                         measure=False, comm_every_options=("1", "z:2"), path=path)
    assert cfg.comm_every == "z:2"
    jcfg = igg.tune_config("diffusion3d", dict(_TGRID), _hier_profile(igg), measure=False,
                           comm_every_options=("1", "z:2"))
    assert cfg.knobs() == jcfg.knobs()
    grid_kw = dict(cfg.grid["winner"], **CPU)
    tg.init_global_grid(**grid_kw)
    T, Cp, p = init_diffusion3d(dtype=torch.float32, comm_every="z:2")
    ref = to_np(run_diffusion(T, Cp, p, 4, nt_chunk=2))
    tg.finalize_global_grid()
    flight = os.path.join(tmp_path, "flight")
    with MeshScheduler(flight_dir=flight) as sched:
        sched.submit(JobSpec(name="tuned", setup=builtin_setup("diffusion3d", tuned=path),
                             nt=2, grid=grid_kw, run=tg.RunSpec(nt_chunk=1, tuned=path)))
        sched.run()
        job = sched.job("tuned")
        assert job.state == "done", job.error
        assert np.array_equal(to_np(job.result["T"]), ref)
    journal = [json.loads(x) for x in open(os.path.join(flight, "scheduler.jsonl"))]
    tuned_ev = [e for e in journal if e.get("kind") == "job_tuned"]
    assert tuned_ev and tuned_ev[0]["comm_every"] == "z:2"
    flight_ev = [json.loads(x) for x in open(os.path.join(flight, "job_tuned.jsonl"))]
    assert any(e.get("kind") == "tuned" for e in flight_ev)


def test_builtin_setup_rejects_model_mismatch():
    from implicitglobalgrid_tpu_torch.service import builtin_setup

    cfg = tg.TunedConfig(model="stokes3d", comm_every="z:2")
    with pytest.raises(InvalidArgumentError, match="refusing"):
        builtin_setup("diffusion3d", tuned=cfg)


def test_tuned_ensemble_fills_runspec():
    """A tuned ensemble becomes the job's batch size when the RunSpec left
    it unset; the port's batched step advances every member and member 0
    is bitwise the solo job."""
    from implicitglobalgrid_tpu_torch.service import builtin_setup

    cfg = tg.TunedConfig(model="diffusion3d", comm_every="1", ensemble=2)
    grid = dict(nx=8, ny=8, nz=8, dimx=2, dimy=2, dimz=2, **CPU)
    with MeshScheduler() as sched:
        sched.submit(JobSpec(name="batched", setup=builtin_setup("diffusion3d", tuned=cfg),
                             nt=2, grid=grid, run=tg.RunSpec(nt_chunk=2, tuned=cfg)))
        sched.submit(JobSpec(name="solo", setup=builtin_setup("diffusion3d"), nt=2,
                             grid=grid, run=tg.RunSpec(nt_chunk=2)))
        sched.run()
        job = sched.job("batched")
        assert job.state == "done", job.error
        assert job.run.ensemble == 2 and int(job.result["T"].shape[0]) == 2
        solo = to_np(sched.job("solo").result["T"])
        assert np.array_equal(to_np(job.result["T"][0]), solo)
        assert np.array_equal(to_np(job.result["T"][1]), solo)
