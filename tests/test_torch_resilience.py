"""The port's resilient driver (`implicitglobalgrid_tpu_torch.runtime.driver`)
on the CPU.

- The 20 tests of `tests/test_resilience.py` on the port, with their
  ``slow``, ``faults`` and ``ensemble`` marks: the acceptance bar is a final
  state bitwise the port's own uninterrupted run, not "the run survived".
  Where the JAX test asserts on the audit (``audit=True``), the port's
  counterpart asserts that the knob raises `NotSupportedError` (the audit
  is not ported) and runs the rest without it. With ``ensemble=E`` the
  port's step advances the whole batch (``members=E``), as its
  `make_state_runner(ensemble=)` steps do.
- Parity against the JAX package's `run_resilient` on the same seeded
  float64 diffusion state with the same faults (the plain route against
  ``"xla"``): the final state within the port's multi-step float64 bound
  (rtol 1e-12, `tests/test_torch_diffusion.py`), the reports' chunk
  boundaries, reasons and non-finite counts equal and their RMS within 1e-6
  relative; solo and at E = 2 with one member tripped.
- The checkpoint slots read across packages: each package's
  `_CheckpointSlots(root).restore()` restores the other's, and the
  ``LATEST`` pointers' JSON is the same.
- The knobs whose module is not ported (the audit's) raise
  `NotSupportedError` naming their ROADMAP item, and a bad endpoint port,
  an age limit without an endpoint or a malformed tuned config raise as the
  JAX package's do, each leaving no writer thread, endpoint or directory
  behind (the endpoint and the tuner themselves:
  `tests/test_torch_mesh_observability.py`, `tests/test_torch_tune.py`).
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import implicitglobalgrid_tpu as igg
import implicitglobalgrid_tpu_torch as tg
from implicitglobalgrid_tpu_torch.utils.exceptions import (
    InvalidArgumentError, NotSupportedError, ResilienceError,
)

from torch_port_util import clean_torch_grid, init_both, to_np  # noqa: F401

RTOL64 = dict(rtol=1e-12, atol=1e-12)  # the port's multi-step float64 bound
RMS_RTOL = 1e-6  # the guard's float32 sums of squares, in another order


def _counters():
    """The port's ``igg_health_events_total`` family as a dict."""
    fam = tg.metrics_registry().get("igg_health_events_total")
    return {} if fam is None else {l["kind"]: int(v) for l, v in fam.samples()}


def _reset_counters():
    tg.metrics_registry().reset("igg_health_events_total")


@pytest.fixture(autouse=True)
def _clean_telemetry():
    tg.stop_flight_recorder()
    tg.reset_metrics()
    yield
    tg.stop_flight_recorder()
    tg.reset_metrics()


def _init(dimx=2, dimy=2, dimz=1):
    tg.init_global_grid(6, 6, 6, dimx=dimx, dimy=dimy, dimz=dimz, quiet=True,
                        device_type="cpu")


def _diffusion_step():
    from implicitglobalgrid_tpu_torch.models import diffusion_step_local, init_diffusion3d

    T, Cp, p = init_diffusion3d(dtype=torch.float64)

    def step(s):
        return {"T": diffusion_step_local(s["T"], s["Cp"], p, "plain"), "Cp": s["Cp"]}

    return step, {"T": T, "Cp": Cp}


_REF_CACHE: dict = {}


def _reference_run(tmp_path, nt=20, nt_chunk=5):
    """Uninterrupted reference: the same driver, no faults; the gathered
    interior (the comparison target whatever the decomposition)."""
    key = (nt, nt_chunk)
    if key in _REF_CACHE:
        return _REF_CACHE[key]
    _init()
    step, state = _diffusion_step()
    ref, reports = tg.run_resilient(step, state, nt, nt_chunk=nt_chunk, key="resil_ref",
                                    checkpoint_dir=str(tmp_path / "ck_ref"))
    assert all(r.ok for r in reports)
    P = tg.gather_interior(ref["T"])
    tg.finalize_global_grid()
    _REF_CACHE[key] = P
    return P


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def test_public_api_exports():
    for sym in ("run_resilient", "ResilientRun", "RunSpec", "HealthReport", "GuardConfig",
                "RecoveryPolicy", "NaNPoke", "CheckpointCorruption",
                "ProcessLoss", "poke_nan", "corrupt_checkpoint",
                "elastic_restart", "restore_checkpoint_elastic",
                "saved_topology", "elastic_local_size", "metrics_registry",
                "start_flight_recorder", "run_report", "PerfWatch"):
        assert hasattr(tg, sym), sym
        assert sym in tg.__all__, sym
    for gone in ("health_counters", "record_health_event", "reset_health_counters"):
        assert not hasattr(tg, gone), gone
        assert gone not in tg.__all__, gone


def test_public_api_importable_in_subprocess():
    """A fresh interpreter imports the port and resolves the runtime entry
    point (catches import cycles an already-imported session would mask)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c",
         "import implicitglobalgrid_tpu_torch as igg; igg.run_resilient; igg.run_report"],
        capture_output=True, text=True, timeout=120, cwd=root)
    assert proc.returncode == 0, proc.stderr[-2000:]


# ---------------------------------------------------------------------------
# Healthy-path semantics
# ---------------------------------------------------------------------------

def test_unsupervised_equivalence_and_reports(tmp_path):
    """With no faults, run_resilient is the chunked runner plus reports:
    the trajectory of run_diffusion, one report a chunk."""
    from implicitglobalgrid_tpu_torch.models import init_diffusion3d, run_diffusion

    _init()
    step, state = _diffusion_step()
    out, reports = tg.run_resilient(step, state, 15, nt_chunk=5, key="resil_eq")
    T0, Cp, p = init_diffusion3d(dtype=torch.float64)
    T_ref = run_diffusion(T0, Cp, p, 15, nt_chunk=5, impl="plain")
    assert torch.equal(out["T"], T_ref)
    assert len(reports) == 3 and all(r.ok for r in reports)
    assert [r.step_begin for r in reports] == [0, 5, 10]
    assert reports[-1].step_end == 15
    assert all(r.nonfinite == {"T": 0, "Cp": 0} for r in reports)
    assert all(r.rms["T"] > 0 for r in reports)


@pytest.mark.slow
def test_health_counters_record_and_reset(tmp_path):
    _reset_counters()
    _init()
    step, state = _diffusion_step()
    tg.run_resilient(step, state, 10, nt_chunk=5, key="resil_cnt",
                     checkpoint_dir=str(tmp_path / "ck"))
    c = _counters()
    assert c["chunks"] == 2
    assert c["checkpoints_saved"] == 3  # initial + one per chunk boundary
    assert "guard_trips" not in c
    _reset_counters()
    assert _counters() == {}


def test_terminal_checkpoint_saved_off_cadence(tmp_path):
    """nt % checkpoint_every != 0 still saves the TERMINAL state, so a
    follow-on run resumes from step nt."""
    from implicitglobalgrid_tpu_torch.runtime.driver import _CheckpointSlots

    _init()
    step, state = _diffusion_step()
    out, reports = tg.run_resilient(step, state, 12, nt_chunk=5, key="resil_final",
                                    checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=5)
    st, at, fellback = _CheckpointSlots(str(tmp_path / "ck")).restore()
    assert at == 12 and not fellback
    assert torch.equal(st["T"], out["T"])


@pytest.mark.slow
def test_terminal_checkpoint_on_cadence_single_save(tmp_path):
    from implicitglobalgrid_tpu_torch.runtime.driver import _CheckpointSlots

    _init()
    step, state = _diffusion_step()
    _reset_counters()
    out, reports = tg.run_resilient(step, dict(state), 10, nt_chunk=5, key="resil_final2",
                                    checkpoint_dir=str(tmp_path / "ck2"), checkpoint_every=5)
    assert _counters()["checkpoints_saved"] == 3  # init + 5 + 10
    st, at, _ = _CheckpointSlots(str(tmp_path / "ck2")).restore()
    assert at == 10


def test_guard_trip_without_checkpoint_is_fatal():
    _init()
    step, state = _diffusion_step()
    state["T"] = tg.poke_nan(state["T"], (0, 0, 0))
    with pytest.raises(ResilienceError, match="nonfinite:T"):
        tg.run_resilient(step, state, 10, nt_chunk=5, key="resil_fatal")


def test_rms_guard_trips():
    _init()
    step, state = _diffusion_step()
    with pytest.raises(ResilienceError, match="rms:T"):
        tg.run_resilient(step, state, 10, nt_chunk=5, key="resil_rms",
                         guard=tg.GuardConfig(rms_limit={"T": 1e-30}))


def test_state_validation():
    """The JAX package's validation; its audit lints (a typo'd rule, a rule
    without ``audit=True``) are refused here before any check, since the
    audit is not ported (ROADMAP item 3)."""
    _init()
    step, state = _diffusion_step()
    with pytest.raises(InvalidArgumentError, match="non-empty dict"):
        tg.run_resilient(step, (state["T"],), 10)
    with pytest.raises(InvalidArgumentError, match="unknown field"):
        tg.run_resilient(step, state, 10, faults=[tg.NaNPoke(step=1, name="nope")])
    with pytest.raises(InvalidArgumentError, match="step range"):
        tg.run_resilient(step, state, 10, faults=[tg.NaNPoke(step=99, name="T")])
    with pytest.raises(InvalidArgumentError, match="stacked shape"):
        tg.run_resilient(step, state, 10, faults=[tg.NaNPoke(step=1, name="T",
                                                             index=(12, 0, 0))])
    with pytest.raises(NotSupportedError, match="item 3"):
        tg.run_resilient(step, state, 10, audit_lints=("host-transfer",))
    with pytest.raises(NotSupportedError, match="item 3"):
        tg.run_resilient(step, state, 10, audit=True, audit_lints=("host-transfr",))


# ---------------------------------------------------------------------------
# The fault-injection matrix
# ---------------------------------------------------------------------------

@pytest.mark.faults
def test_nan_injection_rollback_bit_identical(tmp_path):
    """NaN at step 12 -> the guard trips within one chunk -> rollback to the
    last good save -> the run ends bitwise the uninterrupted reference."""
    P_ref = _reference_run(tmp_path)

    _init()
    _reset_counters()
    step, state = _diffusion_step()
    out, reports = tg.run_resilient(
        step, state, 20, nt_chunk=5, key="resil_nan", checkpoint_dir=str(tmp_path / "ck"),
        faults=[tg.NaNPoke(step=12, name="T", index=(0, 0, 0))])
    tripped = [r for r in reports if not r.ok]
    assert len(tripped) == 1
    assert tripped[0].step_begin == 12 and tripped[0].step_end <= 17
    assert tripped[0].reasons == ("nonfinite:T",)
    assert tripped[0].nonfinite["T"] > 0
    c = _counters()
    assert c["guard_trips"] == 1 and c["rollbacks"] == 1
    assert np.array_equal(tg.gather_interior(out["T"]), P_ref)


@pytest.mark.faults
def test_process_loss_elastic_restart_identical(tmp_path):
    """Simulated process loss at step 13: state abandoned, grid re-inited
    with dims=(1,2,2), the last good checkpoint redistributed, the lost
    steps recomputed — the final interior equals the reference on the
    ORIGINAL decomposition. The JAX test's ``audit=True`` raises here (the
    audit is not ported); the stream holds no audit event."""
    P_ref = _reference_run(tmp_path)

    _init()
    step, state = _diffusion_step()
    with pytest.raises(NotSupportedError, match="item 3"):
        tg.run_resilient(step, state, 20, nt_chunk=5, audit=True,
                         checkpoint_dir=str(tmp_path / "ck"))
    assert not (tmp_path / "ck").exists()  # refused before any directory
    _reset_counters()
    tg.start_flight_recorder(str(tmp_path / "fr.jsonl"))
    try:
        out, reports = tg.run_resilient(
            step, state, 20, nt_chunk=5, key="resil_loss", checkpoint_dir=str(tmp_path / "ck"),
            faults=[tg.ProcessLoss(step=13, new_dims=(1, 2, 2))])
    finally:
        tg.stop_flight_recorder()
    gg = tg.global_grid()
    assert tuple(int(d) for d in gg.dims) == (1, 2, 2)  # the run ended elastic
    assert _counters()["elastic_restarts"] == 1
    assert np.array_equal(tg.gather_interior(out["T"]), P_ref)
    evs = tg.read_flight_events(str(tmp_path / "fr.jsonl"))
    assert not [e for e in evs if e.get("kind") == "audit"]
    [er] = [e for e in evs if e.get("kind") == "elastic_restart"]
    assert er["new_dims"] == [1, 2, 2] and er["to_step"] == 10


@pytest.mark.faults
@pytest.mark.slow
def test_nan_after_elastic_restart_rolls_back_on_new_grid(tmp_path):
    P_ref = _reference_run(tmp_path)

    _init()
    _reset_counters()
    step, state = _diffusion_step()
    out, reports = tg.run_resilient(
        step, state, 20, nt_chunk=5, key="resil_combo", checkpoint_dir=str(tmp_path / "ck"),
        faults=[tg.ProcessLoss(step=13, new_dims=(1, 2, 2)), tg.NaNPoke(step=14, name="T")])
    c = _counters()
    assert c["elastic_restarts"] == 1
    assert c["guard_trips"] == 1 and c["rollbacks"] == 1
    assert np.array_equal(tg.gather_interior(out["T"]), P_ref)


@pytest.mark.faults
def test_checkpoint_corruption_falls_back_to_other_slot(tmp_path):
    """The newest checkpoint bit-flipped after its save: the rollback
    DETECTS it (content checksum), falls back to the other slot, recomputes
    and still matches the reference."""
    P_ref = _reference_run(tmp_path)

    _init()
    _reset_counters()
    step, state = _diffusion_step()
    out, reports = tg.run_resilient(
        step, state, 20, nt_chunk=5, key="resil_corrupt", checkpoint_dir=str(tmp_path / "ck"),
        faults=[tg.CheckpointCorruption(save_index=2, kind="bitflip"),
                tg.NaNPoke(step=12, name="T")])
    c = _counters()
    assert c["rollbacks"] == 1 and c["restore_fallbacks"] == 1
    assert np.array_equal(tg.gather_interior(out["T"]), P_ref)


@pytest.mark.faults
@pytest.mark.parametrize("kind,target", [
    pytest.param("truncate", "shard", marks=pytest.mark.slow),
    ("delete", "shard"),
    pytest.param("bitflip", "meta", marks=pytest.mark.slow),
])
def test_corruption_matrix_both_slots_fatal(tmp_path, kind, target):
    """Corrupting EVERY slot (here: the only save) ends in a clean typed
    failure, never a garbage restore."""
    _init()
    step, state = _diffusion_step()
    with pytest.raises(ResilienceError, match="No checkpoint slot"):
        tg.run_resilient(
            step, state, 10, nt_chunk=5, key=("resil_cm", kind, target),
            checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=100,
            faults=[tg.CheckpointCorruption(save_index=0, kind=kind, target=target),
                    tg.NaNPoke(step=7, name="T")])


@pytest.mark.faults
def test_persistent_failure_escalates_then_exhausts(tmp_path):
    """A fault rollback cannot cure (the step itself poisons the state)
    shrinks the chunk (escalation hook called), then exhausts the bounded
    retry budget with a typed error."""
    _init()
    step, state = _diffusion_step()

    def poisoned(s):
        out = step(s)
        return {"T": tg.poke_nan(out["T"], (0, 0, 0)), "Cp": out["Cp"]}

    _reset_counters()
    seen = []
    with pytest.raises(ResilienceError, match="retry budget"):
        tg.run_resilient(
            poisoned, state, 20, nt_chunk=8, key="resil_poison",
            checkpoint_dir=str(tmp_path / "ck"),
            policy=tg.RecoveryPolicy(max_retries=3, shrink_chunk_after=2,
                                     on_escalate=seen.append))
    c = _counters()
    assert c["guard_trips"] == 4  # max_retries + the final fatal trip
    assert c["escalations"] >= 1
    assert seen and seen[0]["nt_chunk"] < 8


@pytest.mark.faults
def test_elastic_restart_requires_checkpoint_dir():
    _init()
    step, state = _diffusion_step()
    with pytest.raises(ResilienceError, match="no checkpoint_dir"):
        tg.run_resilient(step, state, 10, nt_chunk=5, key="resil_nockpt",
                         faults=[tg.ProcessLoss(step=5, new_dims=(1, 2, 2))])


# ---------------------------------------------------------------------------
# Ensemble axis: per-member fault isolation
# ---------------------------------------------------------------------------

def _ensemble_setup(E):
    from implicitglobalgrid_tpu_torch.models import (
        diffusion_step_local, ensemble_state, init_diffusion3d,
    )

    T, Cp, p = init_diffusion3d(dtype=torch.float64)
    state = {"T": ensemble_state(T, E, perturb=0.01), "Cp": ensemble_state(Cp, E)}

    def step(s):
        return {"T": diffusion_step_local(s["T"], s["Cp"], p, "plain", members=E),
                "Cp": s["Cp"]}

    return step, state


@pytest.mark.faults
@pytest.mark.ensemble
def test_ensemble_member_fault_isolated_rollback(tmp_path):
    """NaN poked into member 2 of an E=4 batch trips that member alone; the
    driver pins the healthy members' committed output and replays from the
    last good save (``member_rollback`` then ``member_splice``), and the
    final batch is bitwise the unfaulted ensemble run."""
    E = 4
    _init()
    step, state = _ensemble_setup(E)
    ref, ref_reports = tg.run_resilient(step, state, 12, nt_chunk=3, key="ens_resil",
                                        ensemble=E, checkpoint_dir=str(tmp_path / "ck_ref"))
    assert len(ref_reports) == 4 * E
    assert all(r.ok for r in ref_reports)
    assert {r.member for r in ref_reports} == set(range(E))

    _reset_counters()
    tg.start_flight_recorder(str(tmp_path / "fr.jsonl"))
    try:
        out, reports = tg.run_resilient(
            step, state, 12, nt_chunk=3, key="ens_resil", ensemble=E,
            checkpoint_dir=str(tmp_path / "ck"),
            faults=[tg.NaNPoke(step=6, name="T", index=(2, 0, 0, 0))])
    finally:
        tg.stop_flight_recorder()
    tripped = [r for r in reports if not r.ok]
    assert [r.member for r in tripped] == [2]
    assert tripped[0].reasons == ("nonfinite:T",)
    assert tripped[0].step_begin == 6
    c = _counters()
    assert c["guard_trips"] == 1 and c["rollbacks"] == 1
    assert c["member_rollbacks"] == 1
    evs = tg.read_flight_events(str(tmp_path / "fr.jsonl"))
    mr = [e for e in evs if e.get("kind") == "member_rollback"]
    ms = [e for e in evs if e.get("kind") == "member_splice"]
    assert len(mr) == 1 and mr[0]["members"] == [2] and sorted(mr[0]["pinned"]) == [0, 1, 3]
    assert len(ms) == 1 and sorted(ms[0]["members"]) == [0, 1, 3]
    assert torch.equal(out["T"], ref["T"])
    fam = tg.metrics_registry().get("igg_member_guard_trips_total")
    assert {l["member"]: v for l, v in fam.samples()} == {"2": 1.0}


@pytest.mark.faults
@pytest.mark.ensemble
@pytest.mark.slow
def test_ensemble_two_members_tripped_same_chunk(tmp_path):
    E = 8
    _init()
    step, state = _ensemble_setup(E)
    ref, _ = tg.run_resilient(step, state, 9, nt_chunk=3, key="ens_resil8", ensemble=E,
                              checkpoint_dir=str(tmp_path / "ck_ref"))
    _reset_counters()
    out, reports = tg.run_resilient(
        step, state, 9, nt_chunk=3, key="ens_resil8", ensemble=E,
        checkpoint_dir=str(tmp_path / "ck"),
        faults=[tg.NaNPoke(step=3, name="T", index=(1, 0, 0, 0)),
                tg.NaNPoke(step=3, name="T", index=(5, 1, 1, 1))])
    tripped = [r for r in reports if not r.ok]
    assert sorted(r.member for r in tripped) == [1, 5]
    c = _counters()
    assert c["guard_trips"] == 1 and c["member_rollbacks"] == 1
    assert torch.equal(out["T"], ref["T"])


# ---------------------------------------------------------------------------
# Fault primitives
# ---------------------------------------------------------------------------

def test_poke_nan_targets_one_cell():
    _init()
    T = tg.ones_g()
    h = tg.poke_nan(T, (3, 4, 5)).numpy()
    assert np.isnan(h[3, 4, 5]) and np.isfinite(
        np.delete(h.ravel(), np.ravel_multi_index((3, 4, 5), h.shape))).all()
    assert torch.isfinite(T).all()  # the input is not written


def test_corrupt_checkpoint_validation(tmp_path):
    _init()
    d = str(tmp_path / "ck")
    tg.save_checkpoint_sharded(d, {"A": tg.ones_g()})
    with pytest.raises(InvalidArgumentError, match="kind"):
        tg.corrupt_checkpoint(d, kind="nope")
    with pytest.raises(InvalidArgumentError, match="target"):
        tg.corrupt_checkpoint(d, target="nope")
    with pytest.raises(InvalidArgumentError, match="no such"):
        tg.corrupt_checkpoint(str(tmp_path / "missing"))


# ---------------------------------------------------------------------------
# Knobs whose module is not ported
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("knob,item", [
    (dict(metrics_port=-1), "port"), (dict(healthz_max_age_s=5.0), "needs metrics_port"),
    (dict(tuned={"comm_every": "1"}), "malformed"), (dict(audit=True), "item 3"),
    (dict(audit_lints=()), "item 3"),
])
def test_unported_knobs_raise_before_any_resource(tmp_path, knob, item):
    """The audit's knobs (not ported) raise `NotSupportedError` naming their
    ROADMAP item; a bad endpoint port, an age limit without an endpoint and
    a malformed tuned config raise as the JAX package's do. All before any
    resource comes up."""
    _init()
    step, state = _diffusion_step()
    threads = {t.name for t in threading.enumerate()}
    error = NotSupportedError if "item" in item else (InvalidArgumentError, OverflowError)
    with pytest.raises(error, match=item):
        tg.run_resilient(step, state, 10, nt_chunk=5, checkpoint_dir=str(tmp_path / "ck"),
                         snapshot_dir=str(tmp_path / "s"), **knob)
    assert not (tmp_path / "ck").exists() and not (tmp_path / "s").exists()
    assert {t.name for t in threading.enumerate()} <= threads  # no writer thread
    assert tg.metrics_server() is None


def test_resize_and_apply_tuned_raise(tmp_path):
    """`resize` needs reshard (not ported); `apply_tuned` takes only a
    `TunedConfig`, as the JAX package's."""
    _init()
    step, state = _diffusion_step()
    run = tg.ResilientRun(step, state, 10, tg.RunSpec(nt_chunk=5))
    try:
        with pytest.raises(NotSupportedError, match="item 4"):
            run.resize((1, 2, 2))
        with pytest.raises(InvalidArgumentError, match="TunedConfig"):
            run.apply_tuned(object())
        run.clear_tuned()
        assert run.tuned is None and not run.tuned_stale
        assert run.advance() and run.step == 5 and not run.done
        assert not run.advance() and run.done
    finally:
        run.close()


def test_spec_and_keywords_exclusive_and_spec_json():
    _init()
    step, state = _diffusion_step()
    with pytest.raises(InvalidArgumentError, match="not both"):
        tg.run_resilient(step, state, 5, spec=tg.RunSpec(), nt_chunk=5)
    from implicitglobalgrid_tpu.runtime.spec import RunSpec as JSpec

    assert [f for f in tg.RunSpec.__dataclass_fields__] == \
        [f for f in JSpec.__dataclass_fields__]
    for f in JSpec.__dataclass_fields__.values():
        assert tg.RunSpec.__dataclass_fields__[f.name].default == f.default, f.name
    spec = dict(nt_chunk=7, checkpoint_dir="/x", faults=(tg.NaNPoke(1, "T"),), perf_window=0)
    assert tg.RunSpec(**spec).to_json() == JSpec(**spec).to_json()


# ---------------------------------------------------------------------------
# Parity with the JAX package's driver
# ---------------------------------------------------------------------------

def _seeded_pair(shape=(12, 12, 6), members=None):
    """The same seeded float64 diffusion state on both packages, with each
    package's parameters of the live grids."""
    from implicitglobalgrid_tpu.models import init_diffusion3d as j_init
    from implicitglobalgrid_tpu_torch.models import init_diffusion3d as t_init

    g = np.random.default_rng(29)
    T = 1 + g.random(shape)
    Cp = 1 + g.random(shape)
    _, _, pj = j_init(dtype=np.float64)
    _, _, pt = t_init(dtype=torch.float64)
    sj = {"T": igg.device_put_g(T), "Cp": igg.device_put_g(Cp)}
    st = {"T": tg.device_put_g(T), "Cp": tg.device_put_g(Cp)}
    if members:
        from implicitglobalgrid_tpu.models import ensemble_state as j_ens

        sj = {"T": j_ens(sj["T"], members, perturb=0.01), "Cp": j_ens(sj["Cp"], members)}
        st = {"T": tg.ensemble_state(st["T"], members, perturb=0.01),
              "Cp": tg.ensemble_state(st["Cp"], members)}
    return sj, st, pj, pt


def _steps(pj, pt, members=None):
    from implicitglobalgrid_tpu.models import diffusion_step_local as j_step
    from implicitglobalgrid_tpu_torch.models import diffusion_step_local as t_step

    def sj(s):
        return {"T": j_step(s["T"], s["Cp"], pj, "xla"), "Cp": s["Cp"]}

    def st(s):
        return {"T": t_step(s["T"], s["Cp"], pt, "plain", members=members), "Cp": s["Cp"]}

    return sj, st


def _reports_match(rj, rt):
    assert len(rj) == len(rt)
    for a, b in zip(rj, rt):
        assert (a.chunk, a.step_begin, a.step_end, a.member) == \
            (b.chunk, b.step_begin, b.step_end, b.member)
        assert a.reasons == b.reasons and a.nonfinite == b.nonfinite
        for k in a.rms:
            assert b.rms[k] == pytest.approx(a.rms[k], rel=RMS_RTOL), k


@pytest.mark.faults
def test_rollback_run_matches_jax(tmp_path):
    """The same faults on both drivers: a NaN rollback and a corrupted slot
    falling back. The final state within the float64 bound, the reports
    alike, and the port's run bitwise its own uninterrupted run."""
    init_both(6, 6, 6, dimx=2, dimy=2, dimz=1, nranks=4)
    sj, st, pj, pt = _seeded_pair()
    fj, ft = _steps(pj, pt)
    kw = dict(nt_chunk=5, checkpoint_every=5)
    faults = [igg.CheckpointCorruption(save_index=2, kind="bitflip"),
              igg.NaNPoke(step=12, name="T", index=(3, 3, 3))]
    oj, rj = igg.run_resilient(fj, sj, 20, key="par_roll", faults=faults,
                               checkpoint_dir=str(tmp_path / "ckj"), **kw)
    ot, rt = tg.run_resilient(ft, st, 20, checkpoint_dir=str(tmp_path / "ckt"),
                              faults=[tg.CheckpointCorruption(save_index=2, kind="bitflip"),
                                      tg.NaNPoke(step=12, name="T", index=(3, 3, 3))], **kw)
    assert [r.ok for r in rt].count(False) == 1
    _reports_match(rj, rt)
    assert np.allclose(to_np(ot["T"]), np.asarray(oj["T"]), **RTOL64)
    clean, _ = tg.run_resilient(ft, st, 20, **kw)
    assert torch.equal(clean["T"], ot["T"])


@pytest.mark.faults
@pytest.mark.ensemble
def test_ensemble_member_trip_matches_jax(tmp_path):
    """E = 2 with member 1 poked: the same per-member reports on both
    drivers, the batch within the float64 bound."""
    init_both(6, 6, 6, dimx=2, dimy=2, dimz=1, nranks=4)
    sj, st, pj, pt = _seeded_pair(members=2)
    fj, ft = _steps(pj, pt, members=2)
    poke = (1, 4, 3, 2)
    oj, rj = igg.run_resilient(fj, sj, 9, nt_chunk=3, key="par_ens", ensemble=2,
                               checkpoint_dir=str(tmp_path / "ckj"),
                               faults=[igg.NaNPoke(step=3, name="T", index=poke)])
    ot, rt = tg.run_resilient(ft, st, 9, nt_chunk=3, ensemble=2,
                              checkpoint_dir=str(tmp_path / "ckt"),
                              faults=[tg.NaNPoke(step=3, name="T", index=poke)])
    assert [r.member for r in rt if not r.ok] == [1]
    _reports_match(rj, rt)
    assert np.allclose(to_np(ot["T"]), np.asarray(oj["T"]), **RTOL64)


def test_checkpoint_slots_read_across_packages(tmp_path):
    """Each package's slots restore on the other, and the LATEST pointers'
    JSON is the same."""
    from implicitglobalgrid_tpu.runtime.driver import _CheckpointSlots as JSlots
    from implicitglobalgrid_tpu_torch.runtime.driver import _CheckpointSlots as TSlots

    init_both(6, 6, 6, dimx=2, dimy=2, dimz=1, nranks=4)
    sj, st, _, _ = _seeded_pair()
    for s in (0, 5):
        JSlots(str(tmp_path / "j")).save(sj, s)
        TSlots(str(tmp_path / "t")).save(st, s)
    assert (tmp_path / "j" / "LATEST").read_text() == (tmp_path / "t" / "LATEST").read_text()
    assert json.loads((tmp_path / "t" / "LATEST").read_text()) == {"slot": "slot1", "step": 5}
    got_t, at_t, fb_t = TSlots(str(tmp_path / "j")).restore()
    got_j, at_j, fb_j = JSlots(str(tmp_path / "t")).restore()
    assert (at_t, fb_t) == (at_j, fb_j) == (5, False)
    for k in ("T", "Cp"):
        assert np.array_equal(to_np(got_t[k]), np.asarray(sj[k]))
        assert np.array_equal(np.asarray(got_j[k]), to_np(st[k]))
