"""The port's auto-tuner (`implicitglobalgrid_tpu_torch.telemetry.tune`) on
the CPU, held against the JAX package's (`tests/test_tune.py`):

- with ``measure=False``, the same profile and the same base grid, the
  port's `tune_config` picks the JAX package's `TunedConfig` (the same
  knobs, ``predicted_step_s`` and the ranking's scores to relative 1e-12);
- JAX's search, persistence and application cases on the port; a tuned
  config written by either package is read by the other;
- a measured tune never regresses (the default is in the measured set) and
  hands the caller's grid back (the same epoch, the same halos);
- `RunSpec(tuned=)` and `ResilientRun.apply_tuned` on the supervised run.

The scheduler halves of JAX's application cases are in
`tests/test_torch_service.py`. Left for later: the CLI case (the tools).
"""

import dataclasses
import math
import os

import pytest
import torch

import implicitglobalgrid_tpu as igg
import implicitglobalgrid_tpu_torch as tg
from implicitglobalgrid_tpu.telemetry.tune import TunedConfig as JaxTunedConfig
from implicitglobalgrid_tpu_torch.telemetry.tune import (
    TunedConfig, resolve_tuned, tuned_config_path,
)
from implicitglobalgrid_tpu_torch.utils.exceptions import InvalidArgumentError

from torch_port_util import clean_torch_grid  # noqa: F401

pytestmark = pytest.mark.tune

_GRID = dict(nx=16, ny=16, nz=16, dimx=2, dimy=2, dimz=2, periodx=1, periody=1, periodz=1)


@pytest.fixture(autouse=True)
def _clean_telemetry():
    for pkg in (tg, igg):
        pkg.stop_flight_recorder()
        pkg.reset_metrics()
    yield
    for pkg in (tg, igg):
        pkg.stop_flight_recorder()
        pkg.reset_metrics()


def _hier(pkg, z_lat=5e-4):
    """Fast x/y links and a slow z link: the two-tier mesh the per-axis
    cadence exists for."""
    return pkg.MachineProfile(
        membw_GBps=800.0, flops_G=45000.0,
        axes={"gx": {"GBps": 45.0, "latency_s": 5e-6},
              "gy": {"GBps": 45.0, "latency_s": 5e-6},
              "gz": {"GBps": 2.0, "latency_s": z_lat}})


def _flat(pkg):
    return pkg.MachineProfile(membw_GBps=800.0, flops_G=45000.0,
                              axes={a: {"GBps": 100.0, "latency_s": 1e-9}
                                    for a in ("gx", "gy", "gz")})


def _port_grid(**kw):
    return dict(_GRID, device_type="cpu", **kw)


# ---------------------------------------------------------------------------
# the search against the JAX package's
# ---------------------------------------------------------------------------

SEARCHES = [
    ("stokes_cadence", "stokes3d", _hier, dict(comm_every_options=("1", "2", "z:2"))),
    ("diffusion_flat", "diffusion3d", _flat, dict(comm_every_options=("1", "2", "z:2"))),
    ("ensemble_wire", "diffusion3d", _hier,
     dict(comm_every_options=("1",), wire_dtype_options=(None, "z:int8,x:f32"),
          ensemble_options=(None, 8))),
    ("acoustic_defaults", "acoustic3d", _hier, {}),
    ("coalesce_overlap", "diffusion3d", _hier,
     dict(coalesce_options=(True, False), overlap_options=(False, True))),
    ("wire_bf16", "acoustic3d", _hier, dict(comm_every_options=("1", "z:2"),
                                            wire_dtype_options=(None, "bfloat16"))),
]


@pytest.mark.parametrize("name,model,profile,kw", SEARCHES, ids=[s[0] for s in SEARCHES])
def test_model_only_search_matches_jax(name, model, profile, kw):
    cj = igg.tune_config(model, dict(_GRID), profile(igg), measure=False, **kw)
    ct = tg.tune_config(model, _port_grid(), profile(tg), measure=False, **kw)
    assert ct.knobs() == cj.knobs()
    assert math.isclose(ct.predicted_step_s, cj.predicted_step_s, rel_tol=1e-12)
    assert ct.profile_source == cj.profile_source
    assert [{k: v for k, v in r.items() if k != "score_s"} for r in ct.meta["ranking"]] \
        == [{k: v for k, v in r.items() if k != "score_s"} for r in cj.meta["ranking"]]
    for rt, rj in zip(ct.meta["ranking"], cj.meta["ranking"]):
        assert math.isclose(rt["score_s"], rj["score_s"], rel_tol=1e-12)
    for k in ("candidates", "priced", "measured", "skipped"):
        assert ct.meta[k] == cj.meta[k], k
    assert {k: v for k, v in ct.grid["winner"].items() if k != "device_type"} \
        == cj.grid["winner"]


def test_search_picks_slow_axis_cadence():
    cfg = tg.tune_config("stokes3d", _port_grid(), _hier(tg), measure=False,
                         comm_every_options=("1", "2", "z:2"))
    assert cfg.model == "stokes3d" and cfg.comm_every == "z:2"
    ranked = [r["comm_every"] for r in cfg.meta["ranking"]]
    assert ranked.index("z:2") < ranked.index("2") < ranked.index("1")
    assert cfg.predicted_step_s > 0 and cfg.meta["priced"] >= 3


def test_search_keeps_default_on_flat_fast_mesh():
    cfg = tg.tune_config("diffusion3d", _port_grid(), _flat(tg), measure=False,
                         comm_every_options=("1", "2", "z:2"))
    assert cfg.comm_every == "1"


def test_search_sweeps_ensemble_and_wire():
    cfg = tg.tune_config("diffusion3d", _port_grid(), _hier(tg), measure=False,
                         comm_every_options=("1",),
                         wire_dtype_options=(None, "z:int8,x:f32"),
                         ensemble_options=(None, 8))
    assert cfg.ensemble == 8 and cfg.wire_dtype == "z:int8,x:f32"


def test_infeasible_candidates_skipped_loudly():
    small = _port_grid(nx=4, ny=4, nz=4)
    cfg = tg.tune_config("stokes3d", small, _hier(tg), measure=False,
                         comm_every_options=("1", "z:8"))
    assert cfg.comm_every == "1"
    assert any(s["comm_every"] == "z:8" for s in cfg.meta["skipped"])
    with pytest.raises(InvalidArgumentError, match="infeasible"):
        tg.tune_config("stokes3d", dict(small, nx=2, ny=2, nz=2), _hier(tg), measure=False,
                       comm_every_options=("z:8",))
    with pytest.raises(InvalidArgumentError, match="unsupported model"):
        tg.tune_config("diffusion2d", _port_grid(), _hier(tg), measure=False)
    with pytest.raises(InvalidArgumentError, match="nx/ny/nz"):
        tg.tune_config("diffusion3d", {"nx": 8}, _hier(tg), measure=False)


def test_tune_preserves_callers_grid():
    tg.init_global_grid(8, 8, 8, dimx=2, dimy=2, dimz=2, quiet=True, device_type="cpu")
    epoch = tg.global_grid().epoch
    tg.tune_config("diffusion3d", _port_grid(), _hier(tg), measure=False,
                   comm_every_options=("1",))
    assert tg.grid_is_initialized() and tg.global_grid().epoch == epoch
    assert tg.telemetry.tune.os.environ.get("IGG_HALO_WIRE_DTYPE") \
        == os.environ.get("IGG_HALO_WIRE_DTYPE")


def test_measured_tune_never_regresses_and_restores_the_grid(tmp_path, monkeypatch):
    """The measured path: the default is in the measured set, so the
    speedup is >= 1.0 and the winner's measured time is the set's least;
    the caller's grid comes back with its epoch, and an `update_halo` on it
    gives the halos it gave before; the knobs' environment is restored."""
    monkeypatch.delenv("IGG_HALO_COALESCE", raising=False)
    tg.init_global_grid(8, 8, 8, dimx=2, dimy=2, dimz=2, periodx=1, quiet=True,
                        device_type="cpu")
    epoch = tg.global_grid().epoch
    g = torch.Generator().manual_seed(3)
    T0 = torch.rand(16, 16, 16, generator=g, dtype=torch.float64)
    before = tg.update_halo(T0.clone())
    path = str(tmp_path / "tuned.json")
    cfg = tg.tune_config("diffusion3d", _port_grid(nx=12, ny=12, nz=12), None,
                         measure=True, top_k=2, comm_every_options=("1", "2", "z:2"),
                         measure_steps=2, reps=2, path=path)
    assert cfg.measured_step_s is not None and cfg.baseline_step_s is not None
    assert cfg.speedup >= 1.0 and cfg.meta["measured"] >= 2
    assert cfg.measured_step_s <= cfg.baseline_step_s
    assert cfg.profile_source == "default" and cfg.meta["path"] == path
    assert tg.load_tuned_config(path).knobs() == cfg.knobs()
    assert tg.global_grid().epoch == epoch
    assert torch.equal(tg.update_halo(T0.clone()), before)
    assert "IGG_HALO_COALESCE" not in os.environ


def test_measured_tune_of_acoustic_on_its_plain_route():
    cfg = tg.tune_config("acoustic3d", _port_grid(nx=10, ny=10, nz=10), None,
                         measure=True, top_k=1, comm_every_options=("1", "z:2"),
                         wire_dtype_options=(None, "bfloat16"), measure_steps=1, reps=1)
    assert cfg.speedup >= 1.0 and cfg.meta["measured"] >= 1


# ---------------------------------------------------------------------------
# persistence + application
# ---------------------------------------------------------------------------

def test_tuned_config_json_roundtrip(tmp_path):
    cfg = TunedConfig(model="diffusion3d", comm_every="z:2", wire_dtype="z:int8",
                      coalesce=True, overlap=False, ensemble=4, predicted_step_s=1e-3,
                      speedup=1.2)
    path = tuned_config_path(tmp_path / "profile.json", "diffusion3d")
    assert path.endswith("tuned_diffusion3d.json")
    tg.save_tuned_config(cfg, path)
    back = tg.load_tuned_config(path)
    assert back.knobs() == cfg.knobs()
    assert back.env() == {"IGG_COMM_EVERY": "z:2", "IGG_HALO_WIRE_DTYPE": "z:int8",
                          "IGG_HALO_COALESCE": "1"}
    assert resolve_tuned(None) is None and resolve_tuned(cfg) is cfg
    assert resolve_tuned(cfg.to_json()).knobs() == cfg.knobs()
    assert resolve_tuned(path).knobs() == cfg.knobs()
    with pytest.raises(InvalidArgumentError):
        resolve_tuned(42)
    with pytest.raises(InvalidArgumentError):
        tg.load_tuned_config(tmp_path / "missing.json")
    with pytest.raises(InvalidArgumentError, match="malformed"):
        TunedConfig.from_json({"comm_every": "1"})


def test_tuned_configs_read_across(tmp_path):
    """Each package reads the other's tuned-config file, field for field."""
    jcfg = JaxTunedConfig(model="stokes3d", comm_every="z:2", wire_dtype="bfloat16",
                          wire_stage="z:staged", coalesce=False, overlap=True, ensemble=2,
                          predicted_step_s=2e-3, measured_step_s=3e-3,
                          baseline_step_s=4e-3, speedup=4 / 3, profile_source="calibrated",
                          grid={"base": {"nx": 8}}, meta={"priced": 3})
    p = str(tmp_path / "jax.json")
    igg.save_tuned_config(jcfg, p)
    assert tg.load_tuned_config(p).to_json() == jcfg.to_json()
    tcfg = dataclasses.replace(tg.load_tuned_config(p), comm_every="1")
    q = str(tmp_path / "port.json")
    tg.save_tuned_config(tcfg, q)
    assert igg.load_tuned_config(q).to_json() == tcfg.to_json()
    assert tg.load_tuned_config(p).env() == jcfg.env()


def test_runspec_tuned_scopes_the_knobs_and_records_the_event(tmp_path, monkeypatch):
    """`RunSpec(tuned=path)`: resolved once, a ``tuned`` event, and every
    chunk under the config's environment (the exchange reads
    ``IGG_HALO_WIRE_DTYPE``); the state equals the same run with the knob
    given directly, and the environment is restored after."""
    from implicitglobalgrid_tpu_torch.models import diffusion_step_local, init_diffusion3d

    monkeypatch.delenv("IGG_HALO_WIRE_DTYPE", raising=False)
    tg.init_global_grid(6, 6, 6, dimx=2, dimy=2, dimz=1, quiet=True, device_type="cpu")
    T, Cp, p = init_diffusion3d(dtype=torch.float32)
    seen = []

    def step(s):
        seen.append(os.environ.get("IGG_HALO_WIRE_DTYPE"))
        return {"T": diffusion_step_local(s["T"], s["Cp"], p, "plain"), "Cp": s["Cp"]}

    cfg = TunedConfig(model="diffusion3d", wire_dtype="bfloat16", predicted_step_s=1e-3,
                      speedup=1.5)
    path = tg.save_tuned_config(cfg, str(tmp_path / "tuned_diffusion3d.json"))
    fr = str(tmp_path / "fr.jsonl")
    tg.start_flight_recorder(fr)
    out, _ = tg.run_resilient(step, {"T": T, "Cp": Cp}, 6, nt_chunk=3, tuned=path)
    tg.stop_flight_recorder()
    assert seen == ["bfloat16"] * 6
    assert "IGG_HALO_WIRE_DTYPE" not in os.environ
    ev = [e for e in tg.read_flight_events(fr) if e["kind"] == "tuned"]
    assert len(ev) == 1 and ev[0]["wire_dtype"] == "bfloat16" and ev[0]["speedup"] == 1.5
    assert ev[0]["model"] == "diffusion3d" and ev[0]["predicted_step_s"] == 1e-3
    rep = tg.run_report(fr, include_metrics=False)
    assert any(s["kind"] == "tuned" for s in rep["sequence"])
    monkeypatch.setenv("IGG_HALO_WIRE_DTYPE", "bfloat16")
    ref, _ = tg.run_resilient(lambda s: {"T": diffusion_step_local(s["T"], s["Cp"], p,
                                                                   "plain"),
                                         "Cp": s["Cp"]}, {"T": T, "Cp": Cp}, 6, nt_chunk=3)
    assert torch.equal(out["T"], ref["T"])
    with pytest.raises(InvalidArgumentError):
        tg.run_resilient(step, {"T": T, "Cp": Cp}, 3, nt_chunk=3,
                         tuned=str(tmp_path / "missing.json"))


def test_apply_tuned_and_stale_on_drift(tmp_path, monkeypatch):
    """`apply_tuned` on a live run: a ``tuned`` event, the knobs from the
    next chunk on; a ``perf_regression`` marks it stale once
    (``tuned_stale``); `clear_tuned` drops it. The drift detector's
    verdicts are given (`PerfWatch` itself: tests/test_torch_perfmodel.py),
    so no host timing decides the test."""
    from implicitglobalgrid_tpu_torch.models import diffusion_step_local, init_diffusion3d

    monkeypatch.delenv("IGG_HALO_COALESCE", raising=False)
    tg.init_global_grid(6, 6, 6, dimx=2, dimy=2, dimz=1, quiet=True, device_type="cpu")
    T, Cp, p = init_diffusion3d(dtype=torch.float32)
    seen = []

    def step(s):
        seen.append(os.environ.get("IGG_HALO_COALESCE"))
        return {"T": diffusion_step_local(s["T"], s["Cp"], p, "plain"), "Cp": s["Cp"]}

    class Drift:
        """The detector's verdict: a regression while ``on``."""
        on = False

        def observe(self, **kw):
            return {"chunk": kw["chunk"], "z": 9.0} if self.on else None

        def baseline_s(self):
            return None

    fr = str(tmp_path / "fr.jsonl")
    tg.start_flight_recorder(fr)
    run = tg.ResilientRun(step, {"T": T, "Cp": Cp}, 40, tg.RunSpec(nt_chunk=2))
    run.watch = drift = Drift()
    try:
        with pytest.raises(InvalidArgumentError, match="TunedConfig"):
            run.apply_tuned(object())
        assert run.advance() and seen == [None, None]
        run.apply_tuned(TunedConfig(model="diffusion3d", coalesce=False))
        for _ in range(3):
            run.advance()
        assert seen[2:] == ["0"] * 6 and not run.tuned_stale
        drift.on = True
        run.advance()
        assert run.tuned_stale and run.tuned_stale_reason == "perf_drift"
        run.advance()
        run.clear_tuned()
        assert run.tuned is None and not run.tuned_stale
        drift.on = False
        run.advance()
        assert seen[-1] is None
    finally:
        run.close()
        tg.stop_flight_recorder()
    kinds = [e["kind"] for e in tg.read_flight_events(fr)]
    assert kinds.count("tuned") == 1 and kinds.count("tuned_stale") == 1
    assert kinds.count("perf_regression") == 2
