"""The port's performance oracle (`implicitglobalgrid_tpu_torch.telemetry`:
`perfmodel`, `calibrate`, `perfdb`) on the CPU, held against the JAX
package's (`tests/test_perfmodel.py`):

- `predict_step`'s whole record equals JAX's (numbers to relative 1e-12)
  under one explicit `MachineProfile`, for the four `STEP_WORKLOADS` on
  2x2x2 grids (``diffusion2d`` on a 2x2 grid): cadence 1, 2 and ``"z:2"``,
  ``overlap``, the bfloat16 and int8 wires, ``ensemble=4``, and the port's
  ``impl`` spellings ``"cuda"``/``"plain"`` against JAX's ``"pallas"``/
  ``"xla"`` (JAX's spellings on the port too);
- JAX's cases of the model, the profile and perfdb, on the port;
- a profile and a perfdb history written by either package are read, and
  checked, by the other;
- `calibrate_machine` on the CPU mesh round-trips (its FLOP fit runs the
  calibration kernel's plain version, `ops.cuda_calibrate.fma_chain_plain`,
  held here against a numpy chain).
"""

import math

import jax
import numpy as np
import pytest
import torch

import implicitglobalgrid_tpu as igg
import implicitglobalgrid_tpu_torch as tg
from implicitglobalgrid_tpu_torch.ops import cuda_calibrate
from implicitglobalgrid_tpu_torch.utils.exceptions import InvalidArgumentError

from torch_port_util import clean_torch_grid, init_both  # noqa: F401

pytestmark = pytest.mark.telemetry

N = 8
# state order and staggering of each model (the tuner's `_MODEL_STAGGER`)
STAGGER = {
    "diffusion3d": ((0, 0, 0),) * 2,
    "acoustic3d": ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1)),
    "stokes3d": ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1),
                 (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)),
}
SETTINGS = [
    ("default", {}, {}),
    ("cadence2", dict(comm_every=2), dict(comm_every=2)),
    ("cadence_z2", dict(comm_every="z:2"), dict(comm_every="z:2")),
    ("overlap", dict(overlap=True), dict(overlap=True)),
    ("wire_bf16", dict(wire_dtype="bfloat16"), dict(wire_dtype="bfloat16")),
    ("wire_int8", dict(wire_dtype="int8"), dict(wire_dtype="int8")),
    ("ensemble4", dict(ensemble=4), dict(ensemble=4)),
    ("impl_cuda", dict(impl="cuda"), dict(impl="pallas")),
    ("impl_plain", dict(impl="plain"), dict(impl="xla")),
    ("impl_jax_spelling", dict(impl="pallas_interpret"), dict(impl="pallas_interpret")),
]


@pytest.fixture(autouse=True)
def _clean_telemetry():
    for pkg in (tg, igg):
        pkg.stop_flight_recorder()
        pkg.reset_metrics()
    yield
    for pkg in (tg, igg):
        pkg.stop_flight_recorder()
        pkg.reset_metrics()


def _init(nx=N, **kw):
    tg.init_global_grid(nx, nx, nx, dimx=2, dimy=2, dimz=2, periodx=1, periody=1,
                        periodz=1, quiet=True, device_type="cpu", **kw)


def _profiles(membw=10.0, flops=7.0):
    axes = {"gx": {"GBps": 1.0, "latency_s": 1e-5}, "gy": {"GBps": 2.0, "latency_s": 2e-5},
            "gz": {"GBps": 0.5, "latency_s": 1e-4}}
    return (igg.MachineProfile(membw_GBps=membw, flops_G=flops, axes=axes),
            tg.MachineProfile(membw_GBps=membw, flops_G=flops, axes=axes))


def _profile(membw=10.0, flops=10.0, link=1.0, lat=1e-5):
    return tg.MachineProfile(membw_GBps=membw, flops_G=flops,
                             axes={a: {"GBps": link, "latency_s": lat}
                                   for a in ("gx", "gy", "gz")})


def assert_same_record(a, b, path="record"):
    """Equal keys and values, numbers to relative 1e-12."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, a, b)
        for k in a:
            assert_same_record(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same_record(x, y, f"{path}[{i}]")
    elif isinstance(a, (bool, str)) or a is None:
        assert a == b, (path, a, b)
    else:
        assert math.isclose(a, b, rel_tol=1e-12, abs_tol=0.0), (path, a, b)


def _fields(model, dims=(2, 2, 2), n=N):
    shapes = [tuple(d * (n + o) for d, o in zip(dims, off)) for off in STAGGER[model]]
    return ([jax.ShapeDtypeStruct(s, np.float32) for s in shapes],
            [torch.zeros(s, dtype=torch.float32) for s in shapes])


# ---------------------------------------------------------------------------
# predict_step against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", sorted(STAGGER))
@pytest.mark.parametrize("name,kw_t,kw_j", SETTINGS, ids=[s[0] for s in SETTINGS])
def test_predict_step_matches_jax(model, name, kw_t, kw_j):
    init_both(N, N, N, dimx=2, dimy=2, dimz=2, periodx=1, periody=1, periodz=1)
    pj, pt = _profiles()
    fj, ft = _fields(model)
    assert_same_record(igg.predict_step(model, fj, profile=pj, **kw_j),
                       tg.predict_step(model, ft, profile=pt, **kw_t))


@pytest.mark.parametrize("name,kw_t,kw_j", SETTINGS[:7], ids=[s[0] for s in SETTINGS[:7]])
def test_predict_step_2d_matches_jax(name, kw_t, kw_j):
    init_both(N, N, 1, dimx=2, dimy=2, dimz=1, periodx=1, periody=1, nranks=4)
    pj, pt = _profiles()
    fj = [jax.ShapeDtypeStruct((2 * N, 2 * N), np.float32)] * 2
    ft = [torch.zeros(2 * N, 2 * N), torch.zeros(2 * N, 2 * N)]
    assert_same_record(igg.predict_step("diffusion2d", fj, profile=pj, **kw_j),
                       tg.predict_step("diffusion2d", ft, profile=pt, **kw_t))


def test_predict_step_nonperiodic_and_wire_stage_match_jax(monkeypatch):
    """A non-periodic mesh and a staged z axis (its granules declared)
    price the same in both packages, the staged record included."""
    monkeypatch.setenv("IGG_TPU_DCN_GRANULES", "z:2")
    init_both(N, N, N, dimx=2, dimy=2, dimz=2, periodx=1)
    pj, pt = _profiles()
    fj, ft = _fields("acoustic3d")
    for kw in (dict(), dict(wire_stage="z:staged"), dict(wire_stage="z:staged", impl="cuda")):
        kj = dict(kw, impl="pallas") if kw.get("impl") == "cuda" else kw
        rec = tg.predict_step("acoustic3d", ft, profile=pt, **kw)
        assert_same_record(igg.predict_step("acoustic3d", fj, profile=pj, **kj), rec)
    assert "staged" in rec["comm"]["gz"]


def test_step_workloads_are_jax_s():
    assert set(tg.telemetry.STEP_WORKLOADS) == set(igg.telemetry.STEP_WORKLOADS)
    for k, w in tg.telemetry.STEP_WORKLOADS.items():
        wj = igg.telemetry.STEP_WORKLOADS[k]
        for f in ("flops_per_cell", "hbm_passes", "exchange_groups", "fused_exchange_groups",
                  "deep_exchange_groups", "deep_halo_depth"):
            assert getattr(w, f) == getattr(wj, f), (k, f)
        for impl, impl_j in (("cuda", "pallas"), ("plain", "xla")):
            for deep in (False, True):
                assert w.groups_for(impl, deep) == wj.groups_for(impl_j, deep)


# ---------------------------------------------------------------------------
# The analytical model (JAX's cases on the port)
# ---------------------------------------------------------------------------

def test_predict_step_structure():
    _init()
    T, Cp = tg.ones_g(dtype=torch.float32), tg.ones_g(dtype=torch.float32)
    pred = tg.predict_step("diffusion3d", (T, Cp), profile=_profile())
    assert pred["model"] == "diffusion3d"
    assert pred["local_cells"] == N ** 3
    assert set(pred["comm"]) == {"gx", "gy", "gz"}
    for rec in pred["comm"].values():
        assert rec["s"] == pytest.approx(rec["latency_s"] + rec["wire_s"])
        assert rec["per_link_bytes"] > 0
    assert pred["step_s"] == pytest.approx(pred["compute"]["s"] + pred["exposed_comm_s"])
    assert pred["bound"] in ("compute", "bandwidth", "latency")
    assert tg.predict_step("diffusion3d", (T, Cp), profile=_profile()) == pred
    with pytest.raises(InvalidArgumentError, match="unknown model"):
        tg.predict_step("nope", (T,))
    with pytest.raises(InvalidArgumentError, match="at least 4 fields"):
        tg.predict_step("acoustic3d", (T,), profile=_profile())


def test_bound_classification_tracks_coefficients():
    _init()
    fields = (tg.ones_g(dtype=torch.float32), tg.ones_g(dtype=torch.float32))
    assert tg.predict_step("diffusion3d", fields, profile=_profile(lat=1.0))["bound"] \
        == "latency"
    p = tg.predict_step("diffusion3d", fields, profile=_profile(link=1e-9, lat=0.0))
    assert p["bound"] == "bandwidth" and p["bound_detail"] == "wire"
    p = tg.predict_step("diffusion3d", fields,
                        profile=_profile(membw=1e-9, link=1e9, lat=0.0))
    assert p["bound"] == "bandwidth" and p["bound_detail"] == "hbm"
    p = tg.predict_step("diffusion3d", fields,
                        profile=_profile(flops=1e-9, membw=1e9, link=1e9, lat=0.0))
    assert p["bound"] == "compute"


def test_comm_every_and_overlap_pricing():
    _init()
    T, Cp = tg.ones_g(dtype=torch.float32), tg.ones_g(dtype=torch.float32)
    prof = _profile(lat=1e-3)
    p1 = tg.predict_step("diffusion3d", (T, Cp), profile=prof)
    p4 = tg.predict_step("diffusion3d", (T, Cp), profile=prof, comm_every=4)
    for ax in p1["comm"]:
        assert p4["comm"][ax]["latency_s"] == pytest.approx(p1["comm"][ax]["latency_s"] / 4)
    po = tg.predict_step("diffusion3d", (T, Cp), profile=prof, overlap=True)
    assert 0.0 < po["interior_frac"] < 1.0
    assert po["exposed_comm_s"] == pytest.approx(
        max(0.0, po["comm_s"] - po["compute"]["s"] * po["interior_frac"]))
    assert po["step_s"] <= p1["step_s"]
    assert p1["interior_frac"] == 1.0


def test_per_axis_comm_every_pricing():
    _init()
    T, Cp = tg.ones_g(dtype=torch.float32), tg.ones_g(dtype=torch.float32)
    prof = _profile(lat=1e-3)
    p1 = tg.predict_step("diffusion3d", (T, Cp), profile=prof)
    pz = tg.predict_step("diffusion3d", (T, Cp), profile=prof, comm_every="z:4")
    assert pz["comm_every"] == "z:4"
    assert pz["comm"]["gz"]["comm_every"] == 4
    assert pz["comm"]["gz"]["latency_s"] == pytest.approx(p1["comm"]["gz"]["latency_s"] / 4)
    for ax in ("gx", "gy"):
        assert pz["comm"][ax]["latency_s"] == pytest.approx(p1["comm"][ax]["latency_s"])
    assert tg.predict_step("diffusion3d", (T, Cp), profile=prof, comm_every={"gz": 4}) == pz
    state = tuple(tg.ones_g(dtype=torch.float32) for _ in range(4))
    a1 = tg.predict_step("acoustic3d", state, profile=prof)
    a2 = tg.predict_step("acoustic3d", state, profile=prof, comm_every=2)
    assert a1["comm"]["gz"]["ppermute_pairs"] == 2.0
    assert a2["comm"]["gz"]["ppermute_pairs"] == 1.0
    # the fused route packs the acoustic state into one round
    af = tg.predict_step("acoustic3d", state, profile=prof, impl="cuda")
    assert af["comm"]["gz"]["ppermute_pairs"] == 1.0


def test_bound_detail_names_latency_dominant_axis():
    _init()
    T, Cp = tg.ones_g(dtype=torch.float32), tg.ones_g(dtype=torch.float32)
    prof = tg.MachineProfile(
        membw_GBps=1e3, flops_G=1e6,
        axes={"gx": {"GBps": 45.0, "latency_s": 5e-6},
              "gy": {"GBps": 45.0, "latency_s": 5e-6},
              "gz": {"GBps": 45.0, "latency_s": 5e-3}})
    p = tg.predict_step("diffusion3d", (T, Cp), profile=prof)
    assert p["bound"] == "latency" and p["bound_detail"] == "comm_every[z]"
    pz = tg.predict_step("diffusion3d", (T, Cp), profile=prof, comm_every="z:8")
    assert pz["comm_s"] < p["comm_s"]


def test_wire_dtype_halves_wire_bytes():
    _init()
    T = tg.ones_g(dtype=torch.float32)
    prof = _profile(lat=0.0)
    full = tg.predict_step("diffusion3d", (T,), profile=prof)
    half = tg.predict_step("diffusion3d", (T,), profile=prof, wire_dtype="bfloat16")
    for ax in full["comm"]:
        assert half["comm"][ax]["per_link_bytes"] * 2 == full["comm"][ax]["per_link_bytes"]


# ---------------------------------------------------------------------------
# Profiles, the defaults and calibration
# ---------------------------------------------------------------------------

def test_calibrate_roundtrip(tmp_path):
    _init()
    path = str(tmp_path / "profile.json")
    prof = tg.calibrate_machine(path, elems_per_device=1 << 12,
                                link_bytes=(1 << 10, 1 << 14), c1=2)
    assert prof.source == "calibrated"
    assert prof.membw_GBps > 0 and prof.flops_G > 0
    assert set(prof.axes) == {"gx", "gy", "gz"}
    for rec in prof.axes.values():
        assert rec["GBps"] > 0 and rec["latency_s"] >= 0
    loaded = tg.load_machine_profile(path)
    assert loaded.membw_GBps == prof.membw_GBps and loaded.axes == prof.axes
    assert loaded.device["n_shards"] == 8 and loaded.device["device_kind"] == "cpu"
    assert loaded.meta["link_bytes"] == [1 << 10, 1 << 14]
    assert loaded.meta["triad_elems_per_device"] == 16 ** 3  # no L2 sizing on the CPU
    T = tg.ones_g(dtype=torch.float32)
    pred = tg.predict_step("diffusion3d", (T,), profile=loaded)
    assert pred["profile_source"] == "calibrated" and 0 < pred["step_s"] < 60.0
    # the JAX package reads it and prices the same step the same way
    igg.init_global_grid(N, N, N, dimx=2, dimy=2, dimz=2, periodx=1, periody=1, periodz=1,
                         quiet=True)
    pj = igg.load_machine_profile(path)
    assert pj.to_json() == loaded.to_json()
    assert_same_record(
        igg.predict_step("diffusion3d", (jax.ShapeDtypeStruct((16,) * 3, np.float32),),
                         profile=pj),
        tg.predict_step("diffusion3d", (torch.zeros(16, 16, 16),), profile=loaded))
    with pytest.raises(InvalidArgumentError, match="small < large"):
        tg.calibrate_machine(link_bytes=(1 << 14, 1 << 10))
    e = tg.calibrate_machine(elems_per_device=1 << 9, link_bytes=(1 << 8, 1 << 10), c1=1,
                             ensemble=2)
    assert e.meta["ensemble"] == 2 and e.meta["link_bytes"] == [1 << 9, 1 << 11]


def test_jax_profile_read_by_the_port(tmp_path):
    path = str(tmp_path / "jax_profile.json")
    prof = igg.MachineProfile(membw_GBps=123.0, flops_G=45.0,
                              axes={"gz": {"GBps": 3.0, "latency_s": 4e-5}},
                              source="calibrated", device={"platform": "cpu"},
                              calibrated_at=1.5, meta={"x": 1})
    igg.save_machine_profile(prof, path)
    got = tg.load_machine_profile(path)
    assert got.to_json() == prof.to_json()
    assert got.axis("gx") == prof.axis("gx")


def test_default_profiles():
    cpu = tg.default_machine_profile("cpu")
    assert cpu.to_json() == igg.default_machine_profile("cpu").to_json()
    gpu = tg.default_machine_profile("gpu")
    assert gpu.source == "default" and gpu.device["platform"] == "gpu"
    assert gpu.membw_GBps > 0 and gpu.flops_G > 0
    assert all(r["GBps"] > 0 and r["latency_s"] >= 0 for r in gpu.axes.values())
    assert set(gpu.axes) == {"gx", "gy", "gz"}
    _init()
    assert tg.default_machine_profile().to_json() == cpu.to_json()  # the grid's device
    h = tg.telemetry.hierarchical_machine_profile()
    assert h.axes["gx"] == gpu.axes["gx"] and h.axes["gy"] == gpu.axes["gy"]
    assert h.axes["gz"]["GBps"] == pytest.approx(gpu.axes["gx"]["GBps"] / 22.5)
    assert h.axes["gz"]["latency_s"] == pytest.approx(gpu.axes["gx"]["latency_s"] * 10)
    assert h.meta == {"preset": "hierarchical", "dcn_axes": ["z"]}


def test_default_profile_axis_fallback():
    prof = tg.MachineProfile(membw_GBps=10.0, flops_G=10.0,
                             axes={"gx": {"GBps": 2.0, "latency_s": 1e-5}})
    assert prof.axis("gy")["GBps"] == 2.0
    empty = tg.MachineProfile(membw_GBps=1.0, flops_G=1.0, axes={})
    assert empty.axis("gx")["GBps"] > 0


def test_load_machine_profile_rejects_garbage(tmp_path):
    p = tmp_path / "bad.json"
    p.write_text("{\"not\": \"a profile\"}")
    with pytest.raises(InvalidArgumentError):
        tg.load_machine_profile(str(p))
    with pytest.raises(InvalidArgumentError):
        tg.load_machine_profile(str(tmp_path / "missing.json"))


# ---------------------------------------------------------------------------
# The live drift detector (JAX's cases on the port)
# ---------------------------------------------------------------------------

def test_perfwatch_flags_only_clear_drift():
    w = tg.PerfWatch(window=8, zmax=4.0, model_step_s=1e-3)
    for i in range(12):
        jitter = 1.0 + 0.02 * ((-1) ** i)
        assert w.observe(chunk=i, step_begin=i, step_end=i + 1, n=10,
                         exec_s=0.01 * jitter) is None
    assert w.observe(chunk=12, step_begin=12, step_end=13, n=10, exec_s=0.1,
                     cold=True) is None
    v = w.observe(chunk=13, step_begin=13, step_end=14, n=10, exec_s=0.1)
    assert v is not None and v["chunk"] == 13 and v["z"] > 4.0
    assert v["ratio"] == pytest.approx(10.0)
    reg = tg.metrics_registry()
    assert reg.get("igg_perf_step_seconds").value() == pytest.approx(0.01)
    assert reg.get("igg_perf_regressions_total").value() == 1.0
    assert reg.get("igg_perf_model_ratio").value() == pytest.approx(10.0)
    with pytest.raises(InvalidArgumentError):
        tg.PerfWatch(window=1)


def test_perfwatch_small_window_still_detects():
    w = tg.PerfWatch(window=4, zmax=4.0)
    for i in range(6):
        assert w.observe(chunk=i, step_begin=i, step_end=i + 1, n=10, exec_s=0.01) is None
    v = w.observe(chunk=6, step_begin=6, step_end=7, n=10, exec_s=10.0)
    assert v is not None and v["chunk"] == 6 and v["z"] > 4.0


def test_run_resilient_takes_a_predict_step_record():
    """`predict_step`'s record is a `RunSpec.perf_model`: the driver
    records its price and feeds the ratio gauge."""
    from implicitglobalgrid_tpu_torch.models import diffusion_step_local, init_diffusion3d

    _init()
    T, Cp, p = init_diffusion3d(dtype=torch.float32)
    pred = tg.predict_step("diffusion3d", (T, Cp), profile=_profile())
    step = lambda s: {"T": diffusion_step_local(s["T"], s["Cp"], p, "plain"),  # noqa: E731
                      "Cp": s["Cp"]}
    tg.run_resilient(step, {"T": T, "Cp": Cp}, 4, nt_chunk=2, perf_model=pred)
    ratio = tg.metrics_registry().get("igg_perf_model_ratio").value()
    assert ratio > 0


@pytest.mark.parametrize("iters,a,b", [(1, 1.000001, 1e-9), (3, 0.999, 0.5), (2, -1.5, 3.0)])
def test_fma_chain_plain_matches_numpy_chain(iters, a, b):
    """The calibration kernel's plain version: each multiply-add rounded
    once to float32 (through float64), as the numpy chain rounds it."""
    rng = np.random.default_rng(iters)
    x0 = rng.uniform(-2, 2, size=(5, 7)).astype(np.float32)
    got = cuda_calibrate.fma_chain(torch.from_numpy(x0.copy()), iters, a, b)
    ref = x0.astype(np.float64)
    a32, b32 = float(np.float32(a)), float(np.float32(b))
    for _ in range(iters * cuda_calibrate.FMA_PER_ITER):
        ref = (ref * a32 + b32).astype(np.float32).astype(np.float64)
    assert np.array_equal(got.numpy(), ref.astype(np.float32))
    with pytest.raises(InvalidArgumentError):
        cuda_calibrate.fma_chain(torch.zeros(3, dtype=torch.float64), 1)
    with pytest.raises(InvalidArgumentError):
        cuda_calibrate.fma_chain(torch.zeros(3), -1)


# ---------------------------------------------------------------------------
# The perf-history database and gate
# ---------------------------------------------------------------------------

def _history(pkg, db, runs=6, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(runs):
        pkg.perfdb_add(db, [
            {"metric": "diffusion3D_f32_cell_updates_per_s_per_chip",
             "value": 100.0 * (1 + 0.04 * rng.uniform(-1, 1)), "platform": "cpu"},
            {"metric": "telemetry_overhead_frac",
             "value": 1e-3 * (1 + 0.1 * rng.uniform(-1, 1))},
            {"metric": "update_halo_coalesced_speedup_4fields",
             "value": 5.0 + rng.uniform(-0.2, 0.2)},
        ])


NOISE = [{"metric": "diffusion3D_f32_cell_updates_per_s_per_chip", "value": 97.0},
         {"metric": "telemetry_overhead_frac", "value": 1.1e-3},
         {"metric": "update_halo_coalesced_speedup_4fields", "value": 4.9}]


def _verdict(rep):
    return (rep["ok"], rep["checked"], [r["metric"] for r in rep["regressions"]],
            [r["metric"] for r in rep["improvements"]], rep["skipped"], rep["history_runs"])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_perfdb_detects_injected_regression_and_passes_noise(tmp_path, writer):
    """Either package's history, gated by both: the same verdicts."""
    db = str(tmp_path / "hist.jsonl")
    _history(igg if writer == "jax" else tg, db)
    rep = tg.perfdb_check(db, NOISE)
    assert rep["ok"] and rep["checked"] == 3 and not rep["regressions"]
    bad = [dict(NOISE[0], value=69.0)] + NOISE[1:]
    rep = tg.perfdb_check(db, bad)
    assert not rep["ok"]
    assert [r["metric"] for r in rep["regressions"]] \
        == ["diffusion3D_f32_cell_updates_per_s_per_chip"]
    assert rep["regressions"][0]["direction"] == "higher"
    worse = NOISE[:1] + [dict(NOISE[1], value=1e-2)] + NOISE[2:]
    assert [r["metric"] for r in tg.perfdb_check(db, worse)["regressions"]] \
        == ["telemetry_overhead_frac"]
    for rows in (NOISE, bad, worse):
        assert _verdict(tg.perfdb_check(db, rows)) == _verdict(igg.perfdb_check(db, rows))
    assert tg.telemetry.perfdb_load(db) == igg.telemetry.perfdb_load(db)


def test_perfdb_skips_unknown_and_fresh_metrics(tmp_path):
    db = str(tmp_path / "hist.jsonl")
    _history(tg, db, runs=1)
    rows = [{"metric": "diffusion3D_f32_cell_updates_per_s_per_chip", "value": 1.0},
            {"metric": "perf_model_ratio_diffusion3D_f32", "value": 1.4}]
    rep = tg.perfdb_check(db, rows)
    assert rep["ok"]
    reasons = {s["metric"]: s["reason"] for s in rep["skipped"]}
    assert reasons["diffusion3D_f32_cell_updates_per_s_per_chip"] == "insufficient-history"
    assert reasons["perf_model_ratio_diffusion3D_f32"] == "unknown-direction"
    assert _verdict(rep) == _verdict(igg.perfdb_check(db, rows))
    with pytest.raises(InvalidArgumentError):
        tg.perfdb_add(db, [{"metric": "x", "value": None}])
    for name in ("a_per_s", "b_gbps", "c_overhead", "d_latency_s", "e_ratio"):
        assert tg.telemetry.metric_direction(name) == igg.telemetry.metric_direction(name)


def test_perfdb_tolerates_torn_final_line(tmp_path):
    db = str(tmp_path / "hist.jsonl")
    _history(tg, db, runs=2)
    with open(db, "a") as f:
        f.write('{"ts": 1, "metrics": {"x":')
    assert len(tg.telemetry.perfdb_load(db)) == 2
    with open(db, "w") as f:
        f.write('{"broken\n{"ts": 2, "metrics": {}}\n')
    with pytest.raises(InvalidArgumentError, match="corrupt interior"):
        tg.telemetry.perfdb_load(db)
