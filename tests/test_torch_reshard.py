"""The port's on-device elastic reshard (`implicitglobalgrid_tpu_torch.reshard`,
`ResilientRun.resize`, `predict_reshard`) on the CPU, mirroring
`tests/test_reshard.py` but for its CLI and scheduler cases.

The bar everywhere is BIT-IDENTITY: the plan's host oracle against an
independently built global field; the plan's JSON and fingerprint against
the JAX package's for the same topology; `reshard_state` against the host
oracle AND the JAX package's `reshard_state` on its 8-device CPU mesh; the
device resize against the checkpoint path and the unresized run. The
golden dump of JAX's program parses with the port's parser and honors the
port's `reshard_contract`, and the port's own recording of a move honors
it too. `test_resize_validation` states the one divergence: the port's
feasibility check is the card's free memory, not a device count.
"""

import itertools
import os

import numpy as np
import pytest
import torch

import implicitglobalgrid_tpu as igg
import implicitglobalgrid_tpu_torch as tg
from implicitglobalgrid_tpu_torch.reshard import (
    apply_plan_host, build_reshard_plan, fields_of_state, live_topology, reshard_contract,
    reshard_state,
)
from implicitglobalgrid_tpu_torch.utils.checkpoint import AxisRedistribution
from implicitglobalgrid_tpu_torch.utils.exceptions import (
    IncoherentArgumentError, InvalidArgumentError, ResilienceError,
)

from torch_port_util import clean_torch_grid  # noqa: F401

_FIXTURE = os.path.join(os.path.dirname(__file__), "data", "hlo",
                        "reshard_2x2x1_to_1x2x2.hlo.txt")
MOVES = [((2, 2, 1), (1, 2, 2), (0, 0, 0)),   # rotate
         ((2, 2, 1), (2, 1, 1), (0, 0, 0)),   # shrink
         ((1, 2, 1), (2, 2, 2), (1, 0, 1))]   # grow, periodic axes


def _topo(nxyz=(6, 6, 6), dims=(2, 2, 1), ol=(2, 2, 2), per=(0, 0, 0)):
    return {"nxyz": np.array(nxyz), "dims": np.array(dims),
            "overlaps": np.array(ol), "periods": np.array(per),
            "halowidths": np.maximum(1, np.array(ol) // 2)}


def _blocks_from_global(G, dims, loc, ol, per):
    """Exchange-fresh stacked layout of global field ``G``: block c's cell i
    holds G[phys(c, i)], the independent reference every re-block must
    reproduce exactly."""
    nd = len(loc)
    axes = [AxisRedistribution(loc[d], loc[d], dims[d], dims[d], ol[d], bool(per[d]))
            for d in range(nd)]
    out = np.zeros([dims[d] * loc[d] for d in range(nd)], dtype=G.dtype)
    for c in itertools.product(*[range(dims[d]) for d in range(nd)]):
        idx = np.ix_(*[axes[d].new_phys(c[d]) for d in range(nd)])
        sel = tuple(slice(c[d] * loc[d], (c[d] + 1) * loc[d]) for d in range(nd))
        out[sel] = G[idx]
    return out


def _ng(dims, loc, ol, per):
    return tuple(dims[d] * (loc[d] - ol[d]) + (0 if per[d] else ol[d]) for d in range(len(loc)))


# ---------------------------------------------------------------------------
# the plan (host only)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src,dst,per", MOVES)
def test_plan_host_oracle_matches_global_field(src, dst, per):
    """Every destination cell holds exactly the global-field value its
    physical coordinate names, for plain, staggered and member-stacked
    fields; the plan's JSON and fingerprint are the JAX package's."""
    from implicitglobalgrid_tpu.reshard import build_reshard_plan as jax_plan

    from implicitglobalgrid_tpu_torch.utils.checkpoint import elastic_local_size

    nx, ol = (6, 6, 6), (2, 2, 2)
    topo = _topo(nx, src, ol, per)
    rng = np.random.default_rng(3)
    loc_T, loc_P, ol_P = (6, 6, 6), (7, 6, 6), (3, 2, 2)  # x-staggered P
    GT = rng.normal(size=_ng(src, loc_T, ol, per))
    GP = rng.normal(size=_ng(src, loc_P, ol_P, per))
    T = _blocks_from_global(GT, src, loc_T, ol, per)
    P = _blocks_from_global(GP, src, loc_P, ol_P, per)
    E = np.stack([T, 2.0 * T, -T])
    fields = {"T": (T.shape, "float64", 0), "P": (P.shape, "float64", 0),
              "E": (E.shape, "float64", 1)}
    plan = build_reshard_plan(topo, dst, fields)
    ref = jax_plan(topo, dst, fields)
    assert plan.to_json() == ref.to_json() and plan.fingerprint() == ref.fingerprint()
    out = apply_plan_host(plan, {"T": T, "P": P, "E": E})
    nxyz_dst = elastic_local_size(topo, dst)
    T_ref = _blocks_from_global(GT, dst, tuple(nxyz_dst), ol, per)
    P_ref = _blocks_from_global(GP, dst, (nxyz_dst[0] + 1, nxyz_dst[1], nxyz_dst[2]), ol_P, per)
    assert np.array_equal(out["T"], T_ref) and np.array_equal(out["P"], P_ref)
    assert np.array_equal(out["E"], np.stack([T_ref, 2.0 * T_ref, -T_ref]))


def test_plan_rounds_are_partial_permutations():
    """Each round is one legal permute: unique sources and destinations, no
    self pairs (those are local), slots inside the flat mesh; byte
    accounting consistent with the round shapes."""
    plan = build_reshard_plan(
        _topo(), (1, 2, 2), {"T": ((12, 12, 6), "float32", 0), "P": ((14, 12, 6), "float32", 0)})
    assert plan.n_flat == 4 and plan.rounds > 0
    for sig in plan.sigs:
        for r in sig.rounds:
            srcs, dsts = [a for a, _ in r.pairs], [b for _, b in r.pairs]
            assert len(set(srcs)) == len(srcs) and len(set(dsts)) == len(dsts)
            assert all(a != b for a, b in r.pairs)
            assert all(0 <= s < plan.n_flat for s in srcs + dsts)
            assert all(p.size[d] <= r.pad[d] for p in r.pieces for d in range(len(r.pad)))
        assert all(p.src_rank == p.dst_rank for p in sig.local)
    expected = sum(int(np.prod(r.pad)) * len(r.pairs) * len(sig.names)
                   * np.dtype(sig.dtype).itemsize for sig in plan.sigs for r in sig.rounds)
    assert plan.wire_bytes == expected and plan.payload_bytes <= plan.wire_bytes
    # the destination's stacked blocks: 1x2x2 blocks of 10x6x4 (11x6x4 staggered)
    assert plan.nxyz_dst == (10, 6, 4)
    assert plan.dst_bytes == (10 * 12 * 8 + 11 * 12 * 8) * 4


def test_plan_validation_errors():
    topo = _topo()
    fields = {"T": ((12, 12, 6), "float32", 0)}
    with pytest.raises(InvalidArgumentError, match="nothing to re-block"):
        build_reshard_plan(topo, (2, 2, 1), fields)
    with pytest.raises(IncoherentArgumentError, match="divide"):
        build_reshard_plan(topo, (3, 1, 1), fields)
    with pytest.raises(IncoherentArgumentError, match="not divisible"):
        build_reshard_plan(topo, (1, 2, 2), {"T": ((13, 12, 6), "float32", 0)})
    with pytest.raises(IncoherentArgumentError, match="inconsistent"):
        build_reshard_plan(topo, (1, 2, 2), {"T": ((6, 6, 6), "float32", 0)})
    with pytest.raises(InvalidArgumentError, match="positive"):
        build_reshard_plan(topo, (0, 2, 2), fields)


@pytest.mark.parametrize("src,dst,per", MOVES)
def test_predict_reshard_equals_jax(src, dst, per):
    """`predict_reshard` prices a plan as the JAX package's does (rel 1e-12)
    under the same profile, and its break-even arithmetic agrees."""
    from implicitglobalgrid_tpu.reshard import build_reshard_plan as jax_plan
    from implicitglobalgrid_tpu.telemetry import (
        MachineProfile as JaxProfile, predict_reshard as jax_predict,
    )

    fields = {"T": (tuple(d * 6 for d in src), "float32", 0),
              "P": ((src[0] * 7, src[1] * 6, src[2] * 6), "float64", 0)}
    topo = _topo(dims=src, per=per)
    axes = {"gx": {"GBps": 12.5, "latency_s": 1.1e-4}, "gz": {"GBps": 3.25, "latency_s": 0.0}}
    got = tg.predict_reshard(build_reshard_plan(topo, dst, fields), profile=tg.MachineProfile(
        membw_GBps=374.0, flops_G=7152.0, axes=axes, source="calibrated"))
    ref = jax_predict(jax_plan(topo, dst, fields), profile=JaxProfile(
        membw_GBps=374.0, flops_G=7152.0, axes=axes, source="calibrated"))
    assert set(got) == set(ref)
    for k, v in ref.items():
        if isinstance(v, float):
            assert got[k] == pytest.approx(v, rel=1e-12, abs=0), k
        else:
            assert got[k] == v, k
    assert got["seconds"] == pytest.approx(got["latency_s"] + got["wire_s"] + got["local_s"])
    assert got.amortized_break_even_steps(50, 1e-3, 5e-4) \
        == ref.amortized_break_even_steps(50, 1e-3, 5e-4)
    dflt = tg.predict_reshard(build_reshard_plan(topo, dst, fields))  # no grid: "cpu"
    assert dflt["profile_source"] == "default" and dflt["seconds"] > 0


# ---------------------------------------------------------------------------
# the contract: the golden dump and the port's own recording
# ---------------------------------------------------------------------------

def _fixture_plan(dst=(1, 2, 2)):
    return build_reshard_plan(
        _topo(), dst, {"T": ((12, 12, 6), "float32", 0), "P": ((14, 12, 6), "float32", 0)})


def test_golden_fixture_contract_byte_exact_and_drift():
    """JAX's committed optimized-HLO dump of the canonical move, through
    the port's parser, honors the port's host-derived contract to the
    byte; a contract for another move fails against it."""
    from implicitglobalgrid_tpu_torch.analysis import audit_program, parse_program

    plan = _fixture_plan()
    rep = audit_program(_FIXTURE, contract=reshard_contract(plan))
    assert rep.ok, [f.message for f in rep.findings]
    ir = parse_program(_FIXTURE)
    assert len(ir.permutes) == plan.rounds
    assert sum(ir.wire_bytes_of(p) for p in ir.permutes) == plan.wire_bytes
    assert not ir.all_reduces and not ir.all_gathers and not ir.all_to_alls
    bad = audit_program(_FIXTURE, contract=reshard_contract(_fixture_plan((2, 1, 1))))
    assert not bad.ok
    assert any(f.rule in ("permute-route", "permute-count", "wire-bytes") for f in bad.findings)


# ---------------------------------------------------------------------------
# reshard_state: bitwise the oracle and the JAX package's
# ---------------------------------------------------------------------------

_JAX_MOVES = MOVES[1:] + [((2, 2, 2), (4, 2, 1), (0, 1, 0))]


def _init_jax_and_port(dims, per):
    kw = dict(dimx=dims[0], dimy=dims[1], dimz=dims[2], periodx=per[0], periody=per[1],
              periodz=per[2], quiet=True)
    igg.init_global_grid(6, 6, 6, **kw)
    tg.init_global_grid(6, 6, 6, device_type="cpu", **kw)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("src,dst,per", _JAX_MOVES)
def test_reshard_state_bitwise_jax_and_oracle(src, dst, per, dtype):
    """The dims x dtype x periodicity matrix: the port's device program
    reproduces the host oracle and the JAX package's `reshard_state`
    byte for byte, a staggered field included; its recording honors the
    plan's contract; the grid ends on the destination dims."""
    from implicitglobalgrid_tpu.reshard import reshard_state as jax_reshard

    _init_jax_and_port(src, per)
    rng = np.random.default_rng(7)
    host = {"T": rng.normal(size=tuple(src[d] * 6 for d in range(3))).astype(dtype),
            "P": rng.normal(size=(src[0] * 7, src[1] * 6, src[2] * 6)).astype(dtype)}
    state = {k: torch.from_numpy(v.copy()) for k, v in host.items()}
    plan = build_reshard_plan(live_topology(), dst, fields_of_state(state))
    expect = apply_plan_host(plan, host)
    new_state, info = reshard_state(state, dst, audit=True)
    rep = info["audit_report"]
    assert rep.ok, [f.message for f in rep.findings]
    assert rep.collectives["permutes"] == plan.rounds == info["rounds"]
    assert rep.collectives["wire_bytes"] == plan.wire_bytes
    assert tuple(int(d) for d in tg.global_grid().dims) == dst
    jax_state, _ = jax_reshard({k: igg.device_put_g(v) for k, v in host.items()}, dst)
    for k in state:
        got = new_state[k].numpy()
        assert np.array_equal(got, expect[k]), k
        assert np.array_equal(got, np.asarray(jax_state[k])), k
        assert torch.equal(state[k], torch.from_numpy(host[k]))  # the source untouched


def test_reshard_failure_restores_source_grid(monkeypatch):
    """A failure after the grid swap puts the source grid back and leaves
    the caller's state untouched; a move across processes is refused before
    anything is touched (the JAX package's multi-controller rule)."""
    from implicitglobalgrid_tpu_torch.reshard import program

    tg.init_global_grid(6, 6, 6, dimx=2, dimy=2, dimz=1, device_type="cpu", quiet=True)
    T = torch.arange(12 * 12 * 6, dtype=torch.float64).reshape(12, 12, 6)

    def boom(self, state):
        raise RuntimeError("copy failed")

    monkeypatch.setattr(program.ReshardProgram, "__call__", boom)
    program.clear_program_cache()
    with pytest.raises(RuntimeError, match="copy failed"):
        reshard_state({"T": T}, (1, 2, 2))
    gg = tg.global_grid()
    assert tuple(int(d) for d in gg.dims) == (2, 2, 1) and gg.device_type == "cpu"
    assert torch.equal(T, torch.arange(12 * 12 * 6, dtype=torch.float64).reshape(12, 12, 6))
    monkeypatch.undo()

    class TwoProcesses:
        world = 2

    monkeypatch.setattr(gg, "transport", TwoProcesses())
    with pytest.raises(InvalidArgumentError, match="one process"):
        reshard_state({"T": T}, (1, 2, 2))
    assert tuple(int(d) for d in tg.global_grid().dims) == (2, 2, 1)


# ---------------------------------------------------------------------------
# the driver: resize through the device path vs the checkpoint path
# ---------------------------------------------------------------------------

def _diffusion_step():
    from implicitglobalgrid_tpu_torch.models import diffusion_step_local, init_diffusion3d

    T, Cp, p = init_diffusion3d(dtype=torch.float64)

    def step(s):
        return {"T": diffusion_step_local(s["T"], s["Cp"], p, "plain"), "Cp": s["Cp"]}

    return step, {"T": T, "Cp": Cp}


def _run_resized(tmp_path, tag, via, nt=12, resize_at=6, tuned=None, audit=False):
    tg.init_global_grid(6, 6, 6, dimx=2, dimy=2, dimz=1, device_type="cpu", quiet=True)
    step, state = _diffusion_step()
    run = tg.ResilientRun(step, state, nt, tg.RunSpec(
        nt_chunk=3, checkpoint_dir=str(tmp_path / f"ck_{tag}"), tuned=tuned, audit=audit))
    recs = []
    try:
        while run.advance():
            if via is not None and run.step == resize_at:
                recs.append(run.resize((1, 2, 2), via=via))
                via = None
    finally:
        run.close()
    out = tg.gather_interior(run.state["T"])
    stale = run.tuned_stale_reason
    tg.finalize_global_grid()
    return out, recs, stale


def test_resize_device_vs_checkpoint_vs_unresized(tmp_path):
    """A mid-run dims change on the device path ends bitwise the checkpoint
    path AND the never-resized run, with the move's recording audited
    (``program="reshard"``), the resize span and metrics recorded, one
    clean chunk audit before and after the move, and an applied
    `TunedConfig` marked stale."""
    from implicitglobalgrid_tpu_torch.telemetry import TunedConfig

    ref, _, _ = _run_resized(tmp_path, "ref", via=None)
    tg.metrics_registry().reset("igg_health_events_total")
    tg.start_flight_recorder(str(tmp_path / "fr.jsonl"))
    try:
        dev, recs, stale = _run_resized(tmp_path, "dev", via="device", audit=True,
                                        tuned=TunedConfig(model="diffusion3d"))
    finally:
        tg.stop_flight_recorder()
    fam = tg.metrics_registry().get("igg_health_events_total")
    assert {l["kind"]: int(v) for l, v in fam.samples()}["resizes"] == 1
    ckp, recs_c, _ = _run_resized(tmp_path, "ckp", via="checkpoint")
    assert np.array_equal(dev, ckp) and np.array_equal(dev, ref)
    assert recs[0]["via"] == "device" and recs[0]["rounds"] > 0
    assert recs_c[0]["via"] == "checkpoint" and "rounds" not in recs_c[0]
    assert stale == "resize"
    evs = tg.read_flight_events(str(tmp_path / "fr.jsonl"))
    resize = [e for e in evs if e.get("kind") == "resize"]
    assert len(resize) == 1 and resize[0]["via"] == "device"
    assert resize[0]["wire_bytes"] > 0 and resize[0]["dur_s"] > 0
    stale_evs = [e for e in evs if e.get("kind") == "tuned_stale"]
    assert len(stale_evs) == 1 and stale_evs[0]["reason"] == "resize"
    audits = [e for e in evs if e.get("kind") == "audit"]
    assert [a["program"] for a in audits] == ["chunk", "reshard", "chunk"]
    assert all(a["ok"] for a in audits)
    fam = tg.metrics_registry().get("igg_reshard_rounds")
    assert fam is not None and fam.samples()[0][1] == recs[0]["rounds"]
    kinds = {l["kind"] for l, _ in tg.metrics_registry().get("igg_reshard_bytes_total").samples()}
    assert "wire" in kinds


def test_resize_auto_records_the_fallback(tmp_path, monkeypatch):
    """Under ``via="auto"`` a failed device path falls back to the
    checkpoint path, recorded as ``via="checkpoint"`` with the device error
    in the record and the event, and ends bitwise the unresized run; under
    ``via="device"`` the same failure raises."""
    import implicitglobalgrid_tpu_torch.reshard as rs

    ref, _, _ = _run_resized(tmp_path, "ref", via=None)

    def refuse(*a, **k):
        raise InvalidArgumentError("refused for the test")

    monkeypatch.setattr(rs, "reshard_state", refuse)
    tg.start_flight_recorder(str(tmp_path / "fr.jsonl"))
    try:
        got, recs, _ = _run_resized(tmp_path, "auto", via="auto")
    finally:
        tg.stop_flight_recorder()
    assert np.array_equal(got, ref)
    assert recs[0]["via"] == "checkpoint" and "refused" in recs[0]["device_error"]
    [ev] = [e for e in tg.read_flight_events(str(tmp_path / "fr.jsonl"))
            if e.get("kind") == "resize"]
    assert ev["via"] == "checkpoint" and "refused" in ev["device_error"]
    with pytest.raises(InvalidArgumentError, match="refused"):
        _run_resized(tmp_path, "dev", via="device")


def test_resize_validation(monkeypatch):
    """The JAX package's argument errors, raised before any path touches
    the grid. One divergence: the JAX package refuses dims that need more
    devices than it sees ("need N device(s)"); the port's virtual mesh holds
    every rank on one card, so (8, 2, 1) — 16 ranks — re-blocks here, and
    the refusal is instead a destination that does not fit the card's free
    memory (`reshard.plan.check_device_memory`; no check on the CPU, so the
    test shrinks the reported free memory)."""
    from implicitglobalgrid_tpu_torch.reshard import plan as plan_mod

    tg.init_global_grid(6, 6, 6, dimx=2, dimy=2, dimz=1, device_type="cpu", quiet=True)
    step, state = _diffusion_step()
    run = tg.ResilientRun(step, state, 6, tg.RunSpec(nt_chunk=3))
    try:
        with pytest.raises(InvalidArgumentError, match="via"):
            run.resize((1, 2, 2), via="nope")
        assert run.resize((2, 2, 1))["via"] == "noop"
        with pytest.raises(IncoherentArgumentError, match="divide"):
            run.resize((3, 1, 1))
        monkeypatch.setattr(plan_mod, "_free_device_bytes", lambda device: 1024)
        with pytest.raises(InvalidArgumentError, match="device memory"):
            run.resize((8, 2, 1))
        assert tuple(int(d) for d in tg.global_grid().dims) == (2, 2, 1)
        monkeypatch.undo()
        with pytest.raises(ResilienceError, match="no checkpoint_dir"):
            run.resize((1, 2, 2), via="checkpoint")
        rec = run.resize((8, 2, 1), via="device")  # 16 ranks on the virtual mesh
        assert rec["via"] == "device" and tuple(int(d) for d in tg.global_grid().dims) \
            == (8, 2, 1)
        assert run.advance() and run.step == 3
    finally:
        run.close()


# ---------------------------------------------------------------------------
# ensembles: the member axis passes through
# ---------------------------------------------------------------------------

def test_ensemble_elastic_restore_per_member(tmp_path):
    """(:344) A member-stacked checkpoint restores onto other dims with each
    member bitwise the solo elastic restore of its own field."""
    from implicitglobalgrid_tpu_torch.models import ensemble_state
    from implicitglobalgrid_tpu_torch.utils.checkpoint import elastic_local_size, saved_topology

    E = 3
    tg.init_global_grid(6, 6, 6, dimx=2, dimy=2, dimz=1, device_type="cpu", quiet=True)
    x, y, z = tg.coords_g(0.5, 0.5, 0.5, tg.zeros_g())
    T = x + 10 * y + 100 * z
    Te = ensemble_state(T, E, perturb=0.01)
    tg.save_checkpoint_sharded(str(tmp_path / "ens"), {"T": Te}, step=7)
    for m in range(E):
        tg.save_checkpoint_sharded(str(tmp_path / f"solo{m}"), {"T": Te[m].clone()})
    tg.finalize_global_grid()
    nx = elastic_local_size(saved_topology(str(tmp_path / "ens")), (1, 2, 2))
    tg.init_global_grid(*nx, dimx=1, dimy=2, dimz=2, device_type="cpu", quiet=True)
    st, step = tg.restore_checkpoint_elastic(str(tmp_path / "ens"))
    assert step == 7
    for m in range(E):
        solo, _ = tg.restore_checkpoint_elastic(str(tmp_path / f"solo{m}"))
        assert torch.equal(st["T"][m], solo["T"]), f"member {m}"


def test_ensemble_on_device_resize_per_member():
    """(:572) The batched state re-blocks on the device path with each
    member bitwise the re-block of its own slice."""
    from implicitglobalgrid_tpu_torch.models import ensemble_state

    E = 3
    tg.init_global_grid(6, 6, 6, dimx=2, dimy=2, dimz=1, device_type="cpu", quiet=True)
    x, y, z = tg.coords_g(0.5, 0.5, 0.5, tg.zeros_g())
    Te = ensemble_state(x + 10 * y + 100 * z, E, perturb=0.01)
    members = [Te[m].numpy().copy() for m in range(E)]
    assert fields_of_state({"T": Te})["T"][2] == 1
    new_state, info = reshard_state({"T": Te}, (1, 2, 2), audit=True)
    assert info["audit_report"].ok
    solo_plan = build_reshard_plan(_topo(), (1, 2, 2),
                                   {"T": (members[0].shape, str(members[0].dtype), 0)})
    for m in range(E):
        expect = apply_plan_host(solo_plan, {"T": members[m]})["T"]
        assert np.array_equal(new_state["T"][m].numpy(), expect), f"member {m}"


def test_regrid_keeps_the_device_binding(tmp_path, monkeypatch):
    """A resize's grid rebuild on either path replaces a live grid, so the
    process keeps the device that grid bound it to: no second
    `select_device`, which refuses two processes sharing one card (the
    chip's transport phase runs two processes on one card)."""
    import implicitglobalgrid_tpu_torch.parallel.grid as grid_mod

    calls = []
    real = grid_mod.init_global_grid

    def spy(*a, **kw):
        calls.append(kw.get("select_device", True))
        return real(*a, **kw)

    monkeypatch.setattr(grid_mod, "init_global_grid", spy)
    for via in ("device", "checkpoint"):
        tg.init_global_grid(6, 6, 6, dimx=2, dimy=2, dimz=1, device_type="cpu", quiet=True)
        step, state = _diffusion_step()
        run = tg.ResilientRun(step, state, 6, tg.RunSpec(
            nt_chunk=3, checkpoint_dir=str(tmp_path / via)))
        try:
            run.advance()
            calls.clear()
            assert run.resize((1, 2, 2), via=via)["via"] == via
        finally:
            run.close()
        assert calls == [False], (via, calls)
        tg.finalize_global_grid()
