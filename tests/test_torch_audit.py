"""The port's communication audit (`implicitglobalgrid_tpu_torch.analysis`)
against the JAX package's compiled programs, on the CPU.

For each structural claim of `tests/test_hlo_audit.py` the same grid and
fields are built in both packages: the JAX side compiles the exchange or
step on its 8-device CPU mesh and parses it, the port records what its
routes move (`analysis.record`). Per mesh axis, `measure_axes` of the
recording (permutes, directed pairs, all-links wire bytes, payload dtypes)
must equal `measure_axes` of the JAX program, the recording must honor the
port's plan-derived contract with no findings, and the two packages'
contracts must serialize equal. Then `audit_model` (the perf-model
crosscheck of the four families; the ensemble flat in E; the mixed-cadence
super-step), the guard's one sum (shared with the reducers), the driver's
``audit=True`` (one audit per distinct chunk length; across an elastic
restart: `tests/test_torch_resilience.py`), and the recorder being off by
default.
"""

import os

import numpy as np
import pytest
import torch

import implicitglobalgrid_tpu as igg
import implicitglobalgrid_tpu_torch as tg
from implicitglobalgrid_tpu.analysis import (
    exchange_contract as jax_exchange_contract, measure_axes as jax_measure,
    model_contract as jax_model_contract, parse_program as jax_parse,
)
from implicitglobalgrid_tpu.analysis.contracts import axis_routes as jax_routes
from implicitglobalgrid_tpu_torch.analysis import (
    CollectiveContract, audit_model, check_contract, exchange_contract, guard_contract,
    measure_axes, model_contract, record_program,
)
from implicitglobalgrid_tpu_torch.analysis.contracts import axis_routes

from torch_port_util import clean_torch_grid, init_both  # noqa: F401

pytestmark = pytest.mark.audit

def _grid(nx, ny, nz, dims, periods, **kw):
    init_both(nx, ny, nz, dimx=dims[0], dimy=dims[1], dimz=dims[2], periodx=periods[0],
              periody=periods[1], periodz=periods[2], nranks=int(np.prod(dims)), **kw)


def _fields(dims, shape, dtypes):
    import jax.numpy as jnp

    stacked = tuple(d * s for d, s in zip(dims, shape))
    g = np.random.default_rng(5)
    host = [g.standard_normal(stacked).astype(dt) for dt in dtypes]
    return ([jnp.asarray(h) for h in host],
            [torch.from_numpy(h.copy()) for h in host])


def _jax_exchange(args, coalesce=None, wire=None, optimized=True):
    """`ProgramIR` of JAX's compiled multi-field exchange (the program
    `tests/test_hlo_audit.py` audits)."""
    import jax

    from implicitglobalgrid_tpu.ops import halo as halo_mod
    from implicitglobalgrid_tpu.ops.fields import field_partition_spec
    from implicitglobalgrid_tpu.ops.precision import resolve_wire_dtype
    from implicitglobalgrid_tpu.utils.compat import shard_map

    gg = igg.global_grid()
    specs = (field_partition_spec(args[0].ndim),) * len(args)
    wire_r = resolve_wire_dtype(wire)

    def exchange(*arrays):
        return tuple(halo_mod._exchange_arrays(
            gg, list(arrays), [gg.halowidths] * len(arrays),
            halo_mod._normalize_dims_order(None), coalesce=coalesce, wire=wire_r))

    fn = jax.jit(shard_map(exchange, mesh=gg.mesh, in_specs=specs, out_specs=specs))
    return jax_parse(fn, *args, optimized=optimized)


def _port_exchange(args, coalesce=None, wire=None):
    from implicitglobalgrid_tpu_torch.ops import halo as halo_mod
    from implicitglobalgrid_tpu_torch.ops.precision import resolve_wire_dtype

    gg = tg.global_grid()

    def exchange(*arrays):
        return tuple(halo_mod._exchange_arrays(
            gg, list(arrays), [gg.halowidths] * len(arrays), halo_mod.DEFAULT_DIMS_ORDER,
            coalesce=coalesce, wire=resolve_wire_dtype(wire)))

    return record_program(exchange, *args).program()


def _same_measure(port_ir, jax_ir):
    got, ref = measure_axes(port_ir, axis_routes()), jax_measure(jax_ir, jax_routes())
    assert got == ref, (got, ref)
    return got


def _honors(ir, contract):
    findings = check_contract(ir, contract)
    assert not findings, [f.to_json() for f in findings]


def _same_json(port_contract, jax_contract):
    a, b = port_contract.to_json(), jax_contract.to_json()
    assert a == b, (a, b)


# (grid args, stacked-field shape a block, dtypes, coalesce, wire, JAX dialect
# optimized): the exchanges of `tests/test_hlo_audit.py`
EXCHANGES = {
    # one pair per exchanging axis (:75)
    "one_pair_per_axis": (((8, 8, 8), (2, 2, 2), (1, 1, 1), {}), [np.float32], None, None, True),
    # self-neighbour axes emit nothing (:90)
    "self_neighbour": (((8, 8, 8), (1, 1, 1), (1, 1, 1), {}), [np.float32], None, None, True),
    # a non-exchanging axis emits no permute (:103)
    "non_exchanging_axis": (((8, 8, 8), (2, 1, 4), (1, 0, 1), {}), [np.float32], None, None,
                            True),
    # coalesced counts flat in the field count, and the per-field 2N (:131)
    "coalesced_2": (((8, 8, 8), (2, 2, 2), (1, 1, 1), {}), [np.float32] * 2, None, None, True),
    "coalesced_4": (((8, 8, 8), (2, 2, 2), (1, 1, 1), {}), [np.float32] * 4, None, None, True),
    "coalesced_8": (((8, 8, 8), (2, 2, 2), (1, 1, 1), {}), [np.float32] * 8, None, None, True),
    "per_field_4": (((8, 8, 8), (2, 2, 2), (1, 1, 1), {}), [np.float32] * 4, False, None,
                    True),
    # mixed dtypes: one pair per dtype group (:148)
    "mixed_dtypes": (((8, 8, 8), (8, 1, 1), (1, 0, 0), {}),
                     [np.float32] * 3 + [np.float64] * 2, None, None, True),
    # the wire cast (:167, the lowered module) and int8 / int4 exact (:203)
    "wire_bfloat16": (((8, 8, 8), (2, 2, 2), (1, 1, 1), {}), [np.float32] * 2, None,
                      "bfloat16", False),
    "wire_int8": (((8, 8, 8), (2, 1, 4), (1, 0, 1), {}), [np.float32] * 4, None, "int8",
                  True),
    "wire_int4": (((8, 8, 8), (2, 1, 4), (1, 0, 1), {}), [np.float32] * 4, None, "int4",
                  True),
    # the per-axis policy (:239)
    "wire_per_axis": (((8, 8, 8), (2, 1, 4), (1, 0, 1), {}), [np.float32] * 2, None,
                      "z:int8,x:f32", True),
    # halowidth 2 (:1047)
    "halowidth_2": (((12, 12, 12), (2, 2, 2), (1, 1, 1),
                     dict(overlaps=(4, 4, 4), halowidths=(2, 2, 2))), [np.float32], None, None,
                    True),
}


@pytest.mark.parametrize("case", sorted(EXCHANGES))
def test_exchange_recording_matches_jax_program(case):
    (n, dims, per, kw), dtypes, coalesce, wire, optimized = EXCHANGES[case]
    _grid(*n, dims, per, **kw)
    jargs, targs = _fields(dims, n, dtypes)
    ref = _jax_exchange(jargs, coalesce=coalesce, wire=wire, optimized=optimized)
    ir = _port_exchange(targs, coalesce=coalesce, wire=wire)
    by_axis = _same_measure(ir, ref)
    contract = exchange_contract(*targs, coalesce=coalesce, wire_dtype=wire)
    _honors(ir, contract)
    _same_json(contract, jax_exchange_contract(*jargs, coalesce=coalesce, wire_dtype=wire))
    assert not ir.all_reduces and not ir.all_gathers
    if case == "self_neighbour":
        assert not ir.permutes and contract.axes == {}
    if case.startswith("coalesced"):
        assert all(v["permutes"] == 2 for v in by_axis.values())
    if case == "per_field_4":
        assert all(v["permutes"] == 8 for v in by_axis.values())
    if case == "mixed_dtypes":
        assert by_axis["gx"]["permutes"] == 4 and by_axis["gx"]["dtypes"] == ("f32", "f64")
    if case.startswith("wire_int"):
        exact = exchange_contract(*targs)
        floor = 3.5 if case == "wire_int8" else 7.0
        assert all(exact.axes[a]["wire_bytes"] >= floor * contract.axes[a]["wire_bytes"]
                   for a in contract.axes)
    if case == "wire_per_axis":
        assert by_axis["gx"]["dtypes"] == ("f32",) and by_axis["gz"]["dtypes"] == ("s8",)


# the fused steps (:383-451): (grid args, model, ndim, permutes)
FUSED = {
    "diffusion3d": (((8, 8, 16), (2, 2, 2), (1, 1, 1)), "diffusion3d", 6),
    "diffusion3d_mixed_mesh": (((8, 8, 16), (1, 2, 4), (1, 0, 1)), "diffusion3d", 4),
    "diffusion3d_all_self": (((16, 16, 16), (1, 1, 1), (1, 1, 1)), "diffusion3d", 0),
    "diffusion2d": (((16, 16, 1), (2, 2, 1), (1, 1, 0)), "diffusion2d", 4),
    "acoustic3d": (((8, 8, 16), (2, 2, 2), (1, 1, 1)), "acoustic3d", 6),
    "stokes3d": (((8, 8, 16), (2, 2, 2), (1, 1, 1)), "stokes3d", 6),
}


def _jax_fused(model):
    from implicitglobalgrid_tpu import models as M

    if model.startswith("diffusion"):
        ndim = 3 if model.endswith("3d") else 2
        T, Cp, p = (M.init_diffusion3d if ndim == 3 else M.init_diffusion2d)(dtype=np.float32)
        return jax_parse(M.make_step(p, ndim=ndim, impl="pallas_interpret"), T, Cp), (T, Cp)
    init, make = ((M.init_acoustic3d, M.make_acoustic_run) if model == "acoustic3d"
                  else (M.init_stokes3d, M.make_stokes_run))
    state, p = init(dtype=np.float32)
    return jax_parse(make(p, 1, impl="pallas_interpret"), *state), tuple(state)


def _port_fused(model):
    from implicitglobalgrid_tpu_torch import models as M

    if model.startswith("diffusion"):
        ndim = 3 if model.endswith("3d") else 2
        T, Cp, p = (M.init_diffusion3d if ndim == 3 else M.init_diffusion2d)(
            dtype=torch.float32)
        return record_program(M.make_run(p, 1, ndim=ndim, impl="cuda"), T, Cp), (T, Cp)
    init, make = ((M.init_acoustic3d, M.make_acoustic_run) if model == "acoustic3d"
                  else (M.init_stokes3d, M.make_stokes_run))
    state, p = init(dtype=torch.float32)
    return record_program(make(p, 1, impl="cuda"), *state), tuple(state)


@pytest.mark.parametrize("case", sorted(FUSED))
def test_fused_step_recording_matches_jax_program(case):
    """The port's fused routes (K4s + K4 / K5 / K9 / K10, their plain
    versions on the CPU) record JAX's fused tier's wire: one packed pair a
    mesh axis and round, byte-exact to the fused-round contract."""
    (n, dims, per), model, n_permutes = FUSED[case]
    _grid(*n, dims, per)
    ref, jfields = _jax_fused(model)
    rec, tfields = _port_fused(model)
    ir = rec.program()
    assert [o.metadata["site"] for o in ir.permutes] == ["slabs"] * n_permutes
    _same_measure(ir, ref)
    assert len(ir.permutes) == n_permutes == len(ref.permutes)
    assert not ir.all_reduces and not ir.all_gathers
    contract = model_contract(model, tfields, impl="cuda")
    _honors(ir, contract)
    j = jax_model_contract(model, jfields, impl="pallas").to_json()
    p = model_contract(model, tfields, impl="pallas").to_json()
    assert p == j


def _guarded(nt_chunk, reducers=()):
    from implicitglobalgrid_tpu_torch.io.reducers import build_reducer_plan, \
        make_reduced_post_chunk
    from implicitglobalgrid_tpu_torch.models import diffusion_step_local, init_diffusion3d
    from implicitglobalgrid_tpu_torch.models.common import make_state_runner
    from implicitglobalgrid_tpu_torch.runtime.health import make_guarded_runner

    T, Cp, p = init_diffusion3d(dtype=torch.float32)

    def step(s, spare):
        return (diffusion_step_local(s[0], s[1], p, "plain"), s[1]), None

    if not reducers:
        return make_guarded_runner(step, nt_chunk=nt_chunk), (T, Cp), 0
    plan = build_reducer_plan(list(reducers), ("T", "Cp"), {"T": T, "Cp": Cp})
    return (make_state_runner(step, nt_chunk=nt_chunk,
                              post_chunk=make_reduced_post_chunk(("T", "Cp"), plan)),
            (T, Cp), plan.length)


def test_guard_one_allreduce_shared_with_reducers():
    """The guarded chunk (:675) records exactly one f32[2N] sum beside the
    step's exchange, whatever the chunk length, and the reducers (:967)
    share it (f32[2N + R]); the recording's steps agree, and the recorded
    chunk measures as JAX's guarded chunk program does."""
    from implicitglobalgrid_tpu import models as JM
    from implicitglobalgrid_tpu.runtime.health import make_guarded_runner as jax_guarded

    _grid(8, 8, 8, (2, 2, 2), (1, 1, 1))
    T, Cp, p = JM.init_diffusion3d(dtype=np.float32)
    jrun = jax_guarded(lambda s: (JM.diffusion_step_local(s[0], s[1], p, "xla"), s[1]),
                       (3, 3), nt_chunk=2, key="torch_audit_guard")
    jir = jax_parse(jrun, T, Cp)
    for nt_chunk in (1, 4):
        run, args, _ = _guarded(nt_chunk)
        rec = record_program(run, *args)
        assert rec.steps() == list(range(nt_chunk)) and not rec.step_findings()
        ir = rec.program()
        _same_measure(ir, jir)
        assert len(ir.all_reduces) == len(jir.all_reduces) == 1
        assert str(ir.payload_of(ir.all_reduces[0])) == "f32[4]"
        _honors(ir, guard_contract(2))
    from implicitglobalgrid_tpu_torch.io.reducers import AxisSlice, Probe, Stats

    run, args, length = _guarded(2, [Probe("T", (0, 0, 0)), AxisSlice("T", 0, (0, 1, 1)),
                                         Stats("T")])
    assert length == 1 + 12 + 2 + 2 * 8
    ir = record_program(run, *args).program()
    assert len(ir.all_reduces) == 1 and len(ir.permutes) == 6
    _honors(ir, guard_contract(2, length))
    assert {f.rule for f in check_contract(ir, guard_contract(2))} == {"allreduce-payload"}


@pytest.mark.parametrize("model,impl", [
    ("diffusion3d", "plain"), ("acoustic3d", "plain"), ("stokes3d", "plain"),
    ("diffusion3d", "cuda"),
])
def test_audit_model_crosschecks_perfmodel(model, impl):
    """(:1061) For each family, `audit_model`'s recording honors the
    plan-derived contract and the perf oracle's priced pairs and bytes
    equal the recorded ones, axis by axis, and equal JAX's crosscheck of
    its compiled step."""
    _grid(8, 8, 8, (2, 2, 2), (1, 1, 1))
    rep = audit_model(model, impl=impl)
    assert rep.ok, [f.to_json() for f in rep.findings]
    assert rep.dialect == "record"
    cc = rep.crosscheck
    assert cc is not None and cc["ok"] and sorted(cc["axes"]) == ["gx", "gy", "gz"]
    for r in cc["axes"].values():
        assert r["modeled_pairs"] == r["parsed_pairs"] > 0
        assert r["modeled_wire_bytes"] == r["parsed_wire_bytes"] > 0
    ref = igg.audit_model(model, impl={"plain": "xla", "cuda": "pallas_interpret"}[impl])
    assert ref.ok and cc["axes"] == ref.crosscheck["axes"]


def test_audit_model_ensemble_flat_in_members():
    """(`tests/test_ensemble.py:92`) `audit_model(ensemble=8)` records the
    8-member batched step: the solo permute counts, 8 x the solo bytes, the
    contract and the crosscheck clean; the batched guard (:124) is still one
    sum of f32[E·2N]."""
    from implicitglobalgrid_tpu_torch.models import ensemble_state

    _grid(6, 6, 6, (2, 2, 1), (0, 0, 0))
    rep1 = audit_model("diffusion3d")
    rep8 = audit_model("diffusion3d", ensemble=8)
    assert rep8.ok, [f.to_json() for f in rep8.findings]
    assert rep8.meta["ensemble"] == 8
    assert rep8.collectives["permutes"] == rep1.collectives["permutes"] > 0
    assert rep8.collectives["all_reduces"] == rep8.collectives["all_gathers"] == 0
    assert rep8.collectives["wire_bytes"] == 8 * rep1.collectives["wire_bytes"] > 0
    for axis, exp in rep8.contract.axes.items():
        assert exp["permutes"] == rep1.contract.axes[axis]["permutes"]
        assert exp["wire_bytes"] == 8 * rep1.contract.axes[axis]["wire_bytes"]
    cc = rep8.crosscheck
    assert cc["ok"] and cc["ensemble"] == 8
    ref = igg.audit_model("diffusion3d", ensemble=8)
    assert cc["axes"] == ref.crosscheck["axes"]
    from implicitglobalgrid_tpu_torch.models import diffusion_step_local, init_diffusion3d
    from implicitglobalgrid_tpu_torch.runtime.health import make_guarded_runner

    E = 3
    run, (T, Cp), _ = _guarded(2)
    p = init_diffusion3d(dtype=torch.float32)[2]
    ens = make_guarded_runner(
        lambda s, spare: ((diffusion_step_local(s[0], s[1], p, "plain", members=E), s[1]),
                          None), nt_chunk=2, ensemble=E)
    ir = record_program(ens, ensemble_state(T, E), ensemble_state(Cp, E)).program()
    solo = record_program(run, T, Cp).program()
    assert len(ir.permutes) == len(solo.permutes) and len(ir.all_reduces) == 1
    assert str(ir.payload_of(ir.all_reduces[0])) == f"f32[{E},4]"
    _honors(ir, guard_contract(2, ensemble=E))


def test_comm_every_per_axis_contract_byte_exact():
    """(`tests/test_comm_avoid.py:427`) The mixed-cadence super-step
    records exactly the planned per-axis permute counts and wire bytes:
    cadence alone, and composed with the per-axis ``z:int8,x:f32`` wire;
    JAX's crosscheck of its compiled super-step agrees axis by axis."""
    _grid(9, 9, 10, (2, 2, 2), (1, 1, 1), overlaps=(2, 2, 4), halowidths=(1, 1, 2))
    rep = audit_model("diffusion3d", comm_every="z:2")
    assert rep.ok, [f.message for f in rep.findings]
    cc = rep.crosscheck
    assert cc["ok"] and cc["comm_every"] == "z:2"
    assert cc["axes"]["gx"]["parsed_pairs"] == 2.0 and cc["axes"]["gz"]["parsed_pairs"] == 1.0
    assert cc["axes"]["gz"]["modeled_wire_bytes"] == cc["axes"]["gz"]["parsed_wire_bytes"]
    rep_q = audit_model("diffusion3d", comm_every="z:2", wire_dtype="z:int8,x:f32")
    assert rep_q.ok and rep_q.crosscheck["ok"], [f.message for f in rep_q.findings]
    assert (rep_q.crosscheck["axes"]["gz"]["parsed_wire_bytes"]
            < cc["axes"]["gz"]["parsed_wire_bytes"])
    assert "IGG_HALO_WIRE_DTYPE" not in os.environ
    ref = igg.audit_model("diffusion3d", comm_every="z:2", wire_dtype="z:int8,x:f32")
    assert rep_q.crosscheck["axes"] == ref.crosscheck["axes"]


def test_run_resilient_audit_one_per_distinct_chunk(tmp_path):
    """``audit=True`` audits the first real chunk of each distinct length,
    recorded while it runs: the results are bitwise an unaudited run's, the
    stream holds one clean ``audit`` event a length (two lengths here: the
    steady 2 and the clipped 1), and `run_report` reconstructs them."""
    from implicitglobalgrid_tpu_torch.models import diffusion_step_local, init_diffusion3d

    tg.init_global_grid(8, 8, 8, dimx=2, dimy=2, dimz=2, periodx=1, periody=1, periodz=1,
                        device_type="cpu", quiet=True)
    T, Cp, p = init_diffusion3d(dtype=torch.float32)

    def step(s):
        return {"T": diffusion_step_local(s["T"], s["Cp"], p, "plain"), "Cp": s["Cp"]}

    fr = str(tmp_path / "fr.jsonl")
    tg.reset_metrics()
    tg.start_flight_recorder(fr)
    try:
        st_a, _ = tg.run_resilient(step, {"T": T, "Cp": Cp}, 5, nt_chunk=2, audit=True,
                                   audit_lints=("host-transfer", "f64-leakage"))
    finally:
        tg.stop_flight_recorder()
    st_p, _ = tg.run_resilient(step, {"T": T, "Cp": Cp}, 5, nt_chunk=2)
    assert torch.equal(st_a["T"], st_p["T"])
    audits = [e for e in tg.read_flight_events(fr) if e["kind"] == "audit"]
    assert len(audits) == 2 and all(a["ok"] and a["program"] == "chunk" for a in audits)
    assert all(a["collectives"]["all_reduces"] == 1 and a["collectives"]["permutes"] == 6
               for a in audits)
    fam = tg.metrics_registry().get("igg_audit_findings_total")
    assert fam is None or not any(v for _, v in fam.samples())


def test_recorder_off_by_default():
    """Outside `recording()` the hook sites record nothing: no recording is
    open, the exchange runs unchanged, and an open recording does not
    nest."""
    from implicitglobalgrid_tpu_torch.analysis import record, recording
    from implicitglobalgrid_tpu_torch.utils.exceptions import InvalidArgumentError

    tg.init_global_grid(8, 8, 8, dimx=2, dimy=2, dimz=2, periodx=1, device_type="cpu",
                        quiet=True)
    assert record.ACTIVE is None
    A = torch.zeros(16, 16, 16)
    out = tg.update_halo(A.clone())
    with recording() as rec:
        got = tg.update_halo(A.clone())
        with pytest.raises(InvalidArgumentError, match="already open"):
            with recording():
                pass
    assert record.ACTIVE is None and torch.equal(out, got) and len(rec.ops) == 6
    assert CollectiveContract.from_json(exchange_contract(A).to_json()).axes \
        == exchange_contract(A).axes
