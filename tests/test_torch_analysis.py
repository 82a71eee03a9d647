"""The port's copy of the analysis parser, contracts and lints
(`implicitglobalgrid_tpu_torch.analysis`) on the JAX package's golden dumps
(tests/data/hlo/) and hand-written programs: every case of
`tests/test_analysis.py` but the live-compile format canary (it needs JAX's
compiler), with the port's modules, plus parity with the JAX package's
parser on every fixture (the same ops, payloads, routes and per-axis
measure) and the recorded (``"record"``) dialect's own rule behaviour.
Host-only: no grid unless a case inits the port's CPU grid.
"""

import os

import numpy as np
import pytest

from implicitglobalgrid_tpu_torch.analysis import (
    CollectiveContract, LINT_RULES, check_contract, guard_contract,
    parse_program, parse_text, run_lints,
)
from implicitglobalgrid_tpu_torch.analysis.contracts import (
    attribute_axis, hlo_dtype, measure_axes, sort_findings,
)
from implicitglobalgrid_tpu_torch.analysis.hlo import Shape
from implicitglobalgrid_tpu_torch.analysis.lints import LintConfig
from implicitglobalgrid_tpu_torch.utils.exceptions import InvalidArgumentError

pytestmark = pytest.mark.audit

_DATA = os.path.join(os.path.dirname(__file__), "data", "hlo")


def _fixture(name):
    with open(os.path.join(_DATA, name), encoding="utf-8") as f:
        return parse_text(f.read())


# 8-shard ring routes in linearized mesh positions (dims=(8,1,1) periodic):
# the two exchange directions of the single fixture axis
_RING_P = frozenset((i, (i + 1) % 8) for i in range(8))
_RING_M = frozenset((i, (i - 1) % 8) for i in range(8))
_ROUTES = {"gx": (_RING_P, _RING_M)}


def test_parse_single_axis_fixture():
    """One f32 field on a dims=(8,1,1) periodic mesh: exactly one permute
    pair, slab payloads f32[1,8,8] = 256 B x 8 directed links = 2048 B on
    the wire each, riding the two x-axis ring routes."""
    ir = _fixture("exchange_single_axis.hlo.txt")
    assert ir.dialect == "hlo" and ir.module == "jit_exchange"
    assert ir.entry and ir.entry.startswith("main")
    assert len(ir.permutes) == 2
    assert not ir.all_reduces and not ir.all_gathers and not ir.all_to_alls
    for op in ir.permutes:
        pay = ir.payload_of(op)
        assert (pay.dtype, pay.dims) == ("f32", (1, 8, 8))
        assert pay.nbytes == 256 and ir.wire_bytes_of(op) == 2048
        pairs = op.attrs["source_target_pairs"]
        assert frozenset(pairs) in (_RING_P, _RING_M)
        # the parser keeps the compiler's provenance metadata
        assert op.metadata.get("source_file", "").endswith("halo.py")
    assert {op.attrs["channel_id"] for op in ir.permutes} == {1, 2}
    assert len(ir.parameters()) == 1
    # route attribution over an explicit (grid-free) route table
    axes = measure_axes(ir, _ROUTES)
    assert axes == {"gx": {"permutes": 2, "pairs": 16, "wire_bytes": 4096,
                           "dtypes": ("f32",)}}
    assert attribute_axis(_ROUTES, [(0, 3)]) is None


def test_parse_coalesced_fixture():
    """Four coalesced f32 fields: STILL one permute pair, the payload now
    the packed 4 x 64-cell slab buffer (f32[256])."""
    ir = _fixture("exchange_coalesced_4field.hlo.txt")
    assert len(ir.permutes) == 2
    for op in ir.permutes:
        pay = ir.payload_of(op)
        assert (pay.dtype, pay.cells) == ("f32", 256)
        assert ir.wire_bytes_of(op) == 8192
    assert len(ir.parameters()) == 4
    # the slab bound: 4 fields x 512-cell blocks = 2048; payloads within
    assert check_contract(ir, CollectiveContract(
        routes=_ROUTES, max_payload_cells=4 * 512)) == []


def test_parse_ensemble_coalesced_fixture():
    """E=4 member-batched two-field coalesced exchange: STILL
    exactly one permute pair on the ring — the vmapped member axis rides
    the payload (f32[4,2,8,8]: members x packed fields x slab), 4 x the
    solo bytes behind the solo pair count. Host-only twin of the live
    contract check in tests/test_ensemble.py."""
    ir = _fixture("exchange_ensemble_coalesced.hlo.txt")
    assert len(ir.permutes) == 2
    for op in ir.permutes:
        pay = ir.payload_of(op)
        assert (pay.dtype, pay.dims) == ("f32", (4, 2, 8, 8))
        assert pay.nbytes == 2048 and ir.wire_bytes_of(op) == 16384
        assert attribute_axis(
            _ROUTES, op.attrs["source_target_pairs"]) == "gx"
    assert not ir.all_reduces and not ir.all_gathers and not ir.all_to_alls
    # slab bound at E=4: 4 members x 2 fields x 256-cell blocks
    assert check_contract(ir, CollectiveContract(
        routes=_ROUTES, max_payload_cells=4 * 2 * 256)) == []


def test_parse_comm_every_mixed_fixture():
    """Per-axis cadence: the deep diffusion SUPER-STEP at
    ``comm_every="z:2"`` on a dims=(4,1,2) periodic mesh. One compiled
    super-cycle = 2 physical steps: the x axis exchanges at EVERY
    sub-step (2 events -> 4 permutes of the 1-wide slab) while the z
    axis exchanges ONCE with its 2-wide slab (2 permutes) — the per-axis
    permute counts and k-wide payloads the live contract leg
    (tests/test_comm_avoid.py) pins against `exchange_contract`."""
    ir = _fixture("exchange_comm_every_mixed.hlo.txt")
    assert ir.dialect == "hlo"
    assert len(ir.permutes) == 6
    assert not ir.all_reduces and not ir.all_gathers and not ir.all_to_alls
    # routes of the (4,1,2) mesh in linearized positions (idx = 2x + z)
    x_fwd = frozenset((2 * x + z, 2 * ((x + 1) % 4) + z)
                      for x in range(4) for z in range(2))
    x_bwd = frozenset((2 * x + z, 2 * ((x - 1) % 4) + z)
                      for x in range(4) for z in range(2))
    z_ring = frozenset((2 * x + z, 2 * x + (z + 1) % 2)
                       for x in range(4) for z in range(2))
    routes = {"gx": (x_fwd, x_bwd), "gz": (z_ring, z_ring)}
    axes = measure_axes(ir, routes)
    # x: 2 exchange events x 2 directions, 1-wide slab (8x10 cells,
    # 320 B) over 8 directed links each; z: ONE event, 2-wide slab
    # (9x8x2 cells, 576 B) over 8 directed links each
    assert axes["gx"] == {"permutes": 4, "pairs": 32,
                          "wire_bytes": 4 * 2560, "dtypes": ("f32",)}
    assert axes["gz"] == {"permutes": 2, "pairs": 16,
                          "wire_bytes": 2 * 4608, "dtypes": ("f32",)}
    for op in ir.permutes:
        pay = ir.payload_of(op)
        assert pay.dims in ((1, 8, 10), (9, 8, 2))


def test_parse_guarded_chunk_fixture():
    """The guarded 2-field chunk on the 2x2x2 mesh honors the structural
    guard contract host-only: exactly one f32[4] psum, six permutes, no
    gathers — and the def-use closure walks through the while-loop
    computations the chunk lowers to."""
    ir = _fixture("guarded_chunk.hlo.txt")
    assert ir.module == "jit_chunk"
    assert len(ir.permutes) == 6 and len(ir.all_reduces) == 1
    ar = ir.all_reduces[0]
    pay = ir.payload_of(ar)
    assert (pay.dtype, pay.cells) == ("f32", 4)
    assert check_contract(ir, guard_contract(2)) == []
    # a wrong guard expectation is CAUGHT (3 fields -> f32[6] psum)
    bad = check_contract(ir, guard_contract(3))
    assert {f.rule for f in bad} == {"allreduce-payload"}
    # the psum has producers: the stats vector is computed, not a constant
    assert ir.closure([ar], "up")
    with pytest.raises(InvalidArgumentError):
        ir.closure([ar], "sideways")


def test_parse_all_self_fixture():
    """All-self periodic mesh: the exchange is pure local copies — zero
    collectives of any kind, and the copy/slice/dynamic-update-slice
    machinery is what remains."""
    ir = _fixture("exchange_all_self.hlo.txt")
    assert not ir.collectives()
    inv = ir.inventory()
    assert inv.get("dynamic-update-slice", 0) > 0
    assert check_contract(ir, CollectiveContract(axes={})) == []


def test_parse_bf16_stablehlo_fixture():
    """The LOWERED StableHLO dialect: bf16 wire payloads visible (the CPU
    backend's float-normalization would rewrite them in optimized text),
    converts feeding the wire, partitioner custom-calls recognized as
    benign."""
    ir = _fixture("exchange_bf16_wire.stablehlo.txt")
    assert ir.dialect == "stablehlo"
    assert len(ir.permutes) == 2
    for op in ir.permutes:
        pay = ir.payload_of(op)
        assert (pay.dtype, pay.cells) == ("bf16", 128)
        assert pay.nbytes == 256 and ir.wire_bytes_of(op) == 2048
        assert len(op.attrs["source_target_pairs"]) == 8
    assert ir.count("convert") >= 2
    cfg = LintConfig(state_dtypes=("f32",), wire_dtype="bf16")
    assert run_lints(ir, config=cfg, rules=("wire-downcast-missing",)) == []
    # Sharding/SPMD* partitioner custom-calls never flag as opaque
    assert run_lints(ir, config=cfg, rules=("custom-call",)) == []


def test_shape_helpers_are_dtype_generic():
    assert Shape("bf16", (1, 8, 8)).nbytes == 128
    assert Shape("f64", (4, 4)).nbytes == 128
    assert Shape("pred", (7,)).nbytes == 7
    assert Shape("f32", ()).cells == 1
    assert str(Shape("s32", (2, 3))) == "s32[2,3]"
    assert hlo_dtype("float64") == "f64" and hlo_dtype("bfloat16") == "bf16"
    assert hlo_dtype("bf16") == "bf16"  # HLO spellings pass through


def test_parse_text_rejects_garbage():
    with pytest.raises(InvalidArgumentError):
        parse_text("")
    with pytest.raises(InvalidArgumentError):
        parse_text("this is not a program dump")
    with pytest.raises(InvalidArgumentError):
        parse_program(42)


def test_contract_json_roundtrip():
    c = CollectiveContract(
        axes={"gx": {"permutes": 2, "wire_bytes": 4096,
                     "dtypes": ("f32",)}},
        routes=_ROUTES, allreduces=1, allreduce_payload=("f32", 4),
        max_payload_cells=512, meta={"model": "diffusion3d"})
    back = CollectiveContract.from_json(c.to_json())
    assert back.axes == c.axes
    assert back.routes == c.routes
    assert back.allreduce_payload == ("f32", 4)
    assert back.max_payload_cells == 512
    import json

    assert CollectiveContract.from_json(
        json.dumps(c.to_json())).axes == c.axes
    with pytest.raises(InvalidArgumentError):
        CollectiveContract.from_json({"axes": {"gx": {"permutes": "NaN?"}}})


def test_stablehlo_dotted_custom_call_target():
    """REGRESSION: dotted symbol names (`@xla.sdy.FuncResultSharding`,
    the Shardy partitioner's marker) must parse whole — a truncated
    target ('xla') would miss the benign carve-out and spam every audit
    with spurious opaque-custom-call warnings."""
    text = """module @jit_f attributes {mhlo.num_partitions = 8 : i32} {
  func.func public @main(%arg0: tensor<4x4xf32>) -> tensor<4x4xf32> {
    %0 = stablehlo.custom_call @xla.sdy.FuncResultSharding(%arg0) {backend_config = ""} : (tensor<4x4xf32>) -> tensor<4x4xf32>
    return %0 : tensor<4x4xf32>
  }
}
"""
    ir = parse_text(text)
    (cc,) = ir.find("custom-call")
    assert cc.attrs["custom_call_target"] == "xla.sdy.FuncResultSharding"
    assert run_lints(ir, config=LintConfig(), rules=("custom-call",)) == []


def test_contract_axes_without_routes_rejected():
    """A contract with per-axis expectations but no route table is
    unsatisfiable (no permute can be attributed, every axis would
    falsely report got=0) — a caller error, not a finding."""
    ir = _fixture("exchange_single_axis.hlo.txt")
    bad = CollectiveContract(axes={"gx": {"permutes": 2}})
    with pytest.raises(InvalidArgumentError):
        check_contract(ir, bad)
    # with routes the same expectation verifies cleanly
    ok = CollectiveContract(axes={"gx": {"permutes": 2}}, routes=_ROUTES)
    assert check_contract(ir, ok) == []


def test_findings_sort_most_severe_first():
    from implicitglobalgrid_tpu_torch.analysis.contracts import AuditFinding

    fs = [AuditFinding("b-rule", "info", "i"),
          AuditFinding("a-rule", "warning", "w"),
          AuditFinding("z-rule", "error", "e")]
    assert [f.severity for f in sort_findings(fs)] \
        == ["error", "warning", "info"]


# ---------------------------------------------------------------------------
# lint rules on synthetic programs (host-only)

def _synth(body, params="p0: f32[4,4]", result="f32[4,4]", module_attrs=""):
    return (f"HloModule synthetic{module_attrs}\n\n"
            f"ENTRY %main ({params}) -> {result} {{\n{body}\n}}\n")


def test_lint_global_materialization():
    text = _synth("  %p0 = f32[4,4] parameter(0)\n"
                  "  ROOT %big = f32[16,16] broadcast(f32[4,4] %p0)",
                  result="f32[16,16]")
    cfg = LintConfig(global_shape=(16, 16), local_shape=(4, 4))
    out = run_lints(parse_text(text), config=cfg,
                    rules=("global-materialization",))
    assert [f.rule for f in out] == ["global-materialization"]
    assert out[0].severity == "error"
    # single-shard grids (global == local) never flag
    cfg1 = LintConfig(global_shape=(4, 4), local_shape=(4, 4))
    assert run_lints(parse_text(text), config=cfg1,
                     rules=("global-materialization",)) == []


def test_lint_host_transfer_and_custom_call():
    text = _synth(
        "  %p0 = f32[4,4] parameter(0)\n"
        "  %cb = f32[4,4] custom-call(f32[4,4] %p0), "
        'custom_call_target="xla_python_cpu_callback"\n'
        "  %oq = f32[4,4] custom-call(f32[4,4] %cb), "
        'custom_call_target="my_opaque_kernel"\n'
        "  ROOT %of = token[] outfeed(f32[4,4] %oq)",
        result="token[]")
    ir = parse_text(text)
    host = run_lints(ir, config=LintConfig(), rules=("host-transfer",))
    assert len(host) == 2  # the callback custom-call AND the outfeed
    assert all(f.severity == "error" for f in host)
    opaque = run_lints(ir, config=LintConfig(), rules=("custom-call",))
    assert [f.details["target"] for f in opaque] == ["my_opaque_kernel"]
    assert opaque[0].severity == "warning"


def test_lint_f64_leakage():
    text = _synth("  %p0 = f32[4,4] parameter(0)\n"
                  "  ROOT %c = f64[4,4] convert(f32[4,4] %p0)",
                  result="f64[4,4]")
    ir = parse_text(text)
    out = run_lints(ir, config=LintConfig(state_dtypes=("f32",)),
                    rules=("f64-leakage",))
    assert [f.rule for f in out] == ["f64-leakage"]
    # a legitimately-f64 program never flags
    assert run_lints(ir, config=LintConfig(state_dtypes=("f32", "f64")),
                     rules=("f64-leakage",)) == []


def test_lint_copy_feeds_collective():
    text = _synth(
        "  %p0 = f32[4,4] parameter(0)\n"
        "  %cp = f32[4,4] copy(f32[4,4] %p0)\n"
        "  ROOT %perm = f32[4,4] collective-permute(f32[4,4] %cp), "
        "source_target_pairs={{0,1},{1,0}}")
    out = run_lints(parse_text(text), config=LintConfig(),
                    rules=("copy-feeds-collective",))
    assert [f.rule for f in out] == ["copy-feeds-collective"]
    assert out[0].details["copy"] == "cp"


def test_lint_donation_unaliased():
    text = _synth(
        "  %p0 = f32[4,4] parameter(0)\n"
        "  ROOT %n = f32[4,4] negate(f32[4,4] %p0)",
        module_attrs=", input_output_alias={ {0}: (0, {}, may-alias) }")
    ir = parse_text(text)
    assert run_lints(ir, config=LintConfig(expect_donation=1),
                     rules=("donation-unaliased",)) == []
    out = run_lints(ir, config=LintConfig(expect_donation=2),
                    rules=("donation-unaliased",))
    assert [f.rule for f in out] == ["donation-unaliased"]
    assert out[0].details == {"expected": 2, "aliased": 1}


def test_lint_wire_downcast_partial_regression_flagged():
    """A PARTIAL downcast regression — one axis narrowed to the wire
    dtype, another still full precision — is as real a bandwidth loss as
    a total one and must flag (the first lint cut passed if ANY payload
    carried the wire dtype). Width, not equality: an f16 payload under
    bf16 wire is legal (`wire_dtype_for` never widens)."""
    mixed = _synth(
        "  %p0 = f32[4,4] parameter(0)\n"
        "  %cv = bf16[1,4] convert(f32[1,4] %s0)\n"
        "  %s0 = f32[1,4] slice(f32[4,4] %p0), slice={[0:1], [0:4]}\n"
        "  %cp0 = bf16[1,4] collective-permute(bf16[1,4] %cv), "
        "channel_id=1, source_target_pairs={{0,1},{1,0}}\n"
        "  %s1 = f32[1,4] slice(f32[4,4] %p0), slice={[3:4], [0:4]}\n"
        "  %cp1 = f32[1,4] collective-permute(f32[1,4] %s1), "
        "channel_id=2, source_target_pairs={{0,1},{1,0}}\n"
        "  ROOT %t = (bf16[1,4], f32[1,4]) tuple(bf16[1,4] %cp0, "
        "f32[1,4] %cp1)",
        result="(bf16[1,4], f32[1,4])")
    cfg = LintConfig(state_dtypes=("f32",), wire_dtype="bf16")
    out = run_lints(parse_text(mixed), config=cfg,
                    rules=("wire-downcast-missing",))
    assert [f.rule for f in out] == ["wire-downcast-missing"]
    assert out[0].severity == "error"
    assert out[0].details["stale"] == 1
    assert out[0].details["float_permutes"] == 2
    # an f16 payload under bf16 wire is at the wire width: clean
    f16 = _synth(
        "  %p0 = f16[4,4] parameter(0)\n"
        "  %s0 = f16[1,4] slice(f16[4,4] %p0), slice={[0:1], [0:4]}\n"
        "  ROOT %cp0 = f16[1,4] collective-permute(f16[1,4] %s0), "
        "channel_id=1, source_target_pairs={{0,1},{1,0}}",
        params="p0: f16[4,4]", result="f16[1,4]")
    assert run_lints(parse_text(f16), config=cfg,
                     rules=("wire-downcast-missing",)) == []


def test_lint_wire_downcast_per_axis_policy_asymmetry():
    """REGRESSION: under a PER-AXIS policy a float
    payload at full width on an axis the policy leaves exact is LEGAL —
    the old global `wire_dtype_for` width check flagged it. With
    ``wire_axes``+``routes`` the lint judges each permute against ITS
    axis: an s8 payload on the quantized axis and an f32 payload on the
    exact axis are both clean, while a stale f32 payload on the
    quantized axis still flags (host-only: explicit route table, no
    grid)."""
    routes = {"gx": (frozenset({(0, 1), (1, 0)}),),
              "gz": (frozenset({(0, 2), (2, 0)}),)}
    mixed_ok = _synth(
        "  %p0 = f32[4,4] parameter(0)\n"
        "  %s0 = f32[1,4] slice(f32[4,4] %p0), slice={[0:1], [0:4]}\n"
        "  %cpx = f32[1,4] collective-permute(f32[1,4] %s0), "
        "channel_id=1, source_target_pairs={{0,1},{1,0}}\n"
        "  %q = s8[8] bitcast(f32[1,4] %s0)\n"
        "  %cpz = s8[8] collective-permute(s8[8] %q), "
        "channel_id=2, source_target_pairs={{0,2},{2,0}}\n"
        "  ROOT %t = (f32[1,4], s8[8]) tuple(f32[1,4] %cpx, s8[8] %cpz)",
        result="(f32[1,4], s8[8])")
    cfg = LintConfig(state_dtypes=("f32",), wire_dtype="f32",
                     wire_axes={"gz": "s8"}, routes=routes)
    assert run_lints(parse_text(mixed_ok), config=cfg,
                     rules=("wire-downcast-missing",)) == []
    # stale: the z permute still carries f32 under the z:int8 policy
    stale = _synth(
        "  %p0 = f32[4,4] parameter(0)\n"
        "  %s0 = f32[1,4] slice(f32[4,4] %p0), slice={[0:1], [0:4]}\n"
        "  %cpx = f32[1,4] collective-permute(f32[1,4] %s0), "
        "channel_id=1, source_target_pairs={{0,1},{1,0}}\n"
        "  %s1 = f32[1,4] slice(f32[4,4] %p0), slice={[3:4], [0:4]}\n"
        "  %cpz = f32[1,4] collective-permute(f32[1,4] %s1), "
        "channel_id=2, source_target_pairs={{0,2},{2,0}}\n"
        "  ROOT %t = (f32[1,4], f32[1,4]) tuple(f32[1,4] %cpx, "
        "f32[1,4] %cpz)",
        result="(f32[1,4], f32[1,4])")
    out = run_lints(parse_text(stale), config=cfg,
                    rules=("wire-downcast-missing",))
    assert [f.rule for f in out] == ["wire-downcast-missing"]
    assert out[0].details["stale"] == 1  # only the z permute
    # a MALFORMED policy spec must raise loudly, not silently disable
    # the lint via the legacy-string fallback (which would judge every
    # payload against a width-4 default and flag nothing); the known
    # legacy HLO spellings the policy parser doesn't know still pass
    from implicitglobalgrid_tpu_torch.analysis import default_lint_config

    for bad in ("w:int8", "z:int3", "int3"):
        with pytest.raises(InvalidArgumentError):
            default_lint_config(wire_dtype=bad)
    assert default_lint_config(wire_dtype="f64").wire_dtype == "f64"
    # NO routes (host-only dump audit, or an unattributable permute):
    # a per-axis policy can never soundly flag a full-width payload —
    # it may belong to an exact-by-policy axis — so nothing flags (the
    # old widest-format fallback judged everything against one width)
    cfg_noroutes = LintConfig(state_dtypes=("f32",), wire_dtype="s8",
                              wire_axes={"gz": "s8"}, routes=None)
    assert run_lints(parse_text(stale), config=cfg_noroutes,
                     rules=("wire-downcast-missing",)) == []
    # live-grid path: `default_lint_config` builds wire_axes + routes
    # from a policy spec when a grid is initialized
    import implicitglobalgrid_tpu_torch as tg
    from implicitglobalgrid_tpu_torch.analysis import default_lint_config

    tg.init_global_grid(8, 8, 8, dimx=2, dimy=1, dimz=4, periodx=1,
                        periodz=1, device_type="cpu", quiet=True)
    try:
        live = default_lint_config(state_dtypes=("f32",),
                                   wire_dtype="z:int8,x:f32")
        assert live.wire_axes == {"gx": "f32", "gz": "s8"}
        assert sorted(live.routes) == ["gx", "gz"]
        assert live.wire_dtype == "f32"  # widest fallback, never false-flags
    finally:
        tg.finalize_global_grid()


def test_parse_int8_quant_fixture():
    """Golden quantized single-axis exchange (dims=(8,1,1) periodic,
    ``wire_dtype="int8"``, OPTIMIZED HLO — int8 payloads survive the CPU
    backend, unlike bf16): one permute pair whose payloads are the packed
    s8[68] buffer = 64 slab cells + 4 bitcast scale bytes, 544 B on the
    wire per direction — 4x fewer slab bytes than the f32 fixture's
    s8-equivalent, byte-exact against `quant_slab_bytes` + SCALE_BYTES."""
    from implicitglobalgrid_tpu_torch.ops.precision import (
        SCALE_BYTES, WireFormat, quant_slab_bytes,
    )

    ir = _fixture("exchange_int8_quant.hlo.txt")
    assert ir.dialect == "hlo"
    assert len(ir.permutes) == 2
    assert not ir.all_reduces and not ir.all_gathers
    expect = quant_slab_bytes(8 * 8, WireFormat("int8")) + SCALE_BYTES
    for op in ir.permutes:
        pay = ir.payload_of(op)
        assert pay.dtype == "s8" and pay.cells == expect == 68
        assert ir.wire_bytes_of(op) == expect * 8
        pairs = op.attrs["source_target_pairs"]
        assert frozenset(pairs) in (_RING_P, _RING_M)
    axes = measure_axes(ir, _ROUTES)
    assert axes == {"gx": {"permutes": 2, "pairs": 16,
                           "wire_bytes": 2 * expect * 8,
                           "dtypes": ("s8",)}}
    # vs the exact fixture: 4 bytes/cell -> 1 + scales = 3.76x down
    exact = _fixture("exchange_single_axis.hlo.txt")
    exact_bytes = sum(exact.wire_bytes_of(p) for p in exact.permutes)
    assert exact_bytes / (2 * expect * 8) > 3.5


def test_parse_interior_first_fixture():
    """Golden INTERIOR-FIRST chunk program: the lowered
    StableHLO of the overlapped diffusion step on the 2x2x2 periodic mesh
    (16^3 local blocks, ol=2 -> 12^3 interior). The fixture proves —
    host-only, via `ProgramIR.closure` — the structural claim of the
    interior-first step shape: one ppermute pair per exchanging axis,
    every permute slab-sized, an `optimization_barrier` guarding the
    stitch, and interior-sized compute with NO SSA path to or from any
    collective-permute (what lets the latency-hiding scheduler run the
    interior under the wire)."""
    ir = _fixture("overlap_interior_first.stablehlo.txt")
    assert ir.dialect == "stablehlo"
    permutes = ir.permutes
    assert len(permutes) == 6  # one pair per exchanging axis
    assert not ir.all_reduces and not ir.all_gathers
    for op in permutes:
        assert ir.payload_of(op).cells < 16 ** 3  # slab-sized
    assert ir.find("optimization-barrier")
    tainted = ir.closure(permutes, "up") | ir.closure(permutes, "down") \
        | set(permutes)

    def interior_sized(op):
        return any(s.dtype == "f32" and s.dims == (12, 12, 12)
                   for s in op.shapes)

    interior_ops = {"add", "multiply", "subtract", "divide", "select",
                    "dynamic-update-slice"}
    independent = [op for op in ir.ops
                   if op.op in interior_ops and interior_sized(op)
                   and op not in tainted]
    assert independent, (
        "no interior-sized compute is independent of the permutes — the "
        "interior-first shape degraded to a serialized exchange")


def test_run_lints_unknown_rule_raises():
    ir = _fixture("exchange_all_self.hlo.txt")
    with pytest.raises(InvalidArgumentError):
        run_lints(ir, config=LintConfig(), rules=("no-such-rule",))
    assert set(LINT_RULES) >= {
        "global-materialization", "wire-downcast-missing",
        "donation-unaliased", "host-transfer", "custom-call",
        "f64-leakage", "copy-feeds-collective"}


# ---------------------------------------------------------------------------
# parity with the JAX package's parser, and the recorded dialect

@pytest.mark.parametrize("name", sorted(os.listdir(_DATA)))
def test_parser_matches_jax_parser_on_every_fixture(name):
    """The port's parser reads every golden dump exactly as the JAX
    package's: dialect, module, entry, the op inventory and, collective by
    collective, the kind, payload, pairs, wire bytes and def-use closure."""
    from implicitglobalgrid_tpu.analysis import parse_text as jax_parse

    with open(os.path.join(_DATA, name), encoding="utf-8") as f:
        text = f.read()
    got, ref = parse_text(text), jax_parse(text)
    assert (got.dialect, got.module, got.entry) == (ref.dialect, ref.module, ref.entry)
    assert got.inventory() == ref.inventory()
    assert len(got.parameters()) == len(ref.parameters())

    def summary(ir):
        return [(o.op, o.name, str(ir.payload_of(o)), o.attrs.get("source_target_pairs"),
                 ir.wire_bytes_of(o), len(ir.closure([o], "up"))) for o in ir.collectives()]

    assert summary(got) == summary(ref)
    # a path to the dump parses too
    assert parse_program(os.path.join(_DATA, name)).inventory() == ref.inventory()


def _cpu_grid(**kw):
    import implicitglobalgrid_tpu_torch as tg

    args = dict(dimx=2, dimy=2, dimz=2, periodx=1, periody=1, periodz=1)
    args.update(kw)
    tg.init_global_grid(8, 8, 8, device_type="cpu", quiet=True, **args)
    return tg


def test_recorded_dialect_rules():
    """The lints on the port's recording (``"record"``): a non-contiguous
    field copied dense before its exchange flags ``copy-feeds-collective``,
    a float64 payload in a float32 program ``f64-leakage``, a gather to the
    host ``host-transfer``, a global-shaped result ``global-materialization``;
    ``donation-unaliased`` and ``custom-call`` have no counterpart in eager
    PyTorch and give no finding there."""
    import torch

    from implicitglobalgrid_tpu_torch.analysis import (
        default_lint_config, record_program, recording,
    )

    tg = _cpu_grid()
    try:
        A = torch.zeros(16, 16, 16).transpose(0, 1)
        assert not A.is_contiguous()
        ir = record_program(lambda a: tg.update_halo(a), A).program()
        assert ir.dialect == "record" and len(ir.permutes) == 6
        out = run_lints(ir, config=default_lint_config(state_dtypes=("float32",)))
        assert [f.rule for f in out] == ["copy-feeds-collective"] * 6
        assert {f.details["copy"] for f in out} == {ir.find("copy")[0].name}
        B = torch.zeros(16, 16, 16, dtype=torch.float64)
        ir = record_program(lambda b: tg.update_halo(b), B).program()
        cfg = default_lint_config(state_dtypes=("float32",))
        assert [f.rule for f in run_lints(ir, config=cfg)] == ["f64-leakage"]
        assert run_lints(ir, config=default_lint_config(state_dtypes=("float64",))) == []
        with recording() as rec:
            tg.gather(B)
            rec.all_gather(B, tuple(int(n) for n in tg.global_grid().nxyz_g), site="test")
        ir = rec.program()
        rules = sorted(f.rule for f in run_lints(ir, config=default_lint_config(
            state_dtypes=("float64",))))
        assert rules == ["global-materialization", "host-transfer"]
        none = run_lints(ir, config=LintConfig(expect_donation=3),
                         rules=("donation-unaliased", "custom-call"))
        assert none == []
    finally:
        tg.finalize_global_grid()


def test_recorded_wire_downcast_and_step_divergence():
    """The wire-downcast lint on recordings: a bfloat16 wire reaches every
    recorded payload (clean), the exact wire under a bfloat16 request flags;
    a recording whose steps moved different collectives is a
    ``recorded-steps-differ`` error."""
    import torch

    from implicitglobalgrid_tpu_torch.analysis import (
        audit_program, default_lint_config, record_program,
    )

    tg = _cpu_grid()
    try:
        A, B = torch.zeros(16, 16, 16), torch.zeros(16, 16, 16)
        cfg = default_lint_config(state_dtypes=("float32",), wire_dtype="bfloat16")
        ir = record_program(lambda a, b: tg.update_halo(a, b, wire_dtype="bfloat16"),
                            A, B).program()
        assert {ir.payload_of(p).dtype for p in ir.permutes} == {"bf16"}
        assert run_lints(ir, config=cfg, rules=("wire-downcast-missing",)) == []
        ir = record_program(lambda a, b: tg.update_halo(a, b), A, B).program()
        assert [f.rule for f in run_lints(ir, config=cfg, rules=(
            "wire-downcast-missing",))] == ["wire-downcast-missing"]
        calls = []

        def uneven(a, b):
            calls.append(1)
            return tg.update_halo(a, b) if len(calls) == 1 else (tg.update_halo(a), b)

        rec = record_program(uneven, A, B, steps=2)
        assert rec.steps() == [0, 1]
        rep = audit_program(rec, lints=())
        assert not rep.ok and rep.by_rule() == {"recorded-steps-differ": 1}
        assert rep.collectives["permutes"] == 6  # the first step's
    finally:
        tg.finalize_global_grid()
