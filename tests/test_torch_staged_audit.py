"""The staged wire through the port's audit (`analysis.audit_model(wire_stage=)`),
beside `tests/test_wire_stage.py`'s compiled audit legs.

- on the JAX fixture mesh (4x1x2 x 8^3, ``IGG_TPU_DCN_GRANULES=z:2``)
  ``audit_model("diffusion3d", wire_stage="z:staged")`` is ok with the
  canonical stage in its meta and crosscheck, and a flat audit of the same
  grid right after is ok too (no staging leaks);
- the recording holds the flat exchange: its per-axis permutes and bytes
  equal the flat audit's and JAX's flat compiled program's, and JAX's
  staged program carries more permutes (its gather and scatter stages),
  which the port does not run;
- the crosscheck prices the staged wire (`predict_step(wire_stage=)`'s
  staged record, equal to JAX's) and holds the recording to the flat plan;
- every spelling audits under JAX's canonical string, and
  ``IGG_HALO_WIRE_STAGE`` is restored after.
"""

import os

import pytest

import implicitglobalgrid_tpu as igg
import implicitglobalgrid_tpu_torch as tg
from implicitglobalgrid_tpu.ops.wire import resolve_wire_stage as j_stage
from torch_port_util import clean_torch_grid  # noqa: F401

FIXTURE = dict(dimx=4, dimy=1, dimz=2, periodx=1, periody=1, periodz=1)


@pytest.fixture
def fixture_mesh(monkeypatch):
    """`tests/test_wire_stage.py`'s mesh: 4x1x2 x 8^3, z split into 2 granules."""
    monkeypatch.setenv("IGG_TPU_DCN_GRANULES", "z:2")
    monkeypatch.delenv("IGG_HALO_WIRE_STAGE", raising=False)
    tg.init_global_grid(8, 8, 8, device_type="cpu", quiet=True, **FIXTURE)
    assert tuple(tg.global_grid().dcn_granules) == (1, 1, 2)


@pytest.mark.audit
@pytest.mark.parametrize("impl", ["plain", "cuda"])
def test_audit_model_staged_ok(fixture_mesh, impl):
    rep = tg.audit_model("diffusion3d", impl=impl, wire_stage="z:staged")
    assert rep.ok, [f.to_json() for f in rep.findings]
    assert rep.crosscheck["ok"] and rep.crosscheck["wire_stage"] == "z:staged"
    assert rep.meta["wire_stage"] == "z:staged" and "by process" in rep.meta["staging"]
    assert "staged_messages" not in rep.meta  # one process: no transport to count
    assert os.environ.get("IGG_HALO_WIRE_STAGE") is None
    flat = tg.audit_model("diffusion3d", impl=impl)
    assert flat.ok, [f.to_json() for f in flat.findings]
    assert "wire_stage" not in flat.meta and flat.crosscheck["wire_stage"] is None


@pytest.mark.audit
def test_staged_recording_is_the_flat_exchange(fixture_mesh):
    """The staged step moves what the flat step moves (two permutes a dim,
    the same bytes) and what JAX's flat program moves; JAX's staged
    program has more permutes: the gather and scatter stages the port's
    process-granule staging does without."""
    from implicitglobalgrid_tpu.analysis import audit_model as j_audit

    staged = tg.audit_model("diffusion3d", wire_stage="z:staged").collectives
    flat = tg.audit_model("diffusion3d").collectives
    assert staged == flat
    assert staged["by_axis"]["gz"]["permutes"] == 2
    igg.init_global_grid(8, 8, 8, quiet=True, **FIXTURE)
    j_flat = j_audit("diffusion3d").collectives
    j_staged = j_audit("diffusion3d", wire_stage="z:staged").collectives
    for axis, rec in staged["by_axis"].items():
        assert (rec["permutes"], rec["wire_bytes"]) == (
            j_flat["by_axis"][axis]["permutes"], j_flat["by_axis"][axis]["wire_bytes"]), axis
    assert j_staged["permutes"] > staged["permutes"]


@pytest.mark.audit
def test_crosscheck_prices_the_staged_wire_as_jax(fixture_mesh):
    """The crosscheck's oracle prices the staged wire as JAX's does (the
    staged record of `predict_step`, equal to JAX's), while each axis's
    modeled pairs and bytes are the flat plan's, which the recording
    matches."""
    from implicitglobalgrid_tpu.models import init_diffusion3d as j_init

    rep = tg.audit_model("diffusion3d", wire_stage="z:staged")
    T, Cp, _ = tg.models.init_diffusion3d()
    rec = tg.predict_step("diffusion3d", (T, Cp), wire_stage="z:staged")
    igg.init_global_grid(8, 8, 8, quiet=True, **FIXTURE)
    jT, jCp, _ = j_init()
    jrec = igg.predict_step("diffusion3d", (jT, jCp), wire_stage="z:staged")
    assert rec["comm"]["gz"]["staged"].keys() == jrec["comm"]["gz"]["staged"].keys()
    assert rec["comm"]["gz"]["ppermute_pairs"] == jrec["comm"]["gz"]["ppermute_pairs"]
    assert rec["comm"]["gz"]["ppermute_pairs"] > 1  # the oracle books the stages
    for axis, row in rep.crosscheck["axes"].items():
        assert row["modeled_pairs"] == row["parsed_pairs"] == 1.0, axis
        assert row["modeled_wire_bytes"] == row["parsed_wire_bytes"] > 0, axis


@pytest.mark.audit
@pytest.mark.parametrize("spec", ["z:staged", "staged", "gz:staged", {"z": "staged"},
                                  "x:staged,z:staged", "off"], ids=str)
def test_stage_spellings_audit_under_jax_canonical(fixture_mesh, spec, monkeypatch):
    monkeypatch.setenv("IGG_HALO_WIRE_STAGE", "x:flat")
    rep = tg.audit_model("diffusion3d", wire_stage=spec)
    want = j_stage(spec)
    assert rep.ok, [f.to_json() for f in rep.findings]
    assert rep.meta["wire_stage"] == ("off" if want is None else str(want))
    assert rep.crosscheck["wire_stage"] == (None if want is None else str(want))
    assert os.environ["IGG_HALO_WIRE_STAGE"] == "x:flat"  # restored


@pytest.mark.audit
def test_staged_audit_composes_with_a_wire_format(fixture_mesh):
    """Staged with ``wire_dtype="z:int8"`` (the composition JAX's slow test
    audits): ok, the quantized payload on the staged axis."""
    rep = tg.audit_model("diffusion3d", wire_stage="z:staged", wire_dtype="z:int8")
    assert rep.ok, [f.to_json() for f in rep.findings]
    assert rep.crosscheck["ok"] and rep.collectives["by_axis"]["gz"]["dtypes"] != \
        rep.collectives["by_axis"]["gx"]["dtypes"]
