"""Port parity of the halo wire formats on `update_halo`, `local_update_halo`
and `halo_comm_plan` (`ops/halo.py`, `ops/wire.py`, `ops/precision.py`).

- `update_halo` under ``bfloat16``, ``float16``, ``int8``, ``int4`` and the
  per-axis ``"z:int8,x:float32"`` equals JAX's `update_halo` under the same
  wire BITWISE, on grids with periodic and PROC_NULL dims, a self-neighbour
  dim, odd overlaps, halowidth 2, ``disp=2``, 1-D and 2-D fields, a
  staggered group, and the ``Field``/tuple/dict forms; the argument and
  ``IGG_HALO_WIRE_DTYPE`` give the same halos; the wired halos differ from
  the exact ones;
- the routes are JAX's: a quantized field takes the coalesced route (K8 +
  K7), a single one too; a field the wire touches skips the combined tier;
  float16 state with a bfloat16 wire, int64, bool and complex64 fields
  travel exact;
- a slab holding a NaN arrives wholly NaN under int8 and int4;
- ``wire_stage`` (argument and ``IGG_HALO_WIRE_STAGE``) gives the flat
  route's halos bitwise, with every exchanging field on the coalesced route;
- `halo_comm_plan` equals JAX's dict for every format, per-axis spec and
  ``"staged"``.
"""

import itertools

import numpy as np
import pytest
import torch

import implicitglobalgrid_tpu as igg
import implicitglobalgrid_tpu.ops.halo as jhalo
import implicitglobalgrid_tpu_torch as tg
import implicitglobalgrid_tpu_torch.ops.cuda_halo as ch
import implicitglobalgrid_tpu_torch.ops.halo as thalo
from implicitglobalgrid_tpu.ops.precision import resolve_wire_dtype as j_resolve
from implicitglobalgrid_tpu.ops.wire import resolve_wire_stage as j_stage
from implicitglobalgrid_tpu_torch.ops.precision import resolve_wire_dtype as t_resolve
from torch_port_util import clean_torch_grid, init_both, to_np  # noqa: F401

FORMATS = ["bfloat16", "float16", "int8", "int4", "z:int8,x:float32"]


def _kw(dims, periods, **extra):
    kw = {f"dim{a}": d for a, d in zip("xyz", dims)}
    kw.update({f"period{a}": q for a, q in zip("xyz", periods)})
    kw.update(extra)
    return kw


# label -> (nxyz, grid kwargs, [(local shape, dtype, per-field halowidths or None)])
GRIDS = {
    "periodic 2x2x2, three f32": (
        (6, 6, 6), _kw((2, 2, 2), (1, 1, 1)), [((6, 6, 6), np.float32, None)] * 3),
    "PROC_NULL 2x2x2, f64 + f32": (
        (6, 6, 6), _kw((2, 2, 2), (0, 0, 0)),
        [((6, 6, 6), np.float64, None), ((6, 6, 6), np.float32, None)]),
    "x self, y PROC_NULL, z multi": (
        (6, 6, 6), _kw((1, 2, 2), (1, 0, 1)), [((6, 6, 6), np.float32, None)] * 2),
    "odd overlaps 3": (
        (7, 7, 7), _kw((2, 2, 2), (1, 0, 1), overlaps=(3, 3, 3)),
        [((7, 7, 7), np.float64, None)]),
    "halowidth 2": (
        (9, 9, 9), _kw((2, 2, 2), (1, 0, 1), overlaps=(4, 4, 4), halowidths=(2, 2, 2)),
        [((9, 9, 9), np.float32, None)] * 2),
    "disp 2": (
        (6, 6, 6), _kw((4, 2, 1), (1, 0, 1), disp=2), [((6, 6, 6), np.float64, None)] * 2),
    "staggered group + per-field hw": (
        (9, 9, 9), _kw((2, 2, 2), (1, 1, 0), overlaps=(4, 4, 4)),
        [((9, 9, 9), np.float32, None), ((10, 9, 9), np.float32, None),
         ((9, 10, 9), np.float32, (1, 1, 1)), ((9, 9, 10), np.float32, None)]),
    "2-D": ((6, 6, 1), _kw((4, 2, 1), (1, 0, 0)), [((6, 6), np.float32, None)] * 2),
    "1-D": ((8, 1, 1), _kw((8, 1, 1), (1, 0, 0)), [((8,), np.float64, None)]),
    "f16 state, ints, bool, complex": (
        (6, 6, 6), _kw((2, 2, 2), (1, 0, 1)),
        [((6, 6, 6), np.float16, None), ((6, 6, 6), np.int64, None),
         ((6, 6, 6), np.bool_, None), ((6, 6, 6), np.complex64, None),
         ((6, 6, 6), np.float32, None)]),
}


def _rand(rng, shape, dtype):
    if dtype == np.bool_:
        return rng.random(shape) > 0.5
    if np.issubdtype(dtype, np.integer):
        return rng.integers(-1000, 1000, shape).astype(dtype)
    a = rng.standard_normal(shape) * 10
    if np.issubdtype(dtype, np.complexfloating):
        a = a + 1j * rng.standard_normal(shape)
    return a.astype(dtype)


def _setup(label, seed=11):
    n, kw, specs = GRIDS[label]
    init_both(*n, nranks=int(np.prod([kw.get(f"dim{a}", 1) for a in "xyz"])), **kw)
    gg = igg.global_grid()
    rng = np.random.default_rng(seed)
    arrays, hws = [], []
    for loc, dt, hw in specs:
        stacked = tuple(int(gg.dims[d]) * s for d, s in enumerate(loc))
        arrays.append(_rand(rng, stacked, dt))
        hws.append(tuple(int(h) for h in (hw or gg.halowidths)))
    return specs, arrays, hws


def _fields(mod, specs, arrays, form="array"):
    out = []
    for (_, _, hw), a in zip(specs, arrays):
        A = mod.device_put_g(a)
        if hw is not None:
            out.append(mod.Field(A, hw))
        elif form == "tuple":
            out.append((A, tuple(int(h) for h in mod.global_grid().halowidths)))
        else:
            out.append(A)
    return out


def _same(got, ref):
    g, r = to_np(got), np.asarray(ref)
    if r.dtype.name == "bfloat16":
        r = r.astype(np.float32)
    assert g.dtype == r.dtype, (g.dtype, r.dtype)
    return np.array_equal(g, r, equal_nan=np.issubdtype(r.dtype, np.inexact))


def _jax_tiers(locs, dtypes, hws, wire, stage=None):
    """JAX's per-field tier under a wire policy, from its own gates (its
    kernel tiers switched on as on a TPU grid)."""
    gg, order = igg.global_grid(), jhalo.DEFAULT_DIMS_ORDER
    prev, jhalo._FORCE_PALLAS_WRITE_INTERPRET = jhalo._FORCE_PALLAS_WRITE_INTERPRET, True
    try:
        return _jax_tiers_on(gg, order, locs, dtypes, hws, wire, stage)
    finally:
        jhalo._FORCE_PALLAS_WRITE_INTERPRET = prev


def _jax_tiers_on(gg, order, locs, dtypes, hws, wire, stage):
    handled = [jhalo._self_exchange_plan(gg, s, h, order) is not None
               for s, h in zip(locs, hws)]
    staged = jhalo._staged_layouts(gg, stage)
    sigs = [jhalo._SigField(s, d) for s, d in zip(locs, dtypes)]
    groups = jhalo._coalesce_groups(gg, sigs, hws, handled, order, coalesce=True, wire=wire,
                                    staged_dims=frozenset(staged))
    grouped = {i for gs in groups.values() for g in gs for i in g}

    def touched(f, hw):
        return any(jhalo._dim_exchanges(gg, f.shape, hw, d) and (
            d in staged or (jhalo.wire_format_for(f.dtype, wire, d) is not None
                            and jhalo._dim_meta(gg, d)[0] > 1)) for d in order)

    tiers = ["self" if handled[i] else "coalesced" if i in grouped else
             "combined" if not touched(sigs[i], hws[i])
             and jhalo._combined_plan(gg, s, hws[i], order) is not None
             else "per_dim" for i, s in enumerate(locs)]
    return tiers, groups


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("label", list(GRIDS))
def test_update_halo_wire_matches_jax(label, fmt, monkeypatch):
    specs, arrays, hws = _setup(label)
    locs = [s for s, _, _ in specs]
    dtypes = [d for _, d, _ in specs]
    tiers, groups = thalo.halo_routes(tg.global_grid(), locs, dtypes, hws, wire_dtype=fmt)
    assert (tiers, groups) == _jax_tiers(locs, dtypes, hws, j_resolve(fmt))
    form = "tuple" if "disp" in label else "array"
    ref = igg.update_halo(*_fields(igg, specs, arrays, form), wire_dtype=fmt)
    exact = tg.update_halo(*_fields(tg, specs, arrays, form), wire_dtype="off")
    got = tg.update_halo(*_fields(tg, specs, arrays, form), wire_dtype=fmt)
    ref, got, exact = (x if isinstance(x, tuple) else (x,) for x in (ref, got, exact))
    for k, (g, r) in enumerate(zip(got, ref)):
        assert _same(g, r), (label, fmt, k)
    narrowed = [k for k, (_, dt, _) in enumerate(specs)
                if any(thalo.wire_format_for(dt, t_resolve(fmt), d) is not None
                       and int(tg.global_grid().dims[d]) > 1 for d in range(len(locs[k])))]
    for k in range(len(specs)):
        if k in narrowed:
            assert not torch.equal(got[k], exact[k]), (label, fmt, k)
        else:
            assert torch.equal(got[k], exact[k]), (label, fmt, k)
    # the environment variable gives the same halos; an explicit "off" wins
    monkeypatch.setenv("IGG_HALO_WIRE_DTYPE", fmt)
    env = tg.local_update_halo(*_fields(tg, specs, arrays))
    env = env if isinstance(env, tuple) else (env,)
    assert all(torch.equal(a, b) for a, b in zip(env, got))
    off = tg.update_halo(*_fields(tg, specs, arrays), wire_dtype="off")
    off = off if isinstance(off, tuple) else (off,)
    assert all(torch.equal(a, b) for a, b in zip(off, exact))


@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_quantized_single_field_takes_the_coalesced_route(fmt, monkeypatch):
    """A lone quantized field rides K8 + K7 on every multi-rank dim (its
    scales live in the flat payload), a dict of fields too; a cast keeps
    the per-field routes."""
    specs, arrays, hws = _setup("PROC_NULL 2x2x2, f64 + f32")
    calls = []
    pack = ch.wire_pack

    def spy(fields, schema, **kw):
        calls.append((schema.dim, len(fields), schema.layout))
        return pack(fields, schema, **kw)

    monkeypatch.setattr(ch, "wire_pack", spy)
    a = tg.device_put_g(arrays[1])
    got = tg.update_halo(a, wire_dtype=fmt)
    assert sorted(calls) == [(0, 1, "flat"), (1, 1, "flat"), (2, 1, "flat")]
    assert _same(got, igg.update_halo(igg.device_put_g(arrays[1]), wire_dtype=fmt))
    calls.clear()
    d = tg.update_halo({"a": tg.device_put_g(arrays[1]), "b": tg.device_put_g(arrays[1])},
                       wire_dtype=fmt)
    assert sorted(calls) == [(0, 2, "flat"), (1, 2, "flat"), (2, 2, "flat")]
    assert all(torch.equal(x, got) for x in d)
    calls.clear()
    tg.update_halo(tg.device_put_g(arrays[1]), wire_dtype="bfloat16")
    assert not calls


@pytest.mark.parametrize("fmt", ["int8", "int4"])
@pytest.mark.parametrize("route", ["coalesced", "per_dim"])
def test_nan_slab_arrives_wholly_nan(fmt, route):
    """A NaN poisons the scale of the one slab it sits in: that block's
    received halo is all NaN, every other halo finite."""
    init_both(6, 6, 6, nranks=8, **_kw((2, 2, 2), (1, 1, 1)))
    rng = np.random.default_rng(2)
    a = rng.standard_normal((12, 12, 12)).astype(np.float32)
    a[4, 2:4, 3] = np.nan          # block (0, 0, 0), inside the right x send slab
    fs = [tg.device_put_g(a)] + ([tg.device_put_g(a)] if route == "coalesced" else [])
    wire = fmt if route == "coalesced" else {"x": "float16"}
    out = tg.update_halo(*fs, dims=(0,), wire_dtype=wire)
    out = out[0] if isinstance(out, tuple) else out
    o = to_np(out)
    if route == "coalesced":
        assert np.isnan(o[6, 0:6, 0:6]).all()      # block (1,0,0)'s left halo
        mask = np.ones_like(o, dtype=bool)
        mask[6, 0:6, 0:6] = False
        mask[4, 2:4, 3] = False
        assert np.isfinite(o[mask]).all()
    else:                                           # a cast moves the NaN alone
        assert np.isnan(o[6, 2:4, 3]).all() and np.isfinite(o[6, 0:2]).all()
    ref = igg.update_halo(*[igg.device_put_g(a) for _ in fs], dims=(0,), wire_dtype=wire)
    ref = ref[0] if isinstance(ref, tuple) else ref
    assert np.array_equal(o, np.asarray(ref), equal_nan=True)


@pytest.mark.parametrize("stage", ["z:staged", "staged"])
def test_staged_wire_is_the_flat_wire(stage, monkeypatch):
    """Staging moves the flat route's halos bitwise: every exchanging field
    of a staged dim takes the coalesced route; undeclared granules (no
    `IGG_TPU_DCN_GRANULES`) stage nothing."""
    monkeypatch.setenv("IGG_TPU_DCN_GRANULES", "z:2")
    specs, arrays, hws = _setup("periodic 2x2x2, three f32")
    assert tuple(tg.global_grid().dcn_granules) == tuple(igg.global_grid().dcn_granules)
    flat = tg.update_halo(*_fields(tg, specs, arrays), wire_dtype="int8")
    tiers, groups = thalo.halo_routes(tg.global_grid(), [specs[0][0]], [np.float32],
                                      [hws[0]], wire_stage=stage)
    assert tiers == ["coalesced"] and list(groups) == [2]
    assert (tiers, groups) == _jax_tiers([specs[0][0]], [np.float32], [hws[0]], None,
                                         j_stage(stage))
    got = tg.update_halo(*_fields(tg, specs, arrays), wire_dtype="int8", wire_stage=stage)
    assert all(torch.equal(a, b) for a, b in zip(got, flat))
    monkeypatch.setenv("IGG_HALO_WIRE_STAGE", stage)
    one = tg.update_halo(tg.device_put_g(arrays[0]))
    assert torch.equal(one, tg.update_halo(tg.device_put_g(arrays[0]), wire_stage="off"))


PLAN_WIRES = FORMATS + [None, "float32", "gz:int4", {"y": "bf16"}]


@pytest.mark.parametrize("stage", [None, "staged", "z:staged"])
@pytest.mark.parametrize("wire", PLAN_WIRES, ids=str)
@pytest.mark.parametrize("label", ["periodic 2x2x2, three f32", "PROC_NULL 2x2x2, f64 + f32",
                                   "staggered group + per-field hw",
                                   "f16 state, ints, bool, complex", "2-D"])
def test_halo_comm_plan_wire_matches_jax(label, wire, stage, monkeypatch):
    # granules that divide the axis: z on the 2x2x2 grids, x on the 2-D 4x2
    monkeypatch.setenv("IGG_TPU_DCN_GRANULES", "x:2" if label == "2-D" else "z:2")
    specs, arrays, hws = _setup(label)
    for coalesce in (True, False):
        ref = igg.halo_comm_plan(*_fields(igg, specs, arrays), coalesce=coalesce,
                                 wire_dtype=wire, wire_stage=stage)
        got = tg.halo_comm_plan(*_fields(tg, specs, arrays), coalesce=coalesce,
                                wire_dtype=wire, wire_stage=stage)
        assert got == ref, (got, ref)


def test_wire_spellings_refused_as_jax_refuses():
    init_both(6, 6, 6, nranks=8, **_kw((2, 2, 2), (1, 1, 1)))
    A = tg.zeros_g()
    for bad in ("int3", "z:int3", "w:int8", "z:int8,gz:int4", "z:int8,f32"):
        with pytest.raises(tg.exceptions.InvalidArgumentError):
            tg.update_halo(A, wire_dtype=bad)
    for bad in ("sideways", "w:staged"):
        with pytest.raises(tg.exceptions.InvalidArgumentError):
            tg.update_halo(A, wire_stage=bad)
    for d, dt in itertools.product((0, 1, 2), (torch.int32, torch.bool)):
        assert thalo.wire_format_for(dt, "int8", d) is None
