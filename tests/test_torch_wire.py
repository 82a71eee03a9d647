"""Port parity of the coalesced multi-field exchange: the wire schema
(`ops/wire.py`), the plain versions of the pack kernel K8 and the
multi-field unpack kernel K7, the coalesced tier of `update_halo`, and
`halo_comm_plan`, against the JAX package.

- `slab_schema`/`schema_for_fields` give JAX's layout and byte count, and
  `unpack(pack(...))` is the identity, on the shapes of `tests/test_wire.py`;
- every block's row of `wire_pack_plain` is, bit for bit, JAX's
  `schema.pack` of that block's slabs (slab and flat layout, f32 and f64);
- multi-field `update_halo` takes JAX's groups and tiers and equals JAX's
  coalesced exchange (its Pallas tiers in interpret mode,
  `_FORCE_PALLAS_WRITE_INTERPRET`) BITWISE on the grids of
  `tests/test_update_halo.py:473-560`, with coalescing on and off;
- `halo_comm_plan` equals JAX's dict on those grids.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import implicitglobalgrid_tpu as igg
import implicitglobalgrid_tpu.ops.halo as jhalo
import implicitglobalgrid_tpu_torch as tg
import implicitglobalgrid_tpu_torch.ops.cuda_halo as ch
from implicitglobalgrid_tpu.ops import wire as jwire
from implicitglobalgrid_tpu_torch.ops import wire as twire
from implicitglobalgrid_tpu_torch.ops.halo import halo_routes
from torch_port_util import clean_torch_grid, init_both, to_np  # noqa: F401


@pytest.fixture
def force_interpret():
    jhalo._FORCE_PALLAS_WRITE_INTERPRET = True
    try:
        yield
    finally:
        jhalo._FORCE_PALLAS_WRITE_INTERPRET = False


SCHEMA_CASES = [
    (0, [(1, 6, 8)] * 4, "slab"),                      # tests/test_wire.py:56-63
    (0, [(1, 6, 8), (1, 7, 8), (1, 6, 9)], "flat"),    # :66-72
    (1, [(5, 2, 8), (5, 2, 8)], "slab"),
    (2, [(5, 6, 1), (6, 6, 1), (5, 7, 1)], "flat"),
    (0, [(1, 6, 8)], "slab"),
]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("dim,shapes,layout", SCHEMA_CASES)
def test_schema_matches_jax(dim, shapes, layout, dtype):
    js = jwire.slab_schema(dim, shapes, dtype)
    ts = twire.slab_schema(dim, shapes, torch.from_numpy(np.zeros(1, dtype)).dtype)
    assert ts.layout == js.layout == layout
    assert ts.payload_bytes == js.payload_bytes
    assert ts.shapes == js.shapes and ts.wire_key == js.wire_key
    rng = np.random.default_rng(dim)
    slabs = [(3 * rng.standard_normal(s)).astype(dtype) for s in shapes]
    jbuf = np.asarray(js.pack([jnp.asarray(s) for s in slabs]))
    tbuf = ts.pack([torch.from_numpy(s) for s in slabs])
    assert tuple(tbuf.shape) == jbuf.shape == ts.buffer_shape
    assert np.array_equal(to_np(tbuf), jbuf)
    for a, b in zip(ts.unpack(tbuf), slabs):
        assert np.array_equal(to_np(a), b)
    # the kernels' addressing: element a of slab k at base_k + a . strides_k
    flat = jbuf.reshape(-1)
    for (base, st), s in zip(ts.slab_offsets(), slabs):
        for a in itertools.product(*(range(n) for n in s.shape)):
            assert flat[base + sum(x * y for x, y in zip(a, st))] == s[a]


def test_schema_for_fields_and_checks():
    fields = [(8, 6, 8), (9, 6, 8)]   # tests/test_wire.py:120-126
    js = jwire.schema_for_fields(0, fields, [1, 1], np.float64)
    ts = twire.schema_for_fields(0, fields, [1, 1], torch.float64)
    assert ts.shapes == js.shapes == ((1, 6, 8), (1, 6, 8))
    assert ts.payload_bytes == js.payload_bytes == 2 * 48 * 8
    q = twire.slab_schema(0, [(1, 4, 4)], torch.float32, fmt="int8")   # quantized: flat
    assert q.layout == "flat" and q.payload_bytes == 16 + 4
    with pytest.raises(tg.exceptions.InvalidArgumentError):
        ts.pack([torch.zeros((1, 6, 8), dtype=torch.float64)])
    with pytest.raises(tg.exceptions.InvalidArgumentError):
        ts.pack([torch.zeros((1, 6, 8))] * 2)   # float32 slabs, float64 schema


def _blocks(counts, loc):
    for c in itertools.product(*(range(k) for k in counts)):
        yield tuple(slice(ci * n, (ci + 1) * n) for ci, n in zip(c, loc))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("dim,locs,layout", [
    (0, [(6, 5, 4), (6, 5, 4), (6, 5, 4)], "slab"),
    (1, [(6, 5, 4), (6, 7, 4)], "slab"),
    (2, [(6, 5, 4), (7, 5, 4), (6, 6, 4)], "flat"),
    (0, [(6, 5, 4), (7, 5, 4), (6, 6, 4), (6, 5, 5)], "flat"),
])
def test_wire_pack_plain_rows_are_jax_pack(dim, locs, layout, dtype):
    """Row b of each buffer is JAX's `schema.pack` of block b's send slabs."""
    counts = (2, 1, 2)
    rng = np.random.default_rng(3)
    fields = [rng.standard_normal(tuple(c * n for c, n in zip(counts, loc))).astype(dtype)
              for loc in locs]
    hws = [1 + (k % 2) for k in range(len(locs))]
    starts_r = [loc[dim] - 2 * h for loc, h in zip(locs, hws)]
    starts_l = [h for h in hws]
    ts = twire.schema_for_fields(dim, locs, hws, torch.from_numpy(fields[0]).dtype)
    js = jwire.schema_for_fields(dim, locs, hws, dtype)
    assert ts.layout == js.layout == layout
    buf_r, buf_l = ch.wire_pack([torch.from_numpy(f) for f in fields], ts,
                                starts_r=starts_r, starts_l=starts_l, blocks=locs)
    for buf, starts in ((buf_r, starts_r), (buf_l, starts_l)):
        assert tuple(buf.shape) == (4, ts.payload_bytes // np.dtype(dtype).itemsize)
        for b, sls in enumerate(zip(*[_blocks(counts, loc) for loc in locs])):
            slabs = [np.take(f[sl], range(st, st + h), axis=dim)
                     for f, sl, st, h in zip(fields, sls, starts, hws)]
            ref = np.asarray(js.pack([jnp.asarray(s) for s in slabs])).reshape(-1)
            assert np.array_equal(to_np(buf[b]), ref), (b, starts)


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("disp", [1, 2])
def test_halo_write_multi_plain_moves(periodic, disp):
    """K7's plain version against a numpy oracle: every block's halos from
    the neighbour blocks' rows, wrapping or keeping PROC_NULL edges."""
    counts, dim = (4, 1, 2), 0
    locs = [(6, 3, 4), (7, 3, 4)]
    rng = np.random.default_rng(4)
    fields = [rng.standard_normal(tuple(c * n for c, n in zip(counts, loc))) for loc in locs]
    ts = twire.schema_for_fields(dim, locs, [1, 2], torch.float64)
    pay = sum(ts.cells)
    br, bl = rng.standard_normal((8, pay)), rng.standard_normal((8, pay))
    tf = [torch.from_numpy(f.copy()) for f in fields]
    ch.halo_write_multi(tf, torch.from_numpy(br), torch.from_numpy(bl), ts, blocks=locs,
                        periodic=periodic, disp=disp)
    coords = list(itertools.product(*(range(k) for k in counts)))
    for k, (f, loc) in enumerate(zip(fields, locs)):
        want = f.copy()
        hw = ts.shapes[k][dim]
        base = sum(ts.cells[:k])
        for b, c in enumerate(coords):
            sl = tuple(slice(ci * n, (ci + 1) * n) for ci, n in zip(c, loc))
            blk = want[sl]
            for side, buf, s in ((0, br, c[0] - disp), (1, bl, c[0] + disp)):
                if periodic:
                    s %= counts[0]
                elif not 0 <= s < counts[0]:
                    continue
                src = coords.index((s,) + c[1:])
                slab = buf[src, base:base + ts.cells[k]].reshape(ts.shapes[k])
                if side == 0:
                    blk[:hw] = slab
                else:
                    blk[loc[0] - hw:] = slab
        assert np.array_equal(to_np(tf[k]), want), k


# ---------------------------------------------------------------------------
# coalesced update_halo against JAX
# ---------------------------------------------------------------------------

def _kw(dims, periods, **extra):
    kw = {f"dim{a}": d for a, d in zip("xyz", dims)}
    kw.update({f"period{a}": q for a, q in zip("xyz", periods)})
    kw.update(extra)
    return kw


def _rand(rng, shape, dtype):
    return (rng.standard_normal(shape) * 10).astype(dtype)


def _case_grids():
    # tests/test_update_halo.py:473-480: three float64 fields
    cases = {}
    for n, dims, periods, kw, label in [
            (6, (2, 2, 2), (1, 1, 1), {}, "all-periodic"),
            (6, (2, 2, 2), (0, 0, 0), {}, "PROC_NULL edges"),
            (6, (1, 2, 2), (1, 0, 1), {}, "x self + y PROC_NULL + z multi"),
            (6, (4, 2, 1), (1, 0, 1), {"disp": 2}, "disp 2"),
            (9, (2, 2, 2), (1, 0, 1), {"overlaps": (4, 4, 4), "halowidths": (2, 2, 2)},
             "halowidth 2")]:
        cases[label] = ((n, n, n), _kw(dims, periods, **kw),
                        [((n, n, n), np.float64, None)] * 3)
    # :498-510: 3 f32 + 2 f64 + 1 int32
    cases["mixed dtypes"] = ((6, 6, 6), _kw((2, 2, 2), (1, 0, 0)),
                             [((6, 6, 6), dt, None) for dt in [np.float32] * 3
                              + [np.float64] * 2 + [np.int32]])
    # :512-530: per-field halowidths and a staggered field
    cases["stagger + per-field hw"] = ((9, 9, 9), _kw((2, 2, 2), (1, 1, 0),
                                                      overlaps=(4, 4, 4)),
                                       [((9, 9, 9), np.float64, None),
                                        ((9, 9, 9), np.float64, (1, 1, 1)),
                                        ((10, 9, 9), np.float64, None)])
    # :533-544: 2-D
    cases["2-D"] = ((6, 6, 1), _kw((4, 2, 1), (1, 1, 0)),
                    [((6, 6), np.float64, None)] * 2)
    # :547-560: 3 + 1 staggered float32 at that test's size
    cases["3+1 staggered f32"] = ((16, 16, 128), _kw((2, 2, 2), (1, 1, 1)),
                                  [((16, 16, 128), np.float32, None)] * 3
                                  + [((17, 16, 128), np.float32, None)])
    return cases


CASES = _case_grids()


def _jax_routes(locs, dtypes, hws, coalesce):
    """JAX's groups by dim and per-field tier, from its own gates."""
    gg, order = igg.global_grid(), jhalo.DEFAULT_DIMS_ORDER
    handled = [jhalo._self_exchange_plan(gg, s, h, order) is not None
               for s, h in zip(locs, hws)]
    sigs = [jhalo._SigField(s, d) for s, d in zip(locs, dtypes)]
    groups = jhalo._coalesce_groups(gg, sigs, hws, handled, order, coalesce=coalesce)
    grouped = {i for gs in groups.values() for g in gs for i in g}
    tiers = ["self" if handled[i] else "coalesced" if i in grouped else
             "combined" if jhalo._combined_plan(gg, s, hws[i], order) is not None
             else "per_dim" for i, s in enumerate(locs)]
    return tiers, groups


def _setup(label, seed=7):
    n, kw, specs = CASES[label]
    init_both(*n, **kw)
    gg = igg.global_grid()
    rng = np.random.default_rng(seed)
    arrays, fields_j, fields_t, hws = [], [], [], []
    for loc, dt, hw in specs:
        stacked = tuple(int(gg.dims[d]) * s for d, s in enumerate(loc))
        a = _rand(rng, stacked, dt)
        arrays.append(a)
        hw_full = tuple(int(h) for h in (hw or gg.halowidths))
        hws.append(hw_full)
        if hw is None:
            fields_j.append(igg.device_put_g(a))
            fields_t.append(tg.device_put_g(a))
        else:
            fields_j.append(igg.Field(igg.device_put_g(a), hw))
            fields_t.append(tg.Field(tg.device_put_g(a), hw))
    return specs, arrays, fields_j, fields_t, hws


def _spy_coalesced(monkeypatch):
    calls = []
    fn = ch.wire_pack

    def spy(fields, schema, **kw):
        calls.append((schema.dim, len(fields)))
        return fn(fields, schema, **kw)

    monkeypatch.setattr(ch, "wire_pack", spy)
    return calls


@pytest.mark.parametrize("coalesce", [True, False])
@pytest.mark.parametrize("label", list(CASES))
def test_update_halo_coalesced_matches_jax(label, coalesce, force_interpret, monkeypatch):
    specs, arrays, fj, ft, hws = _setup(label)
    locs = [s for s, _, _ in specs]
    dtypes = [d for _, d, _ in specs]
    pg = tg.global_grid()
    tiers, groups = halo_routes(pg, locs, dtypes, hws, coalesce=coalesce)
    jtiers, jgroups = _jax_routes(locs, dtypes, hws, coalesce)
    assert groups == jgroups and tiers == jtiers, (groups, jgroups, tiers, jtiers)
    if coalesce and label != "x self + y PROC_NULL + z multi":
        assert "coalesced" in tiers  # the multi-rank dims pack
    calls = _spy_coalesced(monkeypatch)
    ref = [np.asarray(x) for x in igg.update_halo(*fj, coalesce=coalesce)]
    got = [to_np(x) for x in tg.update_halo(*ft, coalesce=coalesce)]
    assert sorted(calls) == sorted((d, len(g)) for d, gs in groups.items() for g in gs)
    for k, (g, r, a) in enumerate(zip(got, ref, arrays)):
        assert g.dtype == r.dtype and np.array_equal(g, r), (label, k)
    assert any(not np.array_equal(g, a) for g, a in zip(got, arrays))


def test_coalesce_env_off_gives_per_field_routes(force_interpret, monkeypatch):
    specs, arrays, fj, ft, hws = _setup("all-periodic")
    locs = [s for s, _, _ in specs]
    dtypes = [d for _, d, _ in specs]
    ref = [to_np(x) for x in tg.update_halo(*[tg.device_put_g(a) for a in arrays])]
    monkeypatch.setenv("IGG_HALO_COALESCE", "0")
    tiers, groups = halo_routes(tg.global_grid(), locs, dtypes, hws)
    assert groups == {} and tiers == ["combined"] * 3
    calls = _spy_coalesced(monkeypatch)
    got = [to_np(x) for x in tg.update_halo(*ft)]
    assert not calls
    for g, r in zip(got, ref):
        assert np.array_equal(g, r)
    monkeypatch.setenv("IGG_HALO_COALESCE", "x")
    with pytest.raises(tg.exceptions.InvalidArgumentError):
        tg.update_halo(*ft)


def test_local_update_halo_coalesces(force_interpret, monkeypatch):
    """The step-side form takes the same groups (the acoustic model's
    velocity exchange)."""
    specs, arrays, fj, ft, hws = _setup("3+1 staggered f32")
    calls = _spy_coalesced(monkeypatch)
    got = tg.local_update_halo(*[tg.device_put_g(a) for a in arrays])
    ref = igg.update_halo(*fj)
    assert sorted(calls) == [(0, 4), (1, 4), (2, 4)]
    for g, r in zip(got, ref):
        assert np.array_equal(to_np(g), np.asarray(r))


# ---------------------------------------------------------------------------
# halo_comm_plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("coalesce", [True, False])
@pytest.mark.parametrize("label", list(CASES))
def test_halo_comm_plan_matches_jax(label, coalesce):
    specs, arrays, fj, ft, hws = _setup(label)
    ref = igg.halo_comm_plan(*fj, coalesce=coalesce)
    got = tg.halo_comm_plan(*ft, coalesce=coalesce)
    assert got == ref, (got, ref)


def test_halo_comm_plan_refuses_what_is_not_ported():
    tg.init_global_grid(6, 6, 6, dimx=2, dimy=2, dimz=2, nranks=8, device_type="cpu",
                        quiet=True)
    A = tg.zeros_g()
    with pytest.raises(tg.exceptions.InvalidArgumentError):   # the ensemble axis: E >= 1
        tg.halo_comm_plan(A, ensemble=0)
    for kw in (dict(wire_dtype="bfloat16"), dict(wire_stage="z:staged"),
               dict(ensemble=2)):   # ported
        assert tg.halo_comm_plan(A, **kw)["fields"] == 1
    plan = tg.halo_comm_plan(A, tg.zeros_g(), jax.ShapeDtypeStruct((12, 12, 12), np.float32))
    assert plan["fields"] == 3 and plan["axes"]["gx"]["ppermutes"] == 2
