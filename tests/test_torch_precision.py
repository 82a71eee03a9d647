"""Port parity of the halo wire precision and stochastic-rounding storage
(`ops/precision.py`, `ops/wire.py`, `parallel/topology.py`,
`models/diffusion.py`), the twin of `tests/test_precision.py`,
`tests/test_wire.py`, `tests/test_wire_stage.py` and the fast case of
`tests/test_quant_accuracy.py`:

- the wire-format and staging spellings, their errors and string round
  trips, and the narrowing rules, as the JAX package resolves them;
- the codec bitwise against the JAX package's on the same numpy inputs
  (random slabs, constant, all-zero, NaN/Inf-poisoned and beyond-float32
  slabs, int4 against int8, the nibble packing, the scale tail). The
  dequantization is held against the JAX package's codec as its exchanges
  run it (compiled: XLA folds ``(q / L) * scale`` into ``q * (scale * (1 /
  L))``);
- the cast and quantized `WireSchema` pack/unpack against JAX's;
- `staged_wire_layout` equal to JAX's layout objects; undeclared granules
  stage nothing; the staged plan's counts; the staged exchange bitwise the
  flat one on the JAX test's fixture mesh;
- `stochastic_round_bf16` bitwise JAX's given the same 16-bit draws; its
  unbiasedness, exact values, signs and non-finite pass-through with the
  port's counter-based bits (`sr_bits`), which do not depend on how the
  mesh is split;
- the sr runner: plain bfloat16 stagnates, sr tracks float32 (the bounds
  of `tests/test_precision.py`), one seed reproduces bitwise and another
  differs, and the runner errors are the JAX package's;
- the int8 wire's drift against the exact wire within the documented
  0.02 (`quant` marker).
"""

import numpy as np
import pytest
import torch

import implicitglobalgrid_tpu as igg
import implicitglobalgrid_tpu_torch as tg
from implicitglobalgrid_tpu.ops import precision as jp
from implicitglobalgrid_tpu.ops import wire as jw
from implicitglobalgrid_tpu.parallel.topology import staged_wire_layout as j_layout
from implicitglobalgrid_tpu_torch.models import (
    init_diffusion3d, make_run, make_run_sr, run_diffusion,
)
from implicitglobalgrid_tpu_torch.ops import precision as tp
from implicitglobalgrid_tpu_torch.ops import wire as tw
from implicitglobalgrid_tpu_torch.parallel.topology import staged_wire_layout as t_layout
from torch_port_util import clean_torch_grid, init_both, to_np  # noqa: F401

quant = pytest.mark.quant
IA = tg.exceptions.InvalidArgumentError


def _jax():
    import jax
    import jax.numpy as jnp

    return jax, jnp


_DEQUANT: dict = {}


def _j_dequant(q, s, n, fmt, od):
    """The JAX package's dequantization as its compiled exchanges run it."""
    jax, _ = _jax()
    key = (n, fmt.name, str(od))
    if key not in _DEQUANT:
        _DEQUANT[key] = jax.jit(lambda a, b: jp.dequantize_slab(a, b, n, fmt, od))
    return np.asarray(_DEQUANT[key](q, s))


def _bits(t):
    """A tensor's bit pattern as a numpy integer array."""
    t = t.detach().cpu()
    if t.dtype in (torch.bfloat16, torch.float16):
        return t.view(torch.int16).numpy()
    if t.dtype == torch.float32:
        return t.view(torch.int32).numpy()
    if t.dtype == torch.float64:
        return t.view(torch.int64).numpy()
    return t.numpy()


def _jbits(a):
    a = np.asarray(a)
    return a.view({2: np.int16, 4: np.int32, 8: np.int64, 1: np.int8}[a.dtype.itemsize])


# ---------------------------------------------------------------------------
# spellings and narrowing
# ---------------------------------------------------------------------------

SPELLINGS = ["off", "", "int8", "i8", "bf16", "fp16", "f32", "int4", "s4", "z:int8,x:f32",
             "gz:int4", "x:bfloat16,y:int8", "z:off", {"z": "int8"}, {"gx": "f16"}]


@quant
@pytest.mark.parametrize("spec", SPELLINGS, ids=str)
def test_wire_spellings_resolve_as_jax(spec):
    j, t = jp.resolve_wire_dtype(spec), tp.resolve_wire_dtype(spec)
    assert (j is None) == (t is None)
    if j is not None:
        assert str(t) == str(j) and repr(t) == repr(j)
        assert [str(f) for f in t.per_dim] == [str(f) for f in j.per_dim]
        assert str(tp.resolve_wire_dtype(str(t))) == str(t)   # round trip
    for dt, tdt in ((np.float32, torch.float32), (np.float64, torch.float64),
                    (np.float16, torch.float16), (np.int32, torch.int32),
                    (np.bool_, torch.bool), (np.complex64, torch.complex64),
                    ("bfloat16", torch.bfloat16)):
        for d in range(3):
            jf = jp.wire_format_for(np.dtype(dt) if dt != "bfloat16" else _jax()[1].bfloat16,
                                    j, d)
            tf = tp.wire_format_for(tdt, t, d)
            assert (None if jf is None else jf.name) == (None if tf is None else tf.name)


@quant
def test_wire_spelling_errors_and_environment(monkeypatch):
    for bad in ("int3", "z:int3", "w:int8", "z:int8,gz:int4", "z:int8,f32"):
        with pytest.raises(IA):
            tp.resolve_wire_dtype(bad)
    assert str(tp.resolve_wire_dtype(np.float16)) == "float16"
    assert str(tp.resolve_wire_dtype(torch.bfloat16)) == "bfloat16"
    monkeypatch.setenv("IGG_HALO_WIRE_DTYPE", "z:int8")
    assert str(tp.resolve_wire_dtype(None)) == "z:int8"
    assert tp.resolve_wire_dtype("off") is None   # an explicit argument wins
    assert tp.WireFormat("int8").dtype == torch.int8
    assert tp.WireFormat("bfloat16").dtype == torch.bfloat16


@pytest.mark.stage
@pytest.mark.parametrize("spec", [None, "", "0", "off", "none", "flat", "z:off", "z:staged",
                                  "staged", "hier", {"z": "staged"}, {"gx": True},
                                  "x:staged,z:flat"], ids=str)
def test_stage_spellings_resolve_as_jax(spec):
    j, t = jw.resolve_wire_stage(spec), tw.resolve_wire_stage(spec)
    assert (j is None) == (t is None)
    if j is not None:
        assert str(t) == str(j) and t.staged_dims == j.staged_dims
        assert tw.resolve_wire_stage(t) is t


@pytest.mark.stage
def test_stage_spelling_errors_and_environment(monkeypatch):
    for bad in ("z:sideways", "sideways", "w:staged", "z:staged,gz:staged", "z:staged,x"):
        with pytest.raises(IA):
            tw.resolve_wire_stage(bad)
    monkeypatch.setenv("IGG_HALO_WIRE_STAGE", "z:staged")
    assert str(tw.resolve_wire_stage(None)) == "z:staged"


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------

@quant
@pytest.mark.parametrize("name", ["int8", "int4"])
def test_codec_bitwise_jax_on_random_slabs(name):
    _, jnp = _jax()
    jf, tf = jp.WireFormat(name), tp.WireFormat(name)
    rng = np.random.default_rng(21)
    for it in range(40):
        n = (1, 2, 7, 64, 301)[it % 5]
        dt = (np.float32, np.float64)[(it // 5) % 2]
        x = (rng.standard_normal(n) * 10 ** rng.uniform(-3, 3)).astype(dt)
        q, s = jp.quantize_slab(jnp.asarray(x), jf)
        tq, ts = tp.quantize_slab(torch.from_numpy(x), tf)
        assert tq.dtype == torch.int8 and tq.numel() == tp.quant_slab_bytes(n, tf)
        assert np.array_equal(np.asarray(q), tq.numpy())
        assert np.array_equal(_jbits(s), _bits(ts))
        for od, tod in ((np.float32, torch.float32), (np.float64, torch.float64),
                        (jnp.bfloat16, torch.bfloat16), (np.float16, torch.float16)):
            ref = _j_dequant(q, s, n, jf, od)
            got = tp.dequantize_slab(tq, ts, n, tf, tod)
            assert np.array_equal(_jbits(ref), _bits(got)), (n, od)


@quant
@pytest.mark.parametrize("name,L", [("int8", 127), ("int4", 7)])
def test_codec_constant_zero_and_bounded(name, L):
    """`tests/test_precision.py`'s codec properties on the port: the scale
    is the max abs; an arbitrary slab returns within scale/(2L); a
    constant slab quantizes to +/-L and returns what JAX's compiled codec
    returns, within one float32 ulp of the constant; an all-zero slab
    takes scale 1 and returns exact zeros."""
    _, jnp = _jax()
    jf, tf = jp.WireFormat(name), tp.WireFormat(name)
    x = (np.random.default_rng(21).standard_normal(513) * 3.7).astype(np.float32)
    q, s = tp.quantize_slab(torch.from_numpy(x), tf)
    assert float(s[0]) == float(np.abs(x).max())
    y = tp.dequantize_slab(q, s, 513, tf, torch.float32).numpy()
    assert np.abs(y - x).max() <= float(s[0]) / (2 * L) * 1.001
    for c in (2.7182817, -0.3333333, 2.5):
        cx = np.full(9, c, np.float32)
        cq, cs = tp.quantize_slab(torch.from_numpy(cx), tf)
        assert set(tp._unpack_int4(cq, 9).tolist() if name == "int4" else cq.tolist()) \
            == {L if c > 0 else -L}
        got = tp.dequantize_slab(cq, cs, 9, tf, torch.float32).numpy()
        jq, js = jp.quantize_slab(jnp.asarray(cx), jf)
        assert np.array_equal(got, _j_dequant(jq, js, 9, jf, np.float32))
        assert np.abs(got - cx).max() <= np.spacing(np.float32(abs(c)))
    zq, zs = tp.quantize_slab(torch.zeros(4), tf)
    assert float(zs[0]) == 1.0
    assert (tp.dequantize_slab(zq, zs, 4, tf, torch.float32) == 0).all()


@quant
def test_codec_nonfinite_poisons_slab():
    _, jnp = _jax()
    for name in ("int8", "int4"):
        jf, tf = jp.WireFormat(name), tp.WireFormat(name)
        for poison in (np.nan, np.inf, -np.inf):
            x = np.asarray([1.0, poison, -2.0, 0.5], np.float32)
            q, s = tp.quantize_slab(torch.from_numpy(x), tf)
            assert np.isnan(float(s[0]))
            assert not np.isfinite(tp.dequantize_slab(q, s, 4, tf, torch.float32).numpy()).any()
            jq, js = jp.quantize_slab(jnp.asarray(x), jf)
            assert np.array_equal(np.asarray(jq), q.numpy())
    big = np.asarray([1e300, 1.0], np.float64)   # beyond the float32 scale: poisoned
    q, s = tp.quantize_slab(torch.from_numpy(big), tp.WireFormat("int8"))
    assert np.isnan(float(s[0]))
    y = tp.dequantize_slab(q, s, 2, tp.WireFormat("int8"), torch.float64).numpy()
    assert not np.isfinite(y).any()


@quant
def test_int4_packing_and_parity_with_int8():
    _, jnp = _jax()
    for n in (7, 8):
        q = np.arange(n, dtype=np.int8) % 15 - 7
        packed = tp._pack_int4(torch.from_numpy(q))
        assert packed.numel() == (n + 1) // 2
        assert np.array_equal(packed.numpy(), np.asarray(jp._pack_int4(jnp.asarray(q))))
        assert np.array_equal(tp._unpack_int4(packed, n).numpy(), q)
    x = np.asarray([7, -7, 3, 0, -1, 5, -4], np.float32) / 7 * 2.5
    f8, f4 = tp.WireFormat("int8"), tp.WireFormat("int4")
    q8, s8 = tp.quantize_slab(torch.from_numpy(x), f8)
    q4, s4 = tp.quantize_slab(torch.from_numpy(x), f4)
    assert float(s8[0]) == float(s4[0]) == 2.5 and q4.numel() == 4 and q8.numel() == 7
    y8 = tp.dequantize_slab(q8, s8, 7, f8, torch.float32).numpy()
    y4 = tp.dequantize_slab(q4, s4, 7, f4, torch.float32).numpy()
    assert np.abs(y4 - x).max() <= np.spacing(np.float32(2.5))   # int4's own levels
    assert np.abs(y8 - x).max() <= 2.5 / (2 * 127) * 1.001
    assert np.array_equal(_jbits(_j_dequant(jnp.asarray(q4.numpy()), jnp.asarray(s4.numpy()),
                                            7, jp.WireFormat("int4"), np.float32)), _bits(
        torch.from_numpy(y4)))


@quant
def test_scale_tail_round_trip():
    _, jnp = _jax()
    vals = [1.5, np.pi, 1e-30, np.nan]
    buf = tp.encode_scales([torch.tensor([v], dtype=torch.float32) for v in vals])
    assert buf.dtype == torch.int8 and buf.numel() == tp.SCALE_BYTES * len(vals)
    jbuf = jp.encode_scales([jnp.asarray([v], jnp.float32) for v in vals])
    assert np.array_equal(buf.numpy(), np.asarray(jbuf))
    dec = tp.decode_scales(buf, len(vals)).numpy()
    assert np.array_equal(dec.view(np.uint32), np.asarray(vals, np.float32).view(np.uint32))


SCHEMAS = [(2, [(1, 4, 8)] * 2), (1, [(2, 4, 8)] * 3), (0, [(1, 6, 8), (1, 7, 8)]),
           (2, [(5, 6, 1)])]


@quant
@pytest.mark.parametrize("fmt", ["bfloat16", "float16", "float32", "int8", "int4"])
@pytest.mark.parametrize("dim,shapes", SCHEMAS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_wire_schema_cast_and_quant_match_jax(dim, shapes, fmt, dtype):
    """`tests/test_wire.py`'s cast and quantized schema cases: layout, wire
    dtype, payload bytes and key as JAX's; ``pack`` bitwise JAX's payload;
    ``unpack`` bitwise JAX's (compiled); the staging rows' codec
    (`encode_rows`/`decode_rows`) is ``pack``/``unpack`` a row."""
    jax, jnp = _jax()
    jf = jp.wire_format_for(dtype, jp.resolve_wire_dtype(fmt), dim)
    tf = tp.wire_format_for(torch.from_numpy(np.zeros(1, dtype)).dtype,
                            tp.resolve_wire_dtype(fmt), dim)
    js = jw.slab_schema(dim, shapes, dtype, jf)
    ts = tw.slab_schema(dim, shapes, torch.from_numpy(np.zeros(1, dtype)).dtype, tf)
    assert (ts.layout, ts.payload_bytes, ts.wire_key, ts.is_quant) == \
        (js.layout, js.payload_bytes, js.wire_key, js.is_quant)
    assert ts.wire_dtype == str(js.wire_dtype)
    rng = np.random.default_rng(dim)
    slabs = [(3 * rng.standard_normal(s)).astype(dtype) for s in shapes]
    jbuf = jax.jit(lambda *a: js.pack(list(a)))(*[jnp.asarray(s) for s in slabs])
    tbuf = ts.pack([torch.from_numpy(s) for s in slabs])
    assert np.array_equal(_jbits(jbuf), _bits(tbuf))
    assert tbuf.numel() * tbuf.element_size() == ts.payload_bytes
    jback = jax.jit(lambda b: js.unpack(b))(jbuf)
    for a, b in zip(ts.unpack(tbuf), jback):
        assert np.array_equal(_jbits(b), _bits(a))
    if ts.layout == "flat":
        rows = torch.stack([torch.cat([torch.from_numpy(s).reshape(-1) for s in slabs])] * 3)
        enc = ts.encode_rows(rows)
        assert np.array_equal(_bits(enc[1]).reshape(-1), _bits(tbuf).reshape(-1))
        dec = ts.decode_rows(enc)
        flat = torch.cat([u.reshape(-1) for u in ts.unpack(tbuf)])
        assert torch.equal(dec[2], flat)


# ---------------------------------------------------------------------------
# the staged wire
# ---------------------------------------------------------------------------

def _fixture(monkeypatch, periodz=1, periodx=1):
    """`tests/test_wire_stage.py`'s mesh: 4x1x2, z split into 2 granules."""
    monkeypatch.setenv("IGG_TPU_DCN_GRANULES", "z:2")
    init_both(8, 8, 8, dimx=4, dimy=1, dimz=2, periodx=periodx, periody=1, periodz=periodz,
              nranks=8)


@pytest.mark.stage
@pytest.mark.parametrize("periodz,periodx", [(1, 1), (0, 1), (1, 0)])
def test_staged_layout_equals_jax(monkeypatch, periodz, periodx):
    _fixture(monkeypatch, periodz, periodx)
    for dim in range(3):
        j, t = j_layout(igg.global_grid(), dim), t_layout(tg.global_grid(), dim)
        assert (j is None) == (t is None), dim
        if j is not None:
            assert (t.dim, t.gather_dim, t.fold, t.granules, t.block, t.dims) == \
                (j.dim, j.gather_dim, j.fold, j.granules, j.block, j.dims)
            for a, b in zip(t.directions, j.directions):
                assert a.__dict__ == b.__dict__
    lay = t_layout(tg.global_grid(), 2)
    assert (lay.gather_dim, lay.fold, lay.granules) == (0, 4, 2)


@pytest.mark.stage
def test_undeclared_granules_mean_no_staging():
    init_both(8, 8, 8, dimx=4, dimy=1, dimz=2, periodx=1, periody=1, periodz=1, nranks=8)
    gg = tg.global_grid()
    assert tuple(gg.dcn_granules) == (1, 1, 1) and t_layout(gg, 2) is None
    A = tg.ones_g((8, 8, 8), torch.float32)
    plan = tg.halo_comm_plan(A, wire_stage="z:staged")
    assert plan["staged_axes"] == () and "staged" not in plan["axes"]["gz"]
    assert plan["axes"]["gz"]["ppermutes"] == 2


@pytest.mark.stage
def test_staged_plan_counts_and_fold(monkeypatch):
    _fixture(monkeypatch)
    A = tg.ones_g((8, 8, 8), torch.float32)
    plan = tg.halo_comm_plan(A, wire_stage="z:staged")
    assert plan == igg.halo_comm_plan(igg.ones_g((8, 8, 8), np.float32), wire_stage="z:staged")
    rec = plan["axes"]["gz"]
    assert plan["staged_axes"] == ("gz",) and rec["ppermutes"] == 14
    det = rec["staged"]
    assert (det["fold"], det["granules"], det["gather_axis"]) == (4, 2, "gx")
    assert (det["dcn_pairs"], det["flat_dcn_pairs"]) == (4, 16)
    flat = tg.halo_comm_plan(A)
    assert flat["wire_stage"] is None and flat["axes"]["gz"]["ppermutes"] == 2


@pytest.mark.stage
@pytest.mark.parametrize("wire", [None, "int8"])
def test_staged_exchange_bit_identical_to_flat(monkeypatch, wire):
    _fixture(monkeypatch)
    rng = np.random.default_rng(16)
    T = np.asarray(rng.normal(size=(32, 8, 16)), np.float32)
    V = np.asarray(rng.normal(size=(36, 8, 16)), np.float32)
    flat = tg.update_halo(tg.device_put_g(T), tg.device_put_g(V), wire_dtype=wire)
    staged = tg.update_halo(tg.device_put_g(T), tg.device_put_g(V), wire_dtype=wire,
                            wire_stage="z:staged")
    ref = igg.update_halo(igg.device_put_g(T), igg.device_put_g(V), wire_dtype=wire,
                          wire_stage="z:staged")
    for f, s, r in zip(flat, staged, ref):
        assert torch.equal(f, s) and np.array_equal(to_np(s), np.asarray(r))


# ---------------------------------------------------------------------------
# stochastic rounding
# ---------------------------------------------------------------------------

def test_stochastic_round_bitwise_jax_given_the_bits():
    jax, jnp = _jax()
    rng = np.random.default_rng(8)
    x = (rng.standard_normal(4096) * 10.0 ** rng.integers(-30, 30, 4096)).astype(np.float32)
    x[:6] = [np.inf, -np.inf, np.nan, 0.0, -0.0, np.finfo(np.float32).max]
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        ref = jp.stochastic_round_bf16(jnp.asarray(x), key)
        bits = np.asarray(jax.random.bits(key, shape=x.shape, dtype=jnp.uint16))
        got = tg.stochastic_round_bf16(torch.from_numpy(x), torch.from_numpy(bits.astype(np.int32)))
        assert got.dtype == torch.bfloat16
        assert np.array_equal(_jbits(ref), _bits(got))


def _port_bits(shape, seed):
    return tp.sr_bits(shape, shape, (0,), (1,), seed, 0, "cpu")


def test_stochastic_round_unbiased_with_port_bits():
    x = torch.full((8192,), 1.0 + 2 ** -9, dtype=torch.float32)
    outs = torch.stack([tg.stochastic_round_bf16(x, _port_bits((8192,), s)).float()
                        for s in range(8)])
    assert abs(float(outs.mean()) - (1.0 + 2 ** -9)) < 2e-4
    up = float((outs > 1.004).float().mean())
    assert 0.22 < up < 0.28
    assert set(np.unique(outs.numpy())) == {1.0, 1.0078125}


def test_stochastic_round_exact_signs_nonfinite():
    bits = _port_bits((5,), 0)
    x = torch.tensor([1.0, -1.0, 0.0, 0.5, -2.25])
    assert torch.equal(tg.stochastic_round_bf16(x, bits).float(), x)
    xm = torch.full((4096,), -(1.0 + 2 ** -8))
    om = tg.stochastic_round_bf16(xm, _port_bits((4096,), 1)).float()
    assert set(np.unique(om.numpy())) == {-1.0078125, -1.0}
    assert abs(float(om.mean()) + (1.0 + 2 ** -8)) < 3e-4
    ob = tg.stochastic_round_bf16(torch.tensor([np.inf, -np.inf, np.nan]), bits[:3]).float()
    assert ob[0] == np.inf and ob[1] == -np.inf and torch.isnan(ob[2])


def test_sr_bits_do_not_depend_on_the_split():
    """A block's bits are a function of (seed, step, its mesh coordinates,
    the cell): the half box of a 2x2x2 mesh at x-coordinate 1 draws the
    whole mesh's bits there; another step or seed draws others."""
    whole = tp.sr_bits((8, 6, 4), (4, 3, 2), (0, 0, 0), (2, 2, 2), 7, 3, "cpu")
    half = tp.sr_bits((4, 6, 4), (4, 3, 2), (1, 0, 0), (2, 2, 2), 7, 3, "cpu")
    assert torch.equal(whole[4:], half)
    assert int(whole.min()) >= 0 and int(whole.max()) < 65536
    assert not torch.equal(whole, tp.sr_bits((8, 6, 4), (4, 3, 2), (0, 0, 0), (2, 2, 2), 7, 4,
                                             "cpu"))
    assert not torch.equal(whole, tp.sr_bits((8, 6, 4), (4, 3, 2), (0, 0, 0), (2, 2, 2), 8, 3,
                                             "cpu"))
    assert not torch.equal(whole[:4], whole[4:])   # every block its own stream


def _final(dtype, sr, nt=200, seed=0, n=24):
    tg.init_global_grid(n, n, n, dimx=2, dimy=2, dimz=2, nranks=8, device_type="cpu",
                        quiet=True)
    try:
        T, Cp, p = init_diffusion3d(dtype=dtype, sr=sr, sr_seed=seed)
        out = run_diffusion(T, Cp, p, nt, nt_chunk=50, impl="plain" if not sr else None)
        return tg.gather_interior(out).astype(np.float64)
    finally:
        tg.finalize_global_grid()


def test_sr_storage_fixes_bf16_stagnation():
    ref = _final(torch.float32, sr=False)
    plain = _final(torch.bfloat16, sr=False)
    srd = _final(torch.bfloat16, sr=True)
    scale = np.abs(ref).max()
    err_plain = np.abs(plain - ref).max() / scale
    err_sr = np.abs(srd - ref).max() / scale
    assert err_plain > 0.1
    assert err_sr < 0.05
    assert err_sr < err_plain / 5


def test_sr_deterministic_per_seed():
    a = _final(torch.bfloat16, sr=True, nt=20, seed=7, n=12)
    b = _final(torch.bfloat16, sr=True, nt=20, seed=7, n=12)
    c = _final(torch.bfloat16, sr=True, nt=20, seed=8, n=12)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)


def test_sr_runner_errors_and_chunks():
    """The JAX package's sr errors: make_run/make_step on an sr bfloat16
    state, another impl, a deep cadence; the runner's global counter makes
    two chunks the same as one run."""
    tg.init_global_grid(12, 12, 12, dimx=2, dimy=2, dimz=2, nranks=8, device_type="cpu",
                        quiet=True, overlaps=(4, 4, 4), halowidths=(2, 2, 2))
    T, Cp, p = init_diffusion3d(dtype=torch.bfloat16, sr=True)
    with pytest.raises(IA):
        make_run(p, 2, impl="plain")(T, Cp)
    with pytest.raises(IA):
        run_diffusion(T, Cp, p, 2, impl="cuda")
    q = init_diffusion3d(dtype=torch.bfloat16, sr=True, comm_every=2)[2]
    with pytest.raises(IA):
        run_diffusion(T, Cp, q, 2)
    one = run_diffusion(T, Cp, p, 6, nt_chunk=6)
    two = run_diffusion(T, Cp, p, 6, nt_chunk=4)
    assert torch.equal(one, two) and one.dtype == torch.bfloat16
    t, c, n = make_run_sr(p, 3)(T, Cp, 0)
    t, c, n = make_run_sr(p, 3)(t, c, n)
    assert n == 6 and torch.equal(t, one)
    # sr on a float32 state is a no-op: the plain route's kernels as usual
    T32, Cp32, p32 = init_diffusion3d(dtype=torch.float32, sr=True)
    assert torch.equal(run_diffusion(T32, Cp32, p32, 2),
                       run_diffusion(T32, Cp32, init_diffusion3d(dtype=torch.float32)[2], 2))


# ---------------------------------------------------------------------------
# the int8 wire's accuracy (tests/test_quant_accuracy.py, fast case)
# ---------------------------------------------------------------------------

def _wired(wire, monkeypatch, nx=24, nt=100):
    tg.init_global_grid(nx, nx, nx, dimx=2, dimy=2, dimz=2, periodx=1, periody=1, periodz=1,
                        nranks=8, device_type="cpu", quiet=True)
    try:
        if wire is None:
            monkeypatch.delenv("IGG_HALO_WIRE_DTYPE", raising=False)
        else:
            monkeypatch.setenv("IGG_HALO_WIRE_DTYPE", wire)
        T, Cp, p = init_diffusion3d(dtype=torch.float32)
        return tg.gather_interior(run_diffusion(T, Cp, p, nt, nt_chunk=25)).astype(np.float64)
    finally:
        monkeypatch.delenv("IGG_HALO_WIRE_DTYPE", raising=False)
        tg.finalize_global_grid()


@quant
def test_int8_wire_drift_within_documented_bound_fast(monkeypatch):
    exact = _wired(None, monkeypatch)
    q8 = _wired("int8", monkeypatch)
    scale = np.abs(exact).max()
    drift = np.abs(q8 - exact).max() / scale
    assert 0 < drift < 0.02, drift
    z8 = _wired("z:int8", monkeypatch)
    drift_z = np.abs(z8 - exact).max() / scale
    assert 0 < drift_z <= drift * 1.05, (drift_z, drift)
