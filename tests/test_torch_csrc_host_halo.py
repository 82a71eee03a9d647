"""The port's CUDA sources run on the CPU (`tests/torch_csrc_host_util.py`:
`csrc/*.cu` built with the host C++ compiler against the stand-in CUDA headers
and driven through the port's own wrappers on CPU tensors). Each kernel's
result is held bitwise against its plain version here: the halo copies K8 and
K7 (every dim, both wire layouts, per-field halowidths, 2-D fields, periodic
and PROC_NULL edges, four dtypes, groups of 16 and 17 fields, an ensemble's
members at E = 1, 3 and 16) and K2, K3 and K6 with their checks once a
signature; the division helper of `cdiv.cuh` bitwise against IEEE division;
the FMA chain of the calibration.

The card's compiler, its float units and its launch limits are not tested here
(`chip_smoke.py` does that on a GPU); the kernels' index arithmetic, masks,
carried registers, shared-memory tiles, barriers, routes and delivery order
are. Skips without a C++ compiler.
"""

import itertools

import numpy as np
import pytest
import torch

import implicitglobalgrid_tpu_torch as tg
from implicitglobalgrid_tpu_torch.ops import cuda_build as cb
from implicitglobalgrid_tpu_torch.ops import cuda_halo as ch
from implicitglobalgrid_tpu_torch.ops.wire import schema_for_fields

from torch_port_util import clean_torch_grid  # noqa: F401
from torch_csrc_host_util import (  # noqa: F401 (fixtures)
    DIVISORS,
    HALO_BLOCK,
    HALO_CASES,
    HALO_DTYPES,
    HALO_VEC_BLOCK,
    K78_CASES,
    K78_DTYPES,
    K78_MEMBER_CASES,
    RANDOM_DIVISORS,
    _equal,
    _grid,
    _halo_case,
    _k78_field,
    _near_least_normal_quotient,
    _numerators,
    _plain,
    _staggered,
    host_lib,
    on_host,
)


@pytest.mark.parametrize("dtype,n", [(np.float32, 10 ** 7), (np.float64, 2 * 10 ** 6)])
def test_cdiv_equals_ieee_division(host_lib, dtype, n):
    """cdiv.cuh's quotient by a constant, and the passes K10's tiles divide
    with (fast, then exact), is the IEEE quotient bit for bit (two NaNs
    agree), on the host build of `igg_cdiv`."""
    full = _numerators(dtype, n, 8)
    for b, a in [(b, full) for b in DIVISORS] + [(b, full[-n // 10:]) for b in RANDOM_DIVISORS]:
        a = np.concatenate([a, _near_least_normal_quotient(dtype, b)])
        with np.errstate(all="ignore"):
            ref = a / dtype(b)
        for mode in (0, 2):  # cdiv; the tiles' passes (fast, then exact)
            q = np.empty_like(a)
            rc = host_lib.igg_cdiv(0 if dtype == np.float32 else 1, a.ctypes.data,
                                   q.ctypes.data, a.size, b, mode, None)
            assert rc == 0
            same = (q.view(f"u{a.itemsize}") == ref.view(f"u{a.itemsize}")) | (
                np.isnan(q) & np.isnan(ref))
            assert same.all(), (b, mode, a[~same][:5], q[~same][:5], ref[~same][:5])


@pytest.mark.parametrize("dim", [0, 1, 2])
@pytest.mark.parametrize("case", sorted(K78_CASES))
def test_k8_k7_match_plain(on_host, monkeypatch, case, dim):
    """K8 (both directions, send starts inside the block) and then K7
    (periodic and PROC_NULL edges, disp 1 and 2) along each dim on a group
    of stacked fields, each launch bitwise against its plain version: both
    wire layouts, shared and per-field halowidths, blocks no tile divides
    and a 3x1x2 grid (a single block along y, disp 2 past the 2 blocks
    along z); rows in 16-byte words where the slabs align."""
    blocks, hws, counts, dname = K78_CASES[case]
    dtype = K78_DTYPES[dname]
    monkeypatch.setattr(ch, "_GROUPS", {})  # this test's groups only
    rng = np.random.default_rng(71 + dim)
    fs = [_k78_field(rng, tuple(c * m for c, m in zip(counts, blk)), dtype) for blk in blocks]
    sch = schema_for_fields(dim, blocks, hws, fs[0].dtype)
    assert sch.layout == case.split("-")[0]
    kw = dict(starts_r=[blk[dim] - 2 * h for blk, h in zip(blocks, hws)],
              starts_l=[h for h in hws], blocks=blocks)
    bufs = ch.wire_pack(fs, sch, **kw)
    assert _equal(bufs, ch.wire_pack_plain(fs, sch, **kw)), "K8"
    launches = 1
    for periodic, disp in itertools.product((True, False), (1, 2)):
        got, want = [f.clone() for f in fs], [f.clone() for f in fs]
        wk = dict(blocks=blocks, periodic=periodic, disp=disp)
        ch.halo_write_multi(got, *bufs, sch, **wk)
        ch.halo_write_multi_plain(want, *bufs, sch, **wk)
        launches += 1
        assert _equal(got, want), ("K7", periodic, disp)
    counts = cb.launch_counts()
    assert (counts["wire_pack"], counts["halo_write_multi"]) == (1, launches - 1)
    vec = [g[5][k * ch._SLAB_DESC + 13] for g in ch._GROUPS.values() for k in range(len(fs))]
    if dim == 2:
        assert not any(vec)  # a z slab is hw cells a row
    elif case.startswith("slab-hw1-vec"):
        assert all(vec)


@pytest.mark.parametrize("dim", [0, 1])
def test_k8_k7_2d_fields_match_plain(on_host, dim):
    """K8 and K7 on 2-D fields (rows of one cell: the trailing dim padded),
    slab and flat layouts, periodic and PROC_NULL, bitwise."""
    rng = np.random.default_rng(75)
    for blocks, hws in (([(37, 70)] * 2, [1, 2]), ([(37, 70), (38, 70), (37, 71)], [1, 1, 2])):
        fs = [_k78_field(rng, (2 * b[0], 2 * b[1]), np.float32) for b in blocks]
        sch = schema_for_fields(dim, blocks, hws, fs[0].dtype)
        kw = dict(starts_r=[b[dim] - 2 * h for b, h in zip(blocks, hws)], starts_l=hws,
                  blocks=blocks)
        bufs = ch.wire_pack(fs, sch, **kw)
        assert _equal(bufs, ch.wire_pack_plain(fs, sch, **kw)), (sch.layout, "K8")
        for periodic in (True, False):
            got, want = [f.clone() for f in fs], [f.clone() for f in fs]
            ch.halo_write_multi(got, *bufs, sch, blocks=blocks, periodic=periodic, disp=1)
            ch.halo_write_multi_plain(want, *bufs, sch, blocks=blocks, periodic=periodic,
                                      disp=1)
            assert _equal(got, want), (sch.layout, periodic)


@pytest.mark.parametrize("nfields", [4, 16, 17])
def test_coalesced_update_halo_on_host_kernels(on_host, monkeypatch, nfields):
    """`update_halo` of a group through the host build of K8 and K7, with
    their launch counts, bitwise against the plain versions' call: (P, Vx,
    Vy, Vz) on a 2x2x2 periodic grid (one K8 and one K7 a dim), and 16 and
    17 fields on a 2x1x2 grid with y not periodic (17 take two launches a
    dim)."""
    if nfields == 4:
        n, dims, periods = (9, 8, 10), (2, 2, 2), (1, 1, 1)
        shapes = _staggered(n, ("P", "Vx", "Vy", "Vz"))
    else:
        n, dims, periods = (6, 5, 7), (2, 1, 2), (1, 0, 0)
        shapes = [n] * nfields
    _grid(n, dims, periods)
    rng = np.random.default_rng(77)
    fs = [_k78_field(rng, tuple(d * m for d, m in zip(dims, s)), np.float32) for s in shapes]
    got = tg.update_halo(*[f.clone() for f in fs])
    counts = cb.launch_counts()
    _plain(monkeypatch)
    want = tg.update_halo(*[f.clone() for f in fs])
    ndims = sum(d > 1 or p for d, p in zip(dims, periods))
    per_dim = 1 if nfields <= ch.MAX_SLABS else 2
    assert (counts["wire_pack"], counts["halo_write_multi"]) == (ndims * per_dim,) * 2
    assert sum(counts.values()) == 2 * ndims * per_dim
    assert _equal(got, want)


@pytest.mark.parametrize("members", [1, 3, 16])
@pytest.mark.parametrize("case", sorted(K78_MEMBER_CASES))
def test_k8_k7_members_match_plain(on_host, monkeypatch, case, members):
    """K8 and K7 with a member count and stride (an ensemble's fields lead
    with E members, every member in the launch), along every dim, periodic
    and PROC_NULL, bitwise against their plain versions at E = 1, 3 and
    16; member m's part of each row is member m's own solo K8 row, and at E
    = 1 the launch is the solo launch, bit for bit."""
    blocks, dtype = K78_MEMBER_CASES[case]
    counts, hws = (2, 2, 1), [1] * len(blocks)
    monkeypatch.setattr(ch, "_GROUPS", {})
    rng = np.random.default_rng(80 + members)
    fs = [_k78_field(rng, (members,) + tuple(c * m for c, m in zip(counts, blk)), dtype)
          for blk in blocks]
    for dim in range(3):
        sch = schema_for_fields(dim, blocks, hws, fs[0].dtype, members=members)
        solo = schema_for_fields(dim, blocks, hws, fs[0].dtype)
        kw = dict(starts_r=[blk[dim] - 2 for blk in blocks], starts_l=hws, blocks=blocks)
        bufs = ch.wire_pack(fs, sch, **kw)
        assert _equal(bufs, ch.wire_pack_plain(fs, sch, **kw)), (dim, "K8")
        for m in range(members):
            own = ch.wire_pack([f[m].contiguous() for f in fs], solo, **kw)
            rows = [b.view(b.shape[0], members, -1)[:, m] for b in bufs]
            assert _equal(rows, own), (dim, m)
        for periodic in (True, False):
            got, want = [f.clone() for f in fs], [f.clone() for f in fs]
            wk = dict(blocks=blocks, periodic=periodic, disp=1)
            ch.halo_write_multi(got, *bufs, sch, **wk)
            ch.halo_write_multi_plain(want, *bufs, sch, **wk)
            assert _equal(got, want), (dim, periodic, "K7")
            if members == 1:
                alone = [f[0].clone() for f in fs]
                ch.halo_write_multi(alone, *bufs, solo, **wk)
                assert _equal([g[0] for g in got], alone), (dim, periodic)
    desc = [g[5] for g in ch._GROUPS.values() if g[5] is not None]
    assert desc and all(d[k * ch._SLAB_DESC + 14] in (1, members) for d in desc
                        for k in range(len(blocks)))


@pytest.mark.parametrize("kernel,arg", HALO_CASES)
def test_k2_k3_k6_match_plain(on_host, kernel, arg):
    """The host build of K2 (a dim and halowidth), K3 (self-exchange modes)
    and K6 (combined delivery of the dims flagged) bitwise against their
    plain versions: the first seven cases in float64 and int8 on 2x2x2
    stacks of (6, 5, 37) blocks; then K2 on every dim, halowidths 1 and 2,
    1-D, 2-D and 3-D fields, and K6 on every mode combination its gate
    admits with x halowidths 1 and 2, each on blocks whose rows are and are
    not whole 16-byte words, in every element size (1, 2, 4 and 8 bytes)."""
    rng = np.random.default_rng(79)
    dtypes = (np.float64, np.int8) if HALO_CASES.index((kernel, arg)) < 7 else HALO_DTYPES
    for dtype in dtypes:
        got, want = _halo_case(kernel, arg, rng, dtype)
        assert torch.equal(got, want), dtype
    name = {"k2": "halo_write", "k3": "halo_self_exchange", "k6": "halo_write_combined"}[kernel]
    assert cb.launch_counts()[name] == len(dtypes)


def test_k2_k6_check_once_a_signature(on_host, monkeypatch):
    """K2's and K6's wrappers check a call once a signature: a second call
    with the same shapes, dtypes and arguments reuses the first's result
    and still launches (and matches the plain version); a new shape is
    checked again; a slab that aliases the field raises on every call."""
    monkeypatch.setattr(ch, "_CALLS", {})
    checks = []
    for name in ("_check_write", "_check_combined"):
        real = getattr(ch, name)
        monkeypatch.setattr(ch, name, lambda *a, real=real, name=name: (checks.append(name),
                                                                          real(*a))[1])
    rng = np.random.default_rng(80)
    for k in range(2):
        got, want = _halo_case("k2", (2, 1), rng, np.float32)
        assert torch.equal(got, want), k
        got, want = _halo_case("k6", (True, True, True), rng, np.float32)
        assert torch.equal(got, want), k
    assert checks == ["_check_write", "_check_combined"]
    assert (cb.launch_counts()["halo_write"], cb.launch_counts()["halo_write_combined"]) == (2, 2)
    _halo_case("k2", (2, 1, HALO_VEC_BLOCK), rng, np.float32)
    assert checks[-1] == "_check_write" and len(checks) == 3
    shape = tuple(2 * b for b in HALO_BLOCK)
    whole = torch.zeros(int(np.prod(shape)) + 2 * 2 * shape[0] * shape[1], dtype=torch.float32)
    A = whole[:int(np.prod(shape))].view(shape)
    sl = whole[int(np.prod(shape)):].view(shape[0], shape[1], 4)[..., :2].contiguous()
    alias = whole[int(np.prod(shape)):int(np.prod(shape)) + sl.numel()].view(sl.shape)
    E = tg.exceptions.InvalidArgumentError
    for _ in range(2):
        with pytest.raises(E, match="alias"):
            ch.halo_write(A, alias, sl, dim=2, hw=1, block=HALO_BLOCK[2])
        with pytest.raises(E, match="alias"):
            ch.halo_write_combined(A, {2: (sl, alias)}, modes=(False, False, True),
                                   hws=(1, 1, 1), block=HALO_BLOCK)
    assert checks[3:] == ["_check_combined"]  # the aliased calls' one new signature
    assert cb.launch_counts()["halo_write"] == 3


@pytest.mark.parametrize("iters", [0, 1, 3])
def test_fma_chain_matches_plain(on_host, monkeypatch, iters):
    """The calibration kernel (`csrc/calibrate.cu`): every element's chain
    of single-rounding multiply-adds equals the plain version's (which
    rounds through float64: equal but where a float64 sum lands on a
    float32 midpoint, which these inputs do not meet), a ragged last block
    included; one launch counted a call."""
    from implicitglobalgrid_tpu_torch.ops import cuda_calibrate as cc

    monkeypatch.setattr(cc, "_on_card", lambda t: True)
    monkeypatch.setattr(cc, "_stream", lambda t: None)
    g = torch.Generator().manual_seed(iters)
    x = torch.rand(3 * 256 + 17, generator=g) * 4 - 2
    got = cc.fma_chain(x.clone(), iters, 1.000001, 1e-9)
    ref = cc.fma_chain_plain(x.clone(), iters, 1.000001, 1e-9)
    assert torch.equal(got, ref)
    assert cb.launch_counts()["fma_chain"] == 1
    big = cc.fma_chain(x.clone(), iters, 0.75, 0.25)
    assert torch.equal(big, cc.fma_chain_plain(x.clone(), iters, 0.75, 0.25))
