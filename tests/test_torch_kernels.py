"""Port parity: each CUDA kernel's plain version (what its wrapper runs on a
CPU tensor) against the JAX Pallas entry point it replaces, in interpret
mode. The halo kernels are pure copies and must match BITWISE; the step
matches to the JAX suite's ulp bounds between its Pallas and XLA tiers
(f32 rtol 2e-6 / atol 2e-5, f64 rtol 1e-13 / atol 1e-12,
`tests/test_pallas_stencil.py:21,50`)."""

import itertools

import numpy as np
import pytest
import torch

from implicitglobalgrid_tpu.ops import pallas_halo as ph
from implicitglobalgrid_tpu.ops import pallas_stencil as ps
from implicitglobalgrid_tpu_torch.ops import cuda_halo as ch
from implicitglobalgrid_tpu_torch.ops import cuda_stencil as cs
from implicitglobalgrid_tpu_torch.utils.exceptions import InvalidArgumentError
from torch_port_util import clean_torch_grid, to_np  # noqa: F401

CONSTS = dict(lam=1.0, dt=0.0123, dx=0.37, dy=0.41, dz=0.29)
TOL = {np.float32: dict(rtol=2e-6, atol=2e-5),
       np.float64: dict(rtol=1e-13, atol=1e-12)}
FUSES = list(itertools.product((False, True), repeat=3))


def _state(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    T = (100 * rng.random(shape)).astype(dtype)
    Cp = (1 + 5 * rng.random(shape)).astype(dtype)
    return T, Cp


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("fuse", FUSES, ids=lambda f: "".join("TF"[not x] for x in f))
def test_step_halo_matches_pallas(fuse, dtype):
    T, Cp = _state((7, 9, 10), dtype)
    ref = np.asarray(ps.diffusion3d_step_halo_pallas(
        T, Cp, fuse=fuse, interpret=True, **CONSTS))
    got = to_np(cs.diffusion3d_step_halo(torch.from_numpy(T), torch.from_numpy(Cp),
                                         fuse=fuse, **CONSTS))
    assert np.allclose(got, ref, **TOL[dtype])
    assert got.dtype == ref.dtype


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_step_matches_pallas(dtype):
    T, Cp = _state((8, 6, 9), dtype, 1)
    ref = np.asarray(ps.diffusion3d_step_pallas(T, Cp, interpret=True, **CONSTS))
    out = torch.empty(T.shape, dtype=torch.from_numpy(T).dtype)
    got = cs.diffusion3d_step(torch.from_numpy(T), torch.from_numpy(Cp), out=out,
                              **CONSTS)
    assert got is out
    assert np.allclose(to_np(got), ref, **TOL[dtype])


@pytest.mark.parametrize("fuse", [(True, True, True), (False, False, False),
                                  (True, False, True)])
def test_step_matches_pallas_multiplane(fuse):
    """The multi-plane TPU entry point computes the same function."""
    import jax

    T, Cp = _state((16, 16, 16), np.float32, 2)
    assert ps.mp_planes(jax.ShapeDtypeStruct(T.shape, T.dtype), interpret=True)
    ref = np.asarray(ps.diffusion3d_step_halo_pallas_mp(
        T, Cp, fuse=fuse, interpret=True, **CONSTS))
    got = to_np(cs.diffusion3d_step_halo(torch.from_numpy(T), torch.from_numpy(Cp),
                                         fuse=fuse, **CONSTS))
    assert np.allclose(got, ref, **TOL[np.float32])


def test_step_bf16_matches_pallas():
    """bf16 storage, f32 compute and f32 constants; one rounding of the
    result to bf16 on each side, so one bf16 ulp apart at most."""
    import jax.numpy as jnp

    T, Cp = _state((6, 8, 8), np.float32, 3)
    Tb, Cb = jnp.asarray(T, jnp.bfloat16), jnp.asarray(Cp, jnp.bfloat16)
    ref = np.asarray(ps.diffusion3d_step_halo_pallas(
        Tb, Cb, fuse=(True, True, True), interpret=True, **CONSTS)).astype(np.float32)
    tb = torch.from_numpy(np.asarray(Tb).astype(np.float32)).bfloat16()
    cb = torch.from_numpy(np.asarray(Cb).astype(np.float32)).bfloat16()
    got = to_np(cs.diffusion3d_step_halo(tb, cb, fuse=(True, True, True), **CONSTS))
    assert np.allclose(got, ref, rtol=2 ** -7, atol=0)


def test_step_blocks_match_per_block_pallas():
    """The stacked form steps every block independently."""
    T, Cp = _state((12, 8, 10), np.float64, 4)
    block = (6, 4, 5)
    got = to_np(cs.diffusion3d_step_halo(torch.from_numpy(T), torch.from_numpy(Cp),
                                         fuse=(False, False, True), block=block,
                                         **CONSTS))
    for c in itertools.product(range(2), repeat=3):
        sl = tuple(slice(ci * b, (ci + 1) * b) for ci, b in zip(c, block))
        ref = np.asarray(ps.diffusion3d_step_halo_pallas(
            T[sl], Cp[sl], fuse=(False, False, True), interpret=True, **CONSTS))
        assert np.allclose(got[sl], ref, **TOL[np.float64])


@pytest.mark.parametrize("dim,hw,shape", [
    (0, 1, (6, 8, 16)), (0, 2, (6, 8, 16)), (1, 1, (4, 16, 16)), (1, 2, (4, 16, 16)),
])
def test_halo_write_matches_pallas_bitwise(dim, hw, shape):
    rng = np.random.default_rng(dim * 10 + hw)
    a = rng.standard_normal(shape)
    ss = list(shape)
    ss[dim] = hw
    sl, sr = rng.standard_normal(ss), rng.standard_normal(ss)
    ref = np.asarray(ph.halo_write_inplace(a, sl, sr, dim=dim, hw=hw, interpret=True))
    ta = torch.from_numpy(a.copy())
    got = ch.halo_write(ta, torch.from_numpy(sl), torch.from_numpy(sr), dim=dim, hw=hw)
    assert got is ta and np.array_equal(to_np(got), ref)


def test_halo_write_blocks_and_dim2():
    """Stacked form (every block's halos, slab c to block c) and dim 2,
    against a numpy oracle; slabs aliasing the field are refused."""
    rng = np.random.default_rng(7)
    a = rng.standard_normal((4, 6, 12)).astype(np.float32)
    sl = rng.standard_normal((4, 6, 4)).astype(np.float32)   # 2 blocks x hw 2
    sr = rng.standard_normal((4, 6, 4)).astype(np.float32)
    ref = a.copy()
    for c in range(2):
        ref[:, :, c * 6: c * 6 + 2] = sl[:, :, c * 2: c * 2 + 2]
        ref[:, :, c * 6 + 4: c * 6 + 6] = sr[:, :, c * 2: c * 2 + 2]
    ta = torch.from_numpy(a.copy())
    ch.halo_write(ta, torch.from_numpy(sl), torch.from_numpy(sr), dim=2, hw=2, block=6)
    assert np.array_equal(ta.numpy(), ref)
    with pytest.raises(InvalidArgumentError):
        ch.halo_write(ta, ta[:, :, :4], torch.from_numpy(sr), dim=2, hw=2, block=6)
    with pytest.raises(InvalidArgumentError):
        ch.halo_write(ta, torch.from_numpy(sl), torch.from_numpy(sr), dim=2, hw=4, block=6)


MODES = [m for m in itertools.product((False, True), repeat=3) if any(m)]


@pytest.mark.parametrize("modes", MODES, ids=lambda m: "".join("TF"[not x] for x in m))
def test_self_exchange_matches_pallas_bitwise(modes):
    rng = np.random.default_rng(11)
    a = rng.standard_normal((7, 8, 9))
    ols = (3, 2, 4)
    ref = np.asarray(ph.halo_self_exchange_pallas(a, modes=modes, ols=ols,
                                                  interpret=True))
    got = to_np(ch.halo_self_exchange(torch.from_numpy(a), modes=modes, ols=ols))
    assert np.array_equal(got, ref)


def test_self_exchange_blocks_and_checks():
    rng = np.random.default_rng(12)
    a = rng.standard_normal((8, 6, 10)).astype(np.float32)
    got = to_np(ch.halo_self_exchange(torch.from_numpy(a), modes=(True, False, True),
                                      ols=(2, 2, 2), block=(4, 6, 5)))
    for c0, c2 in itertools.product(range(2), repeat=2):
        sl = (slice(4 * c0, 4 * c0 + 4), slice(None), slice(5 * c2, 5 * c2 + 5))
        ref = np.asarray(ph.halo_self_exchange_pallas(
            a[sl], modes=(True, False, True), ols=(2, 2, 2), interpret=True))
        assert np.array_equal(got[sl], ref)
    with pytest.raises(InvalidArgumentError):
        ch.halo_self_exchange(torch.from_numpy(a), modes=(False, False, False),
                              ols=(2, 2, 2))
    with pytest.raises(InvalidArgumentError):
        cs.diffusion3d_step(torch.from_numpy(a), torch.from_numpy(a[:4]), **CONSTS)


def test_fusable_halo_dims_matches_jax():
    import implicitglobalgrid_tpu as igg
    import implicitglobalgrid_tpu_torch as tg

    for dims, periods in [((1, 1, 1), (1, 1, 1)), ((2, 1, 1), (1, 1, 1)),
                          ((1, 1, 2), (1, 1, 1)), ((1, 1, 1), (0, 0, 0)),
                          ((1, 2, 1), (1, 0, 1)), ((1, 1, 1), (1, 1, 0))]:
        kw = dict(dimx=dims[0], dimy=dims[1], dimz=dims[2], periodx=periods[0],
                  periody=periods[1], periodz=periods[2], quiet=True)
        igg.init_global_grid(8, 8, 8, **kw)
        tg.init_global_grid(8, 8, 8, device_type="cpu", **kw)
        assert cs.fusable_halo_dims(tg.global_grid()) == \
            ps.fusable_halo_dims(igg.global_grid())
        igg.finalize_global_grid()
        tg.finalize_global_grid()


# ---------------------------------------------------------------------------
# K4, K5, K6 and K4s (the multi-block slice).
# ---------------------------------------------------------------------------

def _both_grids(n, **kw):
    import implicitglobalgrid_tpu as igg
    import implicitglobalgrid_tpu_torch as tg

    kw = dict(kw, quiet=True)
    igg.init_global_grid(*n, **kw)
    tg.init_global_grid(*n, device_type="cpu", **kw)
    return igg.global_grid(), tg.global_grid()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("modes", MODES, ids=lambda m: "".join("TF"[not x] for x in m))
def test_step_exchange_matches_pallas(modes, dtype):
    """One block of a periodic single-rank grid: the exchange pipeline is
    local swaps there, so the JAX entry point runs outside `shard_map`."""
    jg, pg = _both_grids((8, 6, 16), dimx=1, dimy=1, dimz=1, periodx=1, periody=1,
                         periodz=1)
    T, Cp = _state((8, 6, 16), dtype, 5)
    ref = np.asarray(ps.diffusion3d_step_exchange_pallas(
        T, Cp, jg, modes, interpret=True, **CONSTS))
    got = cs.diffusion3d_step_exchange(torch.from_numpy(T), torch.from_numpy(Cp), pg,
                                       modes, **CONSTS)
    assert np.allclose(to_np(got), ref, **TOL[dtype])


@pytest.mark.parametrize("modes", [(True, False, False), (False, True, False),
                                   (True, True, False)], ids=["TF", "FT", "TT"])
def test_step_exchange_2d_matches_pallas(modes):
    import jax

    jg, pg = _both_grids((16, 16, 1), dimx=1, dimy=1, dimz=1, periodx=1, periody=1)
    T, Cp = _state((16, 16), np.float32, 6)
    assert ps.strip_rows_2d(jax.ShapeDtypeStruct(T.shape, T.dtype), interpret=True)
    c = {k: v for k, v in CONSTS.items() if k != "dz"}
    ref = np.asarray(ps.diffusion2d_step_exchange_pallas(
        T, Cp, jg, modes, interpret=True, **c))
    got = cs.diffusion2d_step_exchange(torch.from_numpy(T), torch.from_numpy(Cp), pg,
                                       modes, **c)
    assert np.allclose(to_np(got), ref, **TOL[np.float32])


def test_step_2d_alone_matches_plain_route():
    """K5 with no received slabs is the 2-D step: every block's interior
    updated, boundaries kept (the XLA route's function)."""
    T, Cp = _state((12, 10), np.float64, 7)
    c = {k: v for k, v in CONSTS.items() if k != "dz"}
    got = to_np(cs.diffusion2d_step_recv(torch.from_numpy(T), torch.from_numpy(Cp), {},
                                         block=(6, 5), **c))
    for c0, c1 in itertools.product(range(2), repeat=2):
        sl = (slice(6 * c0, 6 * c0 + 6), slice(5 * c1, 5 * c1 + 5))
        ref = T[sl].copy()
        t, cp = T[sl], Cp[sl]
        qx = -c["lam"] * (t[1:] - t[:-1]) / c["dx"]
        qy = -c["lam"] * (t[:, 1:] - t[:, :-1]) / c["dy"]
        dT = (-(qx[1:, 1:-1] - qx[:-1, 1:-1]) / c["dx"]
              - (qy[1:-1, 1:] - qy[1:-1, :-1]) / c["dy"]) / cp[1:-1, 1:-1]
        ref[1:-1, 1:-1] += c["dt"] * dT
        assert np.allclose(got[sl], ref, **TOL[np.float64])


COMBINED = [m for m in MODES if m[2]]


@pytest.mark.parametrize("modes", COMBINED, ids=lambda m: "".join("TF"[not x] for x in m))
@pytest.mark.parametrize("hwx", [1, 2])
def test_halo_write_combined_matches_pallas_bitwise(modes, hwx):
    rng = np.random.default_rng(13)
    a = rng.standard_normal((8, 6, 10))
    hws = (hwx, 1, 1)
    recvs = {}
    for d in range(3):
        if modes[d]:
            ss = list(a.shape)
            ss[d] = hws[d]
            recvs[d] = (rng.standard_normal(ss), rng.standard_normal(ss))
    ref = np.asarray(ph.halo_write_combined_pallas(a, recvs, modes=modes, hws=hws,
                                                   interpret=True))
    ta = torch.from_numpy(a.copy())
    got = ch.halo_write_combined(
        ta, {d: tuple(torch.from_numpy(s) for s in p) for d, p in recvs.items()},
        modes=modes, hws=hws)
    assert got is ta and np.array_equal(to_np(got), ref)


def test_combined_write_supported_matches_jax():
    for shape, modes, hws in [((8, 6, 10), (True, True, True), (1, 1, 1)),
                              ((8, 6, 10), (True, True, False), (1, 1, 1)),
                              ((8, 6, 10), (True, True, True), (2, 1, 1)),
                              ((3, 6, 10), (True, False, True), (2, 1, 1)),
                              ((8, 6, 10), (False, True, True), (1, 2, 1)),
                              ((8, 6, 10), (False, False, True), (1, 1, 2)),
                              ((8, 10), (True, True, False), (1, 1, 1))]:
        assert ch.combined_write_supported(shape, modes, hws) == \
            ph.combined_write_supported(shape, modes, hws)


def test_exchange_slabs_copy_moves_and_patches():
    """K4s in copy mode against a numpy oracle: a periodic shift, a
    PROC_NULL edge keeping its own current halo, and a corner patched from
    an earlier dim's received slabs."""
    rng = np.random.default_rng(21)
    A = rng.standard_normal((8, 6, 10))
    block = (4, 3, 5)
    zl, zr = rng.standard_normal((8, 6, 2)), rng.standard_normal((8, 6, 2))
    earlier = ((2, 1, (torch.from_numpy(zl), torch.from_numpy(zr))),)
    moves = (cs.Move(2, 0, -1), cs.Move(1, 3, 1))
    for periodic in (True, False):
        got = cs.exchange_slabs(torch.from_numpy(A), 0, 1, moves, block=block,
                                periodic=periodic, earlier=earlier)
        P = A.copy()  # the state after the z halos were written
        for c in range(2):
            P[:, :, 5 * c] = zl[:, :, c]
            P[:, :, 5 * c + 4] = zr[:, :, c]
        for k, (m, g) in enumerate(zip(moves, got)):
            assert tuple(g.shape) == (2, 6, 10)
            for t in range(2):
                s = t + m.shift
                if periodic or 0 <= s < 2:
                    want = P[4 * (s % 2) + m.start]
                else:
                    want = P[4 * t + m.own]
                assert np.array_equal(to_np(g)[t], want), (periodic, k, t)


def test_new_wrappers_refuse_bad_arguments():
    T, Cp = (torch.from_numpy(x) for x in _state((8, 6, 10), np.float32, 8))
    slab = torch.zeros((8, 6, 2))
    E = InvalidArgumentError
    # K4: slab shape, dtype, aliasing; out aliasing T
    with pytest.raises(E):
        cs.diffusion3d_step_recv(T, Cp, {2: (torch.zeros((8, 6, 3)), slab)}, block=(8, 6, 5),
                                 **CONSTS)
    with pytest.raises(E):
        cs.diffusion3d_step_recv(T, Cp, {2: (slab.double(), slab.double())}, block=(8, 6, 5),
                                 **CONSTS)
    with pytest.raises(E):
        cs.diffusion3d_step_recv(T, Cp, {2: (T[:, :, :2].contiguous(), T[:, :, :2])},
                                 block=(8, 6, 5), **CONSTS)
    with pytest.raises(E):
        cs.diffusion3d_step_recv(T, Cp, {2: (slab, slab)}, block=(8, 6, 5), out=T, **CONSTS)
    # K5: 2-D only, slab shapes
    c2 = {k: v for k, v in CONSTS.items() if k != "dz"}
    with pytest.raises(E):
        cs.diffusion2d_step_recv(T, Cp, {}, **c2)
    T2, C2 = T[0].contiguous(), Cp[0].contiguous()
    with pytest.raises(E):
        cs.diffusion2d_step_recv(T2, C2, {1: (torch.zeros((6, 3)), torch.zeros((6, 3)))},
                                 block=(6, 5), **c2)
    with pytest.raises(E):
        cs.diffusion2d_step_recv(T2, C2, {0: (T2[:1], T2[:1])}, **c2)
    # K6: z must exchange, slab shapes, aliasing
    with pytest.raises(E):
        ch.halo_write_combined(T, {0: (slab, slab)}, modes=(True, False, False),
                               hws=(1, 1, 1))
    with pytest.raises(E):
        ch.halo_write_combined(T, {2: (slab, slab)}, modes=(False, False, True),
                               hws=(1, 1, 1))
    with pytest.raises(E):
        ch.halo_write_combined(T, {2: (T[:, :, :1], T[:, :, 1:2])},
                               modes=(False, False, True), hws=(1, 1, 1))
    with pytest.raises(E):
        ch.halo_write_combined(T, {2: (slab.double(), slab.double())},
                               modes=(False, False, True), hws=(1, 1, 1), block=(8, 6, 5))
    # K4s: a move leaving the block, earlier slabs of the wrong shape, dim
    # itself among the earlier dims, a step slab of a 1-D field, mixed dtypes
    with pytest.raises(E):
        cs.exchange_slabs(T, 0, 1, (cs.Move(8, 0, 1),), block=(8, 6, 10), periodic=True)
    with pytest.raises(E):
        cs.exchange_slabs(T, 0, 1, (cs.Move(6, 0, 1),), block=(8, 6, 10), periodic=True,
                          earlier=((2, 1, (slab, slab)),))
    with pytest.raises(E):
        cs.exchange_slabs(T, 2, 1, (cs.Move(6, 0, 1),), block=(8, 6, 5), periodic=True,
                          earlier=((2, 1, (slab, slab)),))
    T1 = T2[0].contiguous()
    with pytest.raises(E):
        cs.exchange_slabs(T1, 0, 1, (cs.Move(2, 0, 1),), block=(10,), periodic=True,
                          Cp=T1.clone(), consts=CONSTS)
    with pytest.raises(E):
        cs.update_slab(T, Cp.double(), 0, [1], 1, block=(8, 6, 10), **CONSTS)


# ---------------------------------------------------------------------------
# K7, K8, K9 and the K4s wave modes (the acoustic slice).
# ---------------------------------------------------------------------------

def test_acoustic_slice_wrappers_refuse_bad_arguments():
    from implicitglobalgrid_tpu_torch.ops import cuda_wave as cw
    from implicitglobalgrid_tpu_torch.ops.wire import schema_for_fields

    E = InvalidArgumentError
    # K8 / K7: two fields of blocks (4, 3, 5), 2 x 1 x 2 blocks
    locs = [(4, 3, 5), (5, 3, 5)]
    fs = [torch.zeros((8, 3, 10), dtype=torch.float64),
          torch.zeros((10, 3, 10), dtype=torch.float64)]
    sch = schema_for_fields(0, locs, [1, 1], torch.float64)
    kw = dict(starts_r=[2, 3], starts_l=[1, 1], blocks=locs)
    buf_r, buf_l = ch.wire_pack(fs, sch, **kw)
    assert tuple(buf_r.shape) == (4, 30)
    with pytest.raises(E):   # a start leaving the block
        ch.wire_pack(fs, sch, starts_r=[4, 3], starts_l=[1, 1], blocks=locs)
    with pytest.raises(E):   # mixed dtypes
        ch.wire_pack([fs[0], fs[1].float()], sch, **kw)
    with pytest.raises(E):   # a schema whose slabs do not fit the blocks
        ch.wire_pack(fs, schema_for_fields(0, [(4, 3, 5), (5, 3, 6)], [1, 1],
                                           torch.float64), **kw)
    with pytest.raises(E):   # different block counts
        ch.wire_pack([fs[0], torch.zeros((5, 3, 10), dtype=torch.float64)], sch, **kw)
    with pytest.raises(E):   # not contiguous
        ch.wire_pack([fs[0].transpose(1, 2), fs[1]], sch, **kw)
    with pytest.raises(E):   # too many fields for one launch
        ch.wire_pack([fs[0]] * (ch.MAX_SLABS + 1), sch, **kw)
    wkw = dict(blocks=locs, periodic=True, disp=1)
    ch.halo_write_multi(fs, buf_r, buf_l, sch, **wkw)
    with pytest.raises(E):   # buffer shape
        ch.halo_write_multi(fs, buf_r[:2], buf_l, sch, **wkw)
    with pytest.raises(E):   # buffer dtype
        ch.halo_write_multi(fs, buf_r.float(), buf_l, sch, **wkw)
    with pytest.raises(E):   # a buffer aliasing a field
        ch.halo_write_multi(fs, fs[0].view(4, -1)[:, :30], buf_l, sch, **wkw)
    with pytest.raises(E):   # halos overlapping in a block of 1 along dim
        ch.halo_write_multi([torch.zeros((2, 3, 10), dtype=torch.float64)] * 2,
                            buf_r, buf_l, schema_for_fields(0, [(1, 3, 5)] * 2, [1, 1],
                                                            torch.float64),
                            blocks=[(1, 3, 5)] * 2, periodic=True, disp=1)
    # K9 and the K4s wave modes: state (P, Vx, Vy, Vz) of blocks (4, 3, 5)
    block = (4, 3, 5)
    st = tuple(torch.zeros(tuple(2 * s for s in shp), dtype=torch.float32)
               for shp in cw.wave_shapes(block).values())
    k = cw.wave_consts(rho=1.0, K=1.0, dt=0.1, dx=1.0, dy=1.0, dz=1.0)
    cw.acoustic_step_recv(st, {}, block=block, consts=k)
    with pytest.raises(E):   # a staggered field of the wrong shape
        cw.acoustic_step_recv((st[0], st[0], st[2], st[3]), {}, block=block, consts=k)
    with pytest.raises(E):   # bfloat16
        cw.acoustic_step_recv(tuple(a.bfloat16() for a in st), {}, block=block, consts=k)
    with pytest.raises(E):   # fewer than 3 planes
        cw.acoustic_step_recv(st, {}, block=(2, 3, 5), consts=k)
    with pytest.raises(E):   # out aliasing the state
        cw.acoustic_step_recv(st, {}, block=block, consts=k, out=st)
    slab = torch.zeros((8, 6, 2))
    with pytest.raises(E):   # a received slab of the wrong shape (P is 8 x 6 x 10)
        cw.acoustic_step_recv(st, {"P": {2: (slab, torch.zeros((8, 6, 3)))}}, block=block,
                              consts=k)
    with pytest.raises(E):   # a received slab aliasing the state
        cw.acoustic_step_recv(st, {"P": {2: (st[0][:, :, :2], slab)}}, block=block, consts=k)
    with pytest.raises(E):   # unknown field
        cw.acoustic_step_recv(st, {"T": {2: (slab, slab)}}, block=block, consts=k)
    modes = {f: (False, False, True) for f in cw.FIELDS}
    ols = {f: (2, 2, 2) for f in cw.FIELDS}
    cw.acoustic_step_self(st, modes, ols, block=block, consts=k)
    with pytest.raises(E):   # an overlap outside [2, n-1]
        cw.acoustic_step_self(st, modes, dict(ols, P=(2, 2, 5)), block=block, consts=k)
    mv = (cs.Move(2, 0, -1), cs.Move(1, 3, 1))
    cw.wave_slabs(st, "Vx", 0, 1, (cs.Move(3, 0, -1), cs.Move(1, 4, 1)), block=block,
                  periodic=True, consts=k)
    with pytest.raises(E):   # unknown field
        cw.wave_slabs(st, "T", 0, 1, mv, block=block, periodic=True, consts=k)
    with pytest.raises(E):   # a move leaving Vx's block of 5 planes
        cw.wave_slabs(st, "Vx", 0, 1, (cs.Move(5, 0, 1),), block=block, periodic=True,
                      consts=k)
    px = torch.zeros((2, 6, 10))
    with pytest.raises(E):   # earlier x slabs of P's shape for Vz (6 x 12 across)
        cw.wave_slabs(st, "Vz", 1, 1, (cs.Move(1, 0, -1), cs.Move(1, 2, 1)), block=block,
                      periodic=True, consts=k, earlier=((0, 1, (px, px)),))
