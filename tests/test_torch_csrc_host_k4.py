"""The port's CUDA sources run on the CPU (`tests/torch_csrc_host_util.py`:
`csrc/*.cu` built with the host C++ compiler against the stand-in CUDA headers
and driven through the port's own wrappers on CPU tensors). Each kernel's
result is held bitwise against its plain version here: the diffusion kernel K4
(every received-mode combination) on stacked blocks with tile and chunk edges
and mixed magnitudes in three dtypes, the K4s 2-D modes, and the K4s z launch
on long blocks (its walk along x).

The card's compiler, its float units and its launch limits are not tested here
(`chip_smoke.py` does that on a GPU); the kernels' index arithmetic, masks,
carried registers, shared-memory tiles, barriers, routes and delivery order
are. Skips without a C++ compiler.
"""

import itertools

import numpy as np
import pytest

from implicitglobalgrid_tpu_torch.ops import cuda_build as cb
from implicitglobalgrid_tpu_torch.ops import cuda_stencil as cs
from implicitglobalgrid_tpu_torch.ops import cuda_stokes as cst
from implicitglobalgrid_tpu_torch.ops import cuda_wave as cw

from torch_port_util import clean_torch_grid  # noqa: F401
from torch_csrc_host_util import (  # noqa: F401 (fixtures)
    DIFF_BLOCK,
    DIFF_K,
    K,
    K4S_WALK_BLOCK,
    WAVE_DTYPES,
    WAVE_K,
    _batches,
    _bits_equal,
    _diffusion_state,
    _earlier,
    _moves,
    _wave_tensor,
    host_lib,
    on_host,
)


@pytest.mark.parametrize("dtype", WAVE_DTYPES)
def test_k4s_2d_modes_match_plain(on_host, dtype):
    """K4s on a 2x2 stack of 2-D blocks (laid out as (S0, 1, S1): a tile of
    one row along y), x rows and y lanes, halowidths 1 and 2 (the per-dim
    tier's 2-D case), the copy and the 2-D step, with the other dim's
    corners, periodic and not, bitwise."""
    rng = np.random.default_rng(33)
    block = (37, 70)
    shape = tuple(2 * n for n in block)
    c2 = {k: v for k, v in DIFF_K.items() if k != "dz"}
    with np.errstate(over="ignore"):
        T, Cp = _diffusion_state(shape, dtype, 34)
    for dim, hw, step, periodic in itertools.product((0, 1), (1, 2), (False, True),
                                                     (True, False)):
        earlier = _earlier(rng, shape, block, (1 - dim,), (hw,), dtype)
        kw = dict(block=block, periodic=periodic, earlier=earlier, Cp=Cp if step else None,
                  consts=c2 if step else None)
        moves = _moves(block[dim], hw)
        got = cs.exchange_slabs(T, dim, hw, moves, **kw)
        ref = cs.exchange_slabs_plain(T, dim, hw, moves, **kw)
        assert all(_bits_equal(a, b) for a, b in zip(got, ref)), (dim, hw, step, periodic)
    assert cb.launch_counts()["exchange_slabs"] == 16


@pytest.mark.parametrize("mode,dtype", [("copy", np.float32), ("step", np.float64),
                                        ("wave", np.float32), ("stokes", np.float64)])
def test_k4s_z_launch_long_blocks_match_plain(on_host, mode, dtype):
    """The K4s z launch on blocks of 35 x 70 x 21, long enough along x for
    several chunks of the wave modes' walk (and its ring slots reused
    across them) and rows in two tiles, both sides periodic and not, with
    earlier dims' corners, bitwise: the copy at halowidths 1, 3 and 8, the
    3-D step at 1 and on two ranges of one block (update_slab), the wave
    and Stokes batches of every field, and each wave field on two ranges of
    8 (shift 0: two groups, slab positions in two tiles)."""
    rng = np.random.default_rng(37)
    n = K4S_WALK_BLOCK
    launches = 0
    if mode in ("copy", "step"):
        shape = tuple(2 * b for b in n)
        with np.errstate(over="ignore"):
            T, Cp = _diffusion_state(shape, dtype, 38)
        step = mode == "step"
        for periodic, hw in itertools.product((True, False), (1,) if step else (1, 3, 8)):
            earlier = _earlier(rng, shape, n, (0, 1), (1, hw), dtype)
            kw = dict(block=n, periodic=periodic, earlier=earlier, Cp=Cp if step else None,
                      consts=DIFF_K if step else None)
            got = cs.exchange_slabs(T, 2, hw, _moves(n[2], hw), **kw)
            ref = cs.exchange_slabs_plain(T, 2, hw, _moves(n[2], hw), **kw)
            launches += 1
            assert all(_bits_equal(a, b) for a, b in zip(got, ref)), (periodic, hw)
        if step:
            starts = [n[2] - 2, 1]
            got = cs.update_slab(T, Cp, 2, starts, 1, block=n, **DIFF_K)
            launches += 1
            for s0, g in zip(starts, got):
                assert _bits_equal(g, cs.update_slab_plain(T, Cp, 2, s0, 1, block=n, **DIFF_K))
        assert cb.launch_counts()["exchange_slabs"] == launches
        return
    mod = cw if mode == "wave" else cst
    shapes = mod.wave_shapes(n)
    all_shapes = shapes if mode == "wave" else cst.stokes_shapes(n)
    st = tuple(_wave_tensor(rng.standard_normal(tuple(2 * s for s in shp)), dtype)
               for shp in all_shapes.values())
    multi, plain, k = ((cw.wave_slabs_multi, cw.wave_slabs_multi_plain, WAVE_K)
                       if mode == "wave" else
                       (cst.stokes_slabs_multi, cst.stokes_slabs_multi_plain, K))
    per_field = _batches(rng, st, cw.FIELDS, n, shapes, dtype)[2]
    for periodic in (True, False):
        kw = dict(block=n, periodic=periodic, consts=k)
        got = multi(st, 2, 1, per_field, **kw)
        ref = plain(st, 2, 1, per_field, **kw)
        for f in per_field:
            assert all(_bits_equal(a, b) for a, b in zip(got[f], ref[f])), (periodic, f)
    if mode == "wave":
        for f, m in shapes.items():
            starts = [m[2] - 9, 1]
            got = cw.wave_update_slab(st, f, 2, starts, 8, block=n, consts=k)
            for s0, g in zip(starts, got):
                ref = cw.wave_slabs_plain(st, f, 2, 8, (cs.Move(s0, s0, 0),), block=n,
                                          periodic=True, consts=k)[0]
                assert _bits_equal(g, ref), (f, s0)
    assert cb.launch_counts()["exchange_slabs"] == (6 if mode == "wave" else 2)


@pytest.mark.parametrize("dtype", WAVE_DTYPES)
def test_k4_every_mode_matches_plain(on_host, dtype):
    """K4 on a 2x2x2 stack of blocks with tile and chunk edges, receiving
    random slabs on each of the 8 combinations of dims (y rows over x
    planes over z lanes), bitwise."""
    shape = tuple(2 * n for n in DIFF_BLOCK)
    with np.errstate(over="ignore"):
        T, Cp = _diffusion_state(shape, dtype, 23)
    rng = np.random.default_rng(24)
    for modes in itertools.product((False, True), repeat=3):
        recvs = {d: tuple(_wave_tensor(rng.standard_normal(
            [2 if e == d else s for e, s in enumerate(shape)]), dtype) for _ in range(2))
            for d in range(3) if modes[d]}
        got = cs.diffusion3d_step_recv(T, Cp, recvs, block=DIFF_BLOCK, **DIFF_K)
        ref = cs.diffusion3d_step_recv_plain(T, Cp, recvs, block=DIFF_BLOCK, **DIFF_K)
        assert _bits_equal(got, ref), modes
    assert cb.launch_counts()["diffusion3d_step_exchange"] == 8
