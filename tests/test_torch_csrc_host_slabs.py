"""The port's CUDA sources run on the CPU (`tests/torch_csrc_host_util.py`:
`csrc/*.cu` built with the host C++ compiler against the stand-in CUDA headers
and driven through the port's own wrappers on CPU tensors). Each kernel's
result is held bitwise against its plain version here: the K4s copy and step
modes along every dim, and its batched wave and Stokes launches (every field
of a dim in one launch), periodic and not.

The card's compiler, its float units and its launch limits are not tested here
(`chip_smoke.py` does that on a GPU); the kernels' index arithmetic, masks,
carried registers, shared-memory tiles, barriers, routes and delivery order
are. Skips without a C++ compiler.
"""

import itertools

import numpy as np
import pytest
import torch

from implicitglobalgrid_tpu_torch.ops import cuda_build as cb
from implicitglobalgrid_tpu_torch.ops import cuda_stencil as cs
from implicitglobalgrid_tpu_torch.ops import cuda_stokes as cst
from implicitglobalgrid_tpu_torch.ops import cuda_wave as cw

from torch_port_util import clean_torch_grid  # noqa: F401
from torch_csrc_host_util import (  # noqa: F401 (fixtures)
    DIFF_K,
    K,
    K4S_BLOCK,
    K4S_STAGGERED_BLOCK,
    WAVE_DTYPES,
    WAVE_K,
    _batches,
    _bits_equal,
    _diffusion_state,
    _earlier,
    _moves,
    _scales,
    _wave_tensor,
    host_lib,
    on_host,
)


@pytest.mark.parametrize("dtype", WAVE_DTYPES)
def test_k4s_copy_and_step_every_dim_match_plain(on_host, dtype):
    """K4s copy and 3-D step modes on a 2x2x2 stack of blocks whose extents
    are no multiple of the tiles, every dim and both sides, periodic and
    not (PROC_NULL edges), without and with two earlier dims' corners
    (halowidths 1 and 2), a copy of halowidth 2 too, bitwise; mixed
    magnitudes in the step's state."""
    rng = np.random.default_rng(31)
    shape = tuple(2 * n for n in K4S_BLOCK)
    with np.errstate(over="ignore"):
        T, Cp = _diffusion_state(shape, dtype, 32)
    launches = 0
    for dim in range(3):
        others = tuple(e for e in (2, 0, 1) if e != dim)
        ear = _earlier(rng, shape, K4S_BLOCK, others, (1, 2), dtype)
        for periodic, earlier, step, hw in itertools.product(
                (True, False), ((), ear), (False, True), (1, 2)):
            if step and hw == 2:
                continue
            kw = dict(block=K4S_BLOCK, periodic=periodic, earlier=earlier,
                      Cp=Cp if step else None, consts=DIFF_K if step else None)
            moves = _moves(K4S_BLOCK[dim], hw)
            got = cs.exchange_slabs(T, dim, hw, moves, **kw)
            ref = cs.exchange_slabs_plain(T, dim, hw, moves, **kw)
            launches += 1
            assert all(_bits_equal(a, b) for a, b in zip(got, ref)), \
                (dim, periodic, len(earlier), step, hw)
    assert cb.launch_counts()["exchange_slabs"] == launches


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("dtype", WAVE_DTYPES)
def test_k4s_batched_wave_every_dim_match_plain(on_host, dtype, periodic):
    """The K4s wave modes' batched launch along each dim on 2x2x2 blocks
    whose extents are no multiple of the tiles, with Vy left out of the
    batch (it gets no thread blocks), earlier dims' corners, bitwise."""
    rng = np.random.default_rng(35)
    n = K4S_STAGGERED_BLOCK
    shapes = cw.wave_shapes(n)
    st = tuple(_wave_tensor(rng.standard_normal(tuple(2 * s for s in shp)), dtype)
               for shp in shapes.values())
    for dim, per_field in _batches(rng, st, ("P", "Vx", "Vz"), n, shapes, dtype).items():
        kw = dict(block=n, periodic=periodic, consts=WAVE_K)
        got = cw.wave_slabs_multi(st, dim, 1, per_field, **kw)
        ref = cw.wave_slabs_multi_plain(st, dim, 1, per_field, **kw)
        assert sorted(got) == sorted(per_field)
        for f in per_field:
            assert all(_bits_equal(a, b) for a, b in zip(got[f], ref[f])), (dim, f)
    assert cb.launch_counts()["exchange_slabs"] == 3


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_k4s_batched_stokes_every_dim_match_plain(on_host, dtype, periodic):
    """The K4s Stokes modes' batched launch along each dim on 2x2x2 blocks
    whose extents are no multiple of the tiles, with Vx left out of the
    batch, earlier dims' corners, on a state whose x planes are scaled to
    zero, tiny, subnormal and near-overflow values (every path of the
    division), bitwise."""
    rng = np.random.default_rng(36)
    n = K4S_STAGGERED_BLOCK
    scales = _scales(dtype)
    with np.errstate(over="ignore"):
        st = tuple(torch.from_numpy((rng.standard_normal(tuple(2 * s for s in shp)) * scales[
            rng.integers(0, 5, (2 * shp[0], 1, 1))]).astype(dtype))
            for shp in cst.stokes_shapes(n).values())
    shapes = cst.wave_shapes(n)
    for dim, per_field in _batches(rng, st, ("P", "Vy", "Vz"), n, shapes, dtype).items():
        kw = dict(block=n, periodic=periodic, consts=K)
        got = cst.stokes_slabs_multi(st, dim, 1, per_field, **kw)
        ref = cst.stokes_slabs_multi_plain(st, dim, 1, per_field, **kw)
        assert sorted(got) == sorted(per_field)
        for f in per_field:
            assert all(_bits_equal(a, b) for a, b in zip(got[f], ref[f])), (dim, f)
    assert cb.launch_counts()["exchange_slabs"] == 3
