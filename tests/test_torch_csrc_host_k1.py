"""The port's CUDA sources run on the CPU (`tests/torch_csrc_host_util.py`:
`csrc/*.cu` built with the host C++ compiler against the stand-in CUDA headers
and driven through the port's own wrappers on CPU tensors). Each kernel's
result is held bitwise against its plain version here: the diffusion kernels
K1 (every fuse combination) and K5 (its four) on stacked blocks with tile and
chunk edges and mixed magnitudes in three dtypes, and whole `run_diffusion`
runs with their launch counts.

The card's compiler, its float units and its launch limits are not tested here
(`chip_smoke.py` does that on a GPU); the kernels' index arithmetic, masks,
carried registers, shared-memory tiles, barriers, routes and delivery order
are. Skips without a C++ compiler.
"""

import itertools

import numpy as np
import pytest
import torch

from implicitglobalgrid_tpu_torch.models import init_diffusion2d, init_diffusion3d, run_diffusion
from implicitglobalgrid_tpu_torch.ops import cuda_build as cb
from implicitglobalgrid_tpu_torch.ops import cuda_stencil as cs

from torch_port_util import clean_torch_grid  # noqa: F401
from torch_csrc_host_util import (  # noqa: F401 (fixtures)
    DIFF_BLOCK,
    DIFF_K,
    WAVE_DTYPES,
    _bits_equal,
    _diffusion_state,
    _grid,
    _plain,
    _wave_tensor,
    host_lib,
    on_host,
)


@pytest.mark.parametrize("dtype", WAVE_DTYPES)
def test_k1_every_fuse_matches_plain(on_host, dtype):
    """K1 on a 2x2x2 stack of blocks with tile and chunk edges, with each
    of the 8 fuse combinations (the halo cells of a fused dim take the
    source cells n-2 and 1, corners composed), bitwise; and one 3^3 block,
    every dim fused (a source read by three output cells a dim)."""
    shape = tuple(2 * n for n in DIFF_BLOCK)
    with np.errstate(over="ignore"):
        T, Cp = _diffusion_state(shape, dtype, 21)
        t3, c3 = _diffusion_state((3, 3, 3), dtype, 22)
    for fuse in itertools.product((False, True), repeat=3):
        got = cs.diffusion3d_step_halo(T, Cp, fuse=fuse, block=DIFF_BLOCK, **DIFF_K)
        ref = cs.diffusion3d_step_halo_plain(T, Cp, fuse=fuse, block=DIFF_BLOCK, **DIFF_K)
        assert _bits_equal(got, ref), fuse
    fuse = (True, True, True)
    assert _bits_equal(cs.diffusion3d_step_halo(t3, c3, fuse=fuse, **DIFF_K),
                       cs.diffusion3d_step_halo_plain(t3, c3, fuse=fuse, **DIFF_K))
    assert cb.launch_counts()["diffusion3d_step_halo"] == 9


@pytest.mark.parametrize("dtype", WAVE_DTYPES)
def test_k5_every_mode_matches_plain(on_host, dtype):
    """K5 on a 2x2 stack of 2-D blocks (several x chunks, rows not a
    multiple of its thread block), receiving random slabs on each of its 4
    combinations of dims (y lanes over x rows), bitwise."""
    block = (37, 70)
    shape = tuple(2 * n for n in block)
    c2 = {k: v for k, v in DIFF_K.items() if k != "dz"}
    with np.errstate(over="ignore"):
        T, Cp = _diffusion_state(shape, dtype, 25)
    rng = np.random.default_rng(26)
    for modes in itertools.product((False, True), repeat=2):
        recvs = {d: tuple(_wave_tensor(rng.standard_normal(
            [2 if e == d else s for e, s in enumerate(shape)]), dtype) for _ in range(2))
            for d in range(2) if modes[d]}
        got = cs.diffusion2d_step_recv(T, Cp, recvs, block=block, **c2)
        ref = cs.diffusion2d_step_recv_plain(T, Cp, recvs, block=block, **c2)
        assert _bits_equal(got, ref), modes
    assert cb.launch_counts()["diffusion2d_step_exchange"] == 4


@pytest.mark.parametrize("ndim", [3, 2])
def test_run_diffusion_on_host_kernels_matches_plain(on_host, monkeypatch, ndim):
    """Four steps through the host build of K4s and K4 (a 2x2x2 mesh: one
    K4 and 3 K4s launches a step) or K4s and K5 (a 2x2 mesh: one K5 and 2
    K4s launches a step) equal the plain versions' run bitwise."""
    if ndim == 3:
        _grid((10, 9, 35), (2, 2, 2), (1, 0, 1))
        T0, Cp, p = init_diffusion3d(dtype=torch.float32)
    else:
        _grid((19, 37, 1), (2, 2, 1), (1, 1, 0))
        T0, Cp, p = init_diffusion2d(dtype=torch.float32)
    a = run_diffusion(T0, Cp, p, 4, nt_chunk=2)
    counts = cb.launch_counts()
    _plain(monkeypatch)
    b = run_diffusion(T0, Cp, p, 4, nt_chunk=2)
    if ndim == 3:
        assert (counts["diffusion3d_step_exchange"], counts["exchange_slabs"]) == (4, 12)
    else:
        assert (counts["diffusion2d_step_exchange"], counts["exchange_slabs"]) == (4, 8)
    assert not torch.equal(a, T0)
    assert torch.equal(a, b)
