"""Port parity of the pseudo-transient Stokes model (`models/stokes.py`)
against the JAX package, from the SAME state (`stokes_state_from_numpy`):
the plain route against JAX ``impl="xla"`` on the five grids of
`tests/test_models_wave_stokes.py:93-99,183-188` (random rhog, 4
iterations, float32 rtol 1e-5 / atol 1e-5*max|field|, float64 1e-12),
`init_stokes3d` bitwise, `stokes_residuals` (1e-6 float32, 1e-12 float64),
distributed equals single, and the residual drops while the sphere drives
upward flow.
"""

import numpy as np
import pytest
import torch

import implicitglobalgrid_tpu_torch as tg
import implicitglobalgrid_tpu_torch.models.stokes as tst
from implicitglobalgrid_tpu.models import init_stokes3d as j_init
from implicitglobalgrid_tpu.models import run_stokes as j_run
from implicitglobalgrid_tpu.models import stokes_residuals as j_residuals
from implicitglobalgrid_tpu_torch.models import init_stokes3d, run_stokes, stokes_residuals
from implicitglobalgrid_tpu_torch.ops import cuda_stokes as cst
from torch_port_util import clean_torch_grid, init_both, to_np  # noqa: F401
from torch_stokes_util import (
    CASES, IDS, NAMES, compare, init_grid, port_state, random_rhog, spy,
)

@pytest.mark.parametrize("grid,dtype", CASES, ids=IDS)
def test_plain_route_matches_jax_xla(grid, dtype, monkeypatch):
    init_grid(grid)
    state, p = j_init(dtype=dtype)
    state = random_rhog(state, 4)
    tstate, tp = port_state(state, p)
    ref = j_run(state, p, 4, nt_chunk=2, impl="xla")
    calls = spy(monkeypatch, cst.StokesStep, "__call__")
    got = run_stokes(tstate, tp, 4, nt_chunk=2, impl="plain")
    assert not calls
    compare(got, ref, dtype, grid)


def _port_run(nx, dims, nt):
    tg.init_global_grid(nx, nx, nx, dimx=dims[0], dimy=dims[1], dimz=dims[2],
                        nranks=int(np.prod(dims)), device_type="cpu", quiet=True)
    state, p = init_stokes3d(dtype=torch.float64)
    state = run_stokes(state, p, nt, nt_chunk=10)
    res = stokes_residuals(state, p)
    out = [tg.gather_interior(a) for a in state[:4]]
    tg.finalize_global_grid()
    return out, res


def test_distributed_matches_single():
    """tests/test_models_wave_stokes.py:71-76 on the port: 2x2x2 x 6^3
    against 1x1x1 x 10^3."""
    multi, _ = _port_run(6, (2, 2, 2), nt=10)
    single, _ = _port_run(10, (1, 1, 1), nt=10)
    for m, s in zip(multi, single):
        assert m.shape == s.shape
        assert np.allclose(m, s, rtol=0, atol=1e-12)


def test_converges_and_buoyancy_drives_flow():
    """tests/test_models_wave_stokes.py:79-90 on the port."""
    tg.init_global_grid(12, 12, 12, dimx=2, dimy=2, dimz=2, nranks=8, device_type="cpu",
                        quiet=True)
    state, p = init_stokes3d(dtype=torch.float64)
    r0 = stokes_residuals(state, p)
    state = run_stokes(state, p, 60, nt_chunk=30)
    r1 = stokes_residuals(state, p)
    assert r1[1] < r0[1]
    Vz = tg.gather_interior(state[3])
    c = Vz.shape[0] // 2
    assert Vz[c, c, c] > 0


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_init_matches_jax_bitwise(dtype):
    init_both(8, 8, 8, dimx=2, dimy=2, dimz=2)
    state, p = j_init(dtype=dtype)
    tstate, tp = init_stokes3d(dtype=torch.from_numpy(np.zeros(1, dtype)).dtype)
    for f in ("mu", "dt_v", "dt_p", "damp", "dx", "dy", "dz", "overlap"):
        assert getattr(tp, f) == getattr(p, f) and type(getattr(tp, f)) is type(getattr(p, f))
    for a, b, name in zip(tstate, state, NAMES):
        assert np.array_equal(to_np(a), np.asarray(b)), name
        assert to_np(a).dtype == np.asarray(b).dtype, name
    assert float(to_np(tstate[7]).sum()) > 0  # the sphere holds cells


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_residuals_match_jax(dtype):
    init_grid("all multi-rank PROC_NULL edges", n=(6, 6, 8))
    state, p = j_init(dtype=dtype)
    state = j_run(state, p, 3, nt_chunk=3, impl="xla")
    state = random_rhog(state, 6)
    tstate, tp = port_state(state, p)
    got, ref = stokes_residuals(tstate, tp), j_residuals(state, p)
    tol = {np.float32: 1e-6, np.float64: 1e-12}[dtype]
    for g, r in zip(got, ref):
        assert type(g) is float and abs(g - r) <= tol * max(1.0, abs(r)), (got, ref)


