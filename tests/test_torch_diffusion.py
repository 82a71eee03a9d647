"""Port parity: the diffusion model against the JAX package.

- `init_diffusion3d`/`2d` build the same state (f64; the exponentials of
  two libraries may differ in the last ulp, hence rtol 1e-14);
- 10-step `run_diffusion` trajectories from the SAME state (carried over
  with `state_from_numpy`) match JAX's ``impl="xla"`` (the port's plain
  route) and ``impl="pallas_interpret"`` (the port's kernel route, which on
  the CPU runs the kernels' plain versions), on one block and on 2x2x2, to
  the JAX suite's multi-step bounds: f32 rtol 1e-5 / atol 1e-4
  (`tests/test_pallas_stencil.py:29-30`), f64 1e-12.
"""

import dataclasses

import numpy as np
import pytest
import torch

import implicitglobalgrid_tpu as igg
import implicitglobalgrid_tpu_torch as tg
from implicitglobalgrid_tpu.models import init_diffusion2d as j_init2d
from implicitglobalgrid_tpu.models import init_diffusion3d as j_init3d
from implicitglobalgrid_tpu.models import run_diffusion as j_run
from implicitglobalgrid_tpu_torch.models import (
    DiffusionParams, init_diffusion2d, init_diffusion3d, run_diffusion,
    state_from_numpy,
)
from torch_port_util import clean_torch_grid, init_both, to_np  # noqa: F401

TOL = {np.float32: dict(rtol=1e-5, atol=1e-4),
       np.float64: dict(rtol=1e-12, atol=1e-12)}
GRIDS = {
    "1 block periodic": ((8, 8, 8), dict(dimx=1, dimy=1, dimz=1, periodx=1,
                                         periody=1, periodz=1)),
    "1 block": ((8, 8, 8), dict(dimx=1, dimy=1, dimz=1)),
    "2x2x2 periodic": ((8, 8, 8), dict(dimx=2, dimy=2, dimz=2, periodx=1,
                                       periody=1, periodz=1)),
    "2x2x2 mixed": ((8, 6, 10), dict(dimx=2, dimy=2, dimz=2, periody=1)),
    "2x1x1 periodic (partial fuse)": ((8, 8, 8), dict(dimx=2, dimy=1, dimz=1,
                                                      periodx=1, periody=1,
                                                      periodz=1)),
}


def test_init_state_matches_jax():
    init_both(8, 6, 7, dimx=2, dimy=2, dimz=2, periodz=1)
    T, Cp, p = j_init3d(dtype=np.float64)
    t, c, q = init_diffusion3d(dtype=torch.float64)
    assert np.allclose(to_np(t), np.asarray(T), rtol=1e-14, atol=0)
    assert np.allclose(to_np(c), np.asarray(Cp), rtol=1e-14, atol=0)
    for f in ("lam", "dt", "dx", "dy", "dz"):
        assert getattr(q, f) == getattr(p, f)
    tg.finalize_global_grid()
    igg.finalize_global_grid()
    init_both(8, 6, dimx=4, dimy=2, periodx=1)
    T, Cp, p = j_init2d(dtype=np.float64)
    t, c, q = init_diffusion2d(dtype=torch.float64)
    assert np.allclose(to_np(t), np.asarray(T), rtol=1e-14, atol=0)
    assert np.allclose(to_np(c), np.asarray(Cp), rtol=1e-14, atol=0)
    assert (q.dt, q.dx, q.dy) == (p.dt, p.dx, p.dy)


KERNEL, PLAIN = ("pallas_interpret", None), ("xla", "plain")
TRAJ = [(g, KERNEL, np.float32) for g in GRIDS] + [
    ("1 block periodic", KERNEL, np.float64), ("2x2x2 mixed", KERNEL, np.float64),
    ("1 block periodic", PLAIN, np.float32), ("2x2x2 periodic", PLAIN, np.float64),
    ("2x2x2 mixed", PLAIN, np.float32),
]


@pytest.mark.parametrize("grid,routes,dtype", TRAJ, ids=[
    f"{g}-{'kernel' if r is KERNEL else 'plain'}-{np.dtype(d).name}"
    for g, r, d in TRAJ])
def test_trajectory_matches_jax(grid, routes, dtype):
    n, kw = GRIDS[grid]
    init_both(*n, **kw)
    T, Cp, p = j_init3d(dtype=dtype)
    ref = np.asarray(j_run(T, Cp, p, 10, nt_chunk=5, impl=routes[0]))
    t, c, q = state_from_numpy(np.asarray(T), np.asarray(Cp),
                               dataclasses.asdict(p), "cpu")
    got = run_diffusion(t, c, q, 10, nt_chunk=5, impl=routes[1])
    assert np.allclose(to_np(got), ref, **TOL[dtype]), grid
    assert np.array_equal(to_np(t), np.asarray(T))  # the input is not written
    assert not np.allclose(ref, np.asarray(T))


def test_trajectory_2d_matches_jax():
    init_both(8, 6, dimx=4, dimy=2, periodx=1)
    T, Cp, p = j_init2d(dtype=np.float64)
    ref = np.asarray(j_run(T, Cp, p, 10, nt_chunk=10, impl="xla"))
    t, c, q = state_from_numpy(np.asarray(T), np.asarray(Cp),
                               dataclasses.asdict(p), "cpu")
    assert np.allclose(to_np(run_diffusion(t, c, q, 10)), ref, **TOL[np.float64])


def test_state_from_numpy_round_trip():
    import jax.numpy as jnp

    init_both(8, 8, 8, dimx=2, dimy=2, dimz=2)
    for dt in (np.float32, np.float64, jnp.bfloat16):
        T, Cp, p = j_init3d(dtype=dt)
        t, c, q = state_from_numpy(np.asarray(T), np.asarray(Cp),
                                   dataclasses.asdict(p), "cpu")
        assert q == DiffusionParams(lam=p.lam, dt=p.dt, dx=p.dx, dy=p.dy, dz=p.dz)
        assert t.is_contiguous() and tuple(t.shape) == tuple(T.shape)
        back = np.asarray(T).astype(np.float32)
        assert np.array_equal(to_np(t).astype(np.float32), back)
        assert np.array_equal(to_np(c).astype(np.float32),
                              np.asarray(Cp).astype(np.float32))


def test_unported_options_raise():
    """``overlap``, a deep ``comm_every``, ``sr`` and ``ensemble`` (all
    ported since) run, from ``init_diffusion3d`` and from
    `state_from_numpy`, and match the plain route bitwise (``sr`` is a no-op
    on a float64 state; an ensemble's member 0 is the solo run); a state
    without the member axis under ``ensemble`` raises as in JAX."""
    tg.init_global_grid(12, 8, 8, periodx=1, overlaps=(4, 2, 2), halowidths=(2, 1, 1),
                        device_type="cpu", quiet=True)
    assert init_diffusion3d(sr=True, sr_seed=3)[2].sr_seed == 3
    T, Cp, p = init_diffusion3d()
    T, Cp = tg.update_halo(T, Cp)   # halos consistent with what they mirror
    ref = run_diffusion(T, Cp, p, 2, impl="plain")
    for kw in (dict(overlap=True), dict(comm_every=2)):
        q = init_diffusion3d(**kw)[2]
        assert torch.equal(run_diffusion(T, Cp, q, 2, impl="plain"), ref), kw
    with pytest.raises(tg.exceptions.InvalidArgumentError, match="member axis"):
        run_diffusion(T, Cp, p, 2, ensemble=2)
    ET, EC = tg.ensemble_state((T, Cp), 2, perturb=0.1)
    assert torch.equal(run_diffusion(ET, EC, p, 2, ensemble=2)[0], ref)
    t, c, q = state_from_numpy(to_np(T), to_np(Cp), dict(dataclasses.asdict(p),
                                                         comm_every="x:2"), "cpu")
    assert q.comm_every == "x:2" and torch.equal(run_diffusion(t, c, q, 2), ref)
    t, c, q = state_from_numpy(to_np(T), to_np(Cp), dict(dataclasses.asdict(p), sr=True,
                                                         sr_seed=5), "cpu")
    assert q.sr and q.sr_seed == 5 and torch.equal(run_diffusion(t, c, q, 2), ref)
    with pytest.raises(tg.exceptions.InvalidArgumentError):
        run_diffusion(T, Cp, p, 2, impl="pallas")


def test_runner_ping_pong_and_donate():
    """Two buffers at most; the caller's T is written only when donated."""
    from implicitglobalgrid_tpu_torch.models import make_run

    tg.init_global_grid(8, 8, 8, periodx=1, periody=1, periodz=1,
                        device_type="cpu", quiet=True)
    T, Cp, p = init_diffusion3d(dtype=torch.float64)
    T0 = T.clone()
    run = make_run(p, 5)
    a, _ = run(T, Cp)
    assert torch.equal(T, T0)
    b, _ = run(T.clone(), Cp, donate=True)
    assert torch.equal(a, b)
    c = run_diffusion(T, Cp, p, 5, nt_chunk=2)
    assert torch.equal(a, c)
