"""Interior-first overlap of the port (`ops/overlap.py`
`hide_communication`, `models.common.interior_first_step`, the models'
``overlap=True``), the twin of `tests/test_overlap.py`: the overlapped step
equals update-then-exchange BITWISE within the port, and matches the JAX
package's overlapped step from the same seeded numpy inputs (float64
1e-12, float32 rtol 1e-5 / atol 1e-4 or 1e-5: the port's model tests'
bounds against ``impl="xla"``).

- one diffusion step on the JAX test's grids (`periods` x `dims`), five
  steps, the thin-block fallback, the staggered multi-field form;
- the models: diffusion 3-D and 2-D, acoustic, and Stokes (held against
  the port's plain Stokes and JAX's plain ``impl="xla"`` Stokes, never JAX's
  overlapped Stokes, whose own test fails on this toolchain);
- the order of the phases (shells, interior, then the exchange, which on a
  CUDA grid runs on the side stream), and the refusals: a wire dtype
  (`NotSupportedError`), bad ``radius``/``n_exchange``/staggering.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import implicitglobalgrid_tpu as igg
import implicitglobalgrid_tpu_torch as tg
from implicitglobalgrid_tpu.models import init_acoustic3d as j_init_acoustic
from implicitglobalgrid_tpu.models import init_diffusion2d as j_init_diffusion2d
from implicitglobalgrid_tpu.models import init_diffusion3d as j_init_diffusion3d
from implicitglobalgrid_tpu.models import init_stokes3d as j_init_stokes
from implicitglobalgrid_tpu.models import run_acoustic as j_run_acoustic
from implicitglobalgrid_tpu.models import run_diffusion as j_run_diffusion
from implicitglobalgrid_tpu.models import run_stokes as j_run_stokes
from implicitglobalgrid_tpu.ops.overlap import hide_communication as j_hide
from implicitglobalgrid_tpu.ops.stencil import d_xa, d_xi, d_ya, d_yi, d_za, d_zi
from implicitglobalgrid_tpu.utils.compat import shard_map
from implicitglobalgrid_tpu_torch.models import common as tcommon
from implicitglobalgrid_tpu_torch.models import (
    acoustic_state_from_numpy, init_acoustic3d, init_diffusion3d, init_stokes3d, run_acoustic,
    run_diffusion, run_stokes, state_from_numpy, stokes_state_from_numpy,
)
from implicitglobalgrid_tpu_torch.ops import overlap as tov
from implicitglobalgrid_tpu_torch.ops.fields import block_slices
from torch_port_util import clean_torch_grid, init_both, to_np  # noqa: F401

TOL = {np.float32: dict(rtol=1e-5, atol=1e-4), np.float64: dict(rtol=1e-12, atol=1e-12)}
SPEC = P("gx", "gy", "gz")
CONSTS = dict(lam=1.0, dt=0.0123, dx=0.37, dy=0.41, dz=0.29)


def _rand(shape, seed, lo=0.0):
    return lo + np.random.default_rng(seed).random(shape)


def _j_update(c):
    def f(T, Cp):
        qx = -c["lam"] * d_xi(T) / c["dx"]
        qy = -c["lam"] * d_yi(T) / c["dy"]
        qz = -c["lam"] * d_zi(T) / c["dz"]
        dT = (-d_xa(qx) / c["dx"] - d_ya(qy) / c["dy"] - d_za(qz) / c["dz"]) \
            / Cp[1:-1, 1:-1, 1:-1]
        return T.at[1:-1, 1:-1, 1:-1].add(c["dt"] * dT)
    return f


def _t_update(c):
    """The same update on one block of the port (constants as 0-d tensors
    of the block's dtype, as the port's plain route rounds them)."""
    def f(T, Cp):
        k = {n: torch.tensor(v, dtype=T.dtype) for n, v in c.items()}
        qx = -k["lam"] * tg.d_xi(T) / k["dx"]
        qy = -k["lam"] * tg.d_yi(T) / k["dy"]
        qz = -k["lam"] * tg.d_zi(T) / k["dz"]
        dT = (-tg.d_xa(qx) / k["dx"] - tg.d_ya(qy) / k["dy"] - tg.d_za(qz) / k["dz"]) \
            / tg.inn(Cp)
        out = T.clone()
        tg.inn(out).add_(k["dt"] * dT)
        return out
    return f


def _plain(update, T, *aux):
    """Update every block, then `local_update_halo`: the plain order."""
    gg = tg.global_grid()
    loc = tuple(int(s) // int(b) for s, b in zip(T.shape, gg.box))
    new = T.clone()
    for sl in block_slices(T.shape, loc):
        new[sl] = update(T[sl], *(a[sl] for a in aux))
    return tg.local_update_halo(new)


def _both(nx, dims, periods, dtype=np.float64, steps=1):
    """(port plain, port overlapped, JAX overlapped) after ``steps`` steps
    of the diffusion update from seeded inputs."""
    init_both(nx, nx, nx, dimx=dims[0], dimy=dims[1], dimz=dims[2], periodx=periods[0],
              periody=periods[1], periodz=periods[2], nranks=int(np.prod(dims)))
    gg = igg.global_grid()
    shape = tuple(int(d) * nx for d in dims)
    T0, Cp = _rand(shape, 1).astype(dtype), _rand(shape, 2, 1.0).astype(dtype)
    upd = _t_update(CONSTS)
    jupd = _j_update(CONSTS)

    def jstep(t, c):
        for _ in range(steps):
            t = j_hide(jupd, t, c, radius=1)
        return t

    ref = np.asarray(jax.jit(shard_map(jstep, mesh=gg.mesh, in_specs=(SPEC, SPEC),
                                       out_specs=SPEC))(igg.device_put_g(T0),
                                                        igg.device_put_g(Cp)))
    t, c = torch.from_numpy(T0), torch.from_numpy(Cp)
    a, b = t, t
    for _ in range(steps):
        a = _plain(upd, a, c)
        b = tg.hide_communication(upd, b, c, radius=1)
    return a, b, ref


@pytest.mark.parametrize("periods,dims", [
    ((0, 0, 0), (2, 2, 2)),
    ((1, 1, 1), (2, 2, 2)),
    ((1, 0, 1), (4, 2, 1)),
    ((1, 1, 1), (1, 1, 1)),   # self-neighbour path
])
def test_overlapped_equals_plain(periods, dims):
    a, b, ref = _both(12, dims, periods)
    assert torch.equal(a, b)
    assert np.allclose(to_np(b), ref, **TOL[np.float64])


def test_overlapped_multiple_steps():
    a, b, ref = _both(12, (2, 2, 2), (1, 0, 0), steps=5)
    assert torch.equal(a, b)
    assert np.allclose(to_np(b), ref, **TOL[np.float64])


def test_overlapped_float32():
    a, b, ref = _both(12, (2, 2, 2), (1, 0, 1), dtype=np.float32, steps=3)
    assert torch.equal(a, b)
    assert np.allclose(to_np(b), ref, **TOL[np.float32])


def test_thin_block_fallback(monkeypatch):
    """A block too thin to split takes the plain order: one update a block,
    no shells."""
    calls = []
    upd = _t_update(CONSTS)

    def counted(*a):
        calls.append(tuple(a[0].shape))
        return upd(*a)

    a, b, ref = _both(5, (2, 2, 2), (0, 0, 0))
    assert torch.equal(a, b)
    assert np.allclose(to_np(b), ref, **TOL[np.float64])
    t = torch.from_numpy(_rand((10, 10, 10), 3))
    tg.hide_communication(counted, t, t + 1.0)
    assert calls == [(5, 5, 5)] * 8


def _v_updates(p):
    def dP(A, d):
        n = A.shape[d]
        return A.narrow(d, 1, n - 1) - A.narrow(d, 0, n - 1)

    def t_upd(vx, vy, vz, Pc):
        c = {k: torch.tensor(v, dtype=Pc.dtype) for k, v in
             dict(cv=-p.dt / p.rho, dx=p.dx, dy=p.dy, dz=p.dz).items()}
        out = []
        for ax, V in enumerate((vx, vy, vz)):
            U = V.clone()
            inner = U.narrow(ax, 1, V.shape[ax] - 2)
            inner.copy_(inner + (c["cv"] * dP(Pc, ax)) / c["d" + "xyz"[ax]])
            out.append(U)
        return tuple(out)

    def j_upd(vx, vy, vz, Pc):
        def jdP(A, d):
            n = A.shape[d]
            return jax.lax.slice_in_dim(A, 1, n, axis=d) - jax.lax.slice_in_dim(A, 0, n - 1,
                                                                                axis=d)
        vx = vx.at[1:-1, :, :].add(-p.dt / p.rho * jdP(Pc, 0) / p.dx)
        vy = vy.at[:, 1:-1, :].add(-p.dt / p.rho * jdP(Pc, 1) / p.dy)
        vz = vz.at[:, :, 1:-1].add(-p.dt / p.rho * jdP(Pc, 2) / p.dz)
        return vx, vy, vz

    return t_upd, j_upd


def test_multi_field_overlap_staggered_equals_plain():
    """The multi-field form on the acoustic V round's three face-staggered
    outputs: one exchange round of all three, the values of the plain
    order."""
    init_both(12, 12, 12, dimx=2, dimy=2, dimz=2, periodx=1)
    gg = igg.global_grid()
    _, p = j_init_acoustic(dtype=np.float64)
    shapes = [(24, 24, 24), (26, 24, 24), (24, 26, 24), (24, 24, 26)]
    arrs = [_rand(s, 10 + k) for k, s in enumerate(shapes)]
    t_upd, j_upd = _v_updates(p)
    specs = (SPEC,) * 4
    ref = jax.jit(shard_map(lambda vx, vy, vz, Pc: j_hide(j_upd, (vx, vy, vz), Pc, radius=1),
                            mesh=gg.mesh, in_specs=specs, out_specs=specs[:3]))(
        *[igg.device_put_g(a) for a in arrs[1:]], igg.device_put_g(arrs[0]))
    ts = [torch.from_numpy(a) for a in arrs]
    got = tg.hide_communication(t_upd, tuple(ts[1:]), ts[0], radius=1)
    locs = [(12, 12, 12), (13, 12, 12), (12, 13, 12), (12, 12, 13)]
    plain = [V.clone() for V in ts[1:]]
    for sls in zip(*(block_slices(a.shape, loc) for a, loc in zip(ts, locs))):
        new = t_upd(*(V[s] for V, s in zip(ts[1:], sls[1:])), ts[0][sls[0]])
        for k in range(3):
            plain[k][sls[k + 1]] = new[k]
    plain = tg.local_update_halo(*plain)
    for g, pl, r in zip(got, plain, ref):
        assert torch.equal(g, pl)
        assert np.allclose(to_np(g), np.asarray(r), **TOL[np.float64])


def _diffusion_models(j_init, grid_args, grid_kw, dtype):
    init_both(*grid_args, **grid_kw)
    T, Cp, p = j_init(dtype=dtype)
    T = T + igg.device_put_g(_rand(T.shape, 5).astype(dtype))
    t, c, q = state_from_numpy(np.asarray(T), np.asarray(Cp), dataclasses.asdict(p), "cpu")
    ref = np.asarray(j_run_diffusion(T, Cp, dataclasses.replace(p, overlap=True), 6,
                                     nt_chunk=3, impl="xla"))
    a = run_diffusion(t, c, q, 6, nt_chunk=3, impl="plain")
    b = run_diffusion(t, c, dataclasses.replace(q, overlap=True), 6, nt_chunk=3, impl="plain")
    return a, b, ref


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_diffusion_overlap_matches_plain(dtype):
    a, b, ref = _diffusion_models(j_init_diffusion3d, (8, 8, 8),
                                  dict(dimx=2, dimy=2, dimz=2, periodx=1, periodz=1), dtype)
    assert torch.equal(a, b)
    assert np.allclose(to_np(b), ref, **TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_diffusion2d_overlap_matches_plain(dtype):
    a, b, ref = _diffusion_models(j_init_diffusion2d, (8, 8, 1),
                                  dict(dimx=2, dimy=2, periodx=1), dtype)
    assert torch.equal(a, b)
    assert np.allclose(to_np(b), ref, **TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_acoustic_overlap_matches_plain(dtype):
    init_both(12, 12, 12, dimx=2, dimy=2, dimz=2, periodx=1, periody=1)
    state, p = j_init_acoustic(dtype=dtype)
    state = tuple(a + igg.device_put_g(_rand(a.shape, 20 + k).astype(dtype))
                  for k, a in enumerate(state))
    ts, tp = acoustic_state_from_numpy(*(np.asarray(a) for a in state), dataclasses.asdict(p),
                                       "cpu")
    ref = j_run_acoustic(state, dataclasses.replace(p, overlap=True), 4, nt_chunk=2,
                         impl="xla")
    a = run_acoustic(ts, tp, 4, nt_chunk=2, impl="plain")
    b = run_acoustic(ts, dataclasses.replace(tp, overlap=True), 4, nt_chunk=2, impl="plain")
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == np.float32 else TOL[np.float64]
    for x, y, r in zip(a, b, ref):
        assert torch.equal(x, y)
        assert np.allclose(to_np(y), np.asarray(r), **tol)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_stokes_overlap_matches_plain(dtype):
    """Held against the port's plain Stokes (bitwise) and JAX's plain
    ``impl="xla"`` Stokes (the port's Stokes model tests' bounds)."""
    init_both(12, 12, 12, dimx=2, dimy=2, dimz=2)
    state, p = j_init_stokes(dtype=dtype)
    state = (*state[:7], igg.device_put_g(_rand(state[7].shape, 30).astype(dtype)))
    ts, tp = stokes_state_from_numpy(*(np.asarray(a) for a in state), dataclasses.asdict(p),
                                     "cpu")
    ref = j_run_stokes(state, p, 6, nt_chunk=3, impl="xla")
    a = run_stokes(ts, tp, 6, nt_chunk=3, impl="plain")
    b = run_stokes(ts, dataclasses.replace(tp, overlap=True), 6, nt_chunk=3, impl="plain")
    for x, y, r in zip(a, b, ref):
        assert torch.equal(x, y)
        r = np.asarray(r)
        if dtype == np.float32:
            assert np.allclose(to_np(y), r, rtol=1e-5, atol=1e-5 * max(1e-30, np.abs(r).max()))
        else:
            assert np.allclose(to_np(y), r, **TOL[np.float64])


def test_phases_in_order(monkeypatch):
    """Shells first, then the interior, then the exchange of the shells
    (the order the side stream needs on a CUDA grid): the interior is
    enqueued before the exchange blocks the host."""
    tg.init_global_grid(12, 12, 12, dimx=2, dimy=1, dimz=1, device_type="cpu", quiet=True)
    events = []
    upd = _t_update(CONSTS)

    def spy_update(T, Cp):
        events.append(("update", tuple(T.shape)))
        return upd(T, Cp)

    lu = tov.local_update_halo

    def spy_exchange(*a, **k):
        events.append(("exchange",))
        return lu(*a, **k)

    monkeypatch.setattr(tov, "local_update_halo", spy_exchange)
    t = torch.from_numpy(_rand((24, 12, 12), 4))
    tg.hide_communication(spy_update, t, t + 1.0)
    # 2 blocks along x: left and right shells of each (ol + r = 3 cells),
    # then each interior grown by r ([1, 11))
    assert events == [("update", (3, 12, 12))] * 4 + [("update", (10, 12, 12))] * 2 \
        + [("exchange",)]
    assert tov.side_stream(t.device) is None  # the CPU: no stream


def test_interior_first_step_and_refusals(monkeypatch):
    tg.init_global_grid(12, 12, 12, dimx=2, dimy=2, dimz=2, nranks=8, device_type="cpu",
                        quiet=True)
    t = torch.from_numpy(_rand((24, 24, 24), 6))
    c = t + 1.0
    upd = _t_update(CONSTS)
    a = tcommon.interior_first_step(lambda T, Cp: (upd(T, Cp), Cp.clone()), (t, c),
                                    radius=1, n_exchange=1)
    assert torch.equal(a[0], tg.hide_communication(upd, t, c))
    assert torch.equal(a[1], c)   # not exchanged: its own values
    IA = tg.exceptions.InvalidArgumentError
    # a wire format reaches the shells' exchange (argument and environment)
    monkeypatch.setenv("IGG_HALO_WIRE_DTYPE", "bf16")
    wired = _plain(upd, t, c)
    assert torch.equal(tg.hide_communication(upd, t, c), wired)
    monkeypatch.delenv("IGG_HALO_WIRE_DTYPE")
    assert torch.equal(tg.hide_communication(upd, t, c, wire_dtype="bf16"), wired)
    assert not torch.equal(tg.hide_communication(upd, t, c), wired)
    with pytest.raises(IA):
        tg.hide_communication(upd, t, c, wire_dtype="bf17")
    for kw in (dict(radius=-1), dict(n_exchange=2)):
        with pytest.raises(IA):
            tg.hide_communication(upd, t, c, **kw)
    with pytest.raises(IA):
        tg.hide_communication(lambda *a: a, (t, c), halowidths=(1, 1, 1))
    with pytest.raises(IA):   # aux two cells wider than the output
        tg.hide_communication(upd, t, torch.zeros(28, 24, 24, dtype=t.dtype))
    with pytest.raises(IA):
        tg.hide_communication(lambda T, Cp: (T, T), t, c)
    for init in (init_diffusion3d, init_acoustic3d, init_stokes3d):
        assert init(overlap=True)[-1].overlap
