"""Deep-halo stepping (``comm_every`` > 1) of the port, the twin of
`tests/test_comm_avoid.py`: the interior trajectory of a deep cadence is
BIT-IDENTICAL to cadence 1's (the masked sub-steps skip exactly the cells
the k-wide exchange overwrites), from states built from each cell's
integer global index (`stacked_from_global_index`), so two decompositions
of one implicit grid start bitwise equal:

- diffusion (3-D, k 2 and 3, per-axis ``"z:2"`` and ``"y:2,z:3"``; 2-D),
  the acoustic leapfrog and the Stokes PT iteration, against cadence 1
  on the JAX test's grids (overlap 2) and on the deep grid itself;
- the port's deep runs against the JAX package's on the same inputs
  (f64 1e-12, the port's model tests' bound against ``impl="xla"``);
- the validation and freshness errors, and the refusals of the runners
  that exchange every step;
- the exchange launches a super-step halve at k = 2 (the kernel wrappers'
  calls, which run their plain versions on the CPU: `launch_counts`
  counts only launches on the card).
"""

import dataclasses

import numpy as np
import pytest
import torch

import implicitglobalgrid_tpu as igg
import implicitglobalgrid_tpu_torch as tg
from implicitglobalgrid_tpu.models import init_acoustic3d as j_init_acoustic
from implicitglobalgrid_tpu.models import init_diffusion3d as j_init_diffusion
from implicitglobalgrid_tpu.models import init_stokes3d as j_init_stokes
from implicitglobalgrid_tpu.models import run_acoustic as j_run_acoustic
from implicitglobalgrid_tpu.models import run_diffusion as j_run_diffusion
from implicitglobalgrid_tpu.models import run_stokes as j_run_stokes
from implicitglobalgrid_tpu_torch.models import (
    init_acoustic3d, init_diffusion2d, init_diffusion3d, init_stokes3d, make_acoustic_run,
    make_run, make_run_deep, make_step, make_stokes_run, run_acoustic, run_diffusion,
    run_stokes,
)
from implicitglobalgrid_tpu_torch.ops import cuda_halo, cuda_stencil
from implicitglobalgrid_tpu_torch.utils.exceptions import (
    IncoherentArgumentError, InvalidArgumentError,
)
from torch_port_util import (  # noqa: F401
    clean_torch_grid, init_both, stacked_from_global_index, to_np,
)

F64 = dict(rtol=1e-12, atol=1e-12)


def _fT(x, y, z):
    return 100 * np.exp(-((x / 7.0 - 1) ** 2) - ((y / 5.0 - 1) ** 2) - ((z / 6.0 - 1) ** 2))


def _fCp(x, y, z):
    return 1.0 + np.exp(-((x / 9.0 - 1) ** 2) - ((y / 8.0 - 1) ** 2) - ((z / 7.0 - 1) ** 2))


def _fP(x, y, z):
    return np.exp(-((x / 7.0 - 1) ** 2) - ((y / 5.0 - 1) ** 2) - ((z / 6.0 - 1) ** 2))


def _frhog(x, y, z):
    return np.exp(-((x / 6.0 - 1) ** 2) - ((y / 5.0 - 1) ** 2) - ((z / 7.0 - 1) ** 2))


def _grid(ln, hw, periods, dims=(2, 2, 2), jax=False):
    """(Re-)initialize the port's grid (and with ``jax`` the JAX package's)
    of ``ln`` blocks, halowidths ``hw`` and overlaps ``2*hw`` per dim."""
    kw = dict(dimx=dims[0], dimy=dims[1], dimz=dims[2], periodx=periods[0],
              periody=periods[1], periodz=periods[2], overlaps=tuple(2 * h for h in hw),
              halowidths=tuple(hw))
    if tg.grid_is_initialized():
        tg.finalize_global_grid()
    if jax:
        if igg.grid_is_initialized():
            igg.finalize_global_grid()
        init_both(*ln, **kw)
    else:
        tg.init_global_grid(*ln, device_type="cpu", quiet=True, **kw)


def _field(ln, hw, periods, fn, dims=(2, 2, 2)):
    return stacked_from_global_index(ln, tuple(2 * h for h in hw), dims, periods, fn)


def _diffusion(ln, comm_every, hw, nt, periods, impl=None):
    """Gathered interior after ``nt`` diffusion steps at cadence
    ``comm_every``."""
    _grid(ln, hw, periods)
    _, _, p = init_diffusion3d(dtype=torch.float64, comm_every=comm_every)
    T = tg.device_put_g(_field(ln, hw, periods, _fT))
    Cp = tg.device_put_g(_field(ln, hw, periods, _fCp))
    return tg.gather_interior(run_diffusion(T, Cp, p, nt, nt_chunk=nt, impl=impl))


def _cube(n):
    return tuple(n) if isinstance(n, (tuple, list)) else (n,) * 3


# local sizes giving the SAME implicit global grid for k = 1 (overlap 2) and
# the deep grid (overlap 2k): non-periodic dims*(n-ol)+ol, periodic dims*(n-ol)
@pytest.mark.parametrize("k,periods,n1,n2", [
    (2, (0, 0, 0), 8, 9),            # global 14^3 both
    (2, (1, 1, 1), 8, 10),           # global 12^3 both
    (2, (1, 0, 0), 8, (10, 9, 9)),   # mixed
    (3, (1, 1, 1), 8, 12),           # three masked sub-steps an exchange
], ids=["k2-walls", "k2-periodic", "k2-mixed", "k3-periodic"])
def test_diffusion_deep_bitwise_equal(k, periods, n1, n2):
    nt = 12
    a = _diffusion(_cube(n1), 1, (1, 1, 1), nt, periods, impl="plain")
    b = _diffusion(_cube(n2), k, (k, k, k), nt, periods)
    assert a.shape == b.shape
    assert np.array_equal(a, b), f"max diff {np.max(np.abs(a - b))}"


@pytest.mark.parametrize("comm_every,n2,hw", [
    ("z:2", (8, 8, 10), (1, 1, 2)),
    ("y:2,z:3", (8, 10, 12), (1, 2, 3)),   # cycle 6: each axis at its own rate
])
def test_diffusion_per_axis_bitwise_equal(comm_every, n2, hw):
    nt = 6
    a = _diffusion((8, 8, 8), 1, (1, 1, 1), nt, (1, 1, 1), impl="plain")
    b = _diffusion(n2, comm_every, hw, nt, (1, 1, 1))
    assert np.array_equal(a, b), f"max diff {np.max(np.abs(a - b))}"


@pytest.mark.parametrize("comm_every", [2, "x:2,y:2,z:2"])
def test_diffusion_deep_equals_cadence_one_on_its_grid(comm_every):
    """On the deep grid itself (halowidth 2 every step at cadence 1), and
    the per-axis spelling of the uniform cadence is one scheme."""
    a = _diffusion((10, 10, 10), 1, (2, 2, 2), 4, (1, 1, 1), impl="plain")
    b = _diffusion((10, 10, 10), comm_every, (2, 2, 2), 4, (1, 1, 1))
    assert np.array_equal(a, b)


def test_diffusion2d_deep_bitwise_equal():
    def run2d(n, k, nt=8):
        tg.init_global_grid(n, n, 1, dimx=2, dimy=2, dimz=0, periodx=1, periody=1,
                            overlaps=(2 * k,) * 3, halowidths=(k,) * 3, device_type="cpu",
                            quiet=True)
        _, _, p = init_diffusion2d(dtype=torch.float64)
        p = dataclasses.replace(p, comm_every=k)
        S3 = stacked_from_global_index((n, n, 2), (2 * k,) * 3, (2, 2, 1), (1, 1, 0),
                                       lambda x, y, z: 100 * np.exp(-((x / 7.0 - 1) ** 2)
                                                                    - ((y / 5.0 - 1) ** 2)))
        T = tg.device_put_g(S3[:, :, 0])
        Cp = tg.device_put_g(np.full_like(S3[:, :, 0], 2.0))
        out = run_diffusion(T, Cp, p, nt, nt_chunk=nt, impl=None if k > 1 else "plain")
        got = tg.gather_interior(out)
        tg.finalize_global_grid()
        return got

    a = run2d(8, 1)
    b = run2d(10, 2)
    assert a.shape == b.shape and np.array_equal(a, b)


def _acoustic(ln, comm_every, hw, periods, nt=8):
    _grid(ln, hw, periods)
    state, p = init_acoustic3d(dtype=torch.float64, comm_every=comm_every)
    P = tg.device_put_g(_field(ln, hw, periods, _fP))
    out = run_acoustic((P, *state[1:]), p, nt, nt_chunk=nt,
                       impl="plain" if comm_every == 1 else None)
    return [tg.gather_interior(f) for f in out]


@pytest.mark.parametrize("periods,n1,n2,comm_every,hw", [
    ((1, 1, 1), 8, 10, 2, (2, 2, 2)),
    ((0, 0, 0), 8, 9, 2, (2, 2, 2)),          # walls: boundary faces never update
    ((1, 0, 0), 8, (10, 9, 9), 2, (2, 2, 2)),
    ((1, 0, 1), 8, (8, 8, 10), "z:2", (1, 1, 2)),
], ids=["periodic", "walls", "mixed", "z2"])
def test_acoustic_deep_bitwise_equal(periods, n1, n2, comm_every, hw):
    a = _acoustic(_cube(n1), 1, (1, 1, 1), periods)
    b = _acoustic(_cube(n2), comm_every, hw, periods)
    for fa, fb, name in zip(a, b, ("P", "Vx", "Vy", "Vz")):
        assert fa.shape == fb.shape, name
        assert np.array_equal(fa, fb), f"{name}: max {np.max(np.abs(fa - fb))}"


def _stokes(n, comm_every, hw, periods, nt=6):
    _grid(_cube(n), hw, periods)
    state, p = init_stokes3d(dtype=torch.float64, comm_every=comm_every)
    rhog = tg.device_put_g(_field(_cube(n), hw, periods, _frhog))
    out = run_stokes((*state[:7], rhog), p, nt, nt_chunk=nt,
                     impl="plain" if comm_every == 1 else None)
    return [tg.gather_interior(f) for f in out]


def test_stokes_deep_bitwise_equal():
    """The PT iteration's dependency radius is 2: k = 2 runs on a
    halowidth-4 grid with the 7-field exchange. Eager PyTorch computes a
    cell the same wherever it lies, so the trajectory is bitwise cadence
    1's (the JAX package's XLA:CPU rounds ~1 ulp apart, hence its 1e-12
    bound). dV is skipped: its halo copies are undefined in the base
    scheme, which never exchanges it."""
    a = _stokes(9, 1, (1, 1, 1), (0, 0, 0))
    b = _stokes(12, 2, (4, 4, 4), (0, 0, 0))
    names = ("P", "Vx", "Vy", "Vz", "dVx", "dVy", "dVz", "rhog")
    for fa, fb, name in zip(a, b, names):
        if name.startswith("dV"):
            continue
        assert fa.shape == fb.shape, name
        assert np.array_equal(fa, fb), f"{name}: max {np.max(np.abs(fa - fb))}"


def test_deep_runs_match_jax():
    """The port's deep runs against the JAX package's from the same
    inputs: diffusion (k 2, per-axis z:2), acoustic and Stokes (k 2)."""
    ln, hw, per = (10, 10, 10), (2, 2, 2), (1, 1, 1)
    for ce in (2, "z:2"):
        _grid(ln, hw, per, jax=True)
        T, Cp = (_field(ln, hw, per, f) for f in (_fT, _fCp))
        _, _, jp = j_init_diffusion(dtype=np.float64, comm_every=ce)
        _, _, tp = init_diffusion3d(dtype=torch.float64, comm_every=ce)
        ref = j_run_diffusion(igg.device_put_g(T), igg.device_put_g(Cp), jp, 4, nt_chunk=4)
        got = run_diffusion(tg.device_put_g(T), tg.device_put_g(Cp), tp, 4, nt_chunk=4)
        assert np.allclose(to_np(got), np.asarray(ref), **F64)
    _grid(ln, hw, per, jax=True)
    P = _field(ln, hw, per, _fP)
    js, jp = j_init_acoustic(dtype=np.float64, comm_every=2)
    ts, tp = init_acoustic3d(dtype=torch.float64, comm_every=2)
    ref = j_run_acoustic((igg.device_put_g(P), *js[1:]), jp, 4, nt_chunk=4)
    got = run_acoustic((tg.device_put_g(P), *ts[1:]), tp, 4, nt_chunk=4)
    for a, b in zip(got, ref):
        assert np.allclose(to_np(a), np.asarray(b), **F64)
    ln, hw, per = (12, 12, 12), (4, 4, 4), (0, 0, 0)
    _grid(ln, hw, per, jax=True)
    rhog = _field(ln, hw, per, _frhog)
    js, jp = j_init_stokes(dtype=np.float64, comm_every=2)
    ts, tp = init_stokes3d(dtype=torch.float64, comm_every=2)
    ref = j_run_stokes((*js[:7], igg.device_put_g(rhog)), jp, 4, nt_chunk=4)
    got = run_stokes((*ts[:7], tg.device_put_g(rhog)), tp, 4, nt_chunk=4)
    for a, b in zip(got, ref):
        b = np.asarray(b)
        assert np.allclose(to_np(a), b, rtol=1e-12, atol=1e-12 * max(1.0, np.abs(b).max()))


def test_comm_every_validation():
    """`tests/test_comm_avoid.py:461`: a halowidth-1 grid cannot carry a
    2-deep exchange; nt must be a multiple of the cycle; the kernel route
    and the runners that exchange every step refuse a deep cadence."""
    _grid((8, 8, 8), (1, 1, 1), (0, 0, 0))
    T, Cp, p = init_diffusion3d(dtype=torch.float64, comm_every=2)
    with pytest.raises(IncoherentArgumentError):
        run_diffusion(T, Cp, p, 4)
    tg.finalize_global_grid()
    tg.init_global_grid(9, 9, 9, dimx=2, dimy=2, dimz=2, overlaps=(4, 4, 4),
                        halowidths=(2, 2, 2), device_type="cpu", quiet=True)
    T, Cp, p = init_diffusion3d(dtype=torch.float64, comm_every=2)
    with pytest.raises(InvalidArgumentError):
        run_diffusion(T, Cp, p, 7)
    with pytest.raises(InvalidArgumentError):
        run_diffusion(T, Cp, p, 4, impl="cuda")
    for make in (lambda: make_run(p, 2), lambda: make_step(p)):
        with pytest.raises(InvalidArgumentError):
            make()
    state, q = init_acoustic3d(dtype=torch.float64, comm_every=2)
    with pytest.raises(InvalidArgumentError):
        make_acoustic_run(q, 2)
    state, q = init_stokes3d(dtype=torch.float64, comm_every=2)
    with pytest.raises(InvalidArgumentError):
        make_stokes_run(q, 2)
    with pytest.raises(IncoherentArgumentError):  # radius 2: needs halowidth 4
        run_stokes(state, q, 2)


def test_comm_every_per_axis_validation():
    """`tests/test_comm_avoid.py:489`: the checks fire per axis."""
    from implicitglobalgrid_tpu_torch.models.common import resolve_comm_every

    for bad in ("w:2", "z:0", "z:2,gz:4"):
        with pytest.raises(InvalidArgumentError):
            resolve_comm_every(bad)
    assert str(resolve_comm_every("gz:3")) == "z:3"
    assert resolve_comm_every({"z": 4, "x": 2}).cycle == 4
    tg.init_global_grid(9, 9, 9, dimx=2, dimy=2, dimz=2, overlaps=(4, 4, 2),
                        halowidths=(2, 2, 1), device_type="cpu", quiet=True)
    T, Cp, p = init_diffusion3d(dtype=torch.float64, comm_every="z:2")
    with pytest.raises(IncoherentArgumentError):
        run_diffusion(T, Cp, p, 4)  # z halo too shallow for z:2
    T, Cp, p = init_diffusion3d(dtype=torch.float64, comm_every="x:2")
    assert torch.isfinite(run_diffusion(T, Cp, p, 4, nt_chunk=4)).all()


def test_comm_every_freshness_bound():
    """`tests/test_comm_avoid.py:518`: a block below overlap + k would ship
    stale send slabs: the deep runner refuses."""
    tg.init_global_grid(5, 8, 8, dimx=3, dimy=1, dimz=2, overlaps=(4, 4, 4),
                        halowidths=(2, 2, 2), device_type="cpu", quiet=True)
    T, Cp, p = init_diffusion3d(dtype=torch.float64, comm_every=2)
    with pytest.raises(IncoherentArgumentError):
        run_diffusion(T, Cp, p, 4)   # n_x=5 < ol+k=6


EXCHANGE_WRAPPERS = [(cuda_halo, "halo_write"), (cuda_halo, "halo_write_combined"),
                     (cuda_halo, "halo_self_exchange"), (cuda_halo, "wire_pack"),
                     (cuda_halo, "halo_write_multi"), (cuda_stencil, "exchange_slabs")]


def _count_exchange_launches(monkeypatch):
    """Count the exchange kernels' wrapper calls (one launch each on the
    card; on the CPU each runs its plain version)."""
    calls = []
    for mod, name in EXCHANGE_WRAPPERS:
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            calls.append(_name)
            return _fn(*a, **k)

        monkeypatch.setattr(mod, name, wrapped)
    return calls


@pytest.mark.parametrize("model", ["diffusion", "acoustic"])
def test_comm_every_cuts_exchange_launches(model, monkeypatch):
    """The counterpart of `test_comm_every_halves_permutes`: at k = 2 one
    2-wide exchange a super-step replaces one a step, so diffusion's
    exchange launches a physical step halve; the acoustic super-step's one
    4-field round replaces two rounds a step (V, then P): a quarter."""
    tg.init_global_grid(9, 9, 9, dimx=2, dimy=2, dimz=2, overlaps=(4, 4, 4),
                        halowidths=(2, 2, 2), device_type="cpu", quiet=True)
    calls = _count_exchange_launches(monkeypatch)
    if model == "diffusion":
        T, Cp, p = init_diffusion3d(dtype=torch.float64)
        make_run(p, 2, impl="plain")(T, Cp)
        every_step = len(calls)
        calls.clear()
        make_run_deep(dataclasses.replace(p, comm_every=2), 1)(T, Cp)
    else:
        state, p = init_acoustic3d(dtype=torch.float64)
        make_acoustic_run(p, 2, impl="plain")(*state)
        every_step = len(calls)
        calls.clear()
        run_acoustic(state, dataclasses.replace(p, comm_every=2), 2)
    # diffusion: K4s + K2 a dim (hw 2: no K6); acoustic: K8 + K7 a dim
    # for the group (P, Vx, Vy, Vz) where cadence 1 exchanges V and P apart
    assert every_step == (12 if model == "diffusion" else 2 * (6 + 6))
    assert len(calls) == 6, calls
