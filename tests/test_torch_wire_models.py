"""The three models under a halo wire format (``IGG_HALO_WIRE_DTYPE``)
against the JAX package under the same format, from the same state.

The JAX package's fused tiers and plain routes read the variable; so do the
port's kernel routes (the fused diffusion, acoustic and Stokes steps, whose
received slabs cross the wire in the K4s slab pipeline) and its plain,
overlapped and deep routes (`local_update_halo`). Under ``bfloat16``,
``int8`` and ``"z:int8,x:float32"``:

- diffusion (3-D on 2x2x2 periodic and mixed, 2-D on 4x2), 10 steps:
  the kernel route against JAX ``impl="pallas_interpret"`` and the plain
  route against ``impl="xla"``, float32 rtol 1e-5 / atol 1e-4 (the bound
  of `test_torch_diffusion.py`);
- the acoustic leapfrog (2x2x2, periodic and PROC_NULL), 6 steps, both
  routes, rtol/atol 1e-5 (`test_torch_acoustic.py`);
- the Stokes PT iteration (2x2x2, periodic and PROC_NULL), 4 iterations,
  the fused route against ``pallas_interpret`` and the plain route against
  ``xla``, rtol 1e-5 / atol 1e-5 x max|field| (`torch_stokes_util.compare`);
- each model with ``overlap=True`` and with ``comm_every=2`` on their
  grids, against JAX's same runs (the deep Stokes run in float64, as in
  `test_torch_comm_avoid.py`);
- every wired run differs from the exact run where the policy narrows a
  multi-rank dim.
"""

import dataclasses

import numpy as np
import pytest
import torch

import implicitglobalgrid_tpu as igg
import implicitglobalgrid_tpu_torch as tg
from implicitglobalgrid_tpu.models import init_acoustic3d as j_init_acoustic
from implicitglobalgrid_tpu.models import init_diffusion2d as j_init2d
from implicitglobalgrid_tpu.models import init_diffusion3d as j_init3d
from implicitglobalgrid_tpu.models import init_stokes3d as j_init_stokes
from implicitglobalgrid_tpu.models import run_acoustic as j_run_acoustic
from implicitglobalgrid_tpu.models import run_diffusion as j_run_diffusion
from implicitglobalgrid_tpu.models import run_stokes as j_run_stokes
from implicitglobalgrid_tpu.ops.precision import resolve_wire_dtype, wire_format_for
from implicitglobalgrid_tpu_torch.models import (
    acoustic_state_from_numpy, init_acoustic3d, init_diffusion3d, init_stokes3d,
    run_acoustic, run_diffusion, run_stokes, state_from_numpy, stokes_state_from_numpy,
)
from implicitglobalgrid_tpu_torch.ops import cuda_stencil
from torch_port_util import (  # noqa: F401
    clean_torch_grid, init_both, stacked_from_global_index, to_np,
)

FORMATS = ["bfloat16", "int8", "z:int8,x:float32"]
DIFF_TOL = dict(rtol=1e-5, atol=1e-4)
WAVE_TOL = dict(rtol=1e-5, atol=1e-5)
KERNEL, PLAIN = ("pallas_interpret", None), ("xla", "plain")


def _narrows(fmt, dtype, ndim):
    """Whether ``fmt`` narrows ``dtype`` along a multi-rank dim of the grid
    (the JAX package's rule)."""
    gg, wire = tg.global_grid(), resolve_wire_dtype(fmt)
    return any(int(gg.dims[d]) > 1 and wire_format_for(dtype, wire, d) is not None
               for d in range(ndim))


def _stokes_close(got, ref):
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert np.allclose(to_np(g), r, rtol=1e-5, atol=1e-5 * max(1e-30, np.abs(r).max())), \
            float(np.abs(to_np(g) - r).max())


def _differ(got, exact, atol):
    got = got if isinstance(got, tuple) else (got,)
    exact = exact if isinstance(exact, tuple) else (exact,)
    return max(float((a.double() - b.double()).abs().max()) for a, b in zip(got, exact)) > atol


# ---------------------------------------------------------------------------
# diffusion
# ---------------------------------------------------------------------------

DIFF_GRIDS = {
    "2x2x2 periodic": ((8, 8, 8), dict(dimx=2, dimy=2, dimz=2, periodx=1, periody=1,
                                       periodz=1)),
    "2x2x2 mixed": ((8, 6, 10), dict(dimx=2, dimy=2, dimz=2, periody=1)),
    "2-D 4x2": ((8, 6), dict(dimx=4, dimy=2, periodx=1)),
}


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("routes", [KERNEL, PLAIN], ids=["kernel", "plain"])
@pytest.mark.parametrize("grid", list(DIFF_GRIDS))
def test_diffusion_wire_matches_jax(grid, routes, fmt, monkeypatch):
    n, kw = DIFF_GRIDS[grid]
    init_both(*n, **kw)
    T, Cp, p = (j_init2d if len(n) == 2 else j_init3d)(dtype=np.float32)
    t, c, q = state_from_numpy(np.asarray(T), np.asarray(Cp), dataclasses.asdict(p), "cpu")
    exact = run_diffusion(t, c, q, 10, nt_chunk=5, impl=routes[1])
    monkeypatch.setenv("IGG_HALO_WIRE_DTYPE", fmt)
    ref = np.asarray(j_run_diffusion(T, Cp, p, 10, nt_chunk=5, impl=routes[0]))
    slabs = []
    fn = cuda_stencil.exchange_slabs
    monkeypatch.setattr(cuda_stencil, "exchange_slabs",
                        lambda *a, **k: slabs.append(1) or fn(*a, **k))
    got = run_diffusion(t, c, q, 10, nt_chunk=5, impl=routes[1])
    assert np.allclose(to_np(got), ref, **DIFF_TOL), float(np.abs(to_np(got) - ref).max())
    if routes is KERNEL:
        assert slabs   # the fused route's K4s slab pipeline ran
    if _narrows(fmt, np.float32, len(n)):
        assert _differ(got, exact, 10 * DIFF_TOL["atol"])
    else:
        assert torch.equal(got, exact)


def _deep_grid(ln, hw, periods):
    init_both(*ln, dimx=2, dimy=2, dimz=2, periodx=periods[0], periody=periods[1],
              periodz=periods[2], overlaps=tuple(2 * h for h in hw), halowidths=tuple(hw))


def _g(ln, hw, periods, fn):
    return stacked_from_global_index(ln, tuple(2 * h for h in hw), (2, 2, 2), periods, fn)


def _fT(x, y, z):
    return 100 * np.exp(-((x / 7.0 - 1) ** 2) - ((y / 5.0 - 1) ** 2) - ((z / 6.0 - 1) ** 2))


def _fCp(x, y, z):
    return 1.0 + np.exp(-((x / 9.0 - 1) ** 2) - ((y / 8.0 - 1) ** 2) - ((z / 7.0 - 1) ** 2))


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("mode", ["overlap", "comm_every=2"])
def test_diffusion_overlap_and_deep_wire_match_jax(mode, fmt, monkeypatch):
    if mode == "overlap":
        init_both(8, 8, 8, dimx=2, dimy=2, dimz=2, periodx=1, periodz=1)
        T, Cp, p = j_init3d(dtype=np.float32)
        p = dataclasses.replace(p, overlap=True)
        t, c, q = state_from_numpy(np.asarray(T), np.asarray(Cp), dataclasses.asdict(p), "cpu")
        nt = 6
    else:
        ln, hw, per = (10, 10, 10), (2, 2, 2), (1, 1, 1)
        _deep_grid(ln, hw, per)
        T, Cp = (igg.device_put_g(_g(ln, hw, per, f).astype(np.float32)) for f in (_fT, _fCp))
        p = j_init3d(dtype=np.float32, comm_every=2)[2]
        t, c = tg.device_put_g(np.array(T)), tg.device_put_g(np.array(Cp))
        q = init_diffusion3d(dtype=torch.float32, comm_every=2)[2]
        nt = 4
    exact = run_diffusion(t, c, q, nt, nt_chunk=nt, impl="plain")
    monkeypatch.setenv("IGG_HALO_WIRE_DTYPE", fmt)
    ref = np.asarray(j_run_diffusion(T, Cp, p, nt, nt_chunk=nt, impl="xla"))
    got = run_diffusion(t, c, q, nt, nt_chunk=nt, impl="plain")
    assert np.allclose(to_np(got), ref, **DIFF_TOL), float(np.abs(to_np(got) - ref).max())
    assert _differ(got, exact, 10 * DIFF_TOL["atol"])


# ---------------------------------------------------------------------------
# acoustic and Stokes
# ---------------------------------------------------------------------------

MODEL_GRIDS = {"2x2x2 periodic": (1, 1, 1), "2x2x2 PROC_NULL": (0, 0, 0)}


def _init_model(periods, n=(8, 8, 16)):
    init_both(*n, dimx=2, dimy=2, dimz=2, periodx=periods[0], periody=periods[1],
              periodz=periods[2])


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("routes", [KERNEL, PLAIN], ids=["kernel", "plain"])
@pytest.mark.parametrize("grid", list(MODEL_GRIDS))
def test_acoustic_wire_matches_jax(grid, routes, fmt, monkeypatch):
    _init_model(MODEL_GRIDS[grid])
    state, p = j_init_acoustic(dtype=np.float32)
    ts, tp = acoustic_state_from_numpy(*(np.asarray(a) for a in state), dataclasses.asdict(p),
                                       "cpu")
    exact = run_acoustic(ts, tp, 6, nt_chunk=3, impl=routes[1])
    monkeypatch.setenv("IGG_HALO_WIRE_DTYPE", fmt)
    ref = j_run_acoustic(state, p, 6, nt_chunk=3, impl=routes[0])
    got = run_acoustic(ts, tp, 6, nt_chunk=3, impl=routes[1])
    for g, r in zip(got, ref):
        assert np.allclose(to_np(g), np.asarray(r), **WAVE_TOL), \
            float(np.abs(to_np(g) - np.asarray(r)).max())
    assert _differ(got, exact, 10 * WAVE_TOL["atol"])


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("routes", [KERNEL, PLAIN], ids=["kernel", "plain"])
@pytest.mark.parametrize("grid", list(MODEL_GRIDS))
def test_stokes_wire_matches_jax(grid, routes, fmt, monkeypatch):
    _init_model(MODEL_GRIDS[grid])
    state, p = j_init_stokes(dtype=np.float32)
    ts, tp = stokes_state_from_numpy(*(np.asarray(a) for a in state), dataclasses.asdict(p),
                                     "cpu")
    exact = run_stokes(ts, tp, 4, nt_chunk=2, impl=routes[1])
    monkeypatch.setenv("IGG_HALO_WIRE_DTYPE", fmt)
    ref = j_run_stokes(state, p, 4, nt_chunk=2, impl=routes[0])
    got = run_stokes(ts, tp, 4, nt_chunk=2, impl=routes[1])
    _stokes_close(got, ref)
    assert _differ(got, exact, 0.0)


def _fP(x, y, z):
    return np.exp(-((x / 7.0 - 1) ** 2) - ((y / 5.0 - 1) ** 2) - ((z / 6.0 - 1) ** 2))


def _frhog(x, y, z):
    return np.exp(-((x / 6.0 - 1) ** 2) - ((y / 5.0 - 1) ** 2) - ((z / 7.0 - 1) ** 2))


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("mode", ["overlap", "comm_every=2"])
def test_acoustic_overlap_and_deep_wire_match_jax(mode, fmt, monkeypatch):
    if mode == "overlap":
        init_both(12, 12, 12, dimx=2, dimy=2, dimz=2, periodx=1, periody=1)
        state, p = j_init_acoustic(dtype=np.float32)
        p = dataclasses.replace(p, overlap=True)
        ts, tp = acoustic_state_from_numpy(*(np.asarray(a) for a in state),
                                           dataclasses.asdict(p), "cpu")
    else:
        ln, hw, per = (10, 10, 10), (2, 2, 2), (1, 1, 1)
        _deep_grid(ln, hw, per)
        P = _g(ln, hw, per, _fP).astype(np.float32)
        js, p = j_init_acoustic(dtype=np.float32, comm_every=2)
        state = (igg.device_put_g(P), *js[1:])
        t0, tp = init_acoustic3d(dtype=torch.float32, comm_every=2)
        ts = (tg.device_put_g(P), *t0[1:])
    exact = run_acoustic(ts, tp, 4, nt_chunk=4, impl="plain")
    monkeypatch.setenv("IGG_HALO_WIRE_DTYPE", fmt)
    ref = j_run_acoustic(state, p, 4, nt_chunk=4, impl="xla")
    got = run_acoustic(ts, tp, 4, nt_chunk=4, impl="plain")
    for g, r in zip(got, ref):
        assert np.allclose(to_np(g), np.asarray(r), **WAVE_TOL), \
            float(np.abs(to_np(g) - np.asarray(r)).max())
    assert _differ(got, exact, 10 * WAVE_TOL["atol"])


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("mode", ["overlap", "comm_every=2"])
def test_stokes_overlap_and_deep_wire_match_jax(mode, fmt, monkeypatch):
    """The overlapped Stokes run against JAX's plain ``xla`` run (the
    port's overlapped run equals its plain run bitwise; JAX's own Stokes
    overlap test fails on this toolchain), the deep run against JAX's in
    float64 with `test_torch_comm_avoid.py`'s bound (in float32 the two
    packages' deep iterates differ in the last bit, and a bfloat16 wire
    rounds a few such cells to neighbouring bfloat16 values)."""
    if mode == "overlap":
        init_both(12, 12, 12, dimx=2, dimy=2, dimz=2)
        state, p = j_init_stokes(dtype=np.float32)
        ts, tp = stokes_state_from_numpy(*(np.asarray(a) for a in state),
                                         dataclasses.asdict(p), "cpu")
        tp = dataclasses.replace(tp, overlap=True)
    else:
        ln, hw, per = (12, 12, 12), (4, 4, 4), (0, 0, 0)
        _deep_grid(ln, hw, per)
        rhog = _g(ln, hw, per, _frhog)
        js, p = j_init_stokes(dtype=np.float64, comm_every=2)
        state = (*js[:7], igg.device_put_g(rhog))
        t0, tp = init_stokes3d(dtype=torch.float64, comm_every=2)
        ts = (*t0[:7], tg.device_put_g(rhog))
    exact = run_stokes(ts, tp, 4, nt_chunk=4, impl="plain")
    monkeypatch.setenv("IGG_HALO_WIRE_DTYPE", fmt)
    ref = j_run_stokes(state, p, 4, nt_chunk=4, impl="xla")
    got = run_stokes(ts, tp, 4, nt_chunk=4, impl="plain")
    if mode == "overlap":
        _stokes_close(got, ref)
    else:
        for g, r in zip(got, ref):
            r = np.asarray(r)
            assert np.allclose(to_np(g), r, rtol=1e-12, atol=1e-12 * max(1.0, np.abs(r).max()))
    assert _differ(got, exact, 0.0)


def test_acoustic_int8_tiers_differ_as_jax_tiers(monkeypatch):
    """Under int8 the JAX package's acoustic pallas and xla tiers differ by
    whole quantization levels (their per-slab scales cover different
    cells); the port's kernel and plain routes differ by the same amount,
    each matching its JAX tier. Under bfloat16 (no scale) both pairs
    agree."""
    _init_model(MODEL_GRIDS["2x2x2 periodic"])
    state, p = j_init_acoustic(dtype=np.float32)
    ts, tp = acoustic_state_from_numpy(*(np.asarray(a) for a in state), dataclasses.asdict(p),
                                       "cpu")
    dist = {}
    for fmt in ("int8", "bfloat16"):
        monkeypatch.setenv("IGG_HALO_WIRE_DTYPE", fmt)
        jk, jp_ = (j_run_acoustic(state, p, 6, nt_chunk=3, impl=i)
                   for i in ("pallas_interpret", "xla"))
        tk, tp_ = (run_acoustic(ts, tp, 6, nt_chunk=3, impl=i) for i in (None, "plain"))
        dist[fmt] = (max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                         for a, b in zip(jk, jp_)),
                     max(float((a - b).abs().max()) for a, b in zip(tk, tp_)))
    j8, t8 = dist["int8"]
    assert j8 > 100 * WAVE_TOL["atol"] and abs(t8 - j8) <= WAVE_TOL["atol"], dist
    # the budget chip_smoke.py holds the card's routes to: one int8 level of
    # the largest field a step
    level = max(float(np.abs(np.asarray(a)).max()) for a in state) / 127
    assert j8 <= 6 * level, (j8, level)
    assert max(dist["bfloat16"]) <= WAVE_TOL["atol"], dist
