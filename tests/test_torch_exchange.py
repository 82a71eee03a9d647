"""Port parity of the multi-block routes: the fused step + exchange (3-D and
2-D) and the combined one-pass `update_halo`, against the JAX package's
Pallas routes in interpret mode.

- the port picks the JAX route: `step_exchange_modes` and the halo tier
  (`halo_route`) equal JAX's on the grids of `tests/test_pallas_stencil.py`
  and `tests/test_update_halo.py`;
- 10-step trajectories from the SAME state (`state_from_numpy`) match JAX's
  ``impl="pallas_interpret"`` to the JAX suite's multi-step bounds, f32
  rtol 1e-5 / atol 1e-4 (`tests/test_pallas_stencil.py:194`), f64 1e-12;
- `update_halo` on multi-block 3-D grids equals JAX's combined tier
  (`_FORCE_PALLAS_WRITE_INTERPRET`) BITWISE: halo movement is pure copies;
- `update_slab` matches `_xla_update_slab` (f64 1e-12; f32 rtol 2e-6 /
  atol 2e-5, the ulp bounds of `tests/test_pallas_stencil.py:21`).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import implicitglobalgrid_tpu as igg
import implicitglobalgrid_tpu.ops.halo as jhalo
import implicitglobalgrid_tpu_torch as tg
import implicitglobalgrid_tpu_torch.models.diffusion as tdiff
from implicitglobalgrid_tpu.models import init_diffusion2d as j_init2d
from implicitglobalgrid_tpu.models import init_diffusion3d as j_init3d
from implicitglobalgrid_tpu.models import run_diffusion as j_run
from implicitglobalgrid_tpu.ops import pallas_stencil as ps
from implicitglobalgrid_tpu_torch.models import run_diffusion, state_from_numpy
from implicitglobalgrid_tpu_torch.ops import cuda_stencil as cs
from implicitglobalgrid_tpu_torch.ops.halo import halo_route
from torch_port_util import clean_torch_grid, init_both, to_np  # noqa: F401

TOL = {np.float32: dict(rtol=1e-5, atol=1e-4),
       np.float64: dict(rtol=1e-12, atol=1e-12)}
ULP_TOL = {np.float32: dict(rtol=2e-6, atol=2e-5),
           np.float64: dict(rtol=1e-12, atol=1e-12)}


def _kw(dims, periods, **extra):
    kw = {f"dim{a}": d for a, d in zip("xyz", dims)}
    kw.update({f"period{a}": q for a, q in zip("xyz", periods)})
    kw.update(extra)
    return kw


# 3-D: the grids of tests/test_pallas_stencil.py:167-172 (local 8x8x16)
GRIDS3 = {
    "all multi-rank periodic": ((2, 2, 2), (1, 1, 1)),
    "all multi-rank PROC_NULL edges": ((2, 2, 2), (0, 0, 0)),
    "multi x only": ((2, 1, 1), (1, 0, 0)),
    "self x + PROC_NULL y + 4-rank z": ((1, 2, 4), (1, 0, 1)),
}
# 2-D: tests/test_pallas_stencil.py:221-225 (local 16x16)
GRIDS2 = {
    "all self-neighbour": ((1, 1, 1), (1, 1, 0)),
    "all multi-rank periodic": ((2, 2, 1), (1, 1, 0)),
    "PROC_NULL edges": ((2, 2, 1), (0, 0, 0)),
    "multi x only": ((2, 1, 1), (1, 0, 0)),
}
# update_halo: multi-block 3-D grids (local shape, grid keywords)
HALO_GRIDS = {
    "2x2x2 periodic": ((8, 8, 8), _kw((2, 2, 2), (1, 1, 1))),
    "2x2x2 mixed": ((8, 6, 10), _kw((2, 2, 2), (0, 1, 0))),
    "1x2x4 mixed": ((8, 8, 16), _kw((1, 2, 4), (1, 0, 1))),
    "2x2x1 z not exchanging": ((6, 7, 8), _kw((2, 2, 1), (1, 0, 0))),
    "2x1x2 hw 2 on x": ((10, 6, 8), _kw((2, 1, 2), (1, 1, 0), overlaps=(4, 2, 2),
                                        halowidths=(2, 1, 1))),
}


@pytest.fixture
def force_interpret():
    """JAX's Pallas halo tiers in interpret mode (as tests/test_update_halo.py
    runs them), restored afterwards."""
    jhalo._FORCE_PALLAS_WRITE_INTERPRET = True
    try:
        yield
    finally:
        jhalo._FORCE_PALLAS_WRITE_INTERPRET = False


def _jax_tier(shape, hws):
    """The tier JAX's `_exchange_arrays` takes for one field, from its gates
    (self-exchange, then combined, then per-dim)."""
    gg, order = igg.global_grid(), jhalo.DEFAULT_DIMS_ORDER
    if jhalo._self_exchange_plan(gg, shape, hws, order) is not None:
        return "self"
    if jhalo._combined_plan(gg, shape, hws, order) is not None:
        return "combined"
    return "per_dim"


ROUTE_CASES = (
    [((8, 8, 16), _kw(*g), [(8, 8, 16), (9, 8, 16), (8, 8, 17)]) for g in GRIDS3.values()]
    + [((16, 16, 1), _kw(*g), [(16, 16), (17, 16)]) for g in GRIDS2.values()]
    + [((n), kw, [n]) for n, kw in HALO_GRIDS.values()]
    + [((12, 12, 12), _kw((2, 2, 2), (0, 0, 0), overlaps=(4, 4, 4), halowidths=(2, 2, 2)),
        [(12, 12, 12)]),
       ((8, 8, 8), _kw((2, 1, 1), (1, 0, 0)), [(9, 8, 8), (8, 8, 8)]),
       ((8, 8, 8), _kw((1, 1, 1), (1, 1, 1)), [(8, 8, 8)]),
       ((12, 12, 16), _kw((2, 1, 1), (1, 0, 1), overlaps=(4, 2, 2), halowidths=(2, 1, 1)),
        [(12, 12, 16)])]
)


@pytest.mark.parametrize("n,kw,shapes", ROUTE_CASES)
def test_routes_match_jax(n, kw, shapes, force_interpret):
    init_both(*n, **kw)
    jg, pg = igg.global_grid(), tg.global_grid()
    hws = tuple(int(h) for h in jg.halowidths)
    for shape in shapes:
        sds = jax.ShapeDtypeStruct(shape, np.float32)
        assert cs.step_exchange_modes(pg, shape) == ps.step_exchange_modes(jg, sds), shape
        assert halo_route(pg, shape, hws) == _jax_tier(shape, hws), shape


def test_resolve_impl_is_cuda_in_2d_and_3d(monkeypatch):
    tg.init_global_grid(16, 16, 1, device_type="cpu", quiet=True)
    assert tdiff._resolve_impl(None) == "cuda"
    monkeypatch.setenv("IGG_USE_PALLAS", "0")
    tg.finalize_global_grid()
    tg.init_global_grid(8, 8, 8, device_type="cpu", quiet=True)
    assert tdiff._resolve_impl(None) == "plain"
    assert tdiff._resolve_impl("cuda") == "cuda"


def _spy(monkeypatch, name):
    """Count the calls of the route function ``name`` of the diffusion model."""
    calls = []
    fn = getattr(tdiff, name)

    def spy(*a, **k):
        calls.append(1)
        return fn(*a, **k)

    monkeypatch.setattr(tdiff, name, spy)
    return calls


def _port_run(T, Cp, p, nt, **kw):
    t, c, q = state_from_numpy(np.asarray(T), np.asarray(Cp), dataclasses.asdict(p), "cpu")
    got = run_diffusion(t, c, q, nt, nt_chunk=5, **kw)
    assert np.array_equal(to_np(t), np.asarray(T))  # the input is not written
    return to_np(got)


TRAJ3 = [(g, d) for g in GRIDS3 for d in (np.float32, np.float64)]


@pytest.mark.parametrize("grid,dtype", TRAJ3,
                         ids=[f"{g}-{np.dtype(d).name}" for g, d in TRAJ3])
def test_trajectory3d_matches_jax_fused(grid, dtype, monkeypatch):
    init_both(8, 8, 16, **_kw(*GRIDS3[grid]))
    T, Cp, p = j_init3d(dtype=dtype)
    sds = jax.ShapeDtypeStruct((8, 8, 16), dtype)
    assert ps.step_exchange_modes(igg.global_grid(), sds) is not None  # JAX fuses
    ref = np.asarray(j_run(T, Cp, p, 10, nt_chunk=5, impl="pallas_interpret"))
    calls = _spy(monkeypatch, "diffusion3d_step_exchange")
    got = _port_run(T, Cp, p, 10)
    assert len(calls) == 10  # the port took the same route, once a step
    assert np.allclose(got, ref, **TOL[dtype]), grid
    assert not np.allclose(ref, np.asarray(T))


TRAJ2 = [(g, d) for g in GRIDS2 for d in (np.float32, np.float64)]


@pytest.mark.parametrize("grid,dtype", TRAJ2,
                         ids=[f"{g}-{np.dtype(d).name}" for g, d in TRAJ2])
def test_trajectory2d_matches_jax_strip_kernel(grid, dtype, monkeypatch):
    init_both(16, 16, 1, **_kw(*GRIDS2[grid]))
    T, Cp, p = j_init2d(dtype=dtype)
    sds = jax.ShapeDtypeStruct((16, 16), dtype)
    gg = igg.global_grid()
    # JAX really runs its strip kernel here
    assert ps.step_exchange_modes(gg, sds) is not None
    assert ps.strip_rows_2d(sds, interpret=True) is not None
    ref = np.asarray(j_run(T, Cp, p, 10, nt_chunk=5, impl="pallas_interpret"))
    calls = _spy(monkeypatch, "diffusion2d_step_exchange")
    halo = _spy(monkeypatch, "local_update_halo")
    got = _port_run(T, Cp, p, 10)
    assert len(calls) == 10 and not halo
    assert np.allclose(got, ref, **TOL[dtype]), grid
    assert not np.allclose(ref, np.asarray(T))


@pytest.mark.parametrize("n,kw", [((16, 16, 1), _kw((1, 1, 1), (0, 0, 0))),
                                  ((12, 12, 1), _kw((2, 1, 1), (1, 0, 0), overlaps=(4, 2, 2),
                                                    halowidths=(2, 1, 1)))],
                         ids=["single block non-periodic", "hw 2 on x"])
def test_trajectory2d_unfused_matches_jax_xla(n, kw, monkeypatch):
    """Where `step_exchange_modes` refuses a 2-D grid JAX runs XLA; the port
    runs K5 with no received slabs, then `local_update_halo`."""
    init_both(*n, **kw)
    T, Cp, p = j_init2d(dtype=np.float64)
    sds = jax.ShapeDtypeStruct(n[:2], np.float64)
    assert ps.step_exchange_modes(igg.global_grid(), sds) is None
    ref = np.asarray(j_run(T, Cp, p, 10, nt_chunk=5, impl="xla"))
    calls = _spy(monkeypatch, "diffusion2d_step_exchange")
    got = _port_run(T, Cp, p, 10)
    assert len(calls) == 10
    assert np.allclose(got, ref, **TOL[np.float64])


@pytest.mark.parametrize("label", list(HALO_GRIDS))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_update_halo_combined_bitwise(label, dtype, force_interpret, monkeypatch):
    n, kw = HALO_GRIDS[label]
    init_both(*n, **kw)
    hws = tuple(int(h) for h in igg.global_grid().halowidths)
    tier = halo_route(tg.global_grid(), n, hws)
    assert tier == _jax_tier(n, hws)
    assert tier == ("per_dim" if "not exchanging" in label else "combined")
    jcalls = []
    jfn = jhalo._combined_exchange
    monkeypatch.setattr(jhalo, "_combined_exchange",
                        lambda *a, **k: jcalls.append(1) or jfn(*a, **k))
    A = np.random.default_rng(5).standard_normal(
        tuple(np.asarray(tg.global_grid().dims) * np.asarray(n))).astype(dtype)
    ref = np.asarray(igg.update_halo(igg.device_put_g(A)))
    assert bool(jcalls) == (tier == "combined")  # JAX took that tier
    got = to_np(tg.update_halo(tg.device_put_g(A)))
    assert np.array_equal(got, ref), label
    assert not np.array_equal(got, A)


@pytest.mark.parametrize("ndim", [3, 2])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_update_slab_matches_jax(ndim, dtype):
    """Every dim, the send ranges [s-ol, s-ol+1) and [ol-1, ol) and the
    current-halo ranges [0, 1) and [s-1, s), on one random block."""
    shape = (9, 8, 10)[:ndim]
    rng = np.random.default_rng(ndim)
    T = (100 * rng.random(shape)).astype(dtype)
    Cp = (1 + 5 * rng.random(shape)).astype(dtype)
    c = dict(lam=1.0, dt=0.0123, dx=0.37, dy=0.41, dz=0.29)
    jc = {k: dtype(v) for k, v in c.items()}
    if ndim == 2:
        del jc["dz"]
    for dim in range(ndim):
        s = shape[dim]
        starts = [s - 2, 1, 0, s - 1]
        got = cs.update_slab(torch.from_numpy(T), torch.from_numpy(Cp), dim, starts, 1,
                             block=shape, **c)
        for start, g in zip(starts, got):
            ref = np.asarray(ps._xla_update_slab(T, Cp, dim, start, 1, jc))
            assert np.allclose(to_np(g), ref, **ULP_TOL[dtype]), (dim, start)
            assert g.shape == ref.shape


def test_update_slab_blocks_and_width():
    """The stacked form: every block's slab, and a wider slab, against the
    per-block JAX computation."""
    block = (6, 5, 7)
    rng = np.random.default_rng(9)
    T = (100 * rng.random((12, 10, 14))).astype(np.float64)
    Cp = (1 + 5 * rng.random((12, 10, 14))).astype(np.float64)
    c = dict(lam=1.0, dt=0.0123, dx=0.37, dy=0.41, dz=0.29)
    (got,) = cs.update_slab(torch.from_numpy(T), torch.from_numpy(Cp), 1, [2], 2,
                            block=block, **c)
    got = to_np(got)
    assert got.shape == (12, 4, 14)
    for c0, c1, c2 in np.ndindex(2, 2, 2):
        sl = (slice(6 * c0, 6 * c0 + 6), slice(5 * c1, 5 * c1 + 5), slice(7 * c2, 7 * c2 + 7))
        ref = np.asarray(ps._xla_update_slab(T[sl], Cp[sl], 1, 2, 2, c))
        assert np.allclose(got[6 * c0:6 * c0 + 6, 2 * c1:2 * c1 + 2, 7 * c2:7 * c2 + 7], ref,
                           **ULP_TOL[np.float64])
