"""Port parity of the acoustic wave model (`models/acoustic.py`, the fused
step K9 with its K4s wave-mode send slabs, `ops/cuda_wave.py`) against the
JAX package, from the SAME state (`acoustic_state_from_numpy`):

- the fused route (the port's default on the CPU, the kernels' plain
  versions) against JAX ``impl="pallas_interpret"`` on the five grids of
  `tests/test_models_wave_stokes.py:93-99` at local 8x8x16 and the plane
  form (10, 8, 16), 6 steps in chunks of 3, whole stacked fields (halos
  included): float32 rtol/atol 1e-5 (the JAX suite's bound, :124),
  float64 1e-12;
- the plain route against JAX ``impl="xla"`` on the same grids;
- bfloat16 states on both routes: the fused route against JAX
  ``pallas_interpret`` (bitwise on one block; on a multi-rank grid bitwise
  off the cells near a block face, whose halos JAX computes with XLA, and
  within 2 bf16 ulps a cell there after a step, within one ulp of each
  field's largest magnitude after 4 steps), the plain route against
  ``xla`` bitwise;
- the K4s wave modes' plain versions against JAX's getters
  (`_make_v_get_slab`, `_make_p_get_slab`) on every field, dim and range;
- model sanity: distributed equals single, the wave propagates, and
  `init_acoustic3d` equals JAX's state and ``dt`` bitwise.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import implicitglobalgrid_tpu as igg
import implicitglobalgrid_tpu_torch as tg
import implicitglobalgrid_tpu_torch.models.acoustic as tac
from implicitglobalgrid_tpu.models import init_acoustic3d as j_init
from implicitglobalgrid_tpu.models import run_acoustic as j_run
from implicitglobalgrid_tpu.ops import pallas_wave as pw
from implicitglobalgrid_tpu_torch.models import (
    acoustic_state_from_numpy, init_acoustic3d, run_acoustic,
)
from implicitglobalgrid_tpu_torch.ops import cuda_wave as cw
from implicitglobalgrid_tpu_torch.ops.staggered import FIELDS
from torch_port_util import clean_torch_grid, init_both, to_np  # noqa: F401

TOL = {np.float32: dict(rtol=1e-5, atol=1e-5), np.float64: dict(rtol=1e-12, atol=1e-12)}
ULP_TOL = {np.float32: dict(rtol=2e-6, atol=2e-5), np.float64: dict(rtol=1e-12, atol=1e-12)}

GRIDS = {  # tests/test_models_wave_stokes.py:93-99, and :127-137
    "all self-neighbour": ((8, 8, 16), (1, 1, 1), (1, 1, 1)),
    "all multi-rank periodic": ((8, 8, 16), (2, 2, 2), (1, 1, 1)),
    "all multi-rank PROC_NULL edges": ((8, 8, 16), (2, 2, 2), (0, 0, 0)),
    "self x + PROC_NULL y + 4-rank z": ((8, 8, 16), (1, 2, 4), (1, 0, 1)),
    "no exchange at all": ((8, 8, 16), (1, 1, 1), (0, 0, 0)),
    "plane form nx=10": ((10, 8, 16), (1, 1, 1), (1, 1, 1)),
}
CASES = [(g, d) for g in GRIDS for d in (np.float32, np.float64)]
IDS = [f"{g}-{np.dtype(d).name}" for g, d in CASES]


def _init(grid):
    n, dims, periods = GRIDS[grid]
    kw = {f"dim{a}": v for a, v in zip("xyz", dims)}
    kw.update({f"period{a}": v for a, v in zip("xyz", periods)})
    init_both(*n, **kw)


def _local(gg, state):
    return tuple(tuple(int(s) // int(gg.dims[d]) for d, s in enumerate(a.shape))
                 for a in state)


def _port_state(state, p):
    return acoustic_state_from_numpy(*(np.asarray(a) for a in state), dataclasses.asdict(p),
                                     "cpu")


def _spy(monkeypatch):
    """Count the fused route's steps (`AcousticStep.__call__`, which a run
    resolves once)."""
    calls = []
    fn = cw.AcousticStep.__call__

    def spy(*a, **k):
        calls.append(1)
        return fn(*a, **k)

    monkeypatch.setattr(cw.AcousticStep, "__call__", spy)
    return calls


def _compare(got, ref, dtype, label):
    for g, r, name in zip(got, ref, ("P", "Vx", "Vy", "Vz")):
        g, r = tg.gather(g), np.asarray(igg.gather(r))
        assert g.shape == r.shape and g.dtype == r.dtype, (label, name)
        assert np.allclose(g, r, **TOL[dtype]), (label, name, float(np.abs(g - r).max()))


@pytest.mark.parametrize("grid,dtype", CASES, ids=IDS)
def test_fused_route_matches_jax_pallas(grid, dtype, monkeypatch):
    _init(grid)
    state, p = j_init(dtype=dtype)
    jmodes = pw.wave_exchange_modes(igg.global_grid(), _local(igg.global_grid(), state))
    tstate, tp = _port_state(state, p)
    modes = cw.wave_exchange_modes(tg.global_grid(), _local(tg.global_grid(), tstate))
    assert modes is not None and modes == jmodes, (modes, jmodes)
    ref = j_run(state, p, 6, nt_chunk=3, impl="pallas_interpret")
    calls = _spy(monkeypatch)
    got = run_acoustic(tstate, tp, 6, nt_chunk=3)
    assert len(calls) == 6  # the port took the fused route, once a step
    for a, b in zip(tstate, state):   # the input is not written
        assert np.array_equal(to_np(a), np.asarray(b))
    _compare(got, ref, dtype, grid)
    assert not np.allclose(to_np(got[0]), np.asarray(state[0]))


@pytest.mark.parametrize("grid,dtype", CASES, ids=IDS)
def test_plain_route_matches_jax_xla(grid, dtype, monkeypatch):
    _init(grid)
    state, p = j_init(dtype=dtype)
    tstate, tp = _port_state(state, p)
    ref = j_run(state, p, 6, nt_chunk=3, impl="xla")
    calls = _spy(monkeypatch)
    got = run_acoustic(tstate, tp, 6, nt_chunk=3, impl="plain")
    assert not calls
    _compare(got, ref, dtype, grid)


def _bf16_ulps(a, b):
    """Per-cell distance in bfloat16 ulps of two bfloat16-valued arrays
    (ordered bit patterns, so a sign change counts every step between)."""
    def key(x):
        u = (np.asarray(x, dtype=np.float32).view(np.int32) >> 16).astype(np.int64)
        return np.where(u < 0, -(u & 0x7FFF), u)
    return np.abs(key(a) - key(b))


def _ulp_of_max(r):
    """One bfloat16 ulp at the largest magnitude of ``r`` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(max(float(np.abs(r).max()), 1e-30))) - 7)


def _face_distance(shape, dims):
    """Per-cell distance, in cells of its own block, of a stacked field to
    the nearest block face along a dim of more than one block: the halos
    there come from send slabs (received, or the block's own on a PROC_NULL
    edge), which JAX computes with XLA."""
    out = np.full(shape, np.iinfo(np.int64).max)
    for d, D in enumerate(dims):
        if int(D) == 1:
            continue
        m = shape[d] // int(D)
        loc = np.arange(shape[d]) % m
        sh = [1, 1, 1]
        sh[d] = shape[d]
        out = np.minimum(out, np.minimum(loc, m - 1 - loc).reshape(sh))
    return out


# (steps, the distance from a face at which every cell is bitwise): the
# cells nearer hold what the send slabs delivered and its spread, which
# reached one cell after a step and two after four in the reading that
# chose these (every field of the three multi-rank grids, steps 1 to 4)
BF16_REACH = {1: 2, 4: 3}


@pytest.mark.parametrize("grid", list(GRIDS))
def test_bf16_fused_route_matches_jax_pallas(grid, monkeypatch):
    """One step, then four, from the same bfloat16 state: the fused route
    (K9's and the K4s wave modes' plain versions, each operation rounded to
    bfloat16 with bfloat16 constants) against JAX's Pallas kernel. On one
    block every cell is bitwise. On a multi-rank grid JAX computes its send
    slabs with XLA, which rounds the pressure getter's operations elsewhere
    than its Pallas kernel, so the cells near a block face (`BF16_REACH`)
    differ: within 2 bf16 ulps a cell after a step, within one ulp of the
    field's largest magnitude after four (JAX's own two routes differ by
    up to 5); every cell farther is bitwise, which JAX's XLA route is not
    after four steps, so the check tells the two roundings apart."""
    _init(grid)
    state, p = j_init(dtype=jnp.bfloat16)
    tstate, tp = _port_state(state, p)
    assert tstate[0].dtype == torch.bfloat16
    calls = _spy(monkeypatch)
    dims = tuple(int(d) for d in tg.global_grid().dims)
    multi_rank = any(d > 1 for d in dims)
    for nt in (1, 4):
        ref = j_run(state, p, nt, nt_chunk=nt, impl="pallas_interpret")
        got = run_acoustic(tstate, tp, nt, nt_chunk=nt)
        xla = j_run(state, p, nt, nt_chunk=nt, impl="xla") if multi_rank and nt > 1 else ref
        xla_far_same = []
        for g, r, x, name in zip(got, ref, xla, FIELDS):
            g, r = to_np(g).astype(np.float32), np.asarray(r).astype(np.float32)
            assert g.shape == r.shape, (grid, name)
            if not multi_rank:
                assert np.array_equal(g, r), (grid, nt, name)
                continue
            far = _face_distance(g.shape, dims) >= BF16_REACH[nt]
            assert far.any() and np.array_equal(g[far], r[far]), (grid, nt, name)
            if nt == 1:
                ulps = int(_bf16_ulps(g[~far], r[~far]).max())
                assert ulps <= 2, (grid, name, ulps)
            else:
                err = float(np.abs(g - r)[~far].max())
                assert err <= _ulp_of_max(r), (grid, name, err, _ulp_of_max(r))
                xla_far_same.append(np.array_equal(np.asarray(x).astype(np.float32)[far],
                                                   r[far]))
        assert not xla_far_same or not all(xla_far_same), grid
    assert len(calls) == 5  # the fused route, once a step


@pytest.mark.parametrize("grid", list(GRIDS))
def test_bf16_plain_route_matches_jax_xla(grid, monkeypatch):
    """Four bfloat16 steps of the plain route equal JAX's XLA route bit for
    bit (both round every operation to bfloat16)."""
    _init(grid)
    state, p = j_init(dtype=jnp.bfloat16)
    tstate, tp = _port_state(state, p)
    calls = _spy(monkeypatch)
    ref = j_run(state, p, 4, nt_chunk=2, impl="xla")
    got = run_acoustic(tstate, tp, 4, nt_chunk=2, impl="plain")
    assert not calls
    for g, r, name in zip(got, ref, FIELDS):
        assert np.array_equal(tg.gather(g), np.asarray(igg.gather(r)).astype(np.float32)), \
            (grid, name)


def test_mesh_step_makes_one_slab_call_a_dim(monkeypatch):
    """On a 2x2x2 mesh a fused step computes every field's received slabs
    with one K4s call a dim: 3, not one for each of the 12 (field, dim)."""
    _init("all multi-rank periodic")
    state, p = init_acoustic3d(dtype=torch.float64)
    calls = []
    fn = cw.wave_slabs_multi_plain

    def spy(st, dim, hw, per_field, **k):
        calls.append(tuple(per_field))
        return fn(st, dim, hw, per_field, **k)

    monkeypatch.setattr(cw, "wave_slabs_multi_plain", spy)
    run_acoustic(state, p, 2, nt_chunk=2)
    assert calls == [cw.FIELDS] * 6


def test_plain_route_exchanges_velocities_as_one_group(monkeypatch):
    """On a multi-rank grid the plain route's velocity exchange is one
    coalesced group a dim (K8 + K7), the pressure's the combined tier."""
    import implicitglobalgrid_tpu_torch.ops.cuda_halo as ch

    _init("all multi-rank periodic")
    state, p = init_acoustic3d(dtype=torch.float64)
    packs, combined = [], []
    fn, fc = ch.wire_pack, ch.halo_write_combined
    monkeypatch.setattr(ch, "wire_pack", lambda f, s, **k: packs.append(len(f)) or fn(f, s, **k))
    monkeypatch.setattr(ch, "halo_write_combined",
                        lambda *a, **k: combined.append(1) or fc(*a, **k))
    tac.acoustic_step_local(state, p, "plain")
    assert packs == [3, 3, 3] and combined == [1]


FIELD_AXIS = {"Vx": 0, "Vy": 1, "Vz": 2}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_wave_slab_getters_match_jax(dtype):
    """Every field, dim and range (the send slabs [s-ol, s-ol+1) and [ol-1,
    ol), the current halos [0, 1) and [s-1, s)) of one random block."""
    nx, ny, nz = 7, 6, 9
    rng = np.random.default_rng(17)
    shapes = cw.wave_shapes((nx, ny, nz))
    state = [rng.standard_normal(shapes[f]).astype(dtype) for f in cw.FIELDS]
    c = dict(rho=1.3, K=0.7, dt=0.021, dx=0.31, dy=0.27, dz=0.35)
    k = cw.wave_consts(**c)
    dtp = np.dtype(dtype).type
    jc = {n: dtp(v) for n, v in k.items()}
    P, Vx, Vy, Vz = (jnp.asarray(a) for a in state)
    getters = {
        "P": pw._make_p_get_slab(P, Vx, Vy, Vz, jc["cx"], jc["cy"], jc["cz"], jc["dtK"],
                                 jc["dx"], jc["dy"], jc["dz"]),
        **{f: pw._make_v_get_slab(V, P, ax, jc["c" + "xyz"[ax]])
           for f, V, ax in (("Vx", Vx, 0), ("Vy", Vy, 1), ("Vz", Vz, 2))},
    }
    tstate = tuple(torch.from_numpy(a) for a in state)
    for f in cw.FIELDS:
        for dim in range(3):
            s = shapes[f][dim]
            ol = 2 + (FIELD_AXIS.get(f) == dim)
            starts = [s - ol, ol - 1, 0, s - 1]
            got = cw.wave_update_slab(tstate, f, dim, starts, 1, block=(nx, ny, nz), consts=k)
            for st, g in zip(starts, got):
                ref = np.asarray(getters[f](dim, st, 1))
                assert g.shape == ref.shape, (f, dim, st)
                assert np.allclose(to_np(g), ref, **ULP_TOL[dtype]), (f, dim, st)


def test_wave_slabs_move_and_patch_like_exchange_slabs():
    """The wave modes' pipeline (moves, PROC_NULL edges, earlier dims'
    corners) is K4s's: a copy-mode exchange of the updated field gives the
    same slabs."""
    from implicitglobalgrid_tpu_torch.ops import cuda_stencil as cs

    block = (4, 3, 5)
    rng = np.random.default_rng(5)
    state = tuple(torch.from_numpy(rng.standard_normal(
        tuple(2 * s for s in shp))) for shp in cw.wave_shapes(block).values())
    k = cw.wave_consts(rho=1.0, K=1.0, dt=0.05, dx=0.3, dy=0.2, dz=0.4)
    U = cw.wave_update_plain(state, block=block, consts=k)
    for f, Uf, m in zip(cw.FIELDS, U, cw.wave_shapes(block).values()):
        zl, zr = (torch.from_numpy(rng.standard_normal(
            (2 * m[0], 2 * m[1], 2))) for _ in range(2))
        earlier = ((2, 1, (zl, zr)),)
        moves = (cs.Move(m[0] - 2, 0, -1), cs.Move(1, m[0] - 1, 1))
        for periodic in (True, False):
            got = cw.wave_slabs(state, f, 0, 1, moves, block=block, periodic=periodic,
                                earlier=earlier, consts=k)
            ref = cs.exchange_slabs(Uf.contiguous(), 0, 1, moves, block=m,
                                    periodic=periodic, earlier=earlier)
            for a, b in zip(got, ref):
                assert torch.equal(a, b), (f, periodic)


def test_self_route_is_update_then_update_halo():
    """K9's all-self route (plain version) equals the update then a
    standalone `update_halo` of each field, bitwise."""
    tg.init_global_grid(8, 7, 9, periodx=1, periody=1, periodz=1, device_type="cpu",
                        quiet=True)
    gg = tg.global_grid()
    rng = np.random.default_rng(8)
    state = tuple(torch.from_numpy(rng.standard_normal(s))
                  for s in cw.wave_shapes((8, 7, 9)).values())
    k = cw.wave_consts(rho=1.0, K=2.0, dt=0.05, dx=0.3, dy=0.2, dz=0.4)
    modes = cw.wave_exchange_modes(gg, [a.shape for a in state])
    assert cw.all_self_exchange(gg, modes)
    got = cw.acoustic_step_exchange(state, gg, modes, rho=1.0, K=2.0, dt=0.05, dx=0.3,
                                    dy=0.2, dz=0.4, block=(8, 7, 9))
    ref = [tg.update_halo(u) for u in cw.wave_update_plain(state, block=(8, 7, 9), consts=k)]
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def _port_run(nx, dims, nt, periods=(0, 0, 0)):
    tg.init_global_grid(nx, nx, nx, dimx=dims[0], dimy=dims[1], dimz=dims[2],
                        periodx=periods[0], periody=periods[1], periodz=periods[2],
                        nranks=int(np.prod(dims)), device_type="cpu", quiet=True)
    state, p = init_acoustic3d(dtype=torch.float64)
    state = run_acoustic(state, p, nt, nt_chunk=5)
    out = [tg.gather_interior(a) for a in state]
    tg.finalize_global_grid()
    return out


def test_distributed_matches_single():
    """tests/test_models_wave_stokes.py:26-31 on the port: 2x2x2 x 6^3
    against 1x1x1 x 10^3."""
    multi = _port_run(6, (2, 2, 2), nt=12)
    single = _port_run(10, (1, 1, 1), nt=12)
    for m, s in zip(multi, single):
        assert m.shape == s.shape
        assert np.allclose(m, s, rtol=0, atol=1e-12)


def test_wave_propagates():
    P0 = _port_run(8, (2, 2, 2), nt=0)[0]
    P1 = _port_run(8, (2, 2, 2), nt=20)[0]
    c = P0.shape[0] // 2
    assert P1[c, c, c] < P0[c, c, c]
    assert np.abs(P1).sum() > 0


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_init_matches_jax_bitwise(dtype):
    init_both(6, 6, 6, dimx=2, dimy=2, dimz=2, periodx=1)
    state, p = j_init(dtype=dtype)
    tstate, tp = init_acoustic3d(dtype=torch.from_numpy(np.zeros(1, dtype)).dtype)
    assert tp.dt == p.dt and type(tp.dt) is float
    for f in ("rho", "K", "dx", "dy", "dz", "overlap"):
        assert getattr(tp, f) == getattr(p, f)
    for a, b in zip(tstate, state):
        assert np.array_equal(to_np(a), np.asarray(b)) and to_np(a).dtype == np.asarray(b).dtype


def test_unported_options_raise(monkeypatch):
    """``overlap=True`` on the plain route, `make_acoustic_run_deep`, the
    variable's deep cadence and ``ensemble`` (all ported since) run and
    match the plain route bitwise (an ensemble's member 0); a state without
    the member axis under ``ensemble`` raises as in JAX."""
    tg.init_global_grid(12, 12, 12, dimx=2, dimy=2, dimz=2, nranks=8, overlaps=(4, 4, 4),
                        halowidths=(2, 2, 2), device_type="cpu", quiet=True)
    state, p = init_acoustic3d(dtype=torch.float64, overlap=True)
    state = tg.update_halo(*state)   # halos consistent with what they mirror
    plain = dataclasses.replace(p, overlap=False)
    ref = run_acoustic(state, plain, 2, impl="plain")

    def same(got):
        assert all(torch.equal(a, b) for a, b in zip(got, ref))

    same(run_acoustic(state, p, 2, impl="plain"))
    fused = run_acoustic(state, plain, 1, impl="cuda")  # the fused route ignores overlap
    assert all(torch.equal(a, b) for a, b in zip(run_acoustic(state, p, 1, impl="cuda"), fused))
    with pytest.raises(tg.exceptions.InvalidArgumentError, match="member axis"):
        run_acoustic(state, plain, 1, ensemble=2)
    same([a[0] for a in run_acoustic(tg.ensemble_state(state, 2, perturb=0.1), plain, 2,
                                     ensemble=2)])
    same(tac.make_acoustic_run_deep(dataclasses.replace(plain, comm_every=2), 1)(*state))
    monkeypatch.setenv("IGG_COMM_EVERY", "2")
    q = init_acoustic3d(dtype=torch.float64)[1]   # no comm_every: the variable's cadence
    assert q.comm_every == "2"
    same(run_acoustic(state, q, 2))
    # an explicit cadence 1 (the params' own) wins over the variable, as in JAX
    same(run_acoustic(state, plain, 2, impl="plain"))
