"""Port parity of the pseudo-transient Stokes solver's fused route (the
iteration K10 with its K4s Stokes-mode send slabs, `ops/cuda_stokes.py`)
against the JAX package, from the SAME state (`stokes_state_from_numpy`):

- the fused route (the port's default on the CPU, the kernels' plain
  versions) against JAX ``impl="pallas_interpret"`` on the five grids of
  `tests/test_models_wave_stokes.py:93-99,183-188` at local 8x8x16, 4
  iterations in chunks of 2, all eight stacked fields (halos included),
  with the buoyant sphere and with a random rhog (where the kernel's and
  the getters' buoyancy forms round differently): float32 rtol 1e-5 / atol
  1e-5*max|field|, float64 1e-12 (both sides use the same arithmetic form,
  so this is tighter than the JAX suite's fused-vs-XLA bound, :209-211);
- the K4s Stokes modes' pipeline, the two forms, the all-self route, an
  ineligible grid (plain route) and the unported options;
- a bfloat16 state: the gate gives it no fused route (JAX's Pallas route
  refuses bfloat16), and its plain route equals JAX ``impl="xla"`` bit for
  bit on every grid (both round every operation to bfloat16).

The plain route, `init_stokes3d`, `stokes_residuals` and the model's sanity
are in `test_torch_stokes_model.py`; the getters in
`test_torch_stokes_getters.py`.
"""

import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import implicitglobalgrid_tpu as igg
import implicitglobalgrid_tpu_torch as tg
import implicitglobalgrid_tpu_torch.models.stokes as tst
from implicitglobalgrid_tpu.models import init_stokes3d as j_init
from implicitglobalgrid_tpu.models import run_stokes as j_run
from implicitglobalgrid_tpu.ops import pallas_stokes as ps
from implicitglobalgrid_tpu_torch.models import init_stokes3d, run_stokes
from implicitglobalgrid_tpu_torch.ops import cuda_stokes as cst
from torch_port_util import clean_torch_grid, init_both, to_np  # noqa: F401
from torch_stokes_util import (
    CASES, GRIDS, IDS, NAMES, compare, init_grid, local_shapes, port_state, random_rhog, spy,
)

@pytest.mark.parametrize("grid,dtype", CASES, ids=IDS)
def test_fused_route_matches_jax_pallas(grid, dtype, monkeypatch):
    """The buoyant sphere, then a random rhog on the same grid (JAX reuses
    its compiled chunk)."""
    init_grid(grid)
    sphere, p = j_init(dtype=dtype)
    calls = spy(monkeypatch, cst.StokesStep, "__call__")
    for k, state in enumerate((sphere, random_rhog(sphere, 3))):
        jmodes = ps.stokes_exchange_modes(igg.global_grid(), local_shapes(igg.global_grid(), state))
        tstate, tp = port_state(state, p)
        modes = cst.stokes_exchange_modes(tg.global_grid(), local_shapes(tg.global_grid(), tstate))
        assert modes is not None and modes == jmodes, (modes, jmodes)
        ref = j_run(state, p, 4, nt_chunk=2, impl="pallas_interpret")
        got = run_stokes(tstate, tp, 4, nt_chunk=2)
        assert len(calls) == 4 * (k + 1)  # the port took the fused route, once an iteration
        for a, b in zip(tstate, state):   # the input is not written
            assert np.array_equal(to_np(a), np.asarray(b))
        compare(got, ref, dtype, grid)
        if np.asarray(state[7]).any():  # a coarse grid's sphere may hold no cell
            assert not np.allclose(to_np(got[3]), np.asarray(state[3]))


def test_stokes_slabs_move_and_patch_like_exchange_slabs():
    """The Stokes modes' pipeline (moves, PROC_NULL edges, earlier dims'
    corners) is K4s's: a copy-mode exchange of the getter-form field gives
    the same slabs."""
    from implicitglobalgrid_tpu_torch.ops import cuda_stencil as cs

    block = (4, 3, 5)
    rng = np.random.default_rng(5)
    state = tuple(torch.from_numpy(rng.standard_normal(tuple(2 * s for s in shp)))
                  for shp in cst.stokes_shapes(block).values())
    k = dict(mu=1.0, dt_v=0.01, dt_p=0.5, damp=0.8, dx=0.3, dy=0.2, dz=0.4)
    U = cst.stokes_update_plain(state, block=block, consts=k, form="getter")
    for f, Uf, m in zip(cst.FIELDS, U, cst.stokes_shapes(block).values()):
        zl, zr = (torch.from_numpy(rng.standard_normal((2 * m[0], 2 * m[1], 2)))
                  for _ in range(2))
        earlier = ((2, 1, (zl, zr)),)
        moves = (cs.Move(m[0] - 2, 0, -1), cs.Move(1, m[0] - 1, 1))
        for periodic in (True, False):
            got = cst.stokes_slabs(state, f, 0, 1, moves, block=block, periodic=periodic,
                                   earlier=earlier, consts=k)
            ref = cs.exchange_slabs(Uf.contiguous(), 0, 1, moves, block=m,
                                    periodic=periodic, earlier=earlier)
            for a, b in zip(got, ref):
                assert torch.equal(a, b), (f, periodic)


def test_forms_differ_only_in_the_buoyancy():
    """The kernel and getter forms agree on Pn, divV, Rx and Ry bit for bit;
    with the flow at rest Rz is the buoyancy alone, where the two forms
    round differently for a random rhog."""
    block = (6, 5, 9)
    rng = np.random.default_rng(9)
    state = [torch.from_numpy(rng.standard_normal(shp).astype(np.float32))
             for shp in cst.stokes_shapes(block).values()]
    state[7] = state[7] * torch.from_numpy(10 ** rng.uniform(-3, 3, state[7].shape)).float()
    k = dict(mu=1.0, dt_v=0.01, dt_p=0.5, damp=0.8, dx=0.3, dy=0.2, dz=0.4)
    a = cst.stokes_terms_plain(state, block=block, consts=k, form="kernel")
    b = cst.stokes_terms_plain(state, block=block, consts=k, form="getter")
    for x, y in zip(a[:4], b[:4]):
        assert torch.equal(x, y)
    rest = [torch.zeros_like(t) for t in state[:7]] + [state[7]]
    a = cst.stokes_terms_plain(rest, block=block, consts=k, form="kernel")[4]
    b = cst.stokes_terms_plain(rest, block=block, consts=k, form="getter")[4]
    scale = float(state[7].abs().max())
    assert not torch.equal(a, b) and torch.allclose(a, b, rtol=1e-6, atol=1e-6 * scale)


def test_self_route_is_update_then_update_halo():
    """K10's all-self route (plain version) equals the iteration then a
    standalone `update_halo` of each exchanged field, bitwise (the sphere's
    rhog, where the two forms agree)."""
    tg.init_global_grid(8, 7, 9, periodx=1, periody=1, periodz=1, device_type="cpu",
                        quiet=True)
    gg = tg.global_grid()
    state, p = init_stokes3d(dtype=torch.float64)
    rng = np.random.default_rng(8)
    state = tuple(torch.from_numpy(rng.standard_normal(a.shape)) if i < 7 else a
                  for i, a in enumerate(state))
    modes = cst.stokes_exchange_modes(gg, [a.shape for a in state])
    assert cst.all_self_exchange(gg, modes)
    got = cst.stokes_step_exchange(state, gg, modes, p, block=(8, 7, 9))
    new = cst.stokes_update_plain(state, block=(8, 7, 9), consts=cst.stokes_consts(p))
    ref = [tg.update_halo(u) for u in new[:4]] + list(new[4:]) + [state[7]]
    for g, r, name in zip(got, ref, NAMES):
        assert torch.equal(g, r), name
    assert got[7] is state[7]


def test_run_resolves_the_route_once(monkeypatch):
    """A run resolves the gate, the route and the constants once, not every
    iteration; a new grid is resolved anew."""
    tg.init_global_grid(8, 8, 8, dimx=2, dimy=2, dimz=2, nranks=8, device_type="cpu",
                        quiet=True)
    state, p = init_stokes3d(dtype=torch.float64)
    gates = spy(monkeypatch, tst, "stokes_exchange_modes")
    steps = spy(monkeypatch, cst.StokesStep, "__call__")
    run = tst.make_stokes_run(p, 3)
    state = run(*state)
    state = run(*state)
    assert len(gates) == 1 and len(steps) == 6
    tg.finalize_global_grid()
    tg.init_global_grid(8, 8, 8, dimx=2, dimy=2, dimz=2, periodx=1, nranks=8,
                        device_type="cpu", quiet=True)
    run(*state)
    assert len(gates) == 2 and len(steps) == 9


def test_plain_route_exchanges_four_fields_as_one_group(monkeypatch):
    """On a multi-rank grid the plain route's exchange of (Vx, Vy, Vz, Pn)
    is one coalesced group a dim (K8 + K7)."""
    import implicitglobalgrid_tpu_torch.ops.cuda_halo as ch

    tg.init_global_grid(8, 8, 8, dimx=2, dimy=2, dimz=2, periodx=1, nranks=8,
                        device_type="cpu", quiet=True)
    state, p = init_stokes3d(dtype=torch.float64)
    packs = []
    fn = ch.wire_pack
    monkeypatch.setattr(ch, "wire_pack", lambda f, s, **k: packs.append(len(f)) or fn(f, s, **k))
    tst.stokes_step_local(state, p, "plain")
    assert packs == [4, 4, 4]


def test_ineligible_grid_takes_plain_route(monkeypatch):
    """Halowidth 2: `stokes_exchange_modes` refuses the grid and the default
    route runs the plain iteration (JAX falls through to XLA), matching
    JAX's XLA route."""
    init_both(10, 10, 10, dimx=2, dimy=2, dimz=2, periodx=1, overlaps=(4, 4, 4),
              halowidths=(2, 2, 2))
    state, p = j_init(dtype=np.float64)
    tstate, tp = port_state(state, p)
    assert cst.stokes_exchange_modes(tg.global_grid(), local_shapes(tg.global_grid(), tstate)) \
        is None
    calls = spy(monkeypatch, cst.StokesStep, "__call__")
    got = run_stokes(tstate, tp, 3, nt_chunk=3)
    assert not calls
    compare(got, j_run(state, p, 3, nt_chunk=3, impl="xla"), np.float64, "halowidth 2")


@pytest.mark.parametrize("grid", list(GRIDS))
def test_bf16_takes_the_plain_route_and_matches_jax_xla(grid, monkeypatch):
    init_grid(grid)
    sphere, p = j_init(dtype=jnp.bfloat16)
    state = random_rhog(sphere, 3)
    tstate, tp = port_state(state, p)
    gg, loc = tg.global_grid(), local_shapes(tg.global_grid(), tstate)
    assert cst.stokes_exchange_modes(gg, loc) is not None  # the shapes alone are eligible
    assert cst.stokes_exchange_modes(gg, loc, tstate[0].dtype) is None
    calls = spy(monkeypatch, cst.StokesStep, "__call__")
    ref = j_run(state, p, 4, nt_chunk=2, impl="xla")
    got = run_stokes(tstate, tp, 4, nt_chunk=2)
    assert not calls  # no fused iteration
    for g, r, name in zip(got, ref, NAMES):
        g, r = tg.gather(g), np.asarray(igg.gather(r))
        assert g.dtype == r.dtype == ml_dtypes.bfloat16, (grid, name)
        assert np.array_equal(g.view(np.uint16), r.view(np.uint16)), (grid, name)


def test_mesh_iteration_makes_one_slab_call_a_dim(monkeypatch):
    """On a 2x2x2 mesh a fused iteration computes every field's received
    slabs with one K4s call a dim: 3, not one for each of the 12 (field,
    dim)."""
    init_grid("all multi-rank periodic")
    state, p = init_stokes3d(dtype=torch.float64)
    calls = []
    fn = cst.stokes_slabs_multi_plain

    def wrapped(st, dim, hw, per_field, **k):
        calls.append(tuple(per_field))
        return fn(st, dim, hw, per_field, **k)

    monkeypatch.setattr(cst, "stokes_slabs_multi_plain", wrapped)
    run_stokes(state, p, 2, nt_chunk=2)
    assert calls == [cst.FIELDS] * 6


def test_unported_options_raise(monkeypatch):
    """``overlap=True`` on the plain route, `deep_step`,
    `make_stokes_run_deep`, the variable's deep cadence and ``ensemble``
    (all ported since) run and match the plain route bitwise (P and V: dV's
    halos are undefined state in the base scheme; an ensemble's member 0);
    a state without the member axis under ``ensemble`` raises as in JAX."""
    tg.init_global_grid(12, 12, 12, dimx=2, dimy=2, dimz=2, nranks=8, device_type="cpu",
                        quiet=True)
    state, p = init_stokes3d(dtype=torch.float64, overlap=True)
    plain = dataclasses.replace(p, overlap=False)
    ref = run_stokes(state, plain, 2, impl="plain")
    assert all(torch.equal(a, b) for a, b in zip(run_stokes(state, p, 2, impl="plain"), ref))
    fused = run_stokes(state, plain, 1, impl="cuda")  # the fused route ignores overlap
    assert all(torch.equal(a, b) for a, b in zip(run_stokes(state, p, 1, impl="cuda"), fused))
    with pytest.raises(tg.exceptions.InvalidArgumentError, match="member axis"):
        run_stokes(state, plain, 1, ensemble=2)
    members = run_stokes(tg.ensemble_state(state, 2, perturb=0.1), plain, 2, ensemble=2)
    assert all(torch.equal(a[0], b) for a, b in zip(members, ref))
    tg.finalize_global_grid()
    # the iteration's radius is 2: k = 2 needs halowidth 4
    tg.init_global_grid(12, 12, 12, dimx=2, dimy=2, dimz=2, nranks=8, overlaps=(8, 8, 8),
                        halowidths=(4, 4, 4), device_type="cpu", quiet=True)
    state, p = init_stokes3d(dtype=torch.float64)
    state = tg.update_halo(*state)   # halos consistent with what they mirror
    ref = run_stokes(state, p, 2, impl="plain")

    def same(got):
        assert all(np.array_equal(tg.gather_interior(a), tg.gather_interior(b))
                   for a, b in zip(got[:4], ref[:4]))

    deep = dataclasses.replace(p, comm_every=2)
    same(tst.make_stokes_run_deep(deep, 1)(*state))
    step, cycle = tst.deep_step(deep)
    assert cycle == 2
    same(step(state))
    monkeypatch.setenv("IGG_COMM_EVERY", "2")
    q = init_stokes3d(dtype=torch.float64)[1]   # no comm_every: the variable's cadence
    assert q.comm_every == "2"
    same(run_stokes(state, q, 2))
    # an explicit cadence 1 (the params' own) wins over the variable, as in JAX
    same(run_stokes(state, p, 2, impl="plain"))


def test_stokes_wrappers_refuse_bad_arguments():
    """K10 and the K4s Stokes modes check their arguments on every device,
    and run no plain version for a tensor that is neither on the CPU nor on
    a card."""
    from implicitglobalgrid_tpu_torch.ops import cuda_stencil as cs

    E = tg.exceptions.InvalidArgumentError
    block = (4, 3, 5)
    st = tuple(torch.zeros(tuple(2 * s for s in shp), dtype=torch.float32)
               for shp in cst.stokes_shapes(block).values())
    k = dict(mu=1.0, dt_v=0.1, dt_p=0.1, damp=0.9, dx=1.0, dy=1.0, dz=1.0)
    new = cst.stokes_step_recv(st, {}, block=block, consts=k)
    assert new[7] is st[7] and len(new) == 8
    assert cst.stokes_bytes(st) == 4 * (2 * sum(a.numel() for a in st[:7]) + st[7].numel())
    with pytest.raises(E):   # seven tensors
        cst.stokes_step_recv(st[:7], {}, block=block, consts=k)
    with pytest.raises(E):   # dV not mirroring V
        cst.stokes_step_recv(st[:4] + (st[5], st[5], st[6], st[7]), {}, block=block, consts=k)
    with pytest.raises(E):   # rhog of another dtype
        cst.stokes_step_recv(st[:7] + (st[7].double(),), {}, block=block, consts=k)
    bf = tuple(a.bfloat16() for a in st)   # bfloat16: the plain version on the CPU
    assert all(torch.equal(a, b) for a, b in zip(
        cst.stokes_step_recv(bf, {}, block=block, consts=k),
        cst.stokes_step_recv_plain(bf, {}, block=block, consts=k)))
    with pytest.raises(E):   # float16
        cst.stokes_step_recv(tuple(a.half() for a in st), {}, block=block, consts=k)
    with pytest.raises(E):   # fewer than 3 planes
        cst.stokes_step_recv(st, {}, block=(2, 3, 5), consts=k)
    with pytest.raises(E):   # out aliasing the state
        cst.stokes_step_recv(st, {}, block=block, consts=k, out=st)
    with pytest.raises(E):   # six outputs
        cst.stokes_step_recv(st, {}, block=block, consts=k,
                             out=[torch.empty_like(a) for a in st[:6]])
    slab = torch.zeros((8, 6, 2))
    with pytest.raises(E):   # a received slab of the wrong shape (P is 8 x 6 x 10)
        cst.stokes_step_recv(st, {"P": {2: (slab, torch.zeros((8, 6, 3)))}}, block=block,
                             consts=k)
    with pytest.raises(E):   # unknown field
        cst.stokes_step_recv(st, {"dVx": {2: (slab, slab)}}, block=block, consts=k)
    modes = {f: (False, False, True) for f in cst.FIELDS}
    ols = {f: (2, 2, 2) for f in cst.FIELDS}
    cst.stokes_step_self(st, modes, ols, block=block, consts=k)
    with pytest.raises(E):   # an overlap outside [2, n-1]
        cst.stokes_step_self(st, modes, dict(ols, Vz=(2, 2, 6)), block=block, consts=k)
    with pytest.raises(E):   # dV is never exchanged
        cst.stokes_slabs(st, "dVx", 0, 1, (cs.Move(2, 0, -1),), block=block, periodic=True,
                         consts=k)
    with pytest.raises(E):   # a move leaving Vx's block of 5 planes
        cst.stokes_slabs(st, "Vx", 0, 1, (cs.Move(5, 0, 1),), block=block, periodic=True,
                         consts=k)
    with pytest.raises(E):   # unknown form
        cst.stokes_update_plain(st, block=block, consts=k, form="xla")
    meta = tuple(a.to("meta") for a in st)
    with pytest.raises(tg.exceptions.NotSupportedError):
        cst.stokes_step_recv(meta, {}, block=block, consts=k)
