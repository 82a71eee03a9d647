"""The ensemble axis of the port against the JAX package's
(`tests/test_ensemble.py`), on the CPU (2x2x1 x 6^3 unless stated):

- `ensemble_state` bitwise JAX's (the perturb ramp, member 0 the base),
  `ensemble_partition_spec` element by element JAX's ``PartitionSpec``, and
  the validation errors of both packages side by side;
- member trajectories of diffusion (float64, E = 4, ``nt_chunk`` 3; plain,
  ``overlap=True`` and 2-D), the acoustic leapfrog and the Stokes iteration
  against JAX's ``run_*(..., ensemble=E)``, to the bounds of the port's
  model tests against ``impl="xla"`` (float64 1e-12); member 0 bitwise the
  port's solo plain run, member 1 different;
- deep ``comm_every=2`` with E = 3, against JAX and bitwise the port's
  solo deep run;
- `halo_comm_plan(ensemble=8)` equal to JAX's, field by field;
- the int8 exchange with per-member scales bitwise JAX's vmapped one (the
  case of `tests/test_ensemble.py:216-270`);
- the calls of `wire_pack` / `halo_write_multi` a step flat in E (one a dim
  on the CPU, where each runs its plain version: `launch_counts` counts
  only launches on the card);
- the rejections: ``impl="cuda"``, ``sr=True``, a state without the member
  axis, ``stokes_residuals`` of an ensemble's state.
"""

import dataclasses

import numpy as np
import pytest
import torch

import implicitglobalgrid_tpu as igg
import implicitglobalgrid_tpu_torch as tg
from implicitglobalgrid_tpu import models as jm
from implicitglobalgrid_tpu_torch import models as tm
from implicitglobalgrid_tpu_torch.models import common as tcommon
from implicitglobalgrid_tpu_torch.ops import cuda_halo
from implicitglobalgrid_tpu_torch.ops.halo import local_update_halo
from implicitglobalgrid_tpu_torch.utils.exceptions import InvalidArgumentError
from implicitglobalgrid_tpu.utils.exceptions import InvalidArgumentError as JInvalid
from torch_port_util import clean_torch_grid, init_both, to_np  # noqa: F401

F64 = dict(rtol=1e-12, atol=1e-12)


def _grid(**kw):
    init_both(6, 6, 6, dimx=2, dimy=2, dimz=1, nranks=4, **kw)


def _port(arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def test_ensemble_state_bitwise_and_partition_spec():
    _grid()
    T, Cp, p = jm.init_diffusion3d(dtype=np.float32)
    t, c = _port((T, Cp))
    for E, perturb in ((3, 0.5), (4, 0.01), (2, 0.0)):
        ref = np.asarray(jm.ensemble_state(T, E, perturb=perturb))
        got = tm.ensemble_state(t, E, perturb=perturb)
        assert got.shape == (E,) + tuple(t.shape) and got.dtype == t.dtype
        assert np.array_equal(to_np(got), ref), (E, perturb)
        assert torch.equal(got[0], t)  # member 0 is the base
    d = tm.ensemble_state({"T": t, "Cp": c}, 3)
    assert set(d) == {"T", "Cp"} and d["Cp"].shape[0] == 3
    tup = tm.ensemble_state([t, c], 2, perturb=0.1)
    assert isinstance(tup, list) and len(tup) == 2
    for nd in (1, 2, 3):
        assert tm.ensemble_partition_spec(nd) == tuple(jm.ensemble_partition_spec(nd))
    assert tg.ensemble_partition_spec(3) == (None, "gx", "gy", "gz")


def test_ensemble_rejections_match_jax():
    """Each JAX rejection beside the port's, both typed InvalidArgumentError
    with the same reason."""
    _grid()
    T, Cp, p = jm.init_diffusion3d(dtype=np.float64)
    t, c = _port((T, Cp))
    q = tm.DiffusionParams(**{k: v for k, v in dataclasses.asdict(p).items()
                              if k != "comm_every"})
    cases = [
        (lambda: jm.ensemble_state(T, 0), lambda: tm.ensemble_state(t, 0), ">= 1"),
        (lambda: jm.common.make_state_runner(lambda s: s, (3,), nt_chunk=1, ensemble=0),
         lambda: tcommon.make_state_runner(lambda s, sp: (s, None), nt_chunk=1, ensemble=0),
         ">= 1"),
        (lambda: jm.common.resolve_ensemble_impl("pallas"),
         lambda: tcommon.resolve_ensemble_impl("cuda"), "incompatible with ensemble"),
        (lambda: jm.run_diffusion(T, Cp, p, 2, ensemble=4),
         lambda: tm.run_diffusion(t, c, q, 2, ensemble=4), "member axis"),
        (lambda: jm.run_diffusion(jm.ensemble_state(T, 2), jm.ensemble_state(Cp, 2),
                                  dataclasses.replace(p, sr=True), 2, ensemble=2),
         lambda: tm.run_diffusion(tm.ensemble_state(t, 2), tm.ensemble_state(c, 2),
                                  dataclasses.replace(q, sr=True), 2, ensemble=2),
         "sr=True"),
        (lambda: jm.run_diffusion(jm.ensemble_state(T, 2), jm.ensemble_state(Cp, 2), p, 2,
                                  ensemble=2, impl="pallas"),
         lambda: tm.run_diffusion(tm.ensemble_state(t, 2), tm.ensemble_state(c, 2), q, 2,
                                  ensemble=2, impl="cuda"),
         "incompatible with ensemble"),
        (lambda: igg.halo_comm_plan(T, ensemble=0), lambda: tg.halo_comm_plan(t, ensemble=0),
         ">= 1"),
    ]
    for jfn, tfn, match in cases:
        with pytest.raises(JInvalid, match=match):
            jfn()
        with pytest.raises(InvalidArgumentError, match=match):
            tfn()


def _diffusion_case(kind):
    if kind == "2d":
        init_both(6, 6, 1, dimx=2, dimy=2, dimz=1, nranks=4)
        T, Cp, p = jm.init_diffusion2d(dtype=np.float64)
    else:
        _grid()
        T, Cp, p = jm.init_diffusion3d(dtype=np.float64, overlap=kind == "overlap")
    t, c, q = tm.state_from_numpy(np.asarray(T), np.asarray(Cp), dataclasses.asdict(p), "cpu")
    return (T, Cp, p), (t, c, q)


@pytest.mark.parametrize("kind", ["plain", "overlap", "2d"])
def test_diffusion_members_match_jax(kind):
    (T, Cp, p), (t, c, q) = _diffusion_case(kind)
    E = 4
    ref = np.asarray(jm.run_diffusion(jm.ensemble_state(T, E, perturb=0.01),
                                      jm.ensemble_state(Cp, E), p, 6, nt_chunk=3, ensemble=E))
    got = to_np(tm.run_diffusion(tm.ensemble_state(t, E, perturb=0.01),
                                 tm.ensemble_state(c, E), q, 6, nt_chunk=3, ensemble=E))
    assert got.shape == ref.shape == (E,) + tuple(t.shape)
    assert np.allclose(got, ref, **F64), float(np.abs(got - ref).max())
    solo = to_np(tm.run_diffusion(t, c, q, 6, nt_chunk=3, impl="plain"))
    assert np.array_equal(got[0], solo)
    assert not np.array_equal(got[1], got[0])


def _acoustic():
    init_both(8, 8, 16, dimx=2, dimy=2, dimz=2, periodx=1, periody=1, periodz=1)
    state, p = jm.init_acoustic3d(dtype=np.float64)
    tstate, q = tm.acoustic_state_from_numpy(*(np.asarray(a) for a in state),
                                             dataclasses.asdict(p), "cpu")
    return state, p, tstate, q, jm.run_acoustic, tm.run_acoustic


def _stokes():
    init_both(8, 8, 16, dimx=2, dimy=2, dimz=2, periodx=1, periody=1, periodz=1)
    state, p = jm.init_stokes3d(dtype=np.float64)
    rng = np.random.default_rng(4)
    rh = rng.standard_normal(np.asarray(state[7]).shape)
    state = tuple(state[:7]) + (igg.device_put_g(rh),)
    tstate, q = tm.stokes_state_from_numpy(*(np.asarray(a) for a in state),
                                           dataclasses.asdict(p), "cpu")
    return state, p, tstate, q, jm.run_stokes, tm.run_stokes


@pytest.mark.parametrize("model", ["acoustic", "stokes"])
@pytest.mark.parametrize("overlap", [False, True])
def test_staggered_members_match_jax(model, overlap):
    state, p, tstate, q, j_run, t_run = (_acoustic if model == "acoustic" else _stokes)()
    q = dataclasses.replace(q, overlap=overlap)
    if model == "acoustic":
        p = dataclasses.replace(p, overlap=overlap)
    # (JAX's own Stokes overlap does not match its plain route on this
    # toolchain, `tests/test_overlap.py`: the port's overlap is held to
    # JAX's plain ensemble, as its solo overlap is)
    E = 3
    ref = j_run(tuple(jm.ensemble_state(state, E, perturb=0.01)), p, 4, nt_chunk=2,
                ensemble=E)
    got = t_run(tm.ensemble_state(tstate, E, perturb=0.01), q, 4, nt_chunk=2, ensemble=E)
    solo = t_run(tstate, q, 4, nt_chunk=2, impl="plain")
    for k, (g, r, s) in enumerate(zip(got, ref, solo)):
        g, r = to_np(g), np.asarray(r)
        scale = max(1e-30, float(np.abs(r).max()))
        assert g.shape == r.shape and np.allclose(g, r, rtol=1e-12, atol=1e-12 * scale), \
            (model, k, float(np.abs(g - r).max()))
        assert np.array_equal(g[0], to_np(s)), (model, k)
    assert not np.array_equal(to_np(got[0][1]), to_np(got[0][0]))


@pytest.mark.parametrize("model", ["diffusion", "acoustic", "stokes"])
def test_deep_comm_every_2_with_members(model):
    """Deep ``comm_every=2`` composes with E = 3: the members match JAX's
    batched deep runner and member 0 is bitwise the port's solo deep run."""
    hw = 4 if model == "stokes" else 2
    n = 16 if model == "stokes" else 10
    init_both(n, n, n, dimx=2, dimy=2, dimz=1, nranks=4, periodx=1,
              overlaps=(2 * hw,) * 3, halowidths=(hw,) * 3)
    E = 3
    if model == "diffusion":
        T, Cp, p = jm.init_diffusion3d(dtype=np.float64, comm_every=2)
        t, c, q = tm.state_from_numpy(np.asarray(T), np.asarray(Cp), dataclasses.asdict(p),
                                      "cpu")
        q = dataclasses.replace(q, comm_every=2)
        ref = [jm.run_diffusion(jm.ensemble_state(T, E, perturb=0.02),
                                jm.ensemble_state(Cp, E), p, 4, nt_chunk=2, ensemble=E)]
        got = [tm.run_diffusion(tm.ensemble_state(t, E, perturb=0.02),
                                tm.ensemble_state(c, E), q, 4, nt_chunk=2, ensemble=E)]
        solo = [tm.run_diffusion(t, c, q, 4, nt_chunk=2)]
    else:
        j_init, t_conv, j_run, t_run = (
            (jm.init_acoustic3d, tm.acoustic_state_from_numpy, jm.run_acoustic,
             tm.run_acoustic) if model == "acoustic" else
            (jm.init_stokes3d, tm.stokes_state_from_numpy, jm.run_stokes, tm.run_stokes))
        state, p = j_init(dtype=np.float64, comm_every=2)
        tstate, q = t_conv(*(np.asarray(a) for a in state), dataclasses.asdict(p), "cpu")
        q = dataclasses.replace(q, comm_every=2)
        ref = j_run(tuple(jm.ensemble_state(state, E, perturb=0.02)), p, 4, nt_chunk=2,
                    ensemble=E)
        got = t_run(tm.ensemble_state(tstate, E, perturb=0.02), q, 4, nt_chunk=2, ensemble=E)
        solo = t_run(tstate, q, 4, nt_chunk=2)
    for g, r, s in zip(got, ref, solo):
        g, r = to_np(g), np.asarray(r)
        scale = max(1e-30, float(np.abs(r).max()))
        assert np.allclose(g, r, rtol=1e-12, atol=1e-12 * scale), float(np.abs(g - r).max())
        assert np.array_equal(g[0], to_np(s))


PLAN_CASES = {
    "one field": dict(shapes=[(12, 12, 6)], wire=None),
    "group": dict(shapes=[(12, 12, 6), (14, 12, 6), (12, 14, 6)], wire=None),
    "group int8": dict(shapes=[(12, 12, 6), (12, 12, 6)], wire="int8"),
    "bf16 z periodic": dict(shapes=[(12, 12, 6), (12, 12, 7)], wire="bfloat16", periodz=1),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_halo_comm_plan_ensemble_equals_jax(case):
    spec = PLAN_CASES[case]
    _grid(periodz=spec.get("periodz", 0))
    arrays = [np.zeros(s) for s in spec["shapes"]]
    for E in (1, 8):
        ref = igg.halo_comm_plan(*[igg.device_put_g(a) for a in arrays],
                                 wire_dtype=spec["wire"], ensemble=E)
        got = tg.halo_comm_plan(*[torch.from_numpy(a) for a in arrays],
                                wire_dtype=spec["wire"], ensemble=E)
        assert set(got) == set(ref)
        for k in ref:
            assert got[k] == ref[k], (case, E, k, got[k], ref[k])
    solo = tg.halo_comm_plan(*[torch.from_numpy(a) for a in arrays], wire_dtype=spec["wire"])
    assert got["ppermutes"] == solo["ppermutes"]
    assert got["wire_bytes"] == 8 * solo["wire_bytes"]
    assert got["local_copy_bytes"] == 8 * solo["local_copy_bytes"]


def test_int8_exchange_per_member_scales_bitwise_jax():
    """`tests/test_ensemble.py:216-270` on the port: the int8 exchange of
    an ensemble's two fields, bitwise JAX's vmapped exchange, each member
    bitwise its own solo int8 `update_halo` (its own scales)."""
    import jax

    from implicitglobalgrid_tpu.models.common import ensemble_partition_spec
    from implicitglobalgrid_tpu.ops import halo as halo_mod
    from implicitglobalgrid_tpu.ops.precision import resolve_wire_dtype
    from implicitglobalgrid_tpu.utils.compat import shard_map

    init_both(4, 8, 8, dimx=8, dimy=1, dimz=1, periodx=1)
    gg = igg.global_grid()
    E = 3
    rng = np.random.default_rng(7)
    A = igg.device_put_g(rng.normal(size=(32, 8, 8)).astype(np.float32))
    B = igg.device_put_g(rng.normal(size=(32, 8, 8)).astype(np.float32))
    wire = resolve_wire_dtype("int8")

    def exchange(*arrays):
        return tuple(halo_mod._exchange_arrays(
            gg, list(arrays), [gg.halowidths] * 2, halo_mod._normalize_dims_order(None),
            coalesce=True, wire=wire))

    espec = (ensemble_partition_spec(3),) * 2
    fn = jax.jit(shard_map(jax.vmap(exchange), mesh=gg.mesh, in_specs=espec,
                           out_specs=espec))
    EA = jm.ensemble_state(A, E, perturb=10.0)
    EB = jm.ensemble_state(B, E, perturb=10.0)
    ref = [np.asarray(r) for r in fn(EA, EB)]
    ta, tb = _port((EA, EB))
    got = local_update_halo(ta, tb, members=E, wire_dtype="int8")
    for g, r in zip(got, ref):
        assert np.array_equal(to_np(g), r)
    for m in range(E):
        solo = tg.update_halo(ta[m].clone(), tb[m].clone(), wire_dtype="int8")
        assert all(torch.equal(g[m], s) for g, s in zip(got, solo)), m


def _count_calls(monkeypatch):
    calls = {"wire_pack": 0, "halo_write_multi": 0}
    for name in calls:
        fn = getattr(cuda_halo, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(cuda_halo, name, wrapped)
    return calls


@pytest.mark.parametrize("model", ["diffusion", "acoustic", "stokes"])
def test_exchange_calls_a_step_flat_in_members(model, monkeypatch):
    """K8 and K7 once a dim and exchange round at E = 1, 3 and 16 (the
    members ride the launch, not more launches): diffusion one round of T,
    the acoustic leapfrog two (V, then P), Stokes one (V, P)."""
    tg.init_global_grid(6, 6, 6, dimx=2, dimy=2, dimz=2, periodx=1, periody=1, periodz=1,
                        device_type="cpu", quiet=True)
    calls = _count_calls(monkeypatch)
    if model == "diffusion":
        T, Cp, p = tm.init_diffusion3d(dtype=torch.float64)
        base, run = (T, Cp), lambda s, E: tm.run_diffusion(*s, p, 2, nt_chunk=2, ensemble=E)
        rounds = 1
    elif model == "acoustic":
        base, p = tm.init_acoustic3d(dtype=torch.float64)
        run, rounds = (lambda s, E: tm.run_acoustic(s, p, 2, nt_chunk=2, ensemble=E)), 2
    else:
        base, p = tm.init_stokes3d(dtype=torch.float64)
        run, rounds = (lambda s, E: tm.run_stokes(s, p, 2, nt_chunk=2, ensemble=E)), 1
    for E in (1, 3, 16):
        for k in calls:
            calls[k] = 0
        run(tm.ensemble_state(tuple(base), E, perturb=0.01), E)
        assert calls == {"wire_pack": 2 * 3 * rounds, "halo_write_multi": 2 * 3 * rounds}, \
            (model, E, calls)


def test_stokes_residuals_of_an_ensemble_raise_as_jax():
    state, p, tstate, q, _, _ = _stokes()
    with pytest.raises(TypeError):  # JAX's broadcasting fails on the member axis
        jm.stokes_residuals(tuple(jm.ensemble_state(state, 2)), p)
    with pytest.raises(InvalidArgumentError, match="eight 3-D tensors"):
        tm.stokes_residuals(tm.ensemble_state(tstate, 2), q)
