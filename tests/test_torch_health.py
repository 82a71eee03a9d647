"""The port's health guard (`implicitglobalgrid_tpu_torch.runtime.health`),
fault injection and recovery records against the JAX package's, on the CPU:
`make_guarded_runner` on both packages from the same seeded state (the
non-finite counts bitwise, the float32 sums of squares within ``SUM_RTOL``),
solo and per ensemble member (E = 2), the reports they give, and the
runner's ``post_chunk`` hook."""

import dataclasses

import numpy as np
import pytest
import torch

import implicitglobalgrid_tpu as igg
import implicitglobalgrid_tpu_torch as tg
from implicitglobalgrid_tpu_torch.utils.exceptions import InvalidArgumentError

from torch_port_util import clean_torch_grid, init_both  # noqa: F401

SUM_RTOL = 1e-6  # the sums of squares: float32, another order than XLA's


def _states(dtype, nan_at=None):
    g = np.random.default_rng(13)
    T = (g.standard_normal((12, 12, 12)) * 3).astype(dtype)
    Cp = (1 + g.random((12, 12, 12))).astype(dtype)
    if nan_at is not None:
        T[nan_at] = np.nan
    return T, Cp


def _guard_vectors(T, Cp, ensemble=None, nt_chunk=2):
    """The guarded runner's stats after ``nt_chunk`` identity steps on both
    packages."""
    from implicitglobalgrid_tpu.models.common import ensemble_state as j_ens
    from implicitglobalgrid_tpu.runtime.health import make_guarded_runner as j_guarded
    from implicitglobalgrid_tpu_torch.models.common import ensemble_state as t_ens

    sj = [igg.device_put_g(a) for a in (T, Cp)]
    st = [tg.device_put_g(a) for a in (T, Cp)]
    if ensemble:
        sj = [j_ens(a, ensemble, perturb=0.5) for a in sj]
        st = [t_ens(a, ensemble, perturb=0.5) for a in st]
    run_j = j_guarded(lambda s: tuple(x * 1 for x in s), (T.ndim, Cp.ndim),
                      nt_chunk=nt_chunk, key="torch_health", ensemble=ensemble)
    run_t = tg.make_guarded_runner(lambda s, spare: (tuple(x * 1 for x in s), None),
                                   nt_chunk=nt_chunk, key="torch_health", ensemble=ensemble)
    out_t = run_t(*st)
    assert all(a.numpy().tobytes() == b.numpy().tobytes() for a, b in zip(out_t[:-1], st))
    return np.asarray(run_j(*sj)[-1]), out_t[-1].numpy()


def _match(vj, vt, T, Cp, ensemble=None):
    assert vj.shape == vt.shape and vt.dtype == np.float32
    assert np.array_equal(vj[..., 0::2], vt[..., 0::2])       # non-finite counts
    scale = max(float(np.nansum(np.asarray(a, np.float64) ** 2)) for a in (T, Cp))
    scale *= (1 + 0.5 * ((ensemble or 1) - 1)) ** 2
    a, b = vj[..., 1::2], vt[..., 1::2]
    assert np.all((np.isnan(a) & np.isnan(b)) | (np.abs(a - b) <= SUM_RTOL * scale))


@pytest.mark.parametrize("grid", [dict(dimx=2, dimy=2, dimz=2),
                                  dict(dimx=2, dimy=2, dimz=2, periodx=1, periody=1, periodz=1),
                                  dict(dimx=4, dimy=2, dimz=1, periodz=1)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_guard_vector_matches_jax(grid, dtype):
    loc = (6, 6, 6) if grid["dimx"] == 2 else (3, 6, 12)
    init_both(*loc, **grid)
    T, Cp = _states(dtype)
    T = T.reshape(12, 12, 12)
    vj, vt = _guard_vectors(T, Cp)
    assert vt.shape == (4,) and (vt[0::2] == 0).all()
    _match(vj, vt, T, Cp)


def test_guard_vector_counts_nonfinite():
    init_both(6, 6, 6, dimx=2, dimy=2, dimz=2)
    T, Cp = _states(np.float32, nan_at=(1, 2, 3))
    T[7, 7, 7] = np.inf
    vj, vt = _guard_vectors(T, Cp)
    assert list(vt[0::2]) == [2.0, 0.0]
    _match(vj, vt, T, Cp)


@pytest.mark.parametrize("nan_member", [None, 1])
def test_ensemble_guard_matches_jax_per_member(nan_member):
    """E = 2: an ``(E, 2N)`` matrix, one row a member, equal to the JAX
    package's vmapped guard; a NaN in member 1 trips member 1 alone."""
    from implicitglobalgrid_tpu.models.common import ensemble_state as j_ens
    from implicitglobalgrid_tpu.runtime.health import make_guarded_runner as j_guarded
    from implicitglobalgrid_tpu_torch.models.common import ensemble_state as t_ens

    init_both(6, 6, 6, dimx=2, dimy=2, dimz=2, periodx=1)
    T, Cp = _states(np.float32)
    ej = [j_ens(igg.device_put_g(a), 2, perturb=0.5) for a in (T, Cp)]
    et = [t_ens(tg.device_put_g(a), 2, perturb=0.5) for a in (T, Cp)]
    if nan_member is not None:
        ej[0] = ej[0].at[nan_member, 4, 5, 6].set(np.nan)
        et[0] = tg.poke_nan(et[0], (nan_member, 4, 5, 6))
    run_j = j_guarded(lambda s: tuple(s), (3, 3), nt_chunk=1, key="torch_ens_guard", ensemble=2)
    run_t = tg.make_guarded_runner(lambda s, spare: (tuple(s), None), nt_chunk=1, ensemble=2)
    vj, vt = np.asarray(run_j(*ej)[-1]), run_t(*et)[-1].numpy()
    assert vt.shape == (2, 4)
    _match(vj, vt, T, Cp, ensemble=2)
    from implicitglobalgrid_tpu_torch.runtime.health import ensemble_reports_from_stats

    reps = ensemble_reports_from_stats(torch.from_numpy(vt), ["T", "Cp"], [1728, 1728],
                                       tg.GuardConfig(), chunk=0, step_begin=0, step_end=1)
    assert [r.member for r in reps] == [0, 1]
    assert [r.ok for r in reps] == ([True, True] if nan_member is None else [True, False])


def test_guard_low_rank_field_counts_each_replica():
    """A 2-D field on the 3-D grid is replicated over z: the JAX package's
    psum counts each of its ``dims[2]`` replica shards, and so does the
    port."""
    init_both(6, 6, 6, dimx=2, dimy=2, dimz=2)
    A = np.random.default_rng(3).standard_normal((12, 12)).astype(np.float32)
    A[0, 0] = np.nan
    from implicitglobalgrid_tpu.runtime.health import make_guarded_runner as j_guarded

    vj = np.asarray(j_guarded(lambda s: tuple(s), (2,), nt_chunk=1, key="torch_2d",
                              check_vma=False)(
        igg.device_put_g(A))[-1])
    vt = tg.make_guarded_runner(lambda s, spare: (tuple(s), None), nt_chunk=1)(
        tg.device_put_g(A))[-1].numpy()
    assert vt[0] == vj[0] == 2.0 and np.isnan(vt[1]) and np.isnan(vj[1])


def test_reports_trip_like_jax():
    """`report_from_stats` on the port's vector gives the JAX package's
    report of its own vector: the NaN trips ``nonfinite:T``, an RMS limit
    trips ``rms:Cp``."""
    from implicitglobalgrid_tpu.runtime.health import (
        GuardConfig as JGuard, report_from_stats as j_report,
    )
    from implicitglobalgrid_tpu_torch.runtime.health import report_from_stats as t_report

    init_both(6, 6, 6, dimx=2, dimy=2, dimz=2, periodx=1)
    T, Cp = _states(np.float32, nan_at=(2, 2, 2))
    vj, vt = _guard_vectors(T, Cp)
    for kw in ({}, {"rms_limit": 1.2}, {"rms_limit": {"Cp": 1.0}}, {"check_nonfinite": False}):
        rj = j_report(vj, ["T", "Cp"], [1728, 1728], JGuard(**kw), chunk=3, step_begin=6,
                      step_end=8)
        rt = t_report(torch.from_numpy(vt), ["T", "Cp"], [1728, 1728], tg.GuardConfig(**kw),
                      chunk=3, step_begin=6, step_end=8)
        assert rt.reasons == rj.reasons and rt.ok == rj.ok and rt.nonfinite == rj.nonfinite
        assert rt.rms.keys() == rj.rms.keys()
    assert "nonfinite:T" in t_report(vt, ["T", "Cp"], [1728, 1728], tg.GuardConfig(),
                                     chunk=0, step_begin=0, step_end=1).reasons


def test_guard_trips_after_poke_nan_on_a_model_run():
    """The diffusion runner with the guard: a clean chunk passes, the chunk
    after a `poke_nan` trips ``nonfinite:T``; `poke_nan` leaves its input
    alone."""
    from implicitglobalgrid_tpu_torch.models import diffusion_step_local, init_diffusion3d
    from implicitglobalgrid_tpu_torch.runtime.health import report_from_stats

    tg.init_global_grid(6, 6, 6, dimx=2, dimy=2, dimz=2, quiet=True, nranks=8,
                        device_type="cpu")
    T, Cp, p = init_diffusion3d(dtype=torch.float32)
    run = tg.make_guarded_runner(
        lambda s, spare: ((diffusion_step_local(s[0], s[1], p, "plain"), s[1]), None),
        nt_chunk=3)
    T1, Cp1, vec = run(T, Cp)
    assert torch.equal(T1, tg.models.run_diffusion(T, Cp, p, 3, nt_chunk=3, impl="plain"))
    sizes = [T.numel(), Cp.numel()]
    rep = report_from_stats(vec, ["T", "Cp"], sizes, tg.GuardConfig(), chunk=0,
                            step_begin=0, step_end=3)
    assert rep.ok and rep.nonfinite == {"T": 0, "Cp": 0}
    bad = tg.poke_nan(T1, (1, 2, 3))
    assert torch.isfinite(T1).all() and torch.isnan(bad[1, 2, 3])
    *_, vec = run(bad, Cp1)
    rep = report_from_stats(vec, ["T", "Cp"], sizes, tg.GuardConfig(), chunk=1,
                            step_begin=3, step_end=6)
    assert not rep.ok and "nonfinite:T" in rep.reasons and rep.nonfinite["T"] > 0


def test_runner_without_hook_unchanged():
    """Without ``post_chunk`` the runner returns the state alone, as
    before; with it, the state and the hook's tensor."""
    from implicitglobalgrid_tpu_torch.models.common import make_state_runner

    tg.init_global_grid(6, 6, 6, dimx=2, dimy=2, dimz=2, quiet=True, nranks=8,
                        device_type="cpu")
    A = tg.ones_g()
    step = lambda s, spare: ((s[0] + 1,), None)  # noqa: E731
    out = make_state_runner(step, nt_chunk=3)(A)
    assert len(out) == 1 and torch.equal(out[0], A + 3)
    out = make_state_runner(step, nt_chunk=3, key="k",
                            post_chunk=lambda s: s[0].sum().reshape(1))(A)
    assert len(out) == 2 and float(out[1]) == float((A + 3).sum())


def test_fault_records_match_jax():
    """The fault and policy records carry the JAX package's fields and
    defaults; `corrupt_checkpoint` refuses what JAX's refuses."""
    import implicitglobalgrid_tpu.runtime as jrt

    for name in ("NaNPoke", "CheckpointCorruption", "ProcessLoss", "RecoveryPolicy",
                 "GuardConfig"):
        fj = [(f.name, f.default) for f in dataclasses.fields(getattr(jrt, name))]
        ft = [(f.name, f.default) for f in dataclasses.fields(getattr(tg, name))]
        assert fj == ft, name
    tg.init_global_grid(4, 4, 4, dimx=2, dimy=2, dimz=2, quiet=True, nranks=8,
                        device_type="cpu")
    with pytest.raises(InvalidArgumentError):
        tg.corrupt_checkpoint("/nonexistent", kind="melt")
    with pytest.raises(InvalidArgumentError):
        tg.corrupt_checkpoint("/nonexistent", target="everything")
    with pytest.raises(InvalidArgumentError, match="no such checkpoint file"):
        tg.corrupt_checkpoint("/nonexistent")


@pytest.mark.parametrize("kind", ["truncate", "bitflip", "delete"])
@pytest.mark.parametrize("target", ["shard", "meta"])
def test_corrupt_checkpoint_detected(tmp_path, kind, target):
    """Every corruption `corrupt_checkpoint` makes is refused by the restore
    with a typed error, as the JAX package's restore refuses its own."""
    from implicitglobalgrid_tpu_torch.utils.exceptions import GlobalGridError

    tg.init_global_grid(4, 4, 4, dimx=2, dimy=2, dimz=2, quiet=True, nranks=8,
                        device_type="cpu")
    d = str(tmp_path / "ck")
    tg.save_checkpoint_sharded(d, {"A": tg.ones_g()}, step=1)
    tg.corrupt_checkpoint(d, kind=kind, target=target)
    with pytest.raises(GlobalGridError):
        tg.restore_checkpoint_sharded(d)
