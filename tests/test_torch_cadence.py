"""The exchange cadence (``comm_every``, ``IGG_COMM_EVERY``) of the port's
models, resolved beside the JAX package's resolver
(`implicitglobalgrid_tpu/ops/wire.py` `resolve_comm_every`):

- each spelling resolves to the same per-axis cadence and string in both
  packages (an explicit value wins over the variable, an empty variable
  and ``"z:1"`` are cadence 1);
  ``for_dim``, ``uniform``, ``cycle``, ``retreats`` and ``due_dims`` agree
  with the JAX package's;
- every model (diffusion, acoustic, Stokes) runs a cadence-1 spelling, from
  its ``init_*`` and from params given the value explicitly; a deep spelling
  runs one cycle of the deep-halo super-step (`models.*.deep_step`) on a
  grid whose x halos carry it, bitwise equal to cadence 1 on that grid.
"""

import dataclasses

import pytest
import torch

import numpy as np

import implicitglobalgrid_tpu_torch as tg
from implicitglobalgrid_tpu.ops.wire import resolve_comm_every as j_resolve
from implicitglobalgrid_tpu_torch.models import (
    init_acoustic3d, init_diffusion3d, init_stokes3d, run_acoustic, run_diffusion, run_stokes,
)
from implicitglobalgrid_tpu_torch.ops.wire import CommCadence, resolve_comm_every
from torch_port_util import clean_torch_grid  # noqa: F401

# (comm_every, IGG_COMM_EVERY or None for unset)
SPELLINGS = {
    "default": (None, None),
    "explicit 1 over the variable's 4": (1, "4"),
    "explicit '1' over the variable's 4": ("1", "4"),
    "empty variable": (None, ""),
    "variable '1'": (None, "1"),
    "z:1": ("z:1", None),
    "gz:1,x:1 over the variable's 2": ("gz:1,x:1", "2"),
    "mapping z 1": ({"z": 1}, None),
    "deep 2": (2, None),
    "deep z:2": ("z:2", None),
    "deep x:1,y:3": ("x:1,y:3", "1"),
    "deep from the variable": (None, "4"),
}


def _setenv(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("IGG_COMM_EVERY", raising=False)
    else:
        monkeypatch.setenv("IGG_COMM_EVERY", env)


def _models():
    """model -> (init, run, fields of the state, params of the state, the
    fields compared; the Stokes dV halos are undefined state in the base
    scheme, which never exchanges them)."""
    return {
        "diffusion": (lambda **kw: init_diffusion3d(dtype=torch.float64, **kw),
                      lambda f, p, nt=1, **k: (run_diffusion(f[0], f[1], p, nt, **k),),
                      lambda s: s[:2], lambda s: s[2], 1),
        "acoustic": (lambda **kw: init_acoustic3d(dtype=torch.float64, **kw),
                     lambda f, p, nt=1, **k: run_acoustic(f, p, nt, **k),
                     lambda s: s[0], lambda s: s[1], 4),
        "stokes": (lambda **kw: init_stokes3d(dtype=torch.float64, **kw),
                   lambda f, p, nt=1, **k: run_stokes(f, p, nt, **k),
                   lambda s: s[0], lambda s: s[1], 4),
    }


@pytest.mark.parametrize("spelling", list(SPELLINGS))
def test_resolves_as_jax(spelling, monkeypatch):
    comm_every, env = SPELLINGS[spelling]
    _setenv(monkeypatch, env)
    got, ref = resolve_comm_every(comm_every), j_resolve(comm_every)
    assert isinstance(got, CommCadence)
    assert got.per_dim == ref.per_dim and str(got) == str(ref) and got.deep == ref.deep
    assert resolve_comm_every(str(got)).per_dim == got.per_dim  # the string round-trips
    assert got.uniform == ref.uniform and got.cycle == ref.cycle
    assert [got.for_dim(d) for d in range(-1, 5)] == [ref.for_dim(d) for d in range(-1, 5)]
    for j in range(2 * got.cycle):
        for nd in (2, 3):
            assert got.retreats(j, nd) == ref.retreats(j, nd)
            assert got.due_dims(j, nd) == ref.due_dims(j, nd)
        assert got.due_dims(j, 3, order=(0, 1, 2)) == ref.due_dims(j, 3, order=(0, 1, 2))


@pytest.mark.parametrize("model", ["diffusion", "acoustic", "stokes"])
@pytest.mark.parametrize("spelling", list(SPELLINGS))
def test_models_run_cadence_one_and_refuse_deep(model, spelling, monkeypatch):
    """Cadence 1 runs in every spelling; a deep spelling no longer raises:
    it runs one cycle of the deep super-step from its ``init_*`` (and the
    variable's cadence where no value is given) and matches cadence 1 on
    the same grid bitwise. The grid is one block, periodic in x only, so x
    is the only exchanging dim: its halowidth carries k_x (2 k_x for the
    Stokes iteration's radius 2), its overlap twice that."""
    comm_every, env = SPELLINGS[spelling]
    _setenv(monkeypatch, env)
    cad = j_resolve(comm_every)
    init, run, fields, params, compared = _models()[model]
    kw = {} if comm_every is None else dict(comm_every=comm_every)
    if not cad.deep:
        tg.init_global_grid(6, 6, 6, periodx=1, device_type="cpu", quiet=True)
        state = init(**kw)
        run(fields(state), params(state))
        # the params' explicit value wins over a deep variable set afterwards
        monkeypatch.setenv("IGG_COMM_EVERY", "3")
        run(fields(state), params(state))
        return
    hw = (2 if model == "stokes" else 1) * cad.for_dim(0)
    tg.init_global_grid(max(6, 4 * hw), 6, 6, periodx=1, overlaps=(2 * hw, 2, 2),
                        halowidths=(hw, 1, 1), device_type="cpu", quiet=True)
    state = init(**kw)
    p = params(state)
    assert resolve_comm_every(p.comm_every).per_dim == cad.per_dim
    f = tg.update_halo(*fields(state))   # halos consistent with what they mirror
    deep = run(f, p, cad.cycle)
    one = run(f, dataclasses.replace(p, comm_every=1), cad.cycle, impl="plain")
    for a, b in list(zip(deep, one))[:compared]:
        assert np.array_equal(tg.gather_interior(a), tg.gather_interior(b))
