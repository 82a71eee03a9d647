"""The exchange cadence (``comm_every``, ``IGG_COMM_EVERY``) of the port's
models, resolved beside the JAX package's resolver
(`implicitglobalgrid_tpu/ops/wire.py` `resolve_comm_every`):

- each spelling resolves to the same per-axis cadence and string in both
  packages (an explicit value wins over the variable, an empty variable
  and ``"z:1"`` are cadence 1);
- every model (diffusion, acoustic, Stokes) runs a cadence-1 spelling, from
  its ``init_*`` and from params given the value explicitly, and refuses a
  deep cadence, which the port does not have yet (`NotSupportedError`).
"""

import dataclasses

import pytest
import torch

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
    return {
        "diffusion": (lambda **kw: init_diffusion3d(dtype=torch.float64, **kw),
                      lambda s: run_diffusion(s[0], s[1], s[2], 1)),
        "acoustic": (lambda **kw: init_acoustic3d(dtype=torch.float64, **kw),
                     lambda s: run_acoustic(s[0], s[1], 1)),
        "stokes": (lambda **kw: init_stokes3d(dtype=torch.float64, **kw),
                   lambda s: run_stokes(s[0], s[1], 1)),
    }


@pytest.mark.parametrize("spelling", list(SPELLINGS))
def test_resolves_as_jax(spelling, monkeypatch):
    comm_every, env = SPELLINGS[spelling]
    _setenv(monkeypatch, env)
    got, ref = resolve_comm_every(comm_every), j_resolve(comm_every)
    assert isinstance(got, CommCadence)
    assert got.per_dim == ref.per_dim and str(got) == str(ref) and got.deep == ref.deep
    assert resolve_comm_every(str(got)).per_dim == got.per_dim  # the string round-trips


@pytest.mark.parametrize("model", ["diffusion", "acoustic", "stokes"])
@pytest.mark.parametrize("spelling", list(SPELLINGS))
def test_models_run_cadence_one_and_refuse_deep(model, spelling, monkeypatch):
    comm_every, env = SPELLINGS[spelling]
    _setenv(monkeypatch, env)
    deep = j_resolve(comm_every).deep
    tg.init_global_grid(6, 6, 6, periodx=1, device_type="cpu", quiet=True)
    init, run = _models()[model]
    NS = tg.exceptions.NotSupportedError
    kw = {} if comm_every is None else dict(comm_every=comm_every)
    if deep:
        with pytest.raises(NS):
            init(**kw)
        _setenv(monkeypatch, None)
        state = init()
        with pytest.raises(NS):   # the deep value given to the params themselves
            run(state[:-1] + (dataclasses.replace(state[-1], comm_every=comm_every
                                                  if comm_every is not None else env),))
        return
    state = init(**kw)
    run(state)
    # the params' explicit value wins over a deep variable set afterwards
    monkeypatch.setenv("IGG_COMM_EVERY", "3")
    run(state)
