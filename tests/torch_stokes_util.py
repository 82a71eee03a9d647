"""Shared helpers of the Stokes parity tests (`tests/test_torch_stokes*.py`):
the grids of `tests/test_models_wave_stokes.py:93-99,183-188`, states
carried from the JAX package into the port, and the field comparison."""

import dataclasses

import numpy as np

import implicitglobalgrid_tpu as igg
import implicitglobalgrid_tpu_torch as tg
from implicitglobalgrid_tpu_torch.models import stokes_state_from_numpy
from torch_port_util import init_both

NAMES = ("P", "Vx", "Vy", "Vz", "dVx", "dVy", "dVz", "rhog")
TOL = {np.float32: 1e-5, np.float64: 1e-12}

GRIDS = {  # tests/test_models_wave_stokes.py:93-99,183-188
    "all self-neighbour": ((1, 1, 1), (1, 1, 1)),
    "all multi-rank periodic": ((2, 2, 2), (1, 1, 1)),
    "all multi-rank PROC_NULL edges": ((2, 2, 2), (0, 0, 0)),
    "self x + PROC_NULL y + 4-rank z": ((1, 2, 4), (1, 0, 1)),
    "no exchange at all": ((1, 1, 1), (0, 0, 0)),
}
CASES = [(g, d) for g in GRIDS for d in (np.float32, np.float64)]
IDS = [f"{g}-{np.dtype(d).name}" for g, d in CASES]


def init_grid(grid, n=(8, 8, 16)):
    """Both packages' grids of ``GRIDS[grid]``, local ``n``."""
    dims, periods = GRIDS[grid]
    kw = {f"dim{a}": v for a, v in zip("xyz", dims)}
    kw.update({f"period{a}": v for a, v in zip("xyz", periods)})
    init_both(*n, **kw)


def local_shapes(gg, state):
    return tuple(tuple(int(s) // int(gg.dims[d]) for d, s in enumerate(a.shape))
                 for a in state)


def random_rhog(state, seed):
    """The JAX state with rhog replaced by random values (the sphere's rhog
    is 0 or 1, where the kernel's and the getters' buoyancy forms agree bit
    for bit)."""
    rng = np.random.default_rng(seed)
    rh = np.asarray(state[7])
    rand = rng.standard_normal(rh.shape).astype(rh.dtype)
    return tuple(state[:7]) + (igg.device_put_g(rand),)


def port_state(state, p):
    """The JAX state and params on the port, on the CPU."""
    return stokes_state_from_numpy(*(np.asarray(a) for a in state), dataclasses.asdict(p),
                                   "cpu")


def spy(monkeypatch, module, name):
    """Count the calls of ``module.name``."""
    calls = []
    fn = getattr(module, name)

    def wrapped(*a, **k):
        calls.append(1)
        return fn(*a, **k)

    monkeypatch.setattr(module, name, wrapped)
    return calls


def compare(got, ref, dtype, label):
    """Every stacked field, halos included: rtol TOL, atol TOL*max|field|."""
    for g, r, name in zip(got, ref, NAMES):
        g, r = tg.gather(g), np.asarray(igg.gather(r))
        assert g.shape == r.shape and g.dtype == r.dtype, (label, name)
        tol = TOL[dtype]
        scale = max(1e-30, float(np.abs(r).max()))
        assert np.allclose(g, r, rtol=tol, atol=tol * scale), \
            (label, name, float(np.abs(g - r).max()))
