"""Port parity of ``init_global_grid(devices=)`` and `sharding_of`.

- a ``devices=["cpu"] * n`` grid equals the JAX package's
  ``devices=jax.devices()[:n]`` grid in ``dims``, ``nprocs``, ``coords`` and
  ``nxyz_g``, the pool of 8 with ``dimx=3`` included (6 used, with JAX's
  warning);
- a pool too small raises JAX's types and messages ("device pool",
  "exceeds");
- the port's own refusals: a list that mixes CUDA and CPU or spans two
  cards (`NotSupportedError`), a ``device_type`` or ``nranks`` that
  contradicts the list (`IncoherentArgumentError`), an empty list; no grid
  is left behind;
- a few diffusion steps on a ``devices=`` grid (2x2x2 x 8^3, seeded) are
  bitwise the port's ``nranks=8`` run and equal JAX's within
  `tests/test_torch_diffusion.py`'s bounds;
- ``sharding_of(n).spec == tuple(igg.sharding_of(n).spec)`` for n = 1..5,
  and its stacked shape is the shape `zeros_g`, `full_g`, `device_put_g`
  and (a 3-D field's) `ensemble_state` allocate.
"""

import dataclasses
import warnings

import jax
import numpy as np
import pytest
import torch

import implicitglobalgrid_tpu as igg
import implicitglobalgrid_tpu_torch as tg
from implicitglobalgrid_tpu.models import init_diffusion3d as j_init3d
from implicitglobalgrid_tpu.models import run_diffusion as j_run
from implicitglobalgrid_tpu.utils.exceptions import InvalidArgumentError as JInvalidArgumentError
from implicitglobalgrid_tpu_torch.models import run_diffusion, state_from_numpy
from implicitglobalgrid_tpu_torch.utils.exceptions import (
    IncoherentArgumentError, InvalidArgumentError, NotLoadedError, NotSupportedError,
)
from torch_port_util import clean_torch_grid, to_np  # noqa: F401

TOL = {np.float32: dict(rtol=1e-5, atol=1e-4), np.float64: dict(rtol=1e-12, atol=1e-12)}

# (pool size, local block, grid kwargs)
POOLS = {
    "8 free": (8, (8, 8, 8), {}),
    "8 dimx=3": (8, (4, 4, 4), dict(dimx=3)),
    "4 free periodic": (4, (6, 6, 6), dict(periodx=1, periodz=1)),
    "8 fixed 2x2x2": (8, (8, 8, 8), dict(dimx=2, dimy=2, dimz=2)),
    "8 fixed 2x1x1 (a subset)": (8, (8, 8, 8), dict(dimx=2, dimy=1, dimz=1)),
    "6 2-D": (6, (8, 8, 1), dict(periody=1)),
    "5 dimx=5": (5, (8, 8, 8), dict(dimx=5)),
}


def _layout(ret, gg):
    me, dims, nprocs, coords, _ = ret
    return (int(me), [int(d) for d in dims], int(nprocs), [int(c) for c in coords],
            [int(n) for n in gg.nxyz_g])


def _init_jax(n, loc, kw):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        ret = igg.init_global_grid(*loc, devices=jax.devices()[:n], quiet=True, **kw)
    return _layout(ret, igg.global_grid()), [str(x.message) for x in w]


def _init_port(n, loc, kw, devices=None):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        ret = tg.init_global_grid(*loc, devices=devices or ["cpu"] * n, quiet=True, **kw)
    return _layout(ret, tg.global_grid()), [str(x.message) for x in w]


@pytest.mark.parametrize("label", list(POOLS))
def test_device_pool_grid_matches_jax(label):
    n, loc, kw = POOLS[label]
    want, jwarn = _init_jax(n, loc, kw)
    got, twarn = _init_port(n, loc, kw)
    assert got == want
    assert twarn == jwarn  # JAX's warning, where the pool is no multiple of the fixed dims
    gg = tg.global_grid()
    assert gg.device == torch.device("cpu") and gg.device_type == "cpu"
    assert tuple(gg.box) == tuple(gg.dims)  # one process: the virtual mesh


def test_pool_warning_names_the_idle_devices():
    _, twarn = _init_port(*POOLS["8 dimx=3"])
    assert len(twarn) == 1 and "using 6 device(s)" in twarn[0] and "2 idle" in twarn[0]


def test_torch_device_entries_and_strings_mix():
    """``torch.device``s and strings are one pool; the grid allocates there."""
    got, _ = _init_port(8, (6, 6, 6), {}, devices=[torch.device("cpu"), "cpu"] * 4)
    assert got[1:3] == ([2, 2, 2], 8)
    assert tg.zeros_g().device == torch.device("cpu")


@pytest.mark.parametrize("n,loc,kw,match", [
    (8, (32, 32, 32), dict(dimx=16), "device pool"),
    (8, (4, 4, 4), dict(dimx=5, dimy=2), "device pool"),
    (8, (4, 4, 4), dict(dimx=5, dimy=2, dimz=1), "exceeds the 8 available"),
    (2, (8, 8, 8), dict(dimx=2, dimy=2, dimz=2), "exceeds the 2 available"),
])
def test_pool_too_small_raises_as_jax(n, loc, kw, match):
    with pytest.raises(JInvalidArgumentError, match=match) as j:
        igg.init_global_grid(*loc, devices=jax.devices()[:n], quiet=True, **kw)
    with pytest.raises(InvalidArgumentError, match=match) as t:
        tg.init_global_grid(*loc, devices=["cpu"] * n, quiet=True, **kw)
    assert str(t.value) == str(j.value)
    assert not tg.grid_is_initialized() and not igg.grid_is_initialized()


@pytest.mark.parametrize("devices,kw,err,match", [
    (["cuda:0"] * 4 + ["cuda:1"] * 4, {}, NotSupportedError, "spans cuda:0, cuda:1"),
    ([torch.device("cuda", 0)] * 4 + ["cpu"] * 4, {}, NotSupportedError,
     "mixes CUDA and CPU"),
    (["cpu"] * 8, dict(device_type="gpu"), IncoherentArgumentError, "contradicts devices="),
    (["cuda:0"] * 8, dict(device_type="cpu"), IncoherentArgumentError,
     "contradicts devices="),
    (["cpu"] * 8, dict(nranks=4), IncoherentArgumentError, "nranks=4 contradicts"),
    ([], {}, InvalidArgumentError, "empty"),
    (["meta"] * 8, {}, NotSupportedError, "CUDA or the CPU"),
    (["no-such-device"] * 8, {}, InvalidArgumentError, "no torch device"),
])
def test_port_refusals(devices, kw, err, match):
    """A process holds its box as one tensor on one device: a list that
    spans two cards or mixes CUDA and CPU raises with that reason, whether
    or not the cards exist; contradicting arguments raise too."""
    with pytest.raises(err, match=match) as e:
        tg.init_global_grid(8, 8, 8, dimx=2, dimy=2, dimz=2, devices=devices, quiet=True,
                            **kw)
    if err is NotSupportedError and "spans" in match:
        assert "one stacked tensor on one device" in str(e.value)
    assert not tg.grid_is_initialized()


def test_card_list_needs_cuda_or_builds_on_that_card():
    """``[cuda:0] * 8``: without CUDA `NotLoadedError` (no CPU fallback),
    with it a grid on that card."""
    if not torch.cuda.is_available():
        with pytest.raises(NotLoadedError, match="CUDA is not available"):
            tg.init_global_grid(8, 8, 8, devices=[torch.device("cuda", 0)] * 8, quiet=True)
        assert not tg.grid_is_initialized()
        return
    tg.init_global_grid(8, 8, 8, devices=[torch.device("cuda", 0)] * 8, quiet=True)
    assert tg.global_grid().device == torch.device("cuda", 0)


@pytest.fixture
def cards(monkeypatch):
    """``cards(n)``: CUDA made to look present with ``n`` cards for the
    pool's binding checks (the grid allocates nothing on them)."""
    def make(n):
        cur = {"index": 0}
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
        monkeypatch.setattr(torch.cuda, "current_device", lambda: cur["index"])
        monkeypatch.setattr(torch.cuda, "set_device",
                            lambda d: cur.update(index=int(getattr(d, "index", d))))
        monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
        return cur
    return make


@pytest.mark.parametrize("n_cards,devices,kw,want", [
    (1, [torch.device("cuda", 0)] * 8, {}, "cuda:0"),
    (1, ["cuda"] * 8, {}, "cuda:0"),
    (2, ["cuda:1"] * 8, dict(select_device=False), "cuda:1"),
    (2, ["cuda:1"] * 8, {}, (IncoherentArgumentError, "select_device binds cuda:0")),
    (1, ["cuda:1"] * 8, dict(select_device=False), (InvalidArgumentError, "has 1 CUDA")),
])
def test_card_list_binds_the_card_select_device_binds(cards, n_cards, devices, kw, want):
    """One process: ``select_device`` binds the card of its node-local rank
    (cuda:0), which the list must name; without it the listed card is the
    grid's, if the host has it. An entry without an index is the current
    card."""
    cur = cards(n_cards)
    if isinstance(want, tuple):
        with pytest.raises(want[0], match=want[1]):
            tg.init_global_grid(8, 8, 8, dimx=2, dimy=2, dimz=2, devices=devices, quiet=True,
                                **kw)
        assert not tg.grid_is_initialized()
        return
    tg.init_global_grid(8, 8, 8, dimx=2, dimy=2, dimz=2, devices=devices, quiet=True, **kw)
    gg = tg.global_grid()
    assert str(gg.device) == str(gg.transport.device) == want and gg.device_type == "gpu"
    assert str(tg.sharding_of(3).device) == want
    assert cur["index"] == 0  # select_device bound cuda:0, or nothing was bound


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_diffusion_on_device_pool_is_the_nranks_run(dtype):
    """5 fused-route steps on a ``devices=["cpu"] * 8`` grid (2x2x2 x 8^3,
    periodic x) from a seeded state: bitwise the ``nranks=8`` grid's run,
    and JAX's ``pallas_interpret`` run on its ``devices=`` grid within the
    multi-step bounds."""
    kw = dict(dimx=2, dimy=2, dimz=2, periodx=1)
    igg.init_global_grid(8, 8, 8, devices=jax.devices()[:8], quiet=True, **kw)
    T, Cp, p = j_init3d(dtype=dtype)
    g = np.random.default_rng(21)
    T0 = np.asarray(T) * (1 + 0.1 * g.standard_normal(np.shape(T))).astype(dtype)
    ref = np.asarray(j_run(igg.device_put_g(T0), Cp, p, 5, nt_chunk=5,
                           impl="pallas_interpret"))
    runs = []
    for grid in (dict(devices=["cpu"] * 8), dict(nranks=8, device_type="cpu")):
        tg.init_global_grid(8, 8, 8, quiet=True, **grid, **kw)
        t, c, q = state_from_numpy(T0, np.asarray(Cp), dataclasses.asdict(p), "cpu")
        runs.append(to_np(run_diffusion(t, c, q, 5, nt_chunk=5)))
        tg.finalize_global_grid()
    assert runs[0].tobytes() == runs[1].tobytes()
    assert np.allclose(runs[0], ref, **TOL[dtype])
    assert not np.allclose(ref, T0)


@pytest.mark.parametrize("ndim", [1, 2, 3, 4, 5])
def test_sharding_of_spec_matches_jax(ndim):
    kw = dict(dimx=2, dimy=2, dimz=2)
    igg.init_global_grid(6, 6, 6, devices=jax.devices()[:8], quiet=True, **kw)
    tg.init_global_grid(6, 6, 6, devices=["cpu"] * 8, quiet=True, **kw)
    s = tg.sharding_of(ndim)
    assert s.spec == tuple(igg.sharding_of(ndim).spec)
    assert (s.dims, s.box, s.coords, s.device) == ((2, 2, 2), (2, 2, 2), (0, 0, 0),
                                                   torch.device("cpu"))
    with pytest.raises(dataclasses.FrozenInstanceError):
        s.box = (1, 1, 1)


@pytest.mark.parametrize("local", [(6,), (6, 7), (7, 6, 5), (6, 6, 6)])
def test_sharding_of_stacked_shape_is_what_alloc_allocates(local):
    """The stacked shape of a local block shape: `zeros_g`'s, `full_g`'s and
    `device_put_g`'s (JAX's global shape on the virtual mesh), on the
    layout's device; an ensemble's member axis stays whole."""
    kw = dict(dimx=2, dimy=2, dimz=2)
    igg.init_global_grid(6, 6, 6, devices=jax.devices()[:8], quiet=True, **kw)
    tg.init_global_grid(6, 6, 6, devices=["cpu"] * 8, quiet=True, **kw)
    s = tg.sharding_of(len(local))
    want = s.stacked_shape(local)
    Z, F = tg.zeros_g(local), tg.full_g(local, 2.0, dtype=torch.float64)
    P = tg.device_put_g(np.zeros(want, np.float32))
    for A in (Z, F, P):
        assert tuple(A.shape) == want and A.device == s.device
    assert want == tuple(igg.zeros_g(local).shape)
    if len(local) == 3:  # a 3-D field's members lead (JAX's spec beyond NDIMS)
        E = tg.ensemble_state(tg.zeros_g(local), 3)
        assert tg.sharding_of(4).stacked_shape((3,) + local) == tuple(E.shape)
    with pytest.raises(InvalidArgumentError):
        s.stacked_shape(local + (2,))


def test_sharding_of_needs_a_grid_and_an_axis():
    from implicitglobalgrid_tpu_torch.utils.exceptions import NotInitializedError

    with pytest.raises(NotInitializedError):
        tg.sharding_of(3)
    tg.init_global_grid(6, 6, 6, devices=["cpu"] * 8, quiet=True)
    with pytest.raises(InvalidArgumentError):
        tg.sharding_of(0)
