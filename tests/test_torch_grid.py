"""Port parity: the PyTorch port's grid lifecycle against the JAX package.

For the same arguments the `GlobalGrid` fields (implicit global size, dims,
coords, neighbours, periods, overlaps, halowidths) must be equal; the error
cases must raise errors of the same type; and an entry point must not fall
back to the CPU silently when CUDA is absent."""

import numpy as np
import pytest

import implicitglobalgrid_tpu as igg
import implicitglobalgrid_tpu_torch as tg
from torch_port_util import clean_torch_grid, init_both  # noqa: F401


@pytest.mark.parametrize("args,kw", [
    ((8, 8, 8), {}),
    ((8, 8, 8), dict(dimx=2, dimy=2, dimz=2, periodx=1)),
    ((6, 8, 10), dict(periodx=1, periody=1, periodz=1)),
    ((8, 8, 8), dict(dimx=4, dimy=2, dimz=1, periodz=1)),
    ((8, 8, 8), dict(dimx=1, dimy=1, dimz=1, periodx=1, periody=1, periodz=1)),
    ((10, 10, 10), dict(dimx=2, overlaps=(4, 4, 4), halowidths=(2, 2, 2))),
    ((8, 8, 8), dict(dimx=2, dimy=2, dimz=2, overlaps=(3, 2, 4), periody=1)),
    ((8, 8, 1), dict(dimz=1)),
    ((16, 1, 1), dict(periodx=1)),
    ((8, 8, 8), dict(dimx=8, dimy=1, dimz=1, disp=2, periodx=1)),
])
def test_global_grid_fields_match_jax(args, kw):
    init_both(*args, **kw)
    a, b = igg.global_grid(), tg.global_grid()
    for name in ("nxyz_g", "nxyz", "dims", "overlaps", "halowidths", "periods",
                 "coords"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name
    assert (a.nprocs, a.disp) == (b.nprocs, b.disp)
    assert tg.nx_g() == igg.nx_g() and tg.ny_g() == igg.ny_g() \
        and tg.nz_g() == igg.nz_g()
    for rank in range(b.nprocs):
        c = tg.parallel.topology.cart_coords(rank, b.dims)
        assert np.array_equal(tg.neighbors_table(c), igg.neighbors_table(c))
        assert b.mesh[tuple(c)] == rank


@pytest.mark.parametrize("args,kw", [
    ((1, 8, 8), {}),
    ((8, 1, 8), {}),
    ((8, 8, 8), dict(dimx=-1)),
    ((8, 8, 8), dict(periodx=2)),
    ((8, 8, 8), dict(halowidths=(0, 1, 1))),
    ((8, 8, 1), dict(dimz=2)),
    ((3, 8, 8), dict(periodx=1, overlaps=(4, 2, 2))),
    ((8, 8, 8), dict(overlaps=(2, 2, 2), halowidths=(2, 1, 1))),
    ((8, 8, 8), dict(device_type="quantum")),
    ((8, 8, 8), dict(overlaps=(2, 2))),
])
def test_errors_match_jax_types(args, kw):
    with pytest.raises(igg.exceptions.GlobalGridError) as ja:
        igg.init_global_grid(*args, quiet=True, **kw)
    kw_t = dict(kw)
    kw_t.setdefault("device_type", "cpu")
    with pytest.raises(tg.exceptions.GlobalGridError) as tt:
        tg.init_global_grid(*args, quiet=True, nranks=8, **kw_t)
    assert type(tt.value).__name__ == type(ja.value).__name__
    if "device_type" not in kw:  # the port lists its own device types
        assert str(tt.value) == str(ja.value)


def test_double_init_and_use_after_finalize():
    tg.init_global_grid(8, 8, 8, device_type="cpu", quiet=True)
    with pytest.raises(tg.exceptions.AlreadyInitializedError):
        tg.init_global_grid(8, 8, 8, device_type="cpu", quiet=True)
    tg.finalize_global_grid()
    with pytest.raises(tg.exceptions.NotInitializedError):
        tg.zeros_g()
    with pytest.raises(tg.exceptions.NotInitializedError):
        tg.finalize_global_grid()


def test_gpu_default_raises_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default grid is valid here")
    for dt in ({}, {"device_type": "gpu"}, {"device_type": "auto"}):
        with pytest.raises(tg.exceptions.NotLoadedError):
            tg.init_global_grid(8, 8, 8, quiet=True, **dt)
    assert not tg.grid_is_initialized()


def test_nranks_dims_create_and_env_flag(monkeypatch):
    me, dims, nprocs, coords, mesh = tg.init_global_grid(
        8, 8, 8, nranks=12, device_type="cpu", quiet=True)
    assert nprocs == 12 and tuple(dims) == tuple(igg.dims_create(12, [0, 0, 0]))
    assert me == 0 and mesh.shape == tuple(dims)
    assert tg.global_grid().use_pallas.all()
    tg.finalize_global_grid()
    monkeypatch.setenv("IGG_USE_PALLAS", "0")
    monkeypatch.setenv("IGG_USE_PALLAS_DIMY", "1")
    tg.init_global_grid(8, 8, 8, device_type="cpu", quiet=True)
    assert tuple(tg.global_grid().use_pallas) == (False, True, False)
    assert tg.select_device() == 0
    tg.finalize_global_grid()
    monkeypatch.setenv("IGG_USE_POLYESTER", "1")
    with pytest.raises(tg.exceptions.InvalidArgumentError):
        tg.init_global_grid(8, 8, 8, device_type="cpu", quiet=True)


def test_tic_toc():
    tg.init_global_grid(8, 8, 8, device_type="cpu", quiet=True)
    tg.tic()
    assert tg.toc() >= 0.0
    tg.utils.timing._t0 = None
    with pytest.raises(tg.exceptions.InvalidArgumentError):
        tg.toc()
