"""Port parity: `update_halo`, `gather` and `gather_interior` on the virtual
mesh are BITWISE equal to the JAX package's on its 8-device CPU mesh (halo
movement and gathers are pure copies). Every case runs twice: with the
kernel tier on (the CPU runs the kernels' plain versions through their
wrappers) and with ``IGG_USE_PALLAS=0`` (slice copies)."""

import numpy as np
import pytest

import implicitglobalgrid_tpu as igg
import implicitglobalgrid_tpu_torch as tg
from torch_port_util import clean_torch_grid, init_both, to_np  # noqa: F401

CASES = [
    ("1 block periodic (self-exchange)", (8, 8, 8),
     dict(dimx=1, dimy=1, dimz=1, periodx=1, periody=1, periodz=1)),
    ("2x2x2 periodic", (6, 7, 8), dict(dimx=2, dimy=2, dimz=2, periodx=1,
                                      periody=1, periodz=1)),
    ("2x2x2 non-periodic", (6, 7, 8), dict(dimx=2, dimy=2, dimz=2)),
    ("2x2x2 mixed, hw 2", (10, 9, 8), dict(dimx=2, dimy=2, dimz=2, periody=1,
                                           overlaps=(4, 4, 4),
                                           halowidths=(2, 2, 2))),
    ("1 block periodic, hw 2", (10, 10, 10),
     dict(periodx=1, periody=1, periodz=1, dimx=1, dimy=1, dimz=1,
          overlaps=(4, 4, 4), halowidths=(2, 2, 2))),
    ("4x2x1 disp 2", (6, 6, 6), dict(dimx=4, dimy=2, dimz=1, disp=2,
                                     periodz=1)),
]


def _rand(shape, dtype=np.float64, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


@pytest.fixture(params=["kernel", "plain"])
def tier(request, monkeypatch):
    if request.param == "plain":
        monkeypatch.setenv("IGG_USE_PALLAS", "0")
    return request.param


@pytest.mark.parametrize("label,n,kw", CASES, ids=[c[0] for c in CASES])
def test_update_halo_bitwise(label, n, kw, tier):
    init_both(*n, **kw)
    A = _rand(tuple(np.asarray(tg.global_grid().dims) * np.asarray(n)))
    ref = np.asarray(igg.update_halo(igg.device_put_g(A)))
    got = to_np(tg.update_halo(tg.device_put_g(A)))
    assert np.array_equal(got, ref), label
    assert not np.array_equal(got, A)


@pytest.mark.parametrize("label,n,kw", CASES[:3], ids=[c[0] for c in CASES[:3]])
def test_update_halo_non_contiguous_field(label, n, kw, tier):
    """A transposed view goes through the same exchange as a dense field:
    `update_halo` returns an exchanged dense copy and leaves the view alone."""
    import torch

    init_both(*n, **kw)
    A = _rand(tuple(np.asarray(tg.global_grid().dims) * np.asarray(n)), seed=6)
    V = torch.from_numpy(np.ascontiguousarray(A.transpose(2, 1, 0))).permute(2, 1, 0)
    assert not V.is_contiguous() and np.array_equal(to_np(V), A)
    got = tg.update_halo(V)
    assert got.is_contiguous()
    assert np.array_equal(to_np(got), np.asarray(igg.update_halo(igg.device_put_g(A))))
    assert np.array_equal(to_np(V), A)


@pytest.mark.parametrize("label,n,kw", CASES[:3], ids=[c[0] for c in CASES[:3]])
def test_update_halo_two_fields_and_dtypes(label, n, kw, tier):
    init_both(*n, **kw)
    dims = np.asarray(tg.global_grid().dims)
    A = _rand(tuple(dims * np.asarray(n)), np.float32, 1)
    B = (_rand(tuple(dims * (np.asarray(n) + (1, 0, 0))), np.float64, 2)
         * 1000).astype(np.int32)  # staggered along x, integer dtype
    ra, rb = igg.update_halo(igg.device_put_g(A), igg.device_put_g(B))
    ga, gb = tg.update_halo(tg.device_put_g(A), tg.device_put_g(B))
    assert np.array_equal(to_np(ga), np.asarray(ra))
    assert np.array_equal(to_np(gb), np.asarray(rb))


def test_update_halo_2d_and_dims_subset(tier):
    init_both(8, 6, dimx=4, dimy=2, periodx=1)
    A = _rand((32, 12), np.float32, 3)
    assert np.array_equal(to_np(tg.update_halo(tg.device_put_g(A))),
                          np.asarray(igg.update_halo(igg.device_put_g(A))))
    tg.finalize_global_grid()
    igg.finalize_global_grid()
    init_both(8, 8, 8, dimx=2, dimy=2, dimz=2, periodx=1, periody=1)
    A = _rand((16, 16, 16), np.float64, 4)
    assert np.array_equal(
        to_np(tg.update_halo(tg.device_put_g(A), dims=(1, 0))),
        np.asarray(igg.update_halo(igg.device_put_g(A), dims=(1, 0))))


@pytest.mark.parametrize("label,n,kw", CASES, ids=[c[0] for c in CASES])
def test_gather_bitwise(label, n, kw):
    init_both(*n, **kw)
    A = _rand(tuple(np.asarray(tg.global_grid().dims) * np.asarray(n)), seed=5)
    Aj = igg.update_halo(igg.device_put_g(A))
    At = tg.update_halo(tg.device_put_g(A))
    assert np.array_equal(tg.gather(At), np.asarray(igg.gather(Aj)))
    assert np.array_equal(tg.gather_interior(At), igg.gather_interior(Aj))
    out = np.zeros_like(A)
    assert tg.gather(At, out) is out and np.array_equal(out, to_np(At))


def test_update_halo_errors():
    tg.init_global_grid(8, 8, 8, dimx=2, dimy=2, dimz=2, nranks=8,
                        device_type="cpu", quiet=True)
    T = tg.zeros_g()
    with pytest.raises(tg.exceptions.InvalidArgumentError):
        tg.update_halo()
    with pytest.raises(tg.exceptions.IncoherentArgumentError):
        tg.update_halo(T, T)
    with pytest.raises(tg.exceptions.IncoherentArgumentError):
        tg.update_halo(T[:15])
    with pytest.raises(tg.exceptions.InvalidArgumentError):
        tg.update_halo(T, wire_dtype="bfloat17")
    with pytest.raises(tg.exceptions.InvalidArgumentError):
        tg.update_halo(T, wire_stage="z:sideways")
