"""The port's `gather`, `gather_interior` and `gather_sub` against the JAX
package's, each case on the 8-device JAX mesh beside an 8-rank port grid on
the CPU: ``root`` (a process index: None on every process but ``root``),
bfloat16 gathered as `ml_dtypes.bfloat16`, bitwise equal to JAX's, and
`gather_sub` on the cases of `tests/test_gather.py`."""

import ml_dtypes
import numpy as np
import pytest
import torch

import implicitglobalgrid_tpu as igg
import implicitglobalgrid_tpu_torch as tg
from implicitglobalgrid_tpu.utils import exceptions as jexc
from implicitglobalgrid_tpu_torch.utils import exceptions as texc

from torch_port_util import clean_torch_grid, init_both  # noqa: F401


def _encoded(dtype=np.float64):
    """The field of `tests/test_gather.py` (every cell encodes its global
    position), on both grids."""
    A = igg.zeros_g()
    cs = igg.coords_g(1.0, 1.0, 1.0, A)
    enc = sum(np.asarray(c) * 10.0 ** (3 * d) for d, c in enumerate(cs))
    enc = np.ascontiguousarray(enc + np.zeros(A.shape))
    if dtype is ml_dtypes.bfloat16:
        j = igg.device_put_g(enc.astype(ml_dtypes.bfloat16))
        t = tg.device_put_g(torch.from_numpy(enc).to(torch.bfloat16))
        return j, t
    return igg.device_put_g(enc.astype(dtype)), tg.device_put_g(enc.astype(dtype))


def _bitwise(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


def _gather_into(mod, A, shape, root):
    return mod.gather(A, np.zeros(shape), root=root)


CALLS = {
    "gather": lambda mod, A, root: mod.gather(A, root=root),
    "gather_A_global": lambda mod, A, root: _gather_into(mod, A, (10, 10, 10), root),
    "gather_interior": lambda mod, A, root: mod.gather_interior(A, root=root),
    "gather_sub": lambda mod, A, root: mod.gather_sub(A, ((0, 1), None, (1, 2)), root=root),
}


@pytest.mark.parametrize("root", [0, 1])
@pytest.mark.parametrize("call", list(CALLS))
def test_root_returns_none_where_jax_does(call, root):
    """The port returns None exactly where the JAX package does (process
    index != root; one process here, index 0), else the same array."""
    init_both(5, 5, 5, dimx=2, dimy=2, dimz=2)
    j, t = _encoded()
    want = CALLS[call](igg, j, root)
    got = CALLS[call](tg, t, root)
    assert (got is None) == (want is None), (call, root)
    if want is not None:
        assert _bitwise(got, want), (call, root)


@pytest.mark.parametrize("call", ["gather", "gather_interior"])
def test_bfloat16_gathers_as_bfloat16(call):
    init_both(5, 5, 5, dimx=2, dimy=2, dimz=2, periodx=1)
    j, t = _encoded(ml_dtypes.bfloat16)
    want = CALLS[call](igg, j, 0)
    got = CALLS[call](tg, t, 0)
    assert got.dtype == ml_dtypes.bfloat16
    assert _bitwise(got, want)


def test_gather_sub_block():
    """`tests/test_gather.py::test_gather_sub_block` on both packages."""
    init_both(5, 5, 5, dimx=2, dimy=2, dimz=2)
    j, t = _encoded(np.float32)
    for box in (((0, 1), (1, 2), (0, 1)), (None, (0, 1), (0, 2)), (None, (0, 1), None)):
        assert _bitwise(tg.gather_sub(t, box), igg.gather_sub(j, box)), box
    out_t, out_j = np.empty((10, 5, 10), np.float32), np.empty((10, 5, 10), np.float32)
    r = tg.gather_sub(t, (None, (0, 1), None), out_t)
    assert r is out_t
    assert _bitwise(out_t, igg.gather_sub(j, (None, (0, 1), None), out_j))
    with pytest.raises(texc.IncoherentArgumentError):
        tg.gather_sub(t, (None, (0, 1), None), np.empty((3, 3, 3)))
    with pytest.raises(jexc.IncoherentArgumentError):
        igg.gather_sub(j, (None, (0, 1), None), np.empty((3, 3, 3)))
    for bad in (((0, 3), None, None), ((1, 1), None, None)):
        with pytest.raises(texc.InvalidArgumentError):
            tg.gather_sub(t, bad)
        with pytest.raises(jexc.InvalidArgumentError):
            igg.gather_sub(j, bad)


def test_gather_sub_extra_box_dim_rejected():
    """`tests/test_gather.py::test_gather_sub_extra_box_dim_rejected`."""
    init_both(8, 8, 1, dimx=2, dimy=2, dimz=1)
    j = igg.ones_g((8, 8), np.float32)
    t = tg.ones_g((8, 8), torch.float32)
    with pytest.raises(texc.InvalidArgumentError):
        tg.gather_sub(t, ((0, 1), (0, 1), (0, 1)))
    with pytest.raises(jexc.InvalidArgumentError):
        igg.gather_sub(j, ((0, 1), (0, 1), (0, 1)))
    got, want = tg.gather_sub(t, ((0, 1), (0, 2))), igg.gather_sub(j, ((0, 1), (0, 2)))
    assert got.shape == (8, 16) and _bitwise(got, want)


def test_gather_sub_rejects_local_layout():
    """`tests/test_gather.py::test_gather_sub_rejects_local_layout`."""
    init_both(5, 5, 5, dimx=2, dimy=2, dimz=2)
    with pytest.raises(texc.InvalidArgumentError):
        tg.gather_sub(torch.zeros((5, 5, 5)), ((1, 2), None, None), layout="local")
    with pytest.raises(jexc.InvalidArgumentError):
        igg.gather_sub(np.zeros((5, 5, 5), np.float32), ((1, 2), None, None),
                       layout="local")


def test_gather_sub_is_exported():
    assert "gather_sub" in tg.__all__ and tg.gather_sub is not None
