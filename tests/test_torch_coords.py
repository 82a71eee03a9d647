"""Port parity: global sizes and coordinates (`nx_g`, `x_g`, `coords_g`)
equal the JAX package's, for plain, staggered and periodic grids."""

import numpy as np
import pytest

import implicitglobalgrid_tpu as igg
import implicitglobalgrid_tpu_torch as tg
from torch_port_util import clean_torch_grid, init_both  # noqa: F401


@pytest.mark.parametrize("kw", [
    dict(dimx=2, dimy=2, dimz=2),
    dict(dimx=2, dimy=2, dimz=2, periodx=1, periodz=1),
    dict(dimx=1, dimy=1, dimz=1, periodx=1, periody=1, periodz=1),
    dict(dimx=4, dimy=2, dimz=1, periody=1, overlaps=(3, 2, 4)),
])
@pytest.mark.parametrize("stagger", [(0, 0, 0), (1, 0, -1)])
def test_coords_match_jax(kw, stagger):
    init_both(6, 7, 8, **kw)
    loc = tuple(n + s for n, s in zip((6, 7, 8), stagger))
    Aj = igg.zeros_g(loc)
    At = tg.zeros_g(loc, dtype=None)
    assert tuple(At.shape) == tuple(Aj.shape)
    for f in ("nx_g", "ny_g", "nz_g"):
        assert getattr(tg, f)(At) == getattr(igg, f)(Aj)
    for a, b in zip(tg.coords_g(0.5, 0.25, 2.0, At),
                    igg.coords_g(0.5, 0.25, 2.0, Aj)):
        assert np.array_equal(a, np.asarray(b))
    for i in range(At.shape[0]):
        assert float(tg.x_g(i, 0.5, At)) == float(igg.x_g(i, 0.5, Aj))
    for k in range(At.shape[2]):
        assert float(tg.z_g(k, 2.0, At)) == float(igg.z_g(k, 2.0, Aj))
    # a local block needs its rank's coordinate
    Lt = tg.zeros_g(loc)[: loc[0], : loc[1], : loc[2]]
    if int(tg.global_grid().dims[1]) > 1:
        with pytest.raises(tg.exceptions.InvalidArgumentError):
            tg.y_g(1, 0.25, Lt, layout="local")
    assert float(tg.y_g(1, 0.25, Lt, coords=(0, 1, 0), layout="local")) == \
        float(igg.y_g(1, 0.25, Lt.numpy(), coords=(0, 1, 0), layout="local"))
