"""The K4s Stokes modes' plain versions (`ops/cuda_stokes.py`) against the
JAX package's send-slab getters (`_v_get_slab`, `_pn_get_slab`), bitwise, on
every field, dim and start of one random block with a random rhog.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import implicitglobalgrid_tpu_torch.models.stokes as tst
from implicitglobalgrid_tpu.ops import pallas_stokes as ps
from implicitglobalgrid_tpu_torch.ops import cuda_stokes as cst
from torch_port_util import clean_torch_grid, to_np  # noqa: F401

FIELD_AXIS = {"Vx": 0, "Vy": 1, "Vz": 2}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_stokes_slab_getters_match_jax_bitwise(dtype):
    """Every field, dim and start (0 .. n-1) of one random block with a
    random rhog, against `_v_get_slab` / `_pn_get_slab` run op by op (a
    jitted getter is fused by XLA, which rounds differently)."""
    nx, ny, nz = 4, 3, 5
    rng = np.random.default_rng(17)
    shapes = cst.stokes_shapes((nx, ny, nz))
    arrs = [rng.standard_normal(shapes[f]).astype(dtype) for f in cst.STATE]
    p = tst.StokesParams(mu=1.3, dt_v=0.021, dt_p=0.7, damp=0.9, dx=0.31, dy=0.27, dz=0.35)
    jstate = tuple(jnp.asarray(a) for a in arrs)
    getters = {"P": ps._pn_get_slab(jstate, p),
               **{f: ps._v_get_slab(jstate, p, ax) for f, ax in FIELD_AXIS.items()}}
    tstate = tuple(torch.from_numpy(a) for a in arrs)
    consts = cst.stokes_consts(p)
    for f in cst.FIELDS:
        for dim in range(3):
            starts = list(range(shapes[f][dim]))
            got = cst.stokes_update_slab(tstate, f, dim, starts, 1, block=(nx, ny, nz),
                                         consts=consts)
            for st, g in zip(starts, got):
                ref = np.asarray(getters[f](dim, st, 1))
                assert g.shape == ref.shape, (f, dim, st)
                assert np.array_equal(to_np(g), ref), \
                    (f, dim, st, float(np.abs(to_np(g) - ref).max()))


