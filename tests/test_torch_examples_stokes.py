"""The port's Stokes example (`examples/stokes3D_multixpu.py` of the port)
against the JAX package's at its ``--cpu`` size: the same iteration count,
its residuals and interior within the JAX suite's bound between its tiers
(rtol 1e-5, atol 1e-4); and the novis example as a subprocess with a timeout
of its own, its printed ``T interior mean`` held to the pin of
`tests/test_examples.py` (6.457611 within 5e-4).
"""

import re
import subprocess
import sys

import numpy as np

import implicitglobalgrid_tpu as igg
from implicitglobalgrid_tpu import models as jm

from torch_port_util import clean_torch_grid, example_env  # noqa: F401

TIER = dict(rtol=1e-5, atol=1e-4)


def test_stokes_example_matches_jax():
    from implicitglobalgrid_tpu_torch.examples.stokes3D_multixpu import stokes3D

    got = stokes3D(cpu=True)
    igg.init_global_grid(24, 24, 24, quiet=True)
    state, p = jm.init_stokes3d(dtype=np.float32)
    it, history = 0, []
    while it < 300:
        state = jm.run_stokes(state, p, 100, nt_chunk=100)
        it += 100
        history.append((it, *jm.stokes_residuals(state, p)))
        if max(history[-1][1:]) < 5e-4:
            break
    J = igg.gather_interior(state[0])
    assert got["iterations"] == it
    assert [h[0] for h in got["history"]] == [h[0] for h in history]
    assert np.allclose(np.array(got["history"])[:, 1:], np.array(history)[:, 1:], **TIER), \
        (got["history"], history)
    assert got["P"].shape == J.shape == (46, 46, 46)
    assert np.allclose(got["P"], J, **TIER), float(np.abs(got["P"] - J).max())
    assert history[-1][2] < history[0][2]


def test_novis_example_prints_the_pinned_mean(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "implicitglobalgrid_tpu_torch.examples.diffusion3D_multixpu_novis",
         "--cpu"], capture_output=True, text=True, timeout=300, cwd=tmp_path, env=example_env())
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "cell-updates/s" in proc.stdout
    m = re.search(r"T interior mean: ([0-9.]+)", proc.stdout)
    assert m is not None, proc.stdout
    assert abs(float(m.group(1)) - 6.457611) < 5e-4
