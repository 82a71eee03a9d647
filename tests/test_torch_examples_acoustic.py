"""The port's acoustic example (`examples/acoustic3D_multixpu.py` of the port)
against the JAX package's at its ``--cpu`` size, in process (within the JAX
suite's bound between its tiers, rtol 1e-5, atol 1e-4), and under ``torchrun
--nproc_per_node=2`` as a subprocess with a timeout of its own, printing the
line of the one-process run.
"""

import subprocess
import sys

import numpy as np

import implicitglobalgrid_tpu as igg
from implicitglobalgrid_tpu import models as jm

from torch_port_util import clean_torch_grid, example_env  # noqa: F401

TIER = dict(rtol=1e-5, atol=1e-4)
_LINES: dict = {}


def _p_lines(out):
    return [ln for ln in out.splitlines() if ln.startswith("P interior")]


def test_acoustic_example_matches_jax(capsys):
    from implicitglobalgrid_tpu_torch.examples.acoustic3D_multixpu import acoustic3D

    P = acoustic3D(cpu=True)
    _LINES["acoustic"] = _p_lines(capsys.readouterr().out)
    igg.init_global_grid(32, 32, 32, periodx=1, periody=1, periodz=1, quiet=True)
    state, p = jm.init_acoustic3d(dtype=np.float32)
    J = igg.gather_interior(jm.run_acoustic(state, p, 60, nt_chunk=6)[0])
    assert P.shape == J.shape == (60, 60, 60)
    assert np.allclose(P, J, **TIER), float(np.abs(P - J).max())
    assert float(np.abs(P).max()) > 0


def test_acoustic_example_under_torchrun(tmp_path, capsys):
    """Two processes of `torchrun` (gloo on the CPU, each owning a box of
    the 8 ranks) print the one-process run's result line."""
    if "acoustic" not in _LINES:  # the one-process run, where this test runs alone
        from implicitglobalgrid_tpu_torch.examples.acoustic3D_multixpu import acoustic3D

        acoustic3D(cpu=True)
        _LINES["acoustic"] = _p_lines(capsys.readouterr().out)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2",
         "-m", "implicitglobalgrid_tpu_torch.examples.acoustic3D_multixpu", "--cpu"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path, env=example_env())
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = _p_lines(proc.stdout)
    assert lines and lines == _LINES["acoustic"], (lines, _LINES["acoustic"])
