"""The port's examples (`implicitglobalgrid_tpu_torch.examples`) against the
JAX package's, at the JAX examples' ``--cpu`` sizes.

- In-process: each example's function beside the JAX example's own calls
  on the 8-device mesh (`init_global_grid`, `init_*`, `run_*`,
  `gather_interior`): diffusion and acoustic within the JAX suite's bound
  between its tiers (rtol 1e-5, atol 1e-4: `ops/pallas_stencil.py:16-18`,
  `tests/test_pallas.py`); Stokes to the same iteration count, its
  residuals and interior within that bound.
- As subprocesses, each with a timeout of its own: the novis example's
  printed ``T interior mean`` held to the pin of `tests/test_examples.py`
  (6.457611 within 5e-4), and the acoustic example under ``torchrun
  --nproc_per_node=2`` printing the line of the one-process run.
"""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np

import implicitglobalgrid_tpu as igg
from implicitglobalgrid_tpu import models as jm

from torch_port_util import clean_torch_grid  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIER = dict(rtol=1e-5, atol=1e-4)
_LINES: dict = {}


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "MASTER_ADDR", "WORLD_SIZE")}
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _p_lines(out):
    return [ln for ln in out.splitlines() if ln.startswith("P interior")]


def test_diffusion_example_matches_jax():
    from implicitglobalgrid_tpu_torch.examples.diffusion3D_multixpu_novis import diffusion3D

    G = diffusion3D(cpu=True)
    igg.init_global_grid(64, 64, 64, quiet=True)
    T, Cp, p = jm.init_diffusion3d(lam=1.0, cp_min=1.0, lx=10.0, ly=10.0, lz=10.0,
                                   dtype=np.float32)
    J = igg.gather_interior(jm.run_diffusion(T, Cp, p, 100, nt_chunk=10))
    assert G.shape == J.shape == (126, 126, 126) and G.dtype == np.float32
    assert np.allclose(G, J, **TIER), float(np.abs(G - J).max())
    assert abs(float(G.mean()) - 6.457611) < 5e-4


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
         "--cpu"], capture_output=True, text=True, timeout=300, cwd=tmp_path, env=_env())
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "cell-updates/s" in proc.stdout
    m = re.search(r"T interior mean: ([0-9.]+)", proc.stdout)
    assert m is not None, proc.stdout
    assert abs(float(m.group(1)) - 6.457611) < 5e-4


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
        capture_output=True, text=True, timeout=300, cwd=tmp_path, env=_env())
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = _p_lines(proc.stdout)
    assert lines and lines == _LINES["acoustic"], (lines, _LINES["acoustic"])


def test_advanced_modes_example_matches_jax(capsys):
    """The advanced-modes example's three parts beside the JAX example's
    calls (32^3 x 40 steps): plain bfloat16's distance from float32 as
    JAX's (the plain route is JAX's ``xla`` tier), stochastic rounding
    nearer float32 than plain bfloat16 in both (its bits differ: the port
    hashes the cell, JAX draws from its key), the deep run's line, and the
    measured overlap with the exchange's labels as comm."""
    from implicitglobalgrid_tpu_torch.examples.diffusion3D_advanced_modes import main

    got = main(cpu=True)
    out = capsys.readouterr().out
    assert "comm_every=2: 40 steps" in out and "overlap[CPU]" in out
    import jax.numpy as jnp

    finals = {}
    for tag, dtype, sr in (("f32", jnp.float32, False), ("bf16", jnp.bfloat16, False),
                           ("bf16_sr", jnp.bfloat16, True)):
        igg.init_global_grid(32, 32, 32, quiet=True)
        T, Cp, p = jm.init_diffusion3d(dtype=dtype, sr=sr)
        out = jm.run_diffusion(T, Cp, p, 40, nt_chunk=40, impl="xla" if not sr else None)
        finals[tag] = np.asarray(igg.gather_interior(out)).astype(np.float64)
        igg.finalize_global_grid()
    scale = np.abs(finals["f32"]).max()
    ref = {t: float(np.abs(finals[t] - finals["f32"]).max() / scale) for t in ("bf16", "bf16_sr")}
    assert np.isclose(got["sr"]["bf16"], ref["bf16"], rtol=1e-3), (got["sr"], ref)
    assert got["sr"]["bf16_sr"] < got["sr"]["bf16"] and ref["bf16_sr"] < ref["bf16"]
    assert got["deep_s"] > 0
    s = got["overlap"]["CPU"]
    assert s["comm_us"] > 0 and s["compute_us"] > 0


def test_vis_example_frames_match_jax(tmp_path, capsys):
    """The fifth example (`diffusion3D_multixpu`, `run_resilient` with a
    snapshot every ``nvis`` steps and a `Stats` reducer, the z-midplane of
    each snapshot read back) beside the JAX example's own calls at its
    ``--cpu`` size: the same 10 frames within the bound between tiers, the
    last frame bitwise the z-midplane of the run's final interior, and the
    printed stats lines for every frame."""
    from implicitglobalgrid_tpu_torch.examples.diffusion3D_multixpu import diffusion3D

    frames, G = diffusion3D(cpu=True)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("step ")]
    assert len(lines) == 10 and lines[-1].startswith("step  100")
    assert frames.shape == (10, 126, 126) and frames.dtype == np.float32
    assert np.array_equal(frames[-1], G[:, :, G.shape[2] // 2])
    igg.init_global_grid(64, 64, 64, quiet=True)
    T, Cp, p = jm.init_diffusion3d(dtype=np.float32)

    def step(s):
        return {"T": jm.diffusion_step_local(s["T"], s["Cp"], p, "xla"), "Cp": s["Cp"]}

    snaps = tmp_path / "snaps"
    igg.run_resilient(step, {"T": T, "Cp": Cp}, 100, nt_chunk=10, key="diffusion3D_vis",
                      snapshot_dir=str(snaps), snapshot_every=10, snapshot_fields=("T",),
                      reducers=[igg.Stats("T", which=("max", "mean"))])
    listed = igg.list_snapshots(str(snaps))
    zmid = igg.open_snapshot(listed[0][1]).global_shape("T")[2] // 2
    J = np.stack([igg.open_snapshot(path).read_global("T", box=(None, None, (zmid, zmid + 1)))
                  [:, :, 0] for _, path in listed])
    assert J.shape == frames.shape
    assert np.allclose(frames, J, **TIER), float(np.abs(frames - J).max())
