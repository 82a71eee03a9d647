"""The port imports neither JAX nor the JAX package (checked in a fresh
interpreter, since this test process imports both), and neither its sources
nor `chip_smoke.py` name either in an import."""

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_import_leaves_jax_out():
    code = (
        "import sys\n"
        "import implicitglobalgrid_tpu_torch as tg\n"
        "import implicitglobalgrid_tpu_torch.models, implicitglobalgrid_tpu_torch.ops.cuda_halo\n"
        "import implicitglobalgrid_tpu_torch.ops.cuda_stencil, implicitglobalgrid_tpu_torch.ops.cuda_build\n"
        "import implicitglobalgrid_tpu_torch.models.acoustic, implicitglobalgrid_tpu_torch.ops.cuda_wave\n"
        "import implicitglobalgrid_tpu_torch.models.stokes, implicitglobalgrid_tpu_torch.ops.cuda_stokes\n"
        "import implicitglobalgrid_tpu_torch.parallel.transport\n"
        "import implicitglobalgrid_tpu_torch.examples.diffusion3D_multixpu_novis\n"
        "import implicitglobalgrid_tpu_torch.examples.acoustic3D_multixpu\n"
        "import implicitglobalgrid_tpu_torch.examples.stokes3D_multixpu\n"
        "import implicitglobalgrid_tpu_torch.examples.diffusion3D_advanced_modes\n"
        "import implicitglobalgrid_tpu_torch.utils.profiling, implicitglobalgrid_tpu_torch.utils.trace_events\n"
        "import implicitglobalgrid_tpu_torch.utils.blockio, implicitglobalgrid_tpu_torch.utils.checkpoint\n"
        "import implicitglobalgrid_tpu_torch.io.layout, implicitglobalgrid_tpu_torch.io.snapshot\n"
        "import implicitglobalgrid_tpu_torch.io.reader, implicitglobalgrid_tpu_torch.io.reducers\n"
        "import implicitglobalgrid_tpu_torch.runtime.health, implicitglobalgrid_tpu_torch.runtime.faults\n"
        "import implicitglobalgrid_tpu_torch.runtime.recovery, implicitglobalgrid_tpu_torch.runtime.driver\n"
        "import implicitglobalgrid_tpu_torch.runtime.spec, implicitglobalgrid_tpu_torch.telemetry\n"
        "import implicitglobalgrid_tpu_torch.telemetry.registry, implicitglobalgrid_tpu_torch.telemetry.recorder\n"
        "import implicitglobalgrid_tpu_torch.telemetry.hooks, implicitglobalgrid_tpu_torch.telemetry.export\n"
        "import implicitglobalgrid_tpu_torch.telemetry.report, implicitglobalgrid_tpu_torch.telemetry.perfmodel\n"
        "import implicitglobalgrid_tpu_torch.examples.diffusion3D_multixpu\n"
        "tg.init_global_grid(6, 6, 6, dimx=2, dimy=2, dimz=2, device_type='cpu', quiet=True)\n"
        "T, Cp, p = implicitglobalgrid_tpu_torch.models.init_diffusion3d()\n"
        "T = implicitglobalgrid_tpu_torch.models.run_diffusion(T, Cp, p, 2)\n"
        "tg.gather_interior(tg.update_halo(T))\n"
        "state, q = implicitglobalgrid_tpu_torch.models.init_acoustic3d()\n"
        "state = implicitglobalgrid_tpu_torch.models.run_acoustic(state, q, 2)\n"
        "tg.gather_interior(tg.update_halo(*state)[1])\n"
        "state, q = implicitglobalgrid_tpu_torch.models.init_stokes3d()\n"
        "state = implicitglobalgrid_tpu_torch.models.run_stokes(state, q, 2)\n"
        "implicitglobalgrid_tpu_torch.models.stokes_residuals(state, q)\n"
        "tg.gather_interior(state[3])\n"
        "tg.gather_sub(state[0], ((0, 1), None, None))\n"
        "E = implicitglobalgrid_tpu_torch.models.ensemble_state((T, Cp), 2, perturb=0.1)\n"
        "implicitglobalgrid_tpu_torch.models.run_diffusion(*E, p, 2, ensemble=2)\n"
        "import tempfile\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    with tg.trace(d):\n"
        "        tg.update_halo(T)\n"
        "    tg.overlap_stats(d), tg.op_breakdown(d)\n"
        "    tg.save_checkpoint_sharded(d + '/ck', {'T': T, 'Cp': Cp}, step=2)\n"
        "    tg.save_checkpoint(d + '/ck.npz', {'T': T}, step=2)\n"
        "    tg.restore_checkpoint(d + '/ck.npz')\n"
        "    tg.restore_checkpoint_sharded(d + '/ck')\n"
        "    T = tg.elastic_restart(d + '/ck', (1, 2, 4))[0]['T']\n"
        "    with tg.SnapshotWriter(d + '/s') as w:\n"
        "        w.submit({'T': T}, 2)\n"
        "    tg.open_snapshot(tg.list_snapshots(d + '/s')[0][1]).read_global('T')\n"
        "    from implicitglobalgrid_tpu_torch.io.reducers import make_reduced_post_chunk\n"
        "    plan = tg.io.build_reducer_plan([tg.Probe('T', (1, 1, 1)), tg.Stats('T')], ['T'], {'T': T})\n"
        "    run = implicitglobalgrid_tpu_torch.models.common.make_state_runner(\n"
        "        lambda s, spare: (s, None), nt_chunk=1, post_chunk=make_reduced_post_chunk(['T'], plan))\n"
        "    plan.decode(run(tg.poke_nan(T, (0, 0, 0)))[-1][2:])\n"
        "    tg.start_flight_recorder(d + '/fr.jsonl')\n"
        "    step = lambda s: {'T': tg.update_halo(s['T'] * 1.0)}\n"
        "    tg.run_resilient(step, {'T': T}, 4, nt_chunk=2, checkpoint_dir=d + '/rck',\n"
        "                     snapshot_dir=d + '/rs', reducers=[tg.Stats('T')],\n"
        "                     faults=[tg.NaNPoke(step=1, name='T', index=(3, 3, 3))])\n"
        "    tg.run_report(tg.stop_flight_recorder(), trace_dir=d)\n"
        "    tg.prometheus_snapshot()\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'implicitglobalgrid_tpu' or m.startswith('implicitglobalgrid_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_sources_name_no_jax():
    pkg = ROOT / "implicitglobalgrid_tpu_torch"
    files = [f for f in pkg.rglob("*.py") if "_build" not in f.relative_to(pkg).parts]
    files.append(ROOT / "chip_smoke.py")
    names = {f.relative_to(pkg).as_posix() for f in files if f.parent != ROOT}
    assert {"parallel/transport.py", "examples/diffusion3D_multixpu_novis.py",
            "examples/acoustic3D_multixpu.py", "examples/stokes3D_multixpu.py",
            "examples/diffusion3D_advanced_modes.py", "utils/profiling.py",
            "utils/trace_events.py", "utils/blockio.py", "utils/checkpoint.py",
            "io/layout.py", "io/snapshot.py", "io/reader.py", "io/reducers.py",
            "runtime/health.py", "runtime/faults.py", "runtime/recovery.py",
            "runtime/driver.py", "runtime/spec.py", "telemetry/__init__.py",
            "telemetry/registry.py", "telemetry/recorder.py", "telemetry/hooks.py",
            "telemetry/export.py", "telemetry/report.py", "telemetry/perfmodel.py",
            "examples/diffusion3D_multixpu.py"} <= names
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                assert "jax" not in s and "implicitglobalgrid_tpu " not in s + " " \
                    and "implicitglobalgrid_tpu." not in s, f"{f}: {s}"
