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


def test_oracle_server_and_mesh_view_leave_jax_out():
    """The performance oracle, the metrics server and the mesh view,
    imported and driven in a fresh interpreter: no JAX module loads."""
    code = (
        "import sys, tempfile, urllib.request\n"
        "import implicitglobalgrid_tpu_torch as tg\n"
        "import implicitglobalgrid_tpu_torch.telemetry.calibrate, implicitglobalgrid_tpu_torch.telemetry.tune\n"
        "import implicitglobalgrid_tpu_torch.telemetry.perfdb, implicitglobalgrid_tpu_torch.telemetry.server\n"
        "import implicitglobalgrid_tpu_torch.telemetry.aggregate, implicitglobalgrid_tpu_torch.telemetry.trace_export\n"
        "import implicitglobalgrid_tpu_torch.ops.cuda_calibrate\n"
        "tg.init_global_grid(6, 6, 6, dimx=2, dimy=2, dimz=2, periodx=1, device_type='cpu', quiet=True)\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    prof = tg.calibrate_machine(d + '/p.json', elems_per_device=512, link_bytes=(256, 1024), c1=1)\n"
        "    T, Cp, p = tg.models.init_diffusion3d()\n"
        "    tg.predict_step('diffusion3d', (T, Cp), profile=tg.load_machine_profile(d + '/p.json'))\n"
        "    cfg = tg.tune_config('diffusion3d', dict(nx=6, ny=6, nz=6, dimx=2, dimy=2, dimz=2, device_type='cpu'),\n"
        "                         d + '/p.json', measure=True, top_k=1, comm_every_options=('1',),\n"
        "                         measure_steps=1, reps=1)\n"
        "    tg.perfdb_add(d + '/db.jsonl', [{'metric': 'x_per_s', 'value': 1.0}])\n"
        "    tg.perfdb_check(d + '/db.jsonl', [{'metric': 'x_per_s', 'value': 1.0}])\n"
        "    import os; os.makedirs(d + '/fl')\n"
        "    tg.start_flight_recorder(d + '/fl', run_id='iso')\n"
        "    def scrape(rep):\n"
        "        urllib.request.urlopen(f'http://127.0.0.1:{tg.metrics_server().port}/metrics').read()\n"
        "    tg.run_resilient(lambda s: {'T': tg.update_halo(s['T'] * 1.0)}, {'T': T}, 2, nt_chunk=1,\n"
        "                     tuned=cfg, metrics_port=0, on_report=scrape)\n"
        "    tg.stop_flight_recorder()\n"
        "    tg.run_report(d + '/fl'), tg.export_chrome_trace(d + '/fl', d + '/t.json')\n"
        "    tg.aggregate_flight(d + '/fl')\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'implicitglobalgrid_tpu' or m.startswith('implicitglobalgrid_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_audit_and_reshard_leave_jax_out():
    """The communication audit (the parser, the recorder, the contracts,
    the lints, `audit_model`, the driver's ``audit=True``) and the
    on-device reshard (`reshard_state`, `ResilientRun.resize`,
    `predict_reshard`), imported and driven in a fresh interpreter: no JAX
    module loads."""
    code = (
        "import sys, os, tempfile\n"
        "import implicitglobalgrid_tpu_torch as tg\n"
        "import implicitglobalgrid_tpu_torch.analysis.hlo, implicitglobalgrid_tpu_torch.analysis.record\n"
        "import implicitglobalgrid_tpu_torch.analysis.contracts, implicitglobalgrid_tpu_torch.analysis.lints\n"
        "import implicitglobalgrid_tpu_torch.analysis.audit, implicitglobalgrid_tpu_torch.reshard.plan\n"
        "import implicitglobalgrid_tpu_torch.reshard.program\n"
        "tg.init_global_grid(6, 6, 6, dimx=2, dimy=2, dimz=1, device_type='cpu', quiet=True)\n"
        "assert tg.audit_model('diffusion3d').ok and tg.audit_model('acoustic3d', impl='cuda').ok\n"
        "tg.parse_program(os.path.join('tests', 'data', 'hlo', 'guarded_chunk.hlo.txt'))\n"
        "T, Cp, p = tg.models.init_diffusion3d()\n"
        "step = lambda s: {'T': tg.models.diffusion_step_local(s['T'], s['Cp'], p), 'Cp': s['Cp']}\n"
        "run = tg.ResilientRun(step, {'T': T, 'Cp': Cp}, 4, tg.RunSpec(nt_chunk=2, audit=True))\n"
        "run.advance(); run.resize((1, 2, 2)); run.advance(); run.close()\n"
        "plan = tg.build_reshard_plan(tg.reshard.live_topology(), (2, 2, 1), tg.reshard.fields_of_state(run.state))\n"
        "tg.predict_reshard(plan)\n"
        "state, info = tg.reshard_state(run.state, (2, 2, 1), audit=True)\n"
        "assert info['audit_report'].ok\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'implicitglobalgrid_tpu' or m.startswith('implicitglobalgrid_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_service_and_live_plane_leave_jax_out():
    """The live plane (`FlightTail`, `LiveAggregate`, the alert engine and
    its sinks, OTLP export, `TraceContext`) and the service (a
    `MeshScheduler` with alerts, the autoscaler and a queue directory,
    `service_report`, `export_service_trace`), imported and driven in a
    fresh interpreter: no JAX module loads."""
    code = (
        "import sys, tempfile\n"
        "import implicitglobalgrid_tpu_torch as tg\n"
        "import implicitglobalgrid_tpu_torch.service, implicitglobalgrid_tpu_torch.telemetry.live\n"
        "import implicitglobalgrid_tpu_torch.telemetry.otlp, implicitglobalgrid_tpu_torch.telemetry.tracectx\n"
        "svc = tg.service\n"
        "d = tempfile.mkdtemp()\n"
        "be = svc.DirectoryBackend(d)\n"
        "be.submit({'name': 'q', 'model': 'acoustic3d', 'nt': 2, 'run': {'nt_chunk': 1},\n"
        "           'grid': {'nx': 6, 'ny': 6, 'nz': 6, 'dimx': 2, 'dimy': 1, 'dimz': 1,\n"
        "                    'device_type': 'cpu'}})\n"
        "grid = dict(nx=6, ny=6, nz=6, dimx=2, dimy=2, dimz=1, device_type='cpu')\n"
        "with svc.MeshScheduler(policy='fair', flight_dir=d, alerts=True, nranks=8,\n"
        "                       alert_sinks=[tg.ControlFileSink(be)],\n"
        "                       autoscale=svc.AutoscalePolicy(grow_slack_s=1e9)) as s:\n"
        "    s.submit(svc.JobSpec(name='a', setup=svc.builtin_setup('diffusion3d'), nt=4,\n"
        "                         grid=grid, run=tg.RunSpec(nt_chunk=2), model='diffusion3d',\n"
        "                         deadline_s=600.0), trace=tg.TraceContext.new())\n"
        "    s.run()\n"
        "    assert s.status()['states'] == {'done': 2}, s.status()\n"
        "agg = tg.LiveAggregate(d); agg.poll(); agg.snapshot()\n"
        "tg.export_otlp(d); tg.service_report(d); tg.export_service_trace(d)\n"
        "svc.explain_autoscale(d)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'implicitglobalgrid_tpu' or m.startswith('implicitglobalgrid_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_serve_and_cli_leave_jax_out():
    """The serving tier (`JobApiServer`, `SnapshotQueryServer`,
    `ObserveServer`) imported and driven, and the operator CLI run as
    ``python -m implicitglobalgrid_tpu_torch.tools snapshots`` and ``jobs
    list`` (through `runpy`, as ``-m`` does), in a fresh interpreter: no JAX
    module loads."""
    code = (
        "import sys, json, runpy, tempfile, urllib.request\n"
        "import implicitglobalgrid_tpu_torch as tg\n"
        "import implicitglobalgrid_tpu_torch.serve, implicitglobalgrid_tpu_torch.cli\n"
        "d = tempfile.mkdtemp()\n"
        "tg.init_global_grid(6, 6, 6, dimx=2, dimy=2, dimz=1, device_type='cpu', quiet=True)\n"
        "tg.write_snapshot(d + '/s', step=1, state={'T': tg.ones_g()})\n"
        "tg.finalize_global_grid()\n"
        "with tg.JobApiServer(d + '/q') as api, tg.SnapshotQueryServer(d + '/s') as q:\n"
        "    rec = {'name': 'a', 'model': 'diffusion3d', 'nt': 2, 'run': {'nt_chunk': 1},\n"
        "           'grid': {'nx': 6, 'ny': 6, 'nz': 6, 'dimx': 2, 'dimy': 1, 'dimz': 1,\n"
        "                    'device_type': 'cpu'}}\n"
        "    req = urllib.request.Request(f'http://127.0.0.1:{api.port}/v1/jobs', method='POST',\n"
        "                                 data=json.dumps(rec).encode())\n"
        "    assert urllib.request.urlopen(req).status == 202\n"
        "    with tg.MeshScheduler(flight_dir=d + '/q') as s:\n"
        "        s.run()\n"
        "    urllib.request.urlopen(f'http://127.0.0.1:{q.port}/v1/snapshots/1/T?box=0:2,,').read()\n"
        "    urllib.request.urlopen(f'http://127.0.0.1:{api.port}/v1/observe').read()\n"
        "for argv in (['snapshots', d + '/s'], ['jobs', 'list', d + '/q']):\n"
        "    sys.argv = ['tools'] + argv\n"
        "    try:\n"
        "        runpy.run_module('implicitglobalgrid_tpu_torch.tools', run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0, (argv, e.code)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'implicitglobalgrid_tpu' or m.startswith('implicitglobalgrid_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-W", "ignore", "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "step          1" in r.stdout and "a                    done" in r.stdout, r.stdout


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
            "examples/diffusion3D_multixpu.py", "telemetry/calibrate.py",
            "telemetry/tune.py", "telemetry/perfdb.py", "telemetry/server.py",
            "telemetry/aggregate.py", "telemetry/trace_export.py",
            "ops/cuda_calibrate.py", "analysis/__init__.py", "analysis/hlo.py",
            "analysis/record.py", "analysis/contracts.py", "analysis/lints.py",
            "analysis/audit.py", "reshard/__init__.py", "reshard/plan.py",
            "reshard/program.py", "telemetry/live.py", "telemetry/otlp.py",
            "telemetry/tracectx.py", "service/__init__.py", "service/job.py",
            "service/policies.py", "service/backend.py", "service/report.py",
            "service/scheduler.py", "service/autoscale.py", "cli.py", "tools.py",
            "serve/__init__.py", "serve/cache.py", "serve/query.py", "serve/observe.py",
            "serve/api.py"} <= names
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                assert "jax" not in s and "implicitglobalgrid_tpu " not in s + " " \
                    and "implicitglobalgrid_tpu." not in s, f"{f}: {s}"
