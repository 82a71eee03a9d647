"""The harness on the CPU at a tiny size: the program's answers agree with
the plain references; the control and every fault a cell can have come out
not correct; the import check; a run with no card; a directory without the
program; a configuration, mix, cell and metric added as files alone."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch
from bench_test_util import BENCH, ROOT, TINY, WORKLOADS, run_tiny, tiny_cell

from benchlib import checks, control, harness, spec
from benchlib.window import Answer


@pytest.mark.parametrize("workload", WORKLOADS)
def test_program_agrees_with_reference(workload):
    res = run_tiny(workload)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["checks"]) == set(tiny_cell(workload).limits)
    assert list(res)[-1] == "checks"
    names = {m for m in res["metrics"]}
    assert {"setup_s", "cell_updates_per_s"} <= names


def test_plain_routes_agree_with_reference():
    """The port's explicit plain route (``impl="plain"``), not only the
    default route the cells take, against the reference."""
    from implicitglobalgrid_tpu_torch.models import run_diffusion

    cell = tiny_cell("diffusion3d.fused")
    ref = cell.reference
    c = ref.consts(cell.cfg)
    inp = ref.inputs(cell.cfg, None, 5, "cpu")
    model = cell.model.Model(cell.cfg, cell.traffic, c, inp, "cpu")
    try:
        out = run_diffusion(*model.state, model.params, 40, nt_chunk=40, impl="plain")
    finally:
        model.close()
    truth = ref.run(inp, c, {"steps": [40]}, ref.DTYPE)
    nums = model.judge(Answer(40, (out,)), truth)
    found, failed = checks.judge([nums], cell.limits)
    assert failed == 0, found


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails(workload):
    """The reference one precision lower in the program's place fails a
    limit (float32 for float64, bfloat16 for float32)."""
    cell = tiny_cell(workload)
    nums = control.control_numbers(cell, 2 ** 31 + 3, "cpu")
    _, failed = checks.judge([nums], cell.limits)
    assert failed == 1, nums


def _plant(monkeypatch, fault):
    import implicitglobalgrid_tpu_torch.models as models
    import implicitglobalgrid_tpu_torch.models.diffusion as diffusion

    run_d = models.run_diffusion
    if fault == "unchanged":
        monkeypatch.setattr(models, "run_diffusion", lambda T, Cp, p, nt, **k: T.clone())
    elif fault == "no_exchange":
        # the step of every block without the exchange between blocks
        monkeypatch.setattr(diffusion, "_cuda_step3",
                            lambda T, Cp, p, gg, loc, out: diffusion._plain_step(T, Cp, p, loc))
        monkeypatch.setattr(diffusion, "local_update_halo", lambda A, **k: A)
    elif fault == "altered":
        def alter(*a, **k):
            A = run_d(*a, **k).clone()
            A.view(-1)[A.numel() // 2] += 0.01 * float(A.abs().max())
            return A
        monkeypatch.setattr(models, "run_diffusion", alter)
    elif fault == "half_batch":
        def half(*a, **k):
            T = run_d(*a, **k).clone()
            E = T.shape[0]
            T[E // 2:] = T[:E // 2].mean(0)
            return T
        monkeypatch.setattr(models, "run_diffusion", half)


FAULTS = [("diffusion3d.fused", f) for f in ("unchanged", "no_exchange", "altered")] \
    + [("diffusion3d.ensemble4", f) for f in ("unchanged", "no_exchange", "altered",
                                              "half_batch")]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_fault_is_not_correct(monkeypatch, workload, fault):
    _plant(monkeypatch, fault)
    res = run_tiny(workload)
    assert not res["correct"] and res["failed"] >= 1, res["checks"]


def test_import_check_compares_whole_names():
    bad = harness.forbidden_modules(["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
                                     "implicitglobalgrid_tpu", "implicitglobalgrid_tpu.ops"])
    assert bad == ["flax", "implicitglobalgrid_tpu", "jax", "jaxlib"]
    assert harness.forbidden_modules(["implicitglobalgrid_tpu_torch",
                                      "implicitglobalgrid_tpu_torch.models", "jaxtyping",
                                      "torch", "benchlib.harness"]) == []


def _env():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return env


def test_run_loads_no_jax():
    """A whole run in a fresh process (the CPU path) leaves no JAX module
    loaded."""
    code = ("import sys; sys.path[:0] = [sys.argv[1]]\n"
            "import bench_test_util as u\n"
            "from benchlib import harness\n"
            "r = u.run_tiny('diffusion3d.ensemble4')\n"
            "print(r['correct'], harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code, str(BENCH / "tests")], cwd=ROOT,
                         env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "True []"


def test_run_without_a_card_fails():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "diffusion3d.fused",
                          "--seed", str(2 ** 31 + 11), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "needs 1 CUDA device" in out.stderr


def _bench_copy(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))
    return tmp_path


def test_bench_files_alone_do_not_run(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files holds
    no program: a run fails, and prints no result."""
    root = _bench_copy(tmp_path)
    code = ("import sys, json; root = sys.argv[1]; sys.path[:0] = [root, root + '/benchmark']\n"
            "from benchlib import harness, spec\n"
            "cell = spec.resolve('diffusion3d.fused', root, cfg_override={'local': [8, 8, 8]})\n"
            "print(json.dumps(harness.run_cell(cell, 1, 0, False, device='cpu')))")
    out = subprocess.run([sys.executable, "-c", code, str(root)], cwd=root, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "implicitglobalgrid_tpu_torch" in out.stderr


PAIRS = """from benchlib.window import Answer, Window
import time


def warm(model, traffic):
    model.advance(model.state, int(traffic["steps_per_call"]))


def run(model, traffic, seconds, seed, profiler=None):
    n, w = int(traffic["steps_per_call"]), Window()
    t0 = time.perf_counter()
    for k in (n, 2 * n):
        ts = time.perf_counter()
        out = model.advance(model.state, k)
        w.calls.append((time.perf_counter() - ts, k))
        w.steps += k
        w.answers.append(Answer(k, out))
    w.seconds, w.attempted = time.perf_counter() - t0, 2
    return w


def control_answer(model, reference, inputs, consts, traffic, dtype):
    n = int(traffic["steps_per_call"])
    return Answer(n, model.answer_state(reference.run(inputs, consts, {"steps": [n]},
                                                      dtype)["at"][n]))
"""


def test_new_config_mix_cell_and_metric_are_files_alone(tmp_path):
    """A configuration, a mix with a generator of a new shape, a cell and a
    metric added as new files and new entries of BENCHMARK.json, with no file
    of the benchmark edited."""
    root = _bench_copy(tmp_path)
    bench = root / "benchmark"
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    cfg = json.loads((bench / "configs" / "diffusion3d-2x2x2x256-f64.json").read_text())
    cfg.update(local=[8, 8, 8], dims=[1, 2, 2], dtype="float32")
    (bench / "configs" / "diffusion3d-1x2x2x8-f32.json").write_text(json.dumps(cfg))
    (bench / "generators" / "pairs.py").write_text(PAIRS)
    (bench / "traffic" / "pairs7.json").write_text(
        json.dumps({"generator": "pairs", "steps_per_call": 7}))
    (bench / "limits" / "diffusion3d.tiny.json").write_text(json.dumps({"T_rel_err": 1e-5}))
    (bench / "metrics" / "calls_made.py").write_text(
        "def read(run):\n    return float(len(run.window.calls))\n")
    spec_ = json.loads((root / "BENCHMARK.json").read_text())
    spec_["configs"].append({"name": "diffusion3d-1x2x2x8-f32", "source": "https://example.org",
                             "file": "benchmark/configs/diffusion3d-1x2x2x8-f32.json",
                             "reduced": ["local"], "why": "a test's"})
    spec_["workloads"].append({"name": "diffusion3d.tiny", "config": "diffusion3d-1x2x2x8-f32",
                               "traffic": "pairs7", "chips": 1, "why": "a test's"})
    spec_["end_to_end"].append({"name": "calls_made", "unit": "calls", "better": "higher",
                                "bound": 0.01, "source": "host_clock",
                                "workloads": ["diffusion3d.tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec_))
    after = {p: p.read_bytes() for p in before}
    assert after == before
    cell = spec.resolve("diffusion3d.tiny", root)
    res = harness.run_cell(cell, 3, 0.0, False, device="cpu")
    assert res["correct"], res["checks"]
    assert res["metrics"]["calls_made"] == {"value": 2.0, "unit": "calls"}
    assert res["attempted"] == 2 and set(res["checks"]) == {"T_rel_err"}
    nums = control.control_numbers(cell, 3, "cpu")
    assert checks.judge([nums], cell.limits)[1] == 1, nums
    assert cell.model.step_bytes(cell.cfg, cell.traffic) == 3 * 4 * (8 * 16 * 16)


def test_step_bytes_are_the_hand_worked_figures():
    d = spec.resolve("diffusion3d.fused")
    # T and Cp read, T written: 3 x 8 bytes x (2 x 256)^3 stored cells
    assert d.model.step_bytes(d.cfg, d.traffic) == 3 * 8 * 512 ** 3 == 3_221_225_472
    e = spec.resolve("diffusion3d.ensemble4")
    assert e.model.step_bytes(e.cfg, e.traffic) == 4 * 3_221_225_472


def test_layout_round_trip():
    from benchlib.layout import Grid

    g = Grid((6, 5, 4), (2, 3, 1), (2, 2, 2))
    assert g.global_shape == (10, 11, 4)
    G = torch.arange(10 * 11 * 4, dtype=torch.float64).reshape(10, 11, 4)
    S = g.stack(G)
    assert S.shape == (12, 15, 4)
    # block (1, 2, 0) holds global cells [4, 10) x [6, 11) x [0, 4)
    assert torch.equal(S[6:12, 10:15, 0:4], G[4:10, 6:11, 0:4])
    Vx = torch.rand(11, 11, 4)
    assert torch.equal(g.stack(Vx, (7, 5, 4))[7:14, 0:5], Vx[4:11, 0:5])
    assert TINY  # the tiny sizes the other tests use
