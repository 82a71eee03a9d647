"""BENCHMARK.json: every entry resolves to its files by name, and every name,
unit and text keeps to the benchmark's format."""

from __future__ import annotations

import json

import pytest
from bench_test_util import BENCH, ROOT, WORKLOADS

from benchlib import spec

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer"}


def test_top_level_keys_and_command():
    assert set(SPEC) == TOP_KEYS
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("workload", WORKLOADS)
def test_workload_resolves_by_name(workload):
    cell = spec.resolve(workload)
    assert cell.chips == 1
    assert (BENCH / "traffic" / f"{cell.traffic_name}.json").is_file()
    assert all(hasattr(cell.generator, f) for f in ("warm", "run", "control_answer"))
    assert (BENCH / "limits" / f"{workload}.json").is_file()
    assert hasattr(cell.model, "Model") and hasattr(cell.reference, "run")
    assert {m["name"] for m, _ in cell.end_to_end} >= {"setup_s", "cell_updates_per_s"}
    assert cell.per_layer and all(hasattr(r, "read") for _, r in cell.per_layer)
    # every number the comparison produces has a limit
    assert cell.limits and all(isinstance(v, float) for v in cell.limits.values())


def test_every_entry_has_its_files():
    for c in SPEC["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("benchmark/configs/")
        assert (BENCH / "models" / f"{cfg['model']}.py").is_file()
        assert (BENCH / "reference" / f"{cfg['model']}.py").is_file()
    for w in SPEC["workloads"]:
        traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert (BENCH / "generators" / f"{traffic['generator']}.py").is_file()
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}


def _names():
    for sec in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in SPEC[sec]:
            yield e["name"]
    for w in SPEC["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in SPEC["configs"]:
        yield from c["reduced"]


def test_names_units_and_texts():
    for n in _names():
        assert spec.NAME_RE.match(n), n
    for sec in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in SPEC[sec]]
        assert len(names) == len(set(names)), sec
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert spec.UNIT_RE.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for e in SPEC["configs"] + SPEC["workloads"]:
        assert spec.TEXT_RE.match(e["why"]), e["why"]
    for c in SPEC["configs"]:
        assert spec.TEXT_RE.match(c["source"]) and len(c["reduced"]) <= 16
    for m in SPEC["per_layer"]:
        assert spec.TEXT_RE.match(m["layer"])


def test_metric_entries():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in SPEC["workloads"]:
        e2e_of, per_of = spec.metrics_of(SPEC, w["name"])
        names = {m["name"] for m in e2e_of}
        assert "setup_s" in names and len(names) >= 2 and per_of


def test_names_of_files_under_paths():
    for p in BENCH.rglob("*"):
        if "__pycache__" in p.parts or p.suffix == ".pyc":
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert all(spec.NAME_RE.match(part) for part in rel.split("/")), rel
