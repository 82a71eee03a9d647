"""Resolve a cell of ``BENCHMARK.json`` to its files, by name.

A workload names a configuration and a traffic mix; each is found by name:

- ``configs``' ``file`` (a JSON object of sizes; its ``"model"`` names the
  adapter ``models/<model>.py`` and the plain reference
  ``reference/<model>.py``);
- ``traffic/<traffic>.json`` (the parameters of a mix; its ``"generator"``
  names the loop ``generators/<generator>.py`` that reads them);
- ``limits/<workload>.json`` (the limit of each number compared);
- ``metrics/<metric>.py`` for every metric the cell reports (``read(run)``).

Adding a configuration, a mix, a cell or a metric adds files and entries;
no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT_RE = re.compile(r"^[^\t\r\n]{1,200}$")


@dataclass
class Cell:
    """One workload with everything it resolves to."""
    name: str
    chips: int
    cfg: dict
    traffic_name: str
    traffic: dict
    limits: dict
    model: object          # the adapter module
    reference: object      # the plain reference module
    generator: object      # the traffic's loop
    end_to_end: list = field(default_factory=list)   # [(metric entry, reader module)]
    per_layer: list = field(default_factory=list)


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def load_module(path: Path, kind: str):
    """Import the file ``path`` as a module of its own (names may hold
    ``-`` and ``.``, so not through ``import``)."""
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"{kind} file missing: {path}")
    mod_name = "bench_" + kind + "_" + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _by_name(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def metrics_of(spec: dict, workload: str):
    """The end-to-end and per-layer metric entries a cell reports: those
    that list it under ``workloads``, or that list none (every cell; a
    per-layer metric without the key goes with the cells that report the
    end-to-end metric it moves)."""
    e2e = [m for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    per = [m for m in spec["per_layer"]
           if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, per


def resolve(workload: str, root: Path = ROOT, cfg_override: dict | None = None,
            traffic_override: dict | None = None) -> Cell:
    """The cell ``workload`` of ``root``'s ``BENCHMARK.json``. The overrides
    update the configuration's and the mix's parameters (tests run a cell
    at a tiny size)."""
    root = Path(root)
    bench = root / "benchmark"
    spec = load_spec(root)
    w = _by_name(spec["workloads"], workload, "workload")
    c = _by_name(spec["configs"], w["config"], "configuration")
    cfg = json.loads((root / c["file"]).read_text())
    cfg.update(cfg_override or {})
    traffic = json.loads((bench / "traffic" / f"{w['traffic']}.json").read_text())
    traffic.update(traffic_override or {})
    limits = json.loads((bench / "limits" / f"{workload}.json").read_text())
    e2e, per = metrics_of(spec, workload)
    return Cell(
        name=workload, chips=int(w["chips"]), cfg=cfg,
        traffic_name=w["traffic"], traffic=traffic, limits=limits,
        model=load_module(bench / "models" / f"{cfg['model']}.py", "model"),
        reference=load_module(bench / "reference" / f"{cfg['model']}.py", "reference"),
        generator=load_module(bench / "generators" / f"{traffic['generator']}.py", "generator"),
        end_to_end=[(m, load_module(bench / "metrics" / f"{m['name']}.py", "metric"))
                    for m in e2e],
        per_layer=[(m, load_module(bench / "metrics" / f"{m['name']}.py", "metric"))
                   for m in per])
