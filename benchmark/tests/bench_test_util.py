"""Helpers of the benchmark's CPU tests: the cells at a tiny size, run
through the harness on the CPU (the program's kernels' plain versions)."""

from __future__ import annotations

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from benchlib import harness, spec  # noqa: E402

WORKLOADS = ("diffusion3d.fused", "diffusion3d.ensemble4")
# each cell cut to blocks of a few cells
TINY = {
    "diffusion3d.fused": ({"local": [10, 10, 10]}, {"steps_per_call": 20}),
    "diffusion3d.ensemble4": ({"local": [10, 10, 10]}, {"steps_per_call": 5}),
}


def tiny_cell(workload: str, root: Path = ROOT):
    cfg, traffic = TINY[workload]
    return spec.resolve(workload, root, cfg_override=cfg, traffic_override=traffic)


def run_tiny(workload: str, seed: int = 2 ** 31 + 7, seconds: float = 0.0, trace=False):
    return harness.run_cell(tiny_cell(workload), seed, seconds, trace, device="cpu")
