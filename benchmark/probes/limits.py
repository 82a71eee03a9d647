"""The two readings each limit is set from, on the card, in one process:
the numbers of the program's timed path on many seeds (a run of the cell
with a short window, as `run.py` makes it), and the control's on a few.

    python3 benchmark/probes/limits.py --workload <name> --seeds 11,12,... \
        --control-seeds 21,22,23 [--seconds 0] [--out limits.jsonl]

Prints one JSON line a reading: ``{"kind": "program" | "control", "seed",
"numbers", ...}``, and appends them to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(BENCH)]
    import torch

    from benchlib import control, harness, spec

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = spec.resolve(args.workload, ROOT)
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for s in filter(None, args.seeds.split(",")):
        t0 = time.perf_counter()
        r = harness.run_cell(cell, int(s), args.seconds, False, device="cuda", t_start=t0)
        emit({"kind": "program", "workload": cell.name, "seed": int(s),
              "correct": r["correct"], "attempted": r["attempted"],
              "numbers": {k: c["value"] for k, c in r["checks"].items()},
              "metrics": {k: m["value"] for k, m in r["metrics"].items()},
              "seconds": time.perf_counter() - t0})
    for s in filter(None, args.control_seeds.split(",")):
        t0 = time.perf_counter()
        nums = control.control_numbers(cell, int(s), "cuda")
        emit({"kind": "control", "workload": cell.name, "seed": int(s),
              "dtype": control.LOWER[cell.cfg["dtype"]], "numbers": nums,
              "seconds": time.perf_counter() - t0})
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
