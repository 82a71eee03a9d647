"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result object; the numbers compared with the reference, each beside its
limit, are the last lines of standard error. A run that finds no CUDA
device, or fewer than the cell asks for, exits with 2 and prints no
result; one that finds a JAX module loaded exits with 3.
"""

from __future__ import annotations

import sys
import time

T_START = time.perf_counter()

import os  # noqa: E402

# The bytecode of every module a run imports (torch's ~2,100 source files
# among them) is kept at a fixed place inside the checkout, so that only a
# checkout's first run compiles it, also where the environment turns
# bytecode off (PYTHONDONTWRITEBYTECODE); it must be set before the imports.
sys.pycache_prefix = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                  ".bench_pycache")
sys.dont_write_bytecode = False

import argparse  # noqa: E402
import json  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT), str(BENCH)]

    from benchlib import checks, harness, spec

    marks = [("imports", time.perf_counter())]
    import torch

    marks.append(("import torch", time.perf_counter()))
    cell = spec.resolve(args.workload, ROOT)
    marks.append(("resolve", time.perf_counter()))
    ok = torch.cuda.is_available() and torch.cuda.device_count() >= cell.chips
    marks.append(("cuda check", time.perf_counter()))
    if not ok:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found {n}", file=sys.stderr)
        return 2
    try:
        result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                  device="cuda", t_start=T_START, marks=marks)
    except harness.ForbiddenImport as e:
        print(f"forbidden module {e}", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print("\n".join(checks.lines(result["checks"])), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
