"""The program's spans in traced calls of a cell, and what a capture costs a
call, on the card, in one process.

    python3 benchmark/probes/spans.py --workload <name> --seed <n> \
        [--calls 20] [--blocks 2] [--out spans.jsonl]

Set-up as `run.py` makes it (the seed-made state, one warm call, the
profiler's warm capture), then ``--blocks`` pairs of ``--calls`` calls: a
block outside any capture, then a block inside one, each call in the
benchmark's span as the generators put it and timed on the host clock.
Prints one JSON line: a call's wall time outside and inside a capture (the
median, and the mean, which keeps each capture's first call), and for each
capture the counts that the runner layer's metrics rest on (``igg::step``
spans against the traced steps, ``igg::run`` spans against the traced
calls), the runner layer's metrics, the device's idle a call split into the
program's share (``call_idle_ms``) and the rest, the idle gaps inside a
call that `benchlib.trace.breakdown` names bare ``bench::call``, and the
three longest gaps as it names them. A program without the spans reads 0
spans and no metric.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time
from pathlib import Path
from types import SimpleNamespace

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
READERS = ("runner_host_ms_per_step", "call_idle_ms")


def capture_counts(td, readers) -> dict:
    from benchlib import trace as tr

    _, busy = td.busy()
    calls = len(td.spans)
    gaps = tr.breakdown(td, top=len(td.ops) + calls)["idle_gaps"]
    out = {"steps": td.steps, "step_spans": sum(h[0] == "igg::step" for h in td.host),
           "calls": calls, "run_spans": sum(h[0] == "igg::run" for h in td.host),
           "idle_ms_per_call": (td.window_us - busy) / 1e3 / calls,
           "bare_call_gaps_ms": [g[1] * 1e3 for g in gaps if g[0] == tr.CALL],
           "longest_gaps_ms": [[g[0], g[1] * 1e3] for g in gaps[:3]]}
    rec = SimpleNamespace(trace=td)
    for name, reader in readers.items():
        out[name] = reader.read(rec)
    if out["call_idle_ms"] is not None:
        out["idle_ms_per_call_rest"] = out["idle_ms_per_call"] - out["call_idle_ms"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--blocks", type=int, default=2)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(BENCH)]
    import torch

    from benchlib import spec
    from benchlib import trace as tr

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = spec.resolve(args.workload, ROOT)
    readers = {n: spec.load_module(BENCH / "metrics" / f"{n}.py", "metric") for n in READERS}
    ref = cell.reference
    inputs = ref.inputs(cell.cfg, cell.traffic.get("members"), args.seed, "cuda")
    model = cell.model.Model(cell.cfg, cell.traffic, ref.consts(cell.cfg), inputs, "cuda")
    steps = int(cell.traffic["steps_per_call"])
    cell.generator.warm(model, cell.traffic)
    prof = tr.Profiler(True)
    prof.warm("cuda")
    torch.cuda.synchronize()

    def timed(span):
        t = time.perf_counter()
        with span:
            out = model.advance(model.state, steps)
        dt = time.perf_counter() - t
        del out
        return dt * 1e3

    off, on, captures = [], [], []
    for _ in range(args.blocks):
        off += [timed(contextlib.nullcontext()) for _ in range(args.calls)]
        prof.start()
        on += [timed(torch.profiler.record_function(tr.CALL)) for _ in range(args.calls)]
        prof.stop()
        captures.append(capture_counts(tr.reduce(prof.collect(), steps * args.calls), readers))
    model.close()
    rec = {"workload": cell.name, "seed": args.seed, "device": torch.cuda.get_device_name(),
           "calls": args.calls, "blocks": args.blocks,
           "call_ms_off_median": statistics.median(off), "call_ms_on_median": statistics.median(on),
           "call_ms_off_mean": statistics.mean(off), "call_ms_on_mean": statistics.mean(on),
           "call_ms_off": off, "call_ms_on": on, "captures": captures}
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
