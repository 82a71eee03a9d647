"""One run of one cell: set-up, the measured window, the comparison with
the plain reference, and the result line.

Set-up (``setup_s``, from the process's start) imports the program, makes
the seed-made state on the device, starts the grid and makes one call of
every shape the mix uses. The window is the mix's generator's loop
(``generators/<name>.py``). Once it has
closed: the check that no JAX module is loaded, the device's memory peak,
the program's state freed, then the reference over the sampled answers.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass

from . import checks, peaks
from . import trace as tr

FORBIDDEN = ("jax", "jaxlib", "flax", "implicitglobalgrid_tpu")


class ForbiddenImport(RuntimeError):
    pass


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (default: the loaded
    ones), compared whole: ``implicitglobalgrid_tpu_torch`` is not
    ``implicitglobalgrid_tpu``."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def assert_no_jax(where: str):
    bad = forbidden_modules()
    if bad:
        raise ForbiddenImport(f"loaded {where}: {', '.join(bad)}")


@dataclass
class RunRecord:
    """What a metric's reader (``metrics/<name>.py``, ``read(run)``) sees."""
    workload: str
    setup_s: float
    window: object         # the generator's `window.Window`
    cells_per_step: int
    step_bytes: int
    step_flops: int
    peak: dict | None

    @property
    def window_s(self) -> float:
        return self.window.seconds

    @property
    def trace(self):
        return self.window.trace


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: float | None = None, marks=None, log=None) -> dict:
    """Run ``cell`` once; returns the result object (the last line).
    ``marks``: the caller's ``[(name, perf_counter)]`` of its set-up since
    ``t_start``, printed with the harness's own."""
    import torch

    log = log or sys.stderr
    t_start = time.perf_counter() if t_start is None else t_start
    cuda = device.startswith("cuda")
    ref = cell.reference
    marks = [("start", t_start), *(marks or []), ("harness", time.perf_counter())]
    if cuda:
        torch.cuda.init()
    marks.append(("cuda", time.perf_counter()))
    consts = ref.consts(cell.cfg)
    inputs = ref.inputs(cell.cfg, cell.traffic.get("members"), int(seed), device)
    if cuda:
        torch.cuda.synchronize()
    marks.append(("inputs", time.perf_counter()))
    model = cell.model.Model(cell.cfg, cell.traffic, consts, inputs, device)
    marks.append(("program", time.perf_counter()))
    cell.generator.warm(model, cell.traffic)
    prof = tr.Profiler(cuda) if trace else None
    if prof:
        prof.warm(device)
    if cuda:
        torch.cuda.synchronize()
    marks.append(("warm", time.perf_counter()))
    assert_no_jax("after set-up")
    setup_s = time.perf_counter() - t_start
    print("setup: " + ", ".join(f"{name} {t - marks[i][1]:.3f} s" for i, (name, t) in
                                enumerate(marks[1:])), file=log)
    kind = torch.cuda.get_device_name() if cuda else "cpu"
    rec = RunRecord(workload=cell.name, setup_s=setup_s, window=None,
                    cells_per_step=model.cells_per_step, step_bytes=model.step_bytes,
                    step_flops=model.step_flops, peak=peaks.lookup(kind, model.dtype))

    rec.window = w = cell.generator.run(model, cell.traffic, float(seconds), int(seed), prof)
    assert_no_jax("when the window closed")
    mem_peak = torch.cuda.max_memory_allocated() if cuda else 0
    model.close()
    print(f"window: {w.seconds:.3f} s, {len(w.calls)} calls, {w.steps} steps", file=log)

    truth = ref.run(inputs, consts, {"steps": sorted({a.steps for a in w.answers})}, ref.DTYPE)
    per_answer = [model.judge(a, truth) for a in w.answers]
    found, failed = checks.judge(per_answer, cell.limits)

    metrics = {}
    for entry, reader in (cell.per_layer if trace else cell.end_to_end):
        v = reader.read(rec)
        if v is not None:
            metrics[entry["name"]] = {"value": float(v), "unit": entry["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": int(cell.chips),
           "memory_peak_bytes": int(mem_peak)}
    # no answer to compare is no proof
    result = {"correct": bool(found) and failed == 0
              and all(c["value"] is not None for c in found.values()),
              "attempted": w.attempted, "failed": failed, "metrics": metrics, "device": dev}
    if trace and w.trace is not None:
        dev["busy_s"] = w.trace.busy()[1] / 1e6
        dev["window_s"] = w.trace.window_us / 1e6
        result["breakdown"] = tr.breakdown(w.trace)
    result["checks"] = found
    return result
