"""The runner layer's readers (`metrics/runner_host_ms_per_step.py`,
`metrics/call_idle_ms.py`) on a synthetic capture with known program
spans and device operations, and the breakdown naming an idle gap inside a
call by the program's innermost span."""

from __future__ import annotations

import pytest
from bench_test_util import BENCH

from benchlib import spec
from benchlib import trace as tr
from benchlib.harness import RunRecord
from benchlib.window import Window


def _ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def synthetic(program_spans=True):
    """Two calls of 2 steps, [0, 100) and [120, 200). Each holds one
    ``igg::run`` ([2, 98), [122, 198)) with its steps (5, 7, 4 and 8 us);
    a step span after the window stays out. Kernels [10, 50) and [55, 90)
    in the first run, [130, 190) in the second: 21 and 16 us of each run
    idle. Each call's first step launches in 1 us; the second call's
    second step waits 4 us more in a launch of 5 us (a full queue)."""
    ev = [_ev("user_annotation", tr.CALL, 0, 100), _ev("user_annotation", tr.CALL, 120, 80)]
    if program_spans:
        ev += [_ev("user_annotation", "igg::run", 2, 96),
               _ev("user_annotation", "igg::run", 122, 76)]
        ev += [_ev("user_annotation", "igg::step", ts, dur)
               for ts, dur in ((3, 5), (8, 7), (123, 4), (127, 8), (205, 9))]
    for corr, t_launch, ts, dur in ((1, 6, 10, 40), (2, 9, 55, 35), (3, 124, 130, 60)):
        ev.append(_ev("cuda_runtime", "cudaLaunchKernel", t_launch, 1, corr))
        ev.append(_ev("kernel", "void step_kernel<double>(int)", ts, dur, corr))
    ev.append(_ev("cuda_runtime", "cudaLaunchKernel", 128, 5, 4))
    return {"traceEvents": ev}


def _record(td):
    w = Window(seconds=2.0, calls=[(0.1, 2)] * 20, steps=40, trace=td)
    return RunRecord(workload="x", setup_s=3.5, window=w, cells_per_step=1000,
                     step_bytes=335_000, step_flops=10, peak=None)


def reader(name):
    return spec.load_module(BENCH / "metrics" / f"{name}.py", "metric")


def test_runner_readers_exact():
    rec = _record(tr.reduce(synthetic(), steps=4))
    # the second call's second step less its launch's wait beyond 1 us
    assert reader("runner_host_ms_per_step").read(rec) == (5 + 7 + 4 + (8 - 4)) / 4 / 1e3
    # [2, 98) less 40 + 35 us busy, [122, 198) less 60 us busy
    assert reader("call_idle_ms").read(rec) == ((96 - 75) + (76 - 60)) / 2 / 1e3


def test_runner_readers_find_nothing_without_their_spans():
    for rec in (_record(None), _record(tr.reduce(synthetic(program_spans=False), steps=4))):
        assert reader("runner_host_ms_per_step").read(rec) is None
        assert reader("call_idle_ms").read(rec) is None


def test_gap_inside_a_call_named_by_program_span():
    names = [g[0] for g in tr.breakdown(tr.reduce(synthetic(), steps=4))["idle_gaps"]]
    assert "bench::call > igg::step" in names and "bench::call > igg::run" in names
    assert tr.CALL not in names


def test_span_probe_counts():
    """`probes/spans.py` on the synthetic capture: spans against the traced
    steps and calls, the idle a call split, and no gap inside a call left
    bare without the program's spans."""
    probe = spec.load_module(BENCH / "probes" / "spans.py", "probe")
    readers = {n: reader(n) for n in probe.READERS}
    c = probe.capture_counts(tr.reduce(synthetic(), steps=4), readers)
    assert (c["steps"], c["step_spans"], c["calls"], c["run_spans"]) == (4, 5, 2, 2)
    assert c["bare_call_gaps_ms"] == []
    assert c["idle_ms_per_call"] == (200 - 135) / 2 / 1e3
    assert c["idle_ms_per_call_rest"] == c["idle_ms_per_call"] - c["call_idle_ms"]
    bare = probe.capture_counts(tr.reduce(synthetic(program_spans=False), steps=4), readers)
    assert bare["run_spans"] == 0 and bare["call_idle_ms"] is None
    assert bare["bare_call_gaps_ms"] == pytest.approx([10e-3, 10e-3, 5e-3])
