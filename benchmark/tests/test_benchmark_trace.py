"""The trace reduction and the per-layer readers on synthetic captures: the
interval union, the idle share, the attribution of device operations to the
benchmark's spans, the step counts, the breakdown."""

from __future__ import annotations

import pytest
from bench_test_util import BENCH

from benchlib import intervals, spec
from benchlib import trace as tr
from benchlib.harness import RunRecord
from benchlib.window import Window


def test_merge_and_gaps():
    merged, total = intervals.merge([(5, 7), (0, 2), (1, 3), (6, 9), (4, 4)])
    assert merged == [[0, 3], [5, 9]] and total == 7
    assert intervals.gaps(merged, -1, 12) == [(-1, 0), (3, 5), (9, 12)]
    assert intervals.clip([(0, 3), (5, 9)], 2, 6) == [(2, 3), (5, 6)]
    assert intervals.intersect_total([[0, 3], [5, 9]], [[2, 6]]) == 2
    assert intervals.merge([]) == ([], 0)


def test_op_kind():
    assert tr.op_kind("void (anonymous namespace)::halo_write_multi_kernel<2, unsigned int>"
                      "(Args)") == "halo_write_multi_kernel"
    assert tr.op_kind("Memcpy DtoH (Device -> Pinned)") == "Memcpy DtoH"
    assert tr.op_kind("void at::native::vectorized_elementwise_kernel<4>(int)") \
        == "vectorized_elementwise_kernel"


def _ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def synthetic():
    """Two calls of 2 steps, [0, 100) and [120, 200), and a reduction
    launched between them. Kernels run late (the device lags the
    launches)."""
    ev = [_ev("user_annotation", tr.CALL, 0, 100), _ev("user_annotation", tr.CALL, 120, 80)]
    launches = [(1, 5, "exchange_slabs_kernel", 10, 10), (2, 6, "step_kernel", 20, 60),
                (3, 105, "reduce_kernel", 106, 2), (4, 125, "exchange_slabs_kernel", 130, 10),
                (5, 126, "step_kernel", 140, 50), (6, 199, "step_kernel", 201, 5)]
    for corr, t_launch, name, ts, dur in launches:
        ev.append(_ev("cuda_runtime", "cudaLaunchKernel", t_launch, 1, corr))
        ev.append(_ev("kernel", f"void {name}<float>(int)", ts, dur, corr))
    ev.append(_ev("cpu_op", "aten::max", 104, 5))
    return {"traceEvents": ev}


def test_reduce_attributes_by_launch():
    td = tr.reduce(synthetic(), steps=4)
    assert (td.lo, td.hi, td.window_us) == (0, 200, 200)
    spans = {(o.kind, o.start): o.span for o in td.ops}
    assert spans[("reduce_kernel", 106)] is None      # launched outside a call
    assert spans[("step_kernel", 201)] == tr.CALL     # launched inside, ran after
    assert len(td.call_ops()) == 5
    merged, busy = td.busy()
    assert busy == 10 + 60 + 2 + 10 + 50 and merged[:2] == [[10, 80], [106, 108]]
    assert tr.reduce({"traceEvents": []}, 1) is None


def _record(td, **kw):
    w = Window(seconds=2.0, calls=[(0.1, 2)] * 20, steps=40, trace=td)
    base = dict(workload="x", setup_s=3.5, window=w, cells_per_step=1000,
                step_bytes=335_000, step_flops=10, peak={"bytes_per_s": 3.35e12,
                                                        "flops_per_s": 1e12})
    base.update(kw)
    return RunRecord(**base)


def reader(name):
    return spec.load_module(BENCH / "metrics" / f"{name}.py", "metric")


def test_per_layer_readers():
    rec = _record(tr.reduce(synthetic(), steps=4))
    # device time of the calls' operations: 10+60+10+50+5 = 135 us over 4 steps
    assert reader("kernels_per_step").read(rec) == pytest.approx(5 / 4)
    assert reader("exchange_ms_per_step").read(rec) == pytest.approx(20 / 4 / 1e3)
    least = 335_000 / 3.35e12
    assert reader("step_roofline").read(rec) == pytest.approx(100 * least / (135e-6 / 4))
    assert reader("device_idle_pct").read(rec) == pytest.approx(100 * (1 - 132 / 200))


def test_readers_find_nothing_without_a_trace():
    rec = _record(None, peak=None)
    for name in ("kernels_per_step", "exchange_ms_per_step", "step_roofline",
                 "device_idle_pct"):
        assert reader(name).read(rec) is None
    assert reader("step_roofline").read(_record(tr.reduce(synthetic(), 4), peak=None)) is None


def test_end_to_end_readers():
    rec = _record(None)
    assert reader("cell_updates_per_s").read(rec) == pytest.approx(1000 * 40 / 2.0)
    assert reader("setup_s").read(rec) == 3.5
    rec.window.calls = [(0.001 * (i + 1), 1) for i in range(100)]
    assert reader("chunk_ms_p95").read(rec) == pytest.approx(95.95)
    rec.window.calls = rec.window.calls[:5]
    assert reader("chunk_ms_p95").read(rec) is None


def test_breakdown_names_gaps_by_host():
    bd = tr.breakdown(tr.reduce(synthetic(), steps=4))
    assert bd["device_ops"][0] == ["step_kernel", pytest.approx(110e-6)]
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10
    names = [g[0] for g in bd["idle_gaps"]]
    assert "between spans" in names and "bench::call > cudaLaunchKernel" in names
    gaps = [g[1] for g in bd["idle_gaps"]]
    assert gaps == sorted(gaps, reverse=True)
