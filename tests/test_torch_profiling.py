"""Profiling of the port (`utils/profiling.py`, `utils/trace_events.py`), the
twin of `tests/test_profiling.py`: the Chrome-trace reader, the overlap
arithmetic, the host fallback, device planes preempting it, `op_breakdown`
on both, the kinds of kernel names, and comm classified by kind.

The synthetic captures are those of `tests/test_profiling.py`, encoded
once as an XSpace (that file's `_field`/`_plane` helpers) for the JAX
package's `overlap_stats`/`op_breakdown` and once as a torch.profiler
Chrome trace for the port's: the records are equal. Live captures of
small port runs on the CPU (2x2x2 x 8^3) show the exchange's labels as
comm, and the runner's spans nested as the runner runs them.
"""

import json
import os

import numpy as np
import pytest
import torch

import implicitglobalgrid_tpu_torch as tg
from implicitglobalgrid_tpu.utils import profiling as jprof
from implicitglobalgrid_tpu_torch.models import (
    ensemble_state, init_diffusion3d, run_diffusion,
)
from implicitglobalgrid_tpu_torch.utils import profiling as prof
from implicitglobalgrid_tpu_torch.utils.exceptions import NotSupportedError
from implicitglobalgrid_tpu_torch.utils.trace_events import find_trace_files, parse_trace
from test_profiling import _event, _line, _meta, _plane, _write_run
from torch_port_util import clean_torch_grid  # noqa: F401

BASE_US = 1428580631000  # a profiler clock's microseconds: beyond a float's ns
K_COMPUTE = "void at::native::vectorized_elementwise_kernel<4, at::native::AddFunctor<float> >(int)"
K_WIRE = ("void (anonymous namespace)::wire_pack_kernel<2, unsigned int>("
          "(anonymous namespace)::Slabs, unsigned int*, unsigned int*)")
K_K7 = ("void (anonymous namespace)::halo_write_multi_kernel<0, unsigned int>("
        "(anonymous namespace)::Slabs, unsigned int const*, unsigned int const*, int, int)")


def _us(ps):
    """Picoseconds after BASE_US as the trace's microsecond text."""
    whole, frac = divmod(ps, 1_000_000)
    return f"{BASE_US + whole}.{frac // 1000:03d}"


def _gpu(name, start_ps, dur_ps, stream=7, cat="kernel", device=0):
    return {"ph": "X", "cat": cat, "name": name, "pid": device, "tid": stream,
            "ts": _us(start_ps), "dur": f"{dur_ps // 1_000_000}.{dur_ps % 1_000_000 // 1000:03d}",
            "args": {"device": device, "stream": stream}}


def _cpu(name, start_ps, dur_ps, tid=1, cat="cpu_op"):
    return {"ph": "X", "cat": cat, "name": name, "pid": 4242, "tid": tid,
            "ts": _us(start_ps), "dur": f"{dur_ps // 1_000_000}.{dur_ps % 1_000_000 // 1000:03d}",
            "args": {}}


def _write_trace(d, events, name="host_4242.20260101-000000"):
    """A torch.profiler Chrome trace: numbers as the profiler writes them
    (microseconds with three decimals), metadata and a profiler span."""
    os.makedirs(d, exist_ok=True)
    body = ",\n".join(
        json.dumps({k: v for k, v in ev.items() if k not in ("ts", "dur")})[:-1]
        + f', "ts": {ev["ts"]}, "dur": {ev["dur"]}}}' for ev in events)
    meta = ('{"ph": "M", "name": "process_name", "pid": 4242, "tid": 0, "ts": 0, '
            '"args": {"name": "python"}},\n{"ph": "X", "cat": "Trace", "name": '
            '"PyTorch Profiler (0)", "pid": "Spans", "tid": "PyTorch Profiler", "ts": '
            f'{BASE_US}.000, "dur": 99.0}}')
    path = os.path.join(d, f"{name}.pt.trace.json")
    with open(path, "w") as f:
        f.write('{"schemaVersion": 1, "traceEvents": [\n' + meta + ",\n" + body + "]}")
    return path


def test_trace_reader(tmp_path):
    """Planes by device and the host, lines by stream and thread, exact
    picoseconds from microseconds past a float's resolution, touching
    spans still touching."""
    path = _write_trace(tmp_path, [
        _gpu(K_COMPUTE, 5_001_000, 2_000_000, stream=7),
        _gpu(K_WIRE, 7_001_000, 4_000_000, stream=13),
        _gpu("Memcpy HtoD (Pageable -> Device)", 1_000, 1_000, stream=7, cat="gpu_memcpy"),
        _cpu("aten::add", 0, 3_000_000),
    ])
    planes = parse_trace(path)
    assert [p.name for p in planes] == ["/device:GPU:0", "/host:CPU"]
    gpu, host = planes
    assert sorted(ln.name for ln in gpu.lines) == ["stream 13", "stream 7"]
    s7 = next(ln for ln in gpu.lines if ln.name == "stream 7")
    assert [e.name for e in s7.events][0].startswith("Memcpy")  # start order
    k = s7.events[1]
    assert k.start_ps == BASE_US * 1_000_000 + 5_001_000 and k.duration_ps == 2_000_000
    w = next(ln for ln in gpu.lines if ln.name == "stream 13").events[0]
    assert w.start_ps == k.end_ps and w.cat == "kernel"  # touching stays touching
    assert [ln.name for ln in host.lines] == ["thread 1"]
    assert find_trace_files(str(tmp_path)) == [path]
    assert find_trace_files(str(tmp_path / "missing")) == []


def _jax_device_case(tmp_path):
    metas = [(1, _meta(1, "%f = f32[8]{0} fusion(%a), calls=%fc")),
             (2, _meta(2, "%cp = collective-permute-start(%x)")),
             (3, _meta(3, "%cs = (f32[8]{0}, u32[]) copy-start(%a)"))]
    lines = [_line("XLA Ops", 0, [_event(1, 15_000_000, 2_000_000)]),
             _line("Async XLA Ops", 0, [_event(2, 16_000_000, 4_000_000),
                                        _event(3, 18_000_000, 9_000_000)])]
    _write_run(tmp_path, [_plane("/device:TPU:0", lines, metas)])


def test_overlap_stats_arithmetic_equals_jax(tmp_path):
    """`test_overlap_stats_arithmetic`'s intervals: compute [15, 17) us on
    one stream, an exchange kernel [16, 20) us on another (JAX's async
    collective span); JAX's async copy span, which counts as neither, is a
    host span here. 1 us of the 4 us comm hidden, records equal."""
    _jax_device_case(tmp_path / "jax")
    ref = jprof.overlap_stats(str(tmp_path / "jax"))["TPU:0"]
    _write_trace(tmp_path / "port", [_gpu(K_COMPUTE, 15_000_000, 2_000_000, stream=7),
                                     _gpu(K_WIRE, 16_000_000, 4_000_000, stream=13),
                                     _cpu("cudaMemcpyAsync", 18_000_000, 9_000_000,
                                          cat="cuda_runtime")])
    got = prof.overlap_stats(str(tmp_path / "port"))
    assert set(got) == {"GPU:0"}
    assert got["GPU:0"] == ref
    assert ref["hidden_comm_us"] == 1.0 and ref["overlap_frac"] == 0.25


def _jax_host_case(tmp_path):
    metas = [(1, _meta(1, "wrapped_add")), (2, _meta(2, "ppermute.42")),
             (3, _meta(3, "ThunkExecutor::Execute")), (4, _meta(4, "Wait: pending_threads=1/8")),
             (5, _meta(5, "end: ppermute.42")), (6, _meta(6, "Rendezvous")),
             (7, _meta(7, "while.3"))]
    lines = [_line("tf_XLAEigen/1", 0, [_event(1, 0, 4_000_000), _event(2, 2_000_000, 6_000_000),
                                        _event(3, 0, 10_000_000),
                                        _event(5, 9_500_000, 1_000_000)]),
             _line("tf_XLAEigen/2", 0, [_event(6, 6_000_000, 3_000_000),
                                        _event(7, 0, 9_000_000), _event(4, 0, 10_000_000)])]
    _write_run(tmp_path, [_plane("/host:CPU", lines, metas)])


def _port_host_events():
    """`test_host_overlap_fallback`'s intervals on the port's host lines:
    an operator [0, 4) us with a nested one (not counted twice), the
    exchange's label [2, 8) us with an operator inside it (comm, not
    compute), a gloo span [6, 9) us; a user label and the profiler's own
    spans are neither."""
    return [_cpu("aten::add", 0, 4_000_000, tid=1),
            _cpu("aten::copy_", 1_000_000, 1_000_000, tid=1),
            _cpu("step", 0, 10_000_000, tid=2, cat="user_annotation"),
            _cpu("igg::update_halo", 2_000_000, 6_000_000, tid=2, cat="user_annotation"),
            _cpu("aten::copy_", 3_000_000, 2_000_000, tid=2),
            _cpu("gloo:send", 6_000_000, 3_000_000, tid=3, cat="user_annotation")]


def test_host_overlap_fallback_equals_jax(tmp_path):
    _jax_host_case(tmp_path / "jax")
    ref = jprof.overlap_stats(str(tmp_path / "jax"))["CPU:threadpool"]
    _write_trace(tmp_path / "port", _port_host_events())
    got = prof.overlap_stats(str(tmp_path / "port"))
    assert set(got) == {"CPU"} and got["CPU"] == ref
    assert (ref["compute_us"], ref["comm_us"], ref["hidden_comm_us"]) == (4.0, 7.0, 2.0)


def test_device_planes_preempt_host_fallback(tmp_path):
    _write_trace(tmp_path, [_gpu(K_COMPUTE, 0, 2_000_000),
                            _cpu("igg::update_halo", 0, 5_000_000, cat="user_annotation")])
    stats = prof.overlap_stats(str(tmp_path))
    assert set(stats) == {"GPU:0"} and stats["GPU:0"]["compute_us"] == 2.0
    assert prof.overlap_stats(str(tmp_path / "none")) == {}
    assert prof.op_breakdown(str(tmp_path / "none")) == []


def test_op_breakdown_host_fallback(tmp_path):
    """The host fallback aggregates the exchange's labels, the collectives'
    spans and the top-level operators by name (JAX: its thunk spans by
    kind); nested operators and other labels stay out."""
    _write_trace(tmp_path, _port_host_events() + [_cpu("aten::add", 12_000_000, 1_000_000)])
    rows = prof.op_breakdown(str(tmp_path))
    by_kind = {k: (us, c) for k, us, c in rows}
    assert by_kind == {"igg::update_halo": (6.0, 1), "aten::add": (5.0, 2),
                       "gloo:send": (3.0, 1)}
    assert rows[0][0] == "igg::update_halo"


def test_op_breakdown_synthetic_equals_jax(tmp_path):
    """`test_op_breakdown_synthetic`'s spans: a kind twice, another once, in
    both packages the same times and counts (JAX's fusion is the port's
    kernel kind, its copy-done a copy), in nanoseconds (the Chrome trace
    keeps no finer time)."""
    metas = [(1, _meta(1, "%f = f32[8]{0} fusion(%a), calls=%fc")),
             (3, _meta(3, "%d = f32[8]{0} copy-done(%cs)"))]
    lines = [_line("XLA Ops", 0, [_event(1, 0, 3_000_000), _event(1, 5_000_000, 1_000_000),
                                  _event(3, 9_000_000, 500_000)])]
    _write_run(tmp_path / "jax", [_plane("/device:TPU:0", lines, metas)])
    ref = jprof.op_breakdown(str(tmp_path / "jax"))
    k7_other = K_K7.replace("<0,", "<2,")
    _write_trace(tmp_path / "port", [
        _gpu(K_K7, 0, 3_000_000), _gpu(k7_other, 5_000_000, 1_000_000, stream=9),
        _gpu("Memcpy DtoD (Device -> Device)", 9_000_000, 500_000, cat="gpu_memcpy")])
    got = prof.op_breakdown(str(tmp_path / "port"))
    assert [(t, c) for _, t, c in got] == [(t, c) for _, t, c in ref]
    assert [k for k, _, _ in got] == ["halo_write_multi_kernel", "Memcpy DtoD"]
    assert [k for k, _, _ in ref] == ["fusion", "copy-done"]


def test_op_kind_parsing():
    assert prof._op_kind(K_K7) == "halo_write_multi_kernel"
    assert prof._op_kind(K_WIRE) == "wire_pack_kernel"
    assert prof._op_kind(K_COMPUTE) == "at::native::vectorized_elementwise_kernel"
    assert prof._op_kind("void stokes_step_kernel_column<float>(Args)") == \
        "stokes_step_kernel_column"
    assert prof._op_kind("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)") == \
        "ncclDevKernel_SendRecv"
    assert prof._op_kind("Memcpy DtoH (Device -> Pinned)") == "Memcpy DtoH"
    assert prof._op_kind("Memset (Device)") == "Memset"
    assert prof._op_kind("aten::add") == "aten::add"
    assert prof._op_kind("igg::update_halo") == "igg::update_halo"
    # every kernel the launch counters name is a kind of its own
    kinds = [k for names in prof.KERNEL_NAMES.values() for k in names]
    assert len(set(kinds)) == len(kinds)
    assert set(prof.EXCHANGE_KERNELS) <= set(prof.KERNEL_NAMES)


def test_comm_classified_by_kind(tmp_path):
    """A kernel whose parameters name an exchange kernel is compute (JAX: a
    fusion consuming a collective's result); a device-to-device copy is
    compute, a host-to-device copy and a NCCL kernel are comm."""
    _write_trace(tmp_path, [
        _gpu("void copy_kernel<float>(wire_pack_kernel_args)", 0, 2_000_000),
        _gpu("Memcpy DtoD (Device -> Device)", 3_000_000, 1_000_000, cat="gpu_memcpy"),
        _gpu("Memcpy HtoD (Pinned -> Device)", 5_000_000, 1_000_000, cat="gpu_memcpy"),
        _gpu("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)", 7_000_000, 500_000)])
    s = prof.overlap_stats(str(tmp_path))["GPU:0"]
    assert s["compute_us"] == 3.0 and s["comm_us"] == 1.5


def test_newest_capture_is_read(tmp_path):
    old = _write_trace(tmp_path, [_gpu(K_COMPUTE, 0, 1_000_000)], "h_1.20260101-000000")
    new = _write_trace(tmp_path, [_gpu(K_WIRE, 0, 2_000_000)], "h_1.20260101-000001")
    os.utime(old, (1, 1))
    assert find_trace_files(str(tmp_path)) == [new]
    assert prof.overlap_stats(str(tmp_path))["GPU:0"]["comm_us"] == 2.0


def test_live_capture_of_a_port_run(tmp_path, monkeypatch):
    """A real torch.profiler capture of 4 plain steps on 2x2x2 x 8^3 (the
    CPU: the host fallback): the exchange's labels are comm, the update's
    operators compute; `annotate` shows in the timeline; outside a capture
    the labels enter no profiler range."""
    tg.init_global_grid(8, 8, 8, dimx=2, dimy=2, dimz=2, periodx=1, device_type="cpu",
                        quiet=True)
    T, Cp, p = init_diffusion3d(dtype=torch.float32)
    run_diffusion(T, Cp, p, 1, impl="plain")  # warm
    with tg.trace(str(tmp_path)):
        with tg.annotate("steps"):
            run_diffusion(T, Cp, p, 4, impl="plain")
    (path,) = find_trace_files(str(tmp_path))
    names = {e.name for pl in parse_trace(path) for ln in pl.lines for e in ln.events}
    assert {"steps", "igg::update_halo"} <= names
    s = tg.overlap_stats(str(tmp_path))["CPU"]
    assert s["comm_us"] > 0 and s["compute_us"] > 0 and s["busy_us"] > 0
    assert s["hidden_comm_us"] <= s["comm_us"] and s["exposed_comm_us"] >= 0
    rows = tg.op_breakdown(str(tmp_path), top=50)
    by_kind = {k: c for k, _, c in rows}
    assert by_kind["igg::update_halo"] == 4
    assert any(k.startswith("aten::") for k in by_kind)

    def boom(*a, **k):
        raise AssertionError("a label entered a profiler range outside a capture")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    run_diffusion(T, Cp, p, 1, impl="plain")


# a route's run_diffusion arguments and its exchange's label: the fused
# route (the kernels' plain versions on the CPU) and the ensemble's plain route
RUNNER_ROUTES = {"fused": ({"impl": "cuda"}, "igg::exchange_slabs"),
                 "ensemble": ({"ensemble": 2}, "igg::update_halo")}
RUNNER_SPANS = ("igg::run", "igg::chunk", "igg::step", "igg::drain")


@pytest.mark.parametrize("route", sorted(RUNNER_ROUTES))
def test_runner_spans_of_a_live_capture(tmp_path, monkeypatch, route):
    """4 steps in chunks of 2 on 2x2x2 x 8^3, as the benchmark's cells run
    them: one run, two chunks, four steps each inside a chunk inside the
    run, one drain, and the route's exchange once a step, as comm; outside
    a capture neither the runner nor the exchange enters a profiler range."""
    kw, exchange = RUNNER_ROUTES[route]
    tg.init_global_grid(8, 8, 8, dimx=2, dimy=2, dimz=2, device_type="cpu", quiet=True)
    T, Cp, p = init_diffusion3d(dtype=torch.float32)
    if "ensemble" in kw:
        T, Cp = ensemble_state((T, Cp), kw["ensemble"], perturb=0.1)
    run_diffusion(T, Cp, p, 2, nt_chunk=2, **kw)  # warm
    with tg.trace(str(tmp_path)):
        run_diffusion(T, Cp, p, 4, nt_chunk=2, **kw)
    (path,) = find_trace_files(str(tmp_path))
    events = [e for pl in parse_trace(path) for ln in pl.lines for e in ln.events]
    spans = {n: [(e.start_ps, e.end_ps) for e in events if e.name == n]
             for n in RUNNER_SPANS + (exchange,)}
    assert {n: len(v) for n, v in spans.items()} == {
        "igg::run": 1, "igg::chunk": 2, "igg::step": 4, "igg::drain": 1, exchange: 4}

    def inside(span, outer):
        return any(a <= span[0] and span[1] <= b for a, b in spans[outer])

    assert all(inside(s, "igg::chunk") for s in spans["igg::step"])
    assert all(inside(s, "igg::run") for s in spans["igg::chunk"] + spans["igg::drain"])
    assert all(inside(s, "igg::step") for s in spans[exchange])
    assert tg.overlap_stats(str(tmp_path))["CPU"]["comm_us"] > 0
    assert {k: c for k, _, c in tg.op_breakdown(str(tmp_path), top=50)}[exchange] == 4

    def boom(*a, **k):
        raise AssertionError("a span entered a profiler range outside a capture")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    run_diffusion(T, Cp, p, 4, nt_chunk=2, **kw)


def test_exchange_slabs_label_is_host_comm(tmp_path):
    """The host fallback counts the fused routes' slab pipeline as comm,
    and the runner's spans around it as neither."""
    _write_trace(tmp_path, [
        _cpu("igg::step", 0, 10_000_000, cat="user_annotation"),
        _cpu("igg::exchange_slabs", 1_000_000, 3_000_000, cat="user_annotation"),
        _cpu("aten::add", 5_000_000, 2_000_000)])
    s = prof.overlap_stats(str(tmp_path))["CPU"]
    assert (s["comm_us"], s["compute_us"], s["busy_us"]) == (3.0, 2.0, 5.0)
    assert "igg::exchange_slabs" in prof.EXCHANGE_LABELS


def test_perfetto_link_refused(tmp_path):
    with pytest.raises(NotSupportedError, match="Perfetto"):
        with tg.trace(str(tmp_path), create_perfetto_link=True):
            pass
    assert not os.listdir(tmp_path)
    np.testing.assert_equal(prof.EXCHANGE_LABELS[0], "igg::update_halo")
