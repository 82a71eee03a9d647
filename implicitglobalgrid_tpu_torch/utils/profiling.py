"""Profiling: capture a trace of the port and read comm/compute overlap from it.

Counterpart of `implicitglobalgrid_tpu/utils/profiling.py`. `trace` wraps
`torch.profiler.profile` (the CPU, and CUDA where the grid's device is a
card) and writes its Chrome trace into a log directory, where Perfetto opens
it; `overlap_stats` and `op_breakdown` read the newest capture back
(`utils.trace_events`) and turn the schedule into numbers::

    with igg.trace("/tmp/igg_trace"):
        T = run_diffusion(T, Cp, p, nt)        # returns once the device drained

    igg.overlap_stats("/tmp/igg_trace")
    # {'GPU:0': {'busy_us': ..., 'comm_us': ..., 'hidden_comm_us': ...,
    #            'exposed_comm_us': ..., 'overlap_frac': ...}}
    igg.op_breakdown("/tmp/igg_trace")         # [(kind, total_us, count), ...]

On a device plane, COMM is every span of the port's exchange: the halo
kernels K2, K3, K6, K7 and K8, K4s's exchange modes (`EXCHANGE_KERNELS`,
by their launch names), NCCL kernels, and the peer, device-to-host and
host-to-device copies (the transport's staging); COMPUTE is every other
kernel, copy and memset. Comm that runs while compute runs on another
stream is HIDDEN (the interior-first overlap, `ops.overlap`). A capture
without a device plane (the CPU) falls back to the host: comm is the spans
of the exchange's labels (`EXCHANGE_LABELS`) and of gloo/c10d, compute the
other top-level operators (``aten::*``).

The port's spans (`label`, a `torch.profiler.record_function` entered only
while a capture runs), on the profiler's clock beside the device activity:

- ``igg::run``: one call of a model's ``run_*`` (`models.common.traced_run`:
  `run_diffusion`, `run_acoustic`, `run_stokes`, their deep branches
  too), from entry to the return after the drain;
- ``igg::chunk``: one call of a `make_state_runner` runner, its
  ``nt_chunk`` steps and the ``post_chunk`` hook;
- ``igg::step``: one step's host work in that loop, the route's dispatch
  and every launch of the step;
- ``igg::drain``: `models.common.run_chunked` waiting for the device's
  queue to empty;
- the exchange's labels (`EXCHANGE_LABELS`): ``igg::update_halo``
  (`ops.halo.update_halo`, `local_update_halo`), ``igg::exchange_slabs``
  (`ops.halo.exchange_recv_slabs_multi`, the slab pipeline of the fused
  routes), ``igg::exchange_shells`` (`ops.overlap`'s side-stream exchange)
  and ``igg::transport`` (`parallel.transport`, across processes).
"""

from __future__ import annotations

import contextlib
import os
import re
import socket
import time

from ..utils.exceptions import NotSupportedError

__all__ = ["trace", "annotate", "label", "profiler_active", "overlap_stats", "op_breakdown",
           "KERNEL_NAMES", "EXCHANGE_KERNELS", "EXCHANGE_KINDS", "EXCHANGE_LABELS"]

# every kernel of the port, by its launch counter (`ops.cuda_build.launch_counts`),
# with the names of the `__global__` functions it launches
KERNEL_NAMES = {"diffusion3d_step_halo": ("diffusion3d_step_halo_kernel",),
                "halo_write": ("halo_write_kernel",),
                "halo_self_exchange": ("self_exchange_kernel",),
                "diffusion3d_step_exchange": ("diffusion3d_step_exchange_kernel",),
                "diffusion2d_step_exchange": ("diffusion2d_step_exchange_kernel",),
                "halo_write_combined": ("halo_write_combined_kernel",),
                "exchange_slabs": ("exchange_slabs_kernel", "exchange_slabs_staggered_kernel"),
                "wire_pack": ("wire_pack_kernel",),
                "halo_write_multi": ("halo_write_multi_kernel",),
                "acoustic_step_exchange": ("acoustic_step_kernel",),
                "stokes_step_exchange": ("stokes_step_kernel", "stokes_step_kernel_column"),
                "fma_chain": ("fma_chain_kernel",)}
# the launch counters of the exchange's kernels: `update_halo`'s tiers and K4s
EXCHANGE_KERNELS = ("halo_write", "halo_self_exchange", "halo_write_combined",
                    "exchange_slabs", "wire_pack", "halo_write_multi")
# their kernels' kinds (`_op_kind`)
EXCHANGE_KINDS = frozenset(k for c in EXCHANGE_KERNELS for k in KERNEL_NAMES[c])
# copies that move data between devices or between a device and the host
_COMM_COPY_RE = re.compile(r"Memcpy (DtoH|HtoD|PtoP|DtoP|PtoD|Peer)", re.IGNORECASE)
_NCCL_RE = re.compile(r"^nccl", re.IGNORECASE)
# the labels the exchange puts around itself (`label`), and the host spans
# of the process group's collectives
EXCHANGE_LABELS = ("igg::update_halo", "igg::exchange_slabs", "igg::exchange_shells",
                   "igg::transport")
_HOST_COMM_RE = re.compile("^(" + "|".join(map(re.escape, EXCHANGE_LABELS))
                           + "|gloo|c10d::|ProcessGroupGloo|nccl:)")


# `torch.autograd.profiler`, bound at the first check so that importing the
# package does not import torch
_autograd_profiler = None
_NO_SPAN = contextlib.nullcontext()


def profiler_active() -> bool:
    """Whether a `torch.profiler` capture runs: one flag read."""
    global _autograd_profiler
    if _autograd_profiler is None:
        import torch.autograd.profiler as ap

        _autograd_profiler = ap
    return _autograd_profiler._is_profiler_enabled


def label(name: str):
    """A named host span in the profiler's timeline around the enclosed
    block (``with label(name):``), entered only while a capture runs:
    outside one it costs a flag read."""
    if not profiler_active():
        return _NO_SPAN
    import torch

    return torch.profiler.record_function(name)


@contextlib.contextmanager
def trace(log_dir: str, *, create_perfetto_link: bool = False):
    """Capture a `torch.profiler` trace of the enclosed block into
    ``log_dir`` (made if missing), as ``<host>_<pid>.<capture>.pt.trace.json``:
    the CPU, and CUDA where the grid's device (else the current one) is a
    card. The runners return once the device has drained, so their work
    lies inside the capture; sync other device work before the block ends.
    Analyze it with `overlap_stats`/`op_breakdown`, or open it in Perfetto.
    ``create_perfetto_link=True`` raises `NotSupportedError`: the port
    uploads nothing. The capture drains the device before it ends."""
    if create_perfetto_link:
        raise NotSupportedError(
            "trace(create_perfetto_link=True): the port uploads no trace; open the "
            "trace file in Perfetto.")
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..parallel.topology import global_grid, grid_is_initialized

    dev = global_grid().device if grid_is_initialized() else None
    cuda = (dev.type == "cuda") if dev is not None else torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    stamp = time.strftime("%Y%m%d-%H%M%S")
    with profile(activities=acts) as prof:
        yield
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"{socket.gethostname()}_{os.getpid()}.{stamp}.pt.trace.json"))


def annotate(name: str):
    """A named region in the profiler timeline around everything the block
    enqueues (`torch.profiler.record_function`)."""
    import torch

    return torch.profiler.record_function(name)


def _op_kind(name: str) -> str:
    """The kind of a trace event: a kernel's name without its return type,
    anonymous namespace, template arguments and parameter list (``void
    (anonymous namespace)::halo_write_multi_kernel<2, unsigned int>(...)``
    -> ``halo_write_multi_kernel``); a copy's or memset's kind (``Memcpy
    DtoH (Device -> Pinned)`` -> ``Memcpy DtoH``); an operator or a label as
    it is named (``aten::add``)."""
    if name.startswith(("Memcpy", "Memset")):
        return " ".join(name.split(" (", 1)[0].split()[:2])
    head = name.replace("(anonymous namespace)::", "").split("<", 1)[0].split("(", 1)[0]
    words = head.split()
    return words[-1] if words else name


def _is_comm(ev) -> bool:
    """Whether a device span is the exchange's (`EXCHANGE_KERNELS`, NCCL,
    the transport's copies)."""
    kind = _op_kind(ev.name)
    return kind in EXCHANGE_KINDS or bool(_NCCL_RE.search(kind)) or (
        ev.cat == "gpu_memcpy" and bool(_COMM_COPY_RE.match(kind)))


_planes_cache: dict = {}


def _all_planes(log_dir: str):
    """Every plane of the newest capture in ``log_dir``, memoized on the
    files' (path, mtime, size): `overlap_stats` and `op_breakdown` of one
    capture read it once. Only the latest capture is kept."""
    from .trace_events import find_trace_files, parse_trace

    files = find_trace_files(log_dir)
    key = tuple((p, os.path.getmtime(p), os.path.getsize(p)) for p in files)
    hit = _planes_cache.get(log_dir)
    if hit is not None and hit[0] == key:
        return hit[1]
    planes = []
    for path in files:
        planes.extend(parse_trace(path))
    _planes_cache.clear()
    _planes_cache[log_dir] = (key, planes)
    return planes


def _device_planes(log_dir: str):
    return [p for p in _all_planes(log_dir) if p.name.startswith("/device:")]


def _merge(intervals):
    """Union of [start, end) intervals; returns merged list and total."""
    if not intervals:
        return [], 0
    intervals = sorted(intervals)
    out = [list(intervals[0])]
    for s, e in intervals[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out, sum(e - s for s, e in out)


def _intersect_total(a, b):
    """Total overlap between two MERGED interval lists."""
    i = j = 0
    total = 0
    while i < len(a) and j < len(b):
        s = max(a[i][0], b[j][0])
        e = min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _stats_from(comm, compute) -> dict:
    """The stats record of both the device-plane and the host paths: merged
    totals, the busy union, and comm ∩ compute = hidden."""
    comm_m, comm_total = _merge(comm)
    comp_m, comp_total = _merge(compute)
    busy = _merge(comm + compute)[1]
    hidden = _intersect_total(comm_m, comp_m)
    return {
        "busy_us": busy / 1e6,
        "compute_us": comp_total / 1e6,
        "comm_us": comm_total / 1e6,
        "hidden_comm_us": hidden / 1e6,
        "exposed_comm_us": (comm_total - hidden) / 1e6,
        "overlap_frac": hidden / comm_total if comm_total else None,
    }


def overlap_stats(log_dir: str):
    """Comm/compute overlap per device plane of the NEWEST capture in
    ``log_dir``: ``{device: {busy_us, compute_us, comm_us, hidden_comm_us,
    exposed_comm_us, overlap_frac}}`` (``"GPU:0"``, ...; see the module
    docstring for what is comm). A capture with no device plane (the CPU)
    falls back to the host (`_host_overlap_stats`), one ``"CPU"`` entry; an
    empty dict means the capture had neither."""
    out = {}
    for plane in _device_planes(log_dir):
        comm, compute = [], []
        for line in plane.lines:
            for ev in line.events:
                if ev.duration_ps <= 0:
                    continue
                (comm if _is_comm(ev) else compute).append((ev.start_ps, ev.end_ps))
        out[plane.name.replace("/device:", "")] = _stats_from(comm, compute)
    if not out:
        out = _host_overlap_stats(log_dir)
    return out


def _host_spans(log_dir: str):
    """The host fallback's spans, ``[(class, event)]``: ``"comm"`` for the
    exchange's labels and the collectives' spans (an operator inside one is
    part of it), ``"op"`` for every other top-level operator (``aten::*``
    not inside another operator or a comm span), per host thread."""
    out = []
    for plane in _all_planes(log_dir):
        if not plane.name.startswith("/host:CPU"):
            continue
        for line in plane.lines:
            open_end = -1   # end of the enclosing comm span or top-level operator
            for ev in line.events:   # start order, outer spans first
                if ev.duration_ps <= 0 or ev.start_ps < open_end:
                    continue
                if _HOST_COMM_RE.search(ev.name):
                    out.append(("comm", ev))
                    open_end = ev.end_ps
                elif ev.name.startswith("aten::"):
                    out.append(("op", ev))
                    open_end = ev.end_ps
    return out


def _host_overlap_stats(log_dir: str):
    """Comm/compute overlap from the host plane (`_host_spans`), the
    fallback of a capture without device planes. Every thread aggregates
    into one ``"CPU"`` entry: ``hidden_comm_us`` is comm time during which
    another thread ran an operator."""
    comm, compute = [], []
    for cls, ev in _host_spans(log_dir):
        (comm if cls == "comm" else compute).append((ev.start_ps, ev.end_ps))
    if not comm and not compute:
        return {}
    return {"CPU": _stats_from(comm, compute)}


def op_breakdown(log_dir: str, top: int = 12):
    """Device time by kind over the NEWEST capture in ``log_dir``:
    ``[(kind, total_us, count), ...]`` sorted by time, ``top`` rows. A kind
    is a kernel's name without its template arguments and parameter list,
    or a copy's kind (`_op_kind`). A capture with no device plane falls back
    to the host's spans (`_host_spans`): the exchange's labels and the
    top-level operators by name. An empty list means neither."""
    agg: dict = {}
    for plane in _device_planes(log_dir):
        for line in plane.lines:
            for ev in line.events:
                kind = _op_kind(ev.name)
                t, c = agg.get(kind, (0, 0))
                agg[kind] = (t + ev.duration_ps, c + 1)
    if not agg:
        for _, ev in _host_spans(log_dir):
            kind = _op_kind(ev.name)
            t, c = agg.get(kind, (0, 0))
            agg[kind] = (t + ev.duration_ps, c + 1)
    rows = sorted(((k, t / 1e6, c) for k, (t, c) in agg.items()), key=lambda r: -r[1])
    return rows[:top]
