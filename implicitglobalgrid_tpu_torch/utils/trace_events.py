"""A reader of the Chrome trace that `torch.profiler` writes.

Counterpart of `implicitglobalgrid_tpu/utils/xplane.py`. The JAX package
decodes the XLA profiler's XSpace protobuf; `torch.profiler` writes no
XPlane but a Chrome trace (``export_chrome_trace``, ``*.pt.trace.json``),
which opens in Perfetto as is. This module reads that file into the JAX
module's data model, so `utils.profiling` keeps its interval arithmetic:

- one ``/device:GPU:<n>`` `XPlane` per CUDA device (the events' ``device``
  argument), one `XLine` a CUDA stream, named ``stream <id>``, holding the
  kernels, copies and memsets that ran on it;
- one ``/host:CPU`` plane holding a line a host thread (``thread <tid>``):
  the operators (``aten::*``), the labels of `torch.profiler.record_function`
  and the other host spans the profiler recorded.

Times are integer picoseconds (`XEvent.start_ps`, ``duration_ps``). The
trace gives microseconds with up to three decimals, on a clock whose values
exceed what a float keeps to the nanosecond; they are read from the JSON
text exactly, and an event's end is its start plus its duration in the
trace's own decimals, so intervals that touch in the trace touch here.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from decimal import Decimal

__all__ = ["XEvent", "XLine", "XPlane", "parse_trace", "find_trace_files",
           "DEVICE_CATEGORIES"]

# the trace categories of the spans that ran on a device
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# host spans that are the profiler's own bookkeeping, not the program's
_HOST_SKIP = ("Trace", "cuda_profiler_range")


@dataclass
class XEvent:
    name: str
    start_ps: int        # on the trace's clock
    duration_ps: int
    cat: str = ""        # the trace's category ("kernel", "cpu_op", ...)

    @property
    def end_ps(self) -> int:
        return self.start_ps + self.duration_ps


@dataclass
class XLine:
    name: str
    events: list = field(default_factory=list)


@dataclass
class XPlane:
    name: str
    lines: list = field(default_factory=list)


def _ps(text) -> int:
    """Microseconds (the JSON number's text) as integer picoseconds."""
    return int((Decimal(str(text)) * 1000000).to_integral_value())


def _plane(planes, name):
    p = planes.get(name)
    if p is None:
        p = planes[name] = (XPlane(name=name), {})
    return p


def _line(plane, key, name):
    lines = plane[1]
    ln = lines.get(key)
    if ln is None:
        ln = lines[key] = XLine(name=name)
        plane[0].lines.append(ln)
    return ln


def parse_trace(path: str):
    """Read one Chrome trace of `torch.profiler` into a list of `XPlane`s:
    the ``/device:GPU:<n>`` planes first (by device), then ``/host:CPU``.
    Only complete events (``"ph": "X"``) with a duration are kept; each
    line's events are in start order."""
    with open(path, encoding="utf-8") as f:
        data = json.load(f, parse_float=str)
    events = data.get("traceEvents", []) if isinstance(data, dict) else data
    planes: dict = {}
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev or "ts" not in ev:
            continue
        cat = str(ev.get("cat", ""))
        args = ev.get("args") or {}
        start = _ps(ev["ts"])
        dur = _ps(Decimal(str(ev["ts"])) + Decimal(str(ev["dur"]))) - start
        x = XEvent(name=str(ev.get("name", "")), start_ps=start, duration_ps=dur, cat=cat)
        if cat in DEVICE_CATEGORIES:
            dev = int(args.get("device", ev.get("pid", 0)))
            stream = args.get("stream", ev.get("tid"))
            pl = _plane(planes, f"/device:GPU:{dev}")
            _line(pl, stream, f"stream {stream}").events.append(x)
        elif cat not in _HOST_SKIP and isinstance(ev.get("pid"), int):
            tid = ev.get("tid")
            _line(_plane(planes, "/host:CPU"), tid, f"thread {tid}").events.append(x)
    out = []
    for name in sorted(planes, key=lambda n: (n == "/host:CPU", len(n), n)):
        plane = planes[name][0]
        for ln in plane.lines:
            ln.events.sort(key=lambda e: (e.start_ps, -e.duration_ps))
        out.append(plane)
    return out


def find_trace_files(log_dir: str):
    """The trace files of the NEWEST capture in ``log_dir``: the
    ``*.pt.trace.json`` files written by the last `utils.profiling.trace`
    (or `torch.profiler.tensorboard_trace_handler`) into it, one a process,
    all of that capture's step (the newest file's name suffix)."""
    if not os.path.isdir(log_dir):
        return []
    files = [os.path.join(log_dir, f) for f in os.listdir(log_dir)
             if f.endswith(".pt.trace.json")]
    if not files:
        return []
    newest = max(files, key=os.path.getmtime)
    stamp = _capture_of(newest)
    return sorted(f for f in files if _capture_of(f) == stamp)


def _capture_of(path: str) -> str:
    """The capture a trace file belongs to: its name's part after the
    process's (``<host>_<pid>.<capture>.pt.trace.json``)."""
    base = os.path.basename(path)[:-len(".pt.trace.json")]
    return base.split(".", 1)[1] if "." in base else ""
