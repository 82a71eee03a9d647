"""The traced sub-window: a `torch.profiler` capture of a few seconds of the
window, reduced to device spans attributed to the benchmark's own host
spans.

The generator marks each call into the program ``bench::call``
(`torch.profiler.record_function`, only while a capture runs). A device operation (kernel, copy, memset)
belongs to the span that holds the host call that launched it (matched by
the trace's correlation ids; by its own start where the launch is
missing). The window is the first traced span's start to the last one's
end; the device is busy in the union of its operations' spans.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from dataclasses import dataclass, field
from pathlib import Path

from . import intervals

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
CALL = "bench::call"


def op_kind(name: str) -> str:
    """A device operation's kind: a kernel's name without its return type,
    namespaces, template arguments and parameters (``void
    (anonymous namespace)::halo_write_multi_kernel<2, unsigned>(...)`` ->
    ``halo_write_multi_kernel``), a copy's or memset's kind (``Memcpy DtoH
    (Device -> Pinned)`` -> ``Memcpy DtoH``)."""
    if name.startswith(("Memcpy", "Memset")):
        return " ".join(name.split(" (", 1)[0].split()[:2])
    head = name.replace("(anonymous namespace)::", "").split("<", 1)[0].split("(", 1)[0]
    words = head.split()
    return words[-1].split("::")[-1] if words else name


@dataclass
class DeviceOp:
    kind: str
    start: float   # microseconds, the trace's clock
    end: float
    span: str | None   # CALL or None (launched outside a call)


@dataclass
class TraceData:
    """A reduced capture: every time in microseconds."""
    lo: float
    hi: float
    ops: list
    spans: list                      # [(name, start, end)] of the benchmark's spans
    host: list = field(default_factory=list)   # [(name, start, end)] host events
    steps: int = 0                   # model steps inside the traced calls

    @property
    def window_us(self) -> float:
        return self.hi - self.lo

    def busy(self):
        """(merged busy list, busy microseconds) inside the window."""
        return intervals.merge(intervals.clip([(o.start, o.end) for o in self.ops],
                                              self.lo, self.hi))

    def call_ops(self):
        return [o for o in self.ops if o.span == CALL]


def reduce(chrome: dict, steps: int) -> TraceData | None:
    """Reduce an exported Chrome trace; None where it holds no span of the
    benchmark."""
    events = [e for e in chrome.get("traceEvents", []) if e.get("ph") == "X"]
    spans = sorted((e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                   for e in events
                   if e.get("cat") == "user_annotation" and e.get("name") == CALL)
    if not spans:
        return None
    spans.sort(key=lambda s: s[1])
    lo, hi = spans[0][1], max(s[2] for s in spans)
    launch = {}
    host = []
    for e in events:
        cat = e.get("cat")
        if cat in HOST_CATS:
            ts = float(e["ts"])
            host.append((e.get("name", ""), ts, ts + float(e.get("dur", 0))))
            corr = (e.get("args") or {}).get("correlation")
            if cat in ("cuda_runtime", "cuda_driver") and corr is not None:
                launch[corr] = ts
    starts = [s[1] for s in spans]

    def span_of(t):
        i = bisect.bisect_right(starts, t) - 1
        return spans[i][0] if i >= 0 and spans[i][1] <= t <= spans[i][2] else None

    ops = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        ts = float(e["ts"])
        corr = (e.get("args") or {}).get("correlation")
        ops.append(DeviceOp(op_kind(e.get("name", "")), ts, ts + float(e.get("dur", 0)),
                            span_of(launch.get(corr, ts))))
    return TraceData(lo=lo, hi=hi, ops=ops, spans=spans, host=host, steps=int(steps))


def breakdown(td: TraceData, top: int = 10) -> dict:
    """The device operations that took most time and the longest idle gaps
    of the window, each gap named by what the host was doing at its middle
    (the benchmark's span, then the innermost host event there)."""
    by = {}
    for o in td.ops:
        s, e = max(o.start, td.lo), min(o.end, td.hi)
        if e > s:
            by[o.kind] = by.get(o.kind, 0.0) + (e - s)
    device_ops = sorted(([k, v / 1e6] for k, v in by.items()), key=lambda r: -r[1])[:top]
    merged, _ = td.busy()
    idle = sorted(intervals.gaps(merged, td.lo, td.hi), key=lambda g: g[0] - g[1])[:top]
    out = []
    for s, e in idle:
        mid = 0.5 * (s + e)
        outer = next((n for n, a, b in td.spans if a <= mid <= b), "between spans")
        inner = [h for h in td.host if h[1] <= mid <= h[2] and h[0] != CALL]
        name = outer + (" > " + min(inner, key=lambda h: h[2] - h[1])[0] if inner else "")
        out.append([name, (e - s) / 1e6])
    return {"device_ops": device_ops, "idle_gaps": out}


class Profiler:
    """A `torch.profiler` capture started and stopped at call boundaries.
    The trace is written under the temporary directory, read back and
    deleted."""

    def __init__(self, cuda: bool):
        from torch.profiler import ProfilerActivity

        self.acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        self.prof = None

    def warm(self, device):
        """One capture of a small operation on ``device``, so that the
        profiler's own start-up is paid in set-up."""
        import torch

        self.start()
        torch.ones(8, device=device).sum().item()
        self.stop()
        self.prof = None

    def start(self):
        from torch.profiler import profile

        self.prof = profile(activities=self.acts)
        self.prof.start()

    def stop(self):
        self.prof.stop()

    def collect(self) -> dict:
        """The stopped capture's Chrome trace, read back and deleted."""
        path = Path(tempfile.gettempdir()) / f"bench_trace_{os.getpid()}.json"
        try:
            self.prof.export_chrome_trace(str(path))
            return json.loads(path.read_text())
        finally:
            self.prof = None
            path.unlink(missing_ok=True)
