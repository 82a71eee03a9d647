"""Host milliseconds a model step: the mean, over the program's ``igg::step``
spans (one a step of its runner) that lie in the traced window, of the
span's length less the time its CUDA runtime and driver calls wait beyond
their own cost. The step's own host work: the route's dispatch and every
launch of the step, without the waits for room in the device's queue,
which follow the device's pace and not the host's.

A CUDA call's own cost is the median length of the calls of its name in
the first step of each traced call, where the queue has just drained (the
program's calls return once the device is idle) and nothing waits for room
in it. A call whose name no first step makes stays in the host's work."""

import bisect
import statistics

STEP = "igg::step"


def _cuda(name):
    return name.startswith("cuda") or (name.startswith("cu") and name[2:3].isupper())


def read(run):
    td = run.trace
    if td is None:
        return None
    steps = sorted((s, e) for name, s, e in td.host
                   if name == STEP and td.lo <= s and e <= td.hi)
    if not steps:
        return None
    calls = sorted((s, e, n) for n, s, e in td.host if _cuda(n))
    starts = [c[0] for c in calls]

    def inside(s0, e0):
        i, j = bisect.bisect_left(starts, s0), bisect.bisect_right(starts, e0)
        return [c for c in calls[i:j] if c[1] <= e0]

    firsts = [next((st for st in steps if a <= st[0] <= b), None) for _, a, b in td.spans]
    by_name = {}
    for st in filter(None, firsts):
        for s, e, n in inside(*st):
            by_name.setdefault(n, []).append(e - s)
    own = {n: statistics.median(d) for n, d in by_name.items()}
    host = [(e0 - s0) - sum(max(0.0, (e - s) - own[n]) for s, e, n in inside(s0, e0) if n in own)
            for s0, e0 in steps]
    return sum(host) / len(host) / 1e3
