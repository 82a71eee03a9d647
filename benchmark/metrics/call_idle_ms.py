"""Device milliseconds a call leaves unused: for each of the program's
``igg::run`` spans (one a ``run_*`` call, entry to the return after the
drain) in the traced window, its length less its overlap with the union of
the device's operations, averaged over the spans. The device time that the
program's own host work inside a call leaves idle; the benchmark loop's
time between calls is not in it."""

from benchlib import intervals

RUN = "igg::run"


def read(run):
    td = run.trace
    if td is None:
        return None
    calls = [(s, e) for name, s, e in td.host if name == RUN and td.lo <= s and e <= td.hi]
    if not calls:
        return None
    busy, _ = td.busy()
    idle = [(e - s) - intervals.intersect_total([[s, e]], busy) for s, e in calls]
    return sum(idle) / len(idle) / 1e3
