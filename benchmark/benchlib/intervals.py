"""Interval arithmetic on device spans: the union of ``[start, end)``
intervals, its total, and the gaps it leaves in a window.

The same arithmetic as the program's profiling helpers (`_merge`,
`_intersect_total`), kept here so the yardstick does not move with the
program."""

from __future__ import annotations


def merge(intervals):
    """The union of ``[start, end)`` intervals: ``(sorted disjoint list,
    total length)``."""
    out = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out, sum(e - s for s, e in out)


def clip(intervals, lo, hi):
    """The parts of ``intervals`` inside ``[lo, hi)``."""
    return [(max(s, lo), min(e, hi)) for s, e in intervals if min(e, hi) > max(s, lo)]


def intersect_total(a, b):
    """Total overlap of two merged interval lists."""
    i = j = 0
    total = 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def gaps(merged, lo, hi):
    """The idle stretches ``[(start, end)]`` of window ``[lo, hi)`` that the
    merged busy list leaves."""
    out, t = [], lo
    for s, e in merged:
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]
