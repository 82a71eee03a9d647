"""The numbers that decide ``correct``: each answer's numbers against their
limits (``limits/<workload>.json``)."""

from __future__ import annotations

import math


def worst(*vals) -> float:
    """The largest of ``vals``, NaN if any is NaN (a plain ``max`` drops a
    NaN that comes second)."""
    vals = [float(v) for v in vals]
    return math.nan if any(math.isnan(v) for v in vals) else max(vals)


def within(value: float, limit: float) -> bool:
    """A number passes when it is finite and at most its limit."""
    return math.isfinite(value) and value <= limit


def judge(per_answer: list, limits: dict):
    """``(checks, failed)``: each number's worst value over the answers
    beside its limit (a non-finite value as None), and the count of answers
    with a number over its limit. A number without a limit fails."""
    names = sorted({k for nums in per_answer for k in nums})
    checks, failed = {}, 0
    for nums in per_answer:
        failed += any(not within(v, limits.get(k, -math.inf)) for k, v in nums.items())
    for k in names:
        v = worst(*(nums[k] for nums in per_answer if k in nums))
        checks[k] = {"value": v if math.isfinite(v) else None,
                     "limit": limits.get(k)}
    return checks, failed


def lines(checks: dict) -> list:
    """One line a number: its value beside its limit."""
    out = []
    for k, c in checks.items():
        ok = c["value"] is not None and c["limit"] is not None and c["value"] <= c["limit"]
        out.append(f"check {k}: {c['value']!r} limit {c['limit']!r} "
                   f"{'ok' if ok else 'FAIL'}")
    return out
