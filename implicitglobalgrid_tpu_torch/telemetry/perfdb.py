"""Perf-history database: append bench runs, gate regressions.

Counterpart of `implicitglobalgrid_tpu/telemetry/perfdb.py`, whole (pure
host code; the ``.jsonl`` format is the JAX package's, so each package
reads and gates the other's history):

- `perfdb_add(db, rows)` appends one JSONL record a bench run,
  ``{"ts", "meta", "metrics": {name: value}}``, from a row list of
  ``{"metric", "value"}`` dicts (a path to a JSON list, or the rows);
- `perfdb_check(db, rows)` compares the current run against the MEDIAN of
  the trailing ``window`` history records, per metric, with the metric's
  direction inferred from its name (`metric_direction`: throughput names
  regress DOWN, overhead and latency names regress UP), and fails on
  changes beyond ``threshold``.

The history is append-only JSONL (one line a run, a torn final line
tolerated) so it diffs, greps and survives partial writes.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import time

from ..utils.exceptions import InvalidArgumentError

__all__ = ["metric_direction", "perfdb_add", "perfdb_check", "perfdb_load"]

# Name-pattern direction inference. The higher-better patterns are the
# more specific ones and are checked FIRST ("..._per_s_per_chip" also
# contains the substring "_s_" a naive seconds-pattern would catch).
_HIGHER_BETTER = ("per_s", "gbps", "gflops", "speedup", "updates",
                  "efficiency")
_LOWER_BETTER = ("overhead", "_frac", "latency", "_seconds", "pipeline_s",
                 "noise", "residual")


def metric_direction(name: str) -> str | None:
    """``"higher"`` / ``"lower"`` = which way is better, None = unknown
    (unknown metrics are reported as skipped, never gated — a typo'd
    pattern must not invert a gate silently; model-fidelity ratios have
    no better direction and stay ungated by design)."""
    n = name.lower()
    for pat in _HIGHER_BETTER:
        if pat in n:
            return "higher"
    for pat in _LOWER_BETTER:
        if pat in n:
            return "lower"
    return None


def _metrics_of(rows_or_path) -> tuple[dict, dict]:
    """(metrics, meta) from a BENCH_ALL.json path or a row list: every
    row with a string ``metric`` and a finite numeric ``value``."""
    if isinstance(rows_or_path, (str, os.PathLike)):
        path = os.fspath(rows_or_path)
        try:
            with open(path, encoding="utf-8") as f:
                rows = json.load(f)
        except (OSError, ValueError) as e:
            raise InvalidArgumentError(
                f"perfdb: cannot read bench rows from {path}: {e}") from e
    else:
        rows = list(rows_or_path)
    if not isinstance(rows, list):
        raise InvalidArgumentError(
            "perfdb: bench rows must be a list of row dicts "
            "(the BENCH_ALL.json shape).")
    metrics: dict = {}
    meta: dict = {}
    for row in rows:
        if not isinstance(row, dict):
            continue
        name, value = row.get("metric"), row.get("value")
        if not isinstance(name, str) or not isinstance(value, (int, float)) \
                or isinstance(value, bool) or not math.isfinite(value):
            continue
        metrics[name] = float(value)
        if not meta and row.get("platform"):
            meta = {k: row.get(k)
                    for k in ("platform", "device_kind", "n_devices")
                    if row.get(k) is not None}
    if not metrics:
        raise InvalidArgumentError(
            "perfdb: no usable (metric, numeric value) rows found.")
    return metrics, meta


def perfdb_load(db_path) -> list:
    """History records, oldest first (a torn final line is tolerated,
    interior corruption raises — same contract as the flight reader)."""
    path = os.fspath(db_path)
    if not os.path.exists(path):
        return []
    out = []
    with open(path, encoding="utf-8") as f:
        lines = f.read().split("\n")
    for i, ln in enumerate(lines):
        s = ln.strip()
        if not s:
            continue
        try:
            out.append(json.loads(s))
        except ValueError:
            trailing = all(not x.strip() for x in lines[i + 1:])
            if trailing:
                break  # torn final line: crash mid-append
            raise InvalidArgumentError(
                f"perfdb: corrupt interior line {i + 1} in {path}.")
    return out


def perfdb_add(db_path, rows_or_path, *, meta: dict | None = None) -> dict:
    """Append the current bench run to the history. Returns the appended
    record ``{"ts", "meta", "metrics"}``."""
    metrics, row_meta = _metrics_of(rows_or_path)
    rec = {"ts": time.time(), "meta": {**row_meta, **(meta or {})},
           "metrics": metrics}
    path = os.fspath(db_path)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "a", encoding="utf-8") as f:
        f.write(json.dumps(rec) + "\n")
        f.flush()
        os.fsync(f.fileno())
    return rec


def perfdb_check(db_path, rows_or_path, *, window: int = 5,
                 threshold: float = 0.30, min_history: int = 2) -> dict:
    """Gate the current run against the trailing history.

    Per metric of the current run with an inferrable direction: baseline
    = median of that metric over the last ``window`` history records
    (records missing it are skipped); a relative change beyond
    ``threshold`` in the WORSE direction is a regression. Metrics with
    fewer than ``min_history`` history points, or an unknown direction,
    are reported under ``skipped`` and never gated (a fresh metric's
    first runs build history instead of failing it).

    Returns ``{"ok", "checked", "regressions": [{metric, value, baseline,
    change, direction, n_history}], "improvements", "skipped",
    "history_runs"}`` — ``ok`` is False iff ``regressions`` is
    non-empty."""
    if not 0 < threshold:
        raise InvalidArgumentError(
            f"perfdb_check: threshold must be positive (got {threshold}).")
    history = perfdb_load(db_path)
    metrics, _ = _metrics_of(rows_or_path)
    regressions, improvements, skipped = [], [], []
    for name, value in sorted(metrics.items()):
        direction = metric_direction(name)
        if direction is None:
            skipped.append({"metric": name, "reason": "unknown-direction"})
            continue
        past = [r["metrics"][name] for r in history[-int(window):]
                if isinstance(r.get("metrics"), dict)
                and isinstance(r["metrics"].get(name), (int, float))
                and math.isfinite(r["metrics"][name])]
        if len(past) < int(min_history):
            skipped.append({"metric": name, "reason": "insufficient-history",
                            "n_history": len(past)})
            continue
        baseline = statistics.median(past)
        if baseline == 0.0:
            # relative change is undefined; gate on absolute movement away
            # from a zero baseline only in the worse direction
            change = value
        else:
            change = (value - baseline) / abs(baseline)
        worse = change < -threshold if direction == "higher" \
            else change > threshold
        rec = {"metric": name, "value": value, "baseline": baseline,
               "change": change, "direction": direction,
               "n_history": len(past)}
        if worse:
            regressions.append(rec)
        elif abs(change) > threshold:
            improvements.append(rec)
    return {
        "ok": not regressions,
        "checked": len(metrics) - len(skipped),
        "regressions": regressions,
        "improvements": improvements,
        "skipped": skipped,
        "history_runs": len(history),
        "window": int(window),
        "threshold": float(threshold),
    }
