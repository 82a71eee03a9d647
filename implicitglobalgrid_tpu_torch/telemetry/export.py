"""Prometheus text-format exporter for the metrics registry.

Counterpart of `implicitglobalgrid_tpu/telemetry/export.py`, the same text
for the same registry. One function, `prometheus_snapshot`, renders the registry in the
Prometheus exposition format (text/plain version 0.0.4): ``# HELP`` /
``# TYPE`` comment pairs per family, samples with escaped label values,
histograms in the cumulative ``_bucket{le=...}`` / ``_sum`` / ``_count``
form. Operators scrape it however they already scrape sidecar files
(node-exporter textfile collector, a 5-line HTTP handler); the port ships
the FORMAT, not a server (the JAX package's metrics server is still to be
ported).
"""

from __future__ import annotations

import math

from .registry import metrics_registry

__all__ = ["prometheus_snapshot"]


def _esc_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _esc_label(s: str) -> str:
    return (s.replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _fmt(v: float) -> str:
    if isinstance(v, float) and math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if isinstance(v, float) and math.isnan(v):
        return "NaN"
    if float(v) == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _labels(d: dict, extra: dict | None = None) -> str:
    items = list(d.items()) + (list(extra.items()) if extra else [])
    if not items:
        return ""
    body = ",".join(f'{k}="{_esc_label(str(v))}"' for k, v in items)
    return "{" + body + "}"


def prometheus_snapshot(registry=None) -> str:
    """Render ``registry`` (default: the process registry) as Prometheus
    exposition text. Families sort by name and series by label values, so
    successive snapshots diff cleanly."""
    reg = registry if registry is not None else metrics_registry()
    lines = []
    for fam in reg.collect():
        name, kind = fam["name"], fam["kind"]
        lines.append(f"# HELP {name} {_esc_help(fam['help'])}")
        lines.append(f"# TYPE {name} {kind}")
        series = sorted(fam["series"], key=lambda s: sorted(s[0].items()))
        if kind in ("counter", "gauge"):
            for labels, v in series:
                lines.append(f"{name}{_labels(labels)} {_fmt(v)}")
            continue
        # histogram: cumulative buckets + _sum/_count per series
        bounds = fam["buckets"]
        for labels, st in series:
            cum = 0
            for b, c in zip(bounds, st["counts"]):
                cum += c
                lines.append(
                    f"{name}_bucket{_labels(labels, {'le': _fmt(b)})} "
                    f"{_fmt(cum)}")
            lines.append(
                f"{name}_bucket{_labels(labels, {'le': '+Inf'})} "
                f"{_fmt(st['count'])}")
            lines.append(f"{name}_sum{_labels(labels)} {_fmt(st['sum'])}")
            lines.append(f"{name}_count{_labels(labels)} "
                         f"{_fmt(st['count'])}")
    return "\n".join(lines) + ("\n" if lines else "")
