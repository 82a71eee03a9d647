"""Process-local metrics registry — counters, gauges, fixed-bucket histograms.

Counterpart of `implicitglobalgrid_tpu/telemetry/registry.py`, pure host
Python and the same families: Prometheus-style named metric families with
typed kinds and label sets, process-local (one registry per process — a
multi-process run scrapes each process, the model Prometheus uses for any
sharded service), and THREAD-SAFE (the resilient driver's ``on_report``
callbacks and the snapshot writer thread may record concurrently).

Families are registered lazily and idempotently::

    reg = metrics_registry()
    reg.counter("igg_health_events_total", "Resilient-runtime events.",
                ("kind",)).inc(1, kind="chunks")
    reg.histogram("igg_checkpoint_seconds", "Checkpoint wall time.",
                  ("op",)).observe(0.12, op="save_sharded")

Export with `telemetry.prometheus_snapshot()`; `reset_metrics()` zeros every
series for test isolation (family registrations survive, so cached family
handles stay valid). The resilient runtime's event counts are the
``igg_health_events_total`` family (`telemetry.hooks.record_health_event`
is the writer).
"""

from __future__ import annotations

import bisect
import re
import threading

from ..utils.exceptions import InvalidArgumentError

__all__ = ["MetricsRegistry", "Counter", "Gauge", "Histogram",
           "DEFAULT_BUCKETS", "metrics_registry", "reset_metrics",
           "ScopedRegistry"]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Latency-flavored default buckets (seconds): checkpoint saves and chunk
# executions both land between ~1 ms (CPU-mesh tests) and minutes (pod-scale
# restores), so the spread is wide and fixed — no dynamic re-bucketing.
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0)


class _Family:
    """One named metric family: a kind, a fixed label set, and the series
    keyed by label values. All mutation happens under the owning registry's
    lock (one lock per registry — contention is a few dict ops)."""

    kind = ""

    def __init__(self, registry: "MetricsRegistry", name: str, help: str,
                 labelnames: tuple):
        self._reg = registry
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._series: dict = {}

    def _key(self, labels: dict) -> tuple:
        if set(labels) != set(self.labelnames):
            raise InvalidArgumentError(
                f"Metric {self.name} takes labels {self.labelnames}; got "
                f"{tuple(sorted(labels))}.")
        return tuple(str(labels[ln]) for ln in self.labelnames)

    def samples(self) -> list:
        """``[(labels_dict, value), ...]`` snapshot (copied under lock)."""
        with self._reg._lock:
            items = list(self._series.items())
        return [(dict(zip(self.labelnames, k)), v) for k, v in items]


class Counter(_Family):
    """Monotone within a run; `inc` only accepts non-negative increments."""

    kind = "counter"

    def inc(self, n: float = 1, **labels) -> None:
        if n < 0:
            raise InvalidArgumentError(
                f"Counter {self.name} cannot decrease (inc({n})).")
        k = self._key(labels)
        with self._reg._lock:
            self._series[k] = self._series.get(k, 0.0) + n

    def value(self, **labels) -> float:
        with self._reg._lock:
            return self._series.get(self._key(labels), 0.0)


class Gauge(_Family):
    """A value that can go anywhere (current step, live chunk size)."""

    kind = "gauge"

    def set(self, v: float, **labels) -> None:
        with self._reg._lock:
            self._series[self._key(labels)] = float(v)

    def add(self, n: float, **labels) -> None:
        k = self._key(labels)
        with self._reg._lock:
            self._series[k] = self._series.get(k, 0.0) + n

    def value(self, **labels) -> float:
        with self._reg._lock:
            return self._series.get(self._key(labels), 0.0)


class Histogram(_Family):
    """Fixed-bucket histogram: per-series non-cumulative bucket counts plus
    sum/count (the exporter emits the cumulative Prometheus form). Bucket
    bounds are fixed at registration — no allocation in `observe` beyond
    the first observation of a label set."""

    kind = "histogram"

    def __init__(self, registry, name, help, labelnames, buckets):
        super().__init__(registry, name, help, labelnames)
        bs = tuple(float(b) for b in buckets)
        if not bs or any(b2 <= b1 for b1, b2 in zip(bs, bs[1:])):
            raise InvalidArgumentError(
                f"Histogram {name} needs a strictly increasing, non-empty "
                f"bucket tuple; got {buckets!r}.")
        self.buckets = bs

    def observe(self, v: float, **labels) -> None:
        v = float(v)
        k = self._key(labels)
        i = bisect.bisect_left(self.buckets, v)  # first bound >= v; len=+Inf
        with self._reg._lock:
            st = self._series.get(k)
            if st is None:
                st = self._series[k] = {
                    "counts": [0] * (len(self.buckets) + 1),
                    "sum": 0.0, "count": 0}
            st["counts"][i] += 1
            st["sum"] += v
            st["count"] += 1


class MetricsRegistry:
    """Named metric families, registered lazily and idempotently.

    Re-registering an existing name with the same kind/labels (and buckets,
    for histograms) returns the SAME family object; a conflicting
    re-registration raises `InvalidArgumentError` — two subsystems cannot
    silently write incompatible series under one name."""

    def __init__(self):
        self._lock = threading.RLock()
        self._families: dict = {}

    def _register(self, cls, name, help, labelnames, **extra):
        if not _NAME_RE.match(name or ""):
            raise InvalidArgumentError(f"Invalid metric name {name!r}.")
        labelnames = tuple(labelnames)
        for ln in labelnames:
            if not _LABEL_RE.match(ln or ""):
                raise InvalidArgumentError(
                    f"Invalid label name {ln!r} for metric {name}.")
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                same = (fam.kind == cls.kind
                        and fam.labelnames == labelnames
                        and extra.get("buckets",
                                      getattr(fam, "buckets", None))
                        == getattr(fam, "buckets", None))
                if not same:
                    raise InvalidArgumentError(
                        f"Metric {name} is already registered as a "
                        f"{fam.kind} with labels {fam.labelnames}; cannot "
                        f"re-register as a {cls.kind} with {labelnames}.")
                return fam
            fam = cls(self, name, help, labelnames, **extra)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labelnames: tuple = ()) -> Counter:
        return self._register(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: tuple = ()) -> Gauge:
        return self._register(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "", labelnames: tuple = (),
                  buckets: tuple = DEFAULT_BUCKETS) -> Histogram:
        return self._register(Histogram, name, help, labelnames,
                              buckets=tuple(float(b) for b in buckets))

    def get(self, name: str):
        """The registered family, or None."""
        with self._lock:
            return self._families.get(name)

    def collect(self) -> list:
        """Snapshot of every family: ``[{name, kind, help, labelnames,
        series: [(labels_dict, value_or_hist_state), ...]}, ...]``, sorted
        by name; histogram states are deep-copied."""
        with self._lock:
            fams = sorted(self._families.values(), key=lambda f: f.name)
            out = []
            for f in fams:
                series = []
                for k, v in f._series.items():
                    if isinstance(v, dict):  # histogram state
                        v = {"counts": list(v["counts"]),
                             "sum": v["sum"], "count": v["count"]}
                    series.append((dict(zip(f.labelnames, k)), v))
                rec = {"name": f.name, "kind": f.kind, "help": f.help,
                       "labelnames": f.labelnames, "series": series}
                if f.kind == "histogram":
                    rec["buckets"] = f.buckets
                out.append(rec)
        return out

    def scoped(self, **labels) -> "ScopedRegistry":
        """A view of this registry that namespaces every family it touches
        under fixed extra labels — the PER-JOB namespacing the multi-run
        scheduler uses (``reg.scoped(job="run42")``): a family registered
        through the view carries the scope's label names appended to its
        own, and every sample call fills them in automatically. Series
        from different scopes coexist in ONE family (one exported metric
        name, label-separated), exactly how Prometheus models tenants."""
        return ScopedRegistry(self, labels)

    def reset(self, name: str | None = None) -> None:
        """Zero every series of family ``name`` (or of ALL families).
        Registrations survive, so handles cached by callers stay valid."""
        with self._lock:
            if name is not None:
                fam = self._families.get(name)
                if fam is not None:
                    fam._series.clear()
                return
            for fam in self._families.values():
                fam._series.clear()


class _ScopedFamily:
    """A family handle that injects the scope's labels into every call.
    Mirrors the Counter/Gauge/Histogram sample surface (`inc`/`set`/`add`/
    `observe`/`value`); the underlying family is shared across scopes."""

    def __init__(self, family: _Family, labels: dict):
        self._fam = family
        self._labels = labels

    @property
    def name(self) -> str:
        return self._fam.name

    def _merge(self, labels: dict) -> dict:
        overlap = set(labels) & set(self._labels)
        if overlap:
            raise InvalidArgumentError(
                f"Metric {self._fam.name}: labels {sorted(overlap)} are "
                "fixed by the registry scope and cannot be overridden.")
        return {**labels, **self._labels}

    def inc(self, n: float = 1, **labels) -> None:
        self._fam.inc(n, **self._merge(labels))

    def set(self, v: float, **labels) -> None:
        self._fam.set(v, **self._merge(labels))

    def add(self, n: float, **labels) -> None:
        self._fam.add(n, **self._merge(labels))

    def observe(self, v: float, **labels) -> None:
        self._fam.observe(v, **self._merge(labels))

    def value(self, **labels) -> float:
        return self._fam.value(**self._merge(labels))


class ScopedRegistry:
    """A label-namespaced view of a `MetricsRegistry` (see
    `MetricsRegistry.scoped`). Registration appends the scope's label
    names to the family's own (idempotently against other scopes of the
    SAME label-name set — two jobs share one family); sample calls fill
    the scope's values in. ``remove_scope()`` drops exactly this scope's
    series from every family it touched — how the scheduler retires a
    finished job's gauges without zeroing the neighbors'."""

    def __init__(self, registry: MetricsRegistry, labels: dict):
        if not labels:
            raise InvalidArgumentError(
                "ScopedRegistry needs at least one scope label "
                "(e.g. job='run42').")
        for ln in labels:
            if not _LABEL_RE.match(ln or ""):
                raise InvalidArgumentError(
                    f"Invalid scope label name {ln!r}.")
        self.registry = registry
        self.labels = {k: str(v) for k, v in labels.items()}
        self._touched: set = set()

    def _scoped(self, fam: _Family) -> _ScopedFamily:
        self._touched.add(fam.name)
        return _ScopedFamily(fam, self.labels)

    def _labelnames(self, labelnames: tuple) -> tuple:
        clash = set(labelnames) & set(self.labels)
        if clash:
            raise InvalidArgumentError(
                f"Label name(s) {sorted(clash)} collide with the scope's.")
        return tuple(labelnames) + tuple(self.labels)

    def counter(self, name: str, help: str = "",
                labelnames: tuple = ()) -> _ScopedFamily:
        return self._scoped(self.registry.counter(
            name, help, self._labelnames(labelnames)))

    def gauge(self, name: str, help: str = "",
              labelnames: tuple = ()) -> _ScopedFamily:
        return self._scoped(self.registry.gauge(
            name, help, self._labelnames(labelnames)))

    def histogram(self, name: str, help: str = "", labelnames: tuple = (),
                  buckets: tuple = DEFAULT_BUCKETS) -> _ScopedFamily:
        return self._scoped(self.registry.histogram(
            name, help, self._labelnames(labelnames), buckets=buckets))

    def get(self, name: str):
        fam = self.registry.get(name)
        return None if fam is None else self._scoped(fam)

    def remove_scope(self) -> None:
        """Delete every series carrying THIS scope's label values from the
        families this view touched (other scopes' series survive)."""
        items = sorted(self.labels.items())
        with self.registry._lock:
            for name in self._touched:
                fam = self.registry._families.get(name)
                if fam is None:
                    continue
                pos = [fam.labelnames.index(ln) for ln, _ in items
                       if ln in fam.labelnames]
                vals = [v for ln, v in items if ln in fam.labelnames]
                for k in [k for k in fam._series
                          if [k[p] for p in pos] == vals]:
                    del fam._series[k]


_default = MetricsRegistry()


def metrics_registry() -> MetricsRegistry:
    """The process-default registry (what the framework's own
    instrumentation and `prometheus_snapshot()` use)."""
    return _default


def reset_metrics() -> None:
    """Zero every series in the default registry (test isolation /
    scrape-and-reset exporters). Family registrations survive."""
    _default.reset()
