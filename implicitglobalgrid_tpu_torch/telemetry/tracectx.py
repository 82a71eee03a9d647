"""W3C trace-context: the one causal identity threaded through the service.

Counterpart of `implicitglobalgrid_tpu/telemetry/tracectx.py`, whole. A
`TraceContext` is the (trace id, span id, parent span id) triple of the W3C
Trace Context recommendation (https://www.w3.org/TR/trace-context/): a
128-bit trace id naming the end-to-end request and a 64-bit span id naming
the current operation within it. The wire form is the ``traceparent``
header::

    traceparent: 00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01
                 ^^ ^^^^^^^^^^^^^^^^ trace id ^^^^^^ ^^ span id ^^^^^^ ^^
               version                                              flags

A queue record's ``traceparent`` (`service.DirectoryBackend`) or the
``trace=`` of `service.MeshScheduler.submit` is a job's root; the scheduler
derives a fresh CHILD span for the job and for every journal event under it,
and the job's flight recorder stamps its events with the root
(`telemetry.recorder.FlightRecorder.trace`). A claim, its admission verdict,
each granted slice, the alert that fired on it and the resize chain it
triggered then share one trace id and form one parent-linked tree
(`telemetry.otlp.export_otlp` renders it). The ids and the header are the
JAX package's, so either package's streams join one trace.

Everything here is stdlib-only and host-side: ids come from `os.urandom`, no
clock reads, no allocation beyond the frozen dataclass.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field, replace

from ..utils.exceptions import InvalidArgumentError

__all__ = ["TraceContext", "new_trace_id", "new_span_id"]

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")


def new_trace_id() -> str:
    """A fresh 128-bit trace id as 32 lowercase hex chars (never all-zero
    — the W3C invalid sentinel)."""
    while True:
        tid = os.urandom(16).hex()
        if tid != "0" * 32:
            return tid


def new_span_id() -> str:
    """A fresh 64-bit span id as 16 lowercase hex chars (never all-zero)."""
    while True:
        sid = os.urandom(8).hex()
        if sid != "0" * 16:
            return sid


@dataclass(frozen=True)
class TraceContext:
    """One node of a distributed trace: ``trace_id`` names the request,
    ``span_id`` this operation, ``parent_span_id`` the operation that
    caused it (None at the root).  ``flags`` is the W3C trace-flags octet
    (``01`` = sampled, the only defined bit)."""

    trace_id: str
    span_id: str = field(default_factory=new_span_id)
    parent_span_id: str | None = None
    flags: str = "01"

    def __post_init__(self):
        for name, val, n in (("trace_id", self.trace_id, 32),
                             ("span_id", self.span_id, 16)):
            if not isinstance(val, str) or len(val) != n \
                    or any(c not in "0123456789abcdef" for c in val) \
                    or val == "0" * n:
                raise InvalidArgumentError(
                    f"TraceContext: {name} must be {n} lowercase hex chars "
                    f"and not all-zero, got {val!r}.")
        if self.parent_span_id is not None \
                and (not isinstance(self.parent_span_id, str)
                     or len(self.parent_span_id) != 16
                     or any(c not in "0123456789abcdef"
                            for c in self.parent_span_id)):
            raise InvalidArgumentError(
                "TraceContext: parent_span_id must be 16 lowercase hex "
                f"chars or None, got {self.parent_span_id!r}.")

    # -- construction --------------------------------------------------

    @classmethod
    def new(cls) -> "TraceContext":
        """A fresh ROOT context: new trace id, new span id, no parent."""
        return cls(trace_id=new_trace_id())

    @classmethod
    def parse(cls, traceparent: str) -> "TraceContext":
        """Parse a ``traceparent`` header value.  The caller becomes a
        CHILD of the header's span: the parsed span id lands in
        ``span_id`` (call `child()` to derive the local span).  Raises
        `InvalidArgumentError` on malformed input, all-zero ids, or the
        reserved version ``ff``."""
        if not isinstance(traceparent, str):
            raise InvalidArgumentError(
                f"traceparent must be a string, got "
                f"{type(traceparent).__name__}.")
        m = _TRACEPARENT_RE.match(traceparent.strip().lower())
        if m is None:
            raise InvalidArgumentError(
                f"malformed traceparent {traceparent!r} (want "
                f"'<2hex>-<32hex>-<16hex>-<2hex>').")
        version, trace_id, span_id, flags = m.groups()
        if version == "ff":
            raise InvalidArgumentError(
                f"traceparent version 'ff' is invalid ({traceparent!r}).")
        if trace_id == "0" * 32 or span_id == "0" * 16:
            raise InvalidArgumentError(
                f"traceparent has all-zero id(s) ({traceparent!r}).")
        return cls(trace_id=trace_id, span_id=span_id, flags=flags)

    # -- derivation ----------------------------------------------------

    def child(self) -> "TraceContext":
        """A new span under this one: same trace, fresh span id, parent
        link to `self.span_id`."""
        return replace(self, span_id=new_span_id(),
                       parent_span_id=self.span_id)

    # -- rendering -----------------------------------------------------

    def to_traceparent(self) -> str:
        """The W3C header value for THIS span (version 00)."""
        return f"00-{self.trace_id}-{self.span_id}-{self.flags}"

    def fields(self) -> dict:
        """The journal/flight stamp: the keys `MeshScheduler._log` and
        `export_otlp` agree on. ``parent_span_id`` only when present."""
        d = {"trace_id": self.trace_id, "span_id": self.span_id}
        if self.parent_span_id is not None:
            d["parent_span_id"] = self.parent_span_id
        return d
