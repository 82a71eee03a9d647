"""Span/event flight recorder — an append-only JSONL stream per run.

Counterpart of `implicitglobalgrid_tpu/telemetry/recorder.py`, in its
format (version 1): each package reads the other's streams. A supervised
run (`runtime/driver.py`) streams its lifecycle — chunk execute splits,
checkpoint save/restore/rollback latencies, guard trips, escalations,
elastic restarts, snapshots — into one newline-delimited JSON file that
survives the process. Records carry a MONOTONIC timestamp ``t``
(ordering-safe across NTP steps; the ``recorder_open`` record anchors it to
wall time), the writer's ``pid`` and ``proc`` (the process's rank in the
live grid's transport: 0 on the virtual mesh or without a grid), the run
id, and a per-recorder sequence number, so a post-hoc reader can
reconstruct the exact event sequence from the file alone
(`telemetry.run_report`).

All instrumentation goes through the module-level current recorder::

    igg.start_flight_recorder("/logs/run42.jsonl")
    state, reports = igg.run_resilient(...)   # driver streams its events
    path = igg.stop_flight_recorder()
    report = igg.run_report(path)

`record_event` is a no-op when no recorder is active — the instrumented
paths pay one None-check. Writes are line-buffered and lock-protected
(driver callbacks and the snapshot writer thread record concurrently);
every line is flushed so a crash loses at most the line being written,
which `read_flight_events` tolerates.
"""

from __future__ import annotations

import contextlib
import json
import os
import secrets
import threading
import time

from ..utils.exceptions import InvalidArgumentError

__all__ = ["FlightRecorder", "start_flight_recorder",
           "stop_flight_recorder", "flight_recorder", "record_event",
           "record_span", "read_flight_events", "use_flight_recorder",
           "bind_thread_recorder"]

_FORMAT_VERSION = 1


def _process_index() -> int:
    """This process's rank in the live grid's transport: 0 on the virtual
    mesh and without a grid."""
    from ..parallel.topology import global_grid, grid_is_initialized

    return int(global_grid().transport.rank) if grid_is_initialized() else 0


def _jsonable(o):
    """Fallback encoder for numpy scalars/arrays and everything else.
    Numeric scalars go through float FIRST (``int(np.float32(0.33))``
    would silently truncate), demoted back to int when integral."""
    try:
        f = float(o)
    except (TypeError, ValueError):
        pass
    else:
        return int(f) if f.is_integer() and abs(f) < 2.0 ** 53 else f
    if hasattr(o, "tolist"):
        return o.tolist()
    return str(o)


class FlightRecorder:
    """Append-only JSONL event stream for one run.

    ``path`` may be a file path (created/appended) or an existing
    directory, in which case the PER-PROCESS convention applies: a
    ``flight_p<process_index>.jsonl`` file is created/appended inside it,
    so N controllers recording into one shared directory never interleave
    writers into one file — exactly the layout
    the JAX package's `telemetry.aggregate.aggregate_flight(dir)` globs
    (``*.jsonl``) to rebuild the mesh-wide view. In a multi-process run
    open the recorder AFTER `init_global_grid` (or after the process group
    started): before it, every process reads rank 0 and would share one
    filename.
    ``run_id`` defaults to a fresh random
    token; it tags every record, so several runs can share one file and
    still be separated by `read_flight_events(path, run_id=...)`."""

    def __init__(self, path, *, run_id: str | None = None):
        self.run_id = str(run_id) if run_id is not None else \
            secrets.token_hex(8)
        path = os.fspath(path)
        if os.path.isdir(path):
            path = os.path.join(path, f"flight_p{_process_index()}.jsonl")
        self.path = path
        self._lock = threading.Lock()
        self._pid = os.getpid()
        self._proc = _process_index()
        self._seq = 0
        # optional distributed-trace context (`telemetry.tracectx.
        # TraceContext`, or any object with ``trace_id`` and ``span_id``):
        # when set, every record is stamped with the trace id and the
        # owning span, ids synthesized at export (`telemetry.otlp`). None
        # (the default) changes NOTHING: records are byte-identical to an
        # untraced recorder's.
        self.trace = None
        self._f = open(path, "a", encoding="utf-8")
        self.event("recorder_open", wall=time.time(),
                   version=_FORMAT_VERSION)

    def event(self, kind: str, **fields) -> None:
        """Append one record. Reserved keys (``t``, ``kind``, ``run``,
        ``pid``, ``proc``, ``seq``) always win over ``fields``."""
        rec = dict(fields)
        tr = self.trace
        if tr is not None:
            rec.setdefault("trace_id", tr.trace_id)
            rec.setdefault("parent_span_id", tr.span_id)
        rec["t"] = time.monotonic()
        rec["kind"] = str(kind)
        rec["run"] = self.run_id
        rec["pid"] = self._pid
        rec["proc"] = self._proc
        with self._lock:
            if self._f is None:
                return  # closed: late events (daemon threads) are dropped
            rec["seq"] = self._seq
            self._seq += 1
            self._f.write(json.dumps(rec, default=_jsonable) + "\n")
            self._f.flush()

    @contextlib.contextmanager
    def span(self, kind: str, **fields):
        """Time the enclosed block and append one record with ``dur_s``."""
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.event(kind, dur_s=time.monotonic() - t0, **fields)

    def close(self) -> None:
        self.event("recorder_close")
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


_current: FlightRecorder | None = None
_tls = threading.local()


def bind_thread_recorder(rec: FlightRecorder | None) -> None:
    """Pin THIS thread's events to ``rec``, overriding the process-wide
    current recorder (None unpins). For long-lived background threads
    that belong to one run — e.g. a job's async snapshot writer under the
    multi-run scheduler, whose commits land while ANOTHER job's recorder
    holds the global slot (or none does, between slices): the thread
    captures its run's recorder once and its events stay correctly
    attributed. Events bound to a recorder that has since closed are
    dropped (the recorder's own closed-check), same as any late event."""
    _tls.recorder = rec


def start_flight_recorder(path, *, run_id: str | None = None
                          ) -> FlightRecorder:
    """Open a `FlightRecorder` and make it THE current recorder — all
    framework instrumentation (`record_event`) streams into it until
    `stop_flight_recorder`. An already-active recorder is closed first."""
    global _current
    # open the NEW recorder first: a failed open (bad path) must leave the
    # active recorder recording, not point _current at a closed one
    new = FlightRecorder(path, run_id=run_id)
    if _current is not None:
        _current.close()
    _current = new
    return new


def stop_flight_recorder() -> str | None:
    """Close the current recorder; returns its file path (None if no
    recorder was active)."""
    global _current
    if _current is None:
        return None
    path = _current.path
    _current.close()
    _current = None
    return path


def flight_recorder() -> FlightRecorder | None:
    """The current recorder, or None."""
    return _current


@contextlib.contextmanager
def use_flight_recorder(rec: FlightRecorder | None):
    """Temporarily make ``rec`` the current recorder WITHOUT closing the
    previous one, restoring it on exit — the multi-run scheduler's
    per-slice routing primitive (each job's driver events stream into that
    job's own JSONL; the outer recorder, if any, resumes afterwards).
    ``rec=None`` silences instrumentation for the block."""
    global _current
    prev = _current
    _current = rec
    try:
        yield rec
    finally:
        _current = prev


def record_event(kind: str, **fields) -> None:
    """Append to this thread's bound recorder (`bind_thread_recorder`) or
    the process-wide current one; no-op (one None-check) when neither is
    active — safe on hot paths."""
    r = getattr(_tls, "recorder", None) or _current
    if r is not None:
        r.event(kind, **fields)


@contextlib.contextmanager
def record_span(kind: str, **fields):
    """Span against the current recorder; when none is active the block
    runs untimed (no clock reads)."""
    r = getattr(_tls, "recorder", None) or _current
    if r is None:
        yield
        return
    with r.span(kind, **fields):
        yield


def read_flight_events(path, *, run_id: str | None = None,
                       offset: int | None = None):
    """Parse a flight-recorder JSONL file back into a list of dicts, in
    file order.

    A malformed FINAL line is tolerated (a crash mid-write is exactly the
    scenario flight recorders exist for); a malformed interior line raises
    `InvalidArgumentError` (the file was edited or interleaved by a foreign
    writer). ``run_id`` filters to one run's records.

    ``offset`` switches to RESUMABLE mode for tailers (`telemetry.live`):
    reading starts at that byte offset and the return value becomes
    ``(events, new_offset)``, where ``new_offset`` is the position after
    the last COMPLETE well-formed line consumed. A torn final line — no
    trailing newline yet, or not yet parseable — is left unconsumed, so
    the next poll re-reads it once the writer's flush completes; it only
    becomes the fatal interior-corruption case when a later complete line
    follows it. Pass ``offset=0`` for the first read and the returned
    ``new_offset`` thereafter; the whole-file form (``offset=None``)
    behaves exactly as before."""
    path = os.fspath(path)
    if not os.path.exists(path):
        raise InvalidArgumentError(f"Flight-recorder file not found: {path}")
    if offset is None:
        out = []
        bad_at = None
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                if not line.strip():
                    continue
                if bad_at is not None:
                    raise InvalidArgumentError(
                        f"Flight-recorder file {path} has a malformed "
                        f"interior line {bad_at + 1} — corrupt or foreign "
                        "content.")
                try:
                    out.append(json.loads(line))
                except ValueError:
                    bad_at = i  # fatal only if any well-formed line follows
        if run_id is not None:
            out = [e for e in out if e.get("run") == str(run_id)]
        return out

    # resumable tail read: byte-offset bookkeeping in BINARY mode (text
    # offsets are not seekable positions under utf-8)
    pos = int(offset)
    if pos < 0:
        raise InvalidArgumentError(
            f"read_flight_events offset must be >= 0; got {offset}.")
    out = []
    bad = None  # (byte_pos_of_line, reason) of a malformed COMPLETE line
    with open(path, "rb") as f:
        f.seek(pos)
        while True:
            line = f.readline()
            if not line:
                break
            if not line.endswith(b"\n"):
                break  # torn tail mid-write: re-read next poll
            if bad is not None:
                if not line.strip():
                    pos += len(line)  # blank after the bad line: benign
                    continue
                raise InvalidArgumentError(
                    f"Flight-recorder file {path} has a malformed interior "
                    f"line at byte {bad} — corrupt or foreign content.")
            if not line.strip():
                pos += len(line)
                continue
            try:
                out.append(json.loads(line.decode("utf-8")))
            except ValueError:
                bad = pos  # fatal only if any well-formed line follows
                continue
            pos += len(line)
    if run_id is not None:
        out = [e for e in out if e.get("run") == str(run_id)]
    return out, pos
