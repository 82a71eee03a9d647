"""Cross-process flight aggregation: N per-process JSONLs -> one mesh view.

Counterpart of `implicitglobalgrid_tpu/telemetry/aggregate.py`, whole. The
flight recorder (`telemetry.recorder`) is process-local: each process of a
`torch.distributed` group streams its own JSONL (``flight_p<rank>.jsonl``
when started with a directory). This module merges those streams post-hoc
into one clock-aligned event sequence (either package's streams):

- `aggregate_flight(source)` loads every per-process stream (a directory
  is globbed for ``*.jsonl``), validates run-id and per-process sequence
  consistency, estimates per-process clock offsets and returns the merged,
  time-sorted sequence with its alignment metadata; `aggregate_events` does
  the same for events already loaded (incrementally with ``resume``);
- `straggler_report(agg)` turns it into per-chunk arrival spreads,
  slowest-process attribution, rolling-window persistent-straggler flags,
  a per-process wait/compute imbalance summary and the mesh-wide
  classification of ``perf_regression`` flags (`_perf_regressions`);
- `mesh_section(events)` is the compact form `run_report` embeds as its
  ``"mesh"`` section.

Clock alignment needs no new collective: every chunk of the resilient
driver ENDS at the health guard's one `transport.all_sum` (`runtime.health`;
the JAX package's chunk-boundary psum), which all processes leave together,
so each process's ``chunk`` record stamps the same instant (plus its own
fetch jitter). Per process the monotonic clock is anchored to wall time by
its ``recorder_open`` record; the residual offset to the reference process
(the lowest index) is the MEDIAN of the per-chunk barrier-stamp deltas. On
the virtual mesh there is one process and one stream.

Attribution model: the chunk is the same work on every process, so the
unencumbered compute time of a chunk is the MINIMUM ``exec_s`` across
processes (the last arriver never waits at the barrier; everyone else's
``exec_s`` holds its wait). A process's barrier ARRIVAL is its corrected
dispatch start plus that compute estimate, so host-side delays show up as
late dispatch starts of the process that incurred them.
"""

from __future__ import annotations

import glob
import os
import statistics

from ..utils.exceptions import InvalidArgumentError
from .recorder import read_flight_events

__all__ = ["aggregate_flight", "aggregate_events", "straggler_report",
           "mesh_section"]


def _resolve_paths(source) -> list:
    """``source`` -> list of JSONL paths: a directory is globbed for
    ``*.jsonl`` (the ``flight_p<i>.jsonl`` convention plus any legacy
    single-file streams), a single file is itself, an iterable of paths
    passes through."""
    if isinstance(source, (str, os.PathLike)):
        source = os.fspath(source)
        if os.path.isdir(source):
            paths = sorted(glob.glob(os.path.join(source, "*.jsonl")))
            if not paths:
                raise InvalidArgumentError(
                    f"aggregate_flight: no *.jsonl files under {source}.")
            return paths
        return [source]
    paths = [os.fspath(p) for p in source]
    if not paths:
        raise InvalidArgumentError("aggregate_flight: no paths given.")
    return paths


def _pick_run_id(events: list, run_id) -> str | None:
    """The one run id to aggregate: explicit, or the single id present —
    several ids without an explicit choice is an error (streams from
    different runs must never be silently mixed into one timeline)."""
    if run_id is not None:
        return str(run_id)
    ids = []
    for e in events:
        r = e.get("run")
        if r is not None and r not in ids:
            ids.append(r)
    if not ids:
        return None
    if len(ids) > 1:
        raise InvalidArgumentError(
            f"aggregate_flight: {len(ids)} run ids present ({ids}); pass "
            "run_id= to select one.")
    return ids[0]


def _chunk_ends(events: list) -> dict:
    """{chunk_index: barrier timestamp} for one process's stream."""
    return {e["chunk"]: e["t"] for e in events
            if e.get("kind") == "chunk" and "chunk" in e and "t" in e}


def aggregate_flight(source, *, run_id: str | None = None) -> dict:
    """Merge per-process flight streams into one mesh-wide sequence.

    ``source``: a directory (globbed for ``*.jsonl``), one path, or an
    iterable of paths. ``run_id`` selects a run when the streams hold
    several (required then — mixing runs raises).

    Returns ``{run_id, processes, files, anchor_proc, offsets, align,
    per_process, events}`` where ``events`` is the merged sequence sorted
    by corrected time (each event's ``t`` is rewritten onto the reference
    process's wall-anchored clock; the original monotonic stamp moves to
    ``t_mono``, the applied correction to ``t_offset``). Offsets are the
    residual per-process corrections estimated at the chunk barriers
    (``align.method[proc] == "chunk-barrier"``; a process sharing no
    chunk with the anchor falls back to its wall-clock anchor alone,
    ``"wall-anchor"``, without degrading the others' fit metadata).

    Validation: one run id across all streams; within each process the
    (possibly multi-file) sequence numbers must be duplicate-free and
    gapless FROM 0 — anything else means a foreign writer interleaved the
    stream, a file was truncated mid-run, or the stream's head (with the
    ``recorder_open`` wall anchor) is missing, and raises
    `InvalidArgumentError` (a torn FINAL line is still tolerated by the
    underlying reader)."""
    paths = _resolve_paths(source)
    raw = []
    for p in paths:
        for e in read_flight_events(p):
            e["_file"] = p
            raw.append(e)
    agg = aggregate_events(raw, run_id=run_id, _what="aggregate_flight")
    files: dict = {}
    for e in agg["events"]:
        files.setdefault(int(e.get("proc", 0)), set()).add(e.pop("_file"))
    agg["files"] = {p: sorted(fs) for p, fs in files.items()}
    for proc, meta in agg["per_process"].items():
        meta["files"] = agg["files"].get(proc, [])
    return agg


_RESUME_CHUNKS = 64  # barrier timestamps carried per process for alignment


def aggregate_events(events, *, run_id: str | None = None,
                     resume: dict | None = None,
                     _what: str = "aggregate_events") -> dict:
    """`aggregate_flight` for ALREADY-LOADED events: the same run-id
    selection, per-process seq validation, and clock alignment over an
    iterable of event dicts (however they were read or concatenated).
    Returns the same record minus the ``files`` map.

    ``resume`` makes it INCREMENTAL for tailers: pass the ``"resume"``
    record of the previous call and an events batch holding only the
    NEW records (e.g. from `read_flight_events(..., offset=)`). Seq
    validation then requires each process's batch to be gapless from
    its checkpointed next seq (not from 0), the wall anchors default to
    the checkpointed ones (a ``recorder_open`` is only expected in the
    first batch), and the barrier-offset medians are computed over the
    checkpoint's carried chunk ends PLUS the batch's — so alignment
    quality matches a full re-read without re-validating history. The
    result's ``events`` hold only the aligned batch; its ``"resume"``
    record feeds the next call. An EMPTY batch is valid with ``resume``
    (returns no events, state carried through)."""
    raw = list(events)
    prior = resume or {}
    rid = _pick_run_id(raw, run_id if run_id is not None
                       else prior.get("run_id"))
    per_proc: dict = {}
    for e in raw:
        if rid is not None and e.get("run") != rid:
            continue
        per_proc.setdefault(int(e.get("proc", 0)), []).append(e)
    if not per_proc and resume is None:
        raise InvalidArgumentError(f"{_what}: no events for run {rid!r}.")

    # --- seq consistency: duplicate-free, gapless per process (from 0,
    # or from the resume checkpoint's next expected seq) -----------------
    next_seq = {int(p): int(n)
                for p, n in (prior.get("next_seq") or {}).items()}
    per_process_meta = {}
    for proc, evs in per_proc.items():
        base = next_seq.get(proc, 0)
        seqs = sorted(e["seq"] for e in evs if "seq" in e)
        if len(set(seqs)) != len(seqs):
            raise InvalidArgumentError(
                f"{_what}: duplicate sequence numbers for process "
                f"{proc} (run {rid!r}) — two writers interleaved one "
                "stream.")
        if seqs and seqs != list(range(base, base + len(seqs))):
            at = "do not start at 0" if base == 0 else \
                f"do not resume at {base}"
            raise InvalidArgumentError(
                f"{_what}: process {proc} (run {rid!r}) has gaps in its "
                f"sequence numbers (or they {at}) — a stream "
                "file is missing, was truncated mid-run, or lost its head "
                "(the recorder_open wall anchor).")
        evs.sort(key=lambda e: e.get("seq", 0))
        if seqs:
            next_seq[proc] = seqs[-1] + 1
        per_process_meta[proc] = {
            "events": len(evs),
            "chunks": sum(1 for e in evs if e.get("kind") == "chunk"),
        }

    # --- clock alignment -------------------------------------------------
    # 1) per process: monotonic -> wall via the recorder_open anchor
    #    (carried through resume once seen)
    wall_anchor = {int(p): float(a)
                   for p, a in (prior.get("wall_anchor") or {}).items()}
    for proc, evs in per_proc.items():
        for e in evs:
            if e.get("kind") == "recorder_open" and "wall" in e:
                wall_anchor[proc] = float(e["wall"]) - float(e["t"])
                break
        wall_anchor.setdefault(proc, 0.0)
    # union of every process ever seen: a process silent THIS batch keeps
    # its alignment state (and its offset) across incremental calls
    chunk_hist = {int(p): {int(c): float(t) for c, t in ends.items()}
                  for p, ends in (prior.get("chunk_ends") or {}).items()}
    procs = sorted(set(per_proc) | set(chunk_hist) | set(wall_anchor))
    if not procs:
        raise InvalidArgumentError(f"{_what}: no events for run {rid!r}.")
    anchor = procs[0]
    # 2) residual offset to the anchor process: median delta of the
    #    chunk-barrier timestamps over the chunks both processes logged
    #    (resume carries the trailing _RESUME_CHUNKS barriers per process)
    for proc, evs in per_proc.items():
        hist = chunk_hist.setdefault(proc, {})
        hist.update(_chunk_ends(evs))
        if len(hist) > _RESUME_CHUNKS:
            for c in sorted(hist)[:len(hist) - _RESUME_CHUNKS]:
                del hist[c]
    ref_ends = chunk_hist.get(anchor, {})
    offsets = {anchor: 0.0}
    residuals = {anchor: 0.0}
    chunks_used = {anchor: len(ref_ends)}
    # per-process alignment method: one crashed-early stream falling back
    # to its wall anchor must not misreport the healthy streams' quality
    methods = {anchor: "anchor"}
    for proc in procs[1:]:
        ends = chunk_hist.get(proc, {})
        common = sorted(set(ends) & set(ref_ends))
        deltas = [(ends[c] + wall_anchor[proc])
                  - (ref_ends[c] + wall_anchor[anchor]) for c in common]
        chunks_used[proc] = len(common)
        methods[proc] = "chunk-barrier"
        if len(deltas) >= 2:
            off = statistics.median(deltas)
            residuals[proc] = statistics.median(
                abs(d - off) for d in deltas)
        elif deltas:
            off = deltas[0]
            residuals[proc] = 0.0
        else:  # nothing shared: the wall anchor is all we have
            off, residuals[proc] = 0.0, None
            methods[proc] = "wall-anchor"
        offsets[proc] = off

    merged = []
    for proc, evs in per_proc.items():
        shift = wall_anchor[proc] - offsets[proc]
        for e in evs:
            e = dict(e)
            if "t" in e:
                e["t_mono"] = e["t"]
                e["t"] = float(e["t"]) + shift
            e["t_offset"] = offsets[proc]
            merged.append(e)
    merged.sort(key=lambda e: (e.get("t", 0.0), e.get("proc", 0),
                               e.get("seq", 0)))
    return {
        "run_id": rid,
        "processes": procs,
        "anchor_proc": anchor,
        "offsets": offsets,
        "align": {"method": methods,
                  "chunks_used": chunks_used,
                  "residual_s": residuals},
        "per_process": per_process_meta,
        "events": merged,
        "resume": {"run_id": rid,
                   "next_seq": dict(next_seq),
                   "wall_anchor": dict(wall_anchor),
                   "chunk_ends": {p: dict(h)
                                  for p, h in chunk_hist.items()}},
    }


def _events_of(agg_or_events) -> list:
    if isinstance(agg_or_events, dict):
        return agg_or_events["events"]
    return list(agg_or_events)


def straggler_report(agg_or_events, *, window: int = 8,
                     share: float = 0.5) -> dict:
    """Straggler & imbalance analysis over an aggregated event stream.

    ``agg_or_events``: the `aggregate_flight` result (or any clock-aligned
    event list). ``window``/``share``: a process is flagged a PERSISTENT
    straggler when it is the slowest arriver in more than ``share`` of the
    chunks of any ``window``-chunk rolling window (adjacent flagged
    windows merge into one span).

    Returns::

        {"processes": [...],
         "chunks": [{chunk, step_end, spread_s, slowest, compute_s,
                     arrival_s: {proc: lateness vs first}}, ...],
         "slowest_counts": {proc: n},
         "persistent": [{proc, first_chunk, last_chunk, chunks, share}],
         "imbalance": {proc: {exec_s_total, compute_s_total, wait_s_total,
                              wait_frac, build_s_total}},
         "perf_regressions": {events, per_process, chunks: [{chunk,
                              procs, scope, max_z}], mesh_wide, localized}
                              | None,
         "summary": {chunks, spread_s_mean, spread_s_max, worst_proc}}

    ``perf_regressions`` classifies the drift detector's
    ``perf_regression`` events (`telemetry.perfmodel.PerfWatch` via the
    driver) across the mesh: a chunk flagged by at least half the
    processes — and never fewer than two, so one sick process can't
    read as the whole mesh — is a MESH-WIDE slowdown (thermal
    throttling, a shared-filesystem stall, an interconnect event); one
    flagged by fewer is LOCALIZED and attributed to the flagging
    process(es) — the same
    verdict the arrival-spread analysis gives, but from each process's
    own baseline, so it also catches a slowdown that hits everyone
    equally (which barrier spreads are blind to). None when no stream
    carries perf events.

    Arrival model: see the module docstring — arrival = corrected dispatch
    start + min-across-processes ``exec_s`` (the unencumbered compute
    estimate); the per-chunk barrier wait of a process is its ``exec_s``
    excess over that minimum. Only chunks logged by EVERY process enter
    the analysis (a chunk one process never ran — mid-rollback divergence
    — has no mesh-wide barrier to measure)."""
    events = _events_of(agg_or_events)
    by_chunk: dict = {}
    procs = set()
    for e in events:
        if e.get("kind") != "chunk" or "exec_s" not in e:
            continue
        proc = int(e.get("proc", 0))
        procs.add(proc)
        # retried chunk indices (rollback) keep the LAST occurrence
        by_chunk.setdefault(e.get("chunk"), {})[proc] = e
    procs = sorted(procs)
    if len(procs) < 2:
        raise InvalidArgumentError(
            "straggler_report needs chunk events from at least two "
            f"processes (have {procs}); aggregate per-process streams "
            "first (aggregate_flight).")

    chunks = []
    slowest_counts = {p: 0 for p in procs}
    totals = {p: {"exec_s_total": 0.0, "wait_s_total": 0.0,
                  "build_s_total": 0.0} for p in procs}
    for c in sorted(k for k, v in by_chunk.items() if len(v) == len(procs)):
        recs = by_chunk[c]
        compute = min(float(r["exec_s"]) for r in recs.values())
        arrivals = {p: (float(r["t"]) - float(r["exec_s"])) + compute
                    for p, r in recs.items()}
        first = min(arrivals.values())
        slowest = max(arrivals, key=arrivals.get)
        spread = arrivals[slowest] - first
        slowest_counts[slowest] += 1
        for p, r in recs.items():
            totals[p]["exec_s_total"] += float(r["exec_s"])
            totals[p]["wait_s_total"] += float(r["exec_s"]) - compute
            totals[p]["build_s_total"] += float(r.get("build_s", 0.0))
        chunks.append({
            "chunk": c,
            "step_end": recs[slowest].get("step_end"),
            "spread_s": spread,
            "slowest": slowest,
            "compute_s": compute,
            "arrival_s": {p: arrivals[p] - first for p in procs},
        })

    # rolling-window persistent-straggler flags (merged into spans); a
    # run shorter than the window is judged over the chunks it has
    win_n = min(int(window), len(chunks))
    persistent = []
    for i in range(len(chunks) - win_n + 1 if win_n else 0):
        win = chunks[i:i + win_n]
        counts: dict = {}
        for ch in win:
            counts[ch["slowest"]] = counts.get(ch["slowest"], 0) + 1
        for p, n in counts.items():
            if n / len(win) <= share:
                continue
            prev = persistent[-1] if persistent else None
            if prev and prev["proc"] == p \
                    and win[0]["chunk"] <= prev["last_chunk"] + 1:
                prev["last_chunk"] = win[-1]["chunk"]
            else:
                persistent.append({"proc": p,
                                   "first_chunk": win[0]["chunk"],
                                   "last_chunk": win[-1]["chunk"]})
    # chunks/share describe the MERGED span, not one contributing window
    for span in persistent:
        within = [c for c in chunks
                  if span["first_chunk"] <= c["chunk"]
                  <= span["last_chunk"]]
        n = sum(1 for c in within if c["slowest"] == span["proc"])
        span["chunks"] = n
        span["share"] = n / len(within)

    imbalance = {}
    for p, t in totals.items():
        ex = t["exec_s_total"]
        imbalance[p] = {
            **t,
            "compute_s_total": ex - t["wait_s_total"],
            "wait_frac": (t["wait_s_total"] / ex) if ex else 0.0,
        }
    spreads = [c["spread_s"] for c in chunks]
    return {
        "processes": procs,
        "chunks": chunks,
        "slowest_counts": slowest_counts,
        "persistent": persistent,
        "imbalance": imbalance,
        "perf_regressions": _perf_regressions(events, procs),
        "summary": {
            "chunks": len(chunks),
            "spread_s_mean": (sum(spreads) / len(spreads)) if spreads
            else None,
            "spread_s_max": max(spreads) if spreads else None,
            "worst_proc": (max(slowest_counts, key=slowest_counts.get)
                           if chunks else None),
        },
    }


def _perf_regressions(events, procs) -> dict | None:
    """Mesh-wide classification of the drift detector's flags (see
    `straggler_report`). ``procs`` is the straggler analysis's process
    list — the mesh-wide threshold counts against EVERY process with
    chunk events, not just the flagging ones."""
    flags = [e for e in events if e.get("kind") == "perf_regression"]
    if not flags:
        return None
    by_chunk: dict = {}
    per_proc: dict = {}
    for e in flags:
        p = int(e.get("proc", 0))
        per_proc[p] = per_proc.get(p, 0) + 1
        rec = by_chunk.setdefault(e.get("chunk"), {"procs": set(),
                                                   "max_z": 0.0})
        rec["procs"].add(p)
        rec["max_z"] = max(rec["max_z"], float(e.get("z", 0.0) or 0.0))
    need = max(2, (len(procs) + 1) // 2)  # at least half the mesh
    chunks = []
    mesh_wide = 0
    for c in sorted(by_chunk, key=lambda x: (x is None, x)):
        rec = by_chunk[c]
        scope = "mesh-wide" if len(rec["procs"]) >= need else "process"
        mesh_wide += scope == "mesh-wide"
        chunks.append({"chunk": c, "procs": sorted(rec["procs"]),
                       "scope": scope, "max_z": rec["max_z"]})
    return {
        "events": len(flags),
        "per_process": per_proc,
        "chunks": chunks,
        "mesh_wide": mesh_wide,
        "localized": len(chunks) - mesh_wide,
    }


def mesh_section(agg_or_events, *, window: int = 8,
                 share: float = 0.5) -> dict | None:
    """The compact cross-process record `run_report` embeds as ``"mesh"``:
    alignment metadata (when given an `aggregate_flight` result) plus the
    straggler report minus its per-chunk bulk (the full per-chunk rows
    stay available via `straggler_report`). None when the stream holds
    fewer than two processes' chunk events."""
    events = _events_of(agg_or_events)
    procs = {int(e.get("proc", 0)) for e in events
             if e.get("kind") == "chunk"}
    if len(procs) < 2:
        return None
    rep = straggler_report(events, window=window, share=share)
    out = {
        "processes": rep["processes"],
        "slowest_counts": rep["slowest_counts"],
        "persistent_stragglers": rep["persistent"],
        "imbalance": rep["imbalance"],
        "perf_regressions": rep["perf_regressions"],
        "summary": rep["summary"],
    }
    if isinstance(agg_or_events, dict):
        out["offsets"] = agg_or_events.get("offsets")
        out["align"] = agg_or_events.get("align")
    return out
