"""Live observability plane: incremental flight tailing, derived signals
and a declarative SLO/alert engine.

Counterpart of `implicitglobalgrid_tpu/telemetry/live.py`, whole: it reads
either package's flight directories and gives the same snapshots, and the
same snapshots give the same alert transitions. The other observability
surfaces are post-hoc (`aggregate_flight` / `straggler_report` /
`run_report` re-read whole JSONLs after the run) or point-in-time (the
`/metrics` gauges). This module is the live middle: it tail-follows the
per-process flight JSONLs of a run, or a scheduler's whole flight
directory, journal included, and keeps rolling DERIVED state while the jobs
are still running:

- `FlightTail`: the byte-offset-checkpointed reader loop. It re-globs the
  directory each poll (new job files appear over time), resumes each file
  at its checkpointed offset (`read_flight_events(offset=)`: a torn final
  line is re-read next poll) and tracks per-stream sequence continuity
  WITHOUT raising: in tail mode a gap is an integrity observation (recorded
  in ``.gaps``), not a crash; the post-hoc aggregator stays the strict one.
- `LiveAggregate`: `FlightTail` plus the clock alignment of
  `telemetry.aggregate` applied incrementally (`aggregate_events(resume=)`)
  and the rolling signal windows: warm step-time quantiles and robust z
  (`robust_z`, `PerfWatch`'s estimator), per-job deadline slack,
  chunk-boundary barrier spreads with persistent-straggler attribution,
  wire/snapshot byte rates, and scheduler queue pressure from the journal
  and `service.QueueBackend` counts. Every merged event gets a
  monotonically increasing ``live_seq`` (the resume cursor of
  `events_since`).
- `AlertRule` / `AlertEngine`: declarative rules (threshold, counter rate,
  burn rate, robust z-score) over any live-derived signal (dotted paths
  into the snapshot, ``*`` fanning out per job/process) or any registry
  metric (``metric:<family>``), evaluated at chunk boundaries with
  per-(rule, key) firing/resolved state machines, consecutive-breach
  hysteresis and dedup. Every transition is journaled as an ``alert``
  flight event, counted as ``igg_alerts_total{rule,severity,state}`` and
  delivered to pluggable sinks: `log_sink`, `ControlFileSink` (files the
  cancel / resize / drain control files a live `service.MeshScheduler`
  consumes at its next slice boundary) and `WebhookSink` (stdlib urllib
  POST, errors swallowed and counted).

`default_rule_pack` ships the six house rules: deadline-slack burn,
guard-trip storm, persistent straggler, perf-regression streak, io-queue
saturation, checkpoint-latency blowout. `service.MeshScheduler(alerts=True)`
embeds the engine in-process: it evaluates over the scheduler's own state
at every slice boundary and journals through the scheduler's journal;
`LiveAggregate` is the observer-side twin for off-process dashboards.
Host-side only: nothing here touches a tensor or the card.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from collections import deque

from ..utils.exceptions import InvalidArgumentError
from .aggregate import _resolve_paths, aggregate_events
from .hooks import note_alert, note_flight_file_bytes
from .perfmodel import robust_z
from .recorder import read_flight_events

__all__ = ["FlightTail", "LiveAggregate", "AlertRule", "AlertEngine",
           "default_rule_pack", "log_sink", "ControlFileSink",
           "WebhookSink"]

_log = logging.getLogger("implicitglobalgrid_tpu_torch.live")


class FlightTail:
    """Incremental reader over one or many flight JSONLs (see module
    docstring). ``source``: a directory (re-globbed for ``*.jsonl``
    EVERY poll — a scheduler admits jobs, and their files must join the
    tail mid-flight), one path, or an iterable of paths. ``run_id``
    filters to one run's records.

    `poll()` returns the newly appended raw events (each tagged with
    ``_file``), in per-file order. Integrity observations — a sequence
    gap, a seq restart (recorder reopened), a truncated/replaced file,
    interior corruption — land in ``.gaps`` instead of raising; a
    corrupt file is skipped to its end (re-following from the next
    append) so one bad stream cannot wedge the whole tail."""

    def __init__(self, source, *, run_id: str | None = None):
        self.source = source
        self.run_id = None if run_id is None else str(run_id)
        self._offsets: dict = {}       # path -> byte offset
        self._next_seq: dict = {}      # (path, run, proc) -> expected seq
        self.gaps: list = []
        self.events_read = 0

    def _paths(self) -> list:
        if isinstance(self.source, (str, os.PathLike)) \
                and os.path.isdir(os.fspath(self.source)):
            import glob

            return sorted(glob.glob(
                os.path.join(os.fspath(self.source), "*.jsonl")))
        try:
            return _resolve_paths(self.source)
        except InvalidArgumentError:
            return []  # an empty directory is a tail waiting for files

    def poll(self) -> list:
        out = []
        for p in self._paths():
            off = self._offsets.get(p, 0)
            try:
                size = os.path.getsize(p)
            except OSError:
                continue
            if size < off:
                # the file shrank: replaced or truncated under us —
                # restart from its head and say so
                self.gaps.append({"file": p, "kind": "truncated",
                                  "offset": off, "size": size,
                                  "t": time.time()})
                off = 0
                self._next_seq = {k: v for k, v in self._next_seq.items()
                                  if k[0] != p}
            try:
                evs, new_off = read_flight_events(p, offset=off)
            except InvalidArgumentError as e:
                # interior corruption: record it once and skip past —
                # the strict post-hoc reader is where this is fatal
                self.gaps.append({"file": p, "kind": "corrupt",
                                  "error": str(e), "t": time.time()})
                self._offsets[p] = size
                continue
            self._offsets[p] = new_off
            # disk hygiene rides the tail checkpoint: each stream's
            # on-disk size as a gauge, so recorder growth is visible
            # (tools flight du is the CLI twin)
            note_flight_file_bytes(os.path.basename(p), size)
            for e in evs:
                if self.run_id is not None \
                        and e.get("run") != self.run_id:
                    continue
                seq = e.get("seq")
                if seq is not None:
                    key = (p, e.get("run"), int(e.get("proc", 0)))
                    expect = self._next_seq.get(key)
                    if expect is not None and int(seq) != expect:
                        self.gaps.append({
                            "file": p, "run": e.get("run"),
                            "proc": key[2],
                            "kind": ("seq_gap" if int(seq) > expect
                                     else "seq_restart"),
                            "expected": expect, "got": int(seq),
                            "t": time.time()})
                    self._next_seq[key] = int(seq) + 1
                e = dict(e)
                e["_file"] = p
                out.append(e)
        self.events_read += len(out)
        return out


def _quantile(hist: list, q: float):
    if not hist:
        return None
    s = sorted(hist)
    return s[min(len(s) - 1, int(q * (len(s) - 1) + 0.5))]


class LiveAggregate:
    """Rolling mesh/service view over a tailed flight source (see the
    module docstring). ``window`` sizes the per-job rolling windows
    (step times, checkpoint latencies, byte-rate samples);
    ``straggler_window``/``min_samples`` mirror `straggler_report` /
    `PerfWatch`. ``backend`` (a `service.QueueBackend`) adds live
    pending-count/oldest-age queue pressure to every snapshot.

    Call `poll()` at your cadence (the terminal dashboard and the
    streaming endpoints do); read `snapshot()` for the derived-signal
    record and `events_since(cursor)` for the merged, clock-aligned,
    ``live_seq``-stamped event feed (bounded buffer — a consumer that
    falls more than ``buffer`` events behind detects the loss by the
    cursor jump)."""

    def __init__(self, source, *, run_id: str | None = None,
                 window: int = 16, straggler_window: int = 8,
                 min_samples: int = 5, backend=None, buffer: int = 4096):
        if int(window) < 2:
            raise InvalidArgumentError(
                f"LiveAggregate needs window >= 2 (got {window}).")
        self.tail = FlightTail(source, run_id=run_id)
        self.window = int(window)
        self.straggler_window = max(2, int(straggler_window))
        self.min_samples = max(2, min(int(min_samples), self.window))
        self.backend = backend
        self._resume: dict = {}        # run id -> aggregate resume record
        self._offsets: dict = {}       # run id -> last good proc offsets
        self._live_seq = 0
        self._buffer: deque = deque(maxlen=int(buffer))
        self._jobs: dict = {}
        self._mesh: dict = {}          # run id -> barrier-spread state
        self._alerts: dict = {}        # (rule, job) -> last transition
        self._recent_alerts: deque = deque(maxlen=64)
        self._queue: dict = {}
        self._sched = {"slices": 0, "draining": False, "last_t": None,
                       "started": False, "stopped": False}
        # the autoscaler's journaled policy verdicts — the
        # observer-side twin of the scheduler's closed loop: policy
        # echo, verdict counts, and the recent decision records (the
        # "autoscale" section of the serve tier's /v1/observe)
        self._autoscale = {"policy": None, "decisions": 0, "filed": 0,
                           "rejected": 0, "resizes": 0, "retunes": 0,
                           "last": None}
        self._autoscale_recent: deque = deque(maxlen=32)
        self._last_event_t = None      # newest aligned wall stamp seen
        self.align: dict = {}          # run id -> alignment metadata

    # -- tail + alignment --------------------------------------------------

    @property
    def gaps(self) -> list:
        return self.tail.gaps

    @property
    def cursor(self) -> int:
        """``live_seq`` of the last merged event (-1 before any)."""
        return self._live_seq - 1

    def poll(self) -> list:
        """Consume everything newly appended: align, merge, stamp
        ``live_seq``, fold into the derived windows. Returns the newly
        merged events (aligned copies, oldest first)."""
        raw = self.tail.poll()
        batches: dict = {}
        for e in raw:
            batches.setdefault(e.get("run"), []).append(e)
        merged = []
        for rid in sorted(batches, key=str):
            merged.extend(self._align_batch(rid, batches[rid]))
        merged.sort(key=lambda e: (e.get("t", 0.0), e.get("proc", 0),
                                   e.get("seq", 0)))
        for e in merged:
            e["live_seq"] = self._live_seq
            self._live_seq += 1
            self._consume(e)
            self._buffer.append(e)
            if e.get("t") is not None:
                t = float(e["t"])
                if self._last_event_t is None or t > self._last_event_t:
                    self._last_event_t = t
        if self.backend is not None:
            try:
                self._queue["pending"] = self.backend.pending_count()
                self._queue["oldest_age_s"] = self.backend.oldest_age_s()
            except Exception as e:  # a backend hiccup must not stop the tail
                self._queue["error"] = f"{type(e).__name__}: {e}"
        return merged

    def _align_batch(self, rid, batch: list) -> list:
        """One run's new events through the incremental aligner; a batch
        the strict aligner refuses (mid-stream attach, a gap the tail
        already recorded) degrades to shift-only alignment with the last
        known offsets instead of raising."""
        resume = self._resume.get(rid)
        if resume is not None:
            # gap tolerance: re-base each process's expected seq on what
            # actually arrived (the tail recorded the discontinuity)
            nxt = dict(resume.get("next_seq") or {})
            for e in batch:
                proc, seq = int(e.get("proc", 0)), e.get("seq")
                if seq is not None and proc in nxt \
                        and int(seq) < nxt[proc]:
                    nxt[proc] = int(seq)  # restart: allow re-validation
            for proc in {int(e.get("proc", 0)) for e in batch}:
                seqs = sorted(int(e["seq"]) for e in batch
                              if int(e.get("proc", 0)) == proc
                              and "seq" in e)
                if seqs and seqs[0] > nxt.get(proc, 0):
                    nxt[proc] = seqs[0]
            resume = dict(resume, next_seq=nxt)
        else:
            # first sight of this run: tolerate a mid-stream attach
            nxt = {}
            for proc in {int(e.get("proc", 0)) for e in batch}:
                seqs = sorted(int(e["seq"]) for e in batch
                              if int(e.get("proc", 0)) == proc
                              and "seq" in e)
                if seqs and seqs[0] > 0:
                    nxt[proc] = seqs[0]
            if nxt:
                resume = {"next_seq": nxt}
        try:
            agg = aggregate_events(batch, run_id=rid, resume=resume,
                                   _what="live_aggregate")
        except InvalidArgumentError as e:
            self.tail.gaps.append({"run": rid, "kind": "align_failed",
                                   "error": str(e), "t": time.time()})
            out = self._shift_only(rid, batch)
            # keep resuming past the bad batch
            res = self._resume.setdefault(
                rid, {"run_id": rid, "next_seq": {}, "wall_anchor": {},
                      "chunk_ends": {}})
            for e in batch:
                if "seq" in e:
                    proc = int(e.get("proc", 0))
                    res["next_seq"][proc] = max(
                        res["next_seq"].get(proc, 0), int(e["seq"]) + 1)
            return out
        self._resume[rid] = agg["resume"]
        self._offsets[rid] = {"wall_anchor":
                              dict(agg["resume"]["wall_anchor"]),
                              "offsets": dict(agg["offsets"])}
        self.align[rid] = {"anchor_proc": agg["anchor_proc"],
                           **agg["align"]}
        return agg["events"]

    def _shift_only(self, rid, batch: list) -> list:
        known = self._offsets.get(rid, {})
        wall = known.get("wall_anchor", {})
        offs = known.get("offsets", {})
        out = []
        for e in batch:
            e = dict(e)
            proc = int(e.get("proc", 0))
            shift = wall.get(proc, 0.0) - offs.get(proc, 0.0)
            if "t" in e:
                e["t_mono"] = e["t"]
                e["t"] = float(e["t"]) + shift
            out.append(e)
        return out

    # -- derived state -----------------------------------------------------

    def _job(self, name) -> dict:
        rec = self._jobs.get(name)
        if rec is None:
            rec = self._jobs[name] = {
                "state": None, "step": None, "nt": None, "chunks": 0,
                "slices": 0, "guard_trips": 0, "rollbacks": 0,
                "perf_regressions": 0, "step_s_last": None, "z": None,
                "deadline_slack_s": None, "deadline_budget_s": None,
                "deadline_missed": False, "checkpoint_s": None,
                "checkpoint_restores": 0, "snapshot_queue_depth": None,
                "snapshot_drops": 0, "snapshot_errors": 0,
                "wire_bytes_total": 0.0, "snapshot_bytes_total": 0.0,
                "wait_s_last": None,
                "_steps": deque(maxlen=self.window),
                "_ckpt": deque(maxlen=self.window),
                "_bytes": deque(maxlen=self.window),
            }
        return rec

    def _consume(self, e: dict) -> None:
        kind = e.get("kind")
        run = e.get("run")
        if run == "scheduler":
            self._consume_journal(kind, e)
            return
        job = self._job(run)
        if kind == "chunk":
            job["chunks"] += 1
            if e.get("step_end") is not None:
                job["step"] = e["step_end"]
            if not e.get("ok", True):
                job["guard_trips"] += 1
            n = int(e.get("n", 0) or 0)
            if n > 0 and e.get("exec_s") is not None and e.get("ok", True):
                per_step = float(e["exec_s"]) / n
                job["step_s_last"] = per_step
                # z against the window BEFORE this sample — PerfWatch's
                # exact discipline (a cold chunk pays its compile in
                # build_s, not exec_s, so it may enter the baseline)
                z, _, _ = robust_z(per_step, job["_steps"],
                                   min_samples=self.min_samples)
                job["z"] = z
                job["_steps"].append(per_step)
            self._observe_barrier(run, e)
        elif kind == "run_begin":
            job["state"] = job["state"] or "running"
            if e.get("nt") is not None:
                job["nt"] = e["nt"]
        elif kind == "rollback":
            job["rollbacks"] += 1
        elif kind == "perf_regression":
            job["perf_regressions"] += 1
        elif kind == "deadline_slack":
            job["deadline_slack_s"] = e.get("slack_s")
            job["deadline_budget_s"] = e.get("budget_s")
        elif kind == "deadline_missed":
            job["deadline_missed"] = True
        elif kind == "checkpoint_save":
            if e.get("dur_s") is not None:
                job["checkpoint_s"] = float(e["dur_s"])
                job["_ckpt"].append(float(e["dur_s"]))
        elif kind == "checkpoint_restore":
            job["checkpoint_restores"] += 1
        elif kind == "snapshot_write":
            job["snapshot_bytes_total"] += float(e.get("nbytes", 0) or 0)
            if e.get("queue_depth") is not None:
                job["snapshot_queue_depth"] = e["queue_depth"]
            self._mark_bytes(job, e)
        elif kind == "snapshot_drop":
            job["snapshot_drops"] += 1
            if e.get("queue_depth") is not None:
                job["snapshot_queue_depth"] = e["queue_depth"]
        elif kind == "snapshot_error":
            job["snapshot_errors"] += 1
        elif kind == "halo_exchange":
            # trace-time accounting: one event per traced exchange, so
            # this is the STATIC byte volume, not a per-step counter
            job["wire_bytes_total"] += float(e.get("wire_bytes", 0) or 0)
            self._mark_bytes(job, e)
        elif kind == "run_end":
            job["state"] = "done" if job["state"] in (None, "running") \
                else job["state"]

    @staticmethod
    def _mark_bytes(job: dict, e: dict) -> None:
        job["_bytes"].append((float(e.get("t", 0.0)),
                              job["wire_bytes_total"],
                              job["snapshot_bytes_total"]))

    def _consume_journal(self, kind, e: dict) -> None:
        name = e.get("job")
        if kind == "scheduler_start":
            self._sched["started"] = True
            if e.get("autoscale") is not None:
                self._autoscale["policy"] = e["autoscale"]
        elif kind == "scheduler_stop":
            self._sched["stopped"] = True
        elif kind == "drain":
            self._sched["draining"] = True
        elif kind == "job_submitted":
            job = self._job(name)
            job["state"] = "queued"
            if e.get("nt") is not None:
                job["nt"] = e["nt"]
        elif kind == "job_admitted":
            self._job(name)["state"] = "running"
        elif kind == "slice":
            self._sched["slices"] += 1
            self._sched["last_t"] = e.get("t")
            job = self._job(name)
            job["slices"] += 1
            if e.get("step") is not None:
                job["step"] = e["step"]
            if e.get("wait_s") is not None:
                job["wait_s_last"] = e["wait_s"]
            if e.get("slack_s") is not None:
                job["deadline_slack_s"] = e["slack_s"]
        elif kind == "deadline_missed" and name is not None:
            self._job(name)["deadline_missed"] = True
        elif kind in ("job_done", "job_failed", "job_cancelled",
                      "job_rejected"):
            self._job(name)["state"] = kind[len("job_"):]
        elif kind == "alert":
            rec = {k: e.get(k) for k in
                   ("rule", "severity", "state", "job", "signal",
                    "value", "threshold", "t")}
            self._alerts[(rec["rule"], rec.get("job"))] = rec
            self._recent_alerts.append(rec)
        elif kind == "autoscale_decision":
            a = self._autoscale
            a["decisions"] += 1
            verdict = e.get("verdict")
            if verdict == "filed":
                a["filed"] += 1
            elif verdict == "rejected":
                a["rejected"] += 1
            rec = {k: e.get(k) for k in
                   ("job", "action", "verdict", "reason", "dims",
                    "new_dims", "streak", "t")}
            be = (e.get("pricing") or {}).get("break_even")
            if be:
                rec["break_even_steps"] = be.get("break_even_steps")
                rec["net_gain_s"] = be.get("net_gain_s")
            a["last"] = rec
            self._autoscale_recent.append(rec)
        elif kind == "job_resized" and name is not None:
            self._autoscale["resizes"] += 1
            job = self._job(name)
            job["resizes"] = job.get("resizes", 0) + 1
            if e.get("new_dims") is not None:
                job["dims"] = e["new_dims"]
        elif kind == "job_retuned" and name is not None:
            self._autoscale["retunes"] += 1
            self._job(name)["retunes"] = \
                self._job(name).get("retunes", 0) + 1

    # -- barrier spreads (multi-process runs) ------------------------------

    def _observe_barrier(self, rid, e: dict) -> None:
        mesh = self._mesh.setdefault(
            rid, {"procs": set(), "pending": {},
                  "spreads": deque(maxlen=self.straggler_window),
                  "last": None})
        proc = int(e.get("proc", 0))
        mesh["procs"].add(proc)
        if e.get("exec_s") is None or e.get("chunk") is None:
            return
        pend = mesh["pending"].setdefault(e["chunk"], {})
        pend[proc] = (float(e["t"]), float(e["exec_s"]))
        if len(mesh["procs"]) < 2 or len(pend) < len(mesh["procs"]):
            if len(mesh["pending"]) > 4 * self.straggler_window:
                for c in sorted(mesh["pending"])[:len(mesh["pending"])
                                                 // 2]:
                    del mesh["pending"][c]
            return
        del mesh["pending"][e["chunk"]]
        # the straggler_report arrival model, windowed: arrival =
        # corrected dispatch start + min exec_s across processes
        compute = min(x[1] for x in pend.values())
        arrivals = {p: (t - ex) + compute for p, (t, ex) in pend.items()}
        first = min(arrivals.values())
        slowest = max(arrivals, key=arrivals.get)
        mesh["spreads"].append(
            {"chunk": e["chunk"], "slowest": slowest,
             "spread_s": arrivals[slowest] - first})
        mesh["last"] = mesh["spreads"][-1]

    # -- the derived-signal snapshot ---------------------------------------

    def snapshot(self) -> dict:
        """The live-derived signal record (JSON-able): ``jobs`` (per-job
        rolling state), ``procs`` (persistent-straggler attribution,
        multi-process runs only), ``queue``, ``scheduler``, ``alerts``
        (active + recent transitions as tailed from the journal), plus
        the tail's integrity observations and alignment metadata. This
        is exactly the record `AlertRule` signals resolve against (and the
        serve tier's ``GET /v1/observe`` body)."""
        jobs = {}
        for name, r in self._jobs.items():
            if name is None:
                continue
            hist = list(r["_steps"])
            rates = self._rates(r)
            jobs[str(name)] = {
                k: v for k, v in r.items() if not k.startswith("_")
            } | {
                "step_s_p50": _quantile(hist, 0.5),
                "step_s_p90": _quantile(hist, 0.9),
                "checkpoint_s_p50": _quantile(list(r["_ckpt"]), 0.5),
                **rates,
            }
        procs: dict = {}
        for rid, mesh in self._mesh.items():
            win = list(mesh["spreads"])
            if len(mesh["procs"]) < 2 or not win:
                continue
            counts: dict = {}
            for rec in win:
                counts[rec["slowest"]] = counts.get(rec["slowest"], 0) + 1
            for p in sorted(mesh["procs"]):
                share = counts.get(p, 0) / len(win)
                rec = procs.setdefault(
                    int(p), {"slowest_share": 0.0, "runs": []})
                rec["slowest_share"] = max(rec["slowest_share"], share)
                rec["runs"].append(str(rid))
            procs["spread_s_last"] = mesh["last"]["spread_s"] \
                if mesh["last"] else None
        active = [rec for rec in self._alerts.values()
                  if rec.get("state") == "firing"]
        return {
            "t": time.time(),
            "cursor": self.cursor,
            # tail freshness: the aligned stamps are wall clock, so the
            # age of the newest merged event distinguishes "quiet mesh"
            # (small, creeping) from "stalled tail" (growing unbounded)
            # — the local twin of /v1/events heartbeats' last_seq
            "tail": {
                "events_read": self.tail.events_read,
                "last_event_t": self._last_event_t,
                "lag_s": (max(0.0, time.time() - self._last_event_t)
                          if self._last_event_t is not None else None),
            },
            "jobs": jobs,
            "procs": procs,
            "queue": dict(self._queue),
            "scheduler": dict(self._sched),
            "alerts": {"active": active,
                       "recent": list(self._recent_alerts)},
            "autoscale": dict(self._autoscale,
                              recent=list(self._autoscale_recent)),
            "gaps": list(self.gaps),
            "align": {str(k): v for k, v in self.align.items()},
        }

    @staticmethod
    def _rates(r: dict) -> dict:
        marks = list(r["_bytes"])
        if len(marks) < 2 or marks[-1][0] <= marks[0][0]:
            return {"wire_bytes_rate": None, "snapshot_bytes_rate": None}
        dt = marks[-1][0] - marks[0][0]
        return {"wire_bytes_rate": (marks[-1][1] - marks[0][1]) / dt,
                "snapshot_bytes_rate": (marks[-1][2] - marks[0][2]) / dt}

    # -- the merged live feed ----------------------------------------------

    def events_since(self, since: int | None = None) -> tuple:
        """``(events, cursor)``: buffered merged events with
        ``live_seq > since`` (all buffered when ``since`` is None) and
        the cursor to pass next time. The buffer is bounded — when
        ``events[0]["live_seq"] > since + 1`` the consumer fell behind
        and lost the difference."""
        if since is None:
            evs = list(self._buffer)
        else:
            since = int(since)
            evs = [e for e in self._buffer if e["live_seq"] > since]
        cursor = evs[-1]["live_seq"] if evs else \
            (self.cursor if since is None else since)
        return evs, cursor


# --------------------------------------------------------------------------
# The alert engine
# --------------------------------------------------------------------------

_KINDS = ("threshold", "rate", "burn_rate", "zscore")
_OPS = {
    ">": lambda a, b: a > b, ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b, "<=": lambda a, b: a <= b,
    "==": lambda a, b: a == b, "!=": lambda a, b: a != b,
}


@dataclasses.dataclass(frozen=True)
class AlertRule:
    """One declarative rule (see the module docstring).

    ``signal``: a dotted path into the live snapshot with at most one
    ``*`` wildcard segment fanning the rule out per key (``jobs.*
    .guard_trips`` runs one state machine per job), or
    ``metric:<family>`` reading the process metrics registry (sum over
    the family's samples). A key whose signal is absent this evaluation
    is SKIPPED — its state machine neither breaches nor clears.

    ``kind``:

    - ``threshold`` — fire when ``value <op> threshold``.
    - ``rate`` — over a cumulative counter: fire when it grew by at
      least ``threshold`` within the last ``window`` evaluations.
    - ``burn_rate`` — over a slack-like gauge: fire when the value is
      exhausted (``<= 0``) or decreasing fast enough to exhaust within
      ``horizon_s`` at the observed burn rate.
    - ``zscore`` — fire when the value's robust z against its own
      rolling window (`telemetry.robust_z` — `PerfWatch`'s estimator)
      exceeds ``threshold``, after ``min_samples`` samples.

    ``for_count`` consecutive breaching evaluations fire (hysteresis);
    ``resolve_count`` consecutive clear evaluations resolve."""

    name: str
    signal: str
    kind: str = "threshold"
    op: str = ">"
    threshold: float = 0.0
    window: int = 8
    horizon_s: float = 60.0
    min_samples: int = 4
    for_count: int = 1
    resolve_count: int = 2
    severity: str = "warning"

    def __post_init__(self):
        if not self.name or not self.signal:
            raise InvalidArgumentError(
                "AlertRule needs a name and a signal path.")
        if self.kind not in _KINDS:
            raise InvalidArgumentError(
                f"AlertRule {self.name!r}: kind must be one of {_KINDS}; "
                f"got {self.kind!r}.")
        if self.op not in _OPS:
            raise InvalidArgumentError(
                f"AlertRule {self.name!r}: op must be one of "
                f"{sorted(_OPS)}; got {self.op!r}.")
        if int(self.window) < 1 or int(self.for_count) < 1 \
                or int(self.resolve_count) < 1:
            raise InvalidArgumentError(
                f"AlertRule {self.name!r}: window, for_count and "
                "resolve_count must be >= 1.")
        if self.signal.count("*") > 1:
            raise InvalidArgumentError(
                f"AlertRule {self.name!r}: at most one '*' wildcard "
                f"segment; got {self.signal!r}.")


def default_rule_pack() -> list:
    """The six house rules (docs/observability.md has the table)."""
    return [
        AlertRule("deadline_slack_burn", "jobs.*.deadline_slack_s",
                  kind="burn_rate", horizon_s=60.0, severity="critical"),
        AlertRule("guard_trip_storm", "jobs.*.guard_trips",
                  kind="rate", threshold=1.0, window=8,
                  severity="critical"),
        AlertRule("persistent_straggler", "procs.*.slowest_share",
                  kind="threshold", op=">", threshold=0.6, for_count=2,
                  severity="warning"),
        AlertRule("perf_regression_streak", "jobs.*.perf_regressions",
                  kind="rate", threshold=3.0, window=8,
                  severity="warning"),
        AlertRule("io_queue_saturation", "jobs.*.snapshot_drops",
                  kind="rate", threshold=1.0, window=8,
                  severity="warning"),
        AlertRule("checkpoint_latency_blowout", "jobs.*.checkpoint_s",
                  kind="zscore", threshold=4.0, min_samples=4,
                  severity="warning"),
    ]


def log_sink(transition: dict) -> None:
    """The trivial sink: one WARNING/INFO log line per transition."""
    level = logging.WARNING if transition["state"] == "firing" \
        else logging.INFO
    _log.log(level, "alert %s %s (job=%s signal=%s value=%s)",
             transition["rule"], transition["state"],
             transition.get("job"), transition.get("signal"),
             transition.get("value"))


class ControlFileSink:
    """Turn a FIRING alert into an EXISTING control-file request
    (`service.QueueBackend.control`): ``action`` ``cancel`` (default;
    needs the transition's job attribution), ``resize`` (with
    ``payload`` — the resize control JSON), or ``drain``. ``rules``
    restricts which rules may act (None = all). Each (rule, job,
    action) fires the control file at most ONCE per sink lifetime —
    re-fires after a resolve do not re-file. The scheduler consumes the
    file at its next slice boundary, exactly as if an operator had run
    ``tools jobs cancel``."""

    def __init__(self, backend, *, action: str = "cancel", rules=None,
                 payload: dict | None = None):
        if action not in ("cancel", "resize", "drain"):
            raise InvalidArgumentError(
                f"ControlFileSink action must be cancel|resize|drain; "
                f"got {action!r}.")
        if action == "resize" and not isinstance(payload, dict):
            raise InvalidArgumentError(
                "ControlFileSink(action='resize') needs a payload dict "
                "({'new_dims': [...], 'via': ...}).")
        self.backend = backend
        self.action = action
        self.rules = None if rules is None else {str(r) for r in rules}
        self.payload = payload
        self.filed: list = []
        self._seen: set = set()

    def __call__(self, transition: dict) -> None:
        if transition.get("state") != "firing":
            return
        if self.rules is not None \
                and transition.get("rule") not in self.rules:
            return
        job = transition.get("job")
        if self.action != "drain" and job is None:
            return  # an unattributed alert cannot target a job
        key = (transition.get("rule"), job, self.action)
        if key in self._seen:
            return
        self._seen.add(key)
        # the alert's own span (stamped by the engine's tracer) rides in
        # the control payload as its traceparent: the scheduler parents
        # the consumed control event on the alert that decided it
        trace = None
        if transition.get("trace_id") and transition.get("span_id"):
            trace = {"traceparent": f"00-{transition['trace_id']}-"
                                    f"{transition['span_id']}-01"}
        if self.action == "drain":
            self.backend.control("drain")
        elif self.action == "resize":
            payload = dict(self.payload)
            if trace:
                payload.update(trace)
            self.backend.control("resize", str(job), payload)
        else:
            self.backend.control("cancel", str(job), trace)
        self.filed.append({"rule": transition.get("rule"), "job": job,
                           "action": self.action})


class WebhookSink:
    """POST every transition as JSON to ``url`` (stdlib urllib only).
    Delivery errors are swallowed and counted (``.errors`` /
    ``.last_error``) — an unreachable webhook must never stall the
    scheduling loop. ``timeout_s`` bounds each attempt."""

    def __init__(self, url: str, *, timeout_s: float = 2.0):
        self.url = str(url)
        self.timeout_s = float(timeout_s)
        self.delivered = 0
        self.errors = 0
        self.last_error = None

    def __call__(self, transition: dict) -> None:
        import urllib.request

        req = urllib.request.Request(
            self.url, data=json.dumps(transition, default=str).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s):
                pass
            self.delivered += 1
        except Exception as e:
            self.errors += 1
            self.last_error = f"{type(e).__name__}: {e}"


class AlertEngine:
    """Evaluate a rule set against successive signal snapshots (see the
    module docstring). ``journal`` is a ``callable(kind, **fields)``
    receiving every transition as an ``alert`` event — the scheduler
    passes its journal's writer so alerts land in ``scheduler.jsonl``
    with single-writer seq integrity; ``registry`` backs
    ``metric:<family>`` signals (default: the process registry).

    `evaluate(snapshot)` returns the transitions it caused (empty most
    boundaries); `active()` lists currently firing (rule, key) states.
    A sink raising is caught, counted (``sink_errors``), and journaled
    once per sink — a broken sink must never take the scheduler down."""

    def __init__(self, rules=None, *, sinks=(), journal=None,
                 registry=None):
        rules = default_rule_pack() if rules is None else list(rules)
        for r in rules:
            if not isinstance(r, AlertRule):
                raise InvalidArgumentError(
                    f"AlertEngine rules must be AlertRule instances; got "
                    f"{type(r).__name__}.")
        names = [r.name for r in rules]
        if len(set(names)) != len(names):
            raise InvalidArgumentError(
                f"AlertEngine: duplicate rule names in {names}.")
        self.rules = rules
        self.sinks = list(sinks)
        self.journal = journal
        self.registry = registry
        # optional distributed-trace hook: callable(transition) -> trace
        # field dict, applied BEFORE journal + sinks so the alert's span
        # is known to both (the scheduler wires its per-job contexts
        # here; a ControlFileSink then files the alert's span as the
        # cancel's parent — "why was my job cancelled" is a trace walk)
        self.tracer = None
        self._state: dict = {}
        self.transitions = 0
        self.evaluations = 0
        self.sink_errors = 0
        self._sink_error_logged: set = set()

    # -- signal resolution -------------------------------------------------

    def _resolve(self, signal: str, snapshot: dict) -> dict:
        """``{key: float value}`` instances of one signal path; key is
        None for scalar signals, the wildcard match (job name, proc)
        for fanned-out ones. Missing/None values are skipped."""
        if signal.startswith("metric:"):
            reg = self.registry
            if reg is None:
                from .registry import metrics_registry

                reg = metrics_registry()
            fam = reg.get(signal[len("metric:"):])
            if fam is None:
                return {}
            total = sum(v for _, v in fam.samples())
            return {None: float(total)}
        node = snapshot
        parts = signal.split(".")
        for i, part in enumerate(parts):
            if part == "*":
                rest = ".".join(parts[i + 1:])
                out = {}
                if isinstance(node, dict):
                    for key, sub in node.items():
                        for k2, v in self._resolve(rest,
                                                   sub or {}).items():
                            out[str(key) if k2 is None
                                else f"{key}.{k2}"] = v
                return out
            if not isinstance(node, dict) or part not in node:
                return {}
            node = node[part]
        if node is None:
            return {}
        try:
            return {None: float(node)}
        except (TypeError, ValueError):
            return {}

    # -- evaluation --------------------------------------------------------

    def evaluate(self, snapshot: dict) -> list:
        """One chunk-boundary evaluation pass. Returns the transitions
        (journaled, counted, and delivered to sinks as a side effect)."""
        self.evaluations += 1
        t = snapshot.get("t") or time.time()
        out = []
        for rule in self.rules:
            for key, value in self._resolve(rule.signal,
                                            snapshot).items():
                tr = self._eval_one(rule, key, value, t)
                if tr is not None:
                    out.append(tr)
                    self._deliver(tr)
        return out

    def _eval_one(self, rule: AlertRule, key, value: float, t: float):
        st = self._state.get((rule.name, key))
        if st is None:
            st = self._state[(rule.name, key)] = {
                "state": "ok", "breach": 0, "clear": 0, "since": None,
                "value": None,
                "hist": deque(maxlen=max(int(rule.window) + 1,
                                         int(rule.min_samples) + 1)),
            }
        hist = st["hist"]
        if rule.kind == "threshold":
            breach = _OPS[rule.op](value, rule.threshold)
        elif rule.kind == "rate":
            base = hist[0][1] if hist else 0.0
            breach = (value - base) >= rule.threshold
            hist.append((t, value))
        elif rule.kind == "burn_rate":
            breach = value <= 0
            if not breach and hist:
                t0, v0 = hist[0]
                if t > t0 and value < v0:
                    burn = (v0 - value) / (t - t0)
                    breach = value / burn < rule.horizon_s
            hist.append((t, value))
        else:  # zscore
            z, _, _ = robust_z(value, (v for _, v in hist),
                               min_samples=rule.min_samples)
            breach = z is not None and z > rule.threshold
            hist.append((t, value))
        st["value"] = value
        if breach:
            st["breach"] += 1
            st["clear"] = 0
        else:
            st["clear"] += 1
            st["breach"] = 0
        if st["state"] == "ok" and breach \
                and st["breach"] >= rule.for_count:
            st["state"], st["since"] = "firing", t
            return self._transition(rule, key, value, t, "firing")
        if st["state"] == "firing" and not breach \
                and st["clear"] >= rule.resolve_count:
            st["state"] = "ok"
            return self._transition(rule, key, value, t, "resolved")
        return None

    def _transition(self, rule: AlertRule, key, value, t, state) -> dict:
        self.transitions += 1
        job = None
        if key is not None:
            job = str(key).split(".", 1)[0]
        return {"rule": rule.name, "severity": rule.severity,
                "state": state, "job": job, "key": key,
                "signal": rule.signal, "value": value,
                "threshold": rule.threshold, "t": t}

    def _deliver(self, tr: dict) -> None:
        if self.tracer is not None:
            try:
                tf = self.tracer(tr)
            except Exception:
                tf = None  # tracing must never block alert delivery
            if tf:
                tr.update(tf)
        note_alert(tr["rule"], tr["severity"], tr["state"])
        if self.journal is not None:
            self.journal("alert", **{k: v for k, v in tr.items()
                                     if k != "t"})
        for sink in self.sinks:
            try:
                sink(tr)
            except Exception as e:
                self.sink_errors += 1
                sid = id(sink)
                if sid not in self._sink_error_logged:
                    self._sink_error_logged.add(sid)
                    _log.warning("alert sink %r failed: %s", sink, e)
                    if self.journal is not None:
                        self.journal("alert_sink_error",
                                     sink=type(sink).__name__,
                                     error=f"{type(e).__name__}: {e}")

    def active(self) -> list:
        """Currently FIRING states, most recent first."""
        out = [{"rule": r, "job": None if k is None
                else str(k).split(".", 1)[0], "key": k,
                "since": st["since"], "value": st["value"]}
               for (r, k), st in self._state.items()
               if st["state"] == "firing"]
        out.sort(key=lambda rec: -(rec["since"] or 0.0))
        return out
