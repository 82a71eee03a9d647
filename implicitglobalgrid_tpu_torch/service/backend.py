"""Pluggable queue backends: where job submissions and control
requests live OUTSIDE the scheduler process.

Counterpart of `implicitglobalgrid_tpu/service/backend.py`, in its record
format: each package's scheduler consumes a queue directory the other
wrote. `MeshScheduler.submit` is an in-process call; everything else — the
JAX package's `tools jobs` CLI and `serve.JobApiServer` HTTP front door, a
second scheduler (of either package) sharing the load — talks to the
scheduler through a `QueueBackend`. The backend owns two channels under one root:

``queue/``
    One JSON record per pending job (the `tools jobs submit` queue-JSON
    job schema — see `service.job.jobspec_from_json`). Producers write
    with the atomic ``.tmp`` + ``os.replace`` idiom; consumers CLAIM a
    record with a single atomic ``os.rename`` to an owner-stamped name,
    so N schedulers over one backend partition jobs with zero
    double-admissions: exactly one rename wins, every loser gets
    ``FileNotFoundError`` and moves on.

``control/``
    The control-file protocol: ``drain`` (empty file),
    ``cancel_<name>`` (empty file; may carry an optional JSON payload —
    requester trace context), ``resize_<name>`` (JSON payload
    ``{"new_dims": [...], "via": ...}``). ``.tmp`` staging files are
    skipped; consuming a request removes the file.

`DirectoryBackend` is the reference implementation and exactly the
behavior `MeshScheduler._poll_control` shipped with — the scheduler now
routes through it, so the CLI, the HTTP API, and any future backend
(a real message queue) can never diverge from each other.
"""

from __future__ import annotations

import itertools
import json
import os

from ..utils.exceptions import InvalidArgumentError

__all__ = ["QueueBackend", "DirectoryBackend"]

_owner_seq = itertools.count()


class QueueBackend:
    """Interface between job producers (CLI, HTTP API) and job
    consumers (schedulers). All methods are synchronous and must be
    safe to call from multiple processes against the same backing
    store; `claim` must be ATOMIC (at most one caller wins each
    record)."""

    # -- producer side -----------------------------------------------------

    def submit(self, record: dict) -> str:
        """Enqueue one job record (queue-JSON job schema). Returns the
        job name. Raises `InvalidArgumentError` on a malformed record or
        a duplicate pending name."""
        raise NotImplementedError

    def control(self, request: str, job: str | None = None,
                payload: dict | None = None) -> None:
        """File one control request: ``drain`` | ``cancel`` (needs
        ``job``; ``payload`` optional — e.g. the requester's trace
        context) | ``resize`` (needs ``job`` + ``payload``)."""
        raise NotImplementedError

    # -- consumer side -----------------------------------------------------

    def pending(self) -> list:
        """Names of unclaimed records, in claim order."""
        raise NotImplementedError

    def pending_count(self) -> int:
        """Number of unclaimed records — the queue-pressure gauge
        (``igg_queue_pending``). Backends override when they can count
        cheaper than listing; the default is ``len(self.pending())``."""
        return len(self.pending())

    def oldest_age_s(self) -> float | None:
        """Age in seconds of the OLDEST unclaimed record (None when the
        queue is empty or the backend cannot tell) — the starvation
        signal (``igg_queue_oldest_age_seconds``) next to the count.
        Purely observational: never claims, never mutates."""
        return None

    def claim(self) -> dict | None:
        """Atomically claim the next pending record. Returns ``None``
        when the queue is empty, else ``{"name", "record", "error"}``
        — ``record`` is the parsed JSON (None when unreadable, with
        ``error`` set). A claimed record is this consumer's alone."""
        raise NotImplementedError

    def discard(self, name: str) -> bool:
        """Atomically remove a still-PENDING record (a cancel that
        beat every scheduler to it). True when this caller won the
        removal; False when the record was already claimed or gone."""
        raise NotImplementedError

    def poll_control(self) -> list:
        """Consume every complete control request, in filing order.
        Returns dicts: ``{"request": "drain"}``,
        ``{"request": "cancel", "job": name, "payload": dict|None}``,
        ``{"request": "resize", "job": name, "payload": dict|None}``
        (payload None = unreadable file — the scheduler journals the
        rejection; never drop an operator request silently)."""
        raise NotImplementedError


class DirectoryBackend(QueueBackend):
    """Filesystem queue under ``root`` (``queue/`` + ``control/``
    subdirectories — `MeshScheduler` points it at its ``flight_dir`` so
    the journal, the queue, and the control channel share one
    directory). ``owner`` stamps claimed records
    (``<name>.json.claimed-<owner>``) for the journal/report to
    attribute; it defaults to a per-process unique tag."""

    def __init__(self, root, *, owner: str | None = None):
        self.root = str(root)
        self.owner = (str(owner) if owner is not None
                      else f"pid{os.getpid()}-{next(_owner_seq)}")
        if "/" in self.owner:
            raise InvalidArgumentError(
                f"DirectoryBackend.owner must be slash-free (it lands "
                f"in filenames); got {self.owner!r}.")
        self.queue_dir = os.path.join(self.root, "queue")
        self.control_dir = os.path.join(self.root, "control")
        os.makedirs(self.queue_dir, exist_ok=True)
        os.makedirs(self.control_dir, exist_ok=True)

    # -- producer side -----------------------------------------------------

    def submit(self, record: dict) -> str:
        if not isinstance(record, dict) or not record.get("name"):
            raise InvalidArgumentError(
                "QueueBackend.submit takes one queue-JSON job record "
                "(a dict with at least a 'name').")
        name = str(record["name"])
        if "/" in name or name.startswith("."):
            raise InvalidArgumentError(
                f"job name must be a slash-free, non-dot-leading string "
                f"(it names queue files); got {name!r}.")
        final = os.path.join(self.queue_dir, name + ".json")
        taken = [f for f in os.listdir(self.queue_dir)
                 if f == name + ".json"
                 or f.startswith(name + ".json.claimed-")]
        if taken:
            raise InvalidArgumentError(
                f"A job named {name!r} is already enqueued "
                f"({taken[0]}) — names key queue records.")
        tmp = final + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(record, f)
        os.replace(tmp, final)
        return name

    def control(self, request: str, job: str | None = None,
                payload: dict | None = None) -> None:
        if request == "drain":
            path = os.path.join(self.control_dir, "drain")
            with open(path, "w", encoding="utf-8"):
                pass
            return
        if job is None or "/" in str(job):
            raise InvalidArgumentError(
                f"control({request!r}) needs a slash-free job name; "
                f"got {job!r}.")
        if request == "cancel":
            # the protocol's empty file stays valid; an optional
            # JSON payload (e.g. the requesting span's traceparent, or
            # the alert that decided the cancel) rides in the body and
            # old consumers that ignore content are unaffected
            path = os.path.join(self.control_dir, f"cancel_{job}")
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                if payload is not None:
                    json.dump(payload, f)
            os.replace(tmp, path)
        elif request == "resize":
            if not isinstance(payload, dict):
                raise InvalidArgumentError(
                    "control('resize') needs a JSON payload dict "
                    "({'new_dims': [...], 'via': ...}).")
            path = os.path.join(self.control_dir, f"resize_{job}")
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(payload, f)
            os.replace(tmp, path)
        else:
            raise InvalidArgumentError(
                f"Unknown control request {request!r} "
                "(drain | cancel | resize).")

    # -- consumer side -----------------------------------------------------

    def pending(self) -> list:
        try:
            names = sorted(os.listdir(self.queue_dir))
        except FileNotFoundError:
            return []
        return [f[:-len(".json")] for f in names
                if f.endswith(".json") and not f.startswith(".")]

    def pending_count(self) -> int:
        # one listdir, no stat calls — cheap enough to stamp per
        # scheduling decision
        try:
            names = os.listdir(self.queue_dir)
        except FileNotFoundError:
            return 0
        return sum(1 for f in names
                   if f.endswith(".json") and not f.startswith("."))

    def oldest_age_s(self) -> float | None:
        import time

        oldest = None
        for name in self.pending():
            path = os.path.join(self.queue_dir, name + ".json")
            try:
                m = os.stat(path).st_mtime
            except FileNotFoundError:
                continue  # claimed between the listing and the stat
            oldest = m if oldest is None else min(oldest, m)
        return None if oldest is None else max(0.0, time.time() - oldest)

    def claim(self) -> dict | None:
        for name in self.pending():
            path = os.path.join(self.queue_dir, name + ".json")
            claimed = path + ".claimed-" + self.owner
            try:
                os.rename(path, claimed)
            except FileNotFoundError:
                continue  # another consumer won this record — move on
            try:
                with open(claimed, encoding="utf-8") as f:
                    record = json.load(f)
                error = None
            except Exception as e:
                record, error = None, f"{type(e).__name__}: {e}"
            return {"name": name, "record": record, "error": error,
                    "path": claimed}
        return None

    def discard(self, name: str) -> bool:
        path = os.path.join(self.queue_dir, str(name) + ".json")
        try:
            os.rename(path, path + ".cancelled")
        except FileNotFoundError:
            return False
        os.remove(path + ".cancelled")
        return True

    def poll_control(self) -> list:
        out = []
        if not os.path.isdir(self.control_dir):
            return out
        for fname in sorted(os.listdir(self.control_dir)):
            path = os.path.join(self.control_dir, fname)
            if fname.endswith(".tmp"):
                continue  # a request still being written (CLI staging)
            if fname == "drain":
                os.remove(path)
                out.append({"request": "drain"})
            elif fname.startswith("cancel_"):
                try:
                    with open(path, encoding="utf-8") as f:
                        raw = f.read().strip()
                    req = json.loads(raw) if raw else None
                except Exception:
                    req = None  # empty/foreign body = legacy cancel
                os.remove(path)
                rec = {"request": "cancel",
                       "job": fname[len("cancel_"):]}
                if isinstance(req, dict):
                    # only a filed JSON body surfaces — a legacy empty
                    # cancel keeps its exact wire shape
                    rec["payload"] = req
                out.append(rec)
            elif fname.startswith("resize_"):
                try:
                    with open(path, encoding="utf-8") as f:
                        req = json.load(f)
                except Exception:
                    req = None
                os.remove(path)
                out.append({"request": "resize",
                            "job": fname[len("resize_"):],
                            "payload": req})
        return out
