"""Scheduling policies: who gets the next chunk-granular slice.

Counterpart of `implicitglobalgrid_tpu/service/policies.py`, whole: the same
picks from the same job table, so both packages' schedulers journal the same
slice sequence.

One tiny interface — ``pick(candidates)`` chooses the job the mesh serves
next — behind which three shipped disciplines live:

- ``fifo``: strict submission order; a job runs to completion before the
  next starts (the batch queue — zero context switches, zero overhead,
  no fairness).
- ``round_robin``: cycle through runnable jobs, one slice each (equal
  slice COUNTS; ignores priorities and slice durations).
- ``fair``: weighted max-min over mesh TIME — pick the job with the
  smallest ``granted_time / priority`` (stride scheduling over measured
  slice seconds, so a job with heavy chunks does not crowd out light
  ones, and ``priority=2`` earns 2x the mesh time of ``priority=1``).

Preemption is only ever at chunk boundaries (the scheduler grants one
`ResilientRun.advance()` per pick), so the policy choice affects latency
and fairness, never results: every job's trajectory is bit-identical
under every policy (asserted in tests/test_torch_service.py).
"""

from __future__ import annotations

from ..utils.exceptions import InvalidArgumentError
from .job import Job

__all__ = ["SchedulingPolicy", "FifoPolicy", "RoundRobinPolicy",
           "FairSharePolicy", "POLICIES", "resolve_policy"]


class SchedulingPolicy:
    """Pick the next job to slice. ``candidates`` is the non-empty list of
    runnable jobs (admitted or queued, not finished), in submission
    order. Implementations must be deterministic — the schedule is part
    of the service's reproducibility story."""

    name = "base"

    def pick(self, candidates: list) -> Job:
        raise NotImplementedError

    def granted(self, job: Job, slice_s: float) -> None:
        """Feedback after a slice (default: ignored)."""


class FifoPolicy(SchedulingPolicy):
    """Strict submission order: the oldest unfinished job owns the mesh
    until it finishes."""

    name = "fifo"

    def pick(self, candidates: list) -> Job:
        return min(candidates, key=lambda j: j.index)


class RoundRobinPolicy(SchedulingPolicy):
    """Cycle through runnable jobs, one slice each."""

    name = "round_robin"

    def __init__(self):
        self._last = -1

    def pick(self, candidates: list) -> Job:
        after = [j for j in candidates if j.index > self._last]
        job = min(after or candidates, key=lambda j: j.index)
        self._last = job.index
        return job


class FairSharePolicy(SchedulingPolicy):
    """Weighted fair share of mesh TIME: pick the minimal
    ``granted_s / priority`` (ties: submission order). New jobs start at
    the current minimum share rather than zero, so a late submission
    catches up without starving everyone else of the mesh for its whole
    backlog.

    Deadline softening: before the alert engine's HARD
    ``deadline_missed``/cancel path ever fires, a job whose live
    ``deadline_slack_s`` has dropped below ``low_slack_s`` gets its
    effective share divided by up to ``1 + slack_boost`` — a stride
    boost that GROWS as slack sinks through ``slack_horizon_s``, so the
    scheduler spends mesh time where the deadline pressure is, smoothly
    and reversibly. The boost reads the driver's live gauge only at
    pick time; ``granted`` accounting is untouched, so a job whose
    slack recovers pays its fair share back. Jobs without a deadline
    (slack None) never boost — the policy is byte-identical to plain
    fair share for them."""

    name = "fair"

    def __init__(self, *, low_slack_s: float = 0.0,
                 slack_boost: float = 4.0,
                 slack_horizon_s: float = 30.0):
        if slack_boost < 0:
            raise InvalidArgumentError(
                f"FairSharePolicy: slack_boost must be >= 0; got "
                f"{slack_boost!r}.")
        if not slack_horizon_s > 0:
            raise InvalidArgumentError(
                f"FairSharePolicy: slack_horizon_s must be > 0; got "
                f"{slack_horizon_s!r}.")
        self.low_slack_s = float(low_slack_s)
        self.slack_boost = float(slack_boost)
        self.slack_horizon_s = float(slack_horizon_s)
        self._share: dict = {}  # job index -> granted_s / weight

    def _boost(self, job: Job) -> float:
        """> 1 when the job's live deadline slack is below
        ``low_slack_s``, saturating at ``1 + slack_boost`` once the
        deficit spans ``slack_horizon_s``."""
        if self.slack_boost == 0 or job.run is None:
            return 1.0
        slack = getattr(job.run, "deadline_slack_s", None)
        if slack is None or slack >= self.low_slack_s:
            return 1.0
        deficit = min(1.0, (self.low_slack_s - float(slack))
                      / self.slack_horizon_s)
        return 1.0 + self.slack_boost * deficit

    def pick(self, candidates: list) -> Job:
        # the floor is the RUNNABLE minimum: a finished job's frozen
        # (small) share must not drag it down, or a late arrival seeded
        # from it would monopolize the mesh until it "caught up" with a
        # tenant that no longer exists
        known = [self._share[j.index] for j in candidates
                 if j.index in self._share]
        floor = min(known) if known else 0.0
        for j in candidates:
            if j.index not in self._share:
                self._share[j.index] = floor
        return min(candidates,
                   key=lambda j: (self._share[j.index] / self._boost(j),
                                  j.index))

    def granted(self, job: Job, slice_s: float) -> None:
        w = max(1, int(job.spec.priority))
        self._share[job.index] = self._share.get(job.index, 0.0) \
            + max(0.0, float(slice_s)) / w


POLICIES = {
    "fifo": FifoPolicy,
    "round_robin": RoundRobinPolicy,
    "fair": FairSharePolicy,
}


def resolve_policy(policy) -> SchedulingPolicy:
    """A policy instance from a name, class, or instance."""
    if isinstance(policy, SchedulingPolicy):
        return policy
    if isinstance(policy, type) and issubclass(policy, SchedulingPolicy):
        return policy()
    if isinstance(policy, str):
        if policy not in POLICIES:
            raise InvalidArgumentError(
                f"Unknown scheduling policy {policy!r}; available: "
                f"{sorted(POLICIES)}.")
        return POLICIES[policy]()
    raise InvalidArgumentError(
        f"policy must be a name, SchedulingPolicy class, or instance; "
        f"got {policy!r}.")
