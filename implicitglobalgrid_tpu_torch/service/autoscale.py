"""Closed-loop autoscaler: the mesh resizes itself.

Counterpart of `implicitglobalgrid_tpu/service/autoscale.py`: the same
policy, the same decisions (action, new dims, verdict) for the same signal
sequence and pool, over the port's `ResilientRun.resize` (a re-block by
copies between block views on the card, `reshard.reshard_state`). An
`Autoscaler` runs inside `MeshScheduler` at slice boundaries
(``MeshScheduler(autoscale=AutoscalePolicy(...))``), reads the scheduler's
live signal snapshot, and drives elastic resizes through the control path
with priced, journaled, explainable decisions:

1. **Signals.** Per-job deadline slack (the driver's live
   ``deadline_slack_s``), queue pressure (backend backlog + queued jobs),
   per-job perf regressions / guard trips, and mesh utilization ride in
   every decision record; the policy acts on slack and pressure.
2. **Candidates.** A starved job (slack below ``grow_slack_s``, under its
   `ScaleBounds` max) wants to GROW; when the mesh is contended (some
   tenant starved, or the queue backlog at/above ``shrink_queue_pending``)
   an unpressured job above its min wants to SHRINK. Candidate ``dims``
   double or halve one mesh axis, keeping the IMPLICIT GLOBAL GRID fixed:
   only even re-blockings within the rank pool and the job's bounds
   survive.
3. **Pricing.** Before acting, every candidate geometry is priced with
   `predict_step` on its OWN grid (initialized host-side on the job's
   device type, as `tune_config`'s first phase does: nothing allocates)
   and the winning move's transfer with `predict_reshard`; the shared
   `ReshardPrediction.amortized_break_even_steps` verdict gates it: a grow
   files only when the break-even lands inside the job's remaining ``nt``
   horizon, a shrink only when the job can afford the priced slowdown
   inside its deadline slack. On the card the move's plan must also fit
   the card's free memory (`reshard.check_device_memory`).
4. **Hysteresis + cooldown.** An action must be wanted for
   ``hysteresis_slices`` CONSECUTIVE boundaries before it is priced, and a
   job that just moved (or was just priced out) is frozen for
   ``cooldown_slices`` boundaries: a bounced signal cannot thrash the mesh
   (tests/test_torch_autoscale.py).
5. **Actuation.** The winning move files through the queue backend's
   control files (``control("resize", ...)``), the same journal chain an
   operator's resize request produces (``autoscale_decision`` ->
   ``control`` -> ``resize_requested`` -> ``job_resized``), so the
   autoscaler has no private path into the mesh.
6. **Re-tune + reprice.** After the resize applies, the scheduler re-runs
   `tune_config` (model-only) against the NEW geometry and applies the
   winner (`ResilientRun.apply_tuned`); the driver's perf-model unit price
   is re-priced (`ResilientRun.reprice`) so deadline slack tracks the new
   geometry.
7. **Explainability.** EVERY decision, rejections included, journals as an
   ``autoscale_decision`` record carrying the signal snapshot and the full
   pricing breakdown (a repeated identical rejection collapses to its
   first record; the ``igg_autoscale_*`` counters still count each).
   `service_report` folds them into an ``autoscale`` section and
   `explain_autoscale` reconstructs the WHY of each move from the journal
   alone.

The rank pool (the JAX package's `jax.device_count()` and
`reshard.plan.device_pool`): one resolver, `Autoscaler.pool`, the attached
scheduler's ``nranks``, feeds both the candidate bound and the mesh
utilization. None (no pool): the utilization is None and growth is bounded
by `ScaleBounds.max_devices` and the card's memory.

The steady-state cost is dict arithmetic: grid inits and pricing only run
once a streak matures past hysteresis.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field as dc_field

from ..telemetry import hooks
from ..utils.exceptions import (
    IncoherentArgumentError, InvalidArgumentError,
)

__all__ = ["ScaleBounds", "AutoscalePolicy", "Autoscaler"]


@dataclass(frozen=True)
class ScaleBounds:
    """Per-job rank-count bounds the policy must respect (a rank is a
    block of the virtual mesh; the JAX package's device).
    ``max_devices=None`` = the rank pool is the ceiling."""

    min_devices: int = 1
    max_devices: int | None = None

    def __post_init__(self):
        if int(self.min_devices) < 1:
            raise InvalidArgumentError(
                f"ScaleBounds.min_devices must be >= 1; got "
                f"{self.min_devices!r}.")
        if self.max_devices is not None \
                and int(self.max_devices) < int(self.min_devices):
            raise InvalidArgumentError(
                f"ScaleBounds: max_devices ({self.max_devices!r}) < "
                f"min_devices ({self.min_devices!r}).")

    def to_json(self) -> dict:
        return {"min_devices": int(self.min_devices),
                "max_devices": (None if self.max_devices is None
                                else int(self.max_devices))}


@dataclass(frozen=True)
class AutoscalePolicy:
    """The declarative knob set of the closed loop (module docstring).

    ``grow_slack_s``: a RUNNING job whose live deadline slack drops
    below this wants to grow (default 0.0 = only provable busts).
    ``shrink_queue_pending``: queue backlog (unclaimed + queued) at or
    above this marks the mesh contended even with no starved tenant.
    ``hysteresis_slices``: consecutive boundary votes an action needs
    before it is priced. ``cooldown_slices``: boundaries a job is
    frozen after a filed (or priced-out) move. ``max_moves_per_eval``:
    moves filed per boundary (the rest keep their streak and file on
    later boundaries). ``via``: the resize path handed to the driver
    (``auto`` | ``device`` | ``checkpoint``). ``retune``: re-run
    `tune_config` against the new geometry once a resize applies.
    ``bounds``: per-job-name `ScaleBounds` overrides over
    ``default_bounds``."""

    grow_slack_s: float = 0.0
    shrink_queue_pending: int = 1
    hysteresis_slices: int = 2
    cooldown_slices: int = 4
    max_moves_per_eval: int = 1
    via: str = "auto"
    retune: bool = True
    default_bounds: ScaleBounds = ScaleBounds()
    bounds: dict = dc_field(default_factory=dict)

    def __post_init__(self):
        if self.via not in ("auto", "device", "checkpoint"):
            raise InvalidArgumentError(
                f"AutoscalePolicy.via must be auto|device|checkpoint; "
                f"got {self.via!r}.")
        if int(self.hysteresis_slices) < 1:
            raise InvalidArgumentError(
                "AutoscalePolicy.hysteresis_slices must be >= 1 (1 = "
                f"act on the first vote); got {self.hysteresis_slices!r}.")
        if int(self.cooldown_slices) < 0:
            raise InvalidArgumentError(
                "AutoscalePolicy.cooldown_slices must be >= 0; got "
                f"{self.cooldown_slices!r}.")
        for name, b in dict(self.bounds).items():
            if not isinstance(b, ScaleBounds):
                raise InvalidArgumentError(
                    f"AutoscalePolicy.bounds[{name!r}] must be a "
                    f"ScaleBounds; got {type(b).__name__}.")

    def bounds_for(self, name: str) -> ScaleBounds:
        return self.bounds.get(name, self.default_bounds)

    def describe(self) -> dict:
        """JSON-able policy echo (``scheduler_start`` journal +
        ``/v1/observe``)."""
        return {"grow_slack_s": float(self.grow_slack_s),
                "shrink_queue_pending": int(self.shrink_queue_pending),
                "hysteresis_slices": int(self.hysteresis_slices),
                "cooldown_slices": int(self.cooldown_slices),
                "max_moves_per_eval": int(self.max_moves_per_eval),
                "via": self.via, "retune": bool(self.retune),
                "default_bounds": self.default_bounds.to_json(),
                "bounds": {k: v.to_json()
                           for k, v in self.bounds.items()}}


class Autoscaler:
    """The policy engine (module docstring). Constructed standalone
    (``Autoscaler(policy)``) and attached by the scheduler
    (``MeshScheduler(autoscale=...)`` calls `attach`), or fed synthetic
    signal snapshots directly through `evaluate` (how the thrash test
    proves hysteresis). ``evaluations`` / ``moves_filed`` /
    ``last_decision_s`` / ``decision_s_total`` are the bench
    accounting surface."""

    def __init__(self, policy: AutoscalePolicy | None = None, *,
                 scheduler=None):
        if policy is None:
            policy = AutoscalePolicy()
        elif isinstance(policy, dict):
            policy = AutoscalePolicy(**policy)
        if not isinstance(policy, AutoscalePolicy):
            raise InvalidArgumentError(
                f"Autoscaler takes an AutoscalePolicy (or its kwargs "
                f"dict); got {type(policy).__name__}.")
        self.policy = policy
        self.sched = None
        self._streak: dict = {}      # (job, action) -> consecutive votes
        self._cooldown: dict = {}    # job -> boundaries left frozen
        self._last_verdict: dict = {}  # (job, action) -> (verdict, reason)
        self.evaluations = 0
        self.moves_filed = 0
        self.last_decision_s = 0.0
        self.decision_s_total = 0.0
        # recent per-boundary costs (bench surface): the median is the
        # steady-state dict-arithmetic cost; the max shows the rare
        # boundary that actually priced a matured streak
        from collections import deque

        self.decision_s_recent: deque = deque(maxlen=256)
        if scheduler is not None:
            self.attach(scheduler)

    def attach(self, scheduler) -> None:
        """Bind to the scheduler whose jobs this policy moves (journal,
        job table, queue backend)."""
        self.sched = scheduler

    # -- the boundary evaluation -------------------------------------------

    def evaluate(self, signals: dict) -> list:
        """One policy pass over a live-signal snapshot
        (`MeshScheduler._live_signals` shape). Returns the decision
        records of this boundary (journaled as ``autoscale_decision``);
        files at most ``max_moves_per_eval`` resizes through the
        control path."""
        t0 = time.perf_counter()
        try:
            decisions = self._evaluate(signals)
        finally:
            dt = time.perf_counter() - t0
            self.last_decision_s = dt
            self.decision_s_total += dt
            self.decision_s_recent.append(dt)
            self.evaluations += 1
        return decisions

    def _evaluate(self, signals: dict) -> list:
        pol = self.policy
        jobs = signals.get("jobs", {}) or {}
        queue = signals.get("queue", {}) or {}
        for name in list(self._cooldown):
            self._cooldown[name] -= 1
            if self._cooldown[name] <= 0:
                del self._cooldown[name]
        running = {n: s for n, s in jobs.items()
                   if s.get("state") == "running"}
        starved = {
            n for n, s in running.items()
            if s.get("deadline_slack_s") is not None
            and float(s["deadline_slack_s"]) < float(pol.grow_slack_s)}
        pending = int(queue.get("pending") or 0) \
            + int(queue.get("queued") or 0)
        contended = bool(starved) \
            or pending >= int(pol.shrink_queue_pending)
        util = self._mesh_utilization(running)
        desired = {}
        for name, sig in running.items():
            devices = self._devices(name, sig)
            lo, hi = self._bounds(name, devices)
            if name in starved:
                if devices is None or hi is None or devices < hi:
                    desired[name] = "grow"
            elif contended and devices is not None and devices > lo:
                desired[name] = "shrink"
        # a vote that did not repeat resets its streak — the hysteresis
        # contract is CONSECUTIVE boundaries
        for key in list(self._streak):
            if desired.get(key[0]) != key[1]:
                del self._streak[key]
        ctx = {"queue": {"pending": queue.get("pending"),
                         "queued": queue.get("queued"),
                         "oldest_age_s": queue.get("oldest_age_s")},
               "starved": sorted(starved),
               "mesh_utilization": util}
        decisions = []
        moves = 0
        # grows first (highest priority first), then shrinks
        order = sorted(
            desired.items(),
            key=lambda kv: (kv[1] != "grow",
                            -int(running[kv[0]].get("priority") or 1)))
        for name, action in order:
            key = (name, action)
            self._streak[key] = streak = self._streak.get(key, 0) + 1
            base = dict(job=name, action=action, streak=streak,
                        signals=dict(running[name], **ctx))
            if streak < int(pol.hysteresis_slices):
                decisions.append(self._decide(
                    **base, verdict="rejected", reason="hysteresis"))
                continue
            if name in self._cooldown:
                decisions.append(self._decide(
                    **base, verdict="rejected", reason="cooldown",
                    cooldown_left=self._cooldown[name]))
                continue
            if moves >= int(pol.max_moves_per_eval):
                # keep the streak: the move files at a later boundary
                decisions.append(self._decide(
                    **base, verdict="rejected", reason="move_budget"))
                continue
            rec = self._plan_move(base)
            decisions.append(rec)
            if rec["verdict"] == "filed":
                moves += 1
                self.moves_filed += 1
                self._streak.pop(key, None)
            if rec.get("priced"):
                # pricing ran (grid swaps + cost model): freeze the job
                # whether or not the move filed, so a persistently
                # priced-out signal cannot re-price every boundary
                self._cooldown[name] = max(1, int(pol.cooldown_slices))
        return decisions

    # -- decision bookkeeping ----------------------------------------------

    def _decide(self, *, job: str, action: str, verdict: str,
                reason: str | None = None, **fields) -> dict:
        """Count + journal one decision. Rejections journal on every
        (verdict, reason) CHANGE per (job, action) — the counters count
        every one; the journal stays readable. Filed moves always
        journal."""
        rec = dict(job=job, action=action, verdict=verdict,
                   reason=reason, **fields)
        hooks.note_autoscale_decision(action, verdict, reason)
        key = (job, action)
        if verdict == "filed" \
                or self._last_verdict.get(key) != (verdict, reason):
            self._log("autoscale_decision", **rec)
        self._last_verdict[key] = (verdict, reason)
        return rec

    def _log(self, kind: str, **fields) -> None:
        if self.sched is not None:
            self.sched._log(kind, **fields)

    def _job(self, name: str):
        return None if self.sched is None else self.sched.jobs.get(name)

    def _devices(self, name: str, sig: dict):
        d = sig.get("devices")
        if d:
            return int(d)
        job = self._job(name)
        if job is not None and job.gg is not None:
            dims = job.gg.dims
            return int(dims[0]) * int(dims[1]) * int(dims[2])
        return None

    def _bounds(self, name: str, devices) -> tuple:
        b = self.policy.bounds_for(name)
        return int(b.min_devices), \
            (None if b.max_devices is None else int(b.max_devices))

    def pool(self) -> int | None:
        """The rank pool: the attached scheduler's ``nranks`` (None
        without one). The one resolver of the candidate bound and the
        mesh utilization."""
        return None if self.sched is None \
            else getattr(self.sched, "nranks", None)

    def _mesh_utilization(self, running: dict):
        """Sum of running jobs' targeted ranks over the pool (> 1 is
        normal — tenants share the pool; it rides in every record as
        context). None without a pool."""
        pool = self.pool()
        total = 0
        for name, sig in running.items():
            d = self._devices(name, sig)
            if d is None:
                return None
            total += d
        return None if pool is None else total / max(1, pool)

    # -- candidate generation + pricing -------------------------------------

    def _plan_move(self, base: dict) -> dict:
        """Generate candidate ``dims``, price them, verdict the best,
        file it. Only runs once hysteresis + cooldown pass."""
        name, action = base["job"], base["action"]
        job = self._job(name)
        if job is None or job.run is None or job.gg is None \
                or job.run.done:
            return self._decide(**base, verdict="rejected",
                                reason="no_live_job")
        if job.resize_requested is not None \
                or getattr(job, "_autoscale_filed", None):
            # a filed move is still in flight (applies at the job's next
            # granted slice) — re-filing would stack duplicate controls
            return self._decide(**base, verdict="rejected",
                                reason="resize_pending")
        from ..telemetry.tune import _MODEL_STAGGER

        model = job.spec.model
        if model not in _MODEL_STAGGER:
            return self._decide(**base, verdict="rejected",
                                reason="unpriceable",
                                detail=f"model {model!r} has no priced "
                                       "workload")
        cands = self._candidate_dims(job, action)
        cur_dims = tuple(int(d) for d in job.gg.dims)
        if not cands:
            return self._decide(**base, verdict="rejected",
                                reason="no_feasible_dims",
                                dims=list(cur_dims))
        try:
            pricing = self._price_move(job, cur_dims, cands)
        except Exception as e:
            return self._decide(**base, verdict="rejected",
                                reason="plan_error", priced=True,
                                dims=list(cur_dims),
                                error=f"{type(e).__name__}: {e}")
        be = pricing["break_even"]
        if action == "grow":
            ok = bool(be["within_horizon"])
            reason = None if ok else "priced_out"
        else:
            # a shrink is a priced slowdown: the job must afford it
            # inside its live slack (jobs without a deadline always can)
            slack = base["signals"].get("deadline_slack_s")
            ok = slack is None or float(slack) + be["net_gain_s"] >= 0.0
            reason = None if ok else "priced_out"
        if not ok:
            return self._decide(**base, verdict="rejected", reason=reason,
                                priced=True, dims=list(cur_dims),
                                new_dims=list(pricing["new_dims"]),
                                pricing=pricing)
        try:
            self._file(job, pricing["new_dims"], pricing["new_unit_s"])
        except Exception as e:
            return self._decide(**base, verdict="rejected",
                                reason="file_error", priced=True,
                                dims=list(cur_dims),
                                new_dims=list(pricing["new_dims"]),
                                error=f"{type(e).__name__}: {e}")
        return self._decide(**base, verdict="filed", priced=True,
                            dims=list(cur_dims),
                            new_dims=list(pricing["new_dims"]),
                            via=self.policy.via, pricing=pricing)

    def _candidate_dims(self, job, action: str) -> list:
        """Feasible one-axis doubles (grow) / halves (shrink) of the
        job's dims: even re-blocking of the SAME implicit global grid,
        inside the rank pool (`pool`) and the job's `ScaleBounds`."""
        from ..telemetry.tune import _grid_ok

        gg = job.gg
        dims = tuple(int(d) for d in gg.dims)
        n = tuple(int(v) for v in gg.nxyz)
        ol = tuple(int(o) for o in gg.overlaps)
        hw = tuple(int(h) for h in gg.halowidths)
        periods = tuple(int(p) for p in gg.periods)
        glob = tuple(dims[d] * (n[d] - ol[d]) + ol[d] for d in range(3))
        pool = self.pool()
        b = self.policy.bounds_for(job.name)
        lo = int(b.min_devices)
        hi = pool if b.max_devices is None else int(b.max_devices) \
            if pool is None else min(pool, int(b.max_devices))
        out = []
        for d in range(3):
            c = list(dims)
            if action == "grow":
                c[d] *= 2
            elif dims[d] % 2 == 0:
                c[d] //= 2
            else:
                continue
            ndev = c[0] * c[1] * c[2]
            if ndev < lo or (hi is not None and ndev > hi) \
                    or tuple(c) == dims:
                continue
            cand_n = []
            for e in range(3):
                span = glob[e] - ol[e]
                if span % c[e]:
                    cand_n = None
                    break
                cand_n.append(span // c[e] + ol[e])
            if cand_n is None:
                continue
            kw = dict(nx=cand_n[0], ny=cand_n[1], nz=cand_n[2],
                      dimx=c[0], dimy=c[1], dimz=c[2],
                      periodx=periods[0], periody=periods[1],
                      periodz=periods[2], overlaps=ol, halowidths=hw,
                      device_type=gg.device_type, quiet=True)
            if not _grid_ok(kw):
                continue
            out.append((tuple(c), kw))
        return out

    def _price_move(self, job, cur_dims: tuple, cands: list) -> dict:
        """Price the current geometry and every candidate with
        `predict_step` (each on its OWN host-side grid — the
        `tune_config` phase-1 idiom; model-vs-model so the gain ratio is
        honest), pick the fastest candidate, price its transfer with
        `predict_reshard`, and return the full breakdown including the
        shared break-even verdict. A plan that does not fit the card's
        free memory raises (`reshard.check_device_memory`)."""
        from ..models.common import resolve_comm_every
        from ..parallel import topology as top
        from ..parallel.grid import finalize_global_grid, init_global_grid
        from ..reshard.plan import (
            build_reshard_plan, check_device_memory, fields_of_state,
            live_topology,
        )
        from ..telemetry.perfmodel import (
            default_machine_profile, predict_reshard, predict_step,
        )
        from ..telemetry.tune import _model_fields

        model = job.spec.model
        run = job.run
        E = run.ensemble
        dtype = next(iter(run.state.values())).dtype
        tuned = run.tuned
        knobs = dict(comm_every=1, overlap=False, coalesce=None,
                     wire_dtype=None, wire_stage=None)
        if tuned is not None:
            knobs = dict(comm_every=tuned.comm_every,
                         overlap=bool(tuned.overlap),
                         coalesce=tuned.coalesce,
                         wire_dtype=tuned.wire_dtype,
                         wire_stage=tuned.wire_stage)
        # the boundary has NO current grid — resolve the profile from the
        # job's own grid instead of the (uninitialized) global one
        dt = getattr(job.gg, "device_type", None)
        profile = default_machine_profile(
            dt if dt and dt != "none" else "cpu")
        cadence = resolve_comm_every(knobs["comm_every"])
        spu = cadence.cycle if cadence.deep else 1
        src_topo = live_topology(job.gg)

        def price(kw) -> float:
            init_global_grid(**kw)
            try:
                cgg = top.global_grid()
                hw = tuple(int(h) for h in cgg.halowidths)
                fields = _model_fields(model, cgg, hw, dtype)
                pred = predict_step(model, fields, profile=profile,
                                    ensemble=E, **knobs)
            finally:
                finalize_global_grid()
            return float(pred["step_s"]) * spu

        n = tuple(int(v) for v in src_topo["nxyz"])
        cur_kw = dict(
            nx=n[0], ny=n[1], nz=n[2],
            dimx=cur_dims[0], dimy=cur_dims[1], dimz=cur_dims[2],
            periodx=int(src_topo["periods"][0]),
            periody=int(src_topo["periods"][1]),
            periodz=int(src_topo["periods"][2]),
            overlaps=tuple(int(o) for o in src_topo["overlaps"]),
            halowidths=tuple(int(h) for h in src_topo["halowidths"]),
            device_type=job.gg.device_type, quiet=True)
        prev = top.swap_global_grid(None)
        if prev is not None:
            top.retain_epoch(prev.epoch)
        try:
            old_unit_s = price(cur_kw)
            priced = []
            for dims_c, kw in cands:
                try:
                    priced.append((price(kw), dims_c))
                except (InvalidArgumentError,
                        IncoherentArgumentError):
                    continue
            if not priced:
                raise InvalidArgumentError(
                    "every candidate geometry refused pricing")
            priced.sort(key=lambda t: t[0])
            new_unit_s, new_dims = priced[0]
        finally:
            if prev is not None:
                top.swap_global_grid(prev)
                top.release_epoch(prev.epoch)
        # the port reads a state's member axes against its grid: build the
        # plan under the job's own grid (the boundary holds none)
        prev = top.swap_global_grid(job.gg)
        try:
            plan = build_reshard_plan(src_topo, new_dims,
                                      fields_of_state(run.state))
        finally:
            top.swap_global_grid(prev)
        # the card's memory bounds the move (the JAX package's device pool)
        check_device_memory(plan, job.gg.device)
        rp = predict_reshard(plan, profile=profile)
        nt_remaining = max(0, int(job.spec.nt) - int(job.step))
        be = rp.amortized_break_even_steps(nt_remaining, old_unit_s,
                                           new_unit_s)
        return {"new_dims": list(new_dims),
                "old_unit_s": old_unit_s, "new_unit_s": new_unit_s,
                "steps_per_unit": spu,
                "candidates": [{"dims": list(d), "unit_s": s}
                               for s, d in priced],
                "reshard": {k: rp[k] for k in
                            ("rounds", "wire_bytes", "seconds",
                             "profile_source")},
                "break_even": be}

    # -- actuation -----------------------------------------------------------

    def _file(self, job, new_dims, new_unit_s: float) -> None:
        """File the move through the EXISTING control path (the queue
        backend's control files — the same chain an operator's resize
        request produces), falling back to the scheduler's direct `resize`
        when no backend exists. Stashes the priced new-geometry unit cost on
        the job so the scheduler re-prices the driver once the resize
        actually APPLIES (`MeshScheduler._slice` ->
        `Autoscaler.on_resized`)."""
        dims = [int(d) for d in new_dims]
        job._autoscale_filed = (tuple(dims), float(new_unit_s))
        q = None if self.sched is None else self.sched.queue
        if q is not None:
            q.control("resize", job.name,
                      {"new_dims": dims, "via": self.policy.via})
        elif self.sched is not None:
            self.sched.resize(job.name, dims, via=self.policy.via)
        else:
            raise InvalidArgumentError(
                "Autoscaler is not attached to a scheduler — nothing "
                "can actuate the move.")

    def on_resized(self, job, new_dims) -> None:
        """Scheduler callback once a resize APPLIED: when it matches the
        move this policy filed, hand the priced new-geometry unit cost
        to the driver (`ResilientRun.reprice`) so deadline slack tracks
        the new geometry — the convergence half of the loop (the re-tune
        then refines the price further)."""
        filed = getattr(job, "_autoscale_filed", None)
        if filed is None:
            return
        dims, unit_s = filed
        job._autoscale_filed = None  # any applied resize supersedes ours
        if tuple(int(d) for d in new_dims) != dims:
            return  # an operator raced us — their resize, their price
        if job.run is not None and unit_s and unit_s > 0:
            job.run.reprice(unit_s, source="autoscale")

    def on_resize_rejected(self, job) -> None:
        """Scheduler callback when a pending resize was REJECTED: clear
        the in-flight stash so the policy is free to vote again (the
        rejection is already journaled as ``resize_rejected``)."""
        job._autoscale_filed = None
