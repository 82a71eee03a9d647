"""The resilient simulation driver: a step function -> a supervised long run.

Counterpart of `implicitglobalgrid_tpu/runtime/driver.py` (`_CheckpointSlots`
:66, `ResilientRun` :153, `run_resilient` :1104), on the port's chunked
runner (`models.common.make_state_runner`), its checkpoints, snapshot writer
and elastic restart::

    state, reports = igg.run_resilient(step, {"T": T, "Cp": Cp}, nt,
                                       nt_chunk=100,
                                       checkpoint_dir="/ckpt/run42")

Per chunk: the runner advances ``nt_chunk`` steps and computes the health
guard after the last one (`runtime.health`; with reducers, the guard and
the reducers' vector behind one `transport.all_sum`,
`io.reducers.make_reduced_post_chunk`); the driver fetches that small
vector to the host (the fetch is the chunk's drain), builds a
`HealthReport`, and

- on a healthy chunk: commits the state, periodically saving a
  DOUBLE-BUFFERED sharded checkpoint (two slots + an atomically replaced
  ``LATEST`` pointer file: a crash mid-write never loses the previous good
  state), and submits the cadence's snapshots;
- on a tripped guard (NaN/Inf, RMS divergence): rolls back to the last good
  checkpoint under the bounded-retry `RecoveryPolicy`, escalating (chunk
  shrink, ``on_escalate``) on repeated trips;
- on a restore failure (corrupt slot): falls back to the OTHER slot,
  verified by the per-file content checksums, not assumed;
- on a simulated process loss: re-inits the grid with other ``dims`` and
  redistributes the last good checkpoint onto it (`runtime.recovery`).

Counters land in the ``igg_health_events_total{kind=...}`` family
(`telemetry`), and with an active flight recorder the driver streams its
lifecycle as the JAX package's JSONL events, which either package's
`run_report` reconstructs. `ResilientRun` is the resumable machine (one
`advance()` a chunk boundary); `run_resilient` drains it.

What differs from the JAX package:

- **The step.** ``step_local(state: dict) -> dict`` is the public contract,
  as there. The port's runner takes ``step(state_tuple, spare) -> (state,
  old)``; the driver adapts one to the other and hands no spare, so the
  step allocates its output and never writes the committed state (a
  tripped chunk's output is dropped and the committed state must stay as
  it was). With ``ensemble=E`` the step advances the whole batch, member
  axis included, as `make_state_runner(ensemble=)` steps do in the port
  (the JAX package vmaps a per-member step).
- **A box a process.** Across processes (`parallel.transport`) each process
  holds its box of every field: the RMS denominator is the global stacked
  cell count, a `NaNPoke` index (global stacked layout) lands only in the
  process whose box owns the cell, and rank 0 alone writes the ``LATEST``
  pointer and injects a `CheckpointCorruption`, then a transport barrier.
- **No compiled runner.** ``key``, ``check_vma`` and ``unroll`` are
  accepted and have no effect on an eager runner; no runner-cache events
  are streamed and no chunk is cold.
- **The live endpoint and the tuner** come as the JAX package has them:
  ``metrics_port`` starts `telemetry.server` for the run (``/metrics``,
  ``/healthz``; ``healthz_max_age_s`` its 503 age), ``tuned`` resolves a
  `telemetry.TunedConfig` once, records the ``tuned`` event and scopes its
  knobs' environment (``IGG_HALO_WIRE_DTYPE``, ``IGG_HALO_COALESCE``,
  ``IGG_COMM_EVERY``, ``IGG_HALO_WIRE_STAGE``) around every `advance()`,
  and a ``perf_regression`` marks it stale (``tuned_stale``).
- **The audit records the chunk.** ``audit=True`` audits the first REAL
  chunk of each distinct length the run dispatches, recorded while it runs
  (`analysis.record`: no replay, no extra step), where the JAX package
  lowers the chunk program before its first dispatch; the verdict is the
  same contract and lints (`analysis.audit_chunk_program`).
- **The resize's device path** (`ResilientRun.resize`, `reshard.
  reshard_state`) copies the blocks on the card, one process only; across
  processes ``via="auto"`` takes the checkpoint path. Its feasibility check
  is the card's free memory, not a device count (`reshard.plan.
  check_device_memory`).
"""

from __future__ import annotations

import json
import os
import time

from .spec import RunSpec

__all__ = ["run_resilient", "ResilientRun", "RunSpec"]


class _CheckpointSlots:
    """Double-buffered checkpoint slots under one root directory.

    Saves alternate between ``slot0``/``slot1``; after a save fully commits
    (the staged-directory rename inside `save_checkpoint_sharded`), rank 0
    replaces the ``LATEST`` pointer file atomically (tmp + fsync + rename)
    to name the new last-good slot, then every process meets at a barrier.
    Restore order is pointer target first, then the other slot, so a crash
    at ANY point (mid-save, mid-pointer-write, post-corruption) still finds
    a complete verified checkpoint. The layout and the pointer's JSON are
    the JAX package's: each package restores the other's slots."""

    SLOTS = ("slot0", "slot1")
    POINTER = "LATEST"

    def __init__(self, root):
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)

    def _pointer(self) -> str:
        return os.path.join(self.root, self.POINTER)

    def latest(self):
        """Path of the last committed slot, or None."""
        try:
            with open(self._pointer()) as f:
                rec = json.load(f)
            name = rec["slot"]
        except Exception:
            return None
        return os.path.join(self.root, name) if name in self.SLOTS else None

    def candidates(self) -> list:
        """Restore order: pointer target first, then the other slot."""
        latest = self.latest()
        out = [latest] if latest else []
        for s in self.SLOTS:
            p = os.path.join(self.root, s)
            if p != latest and os.path.isdir(p):
                out.append(p)
        return out

    def save(self, state: dict, step: int) -> str:
        from ..parallel.topology import global_grid
        from ..utils.checkpoint import save_checkpoint_sharded
        from ..utils.timing import barrier

        latest = self.latest()
        if latest is None or os.path.basename(latest) == self.SLOTS[1]:
            target = os.path.join(self.root, self.SLOTS[0])
        else:
            target = os.path.join(self.root, self.SLOTS[1])
        save_checkpoint_sharded(target, state, step=step)
        if global_grid().transport.rank == 0:
            tmp = self._pointer() + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"slot": os.path.basename(target),
                           "step": int(step)}, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._pointer())
        barrier()  # pointer visible everywhere before anyone proceeds
        return target

    def restore(self):
        """Restore the newest usable slot onto the LIVE grid. Returns
        ``(state, step, used_fallback)``; raises `ResilienceError` when
        every slot fails (corruption is DETECTED, via the checkpoint
        layer's content checksums, never silently restored). Goes through
        the elastic restore, which delegates to the plain sharded restore
        when the decomposition matches, so a slot written BEFORE an
        elastic restart (old ``dims``) is still restorable after one."""
        from ..utils.checkpoint import restore_checkpoint_elastic
        from ..utils.exceptions import ResilienceError

        errors = []
        for i, path in enumerate(self.candidates()):
            try:
                state, step = restore_checkpoint_elastic(path)
                return state, int(step or 0), i > 0
            except Exception as e:  # corrupt/incomplete slot: try the other
                errors.append(f"{path}: {e}")
        raise ResilienceError(
            "No checkpoint slot could be restored:\n  "
            + ("\n  ".join(errors) if errors else "(no slot written yet)"))


def _global_shape(v, lead: int) -> tuple:
    """The whole grid's stacked shape of ``v``, this process's box of a
    field (``lead`` member axes first): the JAX package's array shape."""
    from ..parallel.topology import NDIMS, global_grid

    gg = global_grid()
    shape = [int(s) for s in v.shape]
    for d in range(min(NDIMS, len(shape) - lead)):
        shape[lead + d] = shape[lead + d] // int(gg.box[d]) * int(gg.dims[d])
    return tuple(shape)


def _box_index(v, index, lead: int):
    """``index`` (the whole grid's stacked layout) in this process's box of
    ``v``, or None where another process's box holds the cell."""
    from ..parallel.topology import NDIMS, global_grid

    gg = global_grid()
    out = []
    for d, i in enumerate(int(i) for i in index):
        sd = d - lead
        if 0 <= sd < NDIMS:
            loc = int(v.shape[d]) // int(gg.box[sd])
            i -= int(gg.coords[sd]) * loc
            if not 0 <= i < int(v.shape[d]):
                return None
        out.append(i)
    return tuple(out)


class ResilientRun:
    """One supervised run as a resumable, chunk-granular state machine.

    ``ResilientRun(step_local, state, nt, spec)`` performs the whole setup
    (validation, snapshot writer, checkpoint slots, perf watch); a raising
    constructor leaks none of those resources. Each `advance()` call then
    executes ONE chunk-boundary iteration: heartbeat, faults due at this
    boundary, one supervised chunk, commit-or-recover; it returns True
    while steps remain. `close()` releases the run's resources (idempotent;
    `run_resilient` calls it in a ``finally``). Preemption happens only at
    chunk boundaries, so a run's trajectory is the same however its
    `advance()` calls are spaced."""

    def __init__(self, step_local, state: dict, nt: int,
                 spec: RunSpec | None = None):
        from ..parallel.topology import check_initialized
        from ..telemetry import record_event
        from ..telemetry.hooks import note_heartbeat
        from ..utils.exceptions import InvalidArgumentError
        from .faults import NaNPoke, ProcessLoss
        from .health import GuardConfig
        from .recovery import RecoveryPolicy

        spec = spec if spec is not None else RunSpec()
        check_initialized()
        if not isinstance(state, dict) or not state:
            raise InvalidArgumentError(
                "run_resilient expects a non-empty dict of name -> stacked "
                "array (names become checkpoint keys and HealthReport "
                "entries).")
        self.spec = spec
        self.step_local = step_local
        self.state = state
        self.names = list(state)
        self.ensemble = (None if spec.ensemble is None
                         else int(spec.ensemble))
        if self.ensemble is not None:
            if self.ensemble < 1:
                raise InvalidArgumentError(
                    f"RunSpec.ensemble must be >= 1; got {spec.ensemble}.")
            for k, v in state.items():
                if v.dim() < 2 or int(v.shape[0]) != self.ensemble:
                    raise InvalidArgumentError(
                        f"ensemble={self.ensemble} expects every field to "
                        f"lead with the member axis (shape (E, ...)); "
                        f"field {k!r} has shape {tuple(v.shape)} — build "
                        "the state with models.common.ensemble_state.")
        self._lead = 0 if self.ensemble is None else 1
        # member-splice recovery (ensemble only): after a PARTIAL guard
        # trip the healthy members' committed chunk output (their slices
        # only) is pinned here keyed by the tripped boundary's step, and
        # re-spliced over the replay when it reaches that step again; a
        # dict, so a second trip at another boundary (chunk-shrink
        # escalation mid-replay) cannot drop an earlier boundary's pin
        self._pins: dict = {}
        self.guard = spec.guard if spec.guard is not None else GuardConfig()
        self.policy = (spec.policy if spec.policy is not None
                       else RecoveryPolicy())
        self.nt = int(nt)
        self.cur_chunk = max(1, int(spec.nt_chunk))
        self.checkpoint_every = max(1, int(
            spec.checkpoint_every if spec.checkpoint_every is not None
            else self.cur_chunk))
        self.pending = list(spec.faults)
        for f in self.pending:
            if isinstance(f, (NaNPoke, ProcessLoss)) \
                    and not 0 <= f.step < self.nt:
                raise InvalidArgumentError(
                    f"Fault {f} is outside the run's step range "
                    f"[0, {self.nt}).")
            if isinstance(f, NaNPoke):
                if f.name not in state:
                    raise InvalidArgumentError(
                        f"NaNPoke names unknown field {f.name!r}.")
                # the index addresses the WHOLE grid's stacked layout, as
                # the JAX package's global arrays: validated against it, so
                # a mistyped index cannot inject nothing and pass vacuously
                shape = _global_shape(state[f.name], self._lead)
                if len(f.index) != len(shape) or any(
                        not 0 <= int(i) < s
                        for i, s in zip(f.index, shape)):
                    raise InvalidArgumentError(
                        f"NaNPoke index {tuple(f.index)} is outside field "
                        f"{f.name!r} of stacked shape {tuple(shape)}.")
        # the tuned config (RunSpec.tuned): resolved once (a bad path or
        # record fails construction, not a later chunk); its knobs'
        # environment is scoped around every advance()
        from ..telemetry.tune import resolve_tuned

        self.tuned = resolve_tuned(spec.tuned)
        self._tuned_env = None if self.tuned is None else self.tuned.env()
        # an applied config a perf drift invalidates: marked stale
        # (`tuned_stale` event) until cleared or re-applied
        self.tuned_stale = False
        self.tuned_stale_reason = None
        # wall-clock deadline surface (RunSpec.deadline_s): crossing the
        # budget fires ONE deadline_missed flight event + counter at the
        # next boundary — observability, never a kill
        if spec.deadline_s is not None \
                and not float(spec.deadline_s) > 0:
            raise InvalidArgumentError(
                f"RunSpec.deadline_s is a wall-clock budget in seconds "
                f"(> 0); got {spec.deadline_s!r}.")
        self.deadline_s = (None if spec.deadline_s is None
                           else float(spec.deadline_s))
        self.deadline_missed = False
        # live slack: remaining budget minus the priced cost of the
        # remaining steps, refreshed at every boundary (`_check_deadline`)
        self.deadline_slack_s = None
        self._deadline_t0 = time.monotonic()
        if spec.audit_lints is not None and not spec.audit:
            raise InvalidArgumentError(
                "audit_lints selects rules for the chunk audit — it needs "
                "audit=True.")
        if spec.audit_lints is not None:
            # fail fast on a typo'd rule name: inside the chunk loop it
            # would only surface as a buried `audit_failed` event (the
            # audit degrades by design), silently disabling the requested
            # audit
            from ..analysis import LINT_RULES

            unknown = sorted(set(spec.audit_lints) - set(LINT_RULES))
            if unknown:
                raise InvalidArgumentError(
                    f"audit_lints: unknown lint rule(s) {unknown}; "
                    f"available: {sorted(LINT_RULES)}.")
        self._note_heartbeat = note_heartbeat
        self._record_event = record_event
        self.reducers = tuple(spec.reducers)
        # --- performance oracle: model attachment + live drift detector --
        model_step_s = model_bound = model_source = None
        if spec.perf_model is not None:
            if isinstance(spec.perf_model, dict):
                model_step_s = spec.perf_model.get("step_s")
                model_bound = spec.perf_model.get("bound")
                model_source = spec.perf_model.get("profile_source")
            else:
                model_step_s = spec.perf_model
            try:
                model_step_s = float(model_step_s)
            except (TypeError, ValueError):
                model_step_s = None
            if not model_step_s or model_step_s <= 0:
                raise InvalidArgumentError(
                    "perf_model must be a predict_step-shaped record (with a "
                    "positive 'step_s') or modeled per-step seconds; got "
                    f"{spec.perf_model!r}.")
        self._model_step_s = model_step_s
        self._model_bound = model_bound
        self._model_source = model_source
        self.watch = None
        if int(spec.perf_window) > 0:
            from ..telemetry.perfmodel import PerfWatch

            self.watch = PerfWatch(window=int(spec.perf_window),
                                   zmax=float(spec.perf_zmax),
                                   model_step_s=model_step_s)
        # the live endpoint comes up FIRST: a port conflict fails the call
        # before any other resource (writer thread, checkpoint dirs)
        self.server = None
        if spec.metrics_port is not None:
            from ..telemetry.server import start_metrics_server

            self.server = start_metrics_server(
                int(spec.metrics_port),
                healthz_max_age_s=spec.healthz_max_age_s)
        elif spec.healthz_max_age_s is not None:
            raise InvalidArgumentError(
                "healthz_max_age_s needs metrics_port (it configures the "
                "/healthz endpoint the driver starts).")
        self.writer = None
        try:
            if spec.snapshot_dir is not None:
                from ..io.snapshot import SnapshotWriter

                # validate the field selection NOW, not at the first
                # cadence boundary
                if spec.snapshot_fields is not None:
                    unknown = [f for f in spec.snapshot_fields
                               if f not in state]
                    if unknown:
                        raise InvalidArgumentError(
                            f"snapshot_fields {unknown} are not in the "
                            f"state (have {self.names}).")
            elif spec.snapshot_every is not None \
                    or spec.snapshot_fields is not None \
                    or spec.snapshot_policy != "block" \
                    or spec.snapshot_queue != 2:
                raise InvalidArgumentError(
                    "snapshot_every/snapshot_fields/snapshot_queue/"
                    "snapshot_policy need snapshot_dir to write into.")
            self.slots = (_CheckpointSlots(spec.checkpoint_dir)
                          if spec.checkpoint_dir is not None else None)
            if spec.snapshot_dir is not None:
                self.writer = SnapshotWriter(
                    spec.snapshot_dir, queue_depth=spec.snapshot_queue,
                    policy=spec.snapshot_policy,
                    fields=spec.snapshot_fields)
            self.snapshot_every = max(1, int(
                spec.snapshot_every if spec.snapshot_every is not None
                else self.cur_chunk))
            record_event("run_begin", nt=self.nt, nt_chunk=self.cur_chunk,
                         checkpoint_every=self.checkpoint_every,
                         names=self.names,
                         checkpointing=self.slots is not None,
                         faults=len(self.pending),
                         snapshots=self.writer is not None,
                         snapshot_every=(self.snapshot_every
                                         if self.writer else None),
                         reducers=len(self.reducers))
            if model_step_s is not None:
                record_event("perf_model", step_s=model_step_s,
                             bound=model_bound, source=model_source)
            if self.tuned is not None:
                record_event("tuned", model=self.tuned.model,
                             **self.tuned.knobs(),
                             predicted_step_s=self.tuned.predicted_step_s,
                             measured_step_s=self.tuned.measured_step_s,
                             speedup=self.tuned.speedup)
        except BaseException:
            # a failed setup must not leak the endpoint or the writer
            # thread
            if self.writer is not None:
                self.writer.close()
            if self.server is not None:
                from ..telemetry.server import stop_metrics_server

                stop_metrics_server()
            raise

        self.reports = []
        self.step = 0
        self.chunk_idx = 0
        self.retries = 0
        self.saves = 0
        # each distinct chunk length n is a distinct program in the JAX
        # package (and a distinct recording here): audit the first chunk of
        # every length the run dispatches, once — a cadence-clipped first
        # chunk must not leave the steady-state chunk unaudited. Failures
        # get ONE retry at a later boundary
        self._audited_ns: set = set()
        self._audit_fail_counts: dict = {}
        self._started = False
        self._finished = False
        self._closed = False

    # -- derived views -----------------------------------------------------

    @property
    def done(self) -> bool:
        """True once the run completed all ``nt`` steps (the ``run_end``
        event has been recorded)."""
        return self._finished

    def _step_tuple(self, tup, spare):
        """The runner's step over the user's ``step_local(dict) -> dict``:
        no spare is handed on, so the committed state is never written."""
        out = self.step_local(dict(zip(self.names, tup)))
        return tuple(out[k] for k in self.names), None

    # -- recovery helpers ---------------------------------------------------

    def _save(self, st, at_step):
        from ..parallel.topology import global_grid
        from ..telemetry.hooks import record_health_event
        from .faults import CheckpointCorruption, corrupt_checkpoint

        path = self.slots.save(st, at_step)
        record_health_event("checkpoints_saved")
        due = [f for f in self.pending
               if isinstance(f, CheckpointCorruption)
               and f.save_index == self.saves]
        for f in due:
            self.pending.remove(f)
            self._record_event("fault_injected",
                               fault="CheckpointCorruption",
                               save_index=f.save_index, corruption=f.kind,
                               target=f.target)
            # one damage event, not one per process: applied by rank 0
            # only (a second bitflip would undo the first; a second delete
            # would race-crash), made visible to all before anyone reads
            if global_grid().transport.rank == 0:
                corrupt_checkpoint(path, kind=f.kind, target=f.target,
                                   process=f.process)
        if due and global_grid().transport.world > 1:
            from ..utils.timing import barrier

            barrier()
        self.saves += 1

    def _elastic_recover(self, new_dims):
        from ..telemetry.hooks import record_health_event
        from ..utils.exceptions import ResilienceError
        from .recovery import elastic_restart

        errors = []
        for i, path in enumerate(self.slots.candidates()):
            try:
                st, at = elastic_restart(path, new_dims)
            except Exception as e:
                errors.append(f"{path}: {e}")
                continue
            record_health_event("restores")
            if i > 0:
                record_health_event("restore_fallbacks")
            return st, int(at or 0)
        raise ResilienceError(
            "Elastic restart failed on every checkpoint slot:\n  "
            + "\n  ".join(errors))

    def _audit_chunk(self, rec, n: int, state: dict, plan) -> None:
        """Audit the recorded chunk of length ``n``
        (`analysis.audit_chunk_program`) and stream the verdict
        (`observe_audit`: an ``audit`` event, the findings counters). The
        audit observes: a checker failure is an ``audit_failed`` event with
        one retry at a later chunk of the same length, never a dead run."""
        from ..analysis import audit_chunk_program
        from ..telemetry.hooks import observe_audit

        t0 = time.monotonic()
        try:
            rep = audit_chunk_program(
                rec, tuple(state[k] for k in self.names), names=self.names,
                reducer_floats=plan.length if plan is not None else 0,
                lints=self.spec.audit_lints, ensemble=self.ensemble)
            observe_audit(rep, audit_s=time.monotonic() - t0)
            self._audited_ns.add(n)
        except Exception as e:
            self._audit_fail_counts[n] = self._audit_fail_counts.get(n, 0) + 1
            self._record_event("audit_failed", error=str(e),
                               audit_s=time.monotonic() - t0,
                               attempt=self._audit_fail_counts[n])

    # -- elastic resize (the autoscaling primitive) ---------------------------

    def resize(self, new_dims, *, via: str = "auto") -> dict:
        """Re-block the run onto a ``new_dims`` decomposition of the SAME
        implicit global grid, between `advance()` calls. Two paths, one
        result:

        - ``"device"`` — the fast path (`reshard.reshard_state`): the live
          state re-blocks on the card by the plan's rounds of block-view
          copies, no disk round trip. One process only; with
          ``RunSpec.audit`` the move's recording is audited against its
          plan-derived contract (an ``audit`` event with
          ``program="reshard"``).
        - ``"checkpoint"`` — the verified fallback and bit-identity oracle:
          save the live state to the slots, then
          `restore_checkpoint_elastic` onto the new decomposition (the
          `ProcessLoss` recovery machinery, minus the lost steps).

        ``"auto"`` (default) tries the device path and falls back, recording
        ``via="checkpoint"`` and the device error in the record and the
        event; ``"device"`` raises where the device path fails. Both paths
        end BITWISE equal (the plan reuses the elastic restore's owner-map
        arithmetic), so the trajectory after a resize equals the unresized
        run's. Afterwards the slots re-anchor on the new decomposition,
        the chunks get fresh audit budgets, the ``igg_reshard_*`` metrics
        and a ``resize`` flight event record the move, and an applied
        `TunedConfig` is marked stale (``tuned_stale`` event). Dims that
        cannot decompose the grid, or whose state does not fit the card's
        free memory beside the live one (the port's counterpart of the JAX
        package's device-pool check), are argument errors raised before
        any path touches the grid. Returns the resize record (``via``,
        ``seconds``, plan stats)."""
        from ..parallel.topology import global_grid
        from ..reshard.plan import (
            build_reshard_plan, check_device_memory, fields_of_state, live_topology,
            restore_topology,
        )
        from ..telemetry.hooks import observe_audit, observe_reshard, \
            record_health_event
        from ..utils.checkpoint import elastic_local_size
        from ..utils.exceptions import InvalidArgumentError, ResilienceError

        if via not in ("auto", "device", "checkpoint"):
            raise InvalidArgumentError(
                f"resize: via must be auto|device|checkpoint; got {via!r}.")
        if self._finished:
            raise InvalidArgumentError(
                "resize: the run already completed all its steps.")
        new_dims = tuple(int(d) for d in new_dims)
        if len(new_dims) != 3:
            raise InvalidArgumentError(
                f"resize: new_dims must be 3 ints; got {new_dims}.")
        gg = global_grid()
        if tuple(int(d) for d in gg.dims) == new_dims:
            self._record_event("resize", via="noop",
                               new_dims=list(new_dims), step=self.step)
            return {"via": "noop", "new_dims": list(new_dims)}
        # argument-level feasibility FIRST: the elastic fallback tears the
        # live grid down before its init would fail, so reaching it with
        # an infeasible request would leave the run DEAD, not rejected
        src_topo = live_topology(gg)
        elastic_local_size(src_topo, new_dims)
        if int(gg.transport.world) == 1:
            # both paths hold the new state beside the live one
            check_device_memory(build_reshard_plan(
                src_topo, new_dims, fields_of_state(self.state)), gg.device)
        device_type = gg.device_type
        t0 = time.monotonic()
        info: dict = {}
        used = device_error = None
        if via in ("auto", "device"):
            try:
                from ..reshard import reshard_state

                self.state, info = reshard_state(
                    self.state, new_dims, audit=self.spec.audit,
                    lints=self.spec.audit_lints)
                used = "device"
            except Exception as e:
                if via == "device":
                    raise
                device_error = f"{type(e).__name__}: {e}"
        if used is None:
            if self.slots is None:
                raise ResilienceError(
                    f"resize to {new_dims}: no checkpoint_dir is "
                    "configured for the elastic (checkpoint) path"
                    + (f", and the on-device path failed "
                       f"({device_error})" if device_error else "")
                    + ".")
            # anchor the LIVE state first: the checkpoint path re-blocks
            # the last save, which must be this exact boundary's state
            self._save(self.state, self.step)
            try:
                self.state, self.step = self._elastic_recover(new_dims)
            except BaseException:
                # the elastic restart finalizes and re-inits BEFORE
                # restoring: put the SOURCE grid back so that a caller
                # treating this as a rejected request keeps the run alive
                restore_topology(src_topo, quiet=True, device_type=device_type)
                raise
            used = "checkpoint"
        dur = time.monotonic() - t0
        report = info.pop("audit_report", None)
        if report is not None:
            observe_audit(report, program="reshard")
        if info.get("audit_error"):
            self._record_event("audit_failed", program="reshard",
                               error=info.pop("audit_error"))
        # the rebuilt decomposition's chunks get fresh audits, and the
        # slots re-anchor so any later rollback stays on the live grid
        self._audited_ns.clear()
        self._audit_fail_counts.clear()
        if self.slots is not None:
            self._save(self.state, self.step)
        record_health_event("resizes")
        observe_reshard(
            dur, via=used, new_dims=list(new_dims), step=self.step,
            rounds=info.get("rounds"), wire_bytes=info.get("wire_bytes"),
            local_bytes=info.get("local_bytes"),
            peak_payload_bytes=info.get("peak_payload_bytes"),
            **({"device_error": device_error} if device_error else {}))
        self._mark_tuned_stale("resize")
        return {"via": used, "seconds": dur, "new_dims": list(new_dims),
                **({"device_error": device_error} if device_error else {}),
                **info}

    def _mark_tuned_stale(self, reason: str) -> None:
        """Flag the applied `TunedConfig` as invalidated (a resize changed
        the geometry it was searched for; a perf drift says its knobs
        stopped winning). No-op without a tuned config; records
        the ``tuned_stale`` flight event once."""
        if self.tuned is None or self.tuned_stale:
            return
        self.tuned_stale = True
        self.tuned_stale_reason = reason
        self._record_event("tuned_stale", reason=reason,
                           model=self.tuned.model)

    def clear_tuned(self) -> None:
        """Drop the applied `TunedConfig`: later chunks run under the
        DEFAULT wire/coalesce/cadence environment again. Structural knobs
        the setup built into the step (overlap, a deep super-step,
        ensemble stacking) stay."""
        self.tuned = None
        self._tuned_env = None
        self.tuned_stale = False
        self.tuned_stale_reason = None

    def apply_tuned(self, cfg) -> None:
        """Apply a (re)tuned `TunedConfig` to the LIVE run: later chunks run
        under the config's knob environment (`TunedConfig.env`).
        Structural knobs (overlap, a deep cadence built into the step,
        ensemble stacking) are NOT re-applied: the step function is already
        built. Clears any stale flag and records a ``tuned`` flight
        event."""
        from ..telemetry.tune import TunedConfig
        from ..utils.exceptions import InvalidArgumentError

        if not isinstance(cfg, TunedConfig):
            raise InvalidArgumentError(
                f"apply_tuned takes a telemetry.TunedConfig; got "
                f"{type(cfg).__name__}.")
        self.tuned = cfg
        self._tuned_env = cfg.env()
        self.tuned_stale = False
        self.tuned_stale_reason = None
        self._record_event("tuned", model=cfg.model, **cfg.knobs(),
                           predicted_step_s=cfg.predicted_step_s,
                           measured_step_s=cfg.measured_step_s,
                           speedup=cfg.speedup)

    def reprice(self, step_s: float, *, bound=None, source=None) -> None:
        """Replace the attached perf-model unit price (seconds per step):
        the deadline-slack computation (`_check_deadline`) and the
        PerfWatch measured/modeled ratio track the new price. Records a
        ``perf_model`` flight event."""
        from ..utils.exceptions import InvalidArgumentError

        try:
            step_s = float(step_s)
        except (TypeError, ValueError):
            step_s = 0.0
        if not step_s > 0:
            raise InvalidArgumentError(
                f"reprice: step_s must be positive modeled seconds per "
                f"step; got {step_s!r}.")
        self._model_step_s = step_s
        self._model_bound = bound
        self._model_source = source
        if self.watch is not None:
            self.watch.model_step_s = step_s
        self._record_event("perf_model", step_s=step_s, bound=bound,
                           source=source)

    # -- the chunk-boundary iteration ---------------------------------------

    def advance(self) -> bool:
        """Execute ONE chunk-boundary iteration; return True while steps
        remain (False once the run is complete). The first call performs
        the initial step-0 checkpoint save; the call that commits step
        ``nt`` records the ``run_end`` event. With a tuned config attached
        (`RunSpec.tuned`, `apply_tuned`) the iteration runs under the
        config's knob environment."""
        if self._tuned_env is not None:
            from ..telemetry.tune import _scoped_env

            with _scoped_env(self._tuned_env):
                return self._advance()
        return self._advance()

    def _advance(self) -> bool:
        if self._finished:
            return False
        if not self._started:
            self._started = True
            if self.slots is not None:
                # rollback ALWAYS possible, even before step 1
                self._save(self.state, 0)
        if self.step < self.nt:
            self._iterate()
        if self.step >= self.nt and not self._finished:
            self._note_heartbeat(self.step)
            # a run that crossed its budget inside the FINAL chunk still
            # reports it (no further boundary would check)
            self._check_deadline()
            self._record_event("run_end", completed=self.step,
                               chunks=self.chunk_idx)
            self._finished = True
        return not self._finished

    def _check_deadline(self) -> None:
        """Boundary-granular deadline watch: every boundary of a
        deadline-budgeted run computes the LIVE SLACK (remaining budget
        minus the priced cost of the remaining steps: the attached perf
        model, else the PerfWatch warm baseline, else the budget alone),
        stamps the ``igg_deadline_slack_seconds`` gauge and records a
        ``deadline_slack`` flight event. Past the budget it records ONE
        ``deadline_missed`` event and bumps
        ``igg_job_deadline_missed_total``; the run keeps going."""
        if self.deadline_s is None:
            return
        from ..telemetry.hooks import (
            note_deadline_missed, note_deadline_slack,
        )

        elapsed_s = time.monotonic() - self._deadline_t0
        budget_s = self.deadline_s - elapsed_s
        step_s = self._model_step_s
        priced_by = "perf_model" if step_s else None
        if not step_s and self.watch is not None:
            step_s = self.watch.baseline_s()
            priced_by = "measured" if step_s else None
        remaining = max(0, self.nt - self.step)
        slack_s = budget_s - (step_s * remaining if step_s else 0.0)
        self.deadline_slack_s = slack_s
        note_deadline_slack(slack_s)
        self._record_event("deadline_slack", step=self.step,
                           slack_s=slack_s, budget_s=budget_s,
                           priced_step_s=step_s, priced_by=priced_by,
                           remaining_steps=remaining)
        if not self.deadline_missed and elapsed_s > self.deadline_s:
            self.deadline_missed = True
            note_deadline_missed()
            self._record_event("deadline_missed", step=self.step,
                               deadline_s=self.deadline_s,
                               elapsed_s=elapsed_s, slack_s=slack_s)

    def _iterate(self):
        record_event = self._record_event

        from ..models.common import make_state_runner
        from ..parallel.topology import global_grid
        from ..telemetry.hooks import record_health_event
        from ..utils.exceptions import ResilienceError
        from .faults import NaNPoke, ProcessLoss, poke_nan
        from .health import make_guarded_runner, report_from_stats

        # liveness stamp at every boundary (normal commit, retry, and
        # elastic-restart paths all come back through here)
        self._note_heartbeat(self.step)
        self._check_deadline()
        step = self.step
        # --- faults due at this boundary (chunks split on them) ----------
        for f in [f for f in self.pending
                  if isinstance(f, NaNPoke) and f.step == step]:
            self.pending.remove(f)
            at = _box_index(self.state[f.name], f.index, self._lead)
            if at is not None:  # the process whose box holds the cell
                self.state = dict(self.state)
                self.state[f.name] = poke_nan(self.state[f.name], at)
            record_event("fault_injected", fault="NaNPoke", step=f.step,
                         name=f.name)
        loss = next((f for f in self.pending
                     if isinstance(f, ProcessLoss) and f.step == step),
                    None)
        if loss is not None:
            self.pending.remove(loss)
            record_event("fault_injected", fault="ProcessLoss",
                         step=loss.step, new_dims=list(loss.new_dims))
            if self.slots is None:
                raise ResilienceError(
                    "ProcessLoss injected with no checkpoint_dir — "
                    "nothing to restart from.")
            self.state, self.step = self._elastic_recover(loss.new_dims)
            record_health_event("elastic_restarts")
            record_event("elastic_restart", new_dims=list(loss.new_dims),
                         to_step=self.step)
            # the restart rebuilds the decomposition: audit its chunks too
            # (run_report's audit section treats the last audit as
            # authoritative), with fresh retry budgets
            self._audited_ns.clear()
            self._audit_fail_counts.clear()
            # re-anchor the slots on the NEW decomposition right away, so
            # a guard trip before the next cadence save rolls back onto
            # the live grid instead of re-crossing the dims change
            self._save(self.state, self.step)
            return

        # --- one supervised chunk ----------------------------------------
        nb = min(step + self.cur_chunk, self.nt)
        if self.slots is not None:  # align to the checkpoint cadence
            nb = min(nb, (step // self.checkpoint_every + 1)
                     * self.checkpoint_every)
        if self.writer is not None:  # ... and to the snapshot cadence
            nb = min(nb, (step // self.snapshot_every + 1)
                     * self.snapshot_every)
        for f in self.pending:
            if isinstance(f, (NaNPoke, ProcessLoss)) and step < f.step < nb:
                nb = f.step
        pending_pins = [s for s in self._pins if s > step]
        if pending_pins:
            # member-splice replay in flight: land exactly on the NEXT
            # pinned boundary so the healthy members' pinned chunk output
            # can be re-spliced there
            nb = min(nb, min(pending_pins))
        n = nb - step
        state, names, spec = self.state, self.names, self.spec

        E = self.ensemble
        # the RMS denominator: the whole grid's stacked cell count (per
        # member), whatever box this process holds
        sizes = []
        for k in names:
            count = 1
            for s in _global_shape(state[k], self._lead)[self._lead:]:
                count *= s
            sizes.append(count)
        t_build0 = time.monotonic()
        if self.reducers:
            from ..io.reducers import build_reducer_plan, \
                make_reduced_post_chunk

            # rebuilt per boundary (cheap host work): the ownership
            # geometry follows the LIVE decomposition, which an elastic
            # restart changes; an ensemble's plan reasons over one
            # member's geometry
            plan_state = state if not E else {
                k: v[0] for k, v in state.items()}
            plan = build_reducer_plan(self.reducers, names, plan_state)
            runner = make_state_runner(
                self._step_tuple, nt_chunk=n,
                post_chunk=make_reduced_post_chunk(names, plan), ensemble=E)
        else:
            plan = None
            runner = make_guarded_runner(self._step_tuple, nt_chunk=n,
                                         ensemble=E)
        t_built = time.monotonic()
        audit_now = spec.audit and n not in self._audited_ns \
            and self._audit_fail_counts.get(n, 0) < 2
        t_exec0 = time.monotonic()
        if audit_now:
            # the first real chunk of this length runs under the recorder
            from ..analysis.record import recording

            with recording() as rec:
                out = runner(*(state[k] for k in names))
        else:
            out = runner(*(state[k] for k in names))
        # the small summed vector to the host = the chunk drain; with
        # reducers it carries [health | reducer segments] from ONE sum
        # (ensemble: an (E, 2N+R) matrix, one row a member)
        vec = global_grid().transport.host_values(out[-1])
        t_done = time.monotonic()
        if audit_now:
            self._audit_chunk(rec, n, state, plan)
        nh = 2 * len(names)
        if E:
            from ..telemetry.hooks import observe_member_health
            from .health import ensemble_reports_from_stats

            member_reps = ensemble_reports_from_stats(
                vec[:, :nh], names, sizes, self.guard,
                chunk=self.chunk_idx, step_begin=step, step_end=nb)
            self.reports.extend(member_reps)
            tripped = [r.member for r in member_reps if not r.ok]
            reasons = [f"{reason}@m{r.member}" for r in member_reps
                       for reason in r.reasons]
            ok = not tripped
            rep = member_reps[0]  # chunk-level anchor (chunk/step fields)
            observe_member_health(member_reps)
        else:
            rep = report_from_stats(vec[:nh], names, sizes,
                                    self.guard, chunk=self.chunk_idx,
                                    step_begin=step, step_end=nb)
            self.reports.append(rep)
            tripped, reasons, ok = None, list(rep.reasons), rep.ok
        self.chunk_idx += 1
        record_health_event("chunks")
        # every process stamps the chunk when the last one has its report:
        # `aggregate_flight` aligns the processes' clocks on these stamps
        global_grid().transport.release()
        # exec_s covers dispatch through the stats fetch (= the chunk
        # drain)
        record_event("chunk", chunk=rep.chunk, step_begin=step,
                     step_end=nb, n=n, ok=ok,
                     reasons=reasons,
                     build_s=t_built - t_build0,
                     exec_s=t_done - t_exec0,
                     **({"members_tripped": tripped} if E else {}))
        if self.watch is not None:
            # live drift detection: pure host arithmetic per boundary
            verdict = self.watch.observe(
                chunk=rep.chunk, step_begin=step, step_end=nb, n=n,
                exec_s=t_done - t_exec0)
            if verdict is not None:
                record_event("perf_regression", **verdict)
                self._mark_tuned_stale("perf_drift")
        if plan is not None:
            from ..telemetry.hooks import observe_reducers

            if E:
                # each scenario streams its own probes/stats: one decoded
                # segment set per member, labeled "<label>[m<member>]"
                values = {}
                for m in range(E):
                    for label, v in plan.decode(vec[m, nh:]).items():
                        values[f"{label}[m{m}]"] = v
            else:
                values = plan.decode(vec[nh:])
            observe_reducers(nb, values, ok=ok)
            if spec.on_reduce is not None:
                spec.on_reduce(nb, values)
        if spec.on_report is not None:
            for r in (member_reps if E else (rep,)):
                spec.on_report(r)

        if ok:
            self.state = dict(zip(names, out[:-1]))
            self.step = nb
            self.retries = 0
            if self.step in self._pins:
                self._splice_pin(self.step, self._pins.pop(self.step))
            # cadence saves, plus the TERMINAL state: without the latter a
            # run whose nt is off-cadence could never be resumed from its
            # own end
            if self.slots is not None \
                    and (self.step % self.checkpoint_every == 0
                         or self.step >= self.nt):
                self._save(self.state, self.step)
            if self.writer is not None \
                    and (self.step % self.snapshot_every == 0
                         or self.step >= self.nt):
                kept = self.writer.submit(self.state, self.step)
                record_event("snapshot", step=self.step,
                             displaced=not kept)
            return

        # --- guard tripped: bounded-retry rollback ------------------------
        record_health_event("guard_trips")
        self.retries += 1
        record_event("guard_trip", step_end=nb, reasons=reasons,
                     retries=self.retries,
                     **({"members": tripped} if E else {}))
        if self.slots is None:
            raise ResilienceError(
                f"Health guard tripped at step {nb} "
                f"({', '.join(reasons)}) and no checkpoint_dir is "
                "configured — cannot roll back.")
        if self.retries > self.policy.max_retries:
            raise ResilienceError(
                f"Health guard tripped {self.retries} consecutive times "
                f"at step {nb} ({', '.join(reasons)}); retry budget "
                f"({self.policy.max_retries}) exhausted.")
        if self.policy.backoff_s:
            time.sleep(self.policy.backoff_s * 2 ** (self.retries - 1))
        if self.retries >= self.policy.shrink_chunk_after \
                and self.cur_chunk > self.policy.min_nt_chunk:
            self.cur_chunk = max(self.policy.min_nt_chunk,
                                 self.cur_chunk // 2)
            record_health_event("escalations")
            record_event("escalation", retries=self.retries,
                         nt_chunk=self.cur_chunk, step=step)
            if self.policy.on_escalate is not None:
                self.policy.on_escalate({"retries": self.retries,
                                         "nt_chunk": self.cur_chunk,
                                         "step": step})
        if E and tripped:
            # PARTIAL trip: recovery keys on the member index. Pin the
            # healthy members' committed chunk output (their slices
            # only); the whole batch replays from the last-good save
            # (members are independent, so the replay IS each tripped
            # member's solo recompute), and at the pinned boundary
            # `_splice_pin` re-asserts the healthy members' pinned state.
            # An all-members trip leaves no healthy set and falls through
            # to the classic full rollback.
            healthy = [m for m in range(E) if m not in tripped]
            prior = self._pins.get(nb)
            if prior is not None:
                # a second trip at the SAME boundary: members healthy in
                # BOTH attempts stay pinned; newly tripped ones drop out
                healthy = [m for m in healthy if m in prior["healthy"]]
            if healthy:
                import torch

                self._pins[nb] = {
                    "healthy": healthy,
                    # advanced indexing copies: the pin owns its slices
                    "state": {k: v[torch.tensor(healthy, device=v.device)]
                              for k, v in zip(names, out[:-1])}}
                record_health_event("member_rollbacks")
                record_event("member_rollback", members=tripped,
                             pinned=healthy, step_end=nb)
            else:
                self._pins.pop(nb, None)
        self.state, self.step, fellback = self.slots.restore()
        record_health_event("rollbacks")
        record_health_event("restores")
        if fellback:
            record_health_event("restore_fallbacks")
        record_event("rollback", to_step=self.step, fallback=fellback,
                     retries=self.retries)

    def _splice_pin(self, at_step: int, pin: dict) -> None:
        """Finish a member-splice replay: overwrite the healthy members'
        slices of the replayed state with their PINNED chunk output, in a
        copy. The replay is deterministic, so this is numerically a no-op;
        it is the isolation GUARANTEE (a healthy realization is never
        perturbed by a neighbour's rollback), and it runs before the
        commit's cadence save so checkpoints hold the spliced state."""
        import torch

        out = {}
        for k, v in self.state.items():
            w = v.clone()
            w[torch.tensor(pin["healthy"], device=v.device)] = pin["state"][k]
            out[k] = w
        self.state = out
        self._record_event("member_splice", members=pin["healthy"],
                           step=at_step)

    def close(self) -> None:
        """Release the run's resources (the metrics endpoint, the snapshot
        writer's drain) — idempotent, safe on every exit path."""
        if self._closed:
            return
        self._closed = True
        if self.server is not None:
            from ..telemetry.server import stop_metrics_server

            stop_metrics_server()
        if self.writer is not None:
            # drain on EVERY exit path (normal end, retry-budget
            # ResilienceError, a user exception out of on_report): every
            # submitted snapshot is on disk before the caller proceeds
            self.writer.close()
            self._record_event("snapshot_writer_close", **self.writer.stats)


def run_resilient(step_local, state: dict, nt: int, *,
                  spec: RunSpec | None = None, **kwargs):
    """Advance ``state`` by ``nt`` steps under health supervision with
    checkpoint-rollback recovery. Returns ``(state, reports)``, once the
    device has drained.

    ``step_local(state: dict) -> dict`` advances one step of the stacked
    tensors (this process's box of every field) and returns the new state,
    halos exchanged (`update_halo` / `local_update_halo`, or a model's
    ``*_step_local``); it must not write its input (the driver keeps the
    committed state for a rollback). ``state`` maps field names to those
    tensors; the names key the checkpoints and `HealthReport` entries.
    ``key``, ``check_vma`` and ``unroll`` are accepted for the JAX
    package's callers and have no effect (nothing is compiled or cached).

    The knobs travel either as keywords or pre-packed as
    ``spec=RunSpec(...)``; passing both raises. This function is a thin
    shim over the resumable `ResilientRun` machine: construct, drain
    `advance()` to completion, `close()`.

    ``checkpoint_dir`` enables recovery: double-buffered sharded slots +
    last-good pointer, saved every ``checkpoint_every`` steps (default:
    every chunk) and at the end; without it a tripped guard is fatal
    (`ResilienceError`). ``guard`` (`GuardConfig`) selects the guards;
    ``policy`` (`RecoveryPolicy`) bounds retries and escalation; ``faults``
    takes the deterministic injection species of `runtime.faults` (each
    applied exactly once); ``on_report`` is called with every
    `HealthReport`.

    The chunk schedule is split at fault steps, so injections land at exact
    step boundaries; rollback recomputes from the last good save, so a
    recovered run's final state is bit-identical to an uninterrupted one
    (the kernels' replays give the same bits).

    ``ensemble=E`` batches E scenario members through the one supervised
    run: every state tensor leads with the member axis (build with
    `models.common.ensemble_state`) and ``step_local`` advances the whole
    batch (e.g. ``diffusion_step_local(..., members=E)``), one exchange a
    dim carrying every member. The guard trips PER MEMBER: a partial trip
    pins the healthy members' committed chunk output, replays the batch
    from the last-good save and re-splices the pinned members at the
    boundary (``member_rollback``/``member_splice`` events,
    ``member_rollbacks`` counter). Reducer values stream per member
    (labels suffixed ``[m<member>]``); `HealthReport.member` carries the
    member index (E reports per chunk).

    Output pipeline (`io`, O(box) per process, never a gather):
    ``snapshot_dir`` enables ASYNC sharded snapshots every
    ``snapshot_every`` steps (default: every chunk; ``snapshot_fields``
    restricts the fields, ``snapshot_queue``/``snapshot_policy`` bound the
    queue). ``reducers`` takes `io.Probe` / `io.AxisSlice` / `io.Stats`
    specs computed after each chunk behind the health guard's one sum;
    decoded values stream to the flight recorder + metrics gauges and to
    ``on_reduce(step, values)`` when given.

    Performance oracle (host-side only): every chunk boundary feeds
    `telemetry.PerfWatch` (a rolling median + MAD per-step baseline over
    ``perf_window`` chunks; a chunk whose robust z-score exceeds
    ``perf_zmax`` emits a ``perf_regression`` event); ``perf_model``
    attaches a prediction (a dict with ``step_s``, or seconds a step);
    ``perf_window=0`` disables the detector. ``deadline_s`` is a wall-clock
    budget: its slack is stamped at every boundary and crossing it records
    one ``deadline_missed`` event; the run completes.

    ``metrics_port`` (opt-in) starts the live metrics endpoint
    (`telemetry.start_metrics_server`) for the run: ``/metrics`` serves the
    Prometheus snapshot, ``/healthz`` the age of the driver heartbeat;
    ``0`` binds an ephemeral port (read it from
    ``igg.metrics_server().port``); a server already live in the process
    is attached to (refcounted). ``healthz_max_age_s`` makes ``/healthz``
    return 503 when the heartbeat is older. Binds 127.0.0.1.

    ``tuned`` takes a `telemetry.TunedConfig`, its JSON dict or a path
    (`telemetry.tune_config`'s output): its knobs' environment is scoped
    around every chunk and a ``tuned`` event records it.

    ``audit=True`` audits the first chunk of each distinct length the run
    dispatches, recorded while it runs (`analysis.record`), once: a
    cadence-clipped or fault-split chunk is a distinct length, and an
    elastic restart or a resize re-audits the rebuilt decomposition's
    chunks. The recording is checked against the guard contract (exactly
    one f32[2N + R] sum, no gathers, the steps' collectives alike) and the
    implicit-grid lints (``audit_lints`` selects rules from
    `analysis.LINT_RULES`; default all). Findings stream to the flight
    recorder (``audit`` event: `run_report`'s ``"audit"`` section) and the
    ``igg_audit_findings_total{rule,severity}`` family; an error finding
    does not abort the run (the audit observes). The recorder adds its
    bookkeeping to the audited chunk only."""
    from ..utils.exceptions import InvalidArgumentError
    from ..utils.timing import sync

    if spec is not None and kwargs:
        raise InvalidArgumentError(
            "run_resilient: pass the knobs either pre-packed via spec= or "
            f"as keywords, not both (got spec plus {sorted(kwargs)}).")
    if spec is None:
        spec = RunSpec(**kwargs)
    run = ResilientRun(step_local, state, nt, spec)
    try:
        while run.advance():
            pass
    finally:
        run.close()
    return sync(run.state), run.reports
