"""Jobs: what the persistent-mesh scheduler admits and multiplexes.

Counterpart of `implicitglobalgrid_tpu/service/job.py`. A job is a complete
supervised run waiting to happen: a grid geometry (its own
`init_global_grid` arguments: jobs with DIFFERENT models and grid sizes
share one card), a setup callable that builds the step function and state
UNDER that grid, a step budget, the full `runtime.RunSpec` knob set
(checkpoints, snapshots, reducers, perf watch, audit: every subsystem of the
supervised run becomes per-tenant), and scheduling metadata (priority
weight, optional deadline).

`JobSpec` is the immutable submission; `Job` is the scheduler's live record
of it (state machine QUEUED -> RUNNING -> DONE/FAILED/CANCELLED, slice
accounting, the underlying `ResilientRun`). `builtin_setup` maps the model
names of a queue's JSON (``diffusion3d`` ...) to setup callables, so a job
queue can be described in plain JSON; `jobspec_from_json` reads the JAX
package's job records unchanged.

The built-in setups step the plain route (the JAX package's ``"xla"``, as
`telemetry.tune` maps it): its exchange runs the card's halo kernels, K6 or
K2 for diffusion's `local_update_halo` and K8 + K7 for the coalesced
acoustic and Stokes groups. A batched job (``ensemble=E``) steps the whole
member batch (the port's `models.common.make_state_runner(ensemble=)`
convention), where the JAX package's per-member step is vmapped.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from ..runtime.spec import RunSpec
from ..utils.exceptions import InvalidArgumentError

__all__ = ["JobSpec", "Job", "JobState", "builtin_setup", "BUILTIN_MODELS",
           "jobspec_from_json"]


class JobState:
    """Job lifecycle states (plain strings — they travel through JSON
    journals and Prometheus labels)."""

    QUEUED = "queued"        # submitted, not yet granted a slice
    RUNNING = "running"      # admitted: grid + state live, being sliced
    DONE = "done"            # completed all nt steps; result available
    FAILED = "failed"        # raised (retry budget, fatal guard, setup)
    CANCELLED = "cancelled"  # cancelled before completion
    REJECTED = "rejected"    # refused at admission (deadline pricing)

    TERMINAL = (DONE, FAILED, CANCELLED, REJECTED)


@dataclass(frozen=True)
class JobSpec:
    """One queued simulation.

    ``name`` must be unique within a scheduler (it keys the flight JSONL,
    the journal, and every per-job metric label). ``setup`` is called
    ONCE, at admission, with the job's grid current — it returns
    ``(step_local, state)`` exactly as `run_resilient` takes them.
    ``grid`` holds `init_global_grid` keyword arguments (``quiet=True``
    is applied unless overridden); the scheduler builds a SEPARATE grid
    per job over the same device pool and context-switches between them.
    ``run`` is the embedded `runtime.RunSpec` (all ~20 supervised-run
    knobs — not re-declared here). ``priority`` is the weight the
    ``fair`` policy shares mesh time by (higher = more slices; must be
    >= 1).

    ``deadline_s`` is a wall-clock budget measured from submission.
    Two mechanisms enforce it: admission pricing — when ``model`` names
    a `telemetry.predict_step` workload (``diffusion3d`` …, what
    `jobspec_from_json` fills for built-in jobs), the scheduler prices
    the job's expected mesh-seconds at ``_admit`` time and REJECTS a
    job whose priced completion provably busts the remaining budget
    (journaled ``admission_priced`` verdict; `JobState.REJECTED`) —
    and the runtime ``deadline_missed`` flight event + counter when a
    running job crosses it anyway. ``model=None`` (a custom setup) is
    unpriceable: such jobs always admit; only the runtime surface
    fires."""

    name: str
    setup: Callable[[], tuple]
    nt: int
    grid: dict = field(default_factory=dict)
    run: RunSpec = field(default_factory=RunSpec)
    priority: int = 1
    deadline_s: float | None = None
    model: str | None = None

    def __post_init__(self):
        if not self.name or "/" in str(self.name):
            raise InvalidArgumentError(
                f"JobSpec.name must be a non-empty, slash-free string "
                f"(it names files); got {self.name!r}.")
        if not callable(self.setup):
            raise InvalidArgumentError(
                "JobSpec.setup must be callable () -> (step_local, state).")
        if int(self.nt) <= 0:
            raise InvalidArgumentError(
                f"JobSpec.nt must be positive; got {self.nt}.")
        if not isinstance(self.run, RunSpec):
            raise InvalidArgumentError(
                "JobSpec.run must be a runtime.RunSpec (it embeds the "
                "supervised-run knob set instead of re-declaring it).")
        if int(self.priority) < 1:
            raise InvalidArgumentError(
                f"JobSpec.priority is a fair-share weight >= 1; got "
                f"{self.priority}.")
        if self.deadline_s is not None and not float(self.deadline_s) > 0:
            raise InvalidArgumentError(
                f"JobSpec.deadline_s is a wall-clock budget in seconds "
                f"(> 0) measured from submission; got {self.deadline_s}.")


class Job:
    """The scheduler's live record of one submitted `JobSpec`."""

    def __init__(self, spec: JobSpec, index: int):
        self.spec = spec
        self.index = index              # submission order (fifo key)
        self.state = JobState.QUEUED
        self.gg = None                  # this job's GlobalGrid, once admitted
        self.run = None                 # the ResilientRun machine
        self.recorder = None            # per-job FlightRecorder (or None)
        self.scope = None               # per-job ScopedRegistry gauges
        self.error: str | None = None
        self.result = None              # final state dict (DONE only)
        self.reports = None
        self.submitted_t: float | None = None
        self.started_t: float | None = None
        self.finished_t: float | None = None
        self.admit_s: float = 0.0       # grid init + user setup cost
        self.slices = 0
        self.slice_s_total = 0.0
        self.wait_s_total = 0.0
        self.cancel_requested = False
        self.resize_requested = None    # (dims tuple, via); applied at a slice
        self.last_end_t: float | None = None
        self.deadline_logged = False    # deadline_missed journaled once
        self.trace = None               # job-root TraceContext (or None)

    @property
    def name(self) -> str:
        return self.spec.name

    @property
    def step(self) -> int:
        return 0 if self.run is None else int(self.run.step)

    @property
    def finished(self) -> bool:
        return self.state in JobState.TERMINAL

    def status(self) -> dict:
        """JSON-able snapshot (the JAX package's `tools jobs status` record)."""
        trips = 0 if self.reports is None and self.run is None else sum(
            1 for r in (self.reports if self.reports is not None
                        else self.run.reports) if not r.ok)
        return {
            "name": self.name, "state": self.state, "nt": int(self.spec.nt),
            "step": self.step, "priority": int(self.spec.priority),
            "deadline_s": self.spec.deadline_s,
            "slices": self.slices,
            "slice_s_total": self.slice_s_total,
            "wait_s_total": self.wait_s_total,
            "admit_s": self.admit_s,
            "guard_trips": trips,
            "submitted_t": self.submitted_t, "started_t": self.started_t,
            "finished_t": self.finished_t, "error": self.error,
        }


# ---------------------------------------------------------------------------
# Built-in model setups (the CLI's JSON-describable jobs)
# ---------------------------------------------------------------------------

def _tuned_knobs(cfg) -> dict:
    """(comm_every, overlap) init keywords from a tuned config (or the
    defaults)."""
    if cfg is None:
        return {"comm_every": 1, "overlap": False}
    return {"comm_every": cfg.comm_every, "overlap": bool(cfg.overlap)}


def _dict_step(names, tuple_step):
    """Adapt a tuple-state local step to the driver's dict-state form."""
    def step(s):
        out = tuple_step(tuple(s[n] for n in names))
        return dict(zip(names, out))
    return step


def _setup_diffusion3d(dtype, cfg=None, members=None):
    from ..models import diffusion_step_local, init_diffusion3d
    from ..models import diffusion as D
    from ..ops.wire import resolve_comm_every

    T, Cp, p = init_diffusion3d(dtype=dtype, **_tuned_knobs(cfg))
    if resolve_comm_every(p.comm_every).deep:
        # the tuned deep cadence: the job's step is the SUPER-STEP
        # (lcm(k_d) physical steps + due-axis exchanges per call) — the
        # JobSpec's nt then counts super-steps
        sstep, _ = D.deep_step(p, members=members)
        return _dict_step(("T", "Cp"), sstep), {"T": T, "Cp": Cp}

    def step(s):
        return {"T": diffusion_step_local(s["T"], s["Cp"], p, "plain",
                                          members=members),
                "Cp": s["Cp"]}

    return step, {"T": T, "Cp": Cp}


def _setup_diffusion2d(dtype, cfg=None, members=None):
    from ..models import diffusion_step_local, init_diffusion2d
    from ..ops.wire import resolve_comm_every

    if cfg is not None and resolve_comm_every(cfg.comm_every).deep:
        raise InvalidArgumentError(
            "diffusion2d jobs do not support a tuned deep comm_every "
            "cadence (the 2-D builtin runs the per-step path).")
    T, Cp, p = init_diffusion2d(dtype=dtype)

    def step(s):
        return {"T": diffusion_step_local(s["T"], s["Cp"], p, "plain",
                                          members=members),
                "Cp": s["Cp"]}

    return step, {"T": T, "Cp": Cp}


def _setup_acoustic3d(dtype, cfg=None, members=None):
    from ..models import acoustic_step_local, init_acoustic3d
    from ..models import acoustic as A
    from ..ops.wire import resolve_comm_every

    state, p = init_acoustic3d(dtype=dtype, **_tuned_knobs(cfg))
    names = ("P", "Vx", "Vy", "Vz")
    if resolve_comm_every(p.comm_every).deep:
        sstep, _ = A.deep_step(p, members=members)
        return _dict_step(names, sstep), dict(zip(names, state))

    def step(s):
        out = acoustic_step_local(tuple(s[n] for n in names), p, "plain",
                                  members=members)
        return dict(zip(names, out))

    return step, dict(zip(names, state))


def _setup_stokes3d(dtype, cfg=None, members=None):
    from ..models import init_stokes3d, stokes_step_local
    from ..models import stokes as S
    from ..ops.wire import resolve_comm_every

    state, p = init_stokes3d(dtype=dtype, **_tuned_knobs(cfg))
    names = ("P", "Vx", "Vy", "Vz", "dVx", "dVy", "dVz", "rhog")
    if resolve_comm_every(p.comm_every).deep:
        sstep, _ = S.deep_step(p, members=members)
        return _dict_step(names, sstep), dict(zip(names, state))

    def step(s):
        out = stokes_step_local(tuple(s[n] for n in names), p, "plain",
                                members=members)
        return dict(zip(names, out))

    return step, dict(zip(names, state))


BUILTIN_MODELS = {
    "diffusion3d": _setup_diffusion3d,
    "diffusion2d": _setup_diffusion2d,
    "acoustic3d": _setup_acoustic3d,
    "stokes3d": _setup_stokes3d,
}


def builtin_setup(model: str, dtype: str = "float32",
                  ensemble: int | None = None, perturb: float = 0.0,
                  tuned=None):
    """A `JobSpec.setup` callable for a built-in model family — what
    a queue's JSON job description builds. The callable
    runs at ADMISSION, under the job's own grid.

    ``ensemble=E`` makes the job a BATCHED one: the state is stacked E
    members deep along a new leading axis (`models.common.ensemble_state`;
    ``perturb`` ramps member m's initial state by ``1 + perturb·m`` — E
    parameter variants of one scenario), and the step function advances
    the whole batch (``members=E`` on the model's plain step) — pair it
    with ``RunSpec(ensemble=E)`` so the scheduler's `ResilientRun` trips
    the guard per member. One admitted job then serves E
    scenario users through one set of collectives, with per-member gauges
    in the job's scoped registry (`hooks.observe_member_health`).

    ``tuned`` (a `telemetry.TunedConfig` / dict / path — pair it with
    ``RunSpec(tuned=...)`` so the driver scopes the wire knobs too)
    applies the auto-tuner's STRUCTURAL knobs at setup: the model is
    built with the tuned ``overlap`` and ``comm_every``; a deep cadence
    makes the job's step the deep-halo SUPER-STEP (one call = the
    cadence cycle of physical steps — size ``nt`` in super-steps and
    init the job's grid with the cadence's ``halowidths[d] =
    depth*k_d`` / ``overlaps[d] = 2*depth*k_d``; the tuned config's
    ``grid.winner`` records exactly that geometry). An unset
    ``ensemble`` argument inherits the tuned one. A tuned config for a
    DIFFERENT model raises — silently applying another family's knobs
    would be a misconfiguration, not a tuning."""
    if model not in BUILTIN_MODELS:
        raise InvalidArgumentError(
            f"Unknown model {model!r}; available: "
            f"{sorted(BUILTIN_MODELS)}.")
    from ..telemetry.tune import resolve_tuned

    cfg = resolve_tuned(tuned)
    if cfg is not None and cfg.model != model:
        raise InvalidArgumentError(
            f"builtin_setup: tuned config is for model {cfg.model!r}, "
            f"job runs {model!r} — refusing to apply another family's "
            "knobs.")
    if ensemble is None and cfg is not None:
        ensemble = cfg.ensemble
    if ensemble is not None and int(ensemble) < 1:
        raise InvalidArgumentError(
            f"builtin_setup: ensemble must be >= 1; got {ensemble}.")
    from ..telemetry.tune import _torch_dtype

    dt = _torch_dtype(dtype)
    members = None if ensemble is None else int(ensemble)

    def setup():
        step, state = BUILTIN_MODELS[model](dt, cfg, members)
        if ensemble is not None:
            from ..models.common import ensemble_state

            state = ensemble_state(state, int(ensemble), perturb=perturb)
        return step, state

    setup.__qualname__ = (
        f"builtin_setup({model!r}, {dtype!r}"
        + (f", ensemble={int(ensemble)}" if ensemble is not None else "")
        + (f", tuned={cfg.comm_every}/{cfg.wire_dtype}"
           if cfg is not None else "")
        + ")")
    return setup


def jobspec_from_json(rec: dict, *, where: str = "job record") -> JobSpec:
    """Build a `JobSpec` from one queue-JSON job record — THE schema of
    the JAX package's ``tools jobs submit`` and ``POST /v1/jobs`` (one code
    path, so the CLI and the HTTP API can never diverge):

        {"name": ..., "model": ..., "nt": ...,         # required
         "grid": {...}, "dtype": "float32",            # optional
         "priority": 1, "deadline_s": ..., "perturb": 0.0,
         "run": {... RunSpec knobs, incl. "tuned"/"ensemble" ...}}

    ``where`` labels errors (a file path, an HTTP request id). Unknown
    top-level keys and unknown ``run`` knobs raise `InvalidArgumentError`
    loudly — a typo'd knob must fail, not silently default."""
    if not isinstance(rec, dict):
        raise InvalidArgumentError(
            f"{where}: a job record must be a JSON object; got "
            f"{type(rec).__name__}.")
    rec = dict(rec)
    # transport envelope, not a job knob: the submit span's W3C header
    # the API stamped into the record (the claiming scheduler reads it
    # off the RAW record; the spec itself stays trace-free)
    rec.pop("traceparent", None)
    missing = [k for k in ("name", "model", "nt") if k not in rec]
    if missing:
        raise InvalidArgumentError(
            f"{where}: missing required key(s) {missing}.")
    run = dict(rec.pop("run", {}) or {})
    # the JAX package's runner-cache key (accepted, no effect here: the
    # port caches no compiled runner); kept so RunSpec.to_json agrees
    run.setdefault("key", ("jobs_cli", rec.get("name")))
    model = rec.pop("model")
    try:
        # a batched job is JSON-describable end-to-end: the RunSpec's
        # ensemble knob also drives the setup's member stacking
        # ("perturb" ramps the members into parameter variants), and a
        # "tuned" path applies the auto-tuner's knob set on both sides —
        # the setup (structural: comm_every/overlap/ensemble) and the
        # driver (trace-time: wire/coalesce env)
        spec = JobSpec(
            name=rec.pop("name"),
            setup=builtin_setup(model,
                                rec.pop("dtype", "float32"),
                                ensemble=run.get("ensemble"),
                                perturb=rec.pop("perturb", 0.0),
                                tuned=run.get("tuned")),
            nt=rec.pop("nt"),
            grid=dict(rec.pop("grid", {}) or {}),
            run=RunSpec(**run),
            priority=rec.pop("priority", 1),
            deadline_s=rec.pop("deadline_s", None),
            model=model)
    except TypeError as e:
        # RunSpec(**run) with an unknown knob — surface it as the typed
        # validation error every caller (CLI exit, HTTP 400) handles
        raise InvalidArgumentError(
            f"{where}: bad 'run' knob set ({e}).") from e
    if rec:  # a typo'd knob must fail, not silently default
        raise InvalidArgumentError(
            f"{where}: job {spec.name!r} has unknown key(s) "
            f"{sorted(rec)} (supervised-run knobs belong inside 'run').")
    return spec
