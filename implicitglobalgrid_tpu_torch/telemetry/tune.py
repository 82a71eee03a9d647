"""The closed-loop auto-tuner: search the oracle, validate, persist, apply.

Counterpart of `implicitglobalgrid_tpu/telemetry/tune.py`, whole.
`tune_config` SEARCHES the cost model (`predict_step` over a
`MachineProfile`) over per-axis ``comm_every`` x per-axis ``wire_dtype`` x
per-axis ``wire_stage`` x ``coalesce`` x ``overlap`` x ensemble ``E``,
VALIDATES the top candidates with short measured runs (min-of-reps
two-point windows, the estimator `calibrate_machine` uses), and persists
the winning `TunedConfig` JSON (the JAX package's record) next to the
machine profile, where `runtime.RunSpec(tuned=...)` loads and applies it.

The search holds the implicit GLOBAL grid fixed: a deep cadence candidate
is priced and measured on the grid it needs (``depth * k_d``-wide halos and
correspondingly LARGER local blocks), so the wider slabs' compute is
priced as the cost it is.

The measured candidates run the port's models on their plain route, whose
exchange runs the halo kernels (K8 + K7 for a coalesced group, else K6, K2
or K3, as `ops.halo.halo_routes` picks): the JAX package prices and
measures its ``"xla"`` tier, and the plain route is its counterpart. The
knobs reach the exchange through the environment variables the port reads
(``IGG_HALO_WIRE_DTYPE``, ``IGG_HALO_WIRE_STAGE``, ``IGG_HALO_COALESCE``;
`_scoped_env`).

`tune_config` owns its grids (the measured candidates need different halo
geometries): it swaps the caller's grid aside (`topology.swap_global_grid`,
its epoch retained so its caches survive) and restores it on exit.
"""

from __future__ import annotations

import itertools
import json
import os
import time
from dataclasses import dataclass, field as dc_field, replace
from typing import Any, NamedTuple

from ..utils.exceptions import InvalidArgumentError

__all__ = ["TunedConfig", "tune_config", "save_tuned_config",
           "load_tuned_config", "resolve_tuned", "tuned_config_path"]

_TUNED_VERSION = 1

# per-model measured-run support: canonical state staggering (offsets
# added to the local block shape per field, in state order) — the shapes
# `predict_step` prices candidates with
_MODEL_STAGGER = {
    "diffusion3d": ((0, 0, 0),) * 2,
    "acoustic3d": ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1)),
    "stokes3d": ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1),
                 (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)),
}
_DIM_NAMES = ("x", "y", "z")


@dataclass(frozen=True)
class TunedConfig:
    """One model family's winning knob set on one machine/mesh geometry.

    The knobs are exactly the surface the runtime applies per job:
    ``comm_every`` (canonical per-axis cadence string), ``wire_dtype``
    (canonical per-axis wire policy, or ``None`` = exact),
    ``wire_stage`` (canonical per-axis topology-staged wire policy, or
    ``None`` = flat), ``coalesce``, ``overlap``, and ``ensemble``
    (``None`` = solo). ``predicted_step_s``
    is the oracle's per-(member-)step price; ``measured_step_s`` /
    ``baseline_step_s`` are the calibration-run numbers when the tuner
    measured (``speedup`` = baseline / measured — >= 1.0 by
    construction, the default config is always in the measured set).
    ``grid`` records the geometry the config was tuned FOR (dims,
    periods, base local size, and the cadence's overlaps/halowidths);
    ``meta`` the search accounting (candidates priced/measured/skipped,
    search wall time)."""

    model: str
    comm_every: str = "1"
    wire_dtype: str | None = None
    wire_stage: str | None = None
    coalesce: bool = True
    overlap: bool = False
    ensemble: int | None = None
    predicted_step_s: float | None = None
    measured_step_s: float | None = None
    baseline_step_s: float | None = None
    speedup: float | None = None
    profile_source: str | None = None
    grid: dict = dc_field(default_factory=dict)
    meta: dict = dc_field(default_factory=dict)

    def knobs(self) -> dict:
        """The applied-surface subset, as one dict."""
        return {"comm_every": self.comm_every,
                "wire_dtype": self.wire_dtype,
                "wire_stage": self.wire_stage,
                "coalesce": self.coalesce, "overlap": self.overlap,
                "ensemble": self.ensemble}

    def env(self) -> dict:
        """The environment-variable form of the trace-time knobs — what
        the driver scopes around a tuned run's chunks
        (``IGG_COMM_EVERY`` / ``IGG_HALO_WIRE_DTYPE`` /
        ``IGG_HALO_COALESCE``, plus ``IGG_HALO_WIRE_STAGE`` when the
        tuner selected staging; ``overlap`` and ``ensemble`` are
        structural and applied at setup time instead)."""
        env = {"IGG_COMM_EVERY": str(self.comm_every),
               "IGG_HALO_WIRE_DTYPE": (self.wire_dtype or "off"),
               "IGG_HALO_COALESCE": "1" if self.coalesce else "0"}
        if self.wire_stage is not None:
            env["IGG_HALO_WIRE_STAGE"] = str(self.wire_stage)
        return env

    def to_json(self) -> dict:
        return {"version": _TUNED_VERSION, "model": self.model,
                "comm_every": self.comm_every,
                "wire_dtype": self.wire_dtype,
                "wire_stage": self.wire_stage,
                "coalesce": self.coalesce, "overlap": self.overlap,
                "ensemble": self.ensemble,
                "predicted_step_s": self.predicted_step_s,
                "measured_step_s": self.measured_step_s,
                "baseline_step_s": self.baseline_step_s,
                "speedup": self.speedup,
                "profile_source": self.profile_source,
                "grid": self.grid, "meta": self.meta}

    @classmethod
    def from_json(cls, rec) -> "TunedConfig":
        if isinstance(rec, (str, bytes)):
            rec = json.loads(rec)
        try:
            return cls(
                model=str(rec["model"]),
                comm_every=str(rec.get("comm_every", "1")),
                wire_dtype=rec.get("wire_dtype"),
                wire_stage=rec.get("wire_stage"),
                coalesce=bool(rec.get("coalesce", True)),
                overlap=bool(rec.get("overlap", False)),
                ensemble=(None if rec.get("ensemble") is None
                          else int(rec["ensemble"])),
                predicted_step_s=rec.get("predicted_step_s"),
                measured_step_s=rec.get("measured_step_s"),
                baseline_step_s=rec.get("baseline_step_s"),
                speedup=rec.get("speedup"),
                profile_source=rec.get("profile_source"),
                grid=dict(rec.get("grid", {})),
                meta=dict(rec.get("meta", {})))
        except (KeyError, TypeError, ValueError) as e:
            raise InvalidArgumentError(
                f"TunedConfig.from_json: malformed record ({e}).") from e


def save_tuned_config(cfg: TunedConfig, path) -> str:
    """Persist a tuned config as JSON (the file `load_tuned_config`, the
    and `RunSpec(tuned=...)` exchange; the JAX package's format)."""
    path = os.fspath(path)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(cfg.to_json(), f, indent=1)
    return path


def load_tuned_config(path) -> TunedConfig:
    path = os.fspath(path)
    try:
        with open(path, encoding="utf-8") as f:
            rec = json.load(f)
    except (OSError, ValueError) as e:
        raise InvalidArgumentError(
            f"load_tuned_config: cannot read {path}: {e}") from e
    return TunedConfig.from_json(rec)


def tuned_config_path(profile_path, model: str) -> str:
    """The canonical on-disk home of a model's tuned config: NEXT TO the
    machine profile it was searched against
    (``<profile dir>/tuned_<model>.json``)."""
    base = os.path.dirname(os.fspath(profile_path))
    return os.path.join(base, f"tuned_{model}.json")


def resolve_tuned(tuned) -> TunedConfig | None:
    """Normalize every accepted `RunSpec.tuned` form: ``None`` passes
    through, a `TunedConfig` is returned as-is, a dict parses as its
    JSON record, and a string/path loads the persisted file."""
    if tuned is None or isinstance(tuned, TunedConfig):
        return tuned
    if isinstance(tuned, dict):
        return TunedConfig.from_json(tuned)
    if isinstance(tuned, (str, os.PathLike)):
        return load_tuned_config(tuned)
    raise InvalidArgumentError(
        f"tuned must be a TunedConfig, its JSON dict, or a path; got "
        f"{type(tuned).__name__}.")


# ---------------------------------------------------------------------------
# the search
# ---------------------------------------------------------------------------

def _grid_geometry(grid: dict) -> tuple:
    """(base local n, base overlaps, dims-ish kwargs) from the user's
    `init_global_grid` keyword dict."""
    g = dict(grid)
    try:
        n = (int(g.pop("nx")), int(g.pop("ny")), int(g.pop("nz")))
    except KeyError as e:
        raise InvalidArgumentError(
            f"tune_config: grid needs nx/ny/nz ({e} missing).") from e
    ol = g.pop("overlaps", (2, 2, 2))
    ol = tuple(int(o) for o in (ol if hasattr(ol, "__len__")
                                else (ol,) * 3))
    g.pop("halowidths", None)  # derived per candidate
    return n, ol, g


def _candidate_grid(n_base, ol_base, rest: dict, cad, depth: int) -> dict:
    """`init_global_grid` kwargs for one cadence candidate, holding the
    IMPLICIT GLOBAL GRID fixed: per dim, ``n - ol`` is invariant, so a
    deeper overlap grows the local block by exactly the extra overlap —
    the honest compute cost of the wider slabs."""
    if cad.deep:
        hw = tuple(depth * cad.for_dim(d) for d in range(3))
        ol = tuple(2 * h for h in hw)
    else:
        hw = None  # grid default (min(1, ol//2)-ish) — the base geometry
        ol = ol_base
    n = tuple(nb - ob + o for nb, ob, o in zip(n_base, ol_base, ol))
    kw = dict(rest, nx=n[0], ny=n[1], nz=n[2], overlaps=ol, quiet=True)
    if hw is not None:
        kw["halowidths"] = hw
    return kw


def _grid_ok(kw: dict) -> bool:
    """Host-side feasibility of a candidate grid (mirrors the
    `init_global_grid` coherence checks plus `validate_deep_halo`'s
    freshness bound, so an infeasible cadence is a SKIPPED candidate,
    not a crash mid-search)."""
    n = (kw["nx"], kw["ny"], kw["nz"])
    ol = kw["overlaps"]
    hw = kw.get("halowidths", (0, 0, 0))
    periods = (kw.get("periodx", 0), kw.get("periody", 0),
               kw.get("periodz", 0))
    for d in range(3):
        if n[d] < 2:
            return False
        if periods[d] and n[d] < 2 * ol[d] - 1:
            return False
        if n[d] < ol[d] + hw[d]:  # deep send slabs must stay fresh
            return False
    return True


class _Spec(NamedTuple):
    """A field's stacked shape and dtype, for pricing: nothing is
    allocated (the JAX package's `jax.ShapeDtypeStruct`)."""
    shape: tuple
    dtype: Any


def _torch_dtype(dtype):
    """A torch dtype from its name (the JAX package's ``dtype="float32"``)
    or as it is."""
    from ..ops.wire import _torch_dtype as by_name

    return by_name(dtype) if isinstance(dtype, str) else dtype


def _model_fields(model: str, gg, hw, dtype):
    """Stacked state specs (with per-field halowidths) for pricing."""
    stagger = _MODEL_STAGGER[model]
    box = tuple(int(d) for d in gg.box)
    n = tuple(int(v) for v in gg.nxyz)
    out = []
    for offs in stagger:
        # staggered fields are local n+1 a block, stacked box*(n+1) (how
        # init_* builds them: zeros_g of the staggered local shape)
        shape = tuple(box[d] * (n[d] + offs[d]) for d in range(3))
        sds = _Spec(shape, _torch_dtype(dtype))
        out.append((sds, tuple(hw)) if hw is not None else sds)
    return tuple(out)


def _scoped_env(env: dict):
    """Context manager setting/restoring environment variables (the
    trace-time knob scope — also used by the driver's tuned apply)."""
    import contextlib

    @contextlib.contextmanager
    def scope():
        saved = {k: os.environ.get(k) for k in env}
        try:
            for k, v in env.items():
                os.environ[k] = str(v)
            yield
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    return scope()


def _build_runner(model: str, cand: dict, dtype):
    """(state tuple, runner_factory(nt_chunk), physical steps per
    chunk-unit) under the CURRENT grid for one measured candidate: the
    plain route (the JAX package's ``"xla"``), or the deep runner."""
    from .. import models as M
    from ..models.common import ensemble_state
    from ..ops.wire import resolve_comm_every

    dtype = _torch_dtype(dtype)
    cad = resolve_comm_every(cand["comm_every"])
    E = cand.get("ensemble")
    if model == "diffusion3d":
        T, Cp, p = M.init_diffusion3d(dtype=dtype,
                                      comm_every=cand["comm_every"],
                                      overlap=cand["overlap"])
        state = (T, Cp)
        if cad.deep:
            factory = (lambda c: M.make_run_deep(p, c, ensemble=E))
        else:
            factory = (lambda c: M.make_run(p, c, impl="plain", ensemble=E))
    elif model == "acoustic3d":
        state, p = M.init_acoustic3d(dtype=dtype,
                                     comm_every=cand["comm_every"],
                                     overlap=cand["overlap"])
        if cad.deep:
            factory = (lambda c: M.make_acoustic_run_deep(p, c, ensemble=E))
        else:
            factory = (lambda c: M.make_acoustic_run(p, c, impl="plain",
                                                     ensemble=E))
    elif model == "stokes3d":
        state, p = M.init_stokes3d(dtype=dtype,
                                   comm_every=cand["comm_every"],
                                   overlap=cand["overlap"])
        if cad.deep:
            factory = (lambda c: M.make_stokes_run_deep(p, c, ensemble=E))
        else:
            factory = (lambda c: M.make_stokes_run(p, c, impl="plain",
                                                   ensemble=E))
    else:
        raise InvalidArgumentError(
            f"tune_config: unsupported model {model!r} (have "
            f"{sorted(_MODEL_STAGGER)}).")
    if E:
        state = ensemble_state(state, int(E))
    per_unit = cad.cycle if cad.deep else 1
    return tuple(state), factory, per_unit


def _measure_candidate(model: str, cand: dict, grid_kw: dict, dtype,
                       c1: int, reps: int) -> float:
    """Measured per-(member-)step seconds of one candidate on its own
    grid: min-of-``reps`` two-point windows (`calibrate._two_point`, the
    estimator `calibrate_machine` uses) over whole chunks, each ending in
    `utils.timing.sync`."""
    from ..parallel.grid import finalize_global_grid, init_global_grid
    from ..utils.timing import sync
    from .calibrate import _two_point

    init_global_grid(**grid_kw)
    try:
        with _scoped_env({
                "IGG_HALO_WIRE_DTYPE": cand["wire_dtype"] or "off",
                "IGG_HALO_WIRE_STAGE": cand.get("wire_stage") or "off",
                "IGG_HALO_COALESCE": "1" if cand["coalesce"] else "0"}):
            state, factory, per_unit = _build_runner(model, cand, dtype)

            def chunk(c):
                sync(factory(c)(*state))

            sec_per_unit = _two_point(chunk, c1, 3 * c1, reps=reps)
        E = cand.get("ensemble") or 1
        return sec_per_unit / per_unit / E
    finally:
        finalize_global_grid()


def _default_comm_every_options(dims, periods) -> tuple:
    """The default cadence candidates: exchange-every-step, the uniform
    deep cadence, and each EXCHANGING axis's solo cadence (the per-axis
    win the tuner exists to find)."""
    opts = ["1", "2"]
    for d in range(3):
        if int(dims[d]) > 1 or int(periods[d]):
            opts.append(f"{_DIM_NAMES[d]}:2")
    return tuple(opts)


def tune_config(model: str, grid: dict, profile=None, *,
                dtype="float32",
                comm_every_options=None, wire_dtype_options=(None,),
                wire_stage_options=(None,),
                coalesce_options=(True,), overlap_options=(False,),
                ensemble_options=(None,),
                top_k: int = 2, measure: bool = True,
                measure_steps: int = 4, reps: int = 3,
                path=None) -> TunedConfig:
    """Search -> validate -> persist one model family's knob set.

    ``grid`` is the BASE geometry as `init_global_grid` keywords (nx/ny/
    nz + dims/periods; ``overlaps`` defaults to the grid default) — the
    implicit GLOBAL grid it describes is held fixed across candidates,
    so a deep cadence pays its honest slab-width compute. ``profile`` is
    a `MachineProfile` or a path to one (`calibrate_machine` output);
    a path also sets the default persist location
    (`tuned_config_path`). The candidate space is the cross product of
    the ``*_options`` (defaults: cadences from
    `_default_comm_every_options`, exact wire, coalescing on, overlap
    off, solo) minus infeasible combos (deep cadence x overlap — the
    runners ignore overlap under a cadence; grids the geometry cannot
    carry). Every candidate is priced with `predict_step` on its OWN
    grid geometry; with ``measure=True`` the ``top_k`` predicted (plus
    the all-defaults baseline) are validated with short measured
    calibration runs and the MEASURED winner is returned —
    ``speedup = baseline_step_s / measured_step_s`` is >= 1.0 by
    construction since the baseline is always in the measured set.

    `tune_config` owns grid lifecycle: any live grid is swapped aside
    (epoch retained, so its caches survive) and restored on
    exit; candidate grids are initialized and finalized internally.
    Returns the winning `TunedConfig` (persisted when ``path`` or a
    profile path was given).

    ``wire_stage_options`` adds the topology-staged wire to the
    search: a ``"z:staged"`` candidate reroutes the z exchange as ICI
    leader-gather -> one striped DCN transfer per granule pair -> ICI
    scatter. It is priced per stage against each stage's own link class,
    so it only ranks ahead of flat where the profile is genuinely
    hierarchical — and with ``measure=True`` it must ALSO win the
    measured validation leg before `tune_config` selects it (model and
    measurement have to agree)."""
    from ..ops.wire import resolve_comm_every
    from ..parallel import topology as top
    from ..parallel.grid import finalize_global_grid, init_global_grid
    from .perfmodel import (
        STEP_WORKLOADS, default_machine_profile, load_machine_profile,
    )

    if model not in _MODEL_STAGGER:
        raise InvalidArgumentError(
            f"tune_config: unsupported model {model!r} (have "
            f"{sorted(_MODEL_STAGGER)}).")
    work = STEP_WORKLOADS[model]
    profile_path = None
    if isinstance(profile, (str, os.PathLike)):
        profile_path = os.fspath(profile)
        profile = load_machine_profile(profile_path)
    t0 = time.time()
    n_base, ol_base, rest = _grid_geometry(grid)
    dims = [int(rest.get(k, 0)) for k in ("dimx", "dimy", "dimz")]
    periods = [int(rest.get(k, 0))
               for k in ("periodx", "periody", "periodz")]
    if comm_every_options is None:
        comm_every_options = _default_comm_every_options(dims, periods)

    # candidate space (canonical cadence/stage strings de-dup spellings)
    from ..ops.wire import resolve_wire_stage

    cands = []
    seen = set()
    for ce, wd, ws, co, ov, E in itertools.product(
            comm_every_options, wire_dtype_options, wire_stage_options,
            coalesce_options, overlap_options, ensemble_options):
        cad = resolve_comm_every(ce)
        if cad.deep and ov:
            continue  # the deep runners ignore overlap — not a real combo
        # canonicalize the stage spelling without the env fallback
        # (resolve_wire_stage(None) reads IGG_HALO_WIRE_STAGE — a tune
        # candidate's None means FLAT, not "whatever the env says")
        stg = None if ws is None else resolve_wire_stage(ws)
        stg = None if stg is None else str(stg)
        key = (str(cad), wd, stg, bool(co), bool(ov),
               None if E is None else int(E))
        if key in seen:
            continue
        seen.add(key)
        cands.append({"comm_every": str(cad), "wire_dtype": wd,
                      "wire_stage": stg,
                      "coalesce": bool(co), "overlap": bool(ov),
                      "ensemble": None if E is None else int(E)})
    default_cand = {"comm_every": "1", "wire_dtype": None,
                    "wire_stage": None,
                    "coalesce": True, "overlap": False, "ensemble": None}
    if not any(c == default_cand for c in cands):
        cands.insert(0, dict(default_cand))

    prev = top.swap_global_grid(None)
    if prev is not None:
        top.retain_epoch(prev.epoch)
    priced, skipped = [], []
    try:
        # ---- phase 1: price every candidate on its own geometry -------
        by_geom: dict = {}
        for c in cands:
            cad = resolve_comm_every(c["comm_every"])
            kw = _candidate_grid(n_base, ol_base, rest, cad,
                                 work.deep_halo_depth)
            if not _grid_ok(kw):
                skipped.append({**c, "reason": "infeasible grid"})
                continue
            by_geom.setdefault(
                (kw["nx"], kw["ny"], kw["nz"], tuple(kw["overlaps"]),
                 tuple(kw.get("halowidths", ()))), (kw, []))[1].append(c)
        from .perfmodel import predict_step

        prof = profile
        for kw, group in by_geom.values():
            init_global_grid(**kw)
            try:
                gg = top.global_grid()
                if prof is None:  # grid-derived default coefficients
                    prof = default_machine_profile()
                hw = tuple(int(h) for h in gg.halowidths)
                fields = _model_fields(model, gg, hw, dtype)
                for c in group:
                    pred = predict_step(
                        model, fields, profile=prof,
                        comm_every=c["comm_every"],
                        overlap=c["overlap"], coalesce=c["coalesce"],
                        wire_dtype=c["wire_dtype"],
                        wire_stage=c["wire_stage"],
                        ensemble=c["ensemble"])
                    E = c["ensemble"] or 1
                    priced.append((pred["step_s"] / E, c, pred, dict(kw)))
            finally:
                finalize_global_grid()
        if not priced:
            raise InvalidArgumentError(
                "tune_config: every candidate was infeasible on this "
                f"grid geometry ({grid!r}) — nothing to tune.")
        if measure and not any(t[1] == default_cand for t in priced):
            # the >= 1.0 speedup guarantee hinges on the measured set
            # containing the all-defaults baseline — a base geometry
            # that cannot even run the default config is a caller
            # error, not a StopIteration deep in phase 2
            raise InvalidArgumentError(
                "tune_config: the base grid geometry cannot run the "
                f"default (cadence-1) configuration ({grid!r} — see "
                "meta would-be 'skipped'); fix the base nx/ny/nz/"
                "overlaps or pass measure=False for a model-only "
                "search.")
        priced.sort(key=lambda t: t[0])

        # ---- phase 2: measured validation of the top candidates -------
        measured = []
        if measure:
            chosen = [t for t in priced[:max(1, int(top_k))]]
            if not any(t[1] == default_cand for t in chosen):
                base_t = next(t for t in priced if t[1] == default_cand)
                chosen.append(base_t)
            for pred_s, c, pred, kw in chosen:
                s = _measure_candidate(model, c, kw, dtype,
                                       c1=max(1, int(measure_steps)),
                                       reps=max(1, int(reps)))
                measured.append((s, pred_s, c, pred, kw))
            measured.sort(key=lambda t: t[0])
            win_s, win_pred_s, win_c, win_pred, win_kw = measured[0]
            base_s = next(t[0] for t in measured if t[2] == default_cand)
        else:
            win_pred_s, win_c, win_pred, win_kw = priced[0]
            win_s = base_s = None
    finally:
        if prev is not None:
            top.swap_global_grid(prev)
            top.release_epoch(prev.epoch)

    cfg = TunedConfig(
        model=model,
        comm_every=win_c["comm_every"],
        wire_dtype=win_c["wire_dtype"],
        wire_stage=win_c["wire_stage"],
        coalesce=win_c["coalesce"],
        overlap=win_c["overlap"],
        ensemble=win_c["ensemble"],
        predicted_step_s=float(win_pred["step_s"])
        / (win_c["ensemble"] or 1),
        measured_step_s=win_s,
        baseline_step_s=base_s,
        speedup=(None if win_s is None
                 else (base_s / win_s if win_s > 0 else 1.0)),
        profile_source=win_pred["profile_source"],
        grid={"base": dict(grid), "winner": {
            k: (list(v) if isinstance(v, tuple) else v)
            for k, v in win_kw.items()}},
        meta={"candidates": len(cands), "priced": len(priced),
              "measured": len(measured) if measure else 0,
              "skipped": skipped,
              "ranking": [
                  {"score_s": s, **c} for s, c, _, _ in priced[:8]],
              "search_s": time.time() - t0,
              "tuned_at": t0})
    if path is None and profile_path is not None:
        path = tuned_config_path(profile_path, model)
    if path is not None:
        save_tuned_config(cfg, path)
        cfg = replace(cfg, meta=dict(cfg.meta, path=os.fspath(path)))
    return cfg
