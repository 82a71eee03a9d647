"""The audit entry points: program -> findings, wired for humans and runs.

Counterpart of `implicitglobalgrid_tpu/analysis/audit.py`:

- `audit_program(src, *args, contract=..., lints=...)` — parse anything
  (`parse_program`'s forms: a dump, a `ProgramIR`, a `record.Recording`,
  or a callable that is run once under the recorder) and run the contract
  and lint checks.
- `audit_model(name, impl=...)` — run ONE step of one model family on a
  fresh state on the CURRENT grid under the recorder (the JAX package
  compiles one step instead), derive its contract from the static plan
  (`model_contract`: `STEP_WORKLOADS` rounds over `halo_comm_plan`), check
  it, and cross-check `telemetry.predict_step`'s collective pricing
  against what the step moved.
- `audit_chunk_program(src, args, names=...)` — the resilient driver's
  audit (`run_resilient(audit=True)`): the recording of the first real
  chunk of each distinct chunk length (no replay and no extra step: the
  driver runs that chunk under the recorder), checked against the guard
  contract (one f32[2N + R] sum) and the lints.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

from ..utils.exceptions import InvalidArgumentError, NotSupportedError
from .contracts import (
    CollectiveContract, SEV_ERROR, SEV_WARNING, axis_routes,
    check_contract, guard_contract, measure_axes, model_contract,
    perfmodel_crosscheck, sort_findings,
)
from .hlo import ProgramIR, parse_program
from .lints import LintConfig, default_lint_config, run_lints
from .record import Recording, record_program

__all__ = ["AuditReport", "audit_program", "audit_model",
           "audit_chunk_program"]


@dataclass(frozen=True)
class AuditReport:
    """One audited program: findings + the collective summary behind them."""

    findings: tuple
    inventory: dict
    collectives: dict
    dialect: str
    contract: CollectiveContract | None = None
    crosscheck: dict | None = None
    meta: dict = dc_field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not any(f.severity == SEV_ERROR for f in self.findings)

    @property
    def errors(self) -> int:
        return sum(1 for f in self.findings if f.severity == SEV_ERROR)

    @property
    def warnings(self) -> int:
        return sum(1 for f in self.findings if f.severity == SEV_WARNING)

    def by_rule(self) -> dict:
        out: dict = {}
        for f in self.findings:
            out[f.rule] = out.get(f.rule, 0) + 1
        return dict(sorted(out.items()))

    def to_json(self) -> dict:
        out = {
            "ok": self.ok,
            "dialect": self.dialect,
            "errors": self.errors,
            "warnings": self.warnings,
            "findings": [f.to_json() for f in self.findings],
            "collectives": self.collectives,
            "inventory": self.inventory,
        }
        if self.crosscheck is not None:
            cc = dict(self.crosscheck)
            cc["findings"] = [f.to_json() for f in cc.get("findings", [])]
            out["crosscheck"] = cc
        if self.meta:
            out["meta"] = self.meta
        return out


def _collective_summary(ir: ProgramIR, routes=None) -> dict:
    out = {
        "permutes": len(ir.permutes),
        "all_reduces": len(ir.all_reduces),
        "all_gathers": len(ir.all_gathers),
        "all_to_alls": len(ir.all_to_alls),
        "wire_bytes": sum(ir.wire_bytes_of(p) for p in ir.permutes),
    }
    if routes:
        # None = a permute whose source_target_pairs match no mesh-axis
        # route; an explicit sentinel keeps the JSON key unambiguous
        out["by_axis"] = {("unattributed" if a is None else str(a)): r
                          for a, r in measure_axes(ir, routes).items()}
    return out


def audit_program(src, *args, contract: CollectiveContract | None = None,
                  lints=None, lint_config: LintConfig | None = None,
                  meta=None) -> AuditReport:
    """Parse ``src`` (a dump, a path to one, a `ProgramIR`, a
    `record.Recording`, or a callable plus example args run once under the
    recorder — see `parse_program`) and audit it.

    ``contract=None`` skips the contract check (lints still run);
    ``lints=None`` runs every rule, ``lints=()`` none, else a tuple of
    rule names from `lints.LINT_RULES`. ``lint_config`` defaults to
    `default_lint_config()` over the live grid when one is initialized
    (grid-free otherwise — the host-only golden-fixture path). A recording
    whose steps moved different ops adds a ``recorded-steps-differ``
    finding (`record.Recording.step_findings`)."""
    findings: list = []
    if callable(src) and not isinstance(src, Recording):
        src = record_program(src, *args)
    if isinstance(src, Recording):
        findings.extend(src.step_findings())
    ir = parse_program(src)
    if contract is not None:
        findings.extend(check_contract(ir, contract))
    if lints is None or lints:
        findings.extend(run_lints(ir, config=lint_config, rules=lints))
    routes = contract.routes if contract is not None else _maybe_routes()
    return AuditReport(
        findings=tuple(sort_findings(findings)),
        inventory=ir.inventory(),
        collectives=_collective_summary(ir, routes),
        dialect=ir.dialect,
        contract=contract,
        meta=dict(meta or {}))


def _maybe_routes():
    from ..parallel.topology import grid_is_initialized

    return axis_routes() if grid_is_initialized() else None


# ---------------------------------------------------------------------------
# model programs

def _model_program(model: str, impl: str, dtype, ensemble=None,
                   comm_every=None):
    """(runner of ONE step, its args, the PHYSICAL state fields in canonical
    order) on a fresh state. With ``ensemble=E`` the runner is the E-member
    batched step and ``args`` the member-stacked tensors — ``fields`` stay
    the per-member state the contracts price. With a deep ``comm_every``
    cadence the runner is ONE deep-halo SUPER-STEP (the grid must carry
    ``depth*k_d``-wide halos per axis); plain route only."""
    from .. import models as M
    from ..models.common import ensemble_state, resolve_comm_every

    cad = resolve_comm_every(comm_every if comm_every is not None else 1)
    if cad.deep and impl not in (None, "plain"):
        raise InvalidArgumentError(
            f"audit_model: impl={impl!r} is incompatible with "
            f"comm_every={cad} (deep-halo stepping runs only the plain "
            "route — the same rule the runners enforce).")
    ce = str(cad)
    if model in ("diffusion3d", "diffusion2d"):
        ndim = 3 if model.endswith("3d") else 2
        if cad.deep:
            if ndim == 3:
                T, Cp, p = M.init_diffusion3d(dtype=dtype, comm_every=ce)
            else:
                import dataclasses

                T, Cp, p = M.init_diffusion2d(dtype=dtype)
                p = dataclasses.replace(p, comm_every=ce)
            run = M.make_run_deep(p, 1, ndim=ndim, ensemble=ensemble)
        else:
            init = M.init_diffusion3d if ndim == 3 else M.init_diffusion2d
            T, Cp, p = init(dtype=dtype)
            run = M.make_run(p, 1, ndim=ndim, impl=impl, ensemble=ensemble)
        args = (T, Cp)
    elif model == "acoustic3d":
        if cad.deep:
            state, p = M.init_acoustic3d(dtype=dtype, comm_every=ce)
            run = M.make_acoustic_run_deep(p, 1, ensemble=ensemble)
        else:
            state, p = M.init_acoustic3d(dtype=dtype)
            run = M.make_acoustic_run(p, 1, impl=impl, ensemble=ensemble)
        args = tuple(state)
    elif model == "stokes3d":
        if cad.deep:
            state, p = M.init_stokes3d(dtype=dtype, comm_every=ce)
            run = M.make_stokes_run_deep(p, 1, ensemble=ensemble)
        else:
            state, p = M.init_stokes3d(dtype=dtype)
            run = M.make_stokes_run(p, 1, impl=impl, ensemble=ensemble)
        args = tuple(state)
    else:
        raise InvalidArgumentError(
            f"audit_model: unknown model {model!r} (have diffusion3d, "
            "diffusion2d, acoustic3d, stokes3d).")
    fields = args
    if ensemble is not None:
        args = tuple(ensemble_state(args, int(ensemble)))
    return run, args, fields


def _rounds_impl(model: str, impl: str, fields) -> str:
    """The route whose exchange ROUNDS the recorded step actually ran.

    A ``"cuda"`` request takes the plain route where the fused kernel's
    gate refuses the grid or the state (`wave_exchange_modes` /
    `stokes_exchange_modes`, e.g. halowidth != 1), and the contract must
    follow it: pricing the fused rounds against a plain-route step would
    fail a healthy step."""
    if impl != "cuda":
        return impl
    from ..parallel.topology import global_grid

    gg = global_grid()
    local = [tuple(int(s) // int(gg.box[d]) if d < 3 else int(s)
                   for d, s in enumerate(f.shape)) for f in fields]
    if model == "acoustic3d":
        from ..ops.cuda_wave import wave_exchange_modes

        if wave_exchange_modes(gg, local) is None:
            return "plain"
    elif model == "stokes3d":
        from ..ops.cuda_stokes import stokes_exchange_modes

        if stokes_exchange_modes(gg, local, fields[0].dtype) is None:
            return "plain"
    # diffusion's fused rounds equal the plain rounds, so its fallbacks
    # never change the contract
    return impl


def audit_model(model: str, *, impl: str = "plain", dtype=None,
                wire_dtype=None, wire_stage=None, lints=None,
                crosscheck: bool = True,
                ensemble: int | None = None,
                comm_every=None) -> AuditReport:
    """Run ONE step of one model family on a fresh state on the CURRENT
    grid (its device) under the recorder, and audit what it moved against
    its plan-derived contract.

    ``impl`` is the port's route: ``"cuda"`` (the fused kernel routes: K4s
    + K4, K4s + K9, K4s + K10; their slab pipeline records the canonical
    packed wire, one permute pair per mesh axis and round) or ``"plain"``
    (`local_update_halo`'s tiers). It selects the exchange ROUNDS the
    contract prices (`StepWorkload.groups_for`): the fused acoustic pass
    packs all four fields into one round where the plain leapfrog does
    two. ``crosscheck`` additionally proves that the perf oracle's priced
    permute pairs and wire bytes equal the recorded ones.

    ``wire_dtype`` is applied to BOTH sides: the step (scoped
    ``IGG_HALO_WIRE_DTYPE``, restored after, never leaked) and the
    expectation (contract payload dtypes, wire bytes, lint config,
    crosscheck pricing). The recording holds the payloads in their wire
    format, so no lowered-module fallback is needed.

    ``comm_every`` (a deep per-axis cadence) records ONE deep-halo
    SUPER-STEP instead of a step: its per-axis permute counts and k_d-wide
    payload bytes must equal the super-cycle contract. The grid must carry
    the cadence's halo geometry; plain route only. ``ensemble=E`` records
    the E-member batched step: the same permute counts as one member, E x
    the bytes.

    ``wire_stage`` raises `NotSupportedError`: the port's transport does
    not stage (a staged axis moves the flat exchange, ROADMAP Queue A item
    8), so a recording cannot show staged routes."""
    import os

    from ..models.common import resolve_comm_every
    from ..ops.wire import dtype_name, resolve_wire_stage
    from ..parallel.topology import check_initialized

    check_initialized()
    if resolve_wire_stage(wire_stage if wire_stage is not None else "off") is not None:
        raise NotSupportedError(
            "audit_model(wire_stage=...): the port's transport does not stage a "
            "wire (ROADMAP Queue A item 8), so its recording holds the flat "
            "exchange and cannot show the staged routes.")
    if dtype is None:
        import torch

        dtype = torch.float32
    meta = {"model": model, "impl": impl}
    cad = resolve_comm_every(comm_every if comm_every is not None else 1)
    if cad.deep:
        meta["comm_every"] = str(cad)
    if ensemble is not None:
        ensemble = int(ensemble)
        meta["ensemble"] = ensemble
    saved_wire = os.environ.get("IGG_HALO_WIRE_DTYPE")
    try:
        if wire_dtype is not None:
            from ..ops.precision import resolve_wire_dtype

            policy = resolve_wire_dtype(wire_dtype)
            # the canonical policy string: every accepted form round-trips
            # through the variable the exchange resolves at call time
            os.environ["IGG_HALO_WIRE_DTYPE"] = "off" if policy is None else str(policy)
        runner, args, fields = _model_program(model, impl, dtype, ensemble=ensemble,
                                              comm_every=comm_every)
        rec = record_program(runner, *args)
    finally:
        if saved_wire is None:
            os.environ.pop("IGG_HALO_WIRE_DTYPE", None)
        else:
            os.environ["IGG_HALO_WIRE_DTYPE"] = saved_wire
    from ..telemetry.perfmodel import STEP_WORKLOADS

    rounds_impl = impl if cad.deep else _rounds_impl(model, impl, fields)
    if rounds_impl != impl:
        meta["rounds_impl"] = (
            f"{rounds_impl} (the fused kernel's gate refused this grid or state; "
            "the step took the plain route and the contract follows it)")
    contract = None
    if model in STEP_WORKLOADS:
        contract = model_contract(model, fields, wire_dtype=wire_dtype,
                                  impl=rounds_impl, ensemble=ensemble,
                                  comm_every=comm_every)
    cfg = default_lint_config(state_dtypes={dtype_name(f.dtype) for f in fields},
                              wire_dtype=wire_dtype)
    rep = audit_program(rec, contract=contract, lints=lints,
                        lint_config=cfg, meta=meta)
    cc = None
    if crosscheck and model in STEP_WORKLOADS:
        cc = perfmodel_crosscheck(model, fields, rec.program(),
                                  wire_dtype=wire_dtype, impl=rounds_impl,
                                  ensemble=ensemble, comm_every=comm_every)
    if cc is None:
        return rep
    return AuditReport(
        findings=tuple(sort_findings(list(rep.findings)
                                     + list(cc["findings"]))),
        inventory=rep.inventory, collectives=rep.collectives,
        dialect=rep.dialect, contract=rep.contract, crosscheck=cc,
        meta=rep.meta)


# ---------------------------------------------------------------------------
# the driver's audit

def audit_chunk_program(src, args=(), *, names, reducer_floats: int = 0,
                        contract: CollectiveContract | None = None,
                        lints=None,
                        ensemble: int | None = None) -> AuditReport:
    """Audit one chunk of a resilient run: ``src`` is the `record.Recording`
    of the chunk (the driver runs its first real chunk of each distinct
    length under `record.recording()`), or a chunk runner, then run ONCE on
    ``args`` under the recorder (its output is dropped). ``args`` are the
    chunk's state tensors (their dtypes feed the f64 lint). The default
    contract is the structural guard one (`guard_contract`): exactly one
    f32[2N + R] sum, no gathers; ``ensemble=E`` widens it to the batched
    ``f32[E·(2N + R)]`` stats (still one all-reduce). The recorded steps
    must agree (`record.Recording.step_findings`); the contract sees the
    first step's collectives and the chunk's sum."""
    from ..ops.wire import dtype_name

    if contract is None:
        contract = guard_contract(len(tuple(names)), reducer_floats,
                                  ensemble=ensemble)
    if not isinstance(src, Recording):
        if not callable(src):
            raise InvalidArgumentError(
                "audit_chunk_program expects a record.Recording or a chunk runner.")
        src = record_program(src, *args)
    state_dtypes = {dtype_name(a.dtype) for a in args if hasattr(a, "dtype")}
    cfg = default_lint_config(state_dtypes=state_dtypes)
    return audit_program(src, contract=contract, lints=lints, lint_config=cfg,
                         meta={"program": "chunk", "names": list(names),
                               "steps": len(src.steps()),
                               **({"ensemble": int(ensemble)} if ensemble else {})})
