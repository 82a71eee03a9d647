"""Collective contracts: the static wire plan as a checkable declaration.

The port's copy of `implicitglobalgrid_tpu/analysis/contracts.py`. The
halo layer's `halo_comm_plan` prices every exchange from shapes, overlaps
and the wire dtype alone, and the perf oracle's `STEP_WORKLOADS` records
how each model's step groups its exchange rounds. This module turns those
inputs into a `CollectiveContract` (per-axis permute counts, on-wire
dtypes, exact wire bytes, the legal routes of each mesh axis, the payload
bound and the guard sum's shape), and `check_contract` verifies a
`ProgramIR` against it, yielding structured `AuditFinding`s: a JAX dump
parsed by `hlo.parse_text`, or the port's own traffic recorded by
`record.recording`. The two packages derive byte-equal contracts for the
same grid and fields.

Because the contract and `telemetry.predict_step` price from the SAME
plan, `perfmodel_crosscheck` closes the loop: the oracle's priced permute
pairs and wire bytes must equal what the program moves.

Route attribution: a permute's ``source_target_pairs`` are linearized mesh
positions (row-major over ``gg.dims``), so the legal pair sets per (axis,
direction) follow from `parallel.topology.axis_perm_pairs` and the dims
alone (`axis_routes`, through `record.linear_pairs`, the recorder's own
pair generator). A permute whose pair set matches no axis is an error
finding by itself: an unplanned communication route.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field as dc_field

import numpy as np

from ..utils.exceptions import InvalidArgumentError
from .hlo import ProgramIR
from .record import hlo_dtype, linear_pairs

__all__ = ["AuditFinding", "CollectiveContract", "axis_routes",
           "measure_axes", "exchange_contract", "model_contract",
           "guard_contract", "check_contract", "perfmodel_crosscheck"]

SEV_ERROR, SEV_WARNING, SEV_INFO = "error", "warning", "info"
_SEV_ORDER = {SEV_ERROR: 0, SEV_WARNING: 1, SEV_INFO: 2}


@dataclass(frozen=True)
class AuditFinding:
    """One structured audit result (a broken rule, or a notable fact)."""

    rule: str
    severity: str             # "error" | "warning" | "info"
    message: str
    op: str | None = None     # SSA name of the op the finding anchors to
    computation: str | None = None
    details: dict = dc_field(default_factory=dict)

    def to_json(self) -> dict:
        out = {"rule": self.rule, "severity": self.severity,
               "message": self.message}
        if self.op is not None:
            out["op"] = self.op
        if self.computation is not None:
            out["computation"] = self.computation
        if self.details:
            out["details"] = self.details
        return out


def sort_findings(findings) -> list:
    return sorted(findings,
                  key=lambda f: (_SEV_ORDER.get(f.severity, 3), f.rule))


@dataclass(frozen=True)
class CollectiveContract:
    """Expected collective shape of one program (a dump or a recording).

    ``axes`` maps mesh axis names to ``{"permutes", "wire_bytes",
    "dtypes"}`` — the exact number of collective-permute OPS (2 per pair
    per exchange group), the exact all-links bytes-on-wire, and the legal
    payload dtypes for that axis; ``axes=None`` skips the per-axis checks
    (counts/bytes/routes) while the structural ones (payload slab bound,
    guard psum, forbidden gathers) still run. ``routes`` holds the legal
    ``source_target_pairs`` sets per axis (`axis_routes`); ``None``
    disables attribution. ``allreduce_payload`` is ``(dtype, length)`` of
    the one permitted psum (the health guard's stats vector), checked on
    every all-reduce present. ``max_payload_cells`` bounds every permute
    payload strictly below the local block — dtype-generic (the old
    f32-only regex skipped bf16/f16/f64 payloads entirely)."""

    axes: dict | None = None
    routes: dict | None = None
    allreduces: int = 0
    allreduce_payload: tuple | None = None
    allow_all_gathers: bool = False
    allow_all_to_alls: bool = False
    max_payload_cells: int | None = None
    meta: dict = dc_field(default_factory=dict)

    def to_json(self) -> dict:
        return {
            "axes": self.axes,
            "routes": None if self.routes is None else {
                a: [sorted(list(p) for p in r) for r in routes]
                for a, routes in self.routes.items()},
            "allreduces": self.allreduces,
            "allreduce_payload": (list(self.allreduce_payload)
                                  if self.allreduce_payload else None),
            "allow_all_gathers": self.allow_all_gathers,
            "allow_all_to_alls": self.allow_all_to_alls,
            "max_payload_cells": self.max_payload_cells,
            "meta": self.meta,
        }

    @classmethod
    def from_json(cls, rec) -> "CollectiveContract":
        if isinstance(rec, (str, bytes)):
            rec = json.loads(rec)
        try:
            axes = rec.get("axes")
            if axes is not None:
                axes = {str(a): {"permutes": int(v["permutes"]),
                                 "wire_bytes": (None if v.get("wire_bytes")
                                                is None
                                                else int(v["wire_bytes"])),
                                 "dtypes": tuple(v.get("dtypes", ()))}
                        for a, v in axes.items()}
            routes = rec.get("routes")
            if routes is not None:
                routes = {str(a): tuple(
                    frozenset((int(s), int(t)) for s, t in route)
                    for route in rts) for a, rts in routes.items()}
            arp = rec.get("allreduce_payload")
            return cls(
                axes=axes, routes=routes,
                allreduces=int(rec.get("allreduces", 0)),
                allreduce_payload=(None if arp is None
                                   else (str(arp[0]), int(arp[1]))),
                allow_all_gathers=bool(rec.get("allow_all_gathers", False)),
                allow_all_to_alls=bool(rec.get("allow_all_to_alls", False)),
                max_payload_cells=(None if rec.get("max_payload_cells")
                                   is None
                                   else int(rec["max_payload_cells"])),
                meta=dict(rec.get("meta", {})))
        except (KeyError, TypeError, ValueError, IndexError) as e:
            raise InvalidArgumentError(
                f"CollectiveContract.from_json: malformed record ({e}).") \
                from e


# ---------------------------------------------------------------------------
# topology-derived route tables

def axis_routes(gg=None) -> dict:
    """Legal directed ``(source, target)`` pair-sets per mesh axis and
    exchange direction, in linearized mesh positions (row-major over
    ``gg.dims``: the ids a JAX dump names in ``source_target_pairs`` and
    the recorder records)."""
    from ..parallel.topology import AXIS_NAMES, axis_perm_pairs, global_grid

    gg = gg if gg is not None else global_grid()
    dims = [int(d) for d in gg.dims]
    table: dict = {}
    for d, axis in enumerate(AXIS_NAMES):
        perms = axis_perm_pairs(dims[d], bool(gg.periods[d]), int(gg.disp))
        routes = [frozenset(linear_pairs(dims, d, perm)) for perm in perms]
        routes = [r for r in routes if r]
        if routes:
            table[axis] = tuple(routes)
    # topology-staged sub-routes: when the grid declares DCN granules
    # along an axis (`GlobalGrid.dcn_granules`), the staged wire's
    # gather / striped-DCN / scatter / intra hops ride pair-sets of
    # their own — appended under the staged axis so a staged program's
    # permutes attribute. A gather route that coincides with the gather
    # axis's flat route (every shard crosses, block=1) attributes to the
    # GATHER axis by first-match order — exactly the link its traffic
    # crosses, and the same order `_merged_plan` derives contracts with.
    from ..parallel.topology import staged_wire_layout

    for d, axis in enumerate(AXIS_NAMES):
        lay = staged_wire_layout(gg, d)
        if lay is None:
            continue
        have = {fs for rts in table.values() for fs in rts}
        extra = []
        for dr in lay.directions:
            for pl in (dr.gather_pairs, dr.dcn_pairs, dr.scatter_pairs,
                       dr.intra_pairs_lin):
                fs = frozenset((int(s), int(t)) for s, t in pl if s != t)
                if fs and fs not in have:
                    have.add(fs)
                    extra.append(fs)
        if extra:
            table[axis] = tuple(table.get(axis, ())) + tuple(extra)
    return table


def attribute_axis(routes: dict, pairs) -> str | None:
    """Mesh axis whose legal route matches the permute's pair set."""
    ps = frozenset((int(s), int(t)) for s, t in pairs)
    for axis, rts in routes.items():
        if ps in rts:
            return axis
    return None


def measure_axes(ir: ProgramIR, routes: dict) -> dict:
    """Per-axis totals of the parsed program's permutes: op count, directed
    pair count, all-links wire bytes, payload dtypes. Unattributable
    permutes land under the ``None`` key."""
    out: dict = {}
    for op in ir.permutes:
        pairs = op.attrs.get("source_target_pairs") or ()
        axis = attribute_axis(routes, pairs) if pairs else None
        rec = out.setdefault(axis, {"permutes": 0, "pairs": 0,
                                    "wire_bytes": 0, "dtypes": set()})
        rec["permutes"] += 1
        rec["pairs"] += len(pairs)
        rec["wire_bytes"] += ir.wire_bytes_of(op)
        pay = ir.payload_of(op)
        if pay is not None:
            rec["dtypes"].add(pay.dtype)
    return {a: {**r, "dtypes": tuple(sorted(r["dtypes"]))}
            for a, r in out.items()}


# ---------------------------------------------------------------------------
# contract derivation (from the SAME plan the telemetry layer prices)

def _staged_stage_routes(layout) -> dict:
    """``{(direction, stage): pair tuple}`` of one `StagedWireLayout` —
    the route each stage-table entry's ppermutes ride."""
    out = {}
    for dr in layout.directions:
        out[(dr.name, "intra")] = dr.intra_pairs_lin
        out[(dr.name, "gather")] = dr.gather_pairs
        out[(dr.name, "dcn")] = dr.dcn_pairs
        out[(dr.name, "scatter")] = dr.scatter_pairs
    return out


def _merged_plan(fields, rounds, *, dims=None, coalesce=None,
                 wire_dtype=None, ensemble=None, comm_every=None,
                 wire_stage=None) -> dict:
    """Per-axis {ppermutes, wire_bytes, dtypes} merged over the exchange
    rounds exactly as `telemetry.predict_step` merges them: fields in one
    round coalesce, separate rounds pay separate permutes.

    ``wire_bytes`` here is the ALL-LINKS total the parser measures in a
    program (`ProgramIR.wire_bytes_of` sums the payload over
    every ``source_target_pairs`` entry). `halo_comm_plan` prices one
    axis LINE — payload x directed pairs along a single line of shards —
    while a permute's pair list enumerates every parallel
    line of the mesh, so each axis scales by the perpendicular line
    count (total shards / that axis's extent). Dtypes are converted to
    HLO spelling to match the parsed payloads.

    ``comm_every`` (a deep per-axis cadence — `ops.wire.CommCadence` /
    its spellings) switches the merge to the deep-halo SUPER-CYCLE: the
    super-step program advances ``lcm(k_d)`` physical steps, issuing
    each round only along the axes due at each sub-step
    (`CommCadence.due_dims` — the `models.*.deep_step` schedule), so the
    merged totals are per SUPER-STEP program: axis ``d`` carries
    ``cycle / k_d`` exchanges of its ``depth*k_d``-wide slabs.

    ``wire_stage`` merges the topology-staged program: a staged axis's
    plan record carries the hierarchical stage table (absolute ops /
    bytes — the per-line scaling does not apply), and each stage's ops
    are attributed through `attribute_axis` over the SAME route table
    `check_contract` measures with — so a gather pipeline whose route
    coincides with the gather axis's flat route counts under THAT axis,
    exactly as the parser will count it."""
    from ..ops.halo import halo_comm_plan
    from ..ops.wire import resolve_comm_every
    from ..parallel.topology import (
        AXIS_NAMES, global_grid, staged_wire_layout,
    )

    gg = global_grid()
    gdims = [int(d) for d in gg.dims]
    total = 1
    for d in gdims:
        total *= d
    axis_dim = {a: i for i, a in enumerate(AXIS_NAMES)}
    fields = tuple(fields)
    cad = resolve_comm_every(comm_every if comm_every is not None else 1)
    if cad.deep:
        # one (sub-step, due-axes) exchange event per cycle entry; the
        # caller's dims order is the within-event processing order
        events = [cad.due_dims(j) for j in range(cad.cycle)]
        events = [e for e in events if e]
    else:
        events = [dims]
    table = axis_routes(gg)
    stage_routes: dict = {}
    merged: dict = {}

    def rec_for(axis):
        return merged.setdefault(
            axis, {"permutes": 0, "wire_bytes": 0, "dtypes": set()})
    for ev_dims in events:
        for group in rounds:
            if any(i >= len(fields) for i in group):
                raise InvalidArgumentError(
                    f"exchange round {tuple(group)} indexes past the "
                    f"{len(fields)} given fields.")
            sub = halo_comm_plan(*(fields[i] for i in group), dims=ev_dims,
                                 coalesce=coalesce, wire_dtype=wire_dtype,
                                 ensemble=ensemble, wire_stage=wire_stage)
            for axis, rec in sub["axes"].items():
                dts = tuple(hlo_dtype(d) for d in rec["by_dtype"])
                if "staged" in rec:
                    # hierarchical stage table: absolute ops/bytes (no
                    # per-line scaling), each stage counted on the axis
                    # its ROUTE attributes to — byte-identical to what
                    # the parser measures on the program
                    d = axis_dim[axis]
                    if d not in stage_routes:
                        stage_routes[d] = _staged_stage_routes(
                            staged_wire_layout(gg, d))
                    for st in rec["staged"]["stages"]:
                        pl = stage_routes[d][(st["direction"], st["stage"])]
                        ax = attribute_axis(table, pl)
                        dst = rec_for(ax if ax is not None else axis)
                        dst["permutes"] += int(st["ops"])
                        dst["wire_bytes"] += int(st["wire_bytes"])
                        dst["dtypes"].update(dts)
                    continue
                n_lines = total // gdims[axis_dim[axis]]
                dst = rec_for(axis)
                dst["permutes"] += int(rec["ppermutes"])
                dst["wire_bytes"] += int(rec["wire_bytes"]) * n_lines
                dst["dtypes"].update(dts)
    return merged


def _local_block_cells(fields) -> int:
    """Total per-rank block cells across the fields: the slab bound, every
    permute payload must be strictly smaller. A coalesced payload
    legitimately aggregates N fields' slabs (N x slab can reach one
    field's block), so the structural bound is the whole group's block
    total; the per-axis ``wire_bytes`` equality pins the EXACT slab sizes
    whenever the contract carries axes. ``fields`` take `halo_comm_plan`'s
    forms: this process's stacked box (or anything with a shape)."""
    from ..ops.fields import Field
    from ..parallel.topology import global_grid

    gg = global_grid()
    total = 0
    for f in fields:
        if isinstance(f, Field):
            f = f.A
        elif isinstance(f, tuple) and len(f) == 2 and hasattr(f[0], "shape") \
                and not hasattr(f[1], "shape"):
            f = f[0]
        n = 1
        for d, s in enumerate(f.shape):
            n *= int(s) // (int(gg.box[d]) if d < 3 else 1)
        total += n
    return total


def exchange_contract(*fields, rounds=None, dims=None, coalesce=None,
                      wire_dtype=None, guard_floats: int | None = None,
                      ensemble: int | None = None, comm_every=None,
                      wire_stage=None, meta=None) -> CollectiveContract:
    """Derive the contract for an exchange (or a step program) over the
    CURRENT grid from the static wire plan alone.

    ``fields`` take the same forms as `halo_comm_plan` (arrays, `Field`,
    ``(A, hw)`` tuples, anything with ``shape`` and ``dtype``). ``rounds`` lists the
    exchange rounds as tuples of field indices (default: one coalesced
    round of every field — `STEP_WORKLOADS[...].exchange_groups` for a
    model step). ``comm_every`` (a deep per-axis cadence) derives the
    DEEP-HALO SUPER-STEP program's contract: per-axis permute counts and
    byte-exact k_d-wide payloads merged over the cadence cycle's due
    schedule (`_merged_plan` — axis ``d`` carries ``lcm(k)/k_d``
    exchanges per super-step). ``guard_floats`` adds the
    resilient runtime's psum
    expectation: exactly one f32 all-reduce of that many floats.
    ``ensemble=E`` is the E-member batched program's contract (fields
    stay the PHYSICAL per-member shapes): identical per-axis permute
    COUNTS with byte-exact E-scaled payloads — the proof that
    collective count is flat in E — the slab bound widens to E x the
    local block (a batched payload legitimately aggregates every
    member's slabs), and ``guard_floats`` stays the PER-MEMBER float
    count: the expected psum payload scales to ``f32[E·guard_floats]``
    exactly like `guard_contract`.

    ``wire_stage`` (the `ops.wire.resolve_wire_stage` spelling family)
    derives the TOPOLOGY-STAGED program's contract: a staged axis's
    expectations prove the hierarchical pipeline byte-exactly — per-stage
    permute counts (``fold - 1`` gather + 1 striped DCN + ``fold - 1``
    scatter per cross direction, plus any intra pair), each stage's ops
    counted on the mesh axis its ROUTE attributes to, and exactly
    ``dcn_pairs`` DCN-crossing transfers per round (ONE per granule-pair
    per direction)."""
    from ..parallel.topology import check_initialized, global_grid

    check_initialized()
    gg = global_grid()
    E = 1
    if ensemble is not None:
        E = int(ensemble)
        if E < 1:
            raise InvalidArgumentError(
                f"exchange_contract: ensemble must be >= 1; got "
                f"{ensemble}.")
    rounds = rounds if rounds is not None else (tuple(range(len(fields))),)
    merged = _merged_plan(fields, rounds, dims=dims, coalesce=coalesce,
                          wire_dtype=wire_dtype, ensemble=ensemble,
                          comm_every=comm_every, wire_stage=wire_stage)
    axes = {a: {"permutes": r["permutes"], "wire_bytes": r["wire_bytes"],
                "dtypes": tuple(sorted(r["dtypes"]))}
            for a, r in merged.items() if r["permutes"]}
    from ..ops.wire import resolve_comm_every, resolve_wire_stage

    cad = resolve_comm_every(comm_every if comm_every is not None else 1)
    stg = resolve_wire_stage(wire_stage)
    # a staged DCN stripe legitimately aggregates fold x the packed
    # payload — widen the structural slab bound by the largest fold
    bound = _local_block_cells(fields) * E
    if stg is not None:
        from ..parallel.topology import staged_wire_layout

        folds = [staged_wire_layout(gg, d) for d in stg.staged_dims]
        fold = max((int(l.fold) for l in folds if l is not None), default=1)
        bound *= fold
    return CollectiveContract(
        axes=axes,
        routes=axis_routes(gg),
        allreduces=0 if guard_floats is None else 1,
        allreduce_payload=(None if guard_floats is None
                           else ("f32", E * int(guard_floats))),
        max_payload_cells=bound,
        meta=dict(meta or {}, dims=[int(d) for d in gg.dims],
                  periods=[int(p) for p in gg.periods],
                  **({"ensemble": E} if E > 1 else {}),
                  **({"comm_every": str(cad)} if cad.deep else {}),
                  **({"wire_stage": str(stg)} if stg is not None else {})))


def model_contract(model, fields, *, dims=None, coalesce=None,
                   wire_dtype=None, impl: str = "plain",
                   guard_floats: int | None = None,
                   ensemble: int | None = None,
                   comm_every=None, wire_stage=None) -> CollectiveContract:
    """The step contract of a model family: exchange rounds from
    `telemetry.STEP_WORKLOADS[model]`, priced over the model's state
    ``fields`` (canonical state order — PHYSICAL per-member shapes when
    ``ensemble`` is set). ``impl`` picks the kernel tier's rounds
    (`StepWorkload.groups_for`): both tiers ride the canonical wire
    schema, so a fused kernel route (``"cuda"``) gets the same byte-exact
    contract as the plain route (``"plain"``; the JAX spellings are accepted) —
    only the round grouping may differ. A deep ``comm_every`` cadence
    selects the deep runner's rounds (``deep_exchange_groups``, plain
    route) and the super-cycle merge of
    `exchange_contract`: the contract then describes ONE compiled
    super-step, with each axis's permute count amortized by its own
    cadence."""
    from ..ops.wire import resolve_comm_every
    from ..telemetry.perfmodel import STEP_WORKLOADS

    work = STEP_WORKLOADS.get(str(model))
    if work is None:
        raise InvalidArgumentError(
            f"model_contract: unknown model {model!r} "
            f"(have {sorted(STEP_WORKLOADS)}).")
    cad = resolve_comm_every(comm_every if comm_every is not None else 1)
    return exchange_contract(
        *fields, rounds=work.groups_for(impl, deep=cad.deep), dims=dims,
        coalesce=coalesce, wire_dtype=wire_dtype, guard_floats=guard_floats,
        ensemble=ensemble, comm_every=comm_every, wire_stage=wire_stage,
        meta={"model": str(model), "impl": str(impl)})


def guard_contract(n_fields: int, reducer_floats: int = 0,
                   meta=None, ensemble: int | None = None
                   ) -> CollectiveContract:
    """The resilient chunk program's structural contract when the step
    body is user code (per-axis permute counts unknowable): exactly one
    f32[2N + R] guard psum, no gathers, no all-to-alls. With
    ``ensemble=E`` the one psum carries every member's stats —
    ``f32[E·(2N + R)]`` cells, still exactly one all-reduce (the
    per-member verdicts ride one collective)."""
    E = 1
    if ensemble is not None:
        E = int(ensemble)
        if E < 1:
            raise InvalidArgumentError(
                f"guard_contract: ensemble must be >= 1; got {ensemble}.")
    return CollectiveContract(
        axes=None, routes=None, allreduces=1,
        allreduce_payload=("f32",
                           E * (2 * int(n_fields) + int(reducer_floats))),
        meta=dict(meta or {}, n_fields=int(n_fields),
                  reducer_floats=int(reducer_floats),
                  **({"ensemble": E} if E > 1 else {})))


# ---------------------------------------------------------------------------
# the checker

def check_contract(ir: ProgramIR, contract: CollectiveContract) -> list:
    """Verify a parsed program against a contract. Returns findings
    (empty list = the program honors the contract)."""
    if not isinstance(ir, ProgramIR):
        raise InvalidArgumentError(
            "check_contract expects a ProgramIR (use parse_program).")
    if contract.axes and contract.routes is None:
        # without routes no permute can be attributed to an axis, so every
        # per-axis expectation would "fail" with got=0 on a conforming
        # program — an unsatisfiable contract is a caller error, not a
        # finding (hand-written JSON contracts: include "routes", or use
        # axis_routes() on the live grid)
        raise InvalidArgumentError(
            "check_contract: a contract with per-axis expectations needs "
            "routes to attribute permutes (axis_routes(), or a 'routes' "
            "table in the contract JSON).")
    findings: list = []
    routes = contract.routes
    per_axis: dict = {a: {"permutes": 0, "wire_bytes": 0, "dtypes": set()}
                      for a in (contract.axes or {})}

    for op in ir.permutes:
        pay = ir.payload_of(op)
        pairs = op.attrs.get("source_target_pairs") or ()
        if contract.max_payload_cells is not None and pay is not None \
                and pay.cells >= contract.max_payload_cells:
            findings.append(AuditFinding(
                "permute-payload", SEV_ERROR,
                f"collective-permute payload {pay} is not slab-sized "
                f"(>= the {contract.max_payload_cells}-cell local block): "
                "the slab slicing did not reach the wire.",
                op=op.name, computation=op.computation,
                details={"payload": str(pay), "cells": pay.cells}))
        if routes is None:
            continue
        axis = attribute_axis(routes, pairs) if pairs else None
        if axis is None:
            findings.append(AuditFinding(
                "permute-route", SEV_ERROR,
                "collective-permute rides a route matching no mesh axis "
                "of the static plan (unplanned communication).",
                op=op.name, computation=op.computation,
                details={"source_target_pairs": [list(p) for p in pairs]}))
            continue
        if contract.axes is not None and axis not in contract.axes:
            findings.append(AuditFinding(
                "permute-count", SEV_ERROR,
                f"collective-permute on mesh axis {axis!r}, which the "
                "plan expects not to exchange.",
                op=op.name, computation=op.computation,
                details={"axis": axis}))
            continue
        if axis in per_axis:
            per_axis[axis]["permutes"] += 1
            per_axis[axis]["wire_bytes"] += ir.wire_bytes_of(op)
            if pay is not None:
                per_axis[axis]["dtypes"].add(pay.dtype)

    if contract.axes is not None:
        for axis, exp in contract.axes.items():
            got = per_axis.get(axis,
                               {"permutes": 0, "wire_bytes": 0,
                                "dtypes": set()})
            if got["permutes"] != int(exp["permutes"]):
                findings.append(AuditFinding(
                    "permute-count", SEV_ERROR,
                    f"axis {axis!r}: {got['permutes']} collective-permutes "
                    f"in the program, plan expects {exp['permutes']}.",
                    details={"axis": axis, "got": got["permutes"],
                             "expected": int(exp["permutes"])}))
                continue
            exp_bytes = exp.get("wire_bytes")
            if exp_bytes is not None and got["wire_bytes"] != int(exp_bytes):
                findings.append(AuditFinding(
                    "wire-bytes", SEV_ERROR,
                    f"axis {axis!r}: {got['wire_bytes']} bytes on wire in "
                    f"the program, plan prices {exp_bytes}.",
                    details={"axis": axis, "got": got["wire_bytes"],
                             "expected": int(exp_bytes)}))
            exp_dts = set(exp.get("dtypes") or ())
            if exp_dts and not set(got["dtypes"]) <= exp_dts:
                findings.append(AuditFinding(
                    "permute-dtype", SEV_ERROR,
                    f"axis {axis!r}: payload dtypes "
                    f"{sorted(got['dtypes'])} not within the plan's "
                    f"{sorted(exp_dts)} (wire-dtype contract).",
                    details={"axis": axis,
                             "got": sorted(got["dtypes"]),
                             "expected": sorted(exp_dts)}))

    ars = ir.all_reduces
    if len(ars) != int(contract.allreduces):
        findings.append(AuditFinding(
            "allreduce-count", SEV_ERROR,
            f"{len(ars)} all-reduces in the program, contract expects "
            f"{contract.allreduces}.",
            details={"got": len(ars), "expected": int(contract.allreduces)}))
    if contract.allreduce_payload is not None:
        dt, length = contract.allreduce_payload
        for op in ars:
            pay = ir.payload_of(op)
            if pay is None or pay.dtype != dt or pay.cells != int(length):
                findings.append(AuditFinding(
                    "allreduce-payload", SEV_ERROR,
                    f"all-reduce payload {pay} is not the guard's tiny "
                    f"{dt}[{length}] stats vector.",
                    op=op.name, computation=op.computation,
                    details={"payload": str(pay) if pay else None,
                             "expected": f"{dt}[{length}]"}))
    if ir.all_gathers and not contract.allow_all_gathers:
        findings.append(AuditFinding(
            "all-gather-forbidden", SEV_ERROR,
            f"{len(ir.all_gathers)} all-gather(s) in a program whose "
            "contract forbids them (a gather over the implicit grid "
            "materializes what must never exist).",
            details={"got": len(ir.all_gathers)}))
    if ir.all_to_alls and not contract.allow_all_to_alls:
        findings.append(AuditFinding(
            "all-to-all-forbidden", SEV_ERROR,
            f"{len(ir.all_to_alls)} all-to-all(s) in a program whose "
            "contract forbids them.",
            details={"got": len(ir.all_to_alls)}))
    return sort_findings(findings)


# ---------------------------------------------------------------------------
# perfmodel cross-check

def perfmodel_crosscheck(model, fields, ir: ProgramIR, *, profile=None,
                         dims=None, coalesce=None, wire_dtype=None,
                         impl: str = "plain",
                         ensemble: int | None = None,
                         comm_every=None, wire_stage=None) -> dict:
    """Prove `telemetry.predict_step`'s collective pricing against the
    program: per mesh axis, the oracle's priced ppermute PAIRS
    and all-links wire bytes must equal what the parser measured in the
    program. Returns ``{"ok", "findings", "axes"}`` where each axis entry
    carries modeled vs parsed numbers — drift in the static model becomes
    a caught ``perfmodel-drift`` finding instead of silent mispricing.
    With ``ensemble=E`` the oracle prices the E-member batched program
    (same pairs, E x bytes) against the batched program — proving the
    amortization claim byte-exactly. With a deep ``comm_every`` cadence
    the parsed program is the compiled SUPER-STEP (one cadence cycle):
    the oracle's per-exchange pairs scale by each axis's
    ``cycle / k_d`` events per cycle — proving the per-axis amortization
    (latency term ÷ k_axis) against exactly what the program moved.
    With ``wire_stage`` the oracle prices the hierarchical staged
    program: a staged axis's gather/scatter hops ride the GATHER axis's
    routes in the program, so the per-axis comparison runs
    against the route-attributed plan merge and the oracle-vs-plan
    self-consistency check moves to the TOTAL pair count (the oracle
    books every staged op under the staged axis; the attribution books
    it where the parser will see it — same total, different split)."""
    from ..ops.wire import resolve_comm_every
    from ..parallel.topology import check_initialized, global_grid
    from ..telemetry.perfmodel import predict_step

    check_initialized()
    gg = global_grid()
    cad = resolve_comm_every(comm_every if comm_every is not None else 1)
    pred = predict_step(model, fields, profile=profile, dims=dims,
                        coalesce=coalesce, wire_dtype=wire_dtype, impl=impl,
                        ensemble=ensemble, comm_every=cad,
                        wire_stage=wire_stage)
    plan = _merged_plan(fields,
                        _exchange_rounds(model, len(fields), impl,
                                         deep=cad.deep),
                        dims=dims, coalesce=coalesce, wire_dtype=wire_dtype,
                        ensemble=ensemble, comm_every=cad,
                        wire_stage=wire_stage)
    parsed = measure_axes(ir, axis_routes(gg))
    from ..parallel.topology import AXIS_NAMES

    axis_dim = {a: i for i, a in enumerate(AXIS_NAMES)}
    staged_axes = {a for a, c in pred["comm"].items() if "staged" in c}
    findings: list = []
    axes: dict = {}

    def _events(axis):
        # events per program: 1 per step normally; under a deep
        # cadence the super-step fires this axis cycle/k_d times
        return (cad.cycle // cad.for_dim(axis_dim[axis])
                if cad.deep else 1)

    # the pairs come from predict_step (the oracle under test), the
    # all-links bytes from this module's round merge — the two price
    # the SAME rounds from the SAME plan, so a disagreement between
    # them means one merge loop was edited without the other: flag it
    # rather than crosscheck against a self-inconsistent model. With a
    # staged axis the split across axes legitimately differs (route
    # attribution vs link class), so the check runs on the TOTALS.
    oracle_total = sum(_events(a) * c["ppermute_pairs"]
                       for a, c in pred["comm"].items())
    plan_total = sum(r["permutes"] for r in plan.values()) / 2.0
    if staged_axes:
        if plan_total != oracle_total:
            findings.append(AuditFinding(
                "model-inconsistent", SEV_ERROR,
                f"predict_step prices {oracle_total} ppermute pairs "
                f"total but the plan merge counts {plan_total} — the "
                "model's two round-merge paths have diverged "
                "(fix telemetry.perfmodel / analysis.contracts before "
                "trusting the crosscheck).",
                details={"predict_step_pairs": oracle_total,
                         "plan_pairs": plan_total,
                         "staged_axes": sorted(staged_axes)}))
    for axis in sorted(set(plan) | set(k for k in parsed if k is not None)):
        modeled_pairs = _events(axis) * pred["comm"].get(axis, {}).get(
            "ppermute_pairs", 0.0)
        modeled_bytes = plan.get(axis, {}).get("wire_bytes", 0)
        plan_pairs = plan.get(axis, {}).get("permutes", 0) / 2.0
        if not staged_axes and plan_pairs != modeled_pairs:
            findings.append(AuditFinding(
                "model-inconsistent", SEV_ERROR,
                f"axis {axis!r}: predict_step prices {modeled_pairs} "
                f"ppermute pairs but the plan merge counts {plan_pairs} "
                "— the model's two round-merge paths have diverged "
                "(fix telemetry.perfmodel / analysis.contracts before "
                "trusting the crosscheck).",
                details={"axis": axis, "predict_step_pairs": modeled_pairs,
                         "plan_pairs": plan_pairs}))
        if staged_axes:
            # compare the parser against the route-attributed merge —
            # where the program actually carries each stage
            modeled_pairs = plan_pairs
        got = parsed.get(axis, {"permutes": 0, "wire_bytes": 0})
        got_pairs = got["permutes"] / 2.0
        axes[axis] = {"modeled_pairs": modeled_pairs,
                      "parsed_pairs": got_pairs,
                      "modeled_wire_bytes": int(modeled_bytes),
                      "parsed_wire_bytes": int(got["wire_bytes"])}
        if got_pairs != modeled_pairs \
                or int(got["wire_bytes"]) != int(modeled_bytes):
            findings.append(AuditFinding(
                "perfmodel-drift", SEV_ERROR,
                f"axis {axis!r}: predict_step prices "
                f"{modeled_pairs} ppermute pairs / {modeled_bytes} wire "
                f"bytes per step, the program carries "
                f"{got_pairs} / {got['wire_bytes']} — the static cost "
                "model has drifted from what the program moves.",
                details=axes[axis]))
    if None in parsed:
        findings.append(AuditFinding(
            "permute-route", SEV_ERROR,
            f"{parsed[None]['permutes']} collective-permute(s) ride "
            "routes matching no mesh axis — unpriceable by the model.",
            details=parsed[None]))
    return {"ok": not findings, "findings": findings, "axes": axes,
            "model": str(model), "impl": str(impl),
            "ensemble": int(pred.get("ensemble", 1)),
            "comm_every": str(cad),
            "wire_stage": pred.get("wire_stage"),
            "profile_source": pred["profile_source"]}


def _exchange_rounds(model, n_fields: int, impl: str = "plain",
                     deep: bool = False):
    from ..telemetry.perfmodel import STEP_WORKLOADS, StepWorkload

    if isinstance(model, StepWorkload):
        return model.groups_for(impl, deep=deep)
    work = STEP_WORKLOADS.get(str(model))
    if work is None:
        raise InvalidArgumentError(
            f"unknown model {model!r} (have {sorted(STEP_WORKLOADS)}).")
    return work.groups_for(impl, deep=deep)
