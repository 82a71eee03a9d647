"""The performance oracle: an analytical per-step cost model and the live
drift detector.

Counterpart of `implicitglobalgrid_tpu/telemetry/perfmodel.py` (without
`predict_reshard`, which prices a reshard plan and comes with reshard): a
roofline over the implicit global grid that combines

- the static halo wire plan (`ops.halo.halo_comm_plan`: bytes on the wire,
  permute counts, wire dtype, derived from shapes alone),
- a per-model step workload (stencil FLOPs and memory passes a cell,
  `STEP_WORKLOADS`, the JAX package's table as it is: it describes the
  algorithm, not the device), and
- a `MachineProfile` of measured coefficients (memory bandwidth, FLOP rate,
  and a link bandwidth and latency per mesh axis:
  `telemetry.calibrate.calibrate_machine`; `default_machine_profile` holds
  coefficients measured once on an H100 and labels them ``"default"``)

into a prediction of a step's compute time, per-axis exchange time and
exposed exchange, and the roofline verdict (`predict_step`). The records,
the profile's JSON and the workloads are the JAX package's, so either
package prices the same configuration the same way and reads the other's
profiles.

``impl`` takes the port's route spellings: ``"cuda"`` prices the fused
kernel routes' exchange rounds (the JAX package's ``"pallas*"`` tier,
`StepWorkload.groups_for`) and ``"plain"`` the per-step rounds (its
``"xla"``); the JAX spellings are accepted too.

The live half is `PerfWatch` (with `robust_z`): a rolling per-chunk
baseline (median + MAD over a window, robust z-score) and the measured /
modeled ratio, fed by `runtime.driver` at every chunk boundary, pure host
arithmetic. A chunk whose per-step time drifts past the z threshold emits
a ``perf_regression`` flight event, and the ``igg_perf_*`` gauges feed the
live ``/metrics`` endpoint (`telemetry.server`).
"""

from __future__ import annotations

import json
import os
from collections import deque
from dataclasses import dataclass, field as dc_field

from ..utils.exceptions import InvalidArgumentError

__all__ = ["MachineProfile", "StepWorkload", "STEP_WORKLOADS",
           "default_machine_profile", "hierarchical_machine_profile",
           "load_machine_profile", "save_machine_profile", "predict_step",
           "PerfWatch", "robust_z"]

_PROFILE_VERSION = 1

# The "gpu" default: `calibrate_machine` on one H100 80GB HBM3 at its 700 W
# power limit, on the 2x2x2 virtual mesh of 128^3 blocks (per-device rates
# are the card's shared by the eight blocks: 2.99 TB/s and 57.2 TFLOP/s a
# card; each axis's link is the port's own exchange along it, its eager host
# cost included; gy's fit put all of its time on the bandwidth term),
# measured by chip_smoke.py's oracle phase (phase 13d). Recalibrate for
# another card, mesh or exchange.
_GPU_DEFAULT = {"membw_GBps": 373.93750096610216, "flops_G": 7152.570834854459,
                "axes": {"gx": {"GBps": 12.0820682237197,
                                "latency_s": 0.00010261492873074089},
                         "gy": {"GBps": 5.588273736286372, "latency_s": 0.0},
                         "gz": {"GBps": 3.2075138631642086,
                                "latency_s": 0.00011767624215998208}}}


@dataclass(frozen=True)
class MachineProfile:
    """Measured (or default) machine coefficients the cost model consumes.

    ``membw_GBps``/``flops_G`` are PER-DEVICE achieved rates: on the
    virtual mesh the blocks share one card, and a calibration over the live
    mesh measures the card's rate shared by them (the JAX package's
    emulated CPU mesh has the same semantics). ``axes`` maps mesh axis
    names (``gx``/``gy``/``gz``) to ``{"GBps", "latency_s"}``: the effective
    one-direction link bandwidth and the per-permute-PAIR launch latency of
    an exchange along that axis. ``source`` is ``"calibrated"`` or
    ``"default"``, so a prediction can always say whether measured
    coefficients backed it."""

    membw_GBps: float
    flops_G: float
    axes: dict
    source: str = "default"
    device: dict | None = None
    calibrated_at: float | None = None
    meta: dict = dc_field(default_factory=dict)

    def axis(self, name: str) -> dict:
        """Link coefficients for one mesh axis (falls back to the mean of
        the calibrated axes, then to conservative defaults, so a profile
        calibrated on a 1-D mesh still prices a 3-D one)."""
        rec = self.axes.get(name)
        if rec and rec.get("GBps"):
            return rec
        have = [r for r in self.axes.values() if r and r.get("GBps")]
        if have:
            return {"GBps": sum(r["GBps"] for r in have) / len(have),
                    "latency_s": sum(r.get("latency_s", 0.0)
                                     for r in have) / len(have)}
        return {"GBps": 1.0, "latency_s": 1e-4}

    def to_json(self) -> dict:
        return {"version": _PROFILE_VERSION,
                "membw_GBps": self.membw_GBps, "flops_G": self.flops_G,
                "axes": self.axes, "source": self.source,
                "device": self.device, "calibrated_at": self.calibrated_at,
                "meta": self.meta}


def default_machine_profile(device_type: str | None = None) -> MachineProfile:
    """Fallback coefficients (``source="default"``); use
    `telemetry.calibrate.calibrate_machine` for measured ones. With no
    argument, the current grid's device type is used: ``"gpu"`` holds one
    H100's measured rates (`_GPU_DEFAULT`), ``"cpu"`` the JAX package's
    emulated-CPU-mesh coefficients."""
    if device_type is None:
        from ..parallel.topology import global_grid

        device_type = global_grid().device_type
    if device_type in ("gpu", "cuda"):
        d = _GPU_DEFAULT
        return MachineProfile(
            membw_GBps=d["membw_GBps"], flops_G=d["flops_G"],
            axes={a: dict(r) for a, r in d["axes"].items()},
            source="default",
            device={"platform": "gpu", "device_kind": "NVIDIA H100 80GB HBM3",
                    "power_limit_W": 700.0})
    # the virtual CPU mesh: the blocks share one host's cores
    axes = {a: {"GBps": 4.0, "latency_s": 3e-5} for a in ("gx", "gy", "gz")}
    return MachineProfile(membw_GBps=6.0, flops_G=6.0, axes=axes,
                          source="default",
                          device={"platform": device_type or "cpu"})


def hierarchical_machine_profile() -> MachineProfile:
    """Canned two-tier coefficients (``source="default"``): ``gx``/``gy``
    at the ``"gpu"`` default's link and ``gz`` at a slower class, 1/22.5 of
    its bandwidth and 10x its latency (the JAX package's ratio between its
    two link classes), with the ``"gpu"`` default's memory and FLOP rates.
    Lets the staged-vs-flat pricing and the tuner's staged candidates run
    where every real link is one class; calibrate on the real cluster for
    measured coefficients."""
    base = default_machine_profile("gpu")
    fast = base.axis("gx")
    axes = {"gx": dict(fast), "gy": dict(base.axis("gy")),
            "gz": {"GBps": fast["GBps"] / 22.5,
                   "latency_s": fast["latency_s"] * 10.0}}
    return MachineProfile(membw_GBps=base.membw_GBps, flops_G=base.flops_G,
                          axes=axes, source="default",
                          device={"platform": "gpu"},
                          meta={"preset": "hierarchical",
                                "dcn_axes": ["z"]})


def save_machine_profile(profile: MachineProfile, path) -> str:
    """Persist a profile as JSON (the JAX package's format, version 1)."""
    path = os.fspath(path)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(profile.to_json(), f, indent=1)
    return path


def load_machine_profile(path) -> MachineProfile:
    """Read a profile written by either package."""
    path = os.fspath(path)
    try:
        with open(path, encoding="utf-8") as f:
            rec = json.load(f)
    except (OSError, ValueError) as e:
        raise InvalidArgumentError(
            f"load_machine_profile: cannot read {path}: {e}") from e
    try:
        return MachineProfile(
            membw_GBps=float(rec["membw_GBps"]),
            flops_G=float(rec["flops_G"]),
            axes={str(k): dict(v) for k, v in rec.get("axes", {}).items()},
            source=str(rec.get("source", "calibrated")),
            device=rec.get("device"),
            calibrated_at=rec.get("calibrated_at"),
            meta=rec.get("meta", {}))
    except (KeyError, TypeError, ValueError) as e:
        raise InvalidArgumentError(
            f"load_machine_profile: {path} is not a machine profile "
            f"({e}).") from e


def _fused_tier(impl) -> bool:
    """Whether ``impl`` names the fused kernel routes: the port's
    ``"cuda"`` or the JAX package's ``"pallas*"`` spellings; ``"plain"``,
    ``"xla"`` and anything else price the per-step rounds."""
    s = str(impl)
    return s == "cuda" or s.startswith("pallas")


@dataclass(frozen=True)
class StepWorkload:
    """Per-cell step cost and exchange structure of one model family (the
    JAX package's record).

    ``flops_per_cell`` counts the stencil arithmetic; ``hbm_passes`` the
    memory traffic in array passes (bytes = passes * itemsize * cells).
    ``exchange_groups`` are the step's exchange rounds, one tuple of FIELD
    INDICES a round (fields in one round coalesce into one permute pair
    per axis): diffusion exchanges only T, the acoustic leapfrog a V round
    then a P round. ``fused_exchange_groups`` are the fused kernel routes'
    rounds where they differ (acoustic: all four fields in one round);
    ``deep_exchange_groups`` the deep-halo (``comm_every``) runner's, and
    ``deep_halo_depth`` its per-sub-step dependency radius."""

    flops_per_cell: float
    hbm_passes: float
    exchange_groups: tuple = ((0,),)
    fused_exchange_groups: tuple | None = None
    deep_exchange_groups: tuple | None = None
    deep_halo_depth: int = 1

    def groups_for(self, impl: str = "plain", deep: bool = False) -> tuple:
        """The exchange rounds of one route: the fused routes (``"cuda"``,
        or the JAX package's ``"pallas*"``) price `fused_exchange_groups`
        where declared, any other spelling the per-step rounds.
        ``deep=True`` prices the deep-halo runner's rounds (the cadence
        runs the plain route, so ``deep`` wins over ``impl``)."""
        if deep and self.deep_exchange_groups is not None:
            return self.deep_exchange_groups
        if _fused_tier(impl) and self.fused_exchange_groups is not None:
            return self.fused_exchange_groups
        return self.exchange_groups


# One entry per model family (`models/`), the JAX package's table.
STEP_WORKLOADS = {
    # flux (3 diffs, 3 muls) + divergence (5) + Cp array-div + update;
    # only T is exchanged (Cp is a constant coefficient field)
    "diffusion3d": StepWorkload(flops_per_cell=22.0, hbm_passes=4.0,
                                exchange_groups=((0,),)),
    "diffusion2d": StepWorkload(flops_per_cell=14.0, hbm_passes=4.0,
                                exchange_groups=((0,),)),
    # state (P, Vx, Vy, Vz): the leapfrog exchanges the 3 V fields in one
    # coalesced round, then P in its own round; the fused route packs all
    # four fields into ONE round, and so does the deep-halo super-step
    "acoustic3d": StepWorkload(flops_per_cell=20.0, hbm_passes=8.0,
                               exchange_groups=((1, 2, 3), (0,)),
                               fused_exchange_groups=((0, 1, 2, 3),),
                               deep_exchange_groups=((0, 1, 2, 3),)),
    # state (P, Vx, Vy, Vz, dVx, dVy, dVz, rhog): one coalesced round of
    # the 4 wave fields per PT iteration; the deep-halo scheme exchanges
    # the 7 evolving fields (dV included) at radius-2 slabs
    "stokes3d": StepWorkload(flops_per_cell=60.0, hbm_passes=16.0,
                             exchange_groups=((1, 2, 3, 0),),
                             deep_exchange_groups=((0, 1, 2, 3, 4, 5, 6),),
                             deep_halo_depth=2),
}


def _axis_npairs(gg, dim: int) -> int:
    """Directed links an exchange's permute pair spans along ``dim`` (the
    divisor that turns the plan's all-links ``wire_bytes`` into the
    one-direction per-link payload the link model prices)."""
    from ..parallel.topology import axis_perm_pairs

    perm_p, perm_m = axis_perm_pairs(int(gg.dims[dim]), bool(gg.periods[dim]),
                                     int(gg.disp))
    return len(perm_p) + len(perm_m)


def predict_step(model, fields, *, profile: MachineProfile | None = None,
                 comm_every=1, overlap: bool = False,
                 dims=None, coalesce=None, wire_dtype=None, wire_stage=None,
                 impl: str = "plain", ensemble: int | None = None) -> dict:
    """Predict one step's cost on the CURRENT grid for stacked ``fields``.

    ``model`` is a `STEP_WORKLOADS` key or a `StepWorkload`; ``fields`` are
    the stacked state tensors (or anything with shape and dtype, ``(A,
    halowidths)`` tuples and `ops.fields.Field` included) in the model's
    state order: the workload's exchange rounds index into them and each
    round is priced with `halo_comm_plan` as the step issues it.
    ``profile`` defaults to `default_machine_profile()`. ``comm_every``
    prices the deep-halo cadence (an int or a per-axis spec, the
    `resolve_comm_every` spellings): each axis's exchange is charged once
    per its own ``k_d`` steps, and a deep cadence prices the deep runner's
    rounds. ``overlap`` credits exchange time that hides behind the
    INTERIOR compute (the boundary shell of each exchanging dim computes
    before the exchange): exposed = max(0, comm - compute * interior_frac).
    ``impl`` picks the route's rounds (module docstring). ``wire_stage``
    prices the topology-staged wire, each stage against the link class it
    crosses, beside the flat alternative (``staged``: ``flat_s``,
    ``staged_s``, ``wins``, ``dcn_msgs_ratio``). ``ensemble=E`` prices E
    members in one step: compute and wire bytes scale by E, the launches
    (the latency term) stay flat; the record then carries the
    ``per_member_*`` fields, ``solo_step_s`` and ``ensemble_amortization``.

    Returns the JAX package's record::

        {"model", "profile_source", "local_cells", "ensemble",
         "comm_every", "wire_stage",
         "compute": {"flops", "hbm_bytes", "flops_s", "hbm_s", "s"},
         "comm":    {axis: {"ppermute_pairs", "per_link_bytes",
                            "comm_every", "latency_s", "wire_s", "s"}},
         "local_copy_s", "comm_s", "interior_frac", "exposed_comm_s",
         "step_s", "bound", "bound_detail", "terms"}

    ``bound`` is the largest exposed cost term's class: ``"compute"``
    (FLOPs), ``"bandwidth"`` (memory or wire bytes; ``bound_detail`` says
    which) or ``"latency"`` (exchange launches; ``bound_detail`` names the
    latency-dominant axis's knob, ``comm_every[z]`` or ``wire_stage[z]``)."""
    from ..ops.halo import halo_comm_plan
    from ..ops.wire import resolve_comm_every, resolve_wire_stage
    from ..parallel.topology import (
        check_initialized, global_grid, staged_wire_layout,
    )

    check_initialized()
    gg = global_grid()
    if isinstance(model, StepWorkload):
        work, model_name = model, "custom"
    else:
        work = STEP_WORKLOADS.get(str(model))
        if work is None:
            raise InvalidArgumentError(
                f"predict_step: unknown model {model!r} (have "
                f"{sorted(STEP_WORKLOADS)}; or pass a StepWorkload).")
        model_name = str(model)
    profile = profile if profile is not None else default_machine_profile()
    cad = resolve_comm_every(comm_every)
    stg = resolve_wire_stage(wire_stage)
    E = 1
    if ensemble is not None:
        E = int(ensemble)
        if E < 1:
            raise InvalidArgumentError(
                f"predict_step: ensemble must be >= 1; got {ensemble}.")

    # one wire plan per exchange ROUND the step performs (fields in a
    # round coalesce; separate rounds pay separate launches), merged into
    # per-axis totals
    fields = tuple(fields)
    plan = {"axes": {}, "local_copy_by_axis": {}}
    for group in work.groups_for(impl, deep=cad.deep):
        if any(i >= len(fields) for i in group):
            raise InvalidArgumentError(
                f"predict_step: model {model_name!r} expects at least "
                f"{max(group) + 1} fields in its state order "
                f"(exchange group {group}); got {len(fields)}.")
        sub = halo_comm_plan(*(fields[i] for i in group), dims=dims,
                             coalesce=coalesce, wire_dtype=wire_dtype,
                             ensemble=ensemble, wire_stage=stg)
        for axis, rec in sub["axes"].items():
            dst = plan["axes"].setdefault(
                axis, {"ppermutes": 0, "wire_bytes": 0})
            dst["ppermutes"] += rec["ppermutes"]
            dst["wire_bytes"] += rec["wire_bytes"]
            if "staged" in rec:  # merge rounds' stage tables (one layout)
                det = dst.setdefault(
                    "staged", {k: v for k, v in rec["staged"].items()
                               if k != "stages"} | {"stages": []})
                det["stages"].extend(rec["staged"]["stages"])
        for axis, b in sub["local_copy_by_axis"].items():
            plan["local_copy_by_axis"][axis] = (
                plan["local_copy_by_axis"].get(axis, 0) + b)
    # interior cells of the primary (first) field's LOCAL block (this
    # process's box of blocks is stacked along the three grid dims)
    shape0 = _shape_of(fields[0])
    local_cells = 1
    for d, s in enumerate(shape0):
        local_cells *= s // int(gg.box[d]) if d < 3 else s

    itemsize = _itemsize_of(fields[0])
    # compute scales with the member count; the wire plan above already
    # carries the E x payloads (same launches: the latency term below is
    # the one cost the ensemble does NOT multiply)
    flops = work.flops_per_cell * local_cells * E
    hbm_bytes = work.hbm_passes * itemsize * local_cells * E
    flops_s = flops / (profile.flops_G * 1e9)
    hbm_s = hbm_bytes / (profile.membw_GBps * 1e9)
    compute_s = max(flops_s, hbm_s)

    axis_dims = {"gx": 0, "gy": 1, "gz": 2}
    comm = {}
    lat_total = wire_total = 0.0
    for axis, rec in plan["axes"].items():
        coeff = profile.axis(axis)
        pairs = rec["ppermutes"] / 2.0
        # per-axis amortization: this axis's exchange fires once per its
        # own cadence (the k_d-wide slabs are already in the plan's bytes)
        k_ax = cad.for_dim(axis_dims[axis])
        if "staged" in rec:
            # three-stage pricing: gather/scatter/intra hops on the GATHER
            # axis's link coefficients, the one striped transfer on this
            # axis's own; each stage-table entry is one direction, a pair
            # is two (ops/2), as for the flat pair
            det = rec["staged"]
            ici = profile.axis(det["gather_axis"])
            lat_s = wire_s = flat_lat = flat_wire = per_link = 0.0
            stage_s: dict = {}
            flat_groups = set()
            for st in det["stages"]:
                cls = coeff if st["stage"] == "dcn" else ici
                pr = st["ops"] / 2.0
                ls = pr * float(cls.get("latency_s", 0.0)) / k_ax
                ws = pr * st["payload_bytes"] \
                    / (float(cls["GBps"]) * 1e9) / k_ax
                lat_s += ls
                wire_s += ws
                per_link += pr * st["payload_bytes"]
                stage_s[st["stage"]] = (
                    stage_s.get(st["stage"], 0.0) + ls + ws)
                if st["stage"] in ("gather", "intra") \
                        and st["group"] not in flat_groups:
                    # the flat alternative on THIS axis's link class: the
                    # fold devices of a granule share one link bundle a
                    # granule pair, so their messages serialize
                    flat_groups.add(st["group"])
                    flat_lat += det["fold"] \
                        * float(coeff.get("latency_s", 0.0)) / k_ax
                    flat_wire += det["fold"] * st["payload_bytes"] \
                        / (float(coeff["GBps"]) * 1e9) / k_ax
            staged_s = lat_s + wire_s
            flat_s = flat_lat + flat_wire
            comm[axis] = {
                "ppermute_pairs": pairs, "per_link_bytes": per_link,
                "comm_every": k_ax,
                "latency_s": lat_s, "wire_s": wire_s,
                "s": staged_s,
                "staged": {
                    "fold": det["fold"],
                    "gather_axis": det["gather_axis"],
                    "dcn_pairs": det["dcn_pairs"],
                    "flat_dcn_pairs": det["flat_dcn_pairs"],
                    "dcn_msgs_ratio": (det["flat_dcn_pairs"]
                                       / max(1, det["dcn_pairs"])),
                    "stage_s": stage_s,
                    "staged_s": staged_s,
                    "flat_s": flat_s,
                    "wins": staged_s < flat_s,
                },
            }
            lat_total += lat_s
            wire_total += wire_s
            continue
        npairs = _axis_npairs(gg, axis_dims[axis])
        per_link = (rec["wire_bytes"] / npairs) if npairs else 0.0
        # a flat exchange on a granule-crossing axis funnels the fold
        # devices' messages through one link bundle a granule pair: they
        # serialize, M*lat + M*slab/bw
        lay = staged_wire_layout(gg, axis_dims[axis])
        mult = int(lay.fold) if lay is not None else 1
        lat_s = pairs * mult * float(coeff.get("latency_s", 0.0)) / k_ax
        wire_s = per_link * mult / (float(coeff["GBps"]) * 1e9) / k_ax
        comm[axis] = {"ppermute_pairs": pairs, "per_link_bytes": per_link,
                      "comm_every": k_ax,
                      "latency_s": lat_s, "wire_s": wire_s,
                      "s": lat_s + wire_s}
        if mult > 1:
            comm[axis]["dcn_msgs_per_link"] = mult
        lat_total += lat_s
        wire_total += wire_s
    # self-neighbour slab swaps never touch a link: memory traffic (read +
    # write) at the memory-bandwidth coefficient, amortized per axis
    local_copy_s = sum(
        2.0 * b / (profile.membw_GBps * 1e9) / cad.for_dim(axis_dims[a])
        for a, b in plan["local_copy_by_axis"].items())
    comm_s = lat_total + wire_total + local_copy_s
    # interior-first overlap credit from the slab geometry: each exchanging
    # dim peels a 2*ol-deep boundary shell off the local block that computes
    # BEFORE the exchange; only the interior remainder runs under it
    interior_frac = 1.0
    if overlap:
        interior = 1
        for d in range(min(3, len(shape0))):
            n_d = shape0[d] // int(gg.box[d])
            D = int(gg.dims[d])
            if D > 1 or bool(gg.periods[d]):
                n_d = max(0, n_d - 2 * int(gg.overlaps[d]))
            interior *= n_d
        interior_frac = interior / max(1, local_cells)
    exposed = max(0.0, comm_s - compute_s * interior_frac) if overlap \
        else comm_s
    step_s = compute_s + exposed

    # roofline verdict: the largest EXPOSED term names the regime
    scale = (exposed / comm_s) if (overlap and comm_s > 0) else 1.0
    terms = {"flops_s": flops_s, "hbm_s": hbm_s,
             "latency_s": lat_total * scale,
             "wire_s": (wire_total + local_copy_s) * scale}
    worst = max(terms, key=terms.get)
    bound = {"flops_s": "compute", "hbm_s": "bandwidth",
             "latency_s": "latency", "wire_s": "bandwidth"}[worst]
    detail = {"flops_s": "flops", "hbm_s": "hbm",
              "latency_s": "collective-launch", "wire_s": "wire"}[worst]
    if worst == "latency_s" and comm:
        # name the latency-dominant axis's knob
        dom = max(comm, key=lambda a: comm[a]["latency_s"])
        detail = f"comm_every[{'xyz'[axis_dims[dom]]}]"
        if "staged" in comm[dom] \
                or staged_wire_layout(gg, axis_dims[dom]) is not None:
            detail = f"wire_stage[{'xyz'[axis_dims[dom]]}]"
    rec = {
        "model": model_name,
        "profile_source": profile.source,
        "local_cells": local_cells,
        "ensemble": E,
        "comm_every": str(cad),
        "wire_stage": None if stg is None else str(stg),
        "compute": {"flops": flops, "hbm_bytes": hbm_bytes,
                    "flops_s": flops_s, "hbm_s": hbm_s, "s": compute_s},
        "comm": comm,
        "local_copy_s": local_copy_s,
        "comm_s": comm_s,
        "interior_frac": interior_frac,
        "exposed_comm_s": exposed,
        "step_s": step_s,
        "bound": bound,
        "bound_detail": detail,
        "terms": terms,
    }
    if E > 1:
        # per-member cost against the solo prediction of the same config
        solo = predict_step(model, fields, profile=profile,
                            comm_every=comm_every, overlap=overlap,
                            dims=dims, coalesce=coalesce,
                            wire_dtype=wire_dtype, wire_stage=stg,
                            impl=impl)
        rec["per_member_step_s"] = step_s / E
        rec["per_member_comm_s"] = comm_s / E
        rec["per_member_exposed_comm_s"] = exposed / E
        rec["solo_step_s"] = solo["step_s"]
        rec["ensemble_amortization"] = (
            (step_s / E) / solo["step_s"] if solo["step_s"] > 0 else 1.0)
    return rec


def _unwrap_field(f):
    """The bare tensor-like of a `halo_comm_plan`-style field argument:
    `ops.fields.Field` and ``(A, halowidths)`` tuples unwrap to their
    tensor."""
    from ..ops.fields import Field

    if isinstance(f, Field):
        return f.A
    if isinstance(f, tuple) and len(f) == 2 and hasattr(f[0], "shape") \
            and not hasattr(f[1], "shape"):
        return f[0]
    return f


def _shape_of(f) -> tuple:
    return tuple(int(s) for s in _unwrap_field(f).shape)


def _itemsize_of(f) -> int:
    from ..ops.precision import dtype_name
    from ..ops.wire import _itemsize

    try:
        return _itemsize(dtype_name(_unwrap_field(f).dtype))
    except Exception:
        return 4


def robust_z(value: float, history, *, rel_floor: float = 0.02,
             min_samples: int = 2) -> tuple:
    """The house robust z-score: ``(z, median, mad)`` of ``value``
    against ``history`` (an iterable of floats), with

        z = (value - median) / max(1.4826 * MAD, rel_floor * median, 1e-12)

    — the one estimator shared by `PerfWatch` (in-driver drift detection)
    and the JAX package's observer-side `telemetry.live.LiveAggregate`, so
    the two can never disagree on what counts as a regression. Returns
    ``(None, None, None)`` before ``min_samples`` history entries."""
    from statistics import median

    hist = list(history)
    if len(hist) < max(2, int(min_samples)):
        return None, None, None
    med = median(hist)
    mad = median([abs(x - med) for x in hist])
    sigma = max(1.4826 * mad, rel_floor * med, 1e-12)
    return (float(value) - med) / sigma, med, mad


class PerfWatch:
    """Live drift detector over per-chunk step times (host-side only).

    The driver feeds it one observation per chunk boundary
    (``observe(...)``); it maintains a rolling baseline of per-STEP
    execution time (median + MAD over ``window`` chunks — robust to the
    occasional slow fetch) and a modeled ratio when a prediction is
    given. An observation whose robust z-score

        z = (per_step - median) / max(1.4826 * MAD, rel_floor * median)

    exceeds ``zmax`` (after ``min_samples`` warm-up chunks) returns a
    regression record the driver emits as a ``perf_regression`` flight
    event. Chunks marked ``cold`` (the dispatch paid a compile after a
    runner-cache miss; the port caches no runner, so its driver marks
    none) update the gauges but neither test nor pollute the baseline. Every observation lands in the ``igg_perf_*`` gauges
    (`telemetry.hooks.observe_perf`), so the live ``/metrics`` endpoint
    always shows the current per-step time, model ratio, and z-score."""

    def __init__(self, *, window: int = 16, zmax: float = 4.0,
                 model_step_s: float | None = None, min_samples: int = 5,
                 rel_floor: float = 0.02):
        if window < 2:
            raise InvalidArgumentError(
                f"PerfWatch needs window >= 2 (got {window}).")
        self.window = int(window)
        self.zmax = float(zmax)
        # clamped to the window: a deque of maxlen=window can never hold
        # min_samples > window entries, which would silently disable the
        # z-test for small perf_window values
        self.min_samples = max(2, min(int(min_samples), self.window))
        self.rel_floor = float(rel_floor)
        self.model_step_s = (None if model_step_s is None
                             else float(model_step_s))
        self._hist: deque = deque(maxlen=self.window)
        self.regressions = 0

    def baseline_s(self) -> float | None:
        """The current warm per-step baseline (median of the rolling
        window), or None before ``min_samples`` warm chunks — the
        measured-price fallback the driver's deadline-slack computation
        uses when no perf model was attached."""
        from statistics import median

        if len(self._hist) < self.min_samples:
            return None
        return float(median(self._hist))

    def observe(self, *, chunk, step_begin, step_end, n, exec_s,
                cold: bool = False) -> dict | None:
        """One chunk boundary. Returns the regression record (or None)."""
        from .hooks import observe_perf

        per_step = float(exec_s) / max(1, int(n))
        ratio = (per_step / self.model_step_s
                 if self.model_step_s else None)
        z, med, mad = robust_z(per_step, self._hist,
                               rel_floor=self.rel_floor,
                               min_samples=self.min_samples)
        verdict = None
        if z is not None:
            if not cold and z > self.zmax:
                self.regressions += 1
                verdict = {"chunk": chunk, "step_begin": step_begin,
                           "step_end": step_end, "per_step_s": per_step,
                           "baseline_s": med, "mad_s": mad, "z": z,
                           "ratio": ratio}
        if not cold:
            self._hist.append(per_step)
        observe_perf(per_step, ratio=ratio, z=z,
                     regression=verdict is not None)
        return verdict
