"""The redistribution plan: Cartesian re-blocking as scheduled slice rounds.

Counterpart of `implicitglobalgrid_tpu/reshard/plan.py`. An elastic
``dims`` change re-blocks the SAME implicit global grid over a different
Cartesian decomposition. The checkpoint-based elastic restore
(`utils.checkpoint.restore_checkpoint_elastic`) already derives which
saved block sources every cell of every new block: per-axis owner maps
from the implicit-global-grid formula. This module reuses THAT math
(`utils.checkpoint.AxisRedistribution`, one copy, so the two paths cannot
diverge) and turns it into a **transfer plan**: the exact set of (source
block, destination block, sub-box) pieces, scheduled into **rounds** in
which every block sends at most one slab and receives at most one slab.
Each round is a partial permutation: one ``ppermute`` of the JAX package's
flat transfer mesh, and one recorded ``collective-permute`` of the port's
(`reshard.program`), whose padded per-block payload bounds the peak memory
of a round (the round scheduling of memory-efficient array
redistribution, arXiv:2112.01075).

Everything here is host-side numpy: a plan (and its `reshard_contract`) is
built, priced (`telemetry.predict_reshard`) and audited against a golden
dump without a grid or a device. The plan's JSON and fingerprint are the
JAX package's for the same topology and fields.

Conventions:

- Block ranks are row-major over the FULL 3-D ``dims`` (the linearized
  mesh positions of ``source_target_pairs``); fields of lower spatial rank
  pad their missing coordinates with 0.
- Flat slots are IDENTITY-mapped to ranks: destination rank ``q`` at slot
  ``q``, source rank ``r`` at slot ``r`` (``n_flat = max(prod(src_dims),
  prod(dst_dims))``), so the plan alone fixes every round's pairs.
- Pieces with ``src_rank == dst_rank`` never touch the wire: they are
  LOCAL copies.
- Leading member axes (the ensemble axis) pass through untouched: every
  payload carries all ``E`` members' slabs (same rounds, E x bytes).
- The device check: the JAX package refuses a move whose destination needs
  more devices than it can see (`device_pool`). The port's virtual mesh
  holds every rank on one card, so the count of devices bounds nothing;
  `check_device_memory` refuses a move whose destination state and largest
  round payload do not fit the card's free memory instead (no check on the
  CPU).
"""

from __future__ import annotations

import itertools
import json
from dataclasses import dataclass, field as dc_field

import numpy as np

from ..ops.wire import _itemsize, dtype_name
from ..utils.checkpoint import AxisRedistribution, elastic_local_size
from ..utils.exceptions import IncoherentArgumentError, InvalidArgumentError

__all__ = ["Piece", "Round", "SigPlan", "ReshardPlan",
           "build_reshard_plan", "live_topology", "fields_of_state",
           "apply_plan_host", "reshard_contract",
           "check_device_memory", "init_from_topology", "restore_topology",
           "piece_slices", "stacked_shapes"]

_NDIMS = 3


@dataclass(frozen=True)
class Piece:
    """One (source block -> destination block) sub-box transfer.

    ``src_start``/``dst_start``/``size`` are per-SPATIAL-axis tuples in
    each block's local coordinates (leading member axes excluded — they
    ride whole)."""

    src_rank: int
    dst_rank: int
    src_start: tuple
    dst_start: tuple
    size: tuple

    @property
    def cells(self) -> int:
        n = 1
        for s in self.size:
            n *= int(s)
        return n


@dataclass(frozen=True)
class Round:
    """One scheduled slice round = one ``ppermute``: a partial permutation
    (every source and every destination appears at most once), payload
    padded to ``pad`` (the elementwise max piece size of the round)."""

    pairs: tuple            # ((src_slot, dst_slot), ...) sorted by src
    pieces: tuple           # the Piece set this round carries
    pad: tuple              # per-spatial-axis padded payload extent


@dataclass(frozen=True)
class SigPlan:
    """All fields sharing one block signature (same spatial local shape,
    dtype, and leading member axes) move through the SAME rounds with
    their slabs stacked into one payload — fields in a round coalesce,
    exactly like the halo wire."""

    names: tuple            # field names, canonical order
    dtype: str              # numpy dtype name
    lead: tuple             # leading (member) axis sizes, () for solo
    src_block: tuple        # spatial local block on the source dims
    dst_block: tuple        # spatial local block on the destination dims
    rounds: tuple           # wire rounds (Round)
    local: tuple            # Piece list with src_rank == dst_rank

    @property
    def lead_cells(self) -> int:
        n = 1
        for s in self.lead:
            n *= int(s)
        return n

    def _mult(self) -> int:
        return self.lead_cells * len(self.names) * _itemsize(self.dtype)

    @property
    def wire_bytes(self) -> int:
        """Exact all-links bytes on wire: padded payload x directed pairs
        per round (what `ProgramIR.wire_bytes_of` measures in the
        program)."""
        m = self._mult()
        return sum(int(np.prod(r.pad, dtype=np.int64)) * len(r.pairs) * m
                   for r in self.rounds)

    @property
    def payload_bytes(self) -> int:
        """Useful (unpadded) bytes the wire pieces carry."""
        m = self._mult()
        return sum(p.cells * m for r in self.rounds for p in r.pieces)

    @property
    def local_bytes(self) -> int:
        m = self._mult()
        return sum(p.cells * m for p in self.local)

    @property
    def round_payload_bytes(self) -> list:
        """Per-round padded payload bytes PER DEVICE (the peak-HBM and
        link-time unit `telemetry.predict_reshard` prices)."""
        m = self._mult()
        return [int(np.prod(r.pad, dtype=np.int64)) * m for r in self.rounds]


@dataclass(frozen=True)
class ReshardPlan:
    """The complete (src_dims -> dst_dims) transfer program description."""

    src_dims: tuple
    dst_dims: tuple
    nxyz_src: tuple         # base local block on the source decomposition
    nxyz_dst: tuple
    overlaps: tuple
    periods: tuple
    halowidths: tuple
    n_flat: int             # flat-mesh extent = max(prod(src), prod(dst))
    sigs: tuple = dc_field(default_factory=tuple)

    @property
    def rounds(self) -> int:
        return sum(len(s.rounds) for s in self.sigs)

    @property
    def wire_bytes(self) -> int:
        return sum(s.wire_bytes for s in self.sigs)

    @property
    def payload_bytes(self) -> int:
        return sum(s.payload_bytes for s in self.sigs)

    @property
    def local_bytes(self) -> int:
        return sum(s.local_bytes for s in self.sigs)

    @property
    def dst_bytes(self) -> int:
        """Bytes of the whole destination state (every field, every
        block): what the move allocates beside the source state."""
        return sum(s._mult() * int(np.prod([self.dst_dims[d] * s.dst_block[d]
                                            for d in range(len(s.dst_block))],
                                           dtype=np.int64))
                   for s in self.sigs)

    @property
    def peak_payload_bytes(self) -> int:
        """Largest single-round per-device payload — with the destination
        block, the plan's peak-HBM bound per device."""
        per_round = [b for s in self.sigs for b in s.round_payload_bytes]
        return max(per_round) if per_round else 0

    def stats(self) -> dict:
        return {"rounds": self.rounds, "wire_bytes": self.wire_bytes,
                "payload_bytes": self.payload_bytes,
                "local_bytes": self.local_bytes,
                "peak_payload_bytes": self.peak_payload_bytes,
                "n_flat": self.n_flat,
                "src_dims": list(self.src_dims),
                "dst_dims": list(self.dst_dims)}

    def to_json(self) -> dict:
        return {
            **self.stats(),
            "nxyz_src": list(self.nxyz_src), "nxyz_dst": list(self.nxyz_dst),
            "overlaps": list(self.overlaps), "periods": list(self.periods),
            "halowidths": list(self.halowidths),
            "sigs": [{
                "names": list(s.names), "dtype": s.dtype,
                "lead": list(s.lead),
                "src_block": list(s.src_block),
                "dst_block": list(s.dst_block),
                "wire_bytes": s.wire_bytes,
                "local_pieces": len(s.local),
                "rounds": [{
                    "pairs": [list(p) for p in r.pairs],
                    "pad": list(r.pad),
                    "pieces": len(r.pieces),
                } for r in s.rounds],
            } for s in self.sigs],
        }

    def fingerprint(self) -> str:
        """Stable identity for program caching."""
        import hashlib

        return hashlib.sha1(
            json.dumps(self.to_json(), sort_keys=True).encode()).hexdigest()


# ---------------------------------------------------------------------------
# plan construction
# ---------------------------------------------------------------------------

def live_topology(gg=None) -> dict:
    """The `saved_topology`-shaped record of the LIVE grid — what
    `build_reshard_plan` takes as its source side (the on-device analog
    of reading a checkpoint's meta)."""
    from ..parallel.topology import global_grid

    gg = gg if gg is not None else global_grid()
    return {name: np.asarray(getattr(gg, name), dtype=np.int64).copy()
            for name in ("nxyz", "dims", "overlaps", "periods",
                         "halowidths")}


def _free_device_bytes(device):
    """Bytes the caching allocator can still hand out on ``device``: the
    driver's free memory plus what the allocator holds unused; None on the
    CPU (no check)."""
    import torch

    if getattr(device, "type", str(device)) != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    return int(free) + int(torch.cuda.memory_reserved(device)
                           - torch.cuda.memory_allocated(device))


def check_device_memory(plan: "ReshardPlan", device) -> None:
    """Refuse a move whose destination state plus its largest round
    payload do not fit ``device``'s free memory (the source state is
    already resident and stays until the move ends): the port's
    counterpart of the JAX package's device-pool check (module
    docstring). Raises `InvalidArgumentError` before any grid is touched;
    a no-op on the CPU."""
    free = _free_device_bytes(device)
    if free is None:
        return
    need = plan.dst_bytes + plan.peak_payload_bytes
    if need > free:
        raise InvalidArgumentError(
            f"reshard: the destination dims {plan.dst_dims} need {need} bytes of "
            f"device memory beside the source state; {free} free on {device}.")


def init_from_topology(topo: dict, *, nxyz=None, dims=None,
                       quiet: bool = True, device_type: str = "gpu"):
    """(Re-)init the global grid described by a `live_topology` /
    `saved_topology` dict, optionally onto different ``dims`` with the
    matching LOCAL ``nxyz``, on ``device_type``. The ONE grid rebuild of the
    reshard forward path and of its recovery, so the two cannot drift. It
    replaces a grid this process had: the process keeps the device that
    grid bound it to (no second `select_device`), and a process group stays
    up (``init_dist=False``)."""
    from ..parallel.grid import init_global_grid

    nx = [int(n) for n in (topo["nxyz"] if nxyz is None else nxyz)]
    d = [int(x) for x in (topo["dims"] if dims is None else dims)]
    p = [int(x) for x in topo["periods"]]
    init_global_grid(
        nx[0], nx[1], nx[2], dimx=d[0], dimy=d[1], dimz=d[2],
        periodx=p[0], periody=p[1], periodz=p[2],
        overlaps=tuple(int(o) for o in topo["overlaps"]),
        halowidths=tuple(int(h) for h in topo["halowidths"]),
        quiet=quiet, device_type=device_type, init_dist=False, select_device=False)


def restore_topology(topo: dict, *, quiet: bool = True,
                     device_type: str = "gpu") -> None:
    """Best effort: tear down whatever grid is live (if any) and put the
    ``topo`` grid back. For recovery handlers only — swallows its own
    failures so the original exception stays the one the caller sees."""
    from ..parallel.grid import finalize_global_grid
    from ..parallel.topology import grid_is_initialized

    try:
        if grid_is_initialized():
            finalize_global_grid()
        init_from_topology(topo, quiet=quiet, device_type=device_type)
    except Exception:
        pass


def fields_of_state(state: dict) -> dict:
    """``name -> (stacked shape, dtype name, leading member axes)`` of a
    driver state dict on the live grid — the field description
    `build_reshard_plan` consumes. The member axes come from each tensor's
    shape (`utils.checkpoint.member_axes`)."""
    from ..ops.wire import dtype_name
    from ..utils.checkpoint import member_axes

    return {k: (tuple(int(s) for s in v.shape), dtype_name(v.dtype),
                int(member_axes(v.shape, name=f"field {k!r}")))
            for k, v in state.items()}


def _ravel(coords, dims) -> int:
    c = list(coords) + [0] * (_NDIMS - len(coords))
    return int(np.ravel_multi_index(c, dims))


def _axis_runs(ax, c_new: int) -> list:
    """Contiguous (src_block, dst_start, src_start, length) runs covering
    destination block ``c_new`` along one axis: segments of `new_phys`
    where the owner block is constant AND the owner-local index advances
    by 1 (a periodic wrap or an owner change starts a new run, so every
    run is a plain contiguous slice on both sides)."""
    g = ax.new_phys(c_new)
    c_of, i_of = ax.c_of[g], ax.i_of[g]
    runs = []
    j0 = 0
    for j in range(1, len(g) + 1):
        if j == len(g) or c_of[j] != c_of[j0] or i_of[j] != i_of[j - 1] + 1:
            runs.append((int(c_of[j0]), j0, int(i_of[j0]), j - j0))
            j0 = j
    return runs


def _schedule_rounds(pieces) -> tuple:
    """Greedy edge coloring of the transfer multigraph: each round is a
    partial permutation (every src and dst at most once). Deterministic
    (pieces arrive sorted), and within a factor of the max degree of
    optimal — the degree bound is what bounds peak HBM and round count."""
    rounds: list = []        # [(used_src, used_dst, [pieces])]
    for p in pieces:
        for used_src, used_dst, members in rounds:
            if p.src_rank not in used_src and p.dst_rank not in used_dst:
                used_src.add(p.src_rank)
                used_dst.add(p.dst_rank)
                members.append(p)
                break
        else:
            rounds.append(({p.src_rank}, {p.dst_rank}, [p]))
    out = []
    for _, _, members in rounds:
        members.sort(key=lambda p: p.src_rank)
        nd = len(members[0].size)
        pad = tuple(max(int(p.size[d]) for p in members) for d in range(nd))
        pairs = tuple((p.src_rank, p.dst_rank) for p in members)
        out.append(Round(pairs=pairs, pieces=tuple(members), pad=pad))
    return tuple(out)


def build_reshard_plan(topo: dict, new_dims, fields: dict) -> ReshardPlan:
    """Derive the HBM-to-HBM transfer plan re-blocking ``fields`` from the
    decomposition in ``topo`` (a `live_topology`/`saved_topology` record)
    onto ``new_dims`` — same implicit global grid, same overlaps/periods.

    ``fields`` maps names to ``(stacked shape, dtype, lead)`` (see
    `fields_of_state`): shapes are the SOURCE-decomposition stacked
    layouts, staggered fields carrying their extra cells exactly as in
    the elastic restore. Raises `IncoherentArgumentError` when
    ``new_dims`` cannot decompose the global grid evenly."""
    src_dims = tuple(int(d) for d in np.asarray(topo["dims"]))
    new_dims = tuple(int(d) for d in new_dims)
    if len(new_dims) != _NDIMS or any(d < 1 for d in new_dims):
        raise InvalidArgumentError(
            f"build_reshard_plan: new_dims must be 3 positive ints; got "
            f"{new_dims}.")
    nxyz_src = tuple(int(n) for n in np.asarray(topo["nxyz"]))
    ol = tuple(int(o) for o in np.asarray(topo["overlaps"]))
    per = tuple(int(p) for p in np.asarray(topo["periods"]))
    hw = tuple(int(h) for h in np.asarray(topo["halowidths"]))
    nxyz_dst = tuple(int(n) for n in elastic_local_size(topo, new_dims))
    if src_dims == new_dims:
        raise InvalidArgumentError(
            f"build_reshard_plan: source and destination dims are both "
            f"{src_dims} — nothing to re-block.")
    n_src = int(np.prod(src_dims))
    n_dst = int(np.prod(new_dims))
    n_flat = max(n_src, n_dst)

    if not isinstance(fields, dict) or not fields:
        raise InvalidArgumentError(
            "build_reshard_plan expects a non-empty dict of name -> "
            "(shape, dtype, lead).")

    # group fields by block signature; keep first-seen name order
    groups: dict = {}
    for name, (shape, dtype, lead) in fields.items():
        shape = tuple(int(s) for s in shape)
        lead_sh = shape[:int(lead)]
        sp = shape[int(lead):]
        if not 1 <= len(sp) <= _NDIMS:
            raise InvalidArgumentError(
                f"field {name!r}: spatial rank {len(sp)} is outside 1..3 "
                f"(shape {shape}, lead {lead}).")
        loc_src = []
        for d, s in enumerate(sp):
            if s % src_dims[d]:
                raise IncoherentArgumentError(
                    f"field {name!r}: stacked size {s} along dimension "
                    f"{d} is not divisible by the source dims[{d}]="
                    f"{src_dims[d]}.")
            loc_src.append(s // src_dims[d])
        key = (lead_sh, tuple(loc_src), dtype_name(dtype))
        groups.setdefault(key, []).append(name)

    sigs = []
    for (lead_sh, loc_src, dtype), names in groups.items():
        nd_s = len(loc_src)
        axes, loc_dst = [], []
        for d in range(nd_s):
            stag = loc_src[d] - nxyz_src[d]   # staggered fields carry
            ln = nxyz_dst[d] + stag           # their extra cells along
            if ol[d] + stag < 0 or ln < 1:
                raise IncoherentArgumentError(
                    f"field(s) {names}: local block {loc_src[d]} along "
                    f"dimension {d} is inconsistent with the grid's "
                    f"nxyz[{d}]={nxyz_src[d]} / overlaps[{d}]={ol[d]} "
                    "(stacked shape not from this decomposition?).")
            axes.append(AxisRedistribution(
                loc_src[d], ln, src_dims[d], new_dims[d],
                ol[d] + stag, bool(per[d])))
            loc_dst.append(ln)
        pieces = []
        for c in itertools.product(*[range(new_dims[d])
                                     for d in range(nd_s)]):
            runs_per_axis = [_axis_runs(axes[d], c[d]) for d in range(nd_s)]
            dst_rank = _ravel(c, new_dims)
            for combo in itertools.product(*runs_per_axis):
                src_rank = _ravel([r[0] for r in combo], src_dims)
                pieces.append(Piece(
                    src_rank=src_rank, dst_rank=dst_rank,
                    src_start=tuple(r[2] for r in combo),
                    dst_start=tuple(r[1] for r in combo),
                    size=tuple(r[3] for r in combo)))
        pieces.sort(key=lambda p: (p.dst_rank, p.src_rank, p.dst_start))
        wire = [p for p in pieces if p.src_rank != p.dst_rank]
        local = tuple(p for p in pieces if p.src_rank == p.dst_rank)
        sigs.append(SigPlan(
            names=tuple(names), dtype=dtype_name(dtype), lead=lead_sh,
            src_block=tuple(loc_src), dst_block=tuple(loc_dst),
            rounds=_schedule_rounds(wire), local=local))

    return ReshardPlan(
        src_dims=src_dims, dst_dims=new_dims, nxyz_src=nxyz_src,
        nxyz_dst=nxyz_dst, overlaps=ol, periods=per, halowidths=hw,
        n_flat=n_flat, sigs=tuple(sigs))


# ---------------------------------------------------------------------------
# host oracle
# ---------------------------------------------------------------------------

def piece_slices(plan: ReshardPlan, sig: SigPlan, piece: Piece) -> tuple:
    """``(source selection, destination selection)`` of one piece in the
    STACKED layouts (the source decomposition's and the destination's),
    the member axes whole: the slices both the host oracle and the device
    program (`reshard.program`) copy between."""
    nd_s = len(sig.src_block)
    lead = tuple(slice(None) for _ in sig.lead)
    sc = _coords(piece.src_rank, plan.src_dims)[:nd_s]
    dc = _coords(piece.dst_rank, plan.dst_dims)[:nd_s]
    src = lead + tuple(slice(sc[d] * sig.src_block[d] + piece.src_start[d],
                             sc[d] * sig.src_block[d] + piece.src_start[d] + piece.size[d])
                       for d in range(nd_s))
    dst = lead + tuple(slice(dc[d] * sig.dst_block[d] + piece.dst_start[d],
                             dc[d] * sig.dst_block[d] + piece.dst_start[d] + piece.size[d])
                       for d in range(nd_s))
    return src, dst


def stacked_shapes(plan: ReshardPlan, sig: SigPlan) -> tuple:
    """``(source stacked shape, destination stacked shape)`` of a field of
    ``sig``, member axes first."""
    nd_s = len(sig.src_block)
    return (tuple(sig.lead) + tuple(plan.src_dims[d] * sig.src_block[d] for d in range(nd_s)),
            tuple(sig.lead) + tuple(plan.dst_dims[d] * sig.dst_block[d] for d in range(nd_s)))


def apply_plan_host(plan: ReshardPlan, state: dict) -> dict:
    """Execute the plan on HOST numpy arrays (source-stacked layout) —
    the pure-python oracle the device program (`reshard.program`) is
    tested bit-identical against. Moves raw bytes only (no arithmetic),
    exactly like the device program."""
    out: dict = {}
    for sig in plan.sigs:
        src_shape, dst_shape = stacked_shapes(plan, sig)
        pieces = [p for r in sig.rounds for p in r.pieces] + list(sig.local)
        for name in sig.names:
            src = np.asarray(state[name])
            if tuple(src.shape) != src_shape:
                raise InvalidArgumentError(
                    f"apply_plan_host: field {name!r} has shape "
                    f"{tuple(src.shape)}, the plan expects {src_shape}.")
            dst = np.zeros(dst_shape, dtype=src.dtype)
            for p in pieces:
                src_sel, dst_sel = piece_slices(plan, sig, p)
                dst[dst_sel] = src[src_sel]
            out[name] = dst
    return out


def _coords(rank: int, dims) -> tuple:
    return tuple(int(c) for c in np.unravel_index(rank, dims))


# ---------------------------------------------------------------------------
# the collective contract
# ---------------------------------------------------------------------------

def reshard_contract(plan: ReshardPlan, meta=None):
    """The plan's `analysis.CollectiveContract`: exactly one
    collective-permute per scheduled round on the flat ``rs`` axis, with
    byte-exact padded payloads (all-links total) and each permute's
    ``source_target_pairs`` matching one round's pair set verbatim — an
    unplanned route, a merged/split round, or a payload a byte off the
    schedule is an error finding. No all-reduces, no gathers, no
    all-to-alls: the program is pure permute rounds plus local copies.
    Host-derivable (routes come from the plan, not a live grid)."""
    from ..analysis.contracts import CollectiveContract, hlo_dtype

    dtypes = sorted({hlo_dtype(s.dtype) for s in plan.sigs if s.rounds})
    routes = tuple(frozenset(r.pairs) for s in plan.sigs for r in s.rounds)
    axes = None
    if plan.rounds:
        axes = {"rs": {"permutes": plan.rounds,
                       "wire_bytes": plan.wire_bytes,
                       "dtypes": tuple(dtypes)}}
    return CollectiveContract(
        axes=axes,
        routes={"rs": routes} if routes else None,
        allreduces=0,
        allreduce_payload=None,
        meta=dict(meta or {}, program="reshard",
                  src_dims=list(plan.src_dims),
                  dst_dims=list(plan.dst_dims),
                  rounds=plan.rounds))
