"""The device program of a reshard: plan rounds -> block-view copies on the card.

Counterpart of `implicitglobalgrid_tpu/reshard/program.py`. `reshard_state`
is the fast path of an elastic ``dims`` change: it re-blocks the LIVE state
onto a new decomposition with no disk round trip and no host copy.
Mechanics, in order:

1. The plan (`reshard.plan.build_reshard_plan`) is derived from the live
   grid's topology and the state's shapes (host arithmetic only), and the
   destination state must fit the card's free memory
   (`plan.check_device_memory`).
2. The grid is re-initialized onto the destination dims (same implicit
   global grid, `elastic_local_size` math), as `runtime.recovery.
   elastic_restart` does; the state stays on the card across the swap.
3. The program (`compile_reshard_program`, cached by plan fingerprint, LRU
   8) runs the plan: for each scheduled round, every piece is one
   `Tensor.copy_` from the source block's view of the source stacked
   tensor into the destination block's view of a new stacked tensor, on
   the card; the local pieces follow. Every rank's block lives in one
   stacked tensor of one process (the virtual mesh), so the JAX package's
   flat transfer mesh and its ``ppermute`` collapse into these copies: the
   same bytes, moved inside one card's memory. JAX's transfer is a
   ``ppermute`` program, not a Pallas kernel, so no kernel of its own
   stands behind it.
4. Under a recording (`analysis.record`), each round is recorded as one
   ``collective-permute`` over its pairs on the flat ``rs`` axis with the
   round's scheduled (padded) payload, the unit `reshard_contract` and
   `telemetry.predict_reshard` price: `audit_reshard_program` holds the
   recording against the contract. The copies move each piece's own cells.

One process only: under a `torch.distributed` transport of more than one
process the source blocks of other processes are not on this card, and
`reshard_state` raises `InvalidArgumentError` before touching anything, as
the JAX package's multi-controller check does; the driver's
``resize(via="auto")`` then takes the checkpoint path
(`restore_checkpoint_elastic`), which stays the verified fallback and the
bit-identity oracle.
"""

from __future__ import annotations

from ..utils.exceptions import InvalidArgumentError
from .plan import (
    ReshardPlan, build_reshard_plan, fields_of_state, live_topology, piece_slices,
    reshard_contract, stacked_shapes,
)

__all__ = ["ReshardProgram", "reshard_state", "compile_reshard_program",
           "audit_reshard_program", "clear_program_cache"]

# programs by (plan fingerprint, device): a resize bounced back and forth
# builds each direction's program once; LRU-bounded, as the JAX package's
_PROGRAM_CACHE_MAX = 8
_program_cache: dict = {}


def clear_program_cache() -> None:
    _program_cache.clear()


class ReshardProgram:
    """A plan's copies, built once: per field signature, the rounds in
    schedule order (the wire rounds, then the local pieces), each a tuple
    of ``(source selection, destination selection)`` in the stacked
    layouts. ``program(state) -> new state`` runs them on the state's
    device; a recording sees each wire round as one permute."""

    def __init__(self, plan: ReshardPlan):
        from ..analysis.record import Shape, hlo_dtype

        self.plan = plan
        self.sigs = []
        for sig in plan.sigs:
            rounds = []
            for r in sig.rounds:
                payload = Shape(hlo_dtype(sig.dtype), (len(sig.names),) + tuple(sig.lead)
                                + tuple(int(v) for v in r.pad))
                rounds.append((r.pairs, payload,
                               tuple(piece_slices(plan, sig, p) for p in r.pieces)))
            local = tuple(piece_slices(plan, sig, p) for p in sig.local)
            self.sigs.append((sig, stacked_shapes(plan, sig), tuple(rounds), local))
        self.reports = {}  # audit verdicts by lint selection

    def __call__(self, state: dict) -> dict:
        import torch

        from ..analysis import record

        out = {}
        for sig, (src_shape, dst_shape), rounds, local in self.sigs:
            srcs = []
            for name in sig.names:
                src = state[name]
                if tuple(src.shape) != src_shape:
                    raise InvalidArgumentError(
                        f"reshard: field {name!r} has shape {tuple(src.shape)}, the plan "
                        f"expects {src_shape}.")
                srcs.append(src)
                out[name] = torch.empty(dst_shape, dtype=src.dtype, device=src.device)
            dsts = [out[name] for name in sig.names]
            for pairs, payload, copies in rounds:
                if record.ACTIVE is not None:
                    record.ACTIVE.permute(pairs, payload, site="reshard")
                for src, dst in zip(srcs, dsts):
                    for s_sel, d_sel in copies:
                        dst[d_sel].copy_(src[s_sel])
            for src, dst in zip(srcs, dsts):
                for s_sel, d_sel in local:
                    dst[d_sel].copy_(src[s_sel])
        return out


def compile_reshard_program(plan: ReshardPlan) -> ReshardProgram:
    """The plan's program (cached by fingerprint, LRU 8)."""
    key = plan.fingerprint()
    program = _program_cache.pop(key, None)
    if program is None:
        program = ReshardProgram(plan)
    _program_cache[key] = program  # re-insert = most recent
    while len(_program_cache) > _PROGRAM_CACHE_MAX:
        _program_cache.pop(next(iter(_program_cache)))
    return program


def audit_reshard_program(plan: ReshardPlan, src, state=None, *, lints=None):
    """Hold a reshard's recording against its plan-derived contract
    (`reshard_contract`: one permute a scheduled round on ``rs``, its pairs
    verbatim, byte-exact padded payloads, no sums or gathers), plus the
    lints. ``src`` is the `analysis.record.Recording` of a run of the
    program, or a `ReshardProgram` (or any callable of the state), then run
    once on ``state`` under the recorder."""
    from ..analysis import audit_program
    from ..analysis.lints import default_lint_config
    from ..analysis.record import Recording, record_program

    if not isinstance(src, Recording):
        if state is None:
            raise InvalidArgumentError(
                "audit_reshard_program: a program needs the state to run on.")
        src = record_program(src, state)
    cfg = default_lint_config(state_dtypes={s.dtype for s in plan.sigs})
    return audit_program(src, contract=reshard_contract(plan), lints=lints,
                         lint_config=cfg,
                         meta={"program": "reshard",
                               "src_dims": list(plan.src_dims),
                               "dst_dims": list(plan.dst_dims)})


def reshard_state(state: dict, new_dims, *, quiet: bool = True,
                  audit: bool = False, lints=None):
    """Re-block the live ``state`` onto ``new_dims`` on the card (no host
    round trip) and re-initialize the global grid to match. Returns
    ``(new_state, info)``: ``info`` carries the plan stats (``rounds``,
    ``wire_bytes``, ``local_bytes``, ``peak_payload_bytes``, ...) and
    ``audit_report`` (an `analysis.AuditReport` with ``audit``, else None;
    the program runs once under the recorder, and a cached program keeps
    its verdict by lint selection).

    The result is bitwise a sharded save + `restore_checkpoint_elastic`
    onto the new decomposition: the plan reuses that path's owner-map
    arithmetic and the program copies raw bytes. Raises
    (`IncoherentArgumentError` / `InvalidArgumentError`) without touching
    the grid when the move is impossible — across processes, when the dims
    cannot decompose the grid, when the destination does not fit the
    card's memory — so that the caller (`runtime.ResilientRun.resize`)
    can fall back to the checkpoint path; a failure after the grid swap
    puts the source grid back and leaves ``state`` untouched."""
    from ..analysis.record import recording
    from ..parallel.grid import finalize_global_grid
    from ..parallel.topology import check_initialized, global_grid
    from .plan import check_device_memory, init_from_topology, restore_topology

    check_initialized()
    gg = global_grid()
    if int(gg.transport.world) > 1:
        raise InvalidArgumentError(
            "On-device resharding runs in one process: the source blocks of "
            "other processes are not on this card; runs across processes keep "
            "the checkpoint-based elastic restore.")
    topo = live_topology(gg)
    plan = build_reshard_plan(topo, new_dims, fields_of_state(state))
    # the destination must fit BEFORE the source grid is torn down:
    # failing here leaves the caller's grid (and its fallback) intact
    check_device_memory(plan, gg.device)
    device_type = gg.device_type
    finalize_global_grid()
    try:
        init_from_topology(topo, nxyz=plan.nxyz_dst, dims=plan.dst_dims,
                           quiet=quiet, device_type=device_type)
        program = compile_reshard_program(plan)
        report = audit_error = None
        lkey = None if lints is None else tuple(lints)
        if audit and lkey not in program.reports:
            with recording() as rec:
                new_state = program(state)
            try:
                program.reports[lkey] = audit_reshard_program(plan, rec, lints=lints)
            except Exception as e:
                # the audit OBSERVES: a checker failure must not push a
                # healthy move onto the disk fallback
                audit_error = f"{type(e).__name__}: {e}"
        else:
            new_state = program(state)
        if audit:
            report = program.reports.get(lkey)
    except BaseException:
        # put the SOURCE grid back, so that the caller (the driver's
        # via="auto") can still run its checkpoint fallback on a live grid;
        # the original state tensors were never written
        restore_topology(topo, quiet=quiet, device_type=device_type)
        raise
    info = dict(plan.stats(), audit_report=report)
    if audit_error is not None:
        info["audit_error"] = audit_error
    return new_state, info
