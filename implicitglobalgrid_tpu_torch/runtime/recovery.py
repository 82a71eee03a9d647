"""Recovery policy and elastic restart.

Counterpart of `implicitglobalgrid_tpu/runtime/recovery.py`: the POLICY of a
supervised run's failure loop (how many retries, how long to wait, when to
shrink the chunk) and the heavyweight move, ELASTIC RESTART: re-initialize
the grid with other ``dims`` (a lost or rearranged device) and redistribute
the last good checkpoint's blocks onto the new decomposition
(`utils.checkpoint.restore_checkpoint_elastic`).
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["RecoveryPolicy", "elastic_restart"]


@dataclass(frozen=True)
class RecoveryPolicy:
    """Bounded-retry rollback policy.

    ``max_retries``: consecutive guard trips (without a completed chunk in
    between) tolerated before the run raises `ResilienceError`.
    ``backoff_s``: sleep ``backoff_s * 2**(retry-1)`` before re-running a
    rolled-back chunk (0 in tests; nonzero absorbs transient hardware
    faults in production).
    ``shrink_chunk_after``: once this many consecutive trips happened, the
    run ESCALATES by halving its chunk size (bounded by
    ``min_nt_chunk``) — smaller chunks tighten the guard's detection
    latency and shrink the recompute window, the cheap analog of disabling
    deep-halo `comm_every` modes on repeated blow-ups.
    ``on_escalate``: optional callback ``(info: dict) -> None`` invoked at
    every escalation with ``{"retries", "nt_chunk", "step"}`` — the hook
    for model-level reactions (e.g. swapping in a runner without
    `comm_every` deep halos)."""
    max_retries: int = 3
    backoff_s: float = 0.0
    shrink_chunk_after: int = 2
    min_nt_chunk: int = 1
    on_escalate: object = None


def elastic_restart(ckpt_dir, new_dims, *, quiet: bool = True):
    """Re-initialize the grid decomposed as ``new_dims`` and restore
    ``ckpt_dir`` onto it.

    Reads the saved topology from the checkpoint meta (host-only — the
    'lost' grid need not be alive), finalizes any live grid, re-inits with
    the local block size that keeps the implicit global grid identical
    (`elastic_local_size`), and redistributes the saved blocks. Returns
    ``(state, step)``. Raises `IncoherentArgumentError` when ``new_dims``
    cannot decompose the saved global grid evenly. The new grid takes the
    live grid's device type (the card where no grid is live); a process
    group stays up."""
    from ..parallel.grid import finalize_global_grid, init_global_grid
    from ..parallel.topology import global_grid, grid_is_initialized
    from ..utils.checkpoint import (
        elastic_local_size, restore_checkpoint_elastic, saved_topology,
    )

    topo = saved_topology(ckpt_dir)
    new_dims = tuple(int(d) for d in new_dims)
    nxyz = elastic_local_size(topo, new_dims)
    device_type = "gpu"
    if grid_is_initialized():
        device_type = global_grid().device_type
        finalize_global_grid()
    per = [int(p) for p in topo["periods"]]
    init_global_grid(
        nxyz[0], nxyz[1], nxyz[2],
        dimx=new_dims[0], dimy=new_dims[1], dimz=new_dims[2],
        periodx=per[0], periody=per[1], periodz=per[2],
        overlaps=tuple(int(o) for o in topo["overlaps"]),
        halowidths=tuple(int(h) for h in topo["halowidths"]),
        quiet=quiet, device_type=device_type, init_dist=False)
    return restore_checkpoint_elastic(ckpt_dir)
