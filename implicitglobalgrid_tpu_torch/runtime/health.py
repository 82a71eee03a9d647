"""Health guards for long runs, computed after each chunk.

Counterpart of `implicitglobalgrid_tpu/runtime/health.py`. After the last
step of a chunk (`make_state_runner(post_chunk=...)`), each field contributes
its non-finite count and its float32 sum of squares over the STACKED layout
(halos and overlap cells counted per copy), summed over the blocks of the
process's box and then over the processes by ONE `transport.all_sum`: the
JAX package's ``(2N,)`` vector and its one ``psum`` a chunk, whatever the
field count. Checking the final state is sound for the blow-ups the guard
targets: a NaN or Inf born anywhere in a stencil state propagates and
persists, so it is still there at the chunk boundary.

The non-finite counts are exact (float32 counts, exact up to 2^24); the
sums of squares are float32 sums in another order than XLA's, equal to the
JAX package's within a relative tolerance.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from ..parallel.topology import NDIMS, global_grid

__all__ = ["GuardConfig", "HealthReport", "make_guarded_runner",
           "health_stats_local", "health_parts_local", "report_from_stats",
           "ensemble_reports_from_stats"]


@dataclass(frozen=True)
class GuardConfig:
    """What trips the guard.

    ``check_nonfinite``: any NaN/Inf cell in any field trips (default ON).
    ``rms_limit``: a divergence threshold on the field's RMS, one scalar for
    every field or a dict ``name -> limit`` (fields absent from it are
    unchecked). The RMS is over the STACKED layout, accumulated in float32."""
    check_nonfinite: bool = True
    rms_limit: float | dict | None = None

    def limit_for(self, name: str):
        if isinstance(self.rms_limit, dict):
            return self.rms_limit.get(name)
        return self.rms_limit


@dataclass(frozen=True)
class HealthReport:
    """A chunk's guard verdict. ``nonfinite`` counts NaN/Inf cells per
    field; ``rms`` is the stacked layout's RMS per field; ``reasons`` names
    every tripped guard (``"nonfinite:T"``, ``"rms:T"``); ``ok`` is ``not
    reasons``. An ensemble's chunk gives one report a member (``member``,
    None for a solo run)."""
    chunk: int
    step_begin: int
    step_end: int
    nonfinite: dict
    rms: dict
    reasons: tuple = ()
    member: int | None = None

    @property
    def ok(self) -> bool:
        return not self.reasons


def health_parts_local(state, members: int | None = None):
    """This process's guard contributions before the sum: the float32
    vector ``[nonfinite_0, norm2_0, nonfinite_1, ...]`` over every block of
    its box, on the state's device; ``(members, 2N)`` for an ensemble's
    state, whose tensors lead with the member axis. A field of fewer
    physical axes than the grid's is replicated over the other dims: as
    the JAX package's psum counts each replica shard, its parts count
    ``box[d]`` copies along each of them."""
    import torch

    gg = global_grid()
    lead = 0 if members is None else 1
    parts = []
    for x in state:
        axes = tuple(range(lead, x.dim()))
        copies = 1.0
        for d in range(max(0, x.dim() - lead), NDIMS):
            copies *= int(gg.box[d])
        xf = x.float()
        parts.append((~torch.isfinite(x)).to(torch.float32).sum(dim=axes) * copies)
        parts.append((xf * xf).sum(dim=axes) * copies)
    return torch.stack(parts, dim=-1)


def health_stats_local(state, members: int | None = None):
    """The post-chunk guard (`make_state_runner(post_chunk=)`): the
    ``(2*nfields,)`` float32 vector of `health_parts_local` summed over the
    processes with ONE `transport.all_sum`, equal on every process."""
    return global_grid().transport.all_sum(health_parts_local(state, members))


def make_guarded_runner(step_local, *, nt_chunk: int, key=None,
                        ensemble: int | None = None):
    """`models.common.make_state_runner` with the health guard after the
    chunk: ``run(*state) -> (*state, stats_vec)``. ``key`` is accepted for
    parity with the JAX package's callers. With ``ensemble=E`` the stats
    are an ``(E, 2N)`` matrix, one row a member, behind one sum
    (`ensemble_reports_from_stats`)."""
    from ..models.common import make_state_runner

    return make_state_runner(
        step_local, nt_chunk=nt_chunk,
        key=None if key is None else (key, "igg_health_guard"),
        post_chunk=health_stats_local, ensemble=ensemble)


def report_from_stats(vec, names, sizes, guard: GuardConfig, *,
                      chunk: int, step_begin: int, step_end: int,
                      member: int | None = None) -> HealthReport:
    """The host-side `HealthReport` of a fetched stats vector. ``sizes``
    are the stacked cell counts per field (the RMS denominator)."""
    if hasattr(vec, "detach"):
        vec = vec.detach().cpu().tolist()
    nonfinite, rms, reasons = {}, {}, []
    for i, name in enumerate(names):
        bad = float(vec[2 * i])
        norm2 = float(vec[2 * i + 1])
        nonfinite[name] = int(bad)
        r = math.sqrt(norm2 / sizes[i]) if sizes[i] else 0.0
        if math.isnan(norm2) or math.isinf(norm2):
            r = float("inf")  # a float32 norm2 overflow: divergence either way
        rms[name] = r
        if guard.check_nonfinite and bad > 0:
            reasons.append(f"nonfinite:{name}")
        limit = guard.limit_for(name)
        if limit is not None and not r <= float(limit):
            reasons.append(f"rms:{name}")
    return HealthReport(chunk=chunk, step_begin=step_begin,
                        step_end=step_end, nonfinite=nonfinite, rms=rms,
                        reasons=tuple(reasons), member=member)


def ensemble_reports_from_stats(mat, names, sizes, guard: GuardConfig, *,
                                chunk: int, step_begin: int, step_end: int) -> list:
    """One `HealthReport` a member from an ensemble chunk's ``(E, 2N)``
    stats matrix. ``sizes`` are the PER-MEMBER stacked cell counts."""
    if hasattr(mat, "detach"):
        mat = mat.detach().cpu().tolist()
    return [report_from_stats(mat[m], names, sizes, guard, chunk=chunk,
                              step_begin=step_begin, step_end=step_end, member=m)
            for m in range(len(mat))]
