"""Machine calibration: short measured runs -> a `MachineProfile`.

Counterpart of `implicitglobalgrid_tpu/telemetry/calibrate.py`. The cost
model (`telemetry.perfmodel`) is only as good as its coefficients, so the
profile is MEASURED on the live grid, in windows of a few milliseconds:

- ``membw_GBps``: a triad (2 reads + 1 write, ``a <- b + 0.5 a``, one
  PyTorch kernel) over arrays spanning the grid's blocks. On a card the
  two arrays together are at least 4x its L2 cache, so the rate is the
  device memory's, not the cache's (``meta["triad_elems_per_device"]``
  records the elements used);
- ``flops_G``: a chain of 64 dependent multiply-adds an iteration, kept in
  registers by the hand-written `ops.cuda_calibrate.fma_chain` kernel (one
  load and one store an element); on a card the array fills every SM at
  its thread limit (``meta["fma_elems_per_device"]``);
- per-axis ``{"GBps", "latency_s"}``: the port's own exchange,
  `local_update_halo(x, dims=(dim,))` on a field thin along ``dim`` (the
  route `ops.halo.halo_routes` picks), in a Python loop of ``c`` calls at a
  small and a large slab payload: the two-point fit ``t(S) = latency_s +
  S / GBps``. On the virtual mesh the "link" is that exchange between
  blocks of one card, and its latency term absorbs the eager host cost of
  an exchange, which the port pays.

Per-device rates are the card's rate shared by the blocks (the JAX
package's emulated CPU mesh has the same semantics). Every timed window
ends in `utils.timing.sync` (the device drained); on a card each window is
grown until its smaller call takes at least ``min_window_s``
(``meta["windows"]``), so the fixed cost of a launch and a synchronize
stays small beside it. `calibrate_machine` needs an initialized grid and
returns (and with ``path`` persists) a `MachineProfile` with
``source="calibrated"``, in the JAX package's JSON format.
"""

from __future__ import annotations

import math
import time

from ..utils.exceptions import InvalidArgumentError
from .perfmodel import MachineProfile, save_machine_profile

__all__ = ["calibrate_machine"]

# the smallest timed window on a card (seconds): a launch and a synchronize
# cost microseconds, which a window of milliseconds keeps small beside it
MIN_WINDOW_S = 2e-3


def _two_point(run_chunk, c1: int, c2: int, reps: int = 3) -> float:
    """Steady-state seconds an iteration from two warmed one-call windows
    (the two-window slope idiom: both windows pay the same fixed costs).
    Min of ``reps`` a window: the least-contended estimate on a shared
    host. ``run_chunk(c)`` runs ``c`` iterations and drains the device."""
    run_chunk(c1)
    run_chunk(c2)

    def timed(c):
        t0 = time.perf_counter()
        run_chunk(c)
        return time.perf_counter() - t0

    t1 = min(timed(c1) for _ in range(reps))
    t2 = min(timed(c2) for _ in range(reps))
    if t2 <= t1:  # timer jitter: fall back to the inclusive rate
        return t2 / c2
    return (t2 - t1) / (c2 - c1)


def _grown(run_chunk, c1: int, on_card: bool, min_window_s: float) -> int:
    """``c1``, doubled on a card until one call of it takes at least
    ``min_window_s`` (its first call warms up)."""
    if not on_card:
        return c1
    run_chunk(c1)
    while True:
        t0 = time.perf_counter()
        run_chunk(c1)
        if time.perf_counter() - t0 >= min_window_s or c1 >= 1 << 24:
            return c1
        c1 *= 2


def _blocks(gg) -> int:
    return int(gg.box[0]) * int(gg.box[1]) * int(gg.box[2])


def _sharded_ones(gg, elems_per_device: int, dtype, min_total: int = 0):
    """A stacked tensor of this process's box of (m, m, m) blocks, m^3 ~
    ``elems_per_device`` (at least 8^3), grown until the whole tensor has
    ``min_total`` elements. Returns (tensor, m^3)."""
    import torch

    m = max(8, int(round(elems_per_device ** (1.0 / 3.0))))
    nb = _blocks(gg)
    if nb * m ** 3 < min_total:
        m = int(math.ceil((min_total / nb) ** (1.0 / 3.0)))
    shape = tuple(int(b) * m for b in gg.box)
    return torch.ones(shape, dtype=dtype, device=gg.device), m ** 3


def _measure_membw_gbps(gg, elems_per_device: int, c1: int, meta: dict) -> float:
    """Per-device achieved triad bandwidth (2R + 1W) over the live grid."""
    import torch

    from ..utils.timing import sync

    on_card = gg.device.type == "cuda"
    min_total = 0
    if on_card:  # the two arrays at least 4x the L2 cache
        l2 = int(torch.cuda.get_device_properties(gg.device).L2_cache_size)
        min_total = -(-4 * l2 // 8)
    a, local_elems = _sharded_ones(gg, elems_per_device, torch.float32, min_total)
    b, _ = _sharded_ones(gg, elems_per_device, torch.float32, min_total)

    def chunk(c):
        for _ in range(c):
            torch.add(b, a, alpha=0.5, out=a)
        sync(a)

    c1 = _grown(chunk, c1, on_card, MIN_WINDOW_S)
    s = _two_point(chunk, c1, 3 * c1)
    meta["triad_elems_per_device"] = local_elems
    meta["windows"]["membw"] = c1
    return 3 * 4 * local_elems / s / 1e9


def _measure_flops_g(gg, elems_per_device: int, c1: int, meta: dict) -> float:
    """Per-device achieved FMA rate (many FLOPs a byte: the compute
    roofline, not a second bandwidth measurement), from the calibration
    kernel (`ops.cuda_calibrate.fma_chain`; its plain version on the CPU)."""
    import torch

    from ..ops.cuda_calibrate import FMA_PER_ITER, fma_chain
    from ..utils.timing import sync

    on_card = gg.device.type == "cuda"
    min_total = 0
    if on_card:  # every SM at its thread limit
        prop = torch.cuda.get_device_properties(gg.device)
        min_total = int(prop.multi_processor_count) * int(
            getattr(prop, "max_threads_per_multi_processor", 2048))
    a, local_elems = _sharded_ones(gg, elems_per_device // 8, torch.float32, min_total)

    def chunk(c):
        sync(fma_chain(a, c))

    c1 = _grown(chunk, c1, on_card, MIN_WINDOW_S)
    s = _two_point(chunk, c1, 3 * c1)
    meta["fma_elems_per_device"] = local_elems
    meta["windows"]["flops"] = c1
    return 2 * FMA_PER_ITER * local_elems / s / 1e9


def _measure_axis_link(gg, dim: int, small_bytes: int, large_bytes: int,
                       c1: int, meta: dict) -> dict:
    """One mesh axis's effective link coefficients from the port's own
    exchange (`local_update_halo(x, dims=(dim,))`, ``c`` calls a window),
    timed at two slab payloads: ``t(S) = latency_s + S / GBps``. The field
    is thin along the measured axis (its slab bytes scale with the
    cross-section) and keeps the grid's own local extent along it."""
    import torch

    from ..ops.halo import local_update_halo
    from ..utils.timing import sync

    on_card = gg.device.type == "cuda"
    hw = max(1, int(gg.halowidths[dim]))

    def exchange_time(nbytes: int):
        # one-direction slab payload = mm^2 * hw * 4 bytes
        mm = max(8, int(round((nbytes / (hw * 4)) ** 0.5)))
        local = [mm] * 3
        local[dim] = int(gg.nxyz[dim])
        x = torch.ones(tuple(l * int(b) for l, b in zip(local, gg.box)),
                       dtype=torch.float32, device=gg.device)

        def run_chunk(c):
            nonlocal x
            for _ in range(c):
                x = local_update_halo(x, dims=(dim,))
            sync(x)

        c = _grown(run_chunk, c1, on_card, MIN_WINDOW_S)
        meta["windows"].setdefault("links", {})[f"{dim}:{mm * mm * hw * 4}"] = c
        return _two_point(run_chunk, c, 3 * c), mm * mm * hw * 4

    t_small, s_small = exchange_time(small_bytes)
    t_large, s_large = exchange_time(large_bytes)
    if t_large > t_small and s_large > s_small:
        bw = (s_large - s_small) / (t_large - t_small)
        lat = max(0.0, t_small - s_small / bw)
    else:  # jitter collapse: charge everything to bandwidth
        bw = s_large / t_large
        lat = 0.0
    return {"GBps": bw / 1e9, "latency_s": lat}


def calibrate_machine(path=None, *, elems_per_device: int = 1 << 18,
                      link_bytes=(1 << 13, 1 << 20), c1: int = 4,
                      ensemble: int | None = None,
                      profile_meta: dict | None = None) -> MachineProfile:
    """Measure this grid's machine profile (the JAX package's signature and
    defaults).

    Needs an initialized grid: its blocks on its device ARE the machine
    being profiled (per-device rates share the device between the blocks;
    per-axis links are measured along the grid's own dims).
    ``elems_per_device`` sizes the bandwidth and FLOP arrays (on a card
    raised as the module docstring says); ``link_bytes=(small, large)`` are
    the two payloads of the per-axis link fit; ``c1`` is the small window's
    iteration count (grown on a card, `MIN_WINDOW_S`). Axes with a single
    rank carry no link and are priced as the mean of the measured axes.
    ``ensemble=E`` scales the two link payloads by E (the batched
    exchange's regime) and records E in ``meta``. With ``path`` the profile
    is also saved as JSON. Returns the `MachineProfile`
    (``source="calibrated"``). On a card the FLOP fit runs the calibration
    kernel, which raises if it cannot build or launch."""
    from ..parallel.topology import AXIS_NAMES, check_initialized, global_grid

    check_initialized()
    gg = global_grid()
    if len(link_bytes) != 2 or link_bytes[0] >= link_bytes[1]:
        raise InvalidArgumentError(
            f"calibrate_machine: link_bytes must be (small, large) with "
            f"small < large; got {tuple(link_bytes)}.")
    if ensemble is not None:
        E = int(ensemble)
        if E < 1:
            raise InvalidArgumentError(
                f"calibrate_machine: ensemble must be >= 1; got "
                f"{ensemble}.")
        link_bytes = (int(link_bytes[0]) * E, int(link_bytes[1]) * E)
        profile_meta = dict(profile_meta or {}, ensemble=E)

    t0 = time.time()
    meta = {"windows": {}}
    membw = _measure_membw_gbps(gg, elems_per_device, c1, meta)
    flops = _measure_flops_g(gg, elems_per_device, c1, meta)
    axes = {}
    for dim in range(3):
        if int(gg.dims[dim]) <= 1:
            continue  # no link between blocks along this axis
        axes[AXIS_NAMES[dim]] = _measure_axis_link(
            gg, dim, int(link_bytes[0]), int(link_bytes[1]), c1, meta)

    device = {"platform": gg.device_type,
              "dims": [int(d) for d in gg.dims],
              "n_shards": int(gg.nprocs)}
    if gg.device.type == "cuda":
        import torch

        device["device_kind"] = torch.cuda.get_device_name(gg.device)
    else:
        device["device_kind"] = "cpu"
    profile = MachineProfile(
        membw_GBps=membw, flops_G=flops, axes=axes, source="calibrated",
        device=device, calibrated_at=t0,
        meta={**(profile_meta or {}),
              "elems_per_device": int(elems_per_device),
              "link_bytes": [int(b) for b in link_bytes],
              **meta,
              "calibrate_s": time.time() - t0})
    if path is not None:
        save_machine_profile(profile, path)
    return profile
