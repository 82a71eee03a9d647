#!/usr/bin/env python3
"""Drive the PyTorch port (`implicitglobalgrid_tpu_torch`) on one CUDA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, in order; any failure exits non-zero without the final line:

1. build the CUDA kernels from `implicitglobalgrid_tpu_torch/csrc/`; print
   each kernel's ptxas report, K1's, K4's, K4s's, K9's and K10's registers,
   stack and spills for each template, and check K1's, K4's and K10's SASS for
   the IEEE division (K1 and K4: the division by Cp alone; no spills in
   their float32 and bfloat16 templates); sweep the division helper of
   `cdiv.cuh` over every float32 numerator (and a float64 sample) against
   IEEE division for config 5's divisors and random ones;
2. hold every kernel against its plain PyTorch version on the card, at the
   main paths' shapes (K5 and the slab kernel K4s to TOL; K1 and K4 in
   float32, float64 and bfloat16, halo copies K2/K3/K6, K9 in float32,
   float64 and bfloat16, K10 and the batched K4s wave and Stokes modes
   bitwise), and time
   kernel, plain version and PyTorch library call (CUDA events), and each
   kernel's device time alone (torch.profiler); each K4s mode's launch
   along x, y and z beside its byte bound (and along z its 32-byte sector
   bound): the step on the 128^3 mesh and config 3, the wave and Stokes
   modes on config 4's and 5's meshes; K8 and then K7 along x, y and z on
   config 4's (P, Vx, Vy, Vz) and config 5's (Vx, Vy, Vz, P) coalesced
   groups, each pair held bitwise first, beside their byte and 32-byte
   sector bounds (`k78_dim_times`); K6 by part at 2x2x2 x 256^3 in float32
   and float64 (`k6_part_times`) and K2 a launch on the main paths' shapes
   (`k2_dim_times`), each held bitwise first, beside byte and sector
   bounds; the device time of the library calls beside K2, K3, K6, K7 and
   K8 (`library_device_ms`);
3. main path, periodic: `init_global_grid(256, 256, 256, periodic)` ->
   `init_diffusion3d` -> warm chunk -> tic -> `run_diffusion(nt=100)` -> toc
   -> `update_halo` -> `gather_interior`, against the same run with
   ``IGG_USE_PALLAS=0`` (the plain path on the card); K1 on the run's own
   states (at the start and after its steps);
4. the same, non-periodic (the reference example's novis configuration);
5. the virtual mesh: a 2x2x2 grid of 128^3 blocks (the fused step +
   exchange K4s/K4, the combined `update_halo` K4s/K6), bitwise and
   run-tolerance checks against the plain path, a 2x2x1 `update_halo` with
   z not exchanging and a 2-D `update_halo` with halowidth 2 (the per-dim
   tier, K4s/K2), and a small run against the CPU; K4 on the run's own
   states;
6. BASELINE config 3: 2x2x2 blocks of 256^3, periodic, float64, 20 steps,
   against the plain path and against K1 + `update_halo` for one step; K4
   on the run's own states;
7. BASELINE config 2: a 2x2 mesh of 4096^2 blocks, periodic, float32, 100
   steps of the 2-D fused step (K4s/K5), against the plain path;
8. BASELINE config 4 (3-D acoustic wave) on one 192^3 block, float32, all
   periodic: `init_acoustic3d` -> warm chunk -> tic -> `run_acoustic(nt=600,
   nt_chunk=60)` -> toc -> `gather_interior`, the all-self route (K9 alone),
   against the same run with ``IGG_USE_PALLAS=0`` (the plain route); K9
   on the run's own states (`k9_kernels_ms`) and the route's host, wall and
   device time a step;
9. config 4 on a 2x2x2 mesh of 192^3 blocks, 100 steps: the fused route
   (3 K4s wave-mode launches, one a dim for the four fields, + K9) against
   the plain route; a coalesced `update_halo(P, Vx, Vy, Vz)` (K8 + K7, one
   group a dim) bitwise against the plain grid's; a few steps of
   ``impl="plain"`` (K8/K7 for the velocities, K4s/K6 for P) against
   ``IGG_USE_PALLAS=0``; K9 on the run's own states (`k9_kernels_ms`), the
   fused and the plain route's host, wall and device time a step; a
   bfloat16 run, bitwise
   against the kernels' plain versions on the card for a few steps and
   held to float64 beside the plain route;
10. BASELINE config 5 (3-D pseudo-transient Stokes) on one 128^3 block,
   float32, non-periodic, through the port's Stokes example
   (`implicitglobalgrid_tpu_torch.examples.stokes3D_multixpu`):
   `init_stokes3d` -> warm chunk -> tic -> `run_stokes` in chunks of 500
   with `stokes_residuals` after each until max(residuals) < 5e-4 or 6000
   iterations -> toc -> `gather_interior(P)`, K10 alone; its first 100
   iterations against ``IGG_USE_PALLAS=0``;
11. config 5 on a 2x2x2 mesh of 128^3 blocks, 300 iterations of the fused
   route (3 K4s Stokes-mode launches, one a dim for the four fields, + 1
   K10 an iteration); its first 20 against the plain route (K8 + K7 for the
   (Vx, Vy, Vz, P) group); both routes' host, wall and device time an
   iteration;
12. overlap and deep halos on the virtual mesh, the plain route, float32:
   diffusion on phase 5's mesh, 20 steps with ``overlap=True`` (the
   exchange of the shells on a side stream, the interior on the current
   one), then on overlaps 4, halowidths 2, 20 steps at ``comm_every=2`` and
   ``"z:2"`` against cadence 1; acoustic on config 4's mesh, 10 steps
   overlapped, then 10 at ``comm_every=2``; Stokes on config 5's mesh, 20
   iterations overlapped, then 20 at ``comm_every=2`` on overlaps 8,
   halowidths 4 (dV skipped); every run bitwise against the same grid's
   plain run at cadence 1, its exchange launches a step checked; host, wall
   and device ms a step of each overlapped and deep route beside its plain
   route, the device's busy time, and the hidden share of the exchange (the
   side stream's device time under the other streams' work, from the
   package's `trace` read back through `utils.trace_events`, by stream);
12b. profiling: the package's `trace`, `overlap_stats` and `op_breakdown`
   on phase 5's mesh, 10 steps of the kernel route, then 4 overlapped
   plain-route steps: a device plane, each kernel's count in
   `op_breakdown` equal to its launch counter, ``comm_us`` equal to the
   exchange spans' summed device time, ``overlap_frac`` equal to phase
   12's hidden share of the same capture;
12c. the ensemble axis (`ensemble_state`, ``run_*(..., ensemble=E)``), plain
   route, float32: K8 and K7 with 4 members bitwise their plain versions;
   diffusion on 2x2x2 x 128^3, all periodic, at E = 1, 4 and 16; acoustic
   on config 4's mesh and Stokes on config 5's at E = 4: member 0 bitwise
   the solo run, member 1 not, K8 and K7 launches a step flat in E, the
   int8 wire's members bitwise their solo int8 runs; wall ms a step a
   member beside the solo step, `overlap_stats` of the E = 16 run;
12d. the advanced-modes example at its card sizes (stochastic rounding
   nearer float32 than plain bfloat16);
13. the halo wire formats (``wire_dtype`` / ``IGG_HALO_WIRE_DTYPE``) and
   stochastic-rounding storage: `update_halo` on the 2x2x2 mesh of 128^3
   blocks, periodic and mixed, under bfloat16, float16, int8, int4 and
   ``"z:int8,x:float32"``: config 4's (P, Vx, Vy, Vz) group (K8 + K7) and one
   field (K4s + K2 under a cast, K8 + K7 quantized), bitwise against the
   kernels' plain versions, a NaN in one send slab arriving as a wholly NaN
   slab, ms beside the exact wire's and the device's busy time outside the
   kernels (the codec); the fused routes of config 3's, config 4's and
   config 5's meshes under int8 and bfloat16 against the kernels' plain
   versions and the plain route under the same wire, their distance from
   the exact wire's run, ms a step beside the exact wire's (config 4 under
   int8, whose two routes quantize different slabs as the JAX package's own
   two tiers do, held to the plain route within `INT8_LEVELS_A_STEP` int8
   levels a step); the int8 wire's
   drift at bench_f64_accuracy.py's configuration (2x2x2 x 48^3, 400 steps)
   under 0.02; sr=True bfloat16 against float32 (within 0.05 and a fifth of
   plain bfloat16's error), one seed reproducible and another different, and
   the sr step's ms beside plain bfloat16's on the 128^3 mesh;
13b. checkpoint and io: the main path (256^3 periodic, K1) for 400 steps in
   chunks of 200 with a `SnapshotWriter` taking T and Cp every chunk (the
   last snapshot's `read_global("T")` bitwise `gather_interior(T)`, the
   first one's bitwise its chunk's T though the donating runner wrote the
   submitted tensor next; submit ms, the chunk's wall with and without a
   snapshot, the writer's bytes/s); config 4's mesh (3 K4s + K9) saved
   sharded after 10 steps (~0.91 GB), restored, 10 more steps bitwise the
   uninterrupted 20 (save and restore ms and GB/s, the sha256 share of
   each); the 128^3 diffusion mesh (K4s + K4) saved on 2x2x2 and restored
   by `elastic_restart` onto 4x2x1, `gather_interior` bitwise; the guard
   (`make_guarded_runner`) and the reducers (`make_reduced_post_chunk`:
   a probe, a z line, T's stats) on that mesh's kernel route against plain
   PyTorch on the card (counts, probe, line, min and max bitwise, sums
   within IO_SUM_RTOL), a `poke_nan` tripping ``nonfinite:T``, the hook's
   ms; in a temporary directory, removed after;
13c. the supervised run (`run_resilient`): the main path (256^3 periodic,
   K1) for 400 steps in chunks of 100, the bare donating runner giving the
   reference T; the driver with its default knobs (the guard only) giving
   T bitwise; then with a checkpoint and a snapshot every 200 steps, a
   `Stats` reducer, a `NaNPoke` at step 250 and a flight recorder, T
   bitwise again, exactly one report tripped (``nonfinite:T``), and
   `run_report` of the stream showing one rollback, three saves, one
   restore and two snapshots, K1 launched once a step the driver ran (the
   replayed ones included); chunk ms of the bare runner, the step adapter
   alone, the guard-only and the full run, the save, restore and rollback
   ms, the `Stats` hook's and the guard's ms. The 128^3 mesh (2x2x2
   periodic in x, K4s + K4), 40 steps in chunks of 10 with a checkpoint
   every 20: a `ProcessLoss` at step 20 leaves the grid 4x2x1 on the card,
   `gather_interior(T)` bitwise the uninterrupted 2x2x2 run; a bit-flipped
   second save and a NaN roll back onto the other slot and end bitwise.
   Then the fifth example (`examples.diffusion3D_multixpu`) at its card
   size: 10 frames, the last bitwise the z-midplane of `gather_interior(T)`;
   in a temporary directory, removed after;
13d. the performance oracle and the mesh view: the calibration kernel
   (`fma_chain`, `csrc/calibrate.cu`) against its plain version on the card
   and timed beside its FLOP bound; `calibrate_machine` on the main path's
   256^3 block and on the 2x2x2 x 128^3 mesh (the triad's card rate under
   3.35 TB/s x 1.05, the FMA chain's under the float32 peak x 1.05, a link
   fit for every axis); `predict_step` under the mesh's profile beside the
   measured wall ms a step (`route_times`) of the fused and the plain
   route on the README mesh, config 4's mesh and config 5's mesh;
   `tune_config("diffusion3d")` on the 2x2x2 x 128^3 grid, measured, top 2
   (speedup >= 1; the caller's grid back with its epoch and its halos
   bitwise); `run_resilient(tuned=, metrics_port=0)` on the 256^3 main
   path, 3 chunks of 100 (K1 once a step, /metrics and /healthz scraped
   from ``on_report``, the ``tuned`` event in the stream); `update_halo`
   on the 128^3 mesh with and without its accounting, the recorder off
   and on, the accounting's own host us a call, the ``igg_halo_*``
   counters against `halo_comm_plan` times the calls;
13e. the communication audit and the on-device reshard: `audit_model` of
   diffusion3d on the 2x2x2 x 256^3 mesh (periodic in x), acoustic3d on
   config 4's mesh and stokes3d on config 5's, under impl="cuda" and
   "plain" (every report ok, the perf-model crosscheck clean, each axis's
   recorded permutes, pairs, wire bytes and dtypes printed);
   `run_resilient(audit=True)` on the 256^3 mesh, 300 steps in chunks of
   100 (one clean audit, K4 once a step, T bitwise an unaudited run's, the
   audited chunk's ms beside the others); the mesh resized 2x2x2 -> 4x2x1
   at step 100 on the device path (its reshard audit clean), the
   checkpoint path and not at all, the gathered interiors bitwise equal,
   each path's ms, the plan's rounds and bytes and `predict_reshard`'s
   seconds; config 4's (P, Vx, Vy, Vz) resharded in one move bitwise
   `apply_plan_host`;
13f. the service and the live plane: a `MeshScheduler` (``policy="fair"``,
   a flight directory, `default_rule_pack()` alerts, a `ControlFileSink`
   filing into an operator's directory the scheduler does not consume)
   runs three tenants through `builtin_setup`, float32 on the plain route,
   each submitted with its own `TraceContext`: diffusion on the 2x2x2 x
   256^3 mesh (periodic x), config 4 on its 2x2x2 x 192^3 mesh and config
   5 on its 2x2x2 x 128^3 mesh, 100 steps each in chunks of 25, config 5
   with a `NaNPoke` at step 50 that trips its guard and rolls back. Each
   tenant's final state bitwise the same `JobSpec` run alone through
   `run_resilient`; the guard trip and rollback only in config 5; the
   alert fired on it and its control file filed; each tenant's exchange
   launches (K6/K2 and K4s for diffusion, K8 + K7 for the coalesced
   groups) its solo run's, and its setup's plus the steps it ran times a
   step's; a `LiveAggregate` polled after every slice, its last snapshot
   agreeing with `service_report`/`run_report` of the directory (jobs,
   slices, steps, guard trips); `export_otlp` giving one span tree a job
   under its submitted context. Then an autoscale drill on the diffusion
   tenant: a shrink by one axis through the device path of
   `ResilientRun.resize`, the gathered interior bitwise the solo run's,
   `explain_autoscale` naming the move. The ``service`` line: interleaved
   wall against the solo walls' sum, grant-to-chunk and context-switch
   ms, admission pricing ms, the autoscaler's decision ms and the resize
   ms, `LiveAggregate` poll ms, `export_otlp` ms and spans, the card's
   name and power limit;
13g. serve and the CLI: a `JobApiServer` and a `MeshScheduler(nranks=8)`
   over one flight directory; three job records POSTed (h1: diffusion
   float32 on the 2x2x2 x 256³ main path, snapshotting T; h2: config 4's
   acoustic mesh, resized over HTTP to 2x2x1; h3: the diffusion mesh,
   cancelled over HTTP mid-run) and ``/v1/jobs`` polled until each is
   terminal; the kernel launches of the HTTP-submitted jobs by job (K6 and
   K4s for the diffusion jobs, K8, K7, K6 and K4s for h2); a point, a z
   plane and the whole field of h1's last snapshot read through
   `SnapshotQueryServer`, each byte-identical to `read_global`, cold and
   then from its `BlockCache`; ``/v1/observe`` and ``/v1/events`` (resumed
   from a ``since=`` cursor, no gap, no duplicate); then ``python -m
   implicitglobalgrid_tpu_torch.tools`` in subprocesses on the card: ``jobs
   submit`` of h1's record (its last snapshot bitwise h1's), ``calibrate``,
   ``audit`` of the three families, ``reshard run``, ``snapshots``,
   ``probe``, ``report``, ``watch --once``, then ``tune`` model-only and
   measured on the calibrated profile, each exit code checked. The
   ``serve`` line: submit-to-admission ms, each query's ms and MB/s cold
   and cached, the cache's hit rate, a ``/v1/observe`` poll's ms, the
   launches by job, each command's exit code and seconds, the card's name
   and power limit;
14. the transport: two processes of this script (``--transport-child``)
   share cuda:0 in a gloo process group (NCCL refuses two processes on one
   card), the grids split along z (``IGG_TPU_DCN_AXES=z``, a 2x2x1 box
   each): config 3 (20 fused steps, K4s + K4, then `update_halo`, K4s +
   K6), config 4's mesh (10 fused steps, K4s wave modes + K9, then a
   coalesced `update_halo(P, Vx, Vy, Vz)`, K8 + K7), config 5's mesh
   (20 iterations, K4s Stokes modes + K10, and `stokes_residuals`) and
   phase 12's diffusion mesh (10 plain-route steps without and with
   ``overlap=True``, each process's `overlap_stats` of both, 10 at
   ``comm_every=2`` on the halowidth-2 grid), diffusion at E = 1 and 4 on
   the all-periodic mesh (E = 4's messages a step E = 1's, 4x its bytes), and
   under int8 and bfloat16 config 3's fused steps and config 4's coalesced
   `update_halo`, each gathered to process 0 and held bitwise against
   phases 6, 9, 11, 12, 12c and 13's runs of the same steps on the virtual mesh;
   per step the wall ms, the wire bytes (under a wire format beside the
   exact wire's), the exchange's and gloo's host staging ms, beside the
   virtual mesh's step; after the diffusion mesh's plain steps each process
   writes its box's shards and a `SnapshotWriter` snapshot (process 0
   commits) and computes the guard-and-reducer vector after
   `transport.all_sum`: the checkpoint restores on the virtual mesh bitwise
   phase 12's state, the snapshot reads bitwise its `gather_interior`, the
   vector equals the virtual mesh's; then both processes run
   `run_resilient` on the diffusion mesh's plain route (10 steps, a shared
   checkpoint directory, a `NaNPoke` in process 1's box), the gathered T
   bitwise phase 12's 10 plain steps, each process's own flight stream
   (its rank as ``proc``, ``flight_p<rank>.jsonl`` in one directory)
   holding the guard trip and the rollback; the parent then aggregates
   the directory (`aggregate_flight`, `straggler_report`, `run_report`'s
   ``mesh`` section, `export_chrome_trace`): both processes, finite
   offsets, each chunk's spans ending within 1 ms of each other; then
   `run_resilient(audit=True)` on the same mesh's kernel route resized to
   4x1x2 at step 10 with ``via="auto"``: a clean chunk audit on each
   process before and after, `reshard_state` refused across processes, the
   checkpoint path taken, the gathered interior bitwise the unresized run's;
15. numbers: the card's name and power limit, each kernel's time, bound,
   plain and library times (one JSON line), cell-updates/s, host against
   device time per step of the fused routes, phase 13b's checkpoint and io
   numbers, phase 13c's ``supervised_run``, phase 13d's
   ``oracle_and_mesh_view``, phase 13e's ``audit_and_reshard``, phase 13f's
   ``service`` line, phase 13g's ``serve`` line, and the main paths' K4s
   launches by mode and dim (the
   kernels line holds K1-K10, K4s and the calibration kernel).

The last line is ``{"ok": true, "device": {...}}``. The script imports
nothing of JAX. It needs one card and exits non-zero without CUDA or
without the package beside it. ``--transport-child <pid> <port>`` runs one
process of phase 14, ``--profiling-child <out.json>`` phase 12b in a process
of its own (the script starts them itself).
"""

import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12     # H100 SXM data sheet, float32 outside the tensor cores
STEP_FLOPS_PER_CELL = 29    # divisions, products and sums of one K1 cell update
STEP2D_FLOPS_PER_CELL = 20  # the same for the 2-D cell update (no y term)
TOL = {"float32": dict(rtol=2e-6, atol=2e-5), "float64": dict(rtol=1e-13, atol=1e-12),
       "bfloat16": dict(rtol=2 ** -7, atol=0.0)}
F64_RUN_TOL = dict(rtol=1e-12, atol=1e-12)
RUN_TOL = dict(rtol=1e-5, atol=1e-4)  # the JAX suite's multi-step bound
N_MAIN = 256  # local block of the main path (the reference's per-GPU block)
N_MESH = 128  # local block of the 2x2x2 virtual mesh
N_CFG3 = 256  # BASELINE config 3: 256^3 per block on a 2x2x2 mesh, float64
N_CFG2 = 4096  # BASELINE config 2: 4096^2 per block on a 2x2 mesh, float32
N_CHECK = 64  # block of the kernel-vs-plain checks on 2x2x2 grids (2-D: N_CHECK2D)
N_CHECK2D = 256
N_CFG4 = 192  # BASELINE config 4: 192^3 per block, float32 (one block; a 2x2x2 mesh)
WAVE_FLOPS_PER_CELL = 19  # a pressure cell and its three faces: 10 + 3 x 3
N_CFG5 = 128  # BASELINE config 5: 128^3 per block, float32 (one block; a 2x2x2 mesh)
# a PT iteration a cell: its cell terms 21, three edge stresses 18, three
# residuals with their damped-momentum and velocity updates 39
STOKES_FLOPS_PER_CELL = 78
# every kernel of the port, by its launch counter, with the part of its name
# torch.profiler shows that every kernel it launches holds, and the counters
# of the exchange's kernels: filled from the package's
# (`implicitglobalgrid_tpu_torch.utils.profiling`) once it imports (`_load_names`)
KERNEL_NAMES: dict = {}
EXCHANGE_KERNELS: tuple = ()
K4S_STAGGERED = "exchange_slabs_staggered_kernel"  # the batched staggered modes of K4s


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)
    print(f"  ok: {msg}", flush=True)


def median_ms(fn, batches=7, per_batch=10, warm=3):
    """Per-call time (ms): CUDA events around ``per_batch`` back-to-back
    calls, the median over ``batches``. Back-to-back calls keep the device
    fed, so host overhead shows only where it exceeds the kernel's time."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(batches):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(per_batch):
            fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e) / per_batch)
    return statistics.median(ts)


def _profile(fn, reps):
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return prof.key_averages()


def device_ms(fn, kernel, reps=20, tries=3):
    """Device time (ms) per call of ``fn`` spent in the kernels whose name
    holds ``kernel``, from torch.profiler (CUPTI) over ``reps`` calls; None
    where the profiler records no device time. A profile whose count of
    such kernels is not a multiple of ``reps`` lost records: it is taken
    again, up to ``tries`` times."""
    for _ in range(tries):
        evs = [ev for ev in _profile(fn, reps) if kernel in ev.key]
        if sum(ev.count for ev in evs) % reps == 0:
            break
    tot = sum(ev.device_time_total for ev in evs)
    return tot / reps / 1e3 if tot > 0 else None


def route_times(fn, reps=10, batches=5):
    """Host and device time per call of ``fn`` (one step of a route): the
    host's enqueue time (the calls alone) and the wall time (the calls and
    a synchronize), medians over ``batches`` of ``reps`` calls, and the
    device time of the port's kernels in them (torch.profiler), by kernel.
    Where wall time exceeds device time, the host holds the card back."""
    import torch

    fn()
    torch.cuda.synchronize()
    host, wall = [], []
    for _ in range(batches):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host.append((t1 - t0) / reps * 1e3)
        wall.append((t2 - t0) / reps * 1e3)
    evs = _profile(fn, reps)
    by = {}
    for name, kname in KERNEL_NAMES.items():
        t = sum(ev.device_time_total for ev in evs if kname in ev.key) / reps / 1e3
        if t > 0:
            by[name] = t
    return dict(wall_ms_per_step=statistics.median(wall),
                host_ms_per_step=statistics.median(host),
                device_ms_per_step=sum(by.values()) or None, device_ms_by_kernel=by)


def max_err(got, ref):
    return float((got.double() - ref.double()).abs().max())


def close(a, b, rtol, atol):
    import torch

    return bool(torch.allclose(a.float() if a.dtype == torch.bfloat16 else a,
                               b.float() if b.dtype == torch.bfloat16 else b,
                               rtol=rtol, atol=atol))


def rand_state(shape, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    T = (100 * torch.rand(shape, generator=g, device="cuda")).to(dtype)
    Cp = (1 + 5 * torch.rand(shape, generator=g, device="cuda")).to(dtype)
    return T.contiguous(), Cp.contiguous()


CONSTS = dict(lam=1.0, dt=0.0123, dx=0.037, dy=0.041, dz=0.029)


def phase_kernels(igg_ops, counts_before):
    """Phase 2: every kernel against its plain version, and its timings."""
    import torch

    cs, ch, cb, cw, cst, tg = igg_ops
    rows = {}
    # K1: the step at the main path's shapes and dtypes
    cases = [((256, 256, 256), torch.float32, (True, True, True)),
             ((256, 256, 256), torch.float32, (False, False, False)),
             ((256, 256, 256), torch.float32, (True, False, True)),
             ((64, 64, 64), torch.float64, (True, True, True)),
             ((128, 128, 128), torch.bfloat16, (False, False, False)),
             ((128, 128, 128), torch.bfloat16, (True, True, True))]
    for k, (shape, dt, fuse) in enumerate(cases):
        T, Cp = rand_state(shape, dt, k)
        got = cs.diffusion3d_step_halo(T, Cp, fuse=fuse, **CONSTS)
        ref = cs.diffusion3d_step_halo_plain(T, Cp, fuse=fuse, **CONSTS)
        torch.cuda.synchronize()
        name = str(dt).replace("torch.", "")
        err = max_err(got, ref)
        check(torch.equal(got, ref),
              f"K1 {shape} {name} fuse={fuse} bitwise equal to plain (max abs err {err:.3e})")
        if k == 0:
            out = torch.empty_like(T)
            ms = median_ms(lambda: cs.diffusion3d_step_halo(
                T, Cp, fuse=fuse, out=out, **CONSTS))
            plain = median_ms(lambda: cs.diffusion3d_step_halo_plain(
                T, Cp, fuse=fuse, **CONSTS), batches=3, per_batch=3, warm=1)
            cells = T.numel()
            bound_b = cs.step_bytes(T) / HBM_BYTES_PER_S * 1e3
            bound_o = cells * STEP_FLOPS_PER_CELL / F32_FLOPS_PER_S * 1e3
            rows["diffusion3d_step_halo"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain,
                device_ms=device_ms(lambda: cs.diffusion3d_step_halo(
                    T, Cp, fuse=fuse, out=out, **CONSTS), "diffusion3d_step_halo_kernel"),
                bound_ms=max(bound_b, bound_o),
                bound_by="bytes" if bound_b >= bound_o else "operations",
                library_ms=None, shape="256^3 float32 fuse (T,T,T)")
        del T, Cp, got, ref

    rows["halo_write"] = check_k2(ch)
    rows["halo_self_exchange"] = check_k3(ch)
    rows["diffusion3d_step_exchange"] = check_k4(cs)
    rows["diffusion2d_step_exchange"] = check_k5(cs)
    rows["halo_write_combined"] = check_k6(ch)
    rows["halo_write_combined"]["parts"] = k6_part_times(ch)
    rows["halo_write"]["dims"] = k2_dim_times(ch)
    rows["exchange_slabs"] = k4s = check_k4s(cs)
    k4s["max_abs_err"] = max(k4s["max_abs_err"], check_k4s_wave(cs, cw, tg))
    rows["wire_pack"], rows["halo_write_multi"] = check_k7_k8(ch, tg)
    dims78 = k78_dim_times(ch)
    for name, k in (("wire_pack", "k8"), ("halo_write_multi", "k7")):
        rows[name]["dims"] = {g: {d: r[k] for d, r in rs.items()} for g, rs in dims78.items()}
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], *(
            r[k]["max_abs_err"] for rs in dims78.values() for r in rs.values()))
    rows["acoustic_step_exchange"] = check_k9(cw, tg)
    k4s["max_abs_err"] = max(k4s["max_abs_err"], check_k4s_stokes(cs, cst, tg))
    k4s["dims"] = dims = k4s_dim_times(cs, cw, cst, tg)
    k4s["max_abs_err"] = max(k4s["max_abs_err"],
                             *(r["max_abs_err"] for rs in dims.values() for r in rs.values()))
    for mode in ("wave", "stokes"):  # the y dims' launches, as earlier runs kept them
        y = dims[mode][1]
        k4s.update({f"{mode}_mode_ms": y["ms"], f"{mode}_mode_device_ms": y["device_ms"],
                    f"{mode}_mode_bound_ms": y["bound_ms"], f"{mode}_mode_bound_by": y["bound_by"]})
    rows["stokes_step_exchange"] = check_k10(cst, tg)
    counts = cb.launch_counts()
    for name in rows:
        check(counts[name] > counts_before[name], f"{name} launch counter moved")
    return rows


def rand_slabs(shape, block, dims, dtype, g, hws=(1, 1, 1)):
    """Random received slabs (K2's layout) for each dim in ``dims``."""
    import torch

    out = {}
    for d in dims:
        ss = list(shape)
        ss[d] = shape[d] // block[d] * hws[d]
        out[d] = tuple((100 * torch.rand(ss, generator=g, device="cuda")).to(dtype)
                       for _ in range(2))
    return out


def name_of(dt):
    return str(dt).replace("torch.", "")


def rand_field(shape, dtype, g):
    """A random stacked field on the card: floats in [0, 1000), integers
    over their whole range."""
    import torch

    if dtype.is_floating_point:
        return (1000 * torch.rand(shape, generator=g, device="cuda")).to(dtype)
    info = torch.iinfo(dtype)
    return torch.randint(info.min, info.max, shape, generator=g, device="cuda", dtype=dtype)


def library_device_ms(fn, reps=10, tries=3):
    """Device time (ms) a call of ``fn`` spends in every kernel and copy it
    runs on the card, from torch.profiler over ``reps`` calls, and their
    count a call: a library function of several PyTorch calls without its
    host time. (None, count) where the profiler records no device time."""
    from torch.autograd import DeviceType

    for _ in range(tries):
        evs = [ev for ev in _profile(fn, reps) if ev.device_type == DeviceType.CUDA]
        n = sum(ev.count for ev in evs)
        if n % reps == 0:
            break
    tot = sum(ev.device_time_total for ev in evs)
    return (tot / reps / 1e3 if tot > 0 else None), n // reps


# K2's card checks: (block, dtype); 2 blocks a dim (4 for the 1-D field).
# 128 cells of 4 bytes and 64 of 1, 2 or 8 make rows of whole 16-byte words,
# 61 does not (scalar copies)
K2_CHECKS = [((128,) * 3, "float32"), ((N_CHECK,) * 3, "float64"), ((N_CHECK,) * 3, "int8"),
             ((N_CHECK,) * 3, "int16"), ((N_CHECK, N_CHECK, N_CHECK - 3), "float32"),
             ((N_CHECK, N_CHECK, N_CHECK - 3), "int8"), ((N_CHECK, N_CHECK), "float32"),
             ((N_CHECK, N_CHECK), "int16"), ((N_CHECK,), "float64")]


def check_k2(ch):
    """K2 against its plain version, bitwise: every dim and halowidths 1 and
    2 on the blocks and dtypes of `K2_CHECKS` (3-D, 2-D and 1-D fields; rows
    in 16-byte words and in scalars); then its timing row, the three
    launches of one `update_halo` of 2x2x2 x 128^3 float32, hw 1, beside
    its byte and 32-byte sector bounds and the slice copies' device time."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(7)
    k2_err = 0.0
    for block, dname in K2_CHECKS:
        dt = getattr(torch, dname)
        counts = (4,) if len(block) == 1 else (2,) * len(block)
        shape = tuple(c * b for c, b in zip(counts, block))
        A = rand_field(shape, dt, g)
        for dim in range(len(block)):
            for hw in (1, 2):
                ss = list(shape)
                ss[dim] = counts[dim] * hw
                sl, sr = rand_field(tuple(ss), dt, g), rand_field(tuple(ss), dt, g)
                a1, a2 = A.clone(), A.clone()
                ch.halo_write(a1, sl, sr, dim=dim, hw=hw, block=block[dim])
                ch.halo_write_plain(a2, sl, sr, dim=dim, hw=hw, block=block[dim])
                torch.cuda.synchronize()
                k2_err = max(k2_err, max_err(a1, a2))
                check(torch.equal(a1, a2),
                      f"K2 {counts} x {block} {dname} dim {dim} hw {hw} bitwise equal to plain")
    A = torch.randn((256, 256, 256), generator=g, device="cuda")
    slabs = []
    for dim in range(3):
        ss = list(A.shape)
        ss[dim] = 2
        slabs.append((torch.randn(ss, generator=g, device="cuda"),
                      torch.randn(ss, generator=g, device="cuda")))

    def k2_all():
        for dim, (sl, sr) in enumerate(slabs):
            ch.halo_write(A, sl, sr, dim=dim, hw=1, block=128)

    def k2_plain():
        for dim, (sl, sr) in enumerate(slabs):
            ch.halo_write_plain(A, sl, sr, dim=dim, hw=1, block=128)

    def k2_library():  # one slice copy_ per block and side, as a user writes it
        for dim, (sl, sr) in enumerate(slabs):
            for c in range(2):
                A.narrow(dim, c * 128, 1).copy_(sl.narrow(dim, c, 1))
                A.narrow(dim, c * 128 + 127, 1).copy_(sr.narrow(dim, c, 1))

    bound, sectors = halo_write_bounds(A.shape, 4, [
        k2_box(A.shape, (128,) * 3, dim, 1) for dim in range(3)])
    lib_dev, lib_n = library_device_ms(k2_library)
    return dict(
        max_abs_err=k2_err, ms=median_ms(k2_all), plain_ms=median_ms(k2_plain),
        device_ms=device_ms(k2_all, "halo_write_kernel"),
        bound_ms=bound, bound_by="bytes", sector_bound_ms=sectors,
        library_ms=median_ms(k2_library), library_device_ms=lib_dev, library_kernels=lib_n,
        shape="dims 0,1,2 (3 launches) of one update_halo, 2x2x2 x 128^3 float32, hw 1")


def check_k3(ch):
    """K3 on every non-empty mode combination on a 256^3 block, bitwise, and
    against the sequential slice copies; its timing row, modes (T,T,T)."""
    import itertools

    import torch

    g = torch.Generator(device="cuda").manual_seed(8)
    A = torch.randn((256, 256, 256), generator=g, device="cuda")
    k3_err = 0.0
    for modes in itertools.product((False, True), repeat=3):
        if not any(modes):
            continue
        got = ch.halo_self_exchange(A, modes=modes, ols=(2, 2, 2))
        ref = ch.halo_self_exchange_plain(A, modes=modes, ols=(2, 2, 2))
        torch.cuda.synchronize()
        k3_err = max(k3_err, max_err(got, ref))
        check(torch.equal(got, ref), f"K3 modes {modes} bitwise equal to plain")

    def k3_library():  # the sequential z, x, y slab copies on a clone
        u = A.clone()
        u[:, :, 0].copy_(u[:, :, 254])
        u[:, :, 255].copy_(u[:, :, 1])
        u[0].copy_(u[254])
        u[255].copy_(u[1])
        u[:, 0].copy_(u[:, 254])
        u[:, 255].copy_(u[:, 1])
        return u

    def k3():
        return ch.halo_self_exchange(A, modes=(True, True, True), ols=(2, 2, 2))

    check(torch.equal(k3_library(), k3()), "K3 equals the slice-copy form")
    lib_dev, lib_n = library_device_ms(k3_library)
    return dict(
        max_abs_err=k3_err, ms=median_ms(k3),
        plain_ms=median_ms(lambda: ch.halo_self_exchange_plain(
            A, modes=(True, True, True), ols=(2, 2, 2)), batches=3, per_batch=3, warm=1),
        device_ms=device_ms(k3, "self_exchange_kernel"),
        bound_ms=2 * A.numel() * 4 / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=median_ms(k3_library), library_device_ms=lib_dev, library_kernels=lib_n,
        shape="256^3 float32, modes (T,T,T)")


def check_k4(cs):
    """K4 on every non-empty mode combination, f32/f64/bf16, 2x2x2 x 64^3,
    bitwise; then its timing row at 2x2x2 x 256^3 float32, modes (T,T,T),
    and its float64 time at that shape (what config 3 runs)."""
    import itertools

    import torch

    g = torch.Generator(device="cuda").manual_seed(21)
    err = 0.0
    block = (N_CHECK,) * 3
    for dt in (torch.float32, torch.float64, torch.bfloat16):
        T, Cp = rand_state((2 * N_CHECK,) * 3, dt, 3)
        for modes in itertools.product((False, True), repeat=3):
            if not any(modes):
                continue
            recvs = rand_slabs(T.shape, block, [d for d in range(3) if modes[d]], dt, g)
            got = cs.diffusion3d_step_recv(T, Cp, recvs, block=block, **CONSTS)
            ref = cs.diffusion3d_step_recv_plain(T, Cp, recvs, block=block, **CONSTS)
            torch.cuda.synchronize()
            e = max_err(got, ref)
            err = max(err, e)
            check(torch.equal(got, ref),
                  f"K4 2x2x2x{N_CHECK}^3 {name_of(dt)} modes={modes} bitwise equal to plain "
                  f"(max abs err {e:.3e})")
    n = N_CFG3
    block = (n, n, n)
    T, Cp = rand_state((2 * n,) * 3, torch.float32, 4)
    recvs = rand_slabs(T.shape, block, (0, 1, 2), torch.float32, g)
    out = torch.empty_like(T)

    def k4():
        return cs.diffusion3d_step_recv(T, Cp, recvs, block=block, out=out, **CONSTS)

    ref = cs.diffusion3d_step_recv_plain(T, Cp, recvs, block=block, **CONSTS)
    e = max_err(k4(), ref)
    check(torch.equal(out, ref), f"K4 2x2x2x{n}^3 float32 bitwise equal to plain ({e:.3e})")
    del ref
    slab_b = sum(s.numel() for p in recvs.values() for s in p) * 4
    bound_b = (cs.step_bytes(T) + slab_b) / HBM_BYTES_PER_S * 1e3
    bound_o = T.numel() * STEP_FLOPS_PER_CELL / F32_FLOPS_PER_S * 1e3
    # K1 on the same stack without halos: what the delivery of received
    # slabs adds to the sweep
    k1_ms = median_ms(lambda: cs.diffusion3d_step(T, Cp, block=block, out=out, **CONSTS))
    row = dict(
        max_abs_err=max(err, e), ms=median_ms(k4), k1_same_shape_ms=k1_ms,
        plain_ms=median_ms(lambda: cs.diffusion3d_step_recv_plain(
            T, Cp, recvs, block=block, **CONSTS), batches=3, per_batch=2, warm=1),
        device_ms=device_ms(k4, KERNEL_NAMES["diffusion3d_step_exchange"]),
        bound_ms=max(bound_b, bound_o), bound_by="bytes" if bound_b >= bound_o else "operations",
        library_ms=None, shape=f"2x2x2 x {n}^3 float32, modes (T,T,T)")
    del T, Cp, out, recvs
    # float64 at the same shape: what config 3 runs
    T, Cp = rand_state((2 * n,) * 3, torch.float64, 5)
    recvs = rand_slabs(T.shape, block, (0, 1, 2), torch.float64, g)
    out = torch.empty_like(T)
    ref = cs.diffusion3d_step_recv_plain(T, Cp, recvs, block=block, **CONSTS)
    e = max_err(k4(), ref)
    check(torch.equal(out, ref), f"K4 2x2x2x{n}^3 float64 bitwise equal to plain ({e:.3e})")
    del ref
    slab_b = sum(s.numel() for p in recvs.values() for s in p) * 8
    row.update(f64_device_ms=device_ms(k4, KERNEL_NAMES["diffusion3d_step_exchange"]),
               f64_bound_ms=(cs.step_bytes(T) + slab_b) / HBM_BYTES_PER_S * 1e3)
    return row


def check_k5(cs):
    """K5 on all four mode combinations at 2x2 x 256^2 (f32/f64/bf16); its
    timing row at 2x2 x 4096^2 float32, modes (T,T)."""
    import itertools

    import torch

    c2 = {k: v for k, v in CONSTS.items() if k != "dz"}
    g = torch.Generator(device="cuda").manual_seed(22)
    err = 0.0
    block = (N_CHECK2D, N_CHECK2D)
    for dt in (torch.float32, torch.float64, torch.bfloat16):
        T, Cp = rand_state((2 * N_CHECK2D, 2 * N_CHECK2D), dt, 5)
        for modes in itertools.product((False, True), repeat=2):
            recvs = rand_slabs(T.shape, block, [d for d in range(2) if modes[d]], dt, g)
            got = cs.diffusion2d_step_recv(T, Cp, recvs, block=block, **c2)
            ref = cs.diffusion2d_step_recv_plain(T, Cp, recvs, block=block, **c2)
            torch.cuda.synchronize()
            e = max_err(got, ref)
            err = max(err, e) if dt != torch.bfloat16 else err
            check(close(got, ref, **TOL[name_of(dt)]),
                  f"K5 2x2x{N_CHECK2D}^2 {name_of(dt)} modes={modes} matches plain "
                  f"(max abs err {e:.3e})")
    n = N_CFG2
    block = (n, n)
    T, Cp = rand_state((2 * n, 2 * n), torch.float32, 6)
    recvs = rand_slabs(T.shape, block, (0, 1), torch.float32, g)
    out = torch.empty_like(T)

    def k5():
        return cs.diffusion2d_step_recv(T, Cp, recvs, block=block, out=out, **c2)

    ref = cs.diffusion2d_step_recv_plain(T, Cp, recvs, block=block, **c2)
    e = max_err(k5(), ref)
    check(close(out, ref, **TOL["float32"]), f"K5 2x2x{n}^2 float32 matches plain ({e:.3e})")
    del ref
    slab_b = sum(s.numel() for p in recvs.values() for s in p) * 4
    bound_b = (cs.step_bytes(T) + slab_b) / HBM_BYTES_PER_S * 1e3
    bound_o = T.numel() * STEP2D_FLOPS_PER_CELL / F32_FLOPS_PER_S * 1e3
    return dict(
        max_abs_err=max(err, e), ms=median_ms(k5),
        plain_ms=median_ms(lambda: cs.diffusion2d_step_recv_plain(
            T, Cp, recvs, block=block, **c2), batches=3, per_batch=2, warm=1),
        device_ms=device_ms(k5, KERNEL_NAMES["diffusion2d_step_exchange"]),
        bound_ms=max(bound_b, bound_o), bound_by="bytes" if bound_b >= bound_o else "operations",
        library_ms=None, shape=f"2x2 x {n}^2 float32, modes (T,T)")


def _box_sectors(shape, idx, itemsize):
    """The 32-byte sectors of a contiguous tensor of 3-D ``shape`` that the
    cells of the box ``idx`` (an index array a dim) lie in, each once."""
    import numpy as np

    off = (idx[0][:, None, None] * shape[1] + idx[1][None, :, None]) * shape[2] \
        + idx[2][None, None, :]
    return np.unique(off.ravel() * itemsize // 32).size


def _halo_index(S, n, hw):
    """The indices of the ``[0, hw)`` and ``[n-hw, n)`` halos of every block
    of ``n`` along an extent ``S``."""
    import numpy as np

    return np.array([c * n + s + h for c in range(S // n) for s in (0, n - hw)
                     for h in range(hw)], dtype=np.int64)


def _pad3(shape):
    return tuple(int(s) for s in shape) + (1,) * (3 - len(shape))


def k2_box(shape, block, dim, hw):
    """The index box of K2's halo cells along ``dim`` (3-D, padded)."""
    import numpy as np

    idx = [np.arange(s, dtype=np.int64) for s in _pad3(shape)]
    idx[dim] = _halo_index(int(shape[dim]), int(block[dim]), hw)
    return idx


def k6_boxes(shape, block, modes, hws):
    """The index boxes of K6's parts: ``"x"`` the x-halo planes, ``"y"`` the
    y-halo rows outside them, ``"z"`` the z-halo lanes outside both (a dim
    not in ``modes`` excludes nothing)."""
    import numpy as np

    every = [np.arange(s, dtype=np.int64) for s in shape]
    inner = [np.array([i for i in range(s) if h <= i % n < n - h], dtype=np.int64) if m else a
             for s, n, h, m, a in zip(shape, block, hws, modes, every)]
    halo = [_halo_index(s, n, h) for s, n, h in zip(shape, block, hws)]
    out = {}
    if modes[0]:
        out["x"] = [halo[0], every[1], every[2]]
    if modes[1]:
        out["y"] = [inner[0], halo[1], every[2]]
    out["z"] = [inner[0], inner[1], halo[2]]
    return out


def halo_write_bounds(shape, itemsize, boxes):
    """Byte and 32-byte sector bounds (ms) of writing the halo cells of the
    disjoint index ``boxes`` of a contiguous tensor from contiguous slabs:
    the byte bound reads and writes each cell once; the sector bound counts
    the field's 32-byte sectors the cells lie in, each once, and the slabs'
    bytes (the least a card that writes whole sectors moves)."""
    import numpy as np

    shape = _pad3(shape)
    cells = sum(int(np.prod([len(i) for i in b])) for b in boxes)
    sectors = sum(_box_sectors(shape, b, itemsize) for b in boxes)
    ms = 1e3 / HBM_BYTES_PER_S
    return 2 * cells * itemsize * ms, (32 * sectors + cells * itemsize) * ms


def check_k6(ch):
    """K6 on every combination its gate admits (z exchanging; hw 1 or 2 on
    x), in float32, float64, int32, int8 and int16 on 2x2x2 x 64^3 (rows of
    whole 16-byte words) and in float32 and int8 on 64 x 64 x 61 blocks
    (scalar rows), bitwise; its timing row on one `update_halo` of 2x2x2 x
    256^3 float32, that call also held bitwise against the plain version,
    beside its byte and 32-byte sector bounds and the slice copies' device
    time."""
    import itertools

    import torch

    g = torch.Generator(device="cuda").manual_seed(23)
    err = 0.0
    cases = [((N_CHECK,) * 3, dt) for dt in ("float32", "float64", "int32", "int8", "int16")]
    cases += [((N_CHECK, N_CHECK, N_CHECK - 3), dt) for dt in ("float32", "int8")]
    for (block, dname), modes, hwx in itertools.product(
            cases, itertools.product((False, True), repeat=2), (1, 2)):
        modes = modes + (True,)
        if hwx == 2 and not modes[0]:
            continue
        dt = getattr(torch, dname)
        hws = (hwx, 1, 1)
        A = rand_field(tuple(2 * b for b in block), dt, g)
        recvs = rand_slabs(A.shape, block, [d for d in range(3) if modes[d]], dt, g, hws)
        got = ch.halo_write_combined(A.clone(), recvs, modes=modes, hws=hws, block=block)
        ref = ch.halo_write_combined_plain(A.clone(), recvs, modes=modes, hws=hws, block=block)
        torch.cuda.synchronize()
        err = max(err, max_err(got, ref))
        check(torch.equal(got, ref),
              f"K6 2x2x2 x {block} {dname} modes={modes} hw_x={hwx} bitwise equal to plain")
    n = N_CFG3
    block = (n, n, n)
    A = torch.randn((2 * n,) * 3, generator=g, device="cuda")
    recvs = rand_slabs(A.shape, block, (0, 1, 2), torch.float32, g)
    modes, hws = (True, True, True), (1, 1, 1)
    got = ch.halo_write_combined(A.clone(), recvs, modes=modes, hws=hws, block=block)
    ref = ch.halo_write_combined_plain(A.clone(), recvs, modes=modes, hws=hws, block=block)
    torch.cuda.synchronize()
    e = max_err(got, ref)
    check(torch.equal(got, ref), f"K6 2x2x2x{n}^3 float32 bitwise equal to plain ({e:.3e})")
    del got, ref

    def k6():
        return ch.halo_write_combined(A, recvs, modes=modes, hws=hws, block=block)

    def k6_library():  # one slice copy_ per dim, block and side, in z, x, y order
        for d in (2, 0, 1):
            sl, sr = recvs[d]
            for c in range(2):
                A.narrow(d, c * n, 1).copy_(sl.narrow(d, c, 1))
                A.narrow(d, c * n + n - 1, 1).copy_(sr.narrow(d, c, 1))

    bound, sectors = halo_write_bounds(A.shape, 4, k6_boxes(A.shape, block, modes, hws).values())
    lib_dev, lib_n = library_device_ms(k6_library)
    return dict(
        max_abs_err=max(err, e), ms=median_ms(k6),
        plain_ms=median_ms(lambda: ch.halo_write_combined_plain(
            A, recvs, modes=modes, hws=hws, block=block)),
        device_ms=device_ms(k6, KERNEL_NAMES["halo_write_combined"]),
        bound_ms=bound, bound_by="bytes", sector_bound_ms=sectors,
        library_ms=median_ms(k6_library), library_device_ms=lib_dev, library_kernels=lib_n,
        shape=f"one update_halo of 2x2x2 x {n}^3 float32, hw 1 (all halo cells)")


# K6's launches by part: the mode combinations the gate admits at halowidth 1
K6_MODES = {"FFT": (False, False, True), "TFT": (True, False, True),
            "FTT": (False, True, True), "TTT": (True, True, True)}


def k6_part_times(ch):
    """K6 by part on one `update_halo` of 2x2x2 x 256^3 (the K6 row's shape),
    float32 and config 3's float64: a launch with each mode combination of
    `K6_MODES` ("FFT": the z lanes of every row), held bitwise against the
    plain version, then its device ms alone (torch.profiler) and ms
    (events) beside its byte and 32-byte sector bounds; then the parts by
    difference, x = TTT - FTT, y = TTT - TFT and z the rest, beside their
    own bounds (`k6_boxes`). Prints a line a launch; returns {dtype:
    {"modes": {key: {...}}, "parts": {part: {...}}}}."""
    import torch

    n = N_CFG3
    block, hws = (n,) * 3, (1, 1, 1)
    g = torch.Generator(device="cuda").manual_seed(29)
    out = {}
    for dt in (torch.float32, torch.float64):
        A = torch.randn((2 * n,) * 3, generator=g, device="cuda").to(dt)
        recvs = rand_slabs(A.shape, block, (0, 1, 2), dt, g)
        e = A.element_size()
        res = {}
        for key, modes in K6_MODES.items():
            r = {d: recvs[d] for d in range(3) if modes[d]}
            got = ch.halo_write_combined(A.clone(), r, modes=modes, hws=hws, block=block)
            ref = ch.halo_write_combined_plain(A.clone(), r, modes=modes, hws=hws, block=block)
            torch.cuda.synchronize()
            check(torch.equal(got, ref), f"K6 {name_of(dt)} {key}: the timed launch bitwise "
                                         "equal to plain")
            del got, ref

            def k6():
                return ch.halo_write_combined(A, r, modes=modes, hws=hws, block=block)

            bound, sectors = halo_write_bounds(A.shape, e, k6_boxes(A.shape, block, modes,
                                                                    hws).values())
            res[key] = dict(device_ms=device_ms(k6, KERNEL_NAMES["halo_write_combined"]),
                            ms=median_ms(k6), bound_ms=bound, sector_bound_ms=sectors)
            print(f"  K6 {name_of(dt)} {key}: device {res[key]['device_ms']} ms, "
                  f"{res[key]['ms']:.5f} ms (events), byte bound {bound:.5f} ms, sector bound "
                  f"{sectors:.5f} ms", flush=True)
        t = {k: v["device_ms"] for k, v in res.items()}
        split = {}
        if None not in t.values():
            split = {"x": t["TTT"] - t["FTT"], "y": t["TTT"] - t["TFT"]}
            split["z"] = t["TTT"] - split["x"] - split["y"]
        boxes = k6_boxes(A.shape, block, (True,) * 3, hws)
        parts = {}
        for part, box in boxes.items():
            bound, sectors = halo_write_bounds(A.shape, e, [box])
            parts[part] = dict(device_ms=split.get(part), bound_ms=bound,
                               sector_bound_ms=sectors)
        print(f"  K6 {name_of(dt)} parts: {json.dumps(parts)}", flush=True)
        out[name_of(dt)] = dict(modes=res, parts=parts)
        del A, recvs
    return out


# K2's launches on the main paths: label -> (block, block counts, halowidth
# a dim, the dims launched); float32
K2_DIMS = {"update_halo 2x2x2 x 128^3 (the K2 row)": ((128,) * 3, (2, 2, 2), (1, 1, 1),
                                                    (0, 1, 2)),
           "update_halo 2x2x1 x 128^3 (phase_mesh)": ((128,) * 3, (2, 2, 1), (1, 1, 1),
                                                     (0, 1)),
           "update_halo 4x2 x 128^2, hw (2, 1) (phase_mesh)": ((128, 128), (4, 2), (2, 1),
                                                               (0, 1))}


def k2_dim_times(ch):
    """K2 a launch on the shapes of `K2_DIMS`, float32: each held bitwise
    against the plain version, then its device ms alone (torch.profiler)
    and ms (events, Python included) beside its byte and 32-byte sector
    bounds. Prints a line a launch; returns {label: {dim: {...}}}."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(37)
    out = {}
    for label, (block, counts, hws, dims) in K2_DIMS.items():
        shape = tuple(c * b for c, b in zip(counts, block))
        A = torch.randn(shape, generator=g, device="cuda")
        out[label] = {}
        for dim in dims:
            hw, n = hws[dim], block[dim]
            ss = list(shape)
            ss[dim] = counts[dim] * hw
            sl, sr = (torch.randn(ss, generator=g, device="cuda") for _ in range(2))
            a1, a2 = A.clone(), A.clone()
            ch.halo_write(a1, sl, sr, dim=dim, hw=hw, block=n)
            ch.halo_write_plain(a2, sl, sr, dim=dim, hw=hw, block=n)
            torch.cuda.synchronize()
            check(torch.equal(a1, a2), f"K2 {label} dim {dim}: the timed launch bitwise equal "
                                       "to plain")
            del a1, a2

            def k2():
                return ch.halo_write(A, sl, sr, dim=dim, hw=hw, block=n)

            bound, sectors = halo_write_bounds(shape, 4, [k2_box(shape, block, dim, hw)])
            r = out[label][dim] = dict(device_ms=device_ms(k2, KERNEL_NAMES["halo_write"]),
                                       ms=median_ms(k2), bound_ms=bound, sector_bound_ms=sectors)
            print(f"  K2 {label} dim {dim}: device {r['device_ms']} ms, {r['ms']:.5f} ms "
                  f"(events), byte bound {bound:.5f} ms, sector bound {sectors:.5f} ms",
                  flush=True)
    return out


def check_k4s(cs):
    """K4s: `update_slab` on each dim and range (send and current halo)
    against its plain version (f32/f64/bf16, 2x2x2 x 64^3); the exchange
    form (moves, PROC_NULL edges, two earlier dims' corners; copy and step
    modes) against `exchange_slabs_plain`; all bitwise. Its timing row on
    the y dim of the 2x2x2 x 256^3 float32 step (two earlier dims,
    periodic)."""
    import torch

    err = 0.0
    block = (N_CHECK,) * 3
    for dt in (torch.float32, torch.float64, torch.bfloat16):
        T, Cp = rand_state((2 * N_CHECK,) * 3, dt, 7)
        for dim in range(3):
            starts = [block[dim] - 2, 1, 0, block[dim] - 1]
            got = cs.update_slab(T, Cp, dim, starts, 1, block=block, **CONSTS)
            for st, gs in zip(starts, got):
                ref = cs.update_slab_plain(T, Cp, dim, st, 1, block=block, **CONSTS)
                torch.cuda.synchronize()
                e = max_err(gs, ref)
                err = max(err, e)
                check(torch.equal(gs, ref), f"K4s update_slab {name_of(dt)} dim {dim} start "
                                            f"{st} bitwise equal to plain ({e:.3e})")
    g = torch.Generator(device="cuda").manual_seed(24)
    T, Cp = rand_state((2 * N_CHECK,) * 3, torch.float64, 8)
    earlier = []
    for dim in (2, 0, 1):
        moves = (cs.Move(N_CHECK - 2, 0, -1), cs.Move(1, N_CHECK - 1, 1))
        for periodic in (True, False):
            for step in (False, True):
                kw = dict(block=block, periodic=periodic, earlier=tuple(earlier),
                          Cp=Cp if step else None, consts=CONSTS if step else None)
                got = cs.exchange_slabs(T, dim, 1, moves, **kw)
                ref = cs.exchange_slabs_plain(T, dim, 1, moves, **kw)
                torch.cuda.synchronize()
                for a, b in zip(got, ref):
                    e = max_err(a, b)
                    err = max(err, e)
                    check(torch.equal(a, b), f"K4s exchange dim {dim} periodic={periodic} "
                                             f"step={step} bitwise equal to plain ({e:.3e})")
        earlier.append((dim, 1, rand_slabs(T.shape, block, (dim,), T.dtype, g)[dim]))
    n = N_CFG3
    block = (n, n, n)
    T, Cp = rand_state((2 * n,) * 3, torch.float32, 9)
    earlier = tuple((d, 1, rand_slabs(T.shape, block, (d,), T.dtype, g)[d]) for d in (2, 0))
    moves = (cs.Move(n - 2, 0, -1), cs.Move(1, n - 1, 1))
    kw = dict(block=block, periodic=True, earlier=earlier, Cp=Cp, consts=CONSTS)

    def k4s():
        return cs.exchange_slabs(T, 1, 1, moves, **kw)

    out_cells = 2 * T.shape[0] * 2 * T.shape[2]
    # each output cell written once; its T band (the cell and its two
    # neighbours along y) and its Cp read once
    bound_b = out_cells * (1 + 3 + 1) * 4 / HBM_BYTES_PER_S * 1e3
    bound_o = out_cells * STEP_FLOPS_PER_CELL / F32_FLOPS_PER_S * 1e3
    got, ref = k4s(), cs.exchange_slabs_plain(T, 1, 1, moves, **kw)
    e = max(max_err(a, b) for a, b in zip(got, ref))
    check(all(torch.equal(a, b) for a, b in zip(got, ref)),
          f"K4s y dim of the {n}^3 float32 step bitwise equal to plain ({e:.3e})")
    return dict(
        max_abs_err=max(err, e), ms=median_ms(k4s),
        plain_ms=median_ms(lambda: cs.exchange_slabs_plain(T, 1, 1, moves, **kw),
                           batches=3, per_batch=3, warm=1),
        device_ms=device_ms(k4s, "exchange_slabs_kernel"),
        bound_ms=max(bound_b, bound_o), bound_by="bytes" if bound_b >= bound_o else "operations",
        library_ms=None,
        shape=f"y dim of the 2x2x2 x {n}^3 float32 step: 2 slabs, 2 earlier dims")


def grid(tg, *args, plain=False, **kw):
    """(Re-)initialize the grid; ``plain`` sets IGG_USE_PALLAS=0."""
    if tg.grid_is_initialized():
        tg.finalize_global_grid()
    if plain:
        os.environ["IGG_USE_PALLAS"] = "0"
    else:
        os.environ.pop("IGG_USE_PALLAS", None)
    tg.init_global_grid(*args, quiet=True, **kw)


def phase_main(tg, models, cb, cs, label, nt, **kw):
    """Phases 3 and 4: the main path through the kernels, then the plain
    path on the card from the same state."""
    import torch

    print(f"phase: main path {label}", flush=True)
    grid(tg, N_MAIN, N_MAIN, N_MAIN, **kw)
    T0, Cp, p = models.init_diffusion3d(dtype=torch.float32)
    chunk = 10
    models.run_diffusion(T0, Cp, p, chunk, nt_chunk=chunk)   # warm chunk
    cb.reset_launch_counts()
    tg.tic()
    T = models.run_diffusion(T0, Cp, p, nt, nt_chunk=nt)
    t = tg.toc()
    T = tg.update_halo(T)
    G = tg.gather_interior(T)
    torch.cuda.synchronize()
    counts = cb.launch_counts()
    cells = tg.nx_g() * tg.ny_g() * tg.nz_g()
    rate = cells * nt / t
    print(f"  {label}: nt={nt} in {t:.6f} s = {rate:.6e} cell-updates/s "
          f"(global {tg.nx_g()}x{tg.ny_g()}x{tg.nz_g()}); launches {counts}",
          flush=True)
    check(counts["diffusion3d_step_halo"] == nt, f"{label}: K1 launched once per step")
    import numpy as np

    gg = tg.global_grid()
    k1_own = dict(start=k1_own_ms(cs, gg, T0, Cp, p), after=k1_own_ms(cs, gg, T, Cp, p))
    print(f"  {label}: K1 device ms on the run's own states {k1_own}", flush=True)

    check(G.shape == (tg.nx_g(), tg.ny_g(), tg.nz_g()) and bool(np.isfinite(G).all()),
          f"{label}: gathered interior finite, shape {G.shape}")
    grid(tg, N_MAIN, N_MAIN, N_MAIN, plain=True, **kw)
    t1 = time.perf_counter()
    Tp = tg.update_halo(models.run_diffusion(T0, Cp, p, nt, nt_chunk=nt))
    plain_s = time.perf_counter() - t1
    Gp = tg.gather_interior(Tp)
    err = float(np.abs(G.astype(np.float64) - Gp).max())
    check(np.allclose(G, Gp, **RUN_TOL),
          f"{label}: matches the plain path on the card (max abs err {err:.3e})")
    check(not np.allclose(G, tg.gather_interior(T0)), f"{label}: the state evolved")
    tg.finalize_global_grid()
    os.environ.pop("IGG_USE_PALLAS", None)
    return dict(seconds=t, cell_updates_per_s=rate, plain_seconds=plain_s,
                launches=counts, max_abs_err_vs_plain=err, k1_own_state_ms=k1_own)


def k1_route(tg, cs, p, loc):
    """One step by K1 (no halos) then a standalone `update_halo`: the route
    the port took on multi-block grids before the fused step + exchange."""
    c = dict(lam=p.lam, dt=p.dt, dx=p.dx, dy=p.dy, dz=p.dz)
    return lambda T, Cp: tg.update_halo(cs.diffusion3d_step(T, Cp, block=loc, **c))


def k1_own_ms(cs, gg, T, Cp, p):
    """Device ms of K1 on one state of a single-block run, with the fuse
    flags the run's route takes."""
    import torch

    fuse = cs.fusable_halo_dims(gg) or (False, False, False)
    out = torch.empty_like(T)
    return device_ms(lambda: cs.diffusion3d_step_halo(
        T, Cp, fuse=fuse, out=out, lam=p.lam, dt=p.dt, dx=p.dx, dy=p.dy, dz=p.dz),
        KERNEL_NAMES["diffusion3d_step_halo"])


def k4_own_ms(cs, gg, T, Cp, p):
    """Device ms of K4 on one state of a multi-block run, delivering the
    slabs the run's pipeline sends from that state."""
    import torch

    loc = tuple(int(s) // int(d) for s, d in zip(T.shape, gg.dims))
    consts = dict(lam=p.lam, dt=p.dt, dx=p.dx, dy=p.dy, dz=p.dz)
    recvs = cs._recv_slabs(T, Cp, gg, cs.step_exchange_modes(gg, loc), loc, consts)
    out = torch.empty_like(T)
    return device_ms(lambda: cs.diffusion3d_step_recv(T, Cp, recvs, block=loc, out=out,
                                                      **consts),
                     KERNEL_NAMES["diffusion3d_step_exchange"])


def phase_mesh(tg, models, cb, cs):
    """Phase 5: the 2x2x2 virtual mesh of 128^3 blocks."""
    import numpy as np
    import torch

    print(f"phase: virtual mesh 2x2x2 x {N_MESH}^3", flush=True)
    kw = dict(dimx=2, dimy=2, dimz=2, periodx=1)
    grid(tg, N_MESH, N_MESH, N_MESH, **kw)
    g = torch.Generator(device="cuda").manual_seed(11)
    A = torch.randn((2 * N_MESH,) * 3, generator=g, device="cuda")
    T0, Cp, p = models.init_diffusion3d(dtype=torch.float32)
    models.run_diffusion(T0, Cp, p, 2, nt_chunk=2)  # warm
    cb.reset_launch_counts()
    U = tg.update_halo(A.clone())
    T = models.run_diffusion(T0, Cp, p, 20, nt_chunk=20)
    gU, giU, gT = tg.gather(U), tg.gather_interior(U), tg.gather_interior(T)
    counts = cb.launch_counts()
    k4s = cb.k4s_launch_counts()  # its K4s launches by mode and dim
    print(f"  launches {counts}", flush=True)
    check(counts["diffusion3d_step_exchange"] == 20, "2x2x2: K4 launched once per step")
    check(counts["halo_write_combined"] == 1, "2x2x2: update_halo went through K6")
    check(counts["exchange_slabs"] == 3 * 20 + 3, "2x2x2: K4s launched once per dim")
    check(counts["diffusion3d_step_halo"] == 0 and counts["halo_write"] == 0,
          "2x2x2: neither K1 nor K2 on the fused route")
    gg = tg.global_grid()
    k4_own = dict(start=k4_own_ms(cs, gg, T0, Cp, p), after=k4_own_ms(cs, gg, T, Cp, p))
    print(f"  K4 device ms on the run's own states {k4_own}", flush=True)
    step, k1 = models.make_step(p), k1_route(tg, cs, p, (N_MESH,) * 3)
    times = route_times(lambda: step(T0, Cp))
    times_k1 = route_times(lambda: k1(T0, Cp))
    print(f"  K4 route per step: {times}", flush=True)
    print(f"  K1 + update_halo per step: {times_k1}", flush=True)
    # z not exchanging (dims 2x2x1, z non-periodic): the per-dim tier, K2
    grid(tg, N_MESH, N_MESH, N_MESH, dimx=2, dimy=2, dimz=1, periodx=1)
    A2 = torch.randn((2 * N_MESH, 2 * N_MESH, N_MESH), generator=g, device="cuda")
    cb.reset_launch_counts()
    U2 = tg.update_halo(A2.clone())
    torch.cuda.synchronize()
    c2 = cb.launch_counts()
    k4s.update({k: k4s.get(k, 0) + n for k, n in cb.k4s_launch_counts().items()})
    check(c2["halo_write"] == 2 and c2["halo_write_combined"] == 0,
          "2x2x1: update_halo went through K2 (x and y)")
    counts = {k: counts[k] + c2[k] for k in counts}
    grid(tg, N_MESH, N_MESH, N_MESH, dimx=2, dimy=2, dimz=1, periodx=1, plain=True)
    check(torch.equal(U2, tg.update_halo(A2.clone())),
          "2x2x1: update_halo bitwise equal to the plain path")
    # a 2-D field, halowidth 2 on x: the per-dim tier (K4s + K2) in 2-D
    kw2 = dict(dimx=4, dimy=2, dimz=1, periodx=1, overlaps=(4, 2, 2), halowidths=(2, 1, 1))
    grid(tg, N_MESH, N_MESH, 1, **kw2)
    A3 = torch.randn((4 * N_MESH, 2 * N_MESH), generator=g, device="cuda")
    U3 = tg.update_halo(A3.clone())
    grid(tg, N_MESH, N_MESH, 1, plain=True, **kw2)
    check(torch.equal(U3, tg.update_halo(A3.clone())),
          "4x2 2-D, hw 2: update_halo bitwise equal to the plain path")
    grid(tg, N_MESH, N_MESH, N_MESH, plain=True, **kw)
    Up = tg.update_halo(A.clone())
    check(torch.equal(U, Up), "2x2x2: update_halo bitwise equal to the plain path")
    check(np.array_equal(gU, tg.gather(Up)) and np.array_equal(giU, tg.gather_interior(Up)),
          "2x2x2: gather and gather_interior bitwise equal")
    Gp = tg.gather_interior(models.run_diffusion(T0, Cp, p, 20, nt_chunk=20))
    err = float(np.abs(gT.astype(np.float64) - Gp).max())
    check(np.isfinite(gT).all() and np.allclose(gT, Gp, **RUN_TOL),
          f"2x2x2: 20-step run matches the plain path (max abs err {err:.3e})")

    # a small reference: the card's kernel path against the CPU in float64
    grid(tg, 16, 16, 16, periodx=1, periody=1, periodz=1)
    T0, Cp, p = models.init_diffusion3d(dtype=torch.float64)
    Tg = tg.gather_interior(models.run_diffusion(T0, Cp, p, 10))
    grid(tg, 16, 16, 16, periodx=1, periody=1, periodz=1, device_type="cpu")
    Tc = tg.gather_interior(models.run_diffusion(T0.cpu(), Cp.cpu(), p, 10, impl="plain"))
    check(np.allclose(Tg, Tc, rtol=1e-12, atol=1e-12),
          "16^3 float64: card kernel path matches the CPU plain path")
    tg.finalize_global_grid()
    return counts, dict(k4s_launches=k4s, k4_route=times, k1_update_halo_route=times_k1,
                        max_abs_err_vs_plain=err, k4_own_state_ms=k4_own)


def phase_config3(tg, models, cb, cs):
    """Phase 6: BASELINE config 3, 2x2x2 blocks of 256^3, periodic, float64."""
    import numpy as np
    import torch

    n, nt = N_CFG3, 20
    print(f"phase: BASELINE config 3, 2x2x2 x {n}^3 float64, nt={nt}", flush=True)
    kw = dict(dimx=2, dimy=2, dimz=2, periodx=1, periody=1, periodz=1)
    grid(tg, n, n, n, **kw)
    T0, Cp, p = models.init_diffusion3d(dtype=torch.float64)
    models.run_diffusion(T0, Cp, p, 2, nt_chunk=2)  # warm chunk
    cb.reset_launch_counts()
    tg.tic()
    T = models.run_diffusion(T0, Cp, p, nt, nt_chunk=nt)
    t = tg.toc()
    T_run = T.clone()  # the same input for the plain path's update_halo
    T = tg.update_halo(T)
    G = tg.gather_interior(T)
    torch.cuda.synchronize()
    counts = cb.launch_counts()
    k4s = cb.k4s_launch_counts()  # its K4s launches by mode and dim
    cells = tg.nx_g() * tg.ny_g() * tg.nz_g()
    rate = cells * nt / t
    print(f"  config 3: nt={nt} in {t:.6f} s = {rate:.6e} cell-updates/s "
          f"(global {tg.nx_g()}x{tg.ny_g()}x{tg.nz_g()}); launches {counts}", flush=True)
    check(counts["diffusion3d_step_exchange"] == nt, "config 3: K4 launched once per step")
    check(counts["halo_write_combined"] == 1, "config 3: update_halo went through K6")
    check(counts["exchange_slabs"] == 3 * nt + 3, "config 3: K4s launched once per dim")
    check(G.shape == (tg.nx_g(), tg.ny_g(), tg.nz_g()) and bool(np.isfinite(G).all()),
          f"config 3: gathered interior finite, shape {G.shape}")
    gg = tg.global_grid()
    k4_own = dict(start=k4_own_ms(cs, gg, T0, Cp, p), after=k4_own_ms(cs, gg, T_run, Cp, p))
    print(f"  K4 device ms on the run's own states {k4_own}", flush=True)
    step, k1 = models.make_step(p), k1_route(tg, cs, p, (n, n, n))
    times = route_times(lambda: step(T0, Cp), reps=5)
    times_k1 = route_times(lambda: k1(T0, Cp), reps=5)
    print(f"  K4 route per step: {times}", flush=True)
    print(f"  K1 + update_halo per step: {times_k1}", flush=True)
    # one step by the fused route against K1, then update_halo
    fused, K1 = step(T0, Cp), k1(T0, Cp)
    err_k1 = max_err(fused, K1)
    print(f"  fused step vs K1 + update_halo: max abs err {err_k1!r}", flush=True)
    check(close(fused, K1, **F64_RUN_TOL), "config 3: fused step matches K1 + update_halo")
    del fused, K1
    grid(tg, n, n, n, plain=True, **kw)
    # K6's 8-byte path wrote T's halos: hold the whole tensor, halos included
    Up = tg.update_halo(T_run)
    err_uh = max_err(T, Up)
    check(torch.equal(T, Up), "config 3: update_halo (K4s + K6) bitwise equal to the plain "
                              f"path's, halos included (max abs err {err_uh:.3e})")
    ref = {"config3_T": tg.gather(T)}  # the transport phase's reference, halos included
    del T, T_run, Up
    Gp = tg.gather_interior(tg.update_halo(models.run_diffusion(T0, Cp, p, nt, nt_chunk=nt)))
    err = float(np.abs(G - Gp).max())
    check(np.allclose(G, Gp, **F64_RUN_TOL),
          f"config 3: matches the plain path on the card (max abs err {err:.3e})")
    check(not np.allclose(G, tg.gather_interior(T0)), "config 3: the state evolved")
    tg.finalize_global_grid()
    os.environ.pop("IGG_USE_PALLAS", None)
    return counts, dict(k4s_launches=k4s, seconds=t, cell_updates_per_s=rate,
                        global_cells=cells,
                        max_abs_err_vs_plain=err, max_abs_err_vs_k1_route=err_k1,
                        k4_route=times, k1_update_halo_route=times_k1,
                        k4_own_state_ms=k4_own, step_ms=t * 1e3 / nt,
                        transport_ref=ref)


def phase_config2(tg, models, cb):
    """Phase 7: BASELINE config 2, a 2x2 mesh of 4096^2 blocks, periodic, float32."""
    import numpy as np
    import torch

    n, nt = N_CFG2, 100
    print(f"phase: BASELINE config 2, 2x2 x {n}^2 float32, nt={nt}", flush=True)
    kw = dict(dimx=2, dimy=2, dimz=1, periodx=1, periody=1)
    grid(tg, n, n, 1, **kw)
    T0, Cp, p = models.init_diffusion2d(dtype=torch.float32)
    models.run_diffusion(T0, Cp, p, 2, nt_chunk=2)  # warm chunk
    cb.reset_launch_counts()
    tg.tic()
    T = models.run_diffusion(T0, Cp, p, nt, nt_chunk=nt)
    t = tg.toc()
    G = tg.gather_interior(T)
    counts = cb.launch_counts()
    k4s = cb.k4s_launch_counts()  # its K4s launches by mode and dim
    cells = tg.nx_g() * tg.ny_g()
    rate = cells * nt / t
    print(f"  config 2: nt={nt} in {t:.6f} s = {rate:.6e} cell-updates/s "
          f"(global {tg.nx_g()}x{tg.ny_g()}); launches {counts}", flush=True)
    check(counts["diffusion2d_step_exchange"] == nt, "config 2: K5 launched once per step")
    check(counts["exchange_slabs"] == 2 * nt, "config 2: K4s launched once per dim")
    check(G.shape == (tg.nx_g(), tg.ny_g()) and bool(np.isfinite(G).all()),
          f"config 2: gathered interior finite, shape {G.shape}")
    step = models.make_step(p, ndim=2)
    times = route_times(lambda: step(T0, Cp))
    print(f"  K5 route per step: {times}", flush=True)
    grid(tg, n, n, 1, plain=True, **kw)
    Gp = tg.gather_interior(models.run_diffusion(T0, Cp, p, nt, nt_chunk=nt))
    err = float(np.abs(G.astype(np.float64) - Gp).max())
    check(np.allclose(G, Gp, **RUN_TOL),
          f"config 2: matches the plain path on the card (max abs err {err:.3e})")
    check(not np.allclose(G, tg.gather_interior(T0)), "config 2: the state evolved")
    tg.finalize_global_grid()
    os.environ.pop("IGG_USE_PALLAS", None)
    return counts, dict(k4s_launches=k4s, seconds=t, cell_updates_per_s=rate,
                        global_cells=cells,
                        max_abs_err_vs_plain=err, k5_route=times)


def _acoustic_grid(tg, n, dims, periods, plain=False):
    kw = {f"dim{a}": d for a, d in zip("xyz", dims)}
    kw.update({f"period{a}": q for a, q in zip("xyz", periods)})
    grid(tg, n, n, n, plain=plain, nranks=dims[0] * dims[1] * dims[2], **kw)
    return tg.global_grid()


def _rand_wave_state(cw, block, counts, dtype, g):
    import torch

    return tuple((torch.rand(tuple(c * s for c, s in zip(counts, shp)), generator=g,
                             device="cuda") - 0.5).to(dtype)
                 for shp in cw.wave_shapes(block).values())


WAVE = dict(rho=1.0, K=1.0, dt=0.05, dx=0.052, dy=0.052, dz=0.052)


def _wave_recvs(cw, gg, state, block, consts, check=None):
    """The received slabs of the fused step's pipeline (one batched K4s
    wave-mode launch a dim); ``check(got, dim, periodic, per_field)`` sees
    each launch's slabs."""
    from implicitglobalgrid_tpu_torch.ops.halo import exchange_recv_slabs_multi

    modes = cw.wave_exchange_modes(gg, [tuple(s // int(d) for s, d in zip(a.shape, gg.dims))
                                        for a in state])

    def dim_fn(dim, hw, periodic, per_field):
        got = cw.wave_slabs_multi(state, dim, hw, per_field, block=block, periodic=periodic,
                                  consts=consts)
        if check is not None:
            check(got, dim, periodic, per_field)
        return got

    return modes, exchange_recv_slabs_multi(gg, cw.wave_shapes(block), (1, 1, 1), modes,
                                            dim_fn=dim_fn)


def _dim_batches(recv_fn, *args):
    """Each dim's batched K4s arguments (every field, with the earlier
    dims' slabs) of a fused pipeline, ``recv_fn(*args, check)``: {dim:
    (periodic, per_field)}."""
    seen = {}

    def grab(got, dim, periodic, per_field):
        seen[dim] = (periodic, per_field)

    recv_fn(*args, grab)
    return seen


def _slab_reads(mode, f, dim):
    """The planes a send-slab cell of field ``f`` at plane j along ``dim``
    reads, as {input field: offsets from j}: the diffusion step's T and Cp,
    the wave mode's face and pressure updates (`wave.cuh`), or the Stokes
    mode's divergence, edge stresses, residual and damped update
    (`stokes.cuh`)."""
    V = ("Vx", "Vy", "Vz")
    vd = V[dim]
    if mode == "step":
        return {"T": (-1, 0, 1), "Cp": (0,)}
    if mode == "wave":
        if f == "P":
            return {"P": (-1, 0, 1), vd: (0, 1), **{v: (0,) for v in V if v != vd}}
        return {f: (0,), "P": (-1, 0) if f == vd else (0,)}
    if f == "P":
        return {"P": (0,), vd: (0, 1), **{v: (0,) for v in V if v != vd}}
    rd = {f: (-1, 0, 1), "d" + f: (0,)}
    if f == vd:
        rd.update({"P": (-1, 0), **{v: (-1, 0) for v in V if v != vd}})
        if f == "Vz":
            rd["rhog"] = (-1, 0)
        return rd
    rd.update({"P": (0,), vd: (0, 1), **{v: (0,) for v in V if v not in (vd, f)}})
    if f == "Vz":
        rd["rhog"] = (0,)
    return rd


def slab_batch_bound(mode, fields, dim, per_field):
    """(bound ms, bound_by, sector bound ms) of one batched K4s launch along
    ``dim`` on the stacked state ``fields`` ({name: tensor}, every block's,
    2 blocks along dim): each send slab written once, and each plane of an
    input that some slab cell reads (`_slab_reads`, at the slab's start in
    every block) read once; the operations are the three of a face update
    an output cell, the least any cell does. The corners the earlier dims
    patch in are not counted. Along the contiguous axis (z; y in 2-D) a
    plane is one cell a row, so the sector bound counts instead the 32-byte
    sectors those reads touch, each once: the least a card that reads whole
    sectors moves (None along the other dims, where it equals the byte
    bound)."""
    import numpy as np

    local = {g: int(a.shape[dim]) // 2 for g, a in fields.items()}
    planes, written = set(), 0
    for f, (moves, _) in per_field.items():
        for m in moves:
            written += fields[f].numel() // local[f] * fields[f].element_size()
            for g, offs in _slab_reads(mode, f, dim).items():
                planes.update((g, m.start + o) for o in offs if 0 <= m.start + o < local[g])
    read = sum(fields[g].numel() // local[g] * fields[g].element_size() for g, _ in planes)
    bound_b = (read + written) / HBM_BYTES_PER_S * 1e3
    cells = written // next(iter(fields.values())).element_size()
    bound_o = cells * 3 / F32_FLOPS_PER_S * 1e3
    sector = None
    if dim == next(iter(fields.values())).dim() - 1:  # the contiguous axis
        read = 0
        for g in sorted({g for g, _ in planes}):
            A = fields[g]
            b, row = A.element_size(), int(A.shape[-1])
            z = np.array(sorted(c * local[g] + p for c in range(2) for h, p in planes if h == g))
            sec = (np.arange(A.numel() // row, dtype=np.int64)[:, None] * (row * b)
                   + z[None, :] * b) // 32
            read += np.unique(sec).size * 32
        sector = (read + written) / HBM_BYTES_PER_S * 1e3
    return max(bound_b, bound_o), "bytes" if bound_b >= bound_o else "operations", sector


def _hold_batches(label, plain, errs):
    """A pipeline hook holding each batched K4s launch bitwise against
    ``plain(dim, periodic, per_field)``, every field of it."""
    import torch

    def hold(got, dim, periodic, per_field):
        ref = plain(dim, periodic, per_field)
        torch.cuda.synchronize()
        e = max(max_err(a, b) for f in per_field for a, b in zip(got[f], ref[f]))
        errs.append(e)
        check(sorted(got) == sorted(per_field)
              and all(torch.equal(a, b) for f in per_field for a, b in zip(got[f], ref[f])),
              f"{label} dim {dim} periodic={periodic}: one launch for {tuple(per_field)}, "
              f"bitwise equal to plain ({e:.3e})")
    return hold


def check_k4s_wave(cs, cw, tg):
    """The K4s wave modes bitwise against their plain version: every field,
    dim and range (send and current) with the identity move on 2x2x2 x 64^3
    blocks, and every batched launch of the fused step's pipeline (one a
    dim for the four fields: moves, PROC_NULL edges, earlier dims'
    corners), float32, float64 and bfloat16. Returns the max abs err."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(41)
    n = N_CHECK
    block = (n, n, n)
    k = cw.wave_consts(**WAVE)
    err = 0.0
    for dt in (torch.float32, torch.float64, torch.bfloat16):
        st = _rand_wave_state(cw, block, (2, 2, 2), dt, g)
        for f, m in cw.wave_shapes(block).items():
            for dim in range(3):
                starts = [m[dim] - 2 - (m[dim] - n), 1 + (m[dim] - n), 0, m[dim] - 1]
                got = cw.wave_update_slab(st, f, dim, starts, 1, block=block, consts=k)
                for s0, gs in zip(starts, got):
                    ref = cw.wave_slabs_plain(st, f, dim, 1, (cs.Move(s0, s0, 0),),
                                              block=block, periodic=True, consts=k)[0]
                    torch.cuda.synchronize()
                    e = max_err(gs, ref)
                    err = max(err, e)
                    check(torch.equal(gs, ref),
                          f"K4s wave {f} dim {dim} start {s0} {name_of(dt)} bitwise equal to "
                          f"plain ({e:.3e})")
        for periods in ((1, 1, 1), (0, 0, 0)):
            gg = _acoustic_grid(tg, n, (2, 2, 2), periods)
            errs = []

            def plain(dim, periodic, per_field):
                return cw.wave_slabs_multi_plain(st, dim, 1, per_field, block=block,
                                                 periodic=periodic, consts=k)

            _wave_recvs(cw, gg, st, block, k,
                        _hold_batches(f"K4s wave 2x2x2x{n}^3 {name_of(dt)}", plain, errs))
            check(len(errs) == 3, "K4s wave: 3 batched launches (one a dim) held")
            err = max(err, *errs)
        del st
    tg.finalize_global_grid()
    return err


def _k4s_times(label, launch, plain, kernel, bound):
    """A K4s launch, first held bitwise against ``plain()`` (the same slabs
    by its plain version, as a list), then its time (events, and its
    kernel's device time) beside its bounds (`slab_batch_bound`)."""
    import torch

    got, ref = list(launch()), plain()
    torch.cuda.synchronize()
    e = max(max_err(a, b) for a, b in zip(got, ref))
    check(len(got) == len(ref) and all(torch.equal(a, b) for a, b in zip(got, ref)),
          f"K4s {label}: the timed launch bitwise equal to plain ({e:.3e})")
    return dict(ms=median_ms(launch), device_ms=device_ms(launch, kernel), bound_ms=bound[0],
                bound_by=bound[1], sector_bound_ms=bound[2], max_abs_err=e)


def k4s_dim_times(cs, cw, cst, tg):
    """Each K4s mode's launch along x, y and z at the main paths' shapes,
    as the fused steps' pipelines make them (moves, the earlier dims'
    slabs): the 3-D step on the 2x2x2 x 128^3 float32 mesh and config 3's
    2x2x2 x 256^3 float64, the 2-D step on config 2's 2x2 x 4096^2 float32
    (periodic), the wave modes on config 4's 2x2x2 x 192^3 float32 mesh
    (periodic) and the Stokes modes on config 5's 2x2x2 x 128^3 float32
    mesh (not periodic), each launch held bitwise against its plain version
    and timed beside its bounds; random states. Prints a line each; returns
    {mode: {dim: {...}}}."""
    import torch

    from implicitglobalgrid_tpu_torch.ops.staggered import SlabBatch

    out = {}
    g = torch.Generator(device="cuda").manual_seed(81)
    for label, n, dt, nd in (("step_128_f32", N_MESH, torch.float32, 3),
                             ("step_256_f64", N_CFG3, torch.float64, 3),
                             ("step2d_4096_f32", N_CFG2, torch.float32, 2)):
        block = (n,) * nd
        T, Cp = rand_state((2 * n,) * nd, dt, 11)
        moves = (cs.Move(n - 2, 0, -1), cs.Move(1, n - 1, 1))
        consts = CONSTS if nd == 3 else {k: v for k, v in CONSTS.items() if k != "dz"}
        earlier, out[label] = [], {}
        for dim in ((2, 0, 1) if nd == 3 else (0, 1)):
            kw = dict(block=block, periodic=True, earlier=tuple(earlier), Cp=Cp, consts=consts)
            out[label][dim] = _k4s_times(
                f"{label} dim {dim}", lambda: cs.exchange_slabs(T, dim, 1, moves, **kw),
                lambda: list(cs.exchange_slabs_plain(T, dim, 1, moves, **kw)),
                "exchange_slabs_kernel",
                slab_batch_bound("step", {"T": T, "Cp": Cp}, dim, {"T": (moves, ())}))
            earlier.append((dim, 1, rand_slabs(T.shape, block, (dim,), dt, g)[dim]))
        del T, Cp, earlier
    for mode, n, periods, state, recv_fn, mod, names, consts, plain in (
            ("wave", N_CFG4, (1, 1, 1), _rand_wave_state, _wave_recvs, cw, cw.FIELDS,
             cw.wave_consts(**WAVE), cw.wave_slabs_multi_plain),
            ("stokes", N_CFG5, (0, 0, 0), _rand_stokes_state, _stokes_recvs, cst, cst.STATE,
             STOKES, cst.stokes_slabs_multi_plain)):
        block = (n, n, n)
        gg = _acoustic_grid(tg, n, (2, 2, 2), periods)
        st = state(mod, block, (2, 2, 2), torch.float32, g)
        # the launcher the fused route keeps for a run: its arrays built once, no checks
        launcher = SlabBatch(f"igg_exchange_slabs_{mode}", block=block, counts=(2, 2, 2),
                             consts=consts, const_order=mod._CONST_ORDER, keep=True)
        out[mode] = {}
        for dim, (periodic, per_field) in sorted(
                _dim_batches(recv_fn, mod, gg, st, block, consts).items()):
            def flat(slabs):
                return [a for f in sorted(per_field) for a in slabs[f]]

            out[mode][dim] = _k4s_times(
                f"{mode} dim {dim}", lambda: flat(launcher(st, dim, 1, periodic, per_field)),
                lambda: flat(plain(st, dim, 1, per_field, block=block, periodic=periodic,
                                   consts=consts)),
                K4S_STAGGERED, slab_batch_bound(mode, dict(zip(names, st)), dim, per_field))
        tg.finalize_global_grid()
        del st
    for label, rows in out.items():
        for dim, r in sorted(rows.items()):
            print(f"  K4s {label} dim {dim}: {r['ms']:.5f} ms (events), device "
                  f"{r['device_ms']} ms, byte bound {r['bound_ms']:.5f} ms, sector bound "
                  f"{r['sector_bound_ms']} ms", flush=True)
    return out


# the coalesced groups of the main paths that K8 and K7 are timed on: config 4's
# update_halo(P, Vx, Vy, Vz), periodic, and config 5's plain-route exchange of
# (Vx, Vy, Vz, P), PROC_NULL edges; 2x2x2 blocks of float32, halowidth 1
K78_GROUPS = {"config4": (N_CFG4, ("P", "Vx", "Vy", "Vz"), True),
              "config5": (N_CFG5, ("Vx", "Vy", "Vz", "P"), False)}


def staggered_loc(n, name):
    """The local shape of a field of the acoustic or Stokes state."""
    return tuple(n + (name == f"V{a}") for a in "xyz")


# K8's and K7's device ms on this row's group before they took a member count
# (PERF.md's kernel table, rows 8 and 7; H100 80GB HBM3 at 700 W)
PR13_DEVICE_MS = {"k8": 0.0956, "k7": 0.1927}


def check_k7_k8(ch, tg):
    """K8 and K7 against their plain versions, bitwise: slab and flat
    layouts, 2 to 4 fields, float32, float64, int32, bfloat16 and int8
    (every element size), dims 0, 1 and 2,
    halowidths 1 and 2 and per field, staggered fields, periodic and
    PROC_NULL, on 2x2x2 x 64^3 blocks (and 2-D fields on 2x2 x 64^2); then
    their timing rows on the three
    dims of one coalesced `update_halo(P, Vx, Vy, Vz)` of 2x2x2 x 192^3
    float32 (that call also held bitwise against the plain versions)."""
    import itertools

    import torch

    from implicitglobalgrid_tpu_torch.ops.fields import block_slices
    from implicitglobalgrid_tpu_torch.ops.wire import schema_for_fields

    g = torch.Generator(device="cuda").manual_seed(31)
    n = N_CHECK
    counts = (2, 2, 2)
    err8 = err7 = 0.0
    groups = [([(n, n, n)] * 2, [1, 1]),
              ([(n, n, n), (n + 1, n, n), (n, n + 1, n), (n, n, n + 1)], [1] * 4),
              ([(n, n, n)] * 3, [2, 2, 2]),
              ([(n, n, n), (n + 1, n, n), (n, n, n)], [1, 2, 1])]
    layouts = set()
    for (locs, hws), dim, dt in itertools.product(groups, range(3), (
            torch.float32, torch.float64, torch.int32, torch.bfloat16, torch.int8)):
        fs = [(1000 * torch.rand(tuple(c * m for c, m in zip(counts, loc)), generator=g,
                                 device="cuda")).to(dt) for loc in locs]
        sch = schema_for_fields(dim, locs, hws, dt)
        layouts.add(sch.layout)
        kw = dict(starts_r=[loc[dim] - 3 * h for loc, h in zip(locs, hws)], starts_l=hws,
                  blocks=locs)
        bufs = ch.wire_pack(fs, sch, **kw)
        ref = ch.wire_pack_plain(fs, sch, **kw)
        torch.cuda.synchronize()
        err8 = max(err8, max(max_err(a, b) for a, b in zip(bufs, ref)))
        check(all(torch.equal(a, b) for a, b in zip(bufs, ref)),
              f"K8 {len(locs)} fields dim {dim} hw {hws} {name_of(dt)} {sch.layout} bitwise")
        for periodic in (True, False):
            f1, f2 = [f.clone() for f in fs], [f.clone() for f in fs]
            ch.halo_write_multi(f1, *bufs, sch, blocks=locs, periodic=periodic, disp=1)
            ch.halo_write_multi_plain(f2, *bufs, sch, blocks=locs, periodic=periodic, disp=1)
            torch.cuda.synchronize()
            err7 = max(err7, max(max_err(a, b) for a, b in zip(f1, f2)))
            check(all(torch.equal(a, b) for a, b in zip(f1, f2)),
                  f"K7 {len(locs)} fields dim {dim} hw {hws} {name_of(dt)} "
                  f"periodic={periodic} bitwise")
    for dim, (locs, hws) in itertools.product(range(2), [([(n, n), (n, n)], [1, 2]),
                                                         ([(n, n), (n + 1, n), (n, n + 1)],
                                                          [1, 1, 1])]):
        fs = [torch.randn((2 * loc[0], 2 * loc[1]), generator=g, device="cuda").double()
              for loc in locs]
        sch = schema_for_fields(dim, locs, hws, torch.float64)
        layouts.add(sch.layout)
        kw = dict(starts_r=[loc[dim] - 3 * h for loc, h in zip(locs, hws)], starts_l=hws,
                  blocks=locs)
        bufs, ref = ch.wire_pack(fs, sch, **kw), ch.wire_pack_plain(fs, sch, **kw)
        f1, f2 = [f.clone() for f in fs], [f.clone() for f in fs]
        ch.halo_write_multi(f1, *bufs, sch, blocks=locs, periodic=False, disp=1)
        ch.halo_write_multi_plain(f2, *bufs, sch, blocks=locs, periodic=False, disp=1)
        torch.cuda.synchronize()
        err8 = max(err8, max(max_err(a, b) for a, b in zip(bufs, ref)))
        err7 = max(err7, max(max_err(a, b) for a, b in zip(f1, f2)))
        check(all(torch.equal(a, b) for a, b in zip(bufs, ref))
              and all(torch.equal(a, b) for a, b in zip(f1, f2)),
              f"K8 and K7, 2-D fields {locs} dim {dim} {sch.layout}: bitwise")
    check(layouts == {"slab", "flat"}, "K7/K8 checked in slab and flat layouts")
    # timing: the coalesced update_halo of the acoustic state, 2x2x2 x 192^3
    n, names, _ = K78_GROUPS["config4"]
    locs = [staggered_loc(n, f) for f in names]
    fs = [torch.randn(tuple(2 * m for m in loc), generator=g, device="cuda") for loc in locs]
    schemas, starts = [], []
    for d in range(3):
        schemas.append(schema_for_fields(d, locs, [1] * 4, torch.float32))
        ols = [2 + loc[d] - n for loc in locs]
        starts.append(([loc[d] - ol for loc, ol in zip(locs, ols)], [ol - 1 for ol in ols]))

    def k8():
        return [ch.wire_pack(fs, schemas[d], starts_r=starts[d][0], starts_l=starts[d][1],
                             blocks=locs) for d in range(3)]

    def k8_plain():
        return [ch.wire_pack_plain(fs, schemas[d], starts_r=starts[d][0],
                                   starts_l=starts[d][1], blocks=locs) for d in range(3)]

    bufs = k8()
    ref = k8_plain()
    e8 = max(max_err(a, b) for x, y in zip(bufs, ref) for a, b in zip(x, y))
    check(e8 == 0.0 and all(torch.equal(a, b) for x, y in zip(bufs, ref) for a, b in zip(x, y)),
          f"K8 2x2x2x{n}^3 P, Vx, Vy, Vz bitwise ({e8:.3e})")
    views = [list(block_slices(f.shape, loc)) for f, loc in zip(fs, locs)]

    def k8_library():  # one torch.cat a dim and direction of the flattened slab views
        for d in range(3):
            for st in starts[d]:
                torch.cat([fs[k][views[k][b]].narrow(d, st[k], 1).reshape(-1)
                           for b in range(8) for k in range(4)])

    def k7():
        for d in range(3):
            ch.halo_write_multi(fs, *bufs[d], schemas[d], blocks=locs, periodic=True, disp=1)

    def k7_plain():
        for d in range(3):
            ch.halo_write_multi_plain(fs, *bufs[d], schemas[d], blocks=locs, periodic=True,
                                      disp=1)

    f2 = [f.clone() for f in fs]
    k7()
    for d in range(3):
        ch.halo_write_multi_plain(f2, *bufs[d], schemas[d], blocks=locs, periodic=True, disp=1)
    torch.cuda.synchronize()
    e7 = max(max_err(a, b) for a, b in zip(fs, f2))
    check(all(torch.equal(a, b) for a, b in zip(fs, f2)),
          f"K7 2x2x2x{n}^3 P, Vx, Vy, Vz bitwise ({e7:.3e})")
    coords = list(itertools.product(range(2), repeat=3))
    srcs = []  # (destination halo view, source slab view) for every copy
    for d in range(3):
        shape = schemas[d].buffer_shape
        for b, c in enumerate(coords):
            for side, buf, shift in ((0, bufs[d][0], -1), (1, bufs[d][1], 1)):
                src = list(c)
                src[d] = (c[d] + shift) % 2
                slabs = schemas[d].unpack(buf[coords.index(tuple(src))].view(shape))
                for k in range(4):
                    m = locs[k][d]
                    srcs.append((fs[k][views[k][b]].narrow(d, 0 if side == 0 else m - 1, 1),
                                 slabs[k]))

    def k7_library():  # one slice copy_ a field, block and side
        for dst, src in srcs:
            dst.copy_(src)

    slab_b = sum(2 * sum(s.cells) * 8 * 4 for s in schemas)  # both directions, 8 blocks
    sectors = [coalesced_bounds(fs, locs, [1] * 4, d, *starts[d], True, 1) for d in range(3)]
    shape = "the 3 dims of one coalesced update_halo(P, Vx, Vy, Vz), 2x2x2 x 192^3 float32"
    k8_row = dict(max_abs_err=max(err8, e8), ms=median_ms(k8), plain_ms=median_ms(
        k8_plain, batches=3, per_batch=2, warm=1),
        device_ms=device_ms(k8, KERNEL_NAMES["wire_pack"]), pr13_device_ms=PR13_DEVICE_MS["k8"],
        bound_ms=2 * slab_b / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        sector_bound_ms=sum(b["k8"][1] for b in sectors),
        library_ms=median_ms(k8_library, batches=3, per_batch=3, warm=1),
        **dict(zip(("library_device_ms", "library_kernels"), library_device_ms(k8_library))),
        shape=shape)
    k7_row = dict(max_abs_err=max(err7, e7), ms=median_ms(k7), plain_ms=median_ms(
        k7_plain, batches=3, per_batch=2, warm=1),
        device_ms=device_ms(k7, KERNEL_NAMES["halo_write_multi"]),
        pr13_device_ms=PR13_DEVICE_MS["k7"],
        bound_ms=2 * slab_b / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        sector_bound_ms=sum(b["k7"][1] for b in sectors),
        library_ms=median_ms(k7_library, batches=3, per_batch=3, warm=1),
        **dict(zip(("library_device_ms", "library_kernels"), library_device_ms(k7_library))),
        shape=shape)
    return k8_row, k7_row


def _slab_sectors(shape, blk, dim, runs, hw, itemsize):
    """The 32-byte sectors of a stacked field of ``shape`` (blocks ``blk``)
    that the cells ``[start, start + hw)`` along ``dim`` of the blocks ``c``
    in ``runs`` ((c, start) pairs, every block along the other dims) lie in,
    each once."""
    import numpy as np

    idx = [np.arange(s, dtype=np.int64) for s in shape]
    idx[dim] = np.array([c * blk[dim] + s + h for c, s in runs for h in range(hw)],
                        dtype=np.int64)
    return _box_sectors(shape, idx, itemsize)


def coalesced_bounds(fields, locs, hws, dim, starts_r, starts_l, periodic, disp):
    """Byte and 32-byte sector bounds (ms) of K8 and of K7 along ``dim`` for
    a group of stacked 3-D ``fields``: K8 reads both send slabs of every
    block and writes both buffers; K7 reads the buffer rows that have a
    neighbour and writes those halos (a PROC_NULL side none). The byte bound
    counts each cell once; the sector bound counts the field's sectors that
    the cells touch, each once (the buffers are contiguous: their bytes), the
    least a card that moves whole sectors moves. Returns ``{"k8": (bytes ms,
    sectors ms), "k7": (...)}``."""
    e = fields[0].element_size()
    D = int(fields[0].shape[dim]) // int(locs[0][dim])
    cells = {"k8": 0, "k7": 0}  # buffer cells written (K8) or read (K7)
    sectors = {"k8": 0, "k7": 0}
    for f, blk, hw, sr, sl in zip(fields, locs, hws, starts_r, starts_l):
        shape = tuple(int(s) for s in f.shape)
        slab_cells = f.numel() // blk[dim] * hw  # one start, every block
        runs8 = [(c, s) for c in range(D) for s in (sr, sl)]
        runs7 = [(c, s) for c in range(D) for s, shift in ((0, -disp), (blk[dim] - hw, disp))
                 if periodic or 0 <= c + shift < D]
        cells["k8"] += 2 * slab_cells
        cells["k7"] += slab_cells * len(runs7) // D
        sectors["k8"] += 32 * _slab_sectors(shape, blk, dim, runs8, hw, e)
        sectors["k7"] += 32 * _slab_sectors(shape, blk, dim, runs7, hw, e)
    ms = 1e3 / HBM_BYTES_PER_S
    return {k: (2 * cells[k] * e * ms, (sectors[k] + cells[k] * e) * ms)
            for k in ("k8", "k7")}


def k78_dim_times(ch):
    """K8 then K7 along x, y and z as `_exchange_dim_coalesced` runs them
    (the pack, then the unpack into the same fields), on the groups of
    `K78_GROUPS` (random states, the flat layout); each pair held bitwise
    against the plain versions first (buffers and fields), then timed: ``ms``
    the pair (CUDA events, Python included), each kernel's ``ms`` alone and
    ``device_ms`` inside the pair (torch.profiler), beside its byte and
    sector bounds (`coalesced_bounds`). Prints a line a launch; returns
    {group: {dim: {"k8": {...}, "k7": {...}, "pair_ms": t}}}."""
    import torch

    from implicitglobalgrid_tpu_torch.ops.wire import schema_for_fields

    g = torch.Generator(device="cuda").manual_seed(91)
    out = {}
    for label, (n, names, periodic) in K78_GROUPS.items():
        locs = [staggered_loc(n, f) for f in names]
        fs = [torch.randn(tuple(2 * m for m in loc), generator=g, device="cuda")
              for loc in locs]
        out[label] = {}
        for dim in range(3):
            sch = schema_for_fields(dim, locs, [1] * 4, torch.float32)
            ols = [2 + loc[dim] - n for loc in locs]
            kw = dict(starts_r=[loc[dim] - ol for loc, ol in zip(locs, ols)],
                      starts_l=[ol - 1 for ol in ols], blocks=locs)
            wk = dict(blocks=locs, periodic=periodic, disp=1)
            f1, f2 = [f.clone() for f in fs], [f.clone() for f in fs]
            b1 = ch.wire_pack(f1, sch, **kw)
            ch.halo_write_multi(f1, *b1, sch, **wk)
            b2 = ch.wire_pack_plain(f2, sch, **kw)
            ch.halo_write_multi_plain(f2, *b2, sch, **wk)
            torch.cuda.synchronize()
            e8 = max(max_err(a, b) for a, b in zip(b1, b2))
            e7 = max(max_err(a, b) for a, b in zip(f1, f2))
            check(all(torch.equal(a, b) for a, b in zip(b1, b2))
                  and all(torch.equal(a, b) for a, b in zip(f1, f2)),
                  f"K8 + K7 {label} dim {dim} {sch.layout}: the timed pair bitwise equal to "
                  f"plain ({e8:.3e}, {e7:.3e})")
            del f1, f2, b1, b2
            bufs = ch.wire_pack(fs, sch, **kw)

            def pair():
                ch.halo_write_multi(fs, *ch.wire_pack(fs, sch, **kw), sch, **wk)

            bounds = coalesced_bounds(fs, locs, [1] * 4, dim, kw["starts_r"], kw["starts_l"],
                                      periodic, 1)
            row = {"pair_ms": median_ms(pair)}
            for k, name, alone, err in (
                    ("k8", "wire_pack", lambda: ch.wire_pack(fs, sch, **kw), e8),
                    ("k7", "halo_write_multi",
                     lambda: ch.halo_write_multi(fs, *bufs, sch, **wk), e7)):
                row[k] = dict(ms=median_ms(alone), device_ms=device_ms(pair, KERNEL_NAMES[name]),
                              bound_ms=bounds[k][0], bound_by="bytes",
                              sector_bound_ms=bounds[k][1], max_abs_err=err)
            out[label][dim] = row
            del bufs
        del fs
    for label, rows in out.items():
        for dim, r in rows.items():
            for k in ("k8", "k7"):
                x = r[k]
                print(f"  {k.upper()} {label} dim {dim}: {x['ms']:.5f} ms alone (events), device "
                      f"{x['device_ms']} ms in the pair, byte bound {x['bound_ms']:.5f} ms, sector "
                      f"bound {x['sector_bound_ms']:.5f} ms", flush=True)
            print(f"  K8 + K7 {label} dim {dim}: {r['pair_ms']:.5f} ms (events)", flush=True)
    return out


WAVE_GRIDS = {"all self-neighbour": ((1, 1, 1), (1, 1, 1)),
              "all multi-rank periodic": ((2, 2, 2), (1, 1, 1)),
              "all multi-rank PROC_NULL edges": ((2, 2, 2), (0, 0, 0)),
              "self x + PROC_NULL y + 4-rank z": ((1, 2, 4), (1, 0, 1)),
              "no exchange at all": ((1, 1, 1), (0, 0, 0))}


def check_k9(cw, tg):
    """K9 bitwise against its plain version on the five grid kinds of the
    acoustic parity tests at 64^3 blocks, float32, float64 and bfloat16 (the
    all-self route, or the multi-rank route with the pipeline's received
    slabs); its timing row at 2x2x2 x 192^3 float32, all periodic, and the
    all-self route on one periodic 192^3 block (config 4's two cells) timed
    beside it, on random data."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(51)
    n = N_CHECK
    block = (n, n, n)
    k = cw.wave_consts(**WAVE)
    err = 0.0
    for label, (dims, periods) in WAVE_GRIDS.items():
        gg = _acoustic_grid(tg, n, dims, periods)
        for dt in (torch.float32, torch.float64, torch.bfloat16):
            st = _rand_wave_state(cw, block, dims, dt, g)
            modes, recvs = _wave_recvs(cw, gg, st, block, k)
            if cw.all_self_exchange(gg, modes):
                ols = cw.self_ols(gg, block)
                got = cw.acoustic_step_self(st, modes, ols, block=block, consts=k)
                ref = cw.acoustic_step_self_plain(st, modes, ols, block=block, consts=k)
                route = "all-self"
            else:
                got = cw.acoustic_step_recv(st, recvs, block=block, consts=k)
                ref = cw.acoustic_step_recv_plain(st, recvs, block=block, consts=k)
                route = "multi-rank"
            torch.cuda.synchronize()
            e = max(max_err(a, b) for a, b in zip(got, ref))
            err = max(err, e)
            check(all(torch.equal(a, b) for a, b in zip(got, ref)),
                  f"K9 {label} ({route}) {name_of(dt)} bitwise equal to plain "
                  f"(max abs err {e:.3e})")
    n = N_CFG4
    block = (n, n, n)
    gg = _acoustic_grid(tg, n, (1, 1, 1), (1, 1, 1))
    st1 = _rand_wave_state(cw, block, (1, 1, 1), torch.float32, g)
    modes1 = cw.wave_exchange_modes(gg, [tuple(a.shape) for a in st1])
    ols1 = cw.self_ols(gg, block)
    out1 = tuple(torch.empty_like(a) for a in st1)

    def k9_self():
        return cw.acoustic_step_self(st1, modes1, ols1, block=block, consts=k, out=out1)

    check(all(torch.equal(a, b) for a, b in zip(
        k9_self(), cw.acoustic_step_self_plain(st1, modes1, ols1, block=block, consts=k))),
        f"K9 one periodic {n}^3 block (all-self) float32 bitwise equal to plain")
    single = dict(ms=median_ms(k9_self),
                  device_ms=device_ms(k9_self, KERNEL_NAMES["acoustic_step_exchange"]),
                  bound_ms=cw.wave_bytes(st1) / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                  shape=f"one {n}^3 block float32, all periodic (all-self route)")
    del st1, out1
    gg = _acoustic_grid(tg, n, (2, 2, 2), (1, 1, 1))
    st = _rand_wave_state(cw, block, (2, 2, 2), torch.float32, g)
    _, recvs = _wave_recvs(cw, gg, st, block, k)
    out = tuple(torch.empty_like(a) for a in st)

    def k9():
        return cw.acoustic_step_recv(st, recvs, block=block, consts=k, out=out)

    ref = cw.acoustic_step_recv_plain(st, recvs, block=block, consts=k)
    e = max(max_err(a, b) for a, b in zip(k9(), ref))
    check(all(torch.equal(a, b) for a, b in zip(out, ref)),
          f"K9 2x2x2x{n}^3 float32 bitwise equal to plain ({e:.3e})")
    del ref
    slab_b = sum(s.numel() * 4 for per in recvs.values() for p in per.values() for s in p)
    bound_b = (cw.wave_bytes(st) + slab_b) / HBM_BYTES_PER_S * 1e3
    bound_o = st[0].numel() * WAVE_FLOPS_PER_CELL / F32_FLOPS_PER_S * 1e3
    return dict(
        max_abs_err=max(err, e), ms=median_ms(k9),
        plain_ms=median_ms(lambda: cw.acoustic_step_recv_plain(st, recvs, block=block,
                                                               consts=k),
                           batches=3, per_batch=2, warm=1),
        device_ms=device_ms(k9, KERNEL_NAMES["acoustic_step_exchange"]),
        bound_ms=max(bound_b, bound_o), bound_by="bytes" if bound_b >= bound_o else "operations",
        library_ms=None, single_block=single,
        shape=f"2x2x2 x {n}^3 float32, all periodic (every field, every dim received)")


def k9_kernels_ms(cw, gg, state, block, consts):
    """Device ms of K9 on one state of config 4: the route the grid takes
    (all-self, or the multi-rank route delivering the pipeline's slabs)."""
    import torch

    modes, recvs = _wave_recvs(cw, gg, state, block, consts)
    out = tuple(torch.empty_like(a) for a in state)
    if cw.all_self_exchange(gg, modes):
        ols = cw.self_ols(gg, block)

        def k9():
            return cw.acoustic_step_self(state, modes, ols, block=block, consts=consts, out=out)
    else:
        def k9():
            return cw.acoustic_step_recv(state, recvs, block=block, consts=consts, out=out)
    return device_ms(k9, KERNEL_NAMES["acoustic_step_exchange"])


def _acoustic_step(tg, cw, s0, p):
    """One fused step from ``s0`` as `run_acoustic` takes it: the route
    resolved once (an `AcousticStep`), a spare state to write."""
    import torch

    gg = tg.global_grid()
    locs = [tuple(s // int(d) for s, d in zip(a.shape, gg.dims)) for a in s0]
    step = cw.AcousticStep(gg, cw.wave_exchange_modes(gg, locs), rho=p.rho, K=p.K, dt=p.dt,
                           dx=p.dx, dy=p.dy, dz=p.dz, block=locs[0])
    out = tuple(torch.empty_like(a) for a in s0)
    return lambda: step(s0, out)


def _gather_all(tg, state):
    return [tg.gather_interior(a) for a in state]


def _run_matches(G, Gp, tol):
    import numpy as np

    err = max(float(np.abs(a.astype(np.float64) - b).max()) for a, b in zip(G, Gp))
    return all(np.allclose(a, b, **tol) for a, b in zip(G, Gp)), err


def phase_config4_single(tg, models, cb, cw):
    """Phase 8: BASELINE config 4 on one 192^3 block, all periodic, float32,
    the example's flow, against the plain route."""
    import numpy as np
    import torch

    n, nt, chunk = N_CFG4, 600, 60
    print(f"phase: BASELINE config 4, one {n}^3 block float32, nt={nt}", flush=True)
    kw = dict(periodx=1, periody=1, periodz=1)
    grid(tg, n, n, n, **kw)
    s0, p = models.init_acoustic3d(dtype=torch.float32)
    models.run_acoustic(s0, p, chunk, nt_chunk=chunk)   # warm chunk
    cb.reset_launch_counts()
    tg.tic()
    s = models.run_acoustic(s0, p, nt, nt_chunk=chunk)
    t = tg.toc()
    G = _gather_all(tg, s)
    torch.cuda.synchronize()
    counts = cb.launch_counts()
    cells = tg.nx_g() * tg.ny_g() * tg.nz_g()
    rate = cells * nt / t
    print(f"  config 4 single: nt={nt} in {t:.6f} s = {rate:.6e} cell-updates/s "
          f"(global {tg.nx_g()}x{tg.ny_g()}x{tg.nz_g()}); launches {counts}", flush=True)
    check(counts["acoustic_step_exchange"] == nt and counts["exchange_slabs"] == 0
          and sum(counts.values()) == nt, "config 4 single: K9 once per step, all-self route")
    check(G[0].shape == (tg.nx_g(), tg.ny_g(), tg.nz_g())
          and all(bool(np.isfinite(g).all()) for g in G),
          f"config 4 single: gathered fields finite, P {G[0].shape}")
    gg = tg.global_grid()
    block = (n, n, n)
    modes = cw.wave_exchange_modes(gg, [tuple(a.shape) for a in s0])
    ols = cw.self_ols(gg, block)
    k = cw.wave_consts(rho=p.rho, K=p.K, dt=p.dt, dx=p.dx, dy=p.dy, dz=p.dz)
    a = cw.acoustic_step_self(s, modes, ols, block=block, consts=k)
    b = cw.acoustic_step_self_plain(s, modes, ols, block=block, consts=k)
    err_k9 = max(max_err(x, y) for x, y in zip(a, b))
    check(all(torch.equal(x, y) for x, y in zip(a, b)),
          f"config 4 single: one step by K9 from the state after {nt} steps bitwise equal to "
          f"its plain version ({err_k9:.3e})")
    del a, b
    k9_own = dict(initial=k9_kernels_ms(cw, gg, s0, block, k),
                  after_steps=k9_kernels_ms(cw, gg, s, block, k), steps=nt)
    print(f"  K9 on config 4's own states (device ms): {k9_own}", flush=True)
    times = route_times(_acoustic_step(tg, cw, s0, p))
    print(f"  K9 route per step: {times}", flush=True)
    grid(tg, n, n, n, plain=True, **kw)
    t1 = time.perf_counter()
    Gp = _gather_all(tg, models.run_acoustic(s0, p, nt, nt_chunk=chunk))
    plain_s = time.perf_counter() - t1
    ok, err = _run_matches(G, Gp, dict(rtol=1e-5, atol=1e-5))
    check(ok, f"config 4 single: matches the plain route on the card (max abs err {err:.3e})")
    check(not np.allclose(G[0], tg.gather_interior(s0[0])), "config 4 single: the state evolved")
    tg.finalize_global_grid()
    os.environ.pop("IGG_USE_PALLAS", None)
    return counts, dict(seconds=t, cell_updates_per_s=rate, global_cells=cells,
                        plain_seconds=plain_s, max_abs_err_vs_plain=err,
                        k9_vs_plain_one_step=err_k9, k9_route=times, k9_kernels_ms=k9_own)


def phase_config4_mesh(tg, models, cb, cw):
    """Phase 9: BASELINE config 4 on a 2x2x2 mesh of 192^3 blocks, all
    periodic, float32: the fused route, a coalesced update_halo, the plain
    route, against the plain grid."""
    import numpy as np
    import torch

    n, nt = N_CFG4, 100
    print(f"phase: BASELINE config 4, 2x2x2 x {n}^3 float32, nt={nt}", flush=True)
    kw = dict(dimx=2, dimy=2, dimz=2, periodx=1, periody=1, periodz=1)
    grid(tg, n, n, n, **kw)
    s0, p = models.init_acoustic3d(dtype=torch.float32)
    models.run_acoustic(s0, p, 2, nt_chunk=2)  # warm chunk
    cb.reset_launch_counts()
    tg.tic()
    s = models.run_acoustic(s0, p, nt, nt_chunk=nt)
    t = tg.toc()
    counts = cb.launch_counts()
    k4s = cb.k4s_launch_counts()  # its K4s launches by mode and dim
    G = _gather_all(tg, s)
    cells = tg.nx_g() * tg.ny_g() * tg.nz_g()
    rate = cells * nt / t
    print(f"  config 4 mesh: nt={nt} in {t:.6f} s = {rate:.6e} cell-updates/s "
          f"(global {tg.nx_g()}x{tg.ny_g()}x{tg.nz_g()}); launches {counts}", flush=True)
    check(counts["acoustic_step_exchange"] == nt, "config 4 mesh: K9 launched once per step")
    check(counts["exchange_slabs"] == 3 * nt and sum(counts.values()) == 4 * nt,
          "config 4 mesh: K4s once a dim a step for the four fields")
    check(all(bool(np.isfinite(g).all()) for g in G), "config 4 mesh: gathered fields finite")
    # a standalone coalesced update_halo: one group (P, Vx, Vy, Vz) a dim
    c0 = cb.launch_counts()
    U = tg.update_halo(*[a.clone() for a in s])
    torch.cuda.synchronize()
    c1 = cb.launch_counts()
    du = {k: c1[k] - c0[k] for k in c1}
    print(f"  update_halo(P, Vx, Vy, Vz) launches {du}", flush=True)
    check(du["wire_pack"] == 3 and du["halo_write_multi"] == 3 and sum(du.values()) == 6,
          "config 4 mesh: update_halo(P, Vx, Vy, Vz) went through K8 and K7, once per dim")
    # a few steps of the plain route: K8/K7 for the velocities, K4s + K6 for P
    sp = models.run_acoustic(s0, p, 3, nt_chunk=3, impl="plain")
    torch.cuda.synchronize()
    c2 = cb.launch_counts()
    dp = {k: c2[k] - c1[k] for k in c2}
    print(f"  3 plain-route steps launches {dp}", flush=True)
    check(dp["wire_pack"] == 9 and dp["halo_write_multi"] == 9
          and dp["halo_write_combined"] == 3 and dp["exchange_slabs"] == 9,
          "config 4 mesh: the plain route's exchanges took K8/K7 (velocities), K4s/K6 (P)")
    counts = c2
    times = route_times(_acoustic_step(tg, cw, s0, p), reps=5)
    print(f"  K4s + K9 route per step: {times}", flush=True)
    plain_times = route_times(lambda: models.acoustic_step_local(s0, p, impl="plain"), reps=5)
    print(f"  plain route per step: {plain_times}", flush=True)
    gg = tg.global_grid()
    block = (n, n, n)
    k = cw.wave_consts(rho=p.rho, K=p.K, dt=p.dt, dx=p.dx, dy=p.dy, dz=p.dz)
    k9_own = dict(initial=k9_kernels_ms(cw, gg, s0, block, k),
                  after_steps=k9_kernels_ms(cw, gg, s, block, k), steps=nt)
    print(f"  K9 on config 4's own states (device ms): {k9_own}", flush=True)
    # the transport phase's reference: 10 fused steps, then update_halo
    s10 = models.run_acoustic(s0, p, 10, nt_chunk=10)
    ref = {f"config4_{f}": tg.gather(a) for f, a in zip(
        ("P", "Vx", "Vy", "Vz"), tg.update_halo(*[a.clone() for a in s10]))}
    del s10
    bf16 = acoustic_bf16_mesh(tg, models, cw, p)
    grid(tg, n, n, n, plain=True, **kw)
    Up = tg.update_halo(*[a.clone() for a in s])
    err_uh = max(max_err(a, b) for a, b in zip(U, Up))
    check(all(torch.equal(a, b) for a, b in zip(U, Up)),
          f"config 4 mesh: update_halo(P, Vx, Vy, Vz) bitwise equal to the plain grid's, "
          f"halos included ({err_uh:.3e})")
    del U, Up
    spp = models.run_acoustic(s0, p, 3, nt_chunk=3)
    ok, err_p = _run_matches(_gather_all(tg, sp), _gather_all(tg, spp),
                             dict(rtol=1e-5, atol=1e-5))
    check(ok, f"config 4 mesh: 3 plain-route steps match IGG_USE_PALLAS=0 ({err_p:.3e})")
    del sp, spp
    Gp = _gather_all(tg, models.run_acoustic(s0, p, nt, nt_chunk=nt))
    ok, err = _run_matches(G, Gp, dict(rtol=1e-5, atol=1e-5))
    check(ok, f"config 4 mesh: matches the plain route on the card (max abs err {err:.3e})")
    check(not np.allclose(G[0], tg.gather_interior(s0[0])), "config 4 mesh: the state evolved")
    tg.finalize_global_grid()
    os.environ.pop("IGG_USE_PALLAS", None)
    return counts, dict(k4s_launches=k4s, seconds=t, cell_updates_per_s=rate,
                        global_cells=cells,
                        max_abs_err_vs_plain=err, max_abs_err_plain_route=err_p,
                        k9_route=times, plain_route=plain_times, k9_kernels_ms=k9_own,
                        bf16=bf16, step_ms=t * 1e3 / nt, transport_ref=ref)


BF16_STEPS, BF16_HELD = 20, 5


def acoustic_bf16_mesh(tg, models, cw, p):
    """A bfloat16 acoustic run on the 2x2x2 mesh of config 4 (the grid that
    is current): BF16_HELD steps of the fused route (K4s wave modes + K9 in
    bfloat16) bitwise against the same steps by the kernels' plain versions
    on the card; BF16_STEPS steps against the plain route, both held to a
    float64 run: the fused route's bfloat16 drift from float64 at most twice
    the plain route's (the two round at different points; CPU runs of the
    port drift 0.8-1.3x the plain route's)."""
    import numpy as np
    import torch

    s0, _ = models.init_acoustic3d(dtype=torch.bfloat16)
    held = models.run_acoustic(s0, p, BF16_HELD, nt_chunk=BF16_HELD)
    on_card = cw._on_card
    cw._on_card = lambda t: False  # the fused route's plain versions, on the card
    try:
        ref = models.run_acoustic(s0, p, BF16_HELD, nt_chunk=BF16_HELD)
    finally:
        cw._on_card = on_card
    check(all(torch.equal(a, b) for a, b in zip(held, ref)),
          f"config 4 mesh bfloat16: {BF16_HELD} fused steps bitwise equal to the kernels' "
          "plain versions on the card")
    del held, ref
    fused = _gather_all(tg, models.run_acoustic(s0, p, BF16_STEPS, nt_chunk=BF16_STEPS))
    plain = _gather_all(tg, models.run_acoustic(s0, p, BF16_STEPS, nt_chunk=BF16_STEPS,
                                                impl="plain"))
    f64 = _gather_all(tg, models.run_acoustic(tuple(a.double() for a in s0), p, BF16_STEPS,
                                              nt_chunk=BF16_STEPS))
    out = {}
    for name, a, b, c in zip(cw.FIELDS, fused, plain, f64):
        scale = float(np.abs(c).max())
        out[name] = dict(fused_vs_f64=float(np.abs(a - c).max()) / scale,
                         plain_vs_f64=float(np.abs(b - c).max()) / scale,
                         fused_vs_plain=float(np.abs(a - b).max()) / scale)
    print(f"  bfloat16 mesh, {BF16_STEPS} steps (max errors over max|float64 field|): {out}",
          flush=True)
    check(all(np.isfinite(a).all() for a in fused)
          and all(r["fused_vs_f64"] <= 2 * r["plain_vs_f64"] for r in out.values()),
          "config 4 mesh bfloat16: the fused route's drift from float64 within twice the "
          "plain route's")
    return out


def _rand_stokes_state(cst, block, counts, dtype, g):
    import torch

    return tuple((torch.rand(tuple(c * s for c, s in zip(counts, shp)), generator=g,
                             device="cuda") - 0.5).to(dtype)
                 for shp in cst.stokes_shapes(block).values())


# PT constants near `init_stokes3d`'s scalings for a 128^3 grid
STOKES = dict(mu=1.0, dt_v=0.0004, dt_p=0.047, damp=0.953, dx=0.079, dy=0.079, dz=0.079)


def _stokes_recvs(cst, gg, state, block, consts, check=None):
    """The received slabs of the fused iteration's pipeline (one batched K4s
    Stokes-mode launch a dim); ``check(got, dim, periodic, per_field)`` sees
    each launch's slabs."""
    from implicitglobalgrid_tpu_torch.ops.halo import exchange_recv_slabs_multi

    modes = cst.stokes_exchange_modes(gg, [tuple(s // int(d) for s, d in zip(a.shape, gg.dims))
                                           for a in state])

    def dim_fn(dim, hw, periodic, per_field):
        got = cst.stokes_slabs_multi(state, dim, hw, per_field, block=block, periodic=periodic,
                                     consts=consts)
        if check is not None:
            check(got, dim, periodic, per_field)
        return got

    return modes, exchange_recv_slabs_multi(gg, cst.wave_shapes(block), (1, 1, 1), modes,
                                            dim_fn=dim_fn)


def k10_kernels_ms(cst, state, recvs, block, consts):
    """Device ms of K10's two multi-rank kernels on one state: the tiles (a
    launch that delivers ``recvs``, or slabs of zeros where the grid
    receives none) and the per-column kernel (a launch that delivers
    nothing: the iteration alone). K10 picks the per-column kernel where it
    receives no slab (csrc/stokes.cu)."""
    import torch

    if not recvs:
        counts = tuple(a // b for a, b in zip(state[0].shape, block))
        recvs = {f: {d: tuple(torch.zeros([c if e == d else c * n for e, (c, n) in
                                           enumerate(zip(counts, shp))], dtype=state[0].dtype,
                                          device=state[0].device) for _ in range(2))
                     for d in range(3)} for f, shp in cst.wave_shapes(block).items()}
    out = tuple(torch.empty_like(a) for a in state[:7])
    name = KERNEL_NAMES["stokes_step_exchange"]
    return dict(
        tiles=device_ms(lambda: cst.stokes_step_recv(state, recvs, block=block, consts=consts,
                                                     out=out), name),
        column=device_ms(lambda: cst.stokes_step_recv(state, {}, block=block, consts=consts,
                                                      out=out), name))


def check_k4s_stokes(cs, cst, tg):
    """The K4s Stokes modes bitwise against their plain version: every
    field, dim and range (send and current) with the identity move on 2x2x2
    x 64^3 blocks, and every launch of the fused iteration's pipeline
    (moves, PROC_NULL edges, earlier dims' corners) on 2x2x2 x 128^3,
    float32 and float64 (one batched launch a dim for the four fields).
    Returns the max abs err."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(61)
    err = 0.0
    for dt in (torch.float32, torch.float64):
        n = N_CHECK
        block = (n, n, n)
        st = _rand_stokes_state(cst, block, (2, 2, 2), dt, g)
        for f, m in cst.wave_shapes(block).items():
            for dim in range(3):
                starts = [m[dim] - 2 - (m[dim] - n), 1 + (m[dim] - n), 0, m[dim] - 1]
                got = cst.stokes_update_slab(st, f, dim, starts, 1, block=block, consts=STOKES)
                for s0, gs in zip(starts, got):
                    ref = cst.stokes_slabs_plain(st, f, dim, 1, (cs.Move(s0, s0, 0),),
                                                 block=block, periodic=True, consts=STOKES)[0]
                    torch.cuda.synchronize()
                    e = max_err(gs, ref)
                    err = max(err, e)
                    check(torch.equal(gs, ref),
                          f"K4s Stokes {f} dim {dim} start {s0} {name_of(dt)} bitwise equal to "
                          f"plain ({e:.3e})")
        del st
        n = N_CFG5
        block = (n, n, n)
        for periods in ((1, 1, 1), (0, 0, 0)):
            gg = _acoustic_grid(tg, n, (2, 2, 2), periods)
            st = _rand_stokes_state(cst, block, (2, 2, 2), dt, g)
            errs = []

            def plain(dim, periodic, per_field):
                return cst.stokes_slabs_multi_plain(st, dim, 1, per_field, block=block,
                                                    periodic=periodic, consts=STOKES)

            _stokes_recvs(cst, gg, st, block, STOKES,
                          _hold_batches(f"K4s Stokes 2x2x2x{n}^3 {name_of(dt)}", plain, errs))
            check(len(errs) == 3, "K4s Stokes: 3 batched launches (one a dim) held")
            err = max(err, *errs)
            del st
    tg.finalize_global_grid()
    return err


def check_k10(cst, tg):
    """K10 bitwise against its plain version on the five grid kinds of the
    parity tests at 64^3 blocks, on 2x2x2 x 128^3 and on one 128^3 block,
    each periodic (multi-rank and all-self routes) and non-periodic (config
    5's two grids), float32 and float64; its timing row at 2x2x2 x 128^3
    float32, all periodic (every field received on every dim), with the
    all-self route and one non-periodic block (config 5's single-block
    iteration, no exchange) timed beside it; the mesh launch and the
    single block also on zeros (a solver's start) and on float32
    subnormals (the division's IEEE fallback)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(71)
    err = 0.0
    cases = [(N_CHECK, dims, periods) for dims, periods in WAVE_GRIDS.values()]
    cases += [(N_CFG5, dims, periods) for dims in ((2, 2, 2), (1, 1, 1))
              for periods in ((1, 1, 1), (0, 0, 0))]
    for n, dims, periods in cases:
        gg = _acoustic_grid(tg, n, dims, periods)
        block = (n, n, n)
        for dt in (torch.float32, torch.float64):
            st = _rand_stokes_state(cst, block, dims, dt, g)
            modes, recvs = _stokes_recvs(cst, gg, st, block, STOKES)
            if cst.all_self_exchange(gg, modes):
                ols = cst.self_ols(gg, block)
                got = cst.stokes_step_self(st, modes, ols, block=block, consts=STOKES)
                ref = cst.stokes_step_self_plain(st, modes, ols, block=block, consts=STOKES)
                route = "all-self"
            else:
                got = cst.stokes_step_recv(st, recvs, block=block, consts=STOKES)
                ref = cst.stokes_step_recv_plain(st, recvs, block=block, consts=STOKES)
                route = "multi-rank"
            torch.cuda.synchronize()
            e = max(max_err(a, b) for a, b in zip(got, ref))
            err = max(err, e)
            check(all(torch.equal(a, b) for a, b in zip(got, ref)),
                  f"K10 {dims} x {n}^3 periods {periods} ({route}) {name_of(dt)} bitwise equal "
                  f"to plain (max abs err {e:.3e})")
            del st, got, ref, recvs

    def row(dims, periods):
        n = N_CFG5
        block = (n, n, n)
        gg = _acoustic_grid(tg, n, dims, periods)
        st = _rand_stokes_state(cst, block, dims, torch.float32, g)
        modes, recvs = _stokes_recvs(cst, gg, st, block, STOKES)
        out = tuple(torch.empty_like(a) for a in st[:7])
        if cst.all_self_exchange(gg, modes):
            ols = cst.self_ols(gg, block)

            def k10():
                return cst.stokes_step_self(st, modes, ols, block=block, consts=STOKES, out=out)
        else:
            def k10():
                return cst.stokes_step_recv(st, recvs, block=block, consts=STOKES, out=out)
        slab_b = sum(s.numel() * 4 for per in recvs.values() for p in per.values() for s in p)
        bound_b = (cst.stokes_bytes(st) + slab_b) / HBM_BYTES_PER_S * 1e3
        bound_o = st[0].numel() * STOKES_FLOPS_PER_CELL / F32_FLOPS_PER_S * 1e3
        return st, recvs, k10, bound_b, bound_o

    st, recvs, k10, bound_b, bound_o = row((2, 2, 2), (1, 1, 1))
    r = dict(max_abs_err=err, ms=median_ms(k10),
             kernels_device_ms=k10_kernels_ms(cst, st, recvs, (N_CFG5,) * 3, STOKES),
             plain_ms=median_ms(lambda: cst.stokes_step_recv_plain(
                 st, recvs, block=(N_CFG5,) * 3, consts=STOKES), batches=3, per_batch=2, warm=1),
             device_ms=device_ms(k10, KERNEL_NAMES["stokes_step_exchange"]),
             bound_ms=max(bound_b, bound_o),
             bound_by="bytes" if bound_b >= bound_o else "operations", library_ms=None,
             shape=f"2x2x2 x {N_CFG5}^3 float32, all periodic (every field, every dim "
                   "received)")

    def data_times(st, into):
        """K10 on zeros (where a solver starts) and on float32 subnormals (the
        division's IEEE fallback), same grid and route as ``st``."""
        gg = tg.global_grid()
        for key, scale in (("zeros_device_ms", 0.0), ("subnormal_device_ms", 1e-39)):
            sd = tuple(a * scale for a in st)
            _, rd = _stokes_recvs(cst, gg, sd, (N_CFG5,) * 3, STOKES)
            out = tuple(torch.empty_like(a) for a in sd[:7])
            into[key] = device_ms(lambda: cst.stokes_step_recv(sd, rd, block=(N_CFG5,) * 3,
                                                               consts=STOKES, out=out),
                                  KERNEL_NAMES["stokes_step_exchange"])
            del sd, rd, out

    data_times(st, r)
    del st, recvs
    for key, periods in (("self_route", (1, 1, 1)), ("single_block", (0, 0, 0))):
        st, _, k10, bound_b, bound_o = row((1, 1, 1), periods)
        r[key] = dict(ms=median_ms(k10),
                      device_ms=device_ms(k10, KERNEL_NAMES["stokes_step_exchange"]),
                      bound_ms=max(bound_b, bound_o), periods=periods)
        if key == "single_block":
            r[key]["kernels_device_ms"] = k10_kernels_ms(cst, st, {}, (N_CFG5,) * 3, STOKES)
            data_times(st, r[key])
        del st
    tg.finalize_global_grid()
    return r


def state_magnitudes(state):
    """Shares of a float32 state's values that are zero, subnormal, normal
    below 2^-102 (under the window of cdiv.cuh's corrected product for
    config 5's divisors) and normal above it."""
    import torch

    a = torch.cat([x.reshape(-1).abs() for x in state])
    n = a.numel()
    tiny = torch.finfo(torch.float32).tiny
    zero = int((a == 0).sum())
    sub = int(((a > 0) & (a < tiny)).sum())
    low = int(((a >= tiny) & (a < 2.0 ** -102)).sum())
    return dict(zero=zero / n, subnormal=sub / n, below_2_102=low / n,
                normal=(n - zero - sub - low) / n)


def _stokes_iteration(tg, cst, s0, p):
    """One fused iteration from ``s0`` as `run_stokes` takes it: the route
    resolved once (a `StokesStep`), a spare state to write."""
    import torch

    gg = tg.global_grid()
    locs = [tuple(s // int(d) for s, d in zip(a.shape, gg.dims)) for a in s0]
    step = cst.StokesStep(gg, cst.stokes_exchange_modes(gg, locs), p, block=locs[0])
    out = tuple(torch.empty_like(a) for a in s0)
    return lambda: step(s0, out)


def phase_config5_single(tg, models, cb, cst):
    """Phase 10: BASELINE config 5 on one 128^3 block, float32, non-periodic,
    the example's solver loop, against the plain route."""
    import numpy as np
    import torch

    from implicitglobalgrid_tpu_torch.examples.stokes3D_multixpu import stokes3D

    n, chunk, max_iters, tol = N_CFG5, 500, 6000, 5e-4
    print(f"phase: BASELINE config 5, one {n}^3 block float32, <= {max_iters} PT iterations "
          "(the port's examples/stokes3D_multixpu.py)", flush=True)
    if tg.grid_is_initialized():
        tg.finalize_global_grid()  # the example initializes its own grid
    os.environ.pop("IGG_USE_PALLAS", None)
    cb.reset_launch_counts()
    run = stokes3D(n=n, max_iters=max_iters, check_every=chunk, tol=tol, finalize=False,
                   log=lambda line: print("  " + line, flush=True))
    s0, p, state, it, t = run["init"], run["params"], run["state"], run["iterations"], \
        run["seconds"]
    history, P = run["history"], run["P"]
    res = history[-1][1:]
    torch.cuda.synchronize()
    counts = cb.launch_counts()
    cells = tg.nx_g() * tg.ny_g() * tg.nz_g()
    rate = cells * it / t
    status = "converged" if max(res) < tol else "max-iters"
    print(f"  config 5 single: {status} after {it} PT iterations in {t:.6f} s = {rate:.6e} "
          f"cell-updates/s (global {tg.nx_g()}x{tg.ny_g()}x{tg.nz_g()}); P range "
          f"[{float(P.min()):+.3e}, {float(P.max()):+.3e}]; launches {counts}", flush=True)
    check(counts["stokes_step_exchange"] == it + chunk and sum(counts.values()) == it + chunk,
          "config 5 single: K10 once per iteration (the example's warm chunk included), "
          "nothing else")
    check(P.shape == (tg.nx_g(), tg.ny_g(), tg.nz_g()) and bool(np.isfinite(P).all())
          and all(np.isfinite(h[1:]).all() for h in history),
          f"config 5 single: P finite, shape {P.shape}; residuals finite")
    check(history[-1][2] < history[0][2] or max(res) < tol,
          f"config 5 single: max|R| fell {history[0][2]:.3e} -> {history[-1][2]:.3e}")
    Vz = tg.gather_interior(state[3])
    c = Vz.shape[0] // 2
    check(Vz[c, c, c] > 0, "config 5 single: the buoyant sphere drives upward flow")
    times = route_times(_stokes_iteration(tg, cst, s0, p))
    print(f"  K10 route per iteration: {times}", flush=True)
    solver_ms = device_ms(_stokes_iteration(tg, cst, state, p),
                          KERNEL_NAMES["stokes_step_exchange"])
    both = k10_kernels_ms(cst, state, {}, (n, n, n), cst.stokes_consts(p))
    print(f"  K10 on the converged state: {solver_ms} ms (device); its kernels: {both}",
          flush=True)
    G = [tg.gather_interior(a) for a in models.run_stokes(s0, p, 100, nt_chunk=100)[:4]]
    grid(tg, n, n, n, plain=True)
    t1 = time.perf_counter()
    Gp = [tg.gather_interior(a) for a in models.run_stokes(s0, p, 100, nt_chunk=100)[:4]]
    plain_s = time.perf_counter() - t1
    err = max(float(np.abs(a.astype(np.float64) - b).max()) for a, b in zip(G, Gp))
    ok = all(np.allclose(a, b, rtol=1e-4, atol=1e-5 * max(1e-30, float(np.abs(b).max())))
             for a, b in zip(G, Gp))
    check(ok, f"config 5 single: 100 iterations match the plain route ({err:.3e})")
    tg.finalize_global_grid()
    os.environ.pop("IGG_USE_PALLAS", None)
    return counts, dict(status=status, iterations=it, residuals=list(res), seconds=t,
                        cell_updates_per_s=rate, global_cells=cells, history=history,
                        plain_100_seconds=plain_s, max_abs_err_vs_plain_100=err, k10_route=times,
                        k10_solver_device_ms=solver_ms, k10_solver_kernels_device_ms=both)


def phase_config5_mesh(tg, models, cb, cst):
    """Phase 11: BASELINE config 5 on a 2x2x2 mesh of 128^3 blocks, float32,
    non-periodic: the fused route, against the plain route (K8 + K7)."""
    import numpy as np
    import torch

    n, nt = N_CFG5, 300
    print(f"phase: BASELINE config 5, 2x2x2 x {n}^3 float32, nt={nt}", flush=True)
    kw = dict(dimx=2, dimy=2, dimz=2)
    grid(tg, n, n, n, **kw)
    s0, p = models.init_stokes3d(dtype=torch.float32)
    models.run_stokes(s0, p, 2, nt_chunk=2)  # warm chunk
    cb.reset_launch_counts()
    tg.tic()
    s = models.run_stokes(s0, p, nt, nt_chunk=nt)
    t = tg.toc()
    counts = cb.launch_counts()
    k4s = cb.k4s_launch_counts()  # its K4s launches by mode and dim
    res = models.stokes_residuals(s, p)
    G = [tg.gather_interior(a) for a in s[:4]]
    cells = tg.nx_g() * tg.ny_g() * tg.nz_g()
    rate = cells * nt / t
    print(f"  config 5 mesh: nt={nt} in {t:.6f} s = {rate:.6e} cell-updates/s (global "
          f"{tg.nx_g()}x{tg.ny_g()}x{tg.nz_g()}); residuals {res}; launches {counts}",
          flush=True)
    check(counts["stokes_step_exchange"] == nt, "config 5 mesh: K10 launched once per iteration")
    check(counts["exchange_slabs"] == 3 * nt and sum(counts.values()) == 4 * nt,
          "config 5 mesh: K4s once a dim an iteration for the four fields")
    check(all(bool(np.isfinite(g).all()) for g in G) and np.isfinite(res).all(),
          "config 5 mesh: gathered fields and residuals finite")
    times = route_times(_stokes_iteration(tg, cst, s0, p), reps=5)
    print(f"  K4s + K10 route per iteration: {times}", flush=True)
    solver_ms = device_ms(_stokes_iteration(tg, cst, s, p), KERNEL_NAMES["stokes_step_exchange"])
    consts = cst.stokes_consts(p)
    _, recvs = _stokes_recvs(cst, tg.global_grid(), s, (n, n, n), consts)
    both = k10_kernels_ms(cst, s, recvs, (n, n, n), consts)
    del recvs
    mags = state_magnitudes(s[:7])
    print(f"  K10 on the state after {nt} iterations: {solver_ms} ms (device); its kernels: "
          f"{both}; its values: {mags}", flush=True)
    s20 = models.run_stokes(s0, p, 20, nt_chunk=20)
    f20 = [tg.gather_interior(a) for a in s20[:4]]
    ref = {f"config5_{f}": g for f, g in zip(("P", "Vx", "Vy", "Vz"), f20)}
    ref["config5_residuals"] = np.array(models.stokes_residuals(s20, p))
    del s20
    c0 = cb.launch_counts()
    p20 = [tg.gather_interior(a) for a in models.run_stokes(s0, p, 20, nt_chunk=20,
                                                            impl="plain")[:4]]
    torch.cuda.synchronize()
    c1 = cb.launch_counts()
    dp = {k: c1[k] - c0[k] for k in c1}
    print(f"  20 plain-route iterations launches {dp}", flush=True)
    check(dp["wire_pack"] == 60 and dp["halo_write_multi"] == 60 and sum(dp.values()) == 120,
          "config 5 mesh: the plain route exchanged (Vx, Vy, Vz, P) as one group a dim (K8/K7)")
    counts = {k: counts[k] + dp[k] for k in counts}  # the timed run and the plain route's
    plain_times = route_times(lambda: models.stokes_step_local(s0, p, impl="plain"), reps=5)
    print(f"  plain route per iteration: {plain_times}", flush=True)
    err = max(float(np.abs(a.astype(np.float64) - b).max()) for a, b in zip(f20, p20))
    ok = all(np.allclose(a, b, rtol=1e-4, atol=1e-5 * max(1e-30, float(np.abs(b).max())))
             for a, b in zip(f20, p20))
    check(ok, f"config 5 mesh: 20 fused iterations match the plain route ({err:.3e})")
    check(not np.allclose(G[3], tg.gather_interior(s0[3])), "config 5 mesh: the flow evolved")
    tg.finalize_global_grid()
    return counts, dict(k4s_launches=k4s, seconds=t, cell_updates_per_s=rate,
                        global_cells=cells,
                        residuals=list(res), max_abs_err_vs_plain_20=err, k10_route=times,
                        plain_route=plain_times,
                        k10_solver_device_ms=solver_ms, k10_solver_kernels_device_ms=both,
                        state_magnitudes=mags, step_ms=t * 1e3 / nt, transport_ref=ref)


def _load_names():
    """`KERNEL_NAMES` and `EXCHANGE_KERNELS` from the package's profiling
    module (one tuple of kernel names a launch counter there; here their
    common prefix, which every profiler key of the counter's kernels
    holds)."""
    global KERNEL_NAMES, EXCHANGE_KERNELS
    from implicitglobalgrid_tpu_torch.utils import profiling

    KERNEL_NAMES = {k: os.path.commonprefix(list(v)) for k, v in profiling.KERNEL_NAMES.items()}
    EXCHANGE_KERNELS = tuple(profiling.EXCHANGE_KERNELS)


def _build_dir():
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "implicitglobalgrid_tpu_torch", "_build")


def _merged(spans):
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _covered(a, b, merged):
    """The length of [a, b) that the merged spans cover."""
    return sum(max(0.0, min(b, e) - max(a, s)) for s, e in merged)


def _capture(fn, reps, warm=True):
    """A `trace` (the package's, `utils.profiling`) of ``reps`` calls of
    ``fn`` (after a warm one), into a new directory under `_build_dir()`:
    (the directory, every device span read back through
    `utils.trace_events`, as (line, start ps, end ps, kind, category))."""
    import tempfile

    import torch

    import implicitglobalgrid_tpu_torch as tg
    from implicitglobalgrid_tpu_torch.utils.profiling import _op_kind
    from implicitglobalgrid_tpu_torch.utils.trace_events import find_trace_files, parse_trace

    if warm:
        fn()
    torch.cuda.synchronize()
    os.makedirs(_build_dir(), exist_ok=True)
    d = tempfile.mkdtemp(dir=_build_dir(), prefix="trace_")
    with tg.trace(d):
        for _ in range(reps):
            fn()
    spans = [(ln.name, ev.start_ps, ev.end_ps, _op_kind(ev.name), ev.cat)
             for path in find_trace_files(d) for pl in parse_trace(path)
             if pl.name.startswith("/device:") for ln in pl.lines for ev in ln.events]
    return d, spans


def _device_spans(fn, reps):
    """Every kernel, copy and set of ``reps`` calls of ``fn`` (`_capture`),
    the capture removed after: [(line, start ps, end ps, kind, category)]."""
    import shutil

    d, spans = _capture(fn, reps)
    shutil.rmtree(d, ignore_errors=True)
    return spans


def busy_ms(fn, reps=3):
    """The device's busy time a call of ``fn``: the union of its spans."""
    spans = _device_spans(fn, reps)
    return sum(b - a for a, b in _merged([(a, b) for _, a, b, _, _ in spans])) / reps / 1e9


def hidden_share(spans, reps):
    """Device activity by CUDA stream (phase 12's measure): the side stream
    is the one the exchange kernels (`EXCHANGE_KERNELS`) ran on;
    ``hidden_share`` is the part of its device time that lies under device
    work on the other streams (the interior); ``busy_ms`` the device's busy
    time a call (the union of every span), ``side_ms`` and ``other_ms``
    each side's time a call."""
    from implicitglobalgrid_tpu_torch.utils.profiling import EXCHANGE_KINDS

    side = {ln for ln, _, _, k, _ in spans if k in EXCHANGE_KINDS}
    check(len(side) == 1, f"the exchange kernels ran on one stream ({sorted(side)})")
    side = side.pop()
    mine = [(a, b) for ln, a, b, _, _ in spans if ln == side]
    others = _merged([(a, b) for ln, a, b, _, _ in spans if ln != side])
    check(bool(others), "the interior ran on another stream than the exchange")
    side_ps = sum(b - a for a, b in mine)
    hidden = sum(_covered(a, b, others) for a, b in mine)
    return dict(hidden_share=hidden / side_ps if side_ps else None,
                side_ms=side_ps / reps / 1e9,
                other_ms=sum(b - a for a, b in others) / reps / 1e9,
                busy_ms=sum(b - a for a, b in _merged([(a, b) for _, a, b, _, _ in spans]))
                / reps / 1e9)


def overlap_profile(fn, reps=3):
    """`hidden_share` of ``reps`` calls of ``fn`` (one overlapped step),
    beside the package's `overlap_stats` of the same capture
    (``overlap_stats``)."""
    import shutil

    import implicitglobalgrid_tpu_torch as tg

    d, spans = _capture(fn, reps)
    out = hidden_share(spans, reps)
    out["overlap_stats"] = tg.overlap_stats(d).get("GPU:0")
    shutil.rmtree(d, ignore_errors=True)
    return out


def _bitwise(a, b):
    import numpy as np

    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


def phase_overlap_deep(tg, models, cb):
    """Phase 12: interior-first overlap (``overlap=True``: the exchange of
    the shells on a side stream, the interior on the current one) and deep
    halos (``comm_every`` > 1) of the three models on the virtual mesh, the
    plain route, float32, each run held bitwise against the same grid's
    plain run at cadence 1. Prints host, wall and device ms a step of each
    overlapped route beside its plain route (`route_times`), the device's
    busy time and the exchange's hidden share (`overlap_profile`), and the
    exchange launches a physical step at each cadence. Returns (launches of
    the timed runs, record, the transport phase's references)."""
    import dataclasses

    import torch

    print(f"phase: overlap and deep halos on the virtual mesh, plain route, float32; card "
          f"{card_name()}", flush=True)
    counts, rec, refs = {}, {}, {}

    def launched(fn, nt):
        """``fn()`` between launch-count resets: (result, launches, exchange
        launches a physical step)."""
        cb.reset_launch_counts()
        res = fn()
        torch.cuda.synchronize()
        c = cb.launch_counts()
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
        return res, c, sum(c[k] for k in EXCHANGE_KERNELS) / nt

    def beside(plain_fn, overlap_fn):
        t = dict(plain=route_times(plain_fn, reps=4, batches=3),
                 overlap=route_times(overlap_fn, reps=4, batches=3))
        t["overlap_profile"] = overlap_profile(overlap_fn)
        t["plain_busy_ms"] = busy_ms(plain_fn)
        return t

    def interiors(state):
        return [tg.gather_interior(a) for a in state]

    def same(got, ref, label):
        ok = all(_bitwise(a, b) for a, b in zip(got, ref))
        err = max(float(abs(a.astype("float64") - b).max()) for a, b in zip(got, ref))
        check(ok, f"{label} bitwise equal to the plain route at cadence 1 (max abs err {err!r})")

    n, kw = N_MESH, dict(dimx=2, dimy=2, dimz=2, periodx=1)
    # diffusion, the README run's mesh: 20 steps interior-first
    grid(tg, n, n, n, **kw)
    T0, Cp, p = models.init_diffusion3d(dtype=torch.float32)
    po = dataclasses.replace(p, overlap=True)
    models.run_diffusion(T0, Cp, po, 1, impl="plain")  # warm
    ref = interiors([models.run_diffusion(T0, Cp, p, 20, nt_chunk=20, impl="plain")])
    T, c, per = launched(lambda: models.run_diffusion(T0, Cp, po, 20, nt_chunk=20,
                                                      impl="plain"), 20)
    same(interiors([T]), ref, "diffusion overlap, 20 steps:")
    check(c["exchange_slabs"] == 60 and c["halo_write_combined"] == 20 and per == 4,
          "diffusion overlap: the shells exchanged by K4s + K6 a step")
    r = rec["diffusion"] = beside(lambda: models.diffusion_step_local(T0, Cp, p, "plain"),
                                  lambda: models.diffusion_step_local(T0, Cp, po, "plain"))
    r["overlap_exchange_launches_per_step"] = per
    refs["diffusion_plain_T"] = refs["diffusion_overlap_T"] = tg.gather_interior(
        models.run_diffusion(T0, Cp, p, 10, nt_chunk=10, impl="plain"))
    # the same mesh with overlaps 4, halowidths 2: comm_every 2 and "z:2"
    grid(tg, n, n, n, overlaps=(4, 4, 4), halowidths=(2, 2, 2), **kw)
    T0, Cp, p = models.init_diffusion3d(dtype=torch.float32)
    T0, Cp = tg.update_halo(T0, Cp)  # halos set to what they mirror
    T, _, per1 = launched(lambda: models.run_diffusion(T0, Cp, p, 20, nt_chunk=20,
                                                       impl="plain"), 20)
    ref = interiors([T])
    r = rec["diffusion_deep"] = dict(exchange_launches_per_step={"1": per1})
    for ce, want in ((2, 3), ("z:2", 5)):
        q = dataclasses.replace(p, comm_every=ce)
        models.run_diffusion(T0, Cp, q, 2, impl="plain")  # warm
        T, c, per = launched(lambda: models.run_diffusion(T0, Cp, q, 20, nt_chunk=20), 20)
        same(interiors([T]), ref, f"diffusion comm_every={ce!r}, 20 steps:")
        check(per1 == 6 and per == want,
              f"diffusion comm_every={ce!r}: {per} exchange launches a step (cadence 1: {per1})")
        r["exchange_launches_per_step"][str(ce)] = per
    deep = dataclasses.replace(p, comm_every=2)
    run_deep = models.make_run_deep(deep, 1)
    r["routes"] = dict(plain=route_times(lambda: models.diffusion_step_local(T0, Cp, p, "plain"),
                                         reps=4, batches=3),
                       deep_super_step_of_2=route_times(lambda: run_deep(T0, Cp), reps=4,
                                                        batches=3))
    refs["diffusion_deep_T"] = tg.gather_interior(models.run_diffusion(T0, Cp, deep, 10,
                                                                       nt_chunk=10))

    # acoustic, config 4's mesh (all periodic): 10 steps interior-first
    n, kw = N_CFG4, dict(dimx=2, dimy=2, dimz=2, periodx=1, periody=1, periodz=1)
    grid(tg, n, n, n, **kw)
    s0, p = models.init_acoustic3d(dtype=torch.float32)
    po = dataclasses.replace(p, overlap=True)
    models.run_acoustic(s0, po, 1, impl="plain")  # warm
    ref = interiors(models.run_acoustic(s0, p, 10, nt_chunk=10, impl="plain"))
    s, c, per = launched(lambda: models.run_acoustic(s0, po, 10, nt_chunk=10, impl="plain"), 10)
    same(interiors(s), ref, "acoustic overlap, 10 steps:")
    check(c["wire_pack"] == 30 and c["halo_write_multi"] == 30 and c["exchange_slabs"] == 30
          and c["halo_write_combined"] == 10,
          "acoustic overlap: V's shells by K8 + K7 a dim, P's by K4s + K6")
    r = rec["acoustic"] = beside(lambda: models.acoustic_step_local(s0, p, "plain"),
                                 lambda: models.acoustic_step_local(s0, po, "plain"))
    r["overlap_exchange_launches_per_step"] = per
    del s
    grid(tg, n, n, n, overlaps=(4, 4, 4), halowidths=(2, 2, 2), **kw)
    s0, p = models.init_acoustic3d(dtype=torch.float32)
    s0 = tg.update_halo(*s0)
    s, _, per1 = launched(lambda: models.run_acoustic(s0, p, 10, nt_chunk=10, impl="plain"), 10)
    ref = interiors(s)
    deep = dataclasses.replace(p, comm_every=2)
    models.run_acoustic(s0, deep, 2)  # warm
    s, c, per = launched(lambda: models.run_acoustic(s0, deep, 10, nt_chunk=10), 10)
    same(interiors(s), ref, "acoustic comm_every=2, 10 steps:")
    check(per1 == 12 and per == 3 and c["wire_pack"] == 15,
          f"acoustic comm_every=2: one 4-field K8 + K7 round a dim every 2 steps ({per} "
          f"exchange launches a step; cadence 1: {per1})")
    run_deep = models.make_acoustic_run_deep(deep, 1)
    rec["acoustic_deep"] = dict(
        exchange_launches_per_step={"1": per1, "2": per},
        routes=dict(plain=route_times(lambda: models.acoustic_step_local(s0, p, "plain"),
                                      reps=4, batches=3),
                    deep_super_step_of_2=route_times(lambda: run_deep(*s0), reps=4,
                                                     batches=3)))
    del s, s0, ref

    # Stokes, config 5's mesh (non-periodic): 20 iterations interior-first
    n, kw = N_CFG5, dict(dimx=2, dimy=2, dimz=2)
    grid(tg, n, n, n, **kw)
    s0, p = models.init_stokes3d(dtype=torch.float32)
    po = dataclasses.replace(p, overlap=True)
    models.run_stokes(s0, po, 1, impl="plain")  # warm
    ref = interiors(models.run_stokes(s0, p, 20, nt_chunk=20, impl="plain")[:7])
    s, c, per = launched(lambda: models.run_stokes(s0, po, 20, nt_chunk=20, impl="plain"), 20)
    same(interiors(s[:7]), ref, "Stokes overlap, 20 iterations:")
    check(c["wire_pack"] == 60 and c["halo_write_multi"] == 60 and per == 6,
          "Stokes overlap: the shells of (Vx, Vy, Vz, P) by K8 + K7 a dim")
    r = rec["stokes"] = beside(lambda: models.stokes_step_local(s0, p, "plain"),
                               lambda: models.stokes_step_local(s0, po, "plain"))
    r["overlap_exchange_launches_per_step"] = per
    del s
    # overlaps 8, halowidths 4 (the iteration's radius is 2); dV skipped:
    # its halos are undefined state at cadence 1, which never exchanges it
    grid(tg, n, n, n, overlaps=(8, 8, 8), halowidths=(4, 4, 4), **kw)
    s0, p = models.init_stokes3d(dtype=torch.float32)
    s0 = tg.update_halo(*s0)
    s, _, per1 = launched(lambda: models.run_stokes(s0, p, 20, nt_chunk=20, impl="plain"), 20)
    ref = interiors(s[:4])
    deep = dataclasses.replace(p, comm_every=2)
    models.run_stokes(s0, deep, 2)  # warm
    s, c, per = launched(lambda: models.run_stokes(s0, deep, 20, nt_chunk=20), 20)
    same(interiors(s[:4]), ref, "Stokes comm_every=2, 20 iterations (P, V):")
    check(per1 == 6 and per == 3 and c["wire_pack"] == 30,
          f"Stokes comm_every=2: one 7-field K8 + K7 round a dim every 2 iterations ({per} "
          f"exchange launches an iteration; cadence 1: {per1})")
    run_deep = models.make_stokes_run_deep(deep, 1)
    rec["stokes_deep"] = dict(
        exchange_launches_per_step={"1": per1, "2": per},
        routes=dict(plain=route_times(lambda: models.stokes_step_local(s0, p, "plain"),
                                      reps=4, batches=3),
                    deep_super_step_of_2=route_times(lambda: run_deep(*s0), reps=4,
                                                     batches=3)))
    del s, s0, ref
    tg.finalize_global_grid()
    for name, r in rec.items():
        print(f"  {name}: {json.dumps(r)}", flush=True)
    return counts, rec, refs


def phase_profiling(tg, models, cb):
    """Phase 12b: the package's profiling (`trace`, `overlap_stats`,
    `op_breakdown`) on the virtual mesh's diffusion, 2x2x2 x 128^3,
    periodic in x: 10 steps of the kernel route (K4s + K4), then 4
    overlapped plain-route steps (the shells' exchange, K4s + K6, on the
    side stream). For each capture: a ``/device:GPU:0`` plane; each port
    kernel's count in `op_breakdown` equal to its launch counter over the
    capture; ``comm_us`` equal to the summed device time of the exchange's
    kernels (no copy crosses devices or the host on the virtual mesh); for
    the overlapped route, ``overlap_frac`` equal to phase 12's hidden share
    of the same file. Returns (launches, record)."""
    import dataclasses
    import shutil

    import torch

    from implicitglobalgrid_tpu_torch.utils import profiling

    print(f"phase: profiling (trace, overlap_stats, op_breakdown) on the virtual mesh; card "
          f"{card_name()}", flush=True)
    counts, rec = {}, {}
    grid(tg, N_MESH, N_MESH, N_MESH, dimx=2, dimy=2, dimz=2, periodx=1)
    T0, Cp, p = models.init_diffusion3d(dtype=torch.float32)
    po = dataclasses.replace(p, overlap=True)
    runs = (("kernel_route_10_steps",
             lambda: models.run_diffusion(T0, Cp, p, 10, nt_chunk=10, impl="cuda")),
            ("overlapped_plain_route_4_steps",
             lambda: models.run_diffusion(T0, Cp, po, 4, nt_chunk=4, impl="plain")))
    for name, fn in runs:
        fn()  # warm: the route's first call checks and plans it
        torch.cuda.synchronize()
        cb.reset_launch_counts()
        d, spans = _capture(fn, 1, warm=False)
        c = cb.launch_counts()
        stats = tg.overlap_stats(d)
        rows = tg.op_breakdown(d, top=1000)
        by_kind = {k: n for k, _, n in rows}
        got = {k: sum(by_kind.get(kn, 0) for kn in profiling.KERNEL_NAMES[k]) for k in c}
        if got != c:
            _trace_report(d, name)
        shutil.rmtree(d, ignore_errors=True)
        check("GPU:0" in stats, f"profiling {name}: the capture has a /device:GPU:0 plane")
        s = stats["GPU:0"]
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
        check(got == c and sum(c.values()) > 0,
              f"profiling {name}: op_breakdown's count of each port kernel equals its launch "
              f"counter ({ {k: v for k, v in c.items() if v} }; in the trace "
              f"{ {k: v for k, v in got.items() if v} })")
        exch = sum(b - a for _, a, b, k, _ in spans if k in profiling.EXCHANGE_KINDS)
        check(abs(s["comm_us"] - exch / 1e6) <= 1e-9 * max(1.0, exch / 1e6),
              f"profiling {name}: comm_us {s['comm_us']!r} equals the exchange kernels' summed "
              f"device time {exch / 1e6!r} us")
        r = rec[name] = dict(overlap_stats=s, op_breakdown=rows[:8], launches=c)
        if name.startswith("overlapped"):
            h = hidden_share(spans, 1)
            r["hidden_share"] = h
            check(s["overlap_frac"] is not None and h["hidden_share"] is not None
                  and abs(s["overlap_frac"] - h["hidden_share"]) <= 1e-12,
                  f"profiling {name}: overlap_frac {s['overlap_frac']!r} equals phase 12's "
                  f"hidden share {h['hidden_share']!r} of the same capture")
        print(f"  {name}: overlap_stats {json.dumps(s)}", flush=True)
        for k, us, n in rows[:8]:
            print(f"    {k}: {us:.1f} us, {n} spans", flush=True)
    tg.finalize_global_grid()
    return counts, rec


PROFILING_TIMEOUT = 300  # seconds, for the profiling phase's process


def profiling_child(out_path):
    """Phase 12b in a process of its own (``chip_smoke.py --profiling-child
    <out.json>``): writes its launches and record to ``out_path``. A
    capture in the main process after phase 12 lost the device records of
    the first 4-9 kernels it launched (every capture after it; a fresh
    process's captures lose none: PERF.md §7), so the phase that holds the
    counts of a capture against the launch counters runs in a fresh one."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import implicitglobalgrid_tpu_torch as tg
    from implicitglobalgrid_tpu_torch import models
    from implicitglobalgrid_tpu_torch.ops import cuda_build as cb

    _load_names()
    torch.cuda.set_device(0)
    try:
        counts, rec = phase_profiling(tg, models, cb)
    except SmokeFailure as e:
        print(f"profiling child: FAILED: {e}", flush=True)
        return 1
    with open(out_path, "w") as f:
        json.dump({"counts": counts, "record": rec}, f)
    return 0


def run_profiling_phase():
    """Phase 12b: `profiling_child` in a new process of this script; returns
    its (launches, record)."""
    out = os.path.join(_build_dir(), f"profiling_{os.getpid()}.json")
    env = {k: v for k, v in os.environ.items() if k != "IGG_USE_PALLAS"}
    try:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--profiling-child",
                               out], capture_output=True, text=True, env=env,
                              timeout=PROFILING_TIMEOUT)
        log, rc = proc.stdout + proc.stderr, proc.returncode
    except subprocess.TimeoutExpired:
        log, rc = f"timed out after {PROFILING_TIMEOUT} s", -1
    for line in log.splitlines():
        if not line.startswith(("  _warn_once", "/")):
            print(line, flush=True)
    check(rc == 0, f"profiling: the phase's process exited {rc}")
    with open(out) as f:
        got = json.load(f)
    os.remove(out)
    return got["counts"], got["record"]


def _trace_report(d, name):
    """Print what a capture holds of the port's kernel launches: by trace
    category, the runtime's launch calls, the kernels without their launch
    and the launches without their kernel."""
    import glob

    for path in glob.glob(os.path.join(d, "*.pt.trace.json")):
        with open(path) as f:
            evs = json.load(f).get("traceEvents", [])
        cats = {}
        for ev in evs:
            if "exchange_slabs" in str(ev.get("name", "")) or "step_exchange" in str(
                    ev.get("name", "")):
                cats[ev.get("cat")] = cats.get(ev.get("cat"), 0) + 1
        launch = {ev.get("args", {}).get("correlation") for ev in evs
                  if "LaunchKernel" in str(ev.get("name", ""))}
        kern = {ev.get("args", {}).get("correlation") for ev in evs if ev.get("cat") == "kernel"}
        print(f"  trace of {name}: the port's kernels by category {cats}, "
              f"{len(launch)} launch calls, {len(kern)} kernels, {len(kern - launch)} kernels "
              f"without a launch, {len(launch - kern)} launches without a kernel", flush=True)
ENSEMBLE_MEMBERS = (1, 4, 16)  # bench_ensemble.py's diffusion sweep on the chip
ENSEMBLE_STEPS = 20  # nt_chunk of bench_ensemble.py; diffusion's steps
ENSEMBLE_WIRE_STEPS = 5


def phase_ensemble(tg, models, cb):
    """Phase 12c: the ensemble axis on the virtual mesh, plain route,
    float32 (`ensemble_state`, ``run_*(..., ensemble=E)``). Diffusion on
    2x2x2 x 128^3, all periodic, 20 steps at E = 1, 4 and 16; acoustic on
    config 4's mesh (2x2x2 x 192^3) and Stokes on config 5's (2x2x2 x
    128^3) at E = 4. Each: member 0 bitwise the solo plain-route run,
    member 1 not (``perturb=0.01``), K8 and K7 launches a step the same at
    every E (every member in one launch a dim); the int8 wire's members
    bitwise their solo int8 runs. Prints wall ms a step a member at each E
    beside the solo step (`route_times`) and `overlap_stats` of the E = 16
    run. Returns (launches, record, the transport phase's references)."""
    import shutil

    import numpy as np
    import torch

    print(f"phase: ensemble axis on the virtual mesh, plain route, float32; card "
          f"{card_name()}", flush=True)
    counts, rec, refs = {}, {}, {}

    def launched(fn, nt):
        cb.reset_launch_counts()
        res = fn()
        torch.cuda.synchronize()
        c = cb.launch_counts()
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
        return res, (c["wire_pack"] / nt, c["halo_write_multi"] / nt)

    def members_hold(label, out, solo):
        """Member 0 bitwise the solo run, member 1 (if any) different."""
        first = all(torch.equal(a[0], b) for a, b in zip(out, solo))
        check(first, f"ensemble {label}: member 0 bitwise the solo plain-route run")
        if out[0].shape[0] > 1:
            check(any(not torch.equal(a[1], a[0]) for a in out),
                  f"ensemble {label}: member 1 differs from member 0 (perturb=0.01)")

    # K8 and K7 with a member axis against their plain versions, every dim:
    # config 4's group (P, Vx, Vy, Vz) at E = 4 on 2x2x2 x 64^3 blocks
    from implicitglobalgrid_tpu_torch.ops import cuda_halo as ch
    from implicitglobalgrid_tpu_torch.ops.wire import schema_for_fields

    n = N_CHECK
    g = torch.Generator(device="cuda").manual_seed(14)
    locs = [staggered_loc(n, f) for f in ("P", "Vx", "Vy", "Vz")]
    fs = [torch.rand((4,) + tuple(2 * m for m in loc), generator=g, device="cuda")
          for loc in locs]
    ok = True
    for dim in range(3):
        sch = schema_for_fields(dim, locs, [1] * 4, torch.float32, members=4)
        kw = dict(starts_r=[loc[dim] - 2 for loc in locs], starts_l=[1] * 4, blocks=locs)
        bufs = ch.wire_pack(fs, sch, **kw)
        ok &= all(torch.equal(a, b) for a, b in zip(bufs, ch.wire_pack_plain(fs, sch, **kw)))
        got, want = [f.clone() for f in fs], [f.clone() for f in fs]
        ch.halo_write_multi(got, *bufs, sch, blocks=locs, periodic=True, disp=1)
        ch.halo_write_multi_plain(want, *bufs, sch, blocks=locs, periodic=True, disp=1)
        ok &= all(torch.equal(a, b) for a, b in zip(got, want))
    torch.cuda.synchronize()
    check(ok, "K8 and K7 with 4 members of (P, Vx, Vy, Vz), 2x2x2 x 64^3, every dim: bitwise "
              "their plain versions")
    del fs, bufs, got, want

    # diffusion at bench_ensemble.py's chip size
    n = N_MESH
    grid(tg, n, n, n, dimx=2, dimy=2, dimz=2, periodx=1, periody=1, periodz=1)
    T0, Cp0, p = models.init_diffusion3d(dtype=torch.float32)
    nt = ENSEMBLE_STEPS
    solo = models.run_diffusion(T0, Cp0, p, nt, nt_chunk=nt, impl="plain")
    r = rec["diffusion_128_periodic"] = dict(
        solo=route_times(lambda: models.diffusion_step_local(T0, Cp0, p, "plain"), reps=4,
                         batches=3))
    per = {}
    for E in ENSEMBLE_MEMBERS:
        ET, EC = models.ensemble_state((T0, Cp0), E, perturb=0.01)
        models.run_diffusion(ET, EC, p, 1, ensemble=E)  # warm
        out, per[E] = launched(lambda: models.run_diffusion(ET, EC, p, nt, nt_chunk=nt,
                                                            ensemble=E), nt)
        members_hold(f"diffusion E={E}", (out,), (solo,))
        if E == 4:
            refs["ensemble_diffusion_e4"] = np.stack([tg.gather_interior(
                models.run_diffusion(ET, EC, p, 10, nt_chunk=10, ensemble=E)[m])
                for m in range(E)])
        t = route_times(lambda: models.diffusion_step_local(ET, EC, p, "plain", members=E),
                        reps=4, batches=3)
        t["wall_ms_per_step_per_member"] = t["wall_ms_per_step"] / E
        t["k8_k7_launches_per_step"] = per[E]
        r[f"E{E}"] = t
        print(f"  diffusion E={E}: {t['wall_ms_per_step']:.3f} ms a step, "
              f"{t['wall_ms_per_step_per_member']:.3f} a member (solo "
              f"{r['solo']['wall_ms_per_step']:.3f}), K8/K7 a step {per[E]}", flush=True)
        if E == max(ENSEMBLE_MEMBERS):
            d, _ = _capture(lambda: models.run_diffusion(ET, EC, p, 2, nt_chunk=2, ensemble=E), 1)
            r["overlap_stats_E16"] = tg.overlap_stats(d).get("GPU:0")
            r["op_breakdown_E16"] = tg.op_breakdown(d, top=8)
            shutil.rmtree(d, ignore_errors=True)
            print(f"  diffusion E={E} overlap_stats {json.dumps(r['overlap_stats_E16'])}",
                  flush=True)
        del ET, EC, out
        torch.cuda.empty_cache()
    check(len(set(per.values())) == 1 and per[1] == (3.0, 3.0),
          f"ensemble diffusion: one K8 and one K7 a dim a step at every E ({per})")
    # the int8 wire: each member bitwise its own solo int8 run
    with wire_env("int8"):
        E, nw = 4, ENSEMBLE_WIRE_STEPS
        ET, EC = models.ensemble_state((T0, Cp0), E, perturb=0.01)
        out = models.run_diffusion(ET, EC, p, nw, nt_chunk=nw, ensemble=E)
        same = all(torch.equal(out[m], models.run_diffusion(
            ET[m].contiguous(), EC[m].contiguous(), p, nw, nt_chunk=nw, impl="plain"))
            for m in range(E))
        check(same, f"ensemble diffusion int8 wire, E={E}: each member bitwise its solo int8 "
                    "run (its slabs quantized against its own scales)")
        del ET, EC, out
    del T0, Cp0, solo
    tg.finalize_global_grid()

    # acoustic on config 4's mesh and Stokes on config 5's, E = 4
    for label, n, kw, init, run, step, nt in (
            ("acoustic_config4_mesh", N_CFG4, dict(periodx=1, periody=1, periodz=1),
             models.init_acoustic3d, models.run_acoustic, models.acoustic_step_local, 5),
            ("stokes_config5_mesh", N_CFG5, {}, models.init_stokes3d, models.run_stokes,
             models.stokes_step_local, 10)):
        grid(tg, n, n, n, dimx=2, dimy=2, dimz=2, **kw)
        s0, p = init(dtype=torch.float32)
        solo = run(s0, p, nt, nt_chunk=nt, impl="plain")
        r = rec[label] = dict(solo=route_times(lambda: step(s0, p, "plain"), reps=3, batches=3))
        per = {}
        for E in (1, 4):
            es = models.ensemble_state(tuple(s0), E, perturb=0.01)
            run(es, p, 1, ensemble=E)  # warm
            out, per[E] = launched(lambda: run(es, p, nt, nt_chunk=nt, ensemble=E), nt)
            members_hold(f"{label} E={E}", out, solo)
            if E == 4:
                t = route_times(lambda: step(es, p, "plain", members=E), reps=3, batches=3)
                t["wall_ms_per_step_per_member"] = t["wall_ms_per_step"] / E
                r["E4"] = t
                print(f"  {label} E=4: {t['wall_ms_per_step']:.3f} ms a step, "
                      f"{t['wall_ms_per_step_per_member']:.3f} a member (solo "
                      f"{r['solo']['wall_ms_per_step']:.3f})", flush=True)
            del es, out
        r["k8_k7_launches_per_step"] = per
        check(per[1] == per[4] and per[1][0] > 0,
              f"ensemble {label}: K8 and K7 launches a step the same at E = 1 and 4 ({per})")
        with wire_env("int8"):
            es = models.ensemble_state(tuple(s0), 2, perturb=0.01)
            out = run(es, p, 2, nt_chunk=2, ensemble=2)
            same = all(all(torch.equal(a[m], b) for a, b in zip(out, run(
                tuple(x[m].contiguous() for x in es), p, 2, nt_chunk=2, impl="plain")))
                for m in range(2))
            check(same, f"ensemble {label} int8 wire: each member bitwise its solo int8 run")
            del es, out
        del s0, solo
        tg.finalize_global_grid()
        torch.cuda.empty_cache()
    return counts, rec, refs


def phase_example(tg):
    """Phase 12d: the advanced-modes example
    (`implicitglobalgrid_tpu_torch.examples.diffusion3D_advanced_modes`) at
    its card sizes (one 192^3 block, 400 steps): stochastic-rounding
    bfloat16 nearer float32 than plain bfloat16, the deep-halo run, the
    measured overlap. Returns its record."""
    from implicitglobalgrid_tpu_torch.examples import diffusion3D_advanced_modes as ex

    print(f"phase: the advanced-modes example, card sizes; card {card_name()}", flush=True)
    got = ex.main(cpu=False)
    sr = got["sr"]
    check(sr["bf16_sr"] < sr["bf16"],
          f"advanced modes: sr bfloat16 nearer float32 (max-rel {sr['bf16_sr']!r}) than plain "
          f"bfloat16 ({sr['bf16']!r})")
    check("GPU:0" in got["overlap"], "advanced modes: the overlap was measured on the card")
    return dict(sr_max_rel=sr, deep_seconds=got["deep_s"], overlap=got["overlap"])


TRANSPORT_PROCS = 2
TRANSPORT_TIMEOUT = 600  # seconds, for the two processes together


WIRE_FORMATS = ("bfloat16", "float16", "int8", "int4", "z:int8,x:float32")
FUSED_WIRES = ("int8", "bfloat16")  # the fused routes' and the transport's formats
WIRE_STEPS = {"config3": 20, "config4": 10, "config5": 20}
TRANSPORT_RESIZE = (4, 1, 2)  # the transport's resize of the 128^3 mesh (z still split)
TRANSPORT_WIRE_STEPS = 5  # config 3's fused steps across the processes, each format
DRIFT_N, DRIFT_STEPS = 48, 400  # bench_f64_accuracy.py's configuration
INT8_WIRE_MAX_REL = 0.02  # the JAX package's documented drift bound of the int8 wire
SR_MAX_REL = 0.05  # tests/test_precision.py's bound on the stochastic-rounding run
SR_SEED_STEPS = 50
# Where a model's fused and plain routes quantize different slabs under int8
# (config 4's acoustic leapfrog, as the JAX package's own two tiers do), the
# two routes' runs are held to one int8 level of the largest field a step,
# nt * max|field| / 127: each exchange leaves a halo cell within half a
# level of its source in either route, so the routes part by at most one
# level a step before the stable update spreads it (PERF.md §6).
INT8_LEVELS_A_STEP = 1.0


class wire_env:
    """``IGG_HALO_WIRE_DTYPE`` set to ``fmt`` (None: unset) while inside."""

    def __init__(self, fmt):
        self.fmt = fmt

    def __enter__(self):
        self.saved = os.environ.pop("IGG_HALO_WIRE_DTYPE", None)
        if self.fmt is not None:
            os.environ["IGG_HALO_WIRE_DTYPE"] = self.fmt

    def __exit__(self, *exc):
        os.environ.pop("IGG_HALO_WIRE_DTYPE", None)
        if self.saved is not None:
            os.environ["IGG_HALO_WIRE_DTYPE"] = self.saved


class plain_versions:
    """The kernels' plain versions on the card: the wrappers of ``mods``
    take every tensor for a CPU tensor while inside."""

    def __init__(self, *mods):
        self.mods = mods

    def __enter__(self):
        self.saved = [m._on_card for m in self.mods]
        for m in self.mods:
            m._on_card = lambda t: False

    def __exit__(self, *exc):
        for m, f in zip(self.mods, self.saved):
            m._on_card = f


def _bits_equal(a, b):
    """Bitwise equality of two tensors (NaN payloads included)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    iv = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return torch.equal(a.contiguous().view(iv), b.contiguous().view(iv))


def _rel(a, b):
    """max |a - b| / max |b| of two host arrays."""
    import numpy as np

    return float(np.abs(a.astype(np.float64) - b).max() / np.abs(b).max())


def wire_update_halo(tg, cb, n):
    """Part 1 of the wire phase: `update_halo` on the 2x2x2 virtual mesh of
    ``n``^3 blocks, periodic and mixed, under every format of
    `WIRE_FORMATS`: config 4's staggered (P, Vx, Vy, Vz) group (K8 + K7) and
    one field (K4s + K2 under a cast, K8 + K7 quantized), each bitwise
    against the kernels' plain versions on the card (``IGG_USE_PALLAS=0``);
    a NaN in one send slab arrives as a wholly NaN slab under int8 and int4;
    ms of each call beside the exact wire's, and the share of the device's
    busy time outside the port's kernels (the codec: casts, reductions,
    copies)."""
    import torch

    out, launches, checks = {}, {}, []
    for label, periods in (("periodic", (1, 1, 1)), ("mixed", (1, 0, 1))):
        kw = dict(dimx=2, dimy=2, dimz=2, periodx=periods[0], periody=periods[1],
                  periodz=periods[2])
        g = torch.Generator(device="cuda").manual_seed(41)
        group = [rand_field(tuple(2 * s for s in staggered_loc(n, f)), torch.float32, g)
                 for f in ("P", "Vx", "Vy", "Vz")]
        one = rand_field((2 * n,) * 3, torch.float32, g)
        nan = one.clone()
        nan[n - 2, 5, 7] = float("nan")  # block (0,0,0)'s right send slab along x
        got = {}
        rec = out[label] = {}
        for plain in (False, True):
            grid(tg, n, n, n, plain=plain, **kw)
            for fmt in ("off",) + WIRE_FORMATS:
                cb.reset_launch_counts()
                U = tg.update_halo(*[a.clone() for a in group], wire_dtype=fmt)
                S = tg.update_halo(one.clone(), wire_dtype=fmt)
                torch.cuda.synchronize()
                c = cb.launch_counts()
                got[plain, fmt] = (U, S)
                if plain:
                    continue
                for k, v in c.items():
                    launches[k] = launches.get(k, 0) + v
                r = rec[fmt] = dict(launches={k: v for k, v in c.items() if v})
                ug = [a.clone() for a in group]
                us = one.clone()
                r["group_ms"] = median_ms(lambda: tg.update_halo(*ug, wire_dtype=fmt))
                r["one_ms"] = median_ms(lambda: tg.update_halo(us, wire_dtype=fmt))
                t = route_times(lambda: tg.update_halo(*ug, wire_dtype=fmt), reps=5)
                busy = busy_ms(lambda: tg.update_halo(*ug, wire_dtype=fmt))
                r["group_device_ms"] = t["device_ms_per_step"]
                r["group_busy_ms"] = busy
                r["group_codec_share"] = (None if not busy or t["device_ms_per_step"] is None
                                          else 1 - t["device_ms_per_step"] / busy)
                if fmt in ("int8", "int4"):
                    A = tg.update_halo(nan.clone(), dims=(0,), wire_dtype=fmt)
                    poisoned = bool(torch.isnan(A[n, :n, :n]).all())
                    rest = torch.isfinite(A)
                    rest[n, :n, :n] = True
                    rest[n - 2, 5, 7] = True
                    checks.append((poisoned and bool(rest.all()),
                                   f"wire {label} {fmt}: a NaN in one send slab arrives as "
                                   "a wholly NaN slab, every other halo finite"))
        for fmt in WIRE_FORMATS:
            U, E = got[False, fmt][0], got[False, "off"][0]
            checks.append((any(not _bits_equal(a, b) for a, b in zip(U, E)),
                           f"wire {label} {fmt}: the group's halos differ from the exact "
                           "wire's"))
        for fmt in ("off",) + WIRE_FORMATS:
            (Uk, Sk), (Up, Sp) = got[False, fmt], got[True, fmt]
            same = all(_bits_equal(a, b) for a, b in zip(Uk + (Sk,), Up + (Sp,)))
            checks.append((same, f"wire {label} {fmt}: update_halo of the group and of one "
                                 "field bitwise the kernels' plain versions'"))
        del got
        routes = {f: rec[f]["launches"] for f in ("off",) + WIRE_FORMATS}
        checks.append((routes["int8"].get("wire_pack") == 6
                       and routes["int8"].get("halo_write_multi") == 6
                       and "halo_write" not in routes["int8"],
                       f"wire {label} int8: the group and the lone field on K8 + K7, a dim"))
        checks.append((routes["bfloat16"].get("wire_pack") == 3
                       and routes["bfloat16"].get("halo_write") == 3
                       and routes["bfloat16"].get("exchange_slabs") == 3
                       and "halo_write_combined" not in routes["bfloat16"],
                       f"wire {label} bfloat16: the group on K8 + K7, the lone field on "
                       "K4s + K2 (no K6 under a wire)"))
        print(f"  wire update_halo {label}: " + json.dumps(rec), flush=True)
    tg.finalize_global_grid()
    os.environ.pop("IGG_USE_PALLAS", None)
    return launches, out, checks


def _wire_model_runs(tg, cb, name, n, kw, init, run, mods, tol, bitwise, step_fn,
                     route_levels=()):
    """Part 2 of the wire phase for one model: its fused route on the 2x2x2
    mesh under each of `FUSED_WIRES` (``IGG_HALO_WIRE_DTYPE``), against the
    kernels' plain versions on the card under the same wire (bitwise where
    the kernels are, else ``tol``) and against the plain route under the
    same wire (``tol``); the distance from the exact wire's run; ms a step
    beside the exact wire's. Under the quantized formats of
    ``route_levels`` the two routes quantize different slabs, as the JAX
    package's own two tiers do: there the fused run is held to the plain
    route's within `INT8_LEVELS_A_STEP` levels a step, and the plain
    route's run differs from its exact-wire run by no more than that.
    Returns (launches, record, checks, the exact run's state, the initial
    state)."""
    import torch

    nt = WIRE_STEPS[name]
    grid(tg, n, n, n, **kw)
    s0, p = init()
    s_exact = run(s0, p, nt)
    rec, checks, launches, fused = {}, [], {}, {}
    with wire_env("off"):
        rec["exact_step"] = route_times(step_fn(s0, p), reps=5)
    for fmt in FUSED_WIRES:
        with wire_env(fmt):
            cb.reset_launch_counts()
            s = run(s0, p, nt)
            torch.cuda.synchronize()
            c = cb.launch_counts()
            for k, v in c.items():
                launches[k] = launches.get(k, 0) + v
            with plain_versions(*mods):
                sp = run(s0, p, nt)
            fused[fmt] = s
            r = rec[fmt] = dict(launches={k: v for k, v in c.items() if v})
            r["step"] = route_times(step_fn(s0, p), reps=5)
            if bitwise:
                ok = all(_bits_equal(a, b) for a, b in zip(s, sp))
            else:
                ok = all(close(a, b, **tol) for a, b in zip(s, sp))
            r["max_abs_err_vs_plain_versions"] = max(max_err(a, b) for a, b in zip(s, sp))
            r["max_abs_dist_from_exact_wire"] = max(max_err(a, b) for a, b in zip(s, s_exact))
            checks.append((ok, f"wire {name} {fmt}: {nt} fused steps "
                               f"{'bitwise' if bitwise else 'within tolerance of'} the "
                               "kernels' plain versions on the card"))
            checks.append((r["max_abs_dist_from_exact_wire"] > 0,
                           f"wire {name} {fmt}: the run differs from the exact wire's "
                           f"({r['max_abs_dist_from_exact_wire']!r})"))
            del sp
    grid(tg, n, n, n, plain=True, **kw)
    if route_levels:
        with wire_env("off"):
            sp_exact = run(s0, p, nt)
        level = max(float(a.abs().max()) for a in tuple(s0) + tuple(s_exact)) / 127
        rec["int8_level"] = level
    for fmt in FUSED_WIRES:
        with wire_env(fmt):
            sp = run(s0, p, nt)
        err = max(max_err(a, b) for a, b in zip(fused[fmt], sp))
        rec[fmt]["max_abs_err_vs_plain_route"] = err
        if fmt in route_levels:
            budget = INT8_LEVELS_A_STEP * nt * level
            own = max(max_err(a, b) for a, b in zip(sp, sp_exact))
            rec[fmt]["plain_route_dist_from_exact_wire"] = own
            rec[fmt]["levels_a_step_vs_plain_route"] = err / (nt * level)
            checks.append((err <= budget,
                           f"wire {name} {fmt}: {nt} fused steps {err!r} from the plain route "
                           f"under the same wire, within {INT8_LEVELS_A_STEP} int8 level a "
                           f"step ({budget!r})"))
            checks.append((0 < own <= budget,
                           f"wire {name} {fmt}: the plain route's run {own!r} from its exact "
                           f"wire's, non-zero and within the same budget"))
        else:
            checks.append((all(close(a, b, **tol) for a, b in zip(fused[fmt], sp)),
                           f"wire {name} {fmt}: {nt} fused steps match the plain route under "
                           f"the same wire ({err!r})"))
        del sp
    grid(tg, n, n, n, **kw)
    print(f"  wire {name}: " + json.dumps(rec), flush=True)
    return launches, rec, checks, s_exact, (s0, p)


def wire_fused_routes(tg, models, cb):
    """Part 2 of the wire phase: config 3's diffusion mesh (float64), config
    4's acoustic mesh and config 5's Stokes mesh under int8 and bfloat16
    (`_wire_model_runs`); the transport phase's references (config 3's
    fused steps under each format, config 4's coalesced update_halo under
    each format after 10 exact steps)."""
    import torch

    from implicitglobalgrid_tpu_torch.ops import cuda_halo, cuda_stencil, cuda_stokes, cuda_wave

    launches, rec, checks, refs = {}, {}, [], {}

    def add(c):
        for k, v in c.items():
            launches[k] = launches.get(k, 0) + v

    per = dict(dimx=2, dimy=2, dimz=2, periodx=1, periody=1, periodz=1)

    def diff_init():
        T, Cp, p = models.init_diffusion3d(dtype=torch.float64)
        return (T, Cp), p

    def diff_run(s, p, nt):
        return (models.run_diffusion(s[0], s[1], p, nt, nt_chunk=nt),)

    def diff_step(s, p):
        step = models.make_step(p)
        return lambda: step(*s)

    c, rec["config3"], ch_, _, (s0, p) = _wire_model_runs(
        tg, cb, "config3", N_CFG3, per, diff_init, diff_run, (cuda_stencil, cuda_halo),
        F64_RUN_TOL, False, diff_step)
    add(c)
    checks += ch_
    for fmt in FUSED_WIRES:
        with wire_env(fmt):
            refs[f"wire_config3_{fmt}_T"] = tg.gather(models.run_diffusion(
                s0[0], s0[1], p, TRANSPORT_WIRE_STEPS, nt_chunk=TRANSPORT_WIRE_STEPS))
    del s0
    tg.finalize_global_grid()

    def ac_init():
        return models.init_acoustic3d(dtype=torch.float32)

    def ac_run(s, p, nt):
        return models.run_acoustic(s, p, nt, nt_chunk=nt)

    def ac_step(s, p):
        return _acoustic_step(tg, cuda_wave, s, p)

    # under int8 the acoustic fused and plain routes quantize different slabs,
    # as the JAX package's pallas and xla tiers do (`tests/test_torch_wire_models.py::
    # test_acoustic_int8_tiers_differ_as_jax_tiers`; each port route is held to its
    # JAX tier there): held to a budget of int8 levels here
    c, rec["config4"], ch_, s10, _ = _wire_model_runs(
        tg, cb, "config4", N_CFG4, per, ac_init, ac_run, (cuda_wave,), RUN_TOL, True, ac_step,
        route_levels=("int8",))
    add(c)
    checks += ch_
    for fmt in FUSED_WIRES:
        U = tg.update_halo(*[a.clone() for a in s10], wire_dtype=fmt)
        for f, a in zip(("P", "Vx", "Vy", "Vz"), U):
            refs[f"wire_config4_{fmt}_{f}"] = tg.gather(a)
        del U
    del s10
    tg.finalize_global_grid()

    def st_init():
        return models.init_stokes3d(dtype=torch.float32)

    def st_run(s, p, nt):
        return models.run_stokes(s, p, nt, nt_chunk=nt)

    def st_step(s, p):
        return _stokes_iteration(tg, cuda_stokes, s, p)

    stokes_tol = dict(rtol=1e-4, atol=1e-5)  # config 5 mesh's bound against the plain route
    c, rec["config5"], ch_, _, _ = _wire_model_runs(
        tg, cb, "config5", N_CFG5, dict(dimx=2, dimy=2, dimz=2), st_init, st_run,
        (cuda_stokes,), stokes_tol, True, st_step)
    add(c)
    checks += ch_
    tg.finalize_global_grid()
    return launches, rec, checks, refs


def wire_accuracy(tg, models, cb):
    """Parts 3 and 4 of the wire phase at bench_f64_accuracy.py's
    configuration (2x2x2 blocks of 48^3, periodic, 400 steps): the int8
    wire's drift from the exact wire (float32, the kernel route) under the
    documented 0.02; stochastic-rounding bfloat16 storage (sr=True) against
    the float32 run, within 0.05 and a fifth of plain bfloat16's error; one
    seed bitwise reproducible, another different; then the sr step's ms
    beside the plain bfloat16 step's on the 2x2x2 mesh of 128^3 blocks."""
    import numpy as np
    import torch

    rec, checks, launches = {}, [], {}
    n = DRIFT_N
    grid(tg, n, n, n, dimx=2, dimy=2, dimz=2, periodx=1, periody=1, periodz=1)
    cb.reset_launch_counts()
    T, Cp, p = models.init_diffusion3d(dtype=torch.float32)
    with wire_env("off"):
        exact = tg.gather_interior(models.run_diffusion(T, Cp, p, DRIFT_STEPS, nt_chunk=100))
    with wire_env("int8"):
        q8 = tg.gather_interior(models.run_diffusion(T, Cp, p, DRIFT_STEPS, nt_chunk=100))
    with wire_env("z:int8"):
        z8 = tg.gather_interior(models.run_diffusion(T, Cp, p, DRIFT_STEPS, nt_chunk=100))
    rec["int8_drift"], rec["z_int8_drift"] = _rel(q8, exact), _rel(z8, exact)
    checks.append((0 < rec["int8_drift"] < INT8_WIRE_MAX_REL,
                   f"wire drift: int8 {rec['int8_drift']!r} from the exact wire after "
                   f"{DRIFT_STEPS} steps, within {INT8_WIRE_MAX_REL}"))
    checks.append((0 < rec["z_int8_drift"] <= rec["int8_drift"] * 1.05,
                   f"wire drift: z:int8 {rec['z_int8_drift']!r} within the all-axes drift"))
    Tb, Cb, pb = models.init_diffusion3d(dtype=torch.bfloat16)
    plain = tg.gather_interior(models.run_diffusion(Tb, Cb, pb, DRIFT_STEPS, nt_chunk=100))
    Ts, Cs, ps = models.init_diffusion3d(dtype=torch.bfloat16, sr=True, sr_seed=0)
    t0 = time.perf_counter()
    srd = tg.gather_interior(models.run_diffusion(Ts, Cs, ps, DRIFT_STEPS, nt_chunk=100))
    rec["sr_run_s"] = time.perf_counter() - t0
    rec["err_plain_bf16"] = _rel(plain.astype(np.float64), exact)
    rec["err_sr"] = _rel(srd.astype(np.float64), exact)
    checks.append((rec["err_sr"] < SR_MAX_REL and rec["err_sr"] < rec["err_plain_bf16"] / 5,
                   f"sr: stochastic rounding {rec['err_sr']!r} from float32, plain bfloat16 "
                   f"{rec['err_plain_bf16']!r}"))
    runs = []
    for seed in (7, 7, 8):
        Ts, Cs, ps = models.init_diffusion3d(dtype=torch.bfloat16, sr=True, sr_seed=seed)
        runs.append(models.run_diffusion(Ts, Cs, ps, SR_SEED_STEPS, nt_chunk=SR_SEED_STEPS))
    checks.append((_bits_equal(runs[0], runs[1]) and not _bits_equal(runs[0], runs[2]),
                   f"sr: one seed bitwise reproducible over {SR_SEED_STEPS} steps, another "
                   "seed different"))
    del runs
    torch.cuda.synchronize()
    launches = cb.launch_counts()
    n = N_MESH
    grid(tg, n, n, n, dimx=2, dimy=2, dimz=2, periodx=1, periody=1, periodz=1)
    Tb, Cb, pb = models.init_diffusion3d(dtype=torch.bfloat16)
    ps = models.init_diffusion3d(dtype=torch.bfloat16, sr=True)[2]
    step = models.make_step(pb)
    rec["mesh_128_plain_bf16_step"] = route_times(lambda: step(Tb, Cb), reps=5)
    rec["mesh_128_sr_step"] = route_times(
        lambda: models.diffusion_step_local(Tb, Cb, ps, sr_step=3), reps=5)
    tg.finalize_global_grid()
    print(f"  wire accuracy and sr: " + json.dumps(rec), flush=True)
    return launches, rec, checks


def phase_wire(tg, models, cb):
    """Phase 13: the halo wire formats and stochastic-rounding storage
    (`wire_update_halo`, `wire_fused_routes`, `wire_accuracy`). Every check
    is recorded and printed, then all are held; returns (launches of the
    phase's runs, record, the transport phase's references)."""
    print(f"phase: halo wire formats {WIRE_FORMATS} and stochastic rounding; card "
          f"{card_name()}", flush=True)
    l1, uh, c1 = wire_update_halo(tg, cb, N_MESH)
    l2, fused, c2, refs = wire_fused_routes(tg, models, cb)
    l3, acc, c3 = wire_accuracy(tg, models, cb)
    for ok, msg in c1 + c2 + c3:
        check(ok, msg)
    launches = {k: l1.get(k, 0) + l2.get(k, 0) + l3.get(k, 0) for k in KERNEL_NAMES}
    return launches, dict(update_halo=uh, fused=fused, accuracy=acc), refs


IO_CHUNK, IO_STEPS = 200, 400  # phase 13b's main path: 400 K1 steps, a snapshot a chunk
IO_GUARD_CHUNK = 10  # the guard's and reducers' chunk on the 128^3 mesh
# the float32 sums of the guard and Stats on the card against plain PyTorch's
# sums of the same cells in another order: relative, at 2x2x2 x 128^3
IO_SUM_RTOL = 1e-5


def io_reducers(tg, n=N_MESH):
    """Phase 13b's and the transport phase's reducers on the 2x2x2 mesh of
    ``n``^3 blocks, periodic x (implicit global 2(n-2) x (2n-2) x (2n-2)):
    a probe on the x block boundary, a z line, and T's stats."""
    return [tg.Probe("T", (n - 2, n - 1, 3 * (2 * n - 2) // 4)),
            tg.AxisSlice("T", 2, (n + 2, (2 * n - 2) // 3, 0)), tg.Stats("T")]


def io_plain_parts(tg, T, Cp, reducers):
    """The guard's and the reducers' numbers by plain PyTorch on the card,
    from the implicit global grid of the virtual mesh's ``T`` assembled by
    index (`io.layout.owner_maps`, the `gather_interior` ownership): the
    non-finite counts and sums of squares of ``T`` and ``Cp``, then each
    probe's value, line, and the stats' sum, sum of squares, min and max."""
    import numpy as np
    import torch
    from implicitglobalgrid_tpu_torch.io.layout import field_geometry, owner_maps

    gg = tg.global_grid()
    loc = [int(s) // int(b) for s, b in zip(T.shape, gg.box)]
    idx = []
    for g in field_geometry(gg.dims, gg.nxyz, gg.overlaps, gg.periods, loc):
        c, i = owner_maps(g, np.arange(g.size))
        idx.append(torch.as_tensor(c * g.n + i, device=T.device))
    GI = T[idx[0][:, None, None], idx[1][None, :, None], idx[2][None, None, :]].float()
    out = {"health": [v for A in (T, Cp) for v in
                      (float((~torch.isfinite(A)).sum()), float((A.float() ** 2).sum()))]}
    for red in reducers:
        if isinstance(red, tg.Probe):
            out[red.label] = float(GI[red.index])
        elif isinstance(red, tg.AxisSlice):
            sel = tuple(slice(None) if d == red.axis else i for d, i in enumerate(red.index))
            out[red.label] = GI[sel].cpu().numpy()
        else:
            out[red.label] = dict(sum=float(GI.sum()), ssq=float((GI * GI).sum()),
                                  min=float(GI.min()), max=float(GI.max()))
    return out


def io_vector_matches(vec, plain, plan, names):
    """Where the guard-and-reducer vector ``vec`` differs from
    `io_plain_parts` (``[]``: it matches): counts, probes, slices, min and
    max bitwise, sums within IO_SUM_RTOL; with the sums' relative errors."""
    import numpy as np

    v = np.asarray(vec, dtype=np.float32)
    bad, rel = [], {}
    nh = 2 * len(names)

    def near(name, got, want):
        rel[name] = abs(got - want) / max(abs(want), 1e-30)
        if rel[name] > IO_SUM_RTOL:
            bad.append(name)

    for i, want in enumerate(plain["health"]):
        if i % 2 == 0:
            if v[i] != np.float32(want):
                bad.append(f"nonfinite:{names[i // 2]}")
        else:
            near(f"norm2:{names[i // 2]}", float(v[i]), want)
    P = plan.nprocs
    for red, off, ln, _ in plan._entries:
        seg, want = v[nh + off:nh + off + ln], plain[red.label]
        if red.label.startswith("probe"):
            if seg[0] != np.float32(want):
                bad.append(red.label)
        elif red.label.startswith("slice"):
            if not np.array_equal(seg, want):
                bad.append(red.label)
        else:
            near(f"{red.label}:sum", float(seg[0]), want["sum"])
            near(f"{red.label}:ssq", float(seg[1]), want["ssq"])
            if seg[2:2 + P].min() != np.float32(want["min"]) \
                    or seg[2 + P:].max() != np.float32(want["max"]):
                bad.append(f"{red.label}:min/max")
    return bad, rel


def phase_io(tg, models, cb):
    """Phase 13b: checkpoint and io. The main path's 400 K1 steps in chunks
    of 200 with a `SnapshotWriter` taking T and Cp every chunk (the last
    snapshot read back bitwise `gather_interior(T)`; submit ms, chunk wall
    with and without snapshots, the writer's bytes/s); config 4's mesh
    saved sharded after 10 fused steps, restored, 10 more steps bitwise the
    uninterrupted 20 (save and restore ms and GB/s, the sha256 share); the
    128^3 diffusion mesh saved on 2x2x2 and restored by `elastic_restart`
    onto 4x2x1, bitwise; the guard and the reducers on the mesh's kernel
    route against plain PyTorch on the card, a `poke_nan` tripping the
    guard, the hook's ms. Files go to a temporary directory, removed at
    the end. Returns (launches, record)."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from implicitglobalgrid_tpu_torch.io.reducers import make_reduced_post_chunk
    from implicitglobalgrid_tpu_torch.models.common import make_state_runner
    from implicitglobalgrid_tpu_torch.runtime.health import health_stats_local, report_from_stats
    from implicitglobalgrid_tpu_torch.utils.blockio import file_sha256

    print(f"phase: checkpoint and io; card {card_name()}", flush=True)
    tmp = tempfile.mkdtemp(prefix="igg_io_")
    counts, rec = {}, {}

    def add(c):
        for k, n in c.items():
            counts[k] = counts.get(k, 0) + n

    try:
        # the main path: K1 on 256^3, periodic, a snapshot every chunk
        grid(tg, N_MAIN, N_MAIN, N_MAIN, periodx=1, periody=1, periodz=1)
        T0, Cp, p = models.init_diffusion3d(dtype=torch.float32)
        run = models.make_run(p, IO_CHUNK)
        s = run(T0, Cp)  # warm chunk
        plain_wall = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s = run(*s, donate=True)
            torch.cuda.synchronize()
            plain_wall.append((time.perf_counter() - t0) * 1e3)
        cb.reset_launch_counts()
        root = os.path.join(tmp, "snaps")
        submit_ms, snap_wall = [], []
        with tg.SnapshotWriter(root) as w:
            s = (T0, Cp)
            for k in range(IO_STEPS // IO_CHUNK):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                s = run(*s, donate=k > 0)  # the runner reuses the submitted T next chunk
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                w.submit({"T": s[0], "Cp": s[1]}, (k + 1) * IO_CHUNK)
                t2 = time.perf_counter()
                submit_ms.append((t2 - t1) * 1e3)
                snap_wall.append((t2 - t0) * 1e3)
                if k == 0:
                    G_first = tg.gather_interior(s[0])
            flushed = w.flush(timeout=300.0)
        st = w.stats
        c = cb.launch_counts()
        add(c)
        check(flushed and st["written"] == IO_STEPS // IO_CHUNK and st["errors"] == 0,
              f"io main path: {st['written']} snapshots committed, no error")
        check(c["diffusion3d_step_halo"] == IO_STEPS, "io main path: K1 launched once a step")
        snaps = tg.list_snapshots(root)
        G = tg.gather_interior(s[0])
        R = tg.open_snapshot(snaps[-1][1]).read_global("T")
        check(snaps[-1][0] == IO_STEPS and R.dtype == G.dtype and np.array_equal(R, G),
              "io main path: the last snapshot's read_global(T) bitwise gather_interior(T)")
        check(np.array_equal(tg.open_snapshot(snaps[0][1]).read_global("T"), G_first),
              "io main path: the first snapshot holds its chunk's T, though the next chunk "
              "wrote the submitted tensor (the capture is a copy)")
        rec["main_path_snapshots"] = dict(
            chunk_steps=IO_CHUNK, submit_ms=submit_ms, chunk_wall_ms_with_snapshot=snap_wall,
            chunk_wall_ms_without=plain_wall, snapshot_bytes=st["bytes"] // len(submit_ms),
            writer_s=st["write_s"], writer_bytes_per_s=st["bytes"] / st["write_s"],
            submit_share_of_chunk=[m / statistics.median(plain_wall) for m in submit_ms])
        print(f"  io main path: {json.dumps(rec['main_path_snapshots'])}", flush=True)
        del s, T0, Cp, G, R, G_first

        # config 4's mesh: sharded save after 10 fused steps, restore, 10 more
        grid(tg, N_CFG4, N_CFG4, N_CFG4, dimx=2, dimy=2, dimz=2, periodx=1, periody=1,
             periodz=1)
        s0, q = models.init_acoustic3d(dtype=torch.float32)
        names = ("P", "Vx", "Vy", "Vz")
        cb.reset_launch_counts()
        s10 = models.run_acoustic(s0, q, 10, nt_chunk=10)
        ck = os.path.join(tmp, "ckpt_config4")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tg.save_checkpoint_sharded(ck, dict(zip(names, s10)), step=10)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored, step = tg.restore_checkpoint_sharded(ck)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        files = [os.path.join(ck, f) for f in sorted(os.listdir(ck)) if f.endswith(".npz")]
        t0 = time.perf_counter()
        for f in files:
            file_sha256(f)
        hash_s = time.perf_counter() - t0  # one pass over the files (warm): each side's share
        check(step == 10 and all(torch.equal(restored[n], a) for n, a in zip(names, s10)),
              "io config 4: the restored state bitwise the saved one")
        resumed = models.run_acoustic(tuple(restored[n] for n in names), q, 10, nt_chunk=10)
        straight = models.run_acoustic(s0, q, 20, nt_chunk=20)
        c = cb.launch_counts()
        add(c)
        check(all(torch.equal(a, b) for a, b in zip(resumed, straight)),
              "io config 4: 10 steps after the restore bitwise the uninterrupted 20")
        check(c["acoustic_step_exchange"] == 40, "io config 4: K9 once a step")
        nbytes = sum(a.numel() * a.element_size() for a in s10)
        rec["config4_checkpoint"] = dict(
            bytes=nbytes, file_bytes=sum(os.path.getsize(f) for f in files),
            save_ms=save_s * 1e3, restore_ms=restore_s * 1e3,
            save_gb_per_s=nbytes / save_s / 1e9, restore_gb_per_s=nbytes / restore_s / 1e9,
            sha256_ms=hash_s * 1e3, sha256_share_of_save=hash_s / save_s,
            sha256_share_of_restore=hash_s / restore_s)
        print(f"  io config 4: {json.dumps(rec['config4_checkpoint'])}", flush=True)
        del s0, s10, restored, resumed, straight
        shutil.rmtree(ck, ignore_errors=True)

        # the 128^3 diffusion mesh: saved on 2x2x2, elastic restart onto 4x2x1
        grid(tg, N_MESH, N_MESH, N_MESH, dimx=2, dimy=2, dimz=2, periodx=1)
        T0, Cp, p = models.init_diffusion3d(dtype=torch.float32)
        cb.reset_launch_counts()
        T = models.run_diffusion(T0, Cp, p, 10, nt_chunk=10)
        add(cb.launch_counts())
        GT, GC = tg.gather_interior(T), tg.gather_interior(Cp)
        ck = os.path.join(tmp, "ckpt_mesh")
        tg.save_checkpoint_sharded(ck, {"T": T, "Cp": Cp}, step=10)
        new_dims = (4, 2, 1)
        local = tg.elastic_local_size(tg.saved_topology(ck), new_dims)
        t0 = time.perf_counter()
        st, step = tg.elastic_restart(ck, new_dims)
        torch.cuda.synchronize()
        elastic_s = time.perf_counter() - t0
        gg = tg.global_grid()
        check(tuple(int(d) for d in gg.dims) == new_dims and gg.device.type == "cuda"
              and step == 10, f"io elastic: the grid re-initialized as {new_dims} of {local}")
        check(np.array_equal(tg.gather_interior(st["T"]), GT)
              and np.array_equal(tg.gather_interior(st["Cp"]), GC),
              "io elastic: gather_interior of the restored state bitwise the saved one")
        rec["elastic_restart"] = dict(saved_dims=[2, 2, 2], new_dims=list(new_dims),
                                      new_local=list(local), ms=elastic_s * 1e3)
        print(f"  io elastic: {json.dumps(rec['elastic_restart'])}", flush=True)
        del T, T0, Cp, st, GT, GC
        shutil.rmtree(ck, ignore_errors=True)

        # the guard and the reducers on the 128^3 mesh's kernel route
        grid(tg, N_MESH, N_MESH, N_MESH, dimx=2, dimy=2, dimz=2, periodx=1)
        T0, Cp, p = models.init_diffusion3d(dtype=torch.float32)

        def step(s, spare):
            return (models.diffusion_step_local(s[0], s[1], p, "cuda", out=spare), s[1]), s[0]

        names, reds = ("T", "Cp"), io_reducers(tg)
        plan = tg.io.build_reducer_plan(reds, names, {"T": T0, "Cp": Cp})
        hook = make_reduced_post_chunk(names, plan)
        guarded = tg.make_guarded_runner(step, nt_chunk=IO_GUARD_CHUNK)
        reduced = make_state_runner(step, nt_chunk=IO_GUARD_CHUNK, post_chunk=hook)
        cb.reset_launch_counts()
        T1, C1, gvec = guarded(T0, Cp)
        T2, C2, vec = reduced(T1, C1)
        torch.cuda.synchronize()
        c = cb.launch_counts()
        add(c)
        check(c["diffusion3d_step_exchange"] == 2 * IO_GUARD_CHUNK,
              "io guard: the chunks ran the kernel route (K4 a step)")
        bad, rel_g = io_vector_matches(gvec.cpu().tolist(), io_plain_parts(tg, T1, C1, []),
                                       tg.io.build_reducer_plan([], names, {"T": T1, "Cp": C1}),
                                       names)
        check(not bad, f"io guard: the guard's vector equals plain PyTorch's on the card "
                       f"({bad}; sums' relative errors {rel_g})")
        bad, rel = io_vector_matches(vec.cpu().tolist(), io_plain_parts(tg, T2, C2, reds),
                                     plan, names)
        check(not bad, f"io reducers: probe, slice, min and max bitwise, sums within "
                       f"{IO_SUM_RTOL} of plain PyTorch's on the card ({bad}; {rel})")
        sizes = [T0.numel(), Cp.numel()]
        rep = report_from_stats(vec[:4], names, sizes, tg.GuardConfig(), chunk=1,
                                step_begin=IO_GUARD_CHUNK, step_end=2 * IO_GUARD_CHUNK)
        check(rep.ok, "io guard: a clean chunk passes")
        *_, v3 = reduced(tg.poke_nan(T2, (5, 6, 7)), C2)
        rep = report_from_stats(v3[:4], names, sizes, tg.GuardConfig(), chunk=2,
                                step_begin=2 * IO_GUARD_CHUNK, step_end=3 * IO_GUARD_CHUNK)
        check("nonfinite:T" in rep.reasons and rep.nonfinite["T"] > 0,
              f"io guard: the chunk after a poke_nan trips nonfinite:T ({rep.nonfinite})")
        add({k: n - c.get(k, 0) for k, n in cb.launch_counts().items()})
        hook_ms = median_ms(lambda: hook((T2, C2)), batches=5, per_batch=5)
        guard_ms = median_ms(lambda: health_stats_local((T2, C2)), batches=5, per_batch=5)
        chunk_ms = median_ms(lambda: guarded(T0, Cp), batches=3, per_batch=2, warm=1)
        rec["guard_reducers"] = dict(
            hook_ms_per_chunk=hook_ms, guard_only_ms=guard_ms,
            guarded_chunk_ms=chunk_ms, chunk_steps=IO_GUARD_CHUNK,
            vector_length=int(vec.numel()), sums_rel_err=rel, guard_sums_rel_err=rel_g,
            nonfinite_after_poke=rep.nonfinite["T"])
        print(f"  io guard and reducers: {json.dumps(rec['guard_reducers'])}", flush=True)
        tg.finalize_global_grid()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return counts, rec


SUP_CHUNK, SUP_STEPS = 100, 400  # phase 13c's main path: 400 K1 steps in chunks of 100
SUP_POKE = (250, (5, 6, 7))  # its NaN: the step and the cell (an interior one)
SUP_MESH_STEPS, SUP_MESH_CHUNK = 40, 10  # the 128^3 mesh's supervised runs


def _chunk_ms(events):
    """The chunks' exec ms (dispatch through the stats fetch) of a flight
    stream, in order."""
    return [e["exec_s"] * 1e3 for e in events if e["kind"] == "chunk"]


def phase_supervised(tg, models, cb):
    """Phase 13c: the supervised run (`run_resilient`). The main path
    (256^3 periodic, K1) for 400 steps in chunks of 100: the bare donating
    runner gives the reference T; the driver with its default knobs (the
    guard only) gives T bitwise; then with a checkpoint and a snapshot
    every 200 steps, a `Stats` reducer, a NaN at step 250 and a flight
    recorder it gives T bitwise again, one report tripped with
    ``nonfinite:T``, and `run_report` of the stream shows one rollback, the
    saves and restores, two snapshots; K1's launches equal the steps the
    driver ran, the replayed ones included. The 128^3 mesh (2x2x2 periodic
    in x, K4s + K4): 40 steps in chunks of 10 with a `ProcessLoss` at step
    20 end on 4x2x1 bitwise the uninterrupted run; a bit-flipped second
    save and a NaN fall back to the other slot and end bitwise. Then the
    fifth example at its card size. Files go to a temporary directory,
    removed at the end. Returns (launches, record)."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from implicitglobalgrid_tpu_torch.io.reducers import build_reducer_plan, \
        make_reduced_post_chunk
    from implicitglobalgrid_tpu_torch.models.common import make_state_runner
    from implicitglobalgrid_tpu_torch.runtime.health import health_stats_local

    print(f"phase: the supervised run (run_resilient); card {card_name()}", flush=True)
    tmp = tempfile.mkdtemp(prefix="igg_supervised_")
    counts, rec = {}, {}

    def add(c):
        for k, n in c.items():
            counts[k] = counts.get(k, 0) + n

    def timed_chunks(run, s, n):
        out = []
        for k in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s = run(*s, donate=k > 0)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return s, out

    try:
        # the main path: K1 on 256^3, periodic
        grid(tg, N_MAIN, N_MAIN, N_MAIN, periodx=1, periody=1, periodz=1)
        T0, Cp, p = models.init_diffusion3d(dtype=torch.float32)
        run = models.make_run(p, SUP_CHUNK)
        run(T0, Cp)  # warm chunk
        s, bare_ms = timed_chunks(run, (T0, Cp), SUP_STEPS // SUP_CHUNK)
        T_ref = s[0].clone()
        del s
        step_T = models.make_step(p)  # the kernel route (K1 a step)

        def step(st):
            return {"T": step_T(st["T"], st["Cp"]), "Cp": st["Cp"]}

        # the driver's step adapter alone (a dict step, no spare: each step
        # allocates its output) against the donating runner
        adapter = make_state_runner(
            tg.ResilientRun(step, {"T": T0, "Cp": Cp}, 1)._step_tuple, nt_chunk=SUP_CHUNK)
        adapter(T0, Cp)
        _, adapter_ms = timed_chunks(adapter, (T0, Cp), 3)
        # the default knobs: the guard after each chunk
        fr = os.path.join(tmp, "guard.jsonl")
        tg.start_flight_recorder(fr)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, reps = tg.run_resilient(step, {"T": T0, "Cp": Cp}, SUP_STEPS, nt_chunk=SUP_CHUNK)
        guard_wall = (time.perf_counter() - t0) * 1e3
        tg.stop_flight_recorder()
        guard_ms = _chunk_ms(tg.read_flight_events(fr))
        check(torch.equal(out["T"], T_ref) and len(reps) == SUP_STEPS // SUP_CHUNK
              and all(r.ok for r in reps),
              f"supervised main path, default knobs: T bitwise the bare runner's after "
              f"{SUP_STEPS} steps ({len(reps)} clean reports)")
        del out
        # checkpoints, snapshots, a reducer, a NaN, a flight recorder
        fr = os.path.join(tmp, "full.jsonl")
        tg.reset_metrics()
        cb.reset_launch_counts()
        tg.start_flight_recorder(fr)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, reps = tg.run_resilient(
            step, {"T": T0, "Cp": Cp}, SUP_STEPS, nt_chunk=SUP_CHUNK,
            checkpoint_dir=os.path.join(tmp, "ck"), checkpoint_every=200,
            snapshot_dir=os.path.join(tmp, "snaps"), snapshot_every=200,
            snapshot_fields=("T",), reducers=[tg.Stats("T")],
            faults=(tg.NaNPoke(SUP_POKE[0], "T", SUP_POKE[1]),))
        full_wall = (time.perf_counter() - t0) * 1e3
        tg.stop_flight_recorder()
        c = cb.launch_counts()
        add(c)
        ran = sum(r.step_end - r.step_begin for r in reps)
        tripped = [r for r in reps if not r.ok]
        check(torch.equal(out["T"], T_ref), "supervised main path, faulted: T bitwise the "
                                            "bare runner's after the rollback")
        check(len(tripped) == 1 and tripped[0].reasons == ("nonfinite:T",)
              and tripped[0].step_begin == SUP_POKE[0],
              f"supervised main path: exactly one report tripped, nonfinite:T from step "
              f"{SUP_POKE[0]} ({[(r.step_begin, r.reasons) for r in tripped]})")
        check(c["diffusion3d_step_halo"] == ran,
              f"supervised main path: K1 launched once a step the driver ran, the replayed "
              f"ones included ({c['diffusion3d_step_halo']} launches, {ran} steps)")
        evs = tg.read_flight_events(fr)
        rep = tg.run_report(fr, include_metrics=False)
        ck, io = rep["checkpoints"], rep["io"]
        check(ck["rollbacks"] == 1 and ck["restores"] == 1 and ck["saves"] == 3
              and io["snapshots_written"] == 2 and io["snapshots_submitted"] == 2
              and rep["guards"] == {"trips": 1, "reasons": {"nonfinite:T": 1}},
              f"supervised main path: run_report shows one rollback, {ck['saves']} saves "
              f"and {ck['restores']} restore, {io['snapshots_written']} snapshots written")
        t = {e["kind"]: e["t"] for e in evs if e["kind"] in ("guard_trip", "rollback")}
        save_ms = [e["dur_s"] * 1e3 for e in evs if e["kind"] == "checkpoint_save"]
        restore_ms = [e["dur_s"] * 1e3 for e in evs if e["kind"] == "checkpoint_restore"]
        snaps = tg.list_snapshots(os.path.join(tmp, "snaps"))
        check([st for st, _ in snaps] == [200, SUP_STEPS] and np.array_equal(
            tg.open_snapshot(snaps[-1][1]).read_global("T"), tg.gather_interior(out["T"])),
            "supervised main path: the last snapshot reads bitwise gather_interior(T)")
        names = ("T", "Cp")
        plan = build_reducer_plan([tg.Stats("T")], names, {"T": T0, "Cp": Cp})
        hook = make_reduced_post_chunk(names, plan)
        hook_ms = median_ms(lambda: hook((T0, Cp)), batches=5, per_batch=5)
        guard_only_ms = median_ms(lambda: health_stats_local((T0, Cp)), batches=5,
                                  per_batch=5)
        nbytes = sum(a.numel() * a.element_size() for a in (T0, Cp))
        rec["main_path"] = dict(
            steps=SUP_STEPS, chunk_steps=SUP_CHUNK, bare_chunk_ms=bare_ms,
            adapter_chunk_ms=adapter_ms, guard_chunk_exec_ms=guard_ms,
            guard_run_wall_ms=guard_wall, bare_run_wall_ms=sum(bare_ms),
            full_chunk_exec_ms=_chunk_ms(evs), full_run_wall_ms=full_wall,
            steps_run=ran, k1_launches=c["diffusion3d_step_halo"],
            save_ms=save_ms, restore_ms=restore_ms,
            rollback_ms=(t["rollback"] - t["guard_trip"]) * 1e3,
            checkpoint_bytes=nbytes, save_gb_per_s=[nbytes / m / 1e6 for m in save_ms],
            stats_hook_ms=hook_ms, guard_only_ms=guard_only_ms,
            snapshot_bytes=io["snapshot_bytes"], snapshot_write_s=io["snapshot_write_s_total"])
        print(f"  supervised main path: {json.dumps(rec['main_path'])}", flush=True)
        del out, T_ref, T0, Cp, adapter

        # the 128^3 mesh: 2x2x2 periodic in x, the kernel route (K4s + K4)
        grid(tg, N_MESH, N_MESH, N_MESH, dimx=2, dimy=2, dimz=2, periodx=1)
        T0, Cp, p = models.init_diffusion3d(dtype=torch.float32)
        cb.reset_launch_counts()
        G_ref = tg.gather_interior(models.run_diffusion(T0, Cp, p, SUP_MESH_STEPS,
                                                        nt_chunk=SUP_MESH_CHUNK))
        step_T = models.make_step(p)
        kw = dict(nt_chunk=SUP_MESH_CHUNK, checkpoint_every=20)
        fr = os.path.join(tmp, "elastic.jsonl")
        tg.start_flight_recorder(fr)
        t0 = time.perf_counter()
        out, reps = tg.run_resilient(step, {"T": T0, "Cp": Cp}, SUP_MESH_STEPS,
                                     checkpoint_dir=os.path.join(tmp, "ck_elastic"),
                                     faults=(tg.ProcessLoss(20, (4, 2, 1)),), **kw)
        elastic_wall = (time.perf_counter() - t0) * 1e3
        tg.stop_flight_recorder()
        gg = tg.global_grid()
        check(tuple(int(d) for d in gg.dims) == (4, 2, 1) and gg.device.type == "cuda",
              "supervised mesh: the ProcessLoss left the grid 4x2x1 on the card")
        check(np.array_equal(tg.gather_interior(out["T"]), G_ref),
              f"supervised mesh: after the elastic restart gather_interior(T) bitwise the "
              f"uninterrupted 2x2x2 run's ({SUP_MESH_STEPS} steps)")
        el = tg.run_report(fr, include_metrics=False)
        add(cb.launch_counts())
        del out
        grid(tg, N_MESH, N_MESH, N_MESH, dimx=2, dimy=2, dimz=2, periodx=1)
        T0, Cp, p = models.init_diffusion3d(dtype=torch.float32)
        step_T = models.make_step(p)
        cb.reset_launch_counts()
        fr = os.path.join(tmp, "fallback.jsonl")
        tg.start_flight_recorder(fr)
        out, reps = tg.run_resilient(step, {"T": T0, "Cp": Cp}, SUP_MESH_STEPS,
                                     checkpoint_dir=os.path.join(tmp, "ck_fallback"),
                                     faults=(tg.CheckpointCorruption(1, kind="bitflip"),
                                             tg.NaNPoke(25, "T", (5, 6, 7))), **kw)
        tg.stop_flight_recorder()
        c = cb.launch_counts()
        add(c)
        fb = tg.run_report(fr, include_metrics=False)
        rolls = [e for e in fb["sequence"] if e["kind"] == "rollback"]
        check(len(rolls) == 1 and rolls[0]["fallback"] is True and rolls[0]["to_step"] == 0,
              f"supervised mesh: the bit-flipped slot detected, the rollback fell back to "
              f"the other slot ({rolls})")
        check(np.array_equal(tg.gather_interior(out["T"]), G_ref),
              "supervised mesh: after the fallback gather_interior(T) bitwise the "
              "uninterrupted run's")
        check(c["diffusion3d_step_exchange"] == sum(r.step_end - r.step_begin for r in reps),
              "supervised mesh: K4 once a step the driver ran")
        rec["mesh"] = dict(
            elastic_wall_ms=elastic_wall, elastic=el["elastic_restarts"],
            elastic_restore_ms=[e["dur_s"] * 1e3 for e in el["sequence"]
                                if e["kind"] == "checkpoint_restore"],
            elastic_save_ms=[e["dur_s"] * 1e3 for e in el["sequence"]
                             if e["kind"] == "checkpoint_save"],
            fallback_restores=fb["checkpoints"]["restores"],
            fallback_steps_run=sum(r.step_end - r.step_begin for r in reps))
        print(f"  supervised mesh: {json.dumps(rec['mesh'])}", flush=True)
        del out, T0, Cp, G_ref
        tg.finalize_global_grid()

        # the fifth example at its card size
        from implicitglobalgrid_tpu_torch.examples.diffusion3D_multixpu import diffusion3D

        os.environ.pop("IGG_USE_PALLAS", None)
        cb.reset_launch_counts()
        t0 = time.perf_counter()
        frames, G = diffusion3D()
        ex_s = time.perf_counter() - t0
        add(cb.launch_counts())
        check(frames.shape[0] == 10 and np.array_equal(frames[-1], G[:, :, G.shape[2] // 2]),
              f"vis example: {frames.shape[0]} frames, the last bitwise the z-midplane of "
              f"gather_interior(T)")
        rec["vis_example"] = dict(frames=list(frames.shape), seconds=ex_s,
                                  launches=cb.launch_counts())
        print(f"  vis example: {json.dumps(rec['vis_example'])}", flush=True)
    finally:
        tg.stop_flight_recorder()
        shutil.rmtree(tmp, ignore_errors=True)
    return counts, rec


ORACLE_FMA_ITERS = 64  # FMA-chain iterations of the kernel-vs-plain check and timing
ORACLE_CHUNKS, ORACLE_NT_CHUNK = 3, 100  # the tuned supervised run on the main path
ORACLE_HALO_CALLS = 200  # update_halo calls of the accounting check
ORACLE_DEVICE = "cuda"  # where the phase's own tensors go (a CPU rehearsal sets "cpu")


def _predicted_vs_measured(tg, models, cw, cst, prof):
    """`predict_step` under ``prof`` beside the measured wall ms a step
    (`route_times`) of the fused and the plain route on the three meshes
    the earlier phases run: the README mesh (diffusion, 2x2x2 x 128^3,
    periodic in x), config 4's (acoustic, 2x2x2 x 192^3, periodic) and
    config 5's (Stokes, 2x2x2 x 128^3)."""
    import torch

    meshes = (("readme_diffusion_128", "diffusion3d", N_MESH, dict(periodx=1)),
              ("config4_acoustic_192", "acoustic3d", N_CFG4,
               dict(periodx=1, periody=1, periodz=1)),
              ("config5_stokes_128", "stokes3d", N_CFG5, {}))
    out = {}
    for name, model, n, per in meshes:
        grid(tg, n, n, n, dimx=2, dimy=2, dimz=2, **per)
        if model == "diffusion3d":
            T0, Cp, p = models.init_diffusion3d(dtype=torch.float32)
            state = (T0, Cp)
            fused, plain = models.make_step(p), models.make_step(p, impl="plain")
            routes = {"cuda": lambda: fused(T0, Cp), "plain": lambda: plain(T0, Cp)}
        elif model == "acoustic3d":
            state, p = models.init_acoustic3d(dtype=torch.float32)
            routes = {"cuda": _acoustic_step(tg, cw, state, p),
                      "plain": lambda: models.acoustic_step_local(state, p, impl="plain")}
        else:
            state, p = models.init_stokes3d(dtype=torch.float32)
            routes = {"cuda": _stokes_iteration(tg, cst, state, p),
                      "plain": lambda: models.stokes_step_local(state, p, impl="plain")}
        for impl, fn in routes.items():
            pred = tg.predict_step(model, state, profile=prof, impl=impl)
            wall = route_times(fn, reps=5, batches=3)["wall_ms_per_step"]
            rec = dict(predicted_ms=pred["step_s"] * 1e3, bound=pred["bound"],
                       bound_detail=pred["bound_detail"],
                       predicted_compute_ms=pred["compute"]["s"] * 1e3,
                       predicted_comm_ms=pred["comm_s"] * 1e3, measured_wall_ms=wall,
                       measured_over_predicted=wall / (pred["step_s"] * 1e3))
            out[f"{name}_{impl}"] = rec
            print(f"  {name} {impl}: predicted {rec['predicted_ms']!r} ms ({pred['bound']}, "
                  f"{pred['bound_detail']}), measured wall {wall!r} ms, ratio "
                  f"{rec['measured_over_predicted']!r}", flush=True)
        del state, routes
    tg.finalize_global_grid()
    return out


def _halo_accounting(tg, cb):
    """`update_halo` on the 128^3 mesh with the accounting (this package)
    and without it (the exchange alone, as before the accounting), the
    recorder off and on; the accounting's own host time a call; the
    counters against `halo_comm_plan` times the calls."""
    import tempfile

    import torch
    from implicitglobalgrid_tpu_torch.ops import halo

    grid(tg, N_MESH, N_MESH, N_MESH, dimx=2, dimy=2, dimz=2, periodx=1)
    g = torch.Generator(device=ORACLE_DEVICE).manual_seed(17)
    A = torch.randn((2 * N_MESH,) * 3, generator=g, device=ORACLE_DEVICE)
    plan = tg.halo_comm_plan(A)
    tg.reset_metrics()
    cb.reset_launch_counts()
    for _ in range(ORACLE_HALO_CALLS):
        A = tg.update_halo(A)
    torch.cuda.synchronize()
    counts = cb.launch_counts()
    reg = tg.metrics_registry()
    ex = reg.get("igg_halo_exchanges_total").value()
    pp = sum(v for _, v in reg.get("igg_halo_ppermutes_total").samples())
    wb = sum(v for _, v in reg.get("igg_halo_wire_bytes_total").samples())
    check(ex == ORACLE_HALO_CALLS and pp == ORACLE_HALO_CALLS * plan["ppermutes"]
          and wb == ORACLE_HALO_CALLS * plan["wire_bytes"],
          f"accounting: {ex:.0f} exchanges, {pp:.0f} permutes and {wb:.0f} wire bytes are "
          f"halo_comm_plan's times the {ORACLE_HALO_CALLS} calls")

    def host_us(fn, n=ORACLE_HALO_CALLS):
        fn()
        torch.cuda.synchronize()
        best = None
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            t = (time.perf_counter() - t0) / n * 1e6
            torch.cuda.synchronize()
            best = t if best is None else min(best, t)
        return best

    gg = tg.global_grid()
    fs = halo._normalized_fields((A,))
    acct = lambda: halo._account(gg, fs, halo.DEFAULT_DIMS_ORDER, True, None, None)  # noqa: E731
    rec = {}
    with tempfile.TemporaryDirectory() as d:
        for recorder in ("off", "on"):
            if recorder == "on":
                tg.start_flight_recorder(os.path.join(d, "fr.jsonl"))
            with_acct = host_us(lambda: tg.update_halo(A))
            saved = halo._account
            halo._account = lambda *a: None
            try:
                without = host_us(lambda: tg.update_halo(A))
            finally:
                halo._account = saved
            rec[f"recorder_{recorder}"] = dict(
                update_halo_host_us=with_acct, without_accounting_host_us=without,
                accounting_alone_host_us=host_us(acct, 2000))
            if recorder == "on":
                tg.stop_flight_recorder()
    for k, r in rec.items():
        print(f"  update_halo host us a call, {k}: {json.dumps(r)}", flush=True)
    rec["plan"] = dict(ppermutes=plan["ppermutes"], wire_bytes=plan["wire_bytes"])
    tg.finalize_global_grid()
    return counts, rec


def phase_oracle(tg, models, cb, cw, cst):
    """Phase 13d: the performance oracle and the mesh view. The calibration
    kernel (`fma_chain`) against its plain version on the card;
    `calibrate_machine` on the main path's 256^3 block and on the 2x2x2 x
    128^3 virtual mesh (the triad at least 4x the L2, the per-block rates
    times the blocks under the card's peaks x 1.05); `predict_step` against
    the measured step of the fused and plain routes on the three meshes;
    `tune_config("diffusion3d")` on the 2x2x2 x 128^3 grid, measured, top 2
    (speedup >= 1, the caller's grid back: its epoch, its halos bitwise);
    `run_resilient(tuned=, metrics_port=0)` on the main path, 256^3, 3
    chunks of 100, /metrics and /healthz scraped from ``on_report``, the
    ``tuned`` event, K1 once a step; the halo accounting's host cost and
    counters. Returns (launches, record, the fma_chain kernel row)."""
    import shutil
    import tempfile
    import urllib.request

    import torch
    from implicitglobalgrid_tpu_torch.ops import cuda_calibrate as cc

    print(f"phase: the performance oracle and the mesh view; card {card_name()}", flush=True)
    counts = {k: 0 for k in KERNEL_NAMES}

    def add(c):
        for k in counts:
            counts[k] += c.get(k, 0)

    rec = {}
    # calibrate on the main path's one block, then on the virtual mesh
    cb.reset_launch_counts()
    grid(tg, N_MAIN, N_MAIN, N_MAIN, periodx=1, periody=1, periodz=1)
    t0 = time.perf_counter()
    prof1 = tg.calibrate_machine()
    t1 = time.perf_counter()
    grid(tg, N_MESH, N_MESH, N_MESH, dimx=2, dimy=2, dimz=2, periodx=1)
    profm = tg.calibrate_machine()
    t2 = time.perf_counter()
    torch.cuda.synchronize()
    add(cb.launch_counts())
    check(cb.launch_counts()["fma_chain"] > 0, "calibration: the FLOP fit ran the fma_chain "
                                               "kernel")
    for label, prof, blocks, secs in (("256^3 block", prof1, 1, t1 - t0),
                                      ("2x2x2 x 128^3 mesh", profm, 8, t2 - t1)):
        card_bw, card_fl = prof.membw_GBps * blocks, prof.flops_G * blocks
        print(f"  calibrated on the {label} in {secs:.3f} s: membw_GBps {prof.membw_GBps!r} "
              f"(card {card_bw!r}), flops_G {prof.flops_G!r} (card {card_fl!r}), axes "
              f"{json.dumps(prof.axes)}, meta {json.dumps(prof.meta)}", flush=True)
        check(0 < card_bw <= HBM_BYTES_PER_S / 1e9 * 1.05,
              f"calibration ({label}): the triad's {card_bw:.1f} GB/s a card is under the "
              f"memory's 3.35 TB/s x 1.05 (not cache-resident)")
        check(0 < card_fl <= F32_FLOPS_PER_S / 1e9 * 1.05,
              f"calibration ({label}): the FMA chain's {card_fl:.1f} GFLOP/s a card is under "
              f"the float32 peak x 1.05")
    check(set(profm.axes) == {"gx", "gy", "gz"} and all(
        r["GBps"] > 0 and r["latency_s"] >= 0 for r in profm.axes.values()),
        "calibration (mesh): a link fit for every axis")
    rec["profile_block"] = prof1.to_json()
    rec["profile_mesh"] = profm.to_json()
    tg.finalize_global_grid()

    # the calibration kernel against its plain version, at the shape the
    # 256^3 block's FLOP fit gives it
    n = prof1.meta["fma_elems_per_device"]
    g = torch.Generator(device=ORACLE_DEVICE).manual_seed(23)
    x = torch.rand(n, generator=g, device=ORACLE_DEVICE) * 4 - 2
    got = cc.fma_chain(x.clone(), ORACLE_FMA_ITERS)
    ref = cc.fma_chain_plain(x.clone(), ORACLE_FMA_ITERS, 1.000001, 1e-9)
    torch.cuda.synchronize()
    err = max_err(got, ref)
    check(bool(torch.allclose(got, ref, rtol=1e-6, atol=0.0)),
          f"fma_chain: {n} elements x {ORACLE_FMA_ITERS * cc.FMA_PER_ITER} multiply-adds "
          f"within 1e-6 relative of the plain version (max abs err {err:.3e}; "
          f"{int((got != ref).sum())} elements differ: float64 double rounding)")
    y = x.clone()
    flops = 2.0 * cc.FMA_PER_ITER * ORACLE_FMA_ITERS * n
    bound_o = flops / F32_FLOPS_PER_S * 1e3
    bound_b = 8.0 * n / HBM_BYTES_PER_S * 1e3
    fma_row = dict(
        max_abs_err=err,
        ms=median_ms(lambda: cc.fma_chain(y, ORACLE_FMA_ITERS)),
        plain_ms=median_ms(lambda: cc.fma_chain_plain(y, ORACLE_FMA_ITERS, 1.000001, 1e-9),
                           batches=1, per_batch=1, warm=1),
        device_ms=device_ms(lambda: cc.fma_chain(y, ORACLE_FMA_ITERS),
                            KERNEL_NAMES["fma_chain"]),
        bound_ms=max(bound_o, bound_b), bound_by="operations" if bound_o >= bound_b
        else "bytes", library_ms=None,
        shape=f"{n} float32 x {ORACLE_FMA_ITERS * cc.FMA_PER_ITER} FMAs")
    print(f"  fma_chain: {json.dumps(fma_row)}", flush=True)
    del x, y, got, ref

    # the model against the measured steps
    rec["predicted_vs_measured"] = _predicted_vs_measured(tg, models, cw, cst, profm)

    # the tuner on the 2x2x2 x 128^3 grid, the caller's grid kept
    grid(tg, N_MESH, N_MESH, N_MESH, dimx=2, dimy=2, dimz=2, periodx=1)
    base = dict(nx=N_MESH, ny=N_MESH, nz=N_MESH, dimx=2, dimy=2, dimz=2, periodx=1,
                device_type=tg.global_grid().device_type)
    epoch = tg.global_grid().epoch
    A = torch.randn((2 * N_MESH,) * 3, generator=g, device=ORACLE_DEVICE)
    U1 = tg.update_halo(A.clone())
    cb.reset_launch_counts()
    t0 = time.perf_counter()
    cfg = tg.tune_config("diffusion3d", dict(base), profm, measure=True, top_k=2)
    tune_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    add(cb.launch_counts())
    rec["tuner"] = dict(knobs=cfg.knobs(), predicted_step_s=cfg.predicted_step_s,
                        measured_step_s=cfg.measured_step_s,
                        baseline_step_s=cfg.baseline_step_s, speedup=cfg.speedup,
                        ranking=cfg.meta["ranking"], measured=cfg.meta["measured"],
                        skipped=len(cfg.meta["skipped"]), seconds=tune_s,
                        launches=cb.launch_counts())
    print(f"  tuner: {json.dumps(rec['tuner'])}", flush=True)
    check(cfg.speedup is not None and cfg.speedup >= 1.0,
          f"tuner: the measured pick is no slower than the default (speedup {cfg.speedup!r})")
    check(tg.grid_is_initialized() and tg.global_grid().epoch == epoch,
          "tuner: the caller's grid is back, its epoch unchanged")
    check(torch.equal(tg.update_halo(A.clone()), U1),
          "tuner: update_halo on the caller's grid bitwise as before the tune")
    del A, U1
    tg.finalize_global_grid()

    # the tuned supervised run on the main path, its endpoint scraped
    grid(tg, N_MAIN, N_MAIN, N_MAIN, periodx=1, periody=1, periodz=1)
    T0, Cp, p = models.init_diffusion3d(dtype=torch.float32)
    scraped = []

    def on_report(rep):
        t0 = time.perf_counter()
        port = tg.metrics_server().port
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
            body = r.read().decode()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10) as r:
            health = json.loads(r.read().decode())
        scraped.append(dict(status="igg_driver_heartbeat_timestamp_seconds" in body,
                            bytes=len(body), healthz=health,
                            scrape_ms=(time.perf_counter() - t0) * 1e3))

    k1 = models.make_step(p)  # the K1 route on the one periodic block
    step = lambda s: {"T": k1(s["T"], s["Cp"]), "Cp": s["Cp"]}  # noqa: E731
    tmp = tempfile.mkdtemp(prefix="igg_oracle_")
    try:
        tg.start_flight_recorder(os.path.join(tmp, "fr.jsonl"))
        step({"T": T0, "Cp": Cp})  # warm
        torch.cuda.synchronize()
        cb.reset_launch_counts()
        t0 = time.perf_counter()
        out, reps = tg.run_resilient(step, {"T": T0, "Cp": Cp}, ORACLE_CHUNKS * ORACLE_NT_CHUNK,
                                     nt_chunk=ORACLE_NT_CHUNK, tuned=cfg, metrics_port=0,
                                     on_report=on_report)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = cb.launch_counts()
        add(c)
        path = tg.stop_flight_recorder()
        evs = tg.read_flight_events(path)
        steps = sum(r.step_end - r.step_begin for r in reps)
        check(c["diffusion3d_step_halo"] == steps == ORACLE_CHUNKS * ORACLE_NT_CHUNK,
              f"tuned run: K1 launched once a step ({c['diffusion3d_step_halo']} for {steps})")
        check(len(scraped) == ORACLE_CHUNKS and all(
            x["status"] and x["healthz"]["ok"] for x in scraped),
            f"tuned run: /metrics and /healthz scraped at each of the {len(scraped)} "
            f"chunk boundaries (heartbeat age {scraped[-1]['healthz']['heartbeat_age_s']!r} s)")
        tuned = [e for e in evs if e["kind"] == "tuned"]
        check(len(tuned) == 1 and tuned[0]["comm_every"] == cfg.comm_every,
              f"tuned run: the stream holds the tuned event ({tuned and tuned[0]['comm_every']})")
        check(tg.metrics_server() is None, "tuned run: the endpoint stopped with the run")
        check(bool(torch.isfinite(out["T"]).all()), "tuned run: T finite")
        rec["tuned_run"] = dict(steps=steps, wall_ms_per_step=wall * 1e3 / steps,
                                chunk_exec_ms=[e["exec_s"] * 1e3 for e in evs
                                               if e["kind"] == "chunk"],
                                scrapes=scraped, launches=c)
        print(f"  tuned run: {json.dumps(rec['tuned_run'])}", flush=True)
    finally:
        tg.stop_flight_recorder()
        shutil.rmtree(tmp, ignore_errors=True)
    del out, T0, Cp
    tg.finalize_global_grid()

    c, rec["halo_accounting"] = _halo_accounting(tg, cb)
    add(c)
    return counts, rec, fma_row


AUDIT_CHUNK, AUDIT_STEPS = 100, 300  # phase 13e's supervised run on the 256^3 mesh
RESIZE_AT, RESIZE_STEPS = 100, 200  # its resize: 2x2x2 -> 4x2x1 at step 100
RESIZE_DIMS = (4, 2, 1)


def _axes_line(rep):
    """Per mesh axis of an audit report: permutes, pairs, wire bytes and
    dtypes (`measure_axes` of the recording)."""
    return {a: dict(permutes=r["permutes"], pairs=r["pairs"], wire_bytes=r["wire_bytes"],
                    dtypes=list(r["dtypes"]))
            for a, r in rep.collectives.get("by_axis", {}).items()}


def _resized_run(tg, models, via, ckpt=None, audit=False):
    """The 256^3 mesh's diffusion (2x2x2, periodic in x, the kernel route)
    for RESIZE_STEPS steps in chunks of 100 under the driver, resized to
    RESIZE_DIMS at RESIZE_AT through ``via`` (None: never resized). Returns
    (gathered interior of T, the resize record, the flight events)."""
    import tempfile

    import torch

    grid(tg, N_MAIN, N_MAIN, N_MAIN, dimx=2, dimy=2, dimz=2, periodx=1)
    T0, Cp, p = models.init_diffusion3d(dtype=torch.float32)
    step_T = models.make_step(p)

    def step(st):
        return {"T": step_T(st["T"], st["Cp"]), "Cp": st["Cp"]}

    with tempfile.TemporaryDirectory(prefix="igg_resize_") as d:
        fr = os.path.join(d, "fr.jsonl")
        tg.start_flight_recorder(fr)
        run = tg.ResilientRun(step, {"T": T0, "Cp": Cp}, RESIZE_STEPS, tg.RunSpec(
            nt_chunk=AUDIT_CHUNK, checkpoint_dir=ckpt, checkpoint_every=RESIZE_STEPS,
            audit=audit))
        del T0, Cp
        rec = None
        try:
            while run.advance():
                if via is not None and rec is None and run.step == RESIZE_AT:
                    torch.cuda.synchronize()
                    rec = run.resize(RESIZE_DIMS, via=via)
        finally:
            run.close()
            tg.stop_flight_recorder()
        evs = tg.read_flight_events(fr)
    G = tg.gather_interior(run.state["T"])
    del run
    tg.finalize_global_grid()
    return G, rec, evs


def phase_audit_reshard(tg, models, cb):
    """Phase 13e: the communication audit and the on-device reshard.
    `audit_model` of diffusion3d on the 2x2x2 mesh of 256^3 blocks
    (periodic in x), acoustic3d on config 4's mesh (2x2x2 x 192^3) and
    stokes3d on config 5's (2x2x2 x 128^3), each under impl="cuda" and
    "plain": every report ok, `perfmodel_crosscheck` clean, each axis's
    recorded permutes, pairs, wire bytes and dtypes printed.
    `run_resilient(audit=True)` on the 256^3 mesh, 300 steps in chunks of
    100: one clean ``audit`` event, K4 once a step, the audited first
    chunk's ms beside the later chunks' and an unaudited run's. The mesh
    resized 2x2x2 -> 4x2x1 at step 100 with ``via="device"`` (audited:
    an ``audit`` event with ``program="reshard"``, ok), ``via="checkpoint"``
    and not at all: the gathered interiors bitwise equal; each path's
    resize ms, the plan's rounds, wire and peak payload bytes and
    `predict_reshard`'s seconds. Config 4's staggered state (P, Vx, Vy,
    Vz) resharded in one move, bitwise `apply_plan_host` of its host copy.
    Returns (launches, record)."""
    import tempfile

    import numpy as np
    import torch
    from implicitglobalgrid_tpu_torch.reshard import (
        apply_plan_host, build_reshard_plan, compile_reshard_program, fields_of_state,
        live_topology,
    )

    print(f"phase: the communication audit and the on-device reshard; card {card_name()}",
          flush=True)
    counts = {k: 0 for k in KERNEL_NAMES}

    def add(c):
        for k in counts:
            counts[k] += c.get(k, 0)

    rec = {"audit_model": {}}
    # audit_model: one step of each family on its full-width mesh, both routes
    for model, n, kw in (("diffusion3d", N_MAIN, dict(periodx=1)),
                         ("acoustic3d", N_CFG4, dict(periodx=1, periody=1, periodz=1)),
                         ("stokes3d", N_CFG5, {})):
        grid(tg, n, n, n, dimx=2, dimy=2, dimz=2, **kw)
        for impl in ("cuda", "plain"):
            cb.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rep = tg.audit_model(model, impl=impl)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            add(cb.launch_counts())
            cc = rep.crosscheck or {}
            check(rep.ok and cc.get("ok") and rep.dialect == "record",
                  f"audit_model({model!r}, impl={impl!r}) on 2x2x2 x {n}^3: ok and the "
                  f"perf-model crosscheck clean ({[f.message for f in rep.findings]})")
            r = rec["audit_model"][f"{model}_{impl}"] = dict(
                grid=f"2x2x2 x {n}^3", ms=ms, axes=_axes_line(rep),
                permutes=rep.collectives["permutes"], wire_bytes=rep.collectives["wire_bytes"],
                crosscheck_axes=cc.get("axes"), rounds_impl=rep.meta.get("rounds_impl"),
                launches={k: v for k, v in cb.launch_counts().items() if v})
            print(f"  audit_model {model} {impl}: {json.dumps(r)}", flush=True)
        tg.finalize_global_grid()
    check(rec["audit_model"]["acoustic3d_cuda"]["launches"].get("acoustic_step_exchange") == 1
          and rec["audit_model"]["stokes3d_cuda"]["launches"].get("stokes_step_exchange") == 1
          and rec["audit_model"]["diffusion3d_cuda"]["launches"].get(
              "diffusion3d_step_exchange") == 1,
          "audit_model impl='cuda': one K4, K9 and K10 step recorded")

    # run_resilient(audit=True) on the 256^3 mesh, against the same run unaudited
    grid(tg, N_MAIN, N_MAIN, N_MAIN, dimx=2, dimy=2, dimz=2, periodx=1)
    T0, Cp, p = models.init_diffusion3d(dtype=torch.float32)
    step_T = models.make_step(p)

    def step(st):
        return {"T": step_T(st["T"], st["Cp"]), "Cp": st["Cp"]}

    step({"T": T0, "Cp": Cp})  # warm: the route's first call
    chunk_ms = {}
    with tempfile.TemporaryDirectory(prefix="igg_audit_") as d:
        for label, audit in (("unaudited", False), ("audited", True), ("unaudited_2", False)):
            fr = os.path.join(d, f"{label}.jsonl")
            tg.start_flight_recorder(fr)
            cb.reset_launch_counts()
            out, reps = tg.run_resilient(step, {"T": T0, "Cp": Cp}, AUDIT_STEPS,
                                         nt_chunk=AUDIT_CHUNK, audit=audit)
            torch.cuda.synchronize()
            tg.stop_flight_recorder()
            c = cb.launch_counts()
            add(c)
            evs = tg.read_flight_events(fr)
            chunk_ms[label] = _chunk_ms(evs)
            if audit:
                audits = [e for e in evs if e["kind"] == "audit"]
                check(len(audits) == 1 and audits[0]["ok"] and audits[0]["program"] == "chunk",
                      f"run_resilient(audit=True): exactly one clean audit event "
                      f"({[(a['program'], a['ok'], a['rules']) for a in audits]})")
                check(c["diffusion3d_step_exchange"] == AUDIT_STEPS,
                      f"run_resilient(audit=True): K4 once a step "
                      f"({c['diffusion3d_step_exchange']} launches, {AUDIT_STEPS} steps)")
                rec["supervised_audit"] = dict(
                    audit_s=audits[0].get("audit_s"), collectives=audits[0]["collectives"],
                    k4_launches=c["diffusion3d_step_exchange"])
                T_aud = out["T"]
            else:
                T_ref = out["T"]
            del out
    check(torch.equal(T_aud, T_ref), "run_resilient(audit=True): T bitwise the unaudited run's")
    rec["supervised_audit"]["chunk_ms"] = chunk_ms
    print(f"  supervised run, audit: {json.dumps(rec['supervised_audit'])}", flush=True)
    del T_aud, T_ref, T0, Cp
    tg.finalize_global_grid()

    # the resize: device, checkpoint, never
    cb.reset_launch_counts()
    G_ref, _, _ = _resized_run(tg, models, None)
    G_dev, r_dev, ev_dev = _resized_run(tg, models, "device", audit=True)
    with tempfile.TemporaryDirectory(prefix="igg_resize_ck_") as d:
        G_ckp, r_ckp, ev_ckp = _resized_run(tg, models, "checkpoint", ckpt=d)
    add(cb.launch_counts())
    check(np.array_equal(G_dev, G_ref) and np.array_equal(G_ckp, G_ref),
          f"resize 2x2x2 -> {RESIZE_DIMS}: the device path, the checkpoint path and the "
          "unresized run end with bitwise equal gathered interiors")
    del G_dev, G_ckp, G_ref
    aud = [e for e in ev_dev if e["kind"] == "audit" and e.get("program") == "reshard"]
    check(r_dev["via"] == "device" and r_dev["rounds"] > 0 and len(aud) == 1 and aud[0]["ok"],
          f"resize via='device': the device path ({r_dev['via']}), {r_dev.get('rounds')} "
          f"rounds, one clean reshard audit ({[(a['ok'], a['rules']) for a in aud]})")
    check(r_ckp["via"] == "checkpoint", "resize via='checkpoint': the checkpoint path")
    # the plan again, on the source grid, for its price
    grid(tg, N_MAIN, N_MAIN, N_MAIN, dimx=2, dimy=2, dimz=2, periodx=1)
    T0, Cp, p = models.init_diffusion3d(dtype=torch.float32)
    plan = build_reshard_plan(live_topology(), RESIZE_DIMS,
                              fields_of_state({"T": T0, "Cp": Cp}))
    pred = tg.predict_reshard(plan)
    # the move's copies alone (no grid swap, no plan): their wall ms, their
    # launches and the bytes bound (each cell read once and written once)
    program = compile_reshard_program(plan)
    copies = sum(len(sig.names) * (sum(len(r[2]) for r in rounds) + len(local))
                 for sig, _, rounds, local in program.sigs)
    copy_ms = median_ms(lambda: program({"T": T0, "Cp": Cp}), batches=5, per_batch=2, warm=1)
    del T0, Cp
    tg.finalize_global_grid()
    rec["resize"] = dict(
        dims=[[2, 2, 2], list(RESIZE_DIMS)], grid=f"2x2x2 x {N_MAIN}^3 float32 (T, Cp)",
        device_ms=r_dev["seconds"] * 1e3, checkpoint_ms=r_ckp["seconds"] * 1e3,
        rounds=r_dev["rounds"], wire_bytes=r_dev["wire_bytes"],
        local_bytes=r_dev["local_bytes"], peak_payload_bytes=r_dev["peak_payload_bytes"],
        payload_bytes=plan.payload_bytes, state_bytes=plan.dst_bytes,
        copies_ms=copy_ms, copies=copies,
        copies_bound_ms=2 * plan.dst_bytes / HBM_BYTES_PER_S * 1e3,
        predicted_s=pred["seconds"], predicted=dict(pred),
        device_over_predicted=r_dev["seconds"] / pred["seconds"],
        checkpoint_over_device=r_ckp["seconds"] / r_dev["seconds"])
    print(f"  resize: {json.dumps(rec['resize'])}", flush=True)

    # config 4's staggered state in one move, against the host oracle
    grid(tg, N_CFG4, N_CFG4, N_CFG4, dimx=2, dimy=2, dimz=2, periodx=1, periody=1, periodz=1)
    s0, p = models.init_acoustic3d(dtype=torch.float32)
    s1 = models.run_acoustic(s0, p, 10, nt_chunk=10)
    state = dict(zip(("P", "Vx", "Vy", "Vz"), s1))
    del s0, s1
    host = {k: v.cpu().numpy() for k, v in state.items()}
    plan4 = build_reshard_plan(live_topology(), RESIZE_DIMS, fields_of_state(state))
    expect = apply_plan_host(plan4, host)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new, info = tg.reshard_state(state, RESIZE_DIMS, audit=True)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    same = all(new[k].device.type == "cuda" and np.array_equal(new[k].cpu().numpy(), expect[k])
               for k in state)
    check(same and info["audit_report"].ok,
          f"config 4's (P, Vx, Vy, Vz) resharded to {RESIZE_DIMS} in one move: bitwise "
          "apply_plan_host on the card, the move's audit ok")
    rec["reshard_config4"] = dict(
        ms_with_audit=ms, rounds=info["rounds"], wire_bytes=info["wire_bytes"],
        local_bytes=info["local_bytes"], peak_payload_bytes=info["peak_payload_bytes"],
        sigs=len(plan4.sigs), predicted_s=tg.predict_reshard(plan4)["seconds"])
    print(f"  reshard config 4: {json.dumps(rec['reshard_config4'])}", flush=True)
    del new, state, host, expect
    tg.finalize_global_grid()
    return counts, rec


SERVICE_STEPS = 100  # each tenant's steps (config 5: iterations)
SERVICE_CHUNK = 25
SERVICE_POKE_STEP = 50  # config 5's NaN: the step, in P at the centre of block 0
SERVICE_DEADLINE_S = 3600.0  # every tenant is priced at admission and admits
SERVICE_DEVICE_TYPE = "gpu"  # the tenants' grids (a CPU rehearsal sets "cpu")
SERVICE_SWITCHES = 300  # context switches timed after the run


def _service_specs(tg, ck_dir):
    """The phase's three `JobSpec`s: the builtin setups at the meshes the
    earlier phases run, float32, on the plain route."""
    svc = tg.service
    specs = []
    for name, model, n, kw in (("diffusion", "diffusion3d", N_MAIN, dict(periodx=1)),
                               ("config4", "acoustic3d", N_CFG4,
                                dict(periodx=1, periody=1, periodz=1)),
                               ("config5", "stokes3d", N_CFG5, {})):
        run = dict(nt_chunk=SERVICE_CHUNK)
        if name == "config5":
            run.update(checkpoint_dir=ck_dir, checkpoint_every=SERVICE_STEPS,
                       faults=(tg.NaNPoke(step=SERVICE_POKE_STEP, name="P",
                                          index=(N_CFG5 // 2,) * 3),))
        specs.append(svc.JobSpec(
            name=name, setup=svc.builtin_setup(model, "float32"), nt=SERVICE_STEPS,
            grid=dict(nx=n, ny=n, nz=n, dimx=2, dimy=2, dimz=2,
                      device_type=SERVICE_DEVICE_TYPE, **kw),
            run=tg.RunSpec(**run), model=model, deadline_s=SERVICE_DEADLINE_S))
    return specs


def _executed_steps(tg, path):
    """Steps a job's flight stream says it ran (the replayed ones too)."""
    return sum(int(e["n"]) for e in tg.read_flight_events(path) if e["kind"] == "chunk")


def _sub(a, b):
    return {k: a.get(k, 0) - b.get(k, 0) for k in a}


def _solo_service_run(tg, cb, spec, d):
    """``spec`` alone: one step's launches (on a state of its own), then its
    setup and `run_resilient` of the setup's state under the spec's RunSpec
    with a flight recorder, timed. Returns (final state, wall s, launches of
    setup + run, setup launches, a step's launches, steps run, the gathered
    interior of T or None)."""
    import torch

    grid(tg, **spec.grid)
    step, state = spec.setup()
    c0 = cb.launch_counts()
    step(state)
    torch.cuda.synchronize()
    per_step = _sub(cb.launch_counts(), c0)
    del step, state
    cb.reset_launch_counts()
    fr = os.path.join(d, f"solo_{spec.name}.jsonl")
    tg.start_flight_recorder(fr)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        step, state = spec.setup()
        setup_launches = cb.launch_counts()
        out, _ = tg.run_resilient(step, state, spec.nt, spec=spec.run)
        torch.cuda.synchronize()
    finally:
        tg.stop_flight_recorder()
    wall = time.perf_counter() - t0
    launches = cb.launch_counts()
    G = tg.gather_interior(out["T"]) if "T" in out else None
    tg.finalize_global_grid()
    return out, wall, launches, setup_launches, per_step, _executed_steps(tg, fr), G


def _grant_to_chunk(tg, d, names):
    """Per slice that ran a chunk (not its job's admission slice): ms from
    the grant to the chunk's start, and the slice's ms beside its chunk's
    (the journal and the job streams share one monotonic clock)."""
    journal = tg.read_flight_events(os.path.join(d, "scheduler.jsonl"))
    chunks = {n: [e for e in tg.read_flight_events(os.path.join(d, f"job_{n}.jsonl"))
                  if e["kind"] == "chunk"] for n in names}
    seen, grant, over = set(), [], []
    for e in journal:
        if e["kind"] != "slice":
            continue
        t1 = float(e["t"])
        t0 = t1 - float(e["dur_s"])
        first = e["job"] not in seen
        seen.add(e["job"])
        mine = [c for c in chunks[e["job"]]
                if t0 <= float(c["t"]) - float(c["exec_s"]) - float(c["build_s"]) <= t1]
        if first or not mine:
            continue
        start = float(mine[0]["t"]) - float(mine[0]["exec_s"]) - float(mine[0]["build_s"])
        grant.append((start - t0) * 1e3)
        over.append((t1 - t0 - sum(float(c["exec_s"]) + float(c["build_s"]) for c in mine))
                    * 1e3)
    return grant, over


def _ms_stats(xs):
    return None if not xs else dict(median=statistics.median(xs), min=min(xs), max=max(xs),
                                    n=len(xs))


def phase_service(tg, models, cb):
    """Phase 13f: the service and the live plane (see the module
    docstring). Returns (launches, record); the record is the ``service``
    line."""
    import tempfile

    import numpy as np
    import torch
    from implicitglobalgrid_tpu_torch.parallel import topology as top
    from implicitglobalgrid_tpu_torch.telemetry.recorder import use_flight_recorder

    svc = tg.service
    card = card_name()
    print(f"phase: the service and the live plane; card {card}", flush=True)
    counts = {k: 0 for k in KERNEL_NAMES}

    def add(c):
        for k in counts:
            counts[k] += c.get(k, 0)

    rec = {"card": card, "tenants": {}}
    with tempfile.TemporaryDirectory(prefix="igg_service_") as root:
        names = ("diffusion", "config4", "config5")
        # each tenant alone: the bitwise reference, the launches, the wall
        solo = {}
        for spec in _service_specs(tg, os.path.join(root, "ck_solo")):
            out, wall, launches, setup_l, per_step, steps, G = _solo_service_run(
                tg, cb, spec, root)
            solo[spec.name] = dict(state=out, wall_s=wall, launches=launches,
                                   setup=setup_l, per_step=per_step, steps=steps, G=G)
            print(f"  solo {spec.name}: {wall:.3f} s, {steps} steps", flush=True)

        # the three tenants interleaved
        d = os.path.join(root, "flight")
        ops = os.path.join(root, "operator")
        ctxs = {n: tg.TraceContext.new() for n in names}
        sink = tg.ControlFileSink(svc.DirectoryBackend(ops), rules=("guard_trip_storm",))
        by_job = {n: {k: 0 for k in KERNEL_NAMES} for n in names}
        poll_ms, price_ms = [], []
        cb.reset_launch_counts()
        with svc.MeshScheduler(policy="fair", flight_dir=d, alerts=tg.default_rule_pack(),
                               alert_sinks=[sink], nranks=8) as sched:
            price = sched._price_admission

            def timed_price(*a, **k):
                t = time.perf_counter()
                try:
                    return price(*a, **k)
                finally:
                    price_ms.append((time.perf_counter() - t) * 1e3)

            sched._price_admission = timed_price
            for spec in _service_specs(tg, os.path.join(root, "ck_sched")):
                sched.submit(spec, trace=ctxs[spec.name])
            live = tg.LiveAggregate(d)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            polled = 0.0
            while True:
                slices = {n: j.slices for n, j in sched.jobs.items()}
                c0 = cb.launch_counts()
                if not sched.step():
                    break
                c1 = cb.launch_counts()
                who = [n for n, j in sched.jobs.items() if j.slices != slices[n]]
                if len(who) != 1:
                    raise SmokeFailure(f"a slice advanced {who}, not one tenant")
                for k, v in _sub(c1, c0).items():
                    by_job[who[0]][k] += v
                tp = time.perf_counter()
                live.poll()
                poll_ms.append((time.perf_counter() - tp) * 1e3)
                polled += poll_ms[-1] / 1e3
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0 - polled
            add(cb.launch_counts())
            check(sched.status()["states"] == {"done": 3},
                  f"the three tenants done ({sched.status()['states']})")
            for n in names:
                got, ref = sched.job(n).result, solo[n]["state"]
                check(got.keys() == ref.keys() and all(
                    got[k].device.type == ref[k].device.type and torch.equal(got[k], ref[k])
                    for k in ref),
                    f"tenant {n}: final state bitwise its solo run_resilient")
            trips = {n: sum(1 for r in sched.job(n).reports if not r.ok) for n in names}
            check(trips == {"diffusion": 0, "config4": 0, "config5": 1},
                  f"the NaN poke tripped config 5's guard only ({trips})")
            # the context switch alone: the grid swap and the recorder slot
            jobs = [sched.job(n) for n in names]
            sw = []
            for i in range(SERVICE_SWITCHES):
                j = jobs[i % 3]
                t = time.perf_counter()
                prev = top.swap_global_grid(j.gg)
                with use_flight_recorder(j.recorder):
                    pass
                top.swap_global_grid(prev)
                sw.append((time.perf_counter() - t) * 1e3)
            rec["slices"] = sched.slices
            del jobs
        live.poll()
        snap = live.snapshot()

        # launches: each tenant its solo run's; setup + steps run x a step's
        for n in names:
            s = solo[n]
            steps = _executed_steps(tg, os.path.join(d, f"job_{n}.jsonl"))
            want = {k: s["setup"].get(k, 0) + steps * s["per_step"].get(k, 0)
                    for k in KERNEL_NAMES}
            ex = {k: v for k, v in by_job[n].items() if k in EXCHANGE_KERNELS and v}
            check(bool(ex) and by_job[n] == s["launches"] == want,
                  f"tenant {n}: exchange launches {ex} non-zero, its solo run's "
                  f"({ {k: v for k, v in s['launches'].items() if v} }), and setup + "
                  f"{steps} steps x {({k: v for k, v in s['per_step'].items() if v})} a step")
            rec["tenants"][n] = dict(
                steps_run=steps, launches={k: v for k, v in by_job[n].items() if v},
                per_step={k: v for k, v in s["per_step"].items() if v},
                solo_wall_s=s["wall_s"], guard_trips=trips[n])

        # the alert and its control file
        journal = tg.read_flight_events(os.path.join(d, "scheduler.jsonl"))
        alerts = [(e["rule"], e.get("job"), e["state"]) for e in journal if e["kind"] == "alert"]
        check(("guard_trip_storm", "config5", "firing") in alerts,
              f"the alert engine fired on config 5's trip ({alerts})")
        filed = svc.DirectoryBackend(ops).poll_control()
        check({"request": "cancel", "job": "config5"} in [
            {k: r[k] for k in ("request", "job")} for r in filed],
            f"the control file records it ({filed})")
        rep = tg.run_report(d)
        for n in names:
            j, r = snap["jobs"][n], rep["jobs"][n]
            check(j["state"] == r["state"] == "done" and j["slices"] == r["slices"]
                  and j["step"] == r["step"] == SERVICE_STEPS
                  and j["guard_trips"] == r["report"]["guards"]["trips"] == trips[n],
                  f"tenant {n}: the live snapshot agrees with service_report (state, slices, "
                  f"steps, guard trips: {[j[k] for k in ('state', 'slices', 'step', 'guard_trips')]})")
        check(snap["scheduler"]["slices"] == rep["slices"] == rec["slices"],
              "the live snapshot's slices are the report's")
        t = time.perf_counter()
        doc = tg.export_otlp(d)
        otlp_ms = (time.perf_counter() - t) * 1e3
        spans = [sp for rs in doc["resourceSpans"] for ss in rs["scopeSpans"]
                 for sp in ss["spans"]]
        for n, ctx in ctxs.items():
            mine = [sp for sp in spans if sp["traceId"] == ctx.trace_id]
            ids = {sp["spanId"] for sp in mine}
            kinds = {sp["name"] for sp in mine}
            check(all(sp.get("parentSpanId") in ids | {ctx.span_id} for sp in mine)
                  and {"job_submitted", "slice", "chunk", "job_done"} <= kinds,
                  f"export_otlp: tenant {n}'s spans form one tree under its submitted context "
                  f"({len(mine)} spans)")
        check({sp["traceId"] for sp in spans} == {c.trace_id for c in ctxs.values()},
              "export_otlp: one trace a tenant")
        grant, over = _grant_to_chunk(tg, d, names)

        # the autoscale drill: the diffusion tenant shrinks by one axis
        d2 = os.path.join(root, "drill")
        spec = _service_specs(tg, None)[0]
        pol = svc.AutoscalePolicy(shrink_queue_pending=0, hysteresis_slices=1,
                                  cooldown_slices=0,
                                  bounds={"diffusion": svc.ScaleBounds(4, 8)})
        cb.reset_launch_counts()
        with svc.MeshScheduler(policy="fair", flight_dir=d2, autoscale=pol, nranks=8) as s2:
            s2.submit(spec)
            s2.run()
            add(cb.launch_counts())
            job = s2.job("diffusion")
            check(job.state == "done", f"the drill's tenant done ({job.error})")
            dims = tuple(int(x) for x in job.gg.dims)
            prev = top.swap_global_grid(job.gg)
            try:
                G = tg.gather_interior(job.result["T"])
            finally:
                top.swap_global_grid(prev)
            dec = list(s2.autoscaler.decision_s_recent)
        check(sorted(dims) == [1, 2, 2] and np.array_equal(G, solo["diffusion"]["G"]),
              f"autoscale drill: the diffusion tenant shrank 2x2x2 -> {dims}, gathered "
              "interior bitwise the unresized run's")
        del G
        expl = svc.explain_autoscale(d2)
        moves = [m for m in expl["moves"] if m["applied"]]
        resized = [e for e in tg.read_flight_events(os.path.join(d2, "scheduler.jsonl"))
                   if e["kind"] == "job_resized"]
        check(len(moves) == 1 and moves[0]["action"] == "shrink"
              and moves[0]["new_dims"] == list(dims) and resized
              and resized[0]["via"] == "device",
              f"explain_autoscale names the move ({[(m['action'], m['new_dims'], m['chain']) for m in moves]}), "
              f"on the device path ({[e['via'] for e in resized]})")
        rec.update(
            interleaved_wall_s=wall, solo_wall_sum_s=sum(solo[n]["wall_s"] for n in names),
            switches=rep["switches"], grant_to_chunk_ms=_ms_stats(grant),
            slice_minus_chunk_ms=_ms_stats(over), context_switch_ms=_ms_stats(sw),
            admission_price_ms=price_ms, live_poll_ms=_ms_stats(poll_ms),
            otlp_ms=otlp_ms, otlp_spans=len(spans), alerts=alerts,
            control_filed=[{k: r[k] for k in ("request", "job")} for r in filed],
            autoscale=dict(decision_ms=_ms_stats([x * 1e3 for x in dec]),
                           move=dict(action=moves[0]["action"], dims=moves[0]["dims"],
                                     new_dims=moves[0]["new_dims"], chain=moves[0]["chain"]),
                           resize_ms=float(resized[0]["dur_s"]) * 1e3,
                           rounds=resized[0].get("rounds"), decisions=expl["decisions"]))
        rec["interleaved_over_solo_sum"] = rec["interleaved_wall_s"] / rec["solo_wall_sum_s"]
        del solo, sched, s2
    print(f"  service: {json.dumps(rec)}", flush=True)
    return counts, rec


SERVE_STEPS = 20  # h1's steps (and its CLI twin's), in chunks of SERVE_CHUNK
SERVE_CHUNK = 5
SERVE_SNAPSHOT_EVERY = 10
SERVE_H2_STEPS = 20
SERVE_H3_STEPS = 2000  # cancelled over HTTP long before its end
SERVE_DEVICE_TYPE = "gpu"  # the jobs' and commands' device (a CPU rehearsal sets "cpu")
SERVE_CACHE_BYTES = 2 << 30  # the query server's LRU: the whole T field fits
SERVE_CLI_NX = 128  # the local block of the CLI's self-initialized grids
SERVE_CLI_TIMEOUT = 300  # seconds, for each command
SERVE_TERMINAL = ("done", "failed", "cancelled", "rejected")


def _http(method, url, payload=None):
    """(status, body bytes, headers) of one request; HTTP errors are
    answers, not exceptions."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    if method == "POST" and data is None:
        data = b""
    req = urllib.request.Request(url, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def _serve_record(name, model, n, nt, run, **grid_kw):
    """One queue-JSON job record (the schema of ``POST /v1/jobs`` and ``tools
    jobs submit``) on a 2x2x2 mesh of ``n``³ blocks, float32."""
    grid = dict(nx=n, ny=n, nz=n, dimx=2, dimy=2, dimz=2, **grid_kw)
    if SERVE_DEVICE_TYPE == "cpu":
        grid["device_type"] = "cpu"
    return {"name": name, "model": model, "nt": nt, "dtype": "float32", "grid": grid,
            "run": dict(nt_chunk=SERVE_CHUNK, **run)}


def _cli_commands(root, cmds):
    """Run each ``(name, argv)`` of ``cmds`` as ``python -m
    implicitglobalgrid_tpu_torch.tools`` in a subprocess, all at once;
    returns {name: (exit code, stdout, stderr, seconds to its exit)}. Every
    process is ended before this returns."""
    here = os.path.dirname(os.path.abspath(__file__))
    tools = [sys.executable, "-W", "ignore", "-m", "implicitglobalgrid_tpu_torch.tools"]
    procs, ended = {}, {}
    t0 = time.perf_counter()
    try:
        for i, (name, argv) in enumerate(cmds):
            out, err = (open(os.path.join(root, f"cli_{i}.{k}"), "w+") for k in ("out", "err"))
            procs[name] = (subprocess.Popen(tools + argv, cwd=here, stdout=out, stderr=err,
                                            text=True), out, err)
        while len(ended) < len(procs) and time.perf_counter() - t0 < SERVE_CLI_TIMEOUT:
            for name, (p, _, _) in procs.items():
                if name not in ended and p.poll() is not None:
                    ended[name] = time.perf_counter() - t0
            time.sleep(0.05)
    finally:
        for p, _, _ in procs.values():
            if p.poll() is None:
                p.kill()
            p.wait()
    res = {}
    for name, (p, out, err) in procs.items():
        out.seek(0)
        err.seek(0)
        res[name] = (p.returncode, out.read(), err.read(), ended.get(name, float("inf")))
        out.close()
        err.close()
    return res


def _cli_checked(res, name, want=0):
    rc, stdout, stderr, sec = res[name]
    check(rc == want, f"tools {name}: exit code {rc} (want {want}) in {sec:.1f} s"
          + ("" if rc == want else f"; stderr tail: {stderr[-1500:]}"))
    return stdout


def _events(url):
    lines = [json.loads(x) for x in _http("GET", url)[1].splitlines()]
    return [e for e in lines if e["kind"] != "heartbeat"], lines[-1]


def phase_serve(tg, models, cb):
    """Phase 13g: serve and the CLI (see the module docstring). Returns
    (launches, record); the record is the ``serve`` line."""
    import io
    import tempfile

    import numpy as np
    import torch
    from implicitglobalgrid_tpu_torch.parallel import topology as top

    svc = tg.service
    card = card_name()
    print(f"phase: serve and the CLI; card {card}", flush=True)
    names = ("h1", "h2", "h3")
    cpu = ["--cpu"] if SERVE_DEVICE_TYPE == "cpu" else []
    rec = {"card": card}
    with tempfile.TemporaryDirectory(prefix="igg_serve_") as root:
        d = os.path.join(root, "svc")
        snaps = {k: os.path.join(root, f"snaps_{k}") for k in ("http", "cli")}

        def h1(snapdir):
            return _serve_record("h1", "diffusion3d", N_MAIN, SERVE_STEPS, dict(
                snapshot_dir=snapdir, snapshot_every=SERVE_SNAPSHOT_EVERY,
                snapshot_fields=["T"]), periodx=1)

        records = [h1(snaps["http"]),
                   _serve_record("h2", "acoustic3d", N_CFG4, SERVE_H2_STEPS, {},
                                 periodx=1, periody=1, periodz=1),
                   _serve_record("h3", "diffusion3d", N_MAIN, SERVE_H3_STEPS, {}, periodx=1)]
        by_job = {n: {k: 0 for k in KERNEL_NAMES} for n in names}
        with tg.JobApiServer(d) as api:
            u = f"http://{api.host}:{api.port}"
            # -- part 1: jobs over HTTP under a live scheduler ----------------
            with svc.MeshScheduler(policy="round_robin", flight_dir=d, nranks=8) as sched:
                cb.reset_launch_counts()
                code, body, _ = _http("POST", u + "/v1/jobs", {"jobs": records})
                t_posted = time.monotonic()
                check(code == 202 and json.loads(body)["submitted"] == list(names),
                      f"POST /v1/jobs: 202, three records enqueued ({code})")
                requested, polls, states = [], 0, {}
                for _ in range(100000):
                    slices = {n: j.slices for n, j in sched.jobs.items()}
                    c0 = cb.launch_counts()
                    progressed = sched.step()
                    grown = _sub(cb.launch_counts(), c0)
                    who = [n for n, j in sched.jobs.items() if j.slices != slices.get(n, 0)]
                    if any(grown.values()):
                        if len(who) != 1:
                            raise SmokeFailure(f"launches in a step of {who}, not one job")
                        for k, v in grown.items():
                            by_job[who[0]][k] += v
                    jobs = json.loads(_http("GET", u + "/v1/jobs")[1])["jobs"]
                    states = {n: j["state"] for n, j in jobs.items()}
                    polls += 1
                    if "resize" not in requested and states.get("h2") == "running":
                        code, body, _ = _http("POST", u + "/v1/jobs/h2/resize",
                                              {"new_dims": [2, 2, 1]})
                        check(code == 202, f"POST /v1/jobs/h2/resize: {code}")
                        requested.append("resize")
                    if "cancel" not in requested and states.get("h3") == "running" \
                            and (jobs["h3"].get("step") or 0) > 0:
                        code, body, _ = _http("POST", u + "/v1/jobs/h3/cancel")
                        check(code == 202 and "discarded" not in json.loads(body),
                              f"POST /v1/jobs/h3/cancel of the running job: {code}")
                        requested.append("cancel")
                    if len(states) == 3 and all(v in SERVE_TERMINAL for v in states.values()):
                        break
                    if not progressed:
                        raise SmokeFailure(f"the scheduler idles with jobs {states}")
                check(states == {"h1": "done", "h2": "done", "h3": "cancelled"},
                      f"/v1/jobs after {polls} polls: h1 and h2 done, h3 cancelled ({states})")
                h2, h3 = sched.job("h2"), sched.job("h3")
                check(tuple(int(x) for x in h2.gg.dims) == (2, 2, 1)
                      and 0 < h3.run.step < SERVE_H3_STEPS,
                      f"h2 resized over HTTP to {tuple(int(x) for x in h2.gg.dims)}, h3 "
                      f"cancelled at step {h3.run.step} of {SERVE_H3_STEPS}")
                job = sched.job("h1")
                prev = top.swap_global_grid(job.gg)
                try:
                    G1 = tg.gather_interior(job.result["T"])
                finally:
                    top.swap_global_grid(prev)
                torch.cuda.synchronize()
            journal = tg.read_flight_events(os.path.join(d, "scheduler.jsonl"))
            admitted = {e["job"]: (float(e["t"]) - t_posted) * 1e3 for e in journal
                        if e["kind"] == "job_admitted"}
            resized = [e for e in journal if e["kind"] == "job_resized"]
            check(set(admitted) == set(names) and len(resized) == 1
                  and resized[0]["job"] == "h2" and resized[0]["via"] == "device",
                  f"the journal: three admissions, h2's resize on the device path "
                  f"({[(e['job'], e['via']) for e in resized]})")
            want = {"h1": ("exchange_slabs", "halo_write_combined"),
                    "h3": ("exchange_slabs", "halo_write_combined"),
                    "h2": ("exchange_slabs", "halo_write_combined", "wire_pack",
                           "halo_write_multi")}
            for n in names:
                got = {k: v for k, v in by_job[n].items() if v}
                check(all(by_job[n][k] > 0 for k in want[n]),
                      f"job {n} over HTTP launched {want[n]} ({got})")
            counts = {k: sum(by_job[n][k] for n in names) for k in KERNEL_NAMES}
            rec.update(submit_to_admission_ms=admitted, polls=polls,
                       launches={n: {k: v for k, v in by_job[n].items() if v} for n in names},
                       h3_cancelled_at_step=h3.run.step, h2_resize_ms=float(resized[0]["dur_s"]) * 1e3)
            del job, h2, h3, sched

            # -- part 2: sub-box reads through the query server ---------------
            path = dict(tg.list_snapshots(snaps["http"])).get(SERVE_STEPS)
            check(path is not None, f"h1 committed its step-{SERVE_STEPS} snapshot")
            ref = tg.open_snapshot(path)
            gs = ref.global_shape("T")
            whole = ref.read_global("T")
            check(np.array_equal(whole, G1), "h1's last snapshot bitwise its final state")
            del G1
            pt = tuple(s // 3 for s in gs)
            boxes = {"point": tuple((i, i + 1) for i in pt),
                     "z_plane": ((0, gs[0]), (0, gs[1]), (gs[2] // 2, gs[2] // 2 + 1)),
                     "whole": None}
            queries = {}
            with tg.SnapshotQueryServer(snaps["http"], cache_bytes=SERVE_CACHE_BYTES) as q:
                uq = f"http://{q.host}:{q.port}"
                listing = json.loads(_http("GET", uq + "/v1/snapshots")[1])
                check([s["step"] for s in listing["snapshots"]]
                      == list(range(SERVE_SNAPSHOT_EVERY, SERVE_STEPS + 1, SERVE_SNAPSHOT_EVERY))
                      and listing["snapshots"][-1]["global_shapes"]["T"] == list(gs),
                      f"GET /v1/snapshots lists h1's snapshots ({len(listing['snapshots'])})")
                for name, box in boxes.items():
                    expect = whole if box is None else ref.read_global("T", box)
                    buf = io.BytesIO()
                    np.save(buf, expect)
                    want_bytes = buf.getvalue()
                    query = "" if box is None else "?box=" + ",".join(f"{a}:{b}" for a, b in box)
                    q.cache.clear()
                    got = {}
                    for how in ("cold", "cached"):
                        t0 = time.perf_counter()
                        code, body, hdrs = _http("GET", uq + f"/v1/snapshots/{SERVE_STEPS}/T"
                                                 + query)
                        dt = time.perf_counter() - t0
                        check(code == 200 and body == want_bytes,
                              f"query {name} ({how}): {len(body)} bytes byte-identical to "
                              "read_global")
                        got[how] = (dt, int(hdrs["X-IGG-Cache-Hits"]))
                    blocks = got["cached"][1]
                    check(got["cold"][1] == 0 and blocks > 0,
                          f"query {name}: cold read 0 cache hits, second read {blocks} "
                          "block(s) from the LRU")
                    mb = len(want_bytes) / 1e6
                    queries[name] = dict(bytes=len(want_bytes), blocks=blocks,
                                         cold_ms=got["cold"][0] * 1e3,
                                         cached_ms=got["cached"][0] * 1e3,
                                         cold_MBps=mb / got["cold"][0],
                                         cached_MBps=mb / got["cached"][0])
                code, body, _ = _http("GET", uq + f"/v1/snapshots/{SERVE_STEPS}/T?point="
                                      + ",".join(map(str, pt)))
                check(code == 200 and json.loads(body)["value"] == float(whole[pt]),
                      "query ?point= equals read_global's cell")
                st = q.cache.stats()
            rec.update(queries=queries, cache=st,
                       cache_hit_rate=st["hits"] / max(1, st["hits"] + st["misses"]))
            del whole

            # -- part 3: the observe endpoints --------------------------------
            poll_ms = []
            for _ in range(5):
                t0 = time.perf_counter()
                code, body, _ = _http("GET", u + "/v1/observe")
                poll_ms.append((time.perf_counter() - t0) * 1e3)
            snap = json.loads(body)
            check(code == 200 and {n: snap["jobs"][n]["state"] for n in names}
                  == {"h1": "done", "h2": "done", "h3": "cancelled"},
                  "GET /v1/observe: the three jobs' states")
            full, last = _events(u + "/v1/events?since=-1&timeout_s=0.5")
            seqs = [e["live_seq"] for e in full]
            check(seqs == list(range(len(seqs))) and last.get("done")
                  and last["cursor"] == seqs[-1] == snap["cursor"],
                  f"GET /v1/events: {len(seqs)} events, live_seq 0..{seqs[-1]}")
            half, hb = _events(u + f"/v1/events?since=-1&max_events={len(seqs) // 2}&timeout_s=5")
            rest, _ = _events(u + f"/v1/events?since={hb['cursor']}&timeout_s=0.5")
            resumed = [e["live_seq"] for e in half + rest]
            check(resumed == seqs, f"the stream resumed from since={hb['cursor']}: "
                  f"{len(half)} + {len(rest)} events, no gap, no duplicate")
            rec.update(observe_poll_ms=_ms_stats(poll_ms), events=len(seqs))

        # -- part 4: the CLI on the card ------------------------------------------
        queue = os.path.join(root, "queue.json")
        with open(queue, "w") as f:
            json.dump({"policy": "fifo", "jobs": [h1(snaps["cli"])]}, f)
        prof = os.path.join(root, "profile.json")
        step_cell = [str(i) for i in pt]
        res = _cli_commands(root, [
            ("jobs submit", ["jobs", "submit", queue, "--flight-dir",
                             os.path.join(root, "cli_svc")] + cpu),
            ("calibrate", ["calibrate", "--out", prof] + cpu),
            ("audit", ["audit", "diffusion3d", "acoustic3d", "stokes3d", "--json"] + cpu),
            ("reshard run", ["reshard", "run", "--src-dims", "2,2,2", "--dst-dims", "4,2,1",
                             "--nx", str(SERVE_CLI_NX), "--json"] + cpu),
            ("snapshots", ["snapshots", snaps["http"]]),
            ("probe", ["probe", snaps["http"], "T"] + step_cell),
            ("report", ["report", d, "--no-metrics"]),
            ("watch", ["watch", d, "--once"])])
        res.update(_cli_commands(root, [
            ("tune model-only", ["tune", "diffusion3d", "--profile", prof, "--nx", str(N_MAIN),
                                 "--no-measure", "--out", os.path.join(root, "t0.json")] + cpu),
            ("tune measured", ["tune", "diffusion3d", "--profile", prof, "--nx",
                               str(SERVE_CLI_NX), "--out", os.path.join(root, "t1.json")] + cpu)]))
        _cli_checked(res, "jobs submit")
        twin = tg.open_snapshot(dict(tg.list_snapshots(snaps["cli"]))[SERVE_STEPS])
        check(np.array_equal(twin.read_global("T"), ref.read_global("T")),
              "h1 over HTTP bitwise its `tools jobs submit` twin (the last snapshots)")
        cal = json.loads(_cli_checked(res, "calibrate"))
        check(os.path.exists(prof) and cal["flops_G"] > 0 and cal["membw_GBps"] > 0,
              f"calibrate: a profile ({cal['flops_G']} GFLOP/s, {cal['membw_GBps']} GB/s)")
        aud = json.loads(_cli_checked(res, "audit"))
        check(aud["ok"] and [p["name"] for p in aud["programs"]]
              == ["diffusion3d", "acoustic3d", "stokes3d"], "audit: three programs ok")
        rs = json.loads(_cli_checked(res, "reshard run"))
        check(rs["ok"] and rs["verified"], "reshard run: audited and bitwise the host oracle")
        listed = _cli_checked(res, "snapshots").splitlines()
        check(len(listed) == SERVE_STEPS // SERVE_SNAPSHOT_EVERY, f"snapshots: {len(listed)} lines")
        probed = _cli_checked(res, "probe").splitlines()
        check(probed[-1] == f"{SERVE_STEPS} {float(ref.read_global('T', boxes['point'])[0, 0, 0])!r}",
              f"probe: the cell's series ({probed})")
        rep = json.loads(_cli_checked(res, "report"))
        check({n: rep["jobs"][n]["state"] for n in names}
              == {"h1": "done", "h2": "done", "h3": "cancelled"}, "report: the service record")
        frame = _cli_checked(res, "watch")
        check("JOB" in frame and all(n in frame for n in names), "watch --once: the jobs' frame")
        t_model = json.loads(_cli_checked(res, "tune model-only"))
        t_meas = json.loads(_cli_checked(res, "tune measured"))
        check(t_model["model"] == t_meas["model"] == "diffusion3d"
              and t_meas.get("measured_step_s") is not None,
              f"tune: model-only and measured configs (speedup {t_meas.get('speedup')})")
        rec["cli"] = {k: dict(rc=v[0], seconds=v[3]) for k, v in res.items()}
        rec["tune_measured"] = {k: t_meas.get(k) for k in ("comm_every", "wire_dtype",
                                                            "measured_step_s",
                                                            "baseline_step_s", "speedup")}
    print(f"  serve: {json.dumps(rec)}", flush=True)
    return counts, rec


def _transport_dir():
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "implicitglobalgrid_tpu_torch", "_build", "transport")


def transport_child(pid, port):
    """One of the transport phase's processes (``chip_smoke.py
    --transport-child <pid> <port>``): a gloo group of two processes on
    cuda:0, the grids split along z (``IGG_TPU_DCN_AXES=z``, each process a
    2x2x1 box), each run of the phase timed over its steps; process 0
    writes the gathered results and every process its record into
    `_transport_dir()`."""
    import dataclasses
    import shutil

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import implicitglobalgrid_tpu_torch as tg
    from implicitglobalgrid_tpu_torch import models
    from implicitglobalgrid_tpu_torch.ops import cuda_build as cb

    _load_names()

    torch.cuda.set_device(0)
    os.environ["IGG_TPU_DCN_AXES"] = "z"
    os.environ.pop("IGG_USE_PALLAS", None)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=TRANSPORT_PROCS, rank=pid)
    out, rec = _transport_dir(), {}

    def grid(n, **kw):
        tg.init_global_grid(n, n, n, dimx=2, dimy=2, dimz=2, quiet=True, init_dist=False,
                            select_device=False, **kw)
        gg = tg.global_grid()
        return dict(box=gg.box.tolist(), coords=gg.coords.tolist(),
                    backend=gg.transport.backend, staged=gg.transport.stage)

    def timed(fn, nt):
        """``fn()`` between tic and toc, with its launches and the
        transport's bytes and staging time."""
        tr = tg.global_grid().transport
        cb.reset_launch_counts()
        tr.reset_stats()
        tg.tic()
        res = fn()
        t = tg.toc()
        st = dict(tr.stats)
        return res, dict(steps=nt, step_ms=t * 1e3 / nt,
                         wire_bytes_per_step=st["wire_bytes"] / nt,
                         messages_per_step=st["messages"] / nt,
                         exchange_ms_per_step=st["exchange_s"] * 1e3 / nt,
                         staging_ms_per_step=st["staging_s"] * 1e3 / nt,
                         launches=cb.launch_counts(), k4s=cb.k4s_launch_counts())

    def save(name, a):
        if pid == 0:
            np.save(os.path.join(out, name + ".npy"), a)

    # BASELINE config 3: 20 fused steps (K4s + K4), then update_halo (K4s + K6)
    r = rec["config3"] = grid(N_CFG3, periodx=1, periody=1, periodz=1)
    T0, Cp, p = models.init_diffusion3d(dtype=torch.float64)
    models.run_diffusion(T0, Cp, p, 2, nt_chunk=2)  # warm chunk
    T, r["steps"] = timed(lambda: models.run_diffusion(T0, Cp, p, 20, nt_chunk=20), 20)
    tg.update_halo(T.clone())  # warm: the route's first call checks and plans it
    T, r["update_halo"] = timed(lambda: tg.update_halo(T), 1)
    save("config3_T", tg.gather(T))
    del T
    # the same fused steps under each wire format (the wire phase's references)
    for fmt in FUSED_WIRES:
        with wire_env(fmt):
            models.run_diffusion(T0, Cp, p, 2, nt_chunk=2)  # warm chunk
            T, r[f"wire_{fmt}"] = timed(lambda: models.run_diffusion(
                T0, Cp, p, TRANSPORT_WIRE_STEPS, nt_chunk=TRANSPORT_WIRE_STEPS),
                TRANSPORT_WIRE_STEPS)
        save(f"wire_config3_{fmt}_T", tg.gather(T))
        del T
    del T0, Cp
    tg.finalize_global_grid()
    # config 4's mesh: 10 fused acoustic steps (K4s wave modes + K9), then a
    # coalesced update_halo(P, Vx, Vy, Vz) (K8 + K7)
    r = rec["config4"] = grid(N_CFG4, periodx=1, periody=1, periodz=1)
    s0, p = models.init_acoustic3d(dtype=torch.float32)
    models.run_acoustic(s0, p, 2, nt_chunk=2)  # warm chunk
    s10, r["steps"] = timed(lambda: models.run_acoustic(s0, p, 10, nt_chunk=10), 10)
    tg.update_halo(*[a.clone() for a in s10])  # warm
    U, r["update_halo"] = timed(lambda: tg.update_halo(*[a.clone() for a in s10]), 1)
    for f, a in zip(("P", "Vx", "Vy", "Vz"), U):
        save(f"config4_{f}", tg.gather(a))
    for fmt in FUSED_WIRES:  # the coalesced update_halo under each wire format
        tg.update_halo(*[a.clone() for a in s10], wire_dtype=fmt)  # warm
        U, r[f"update_halo_{fmt}"] = timed(
            lambda: tg.update_halo(*[a.clone() for a in s10], wire_dtype=fmt), 1)
        for f, a in zip(("P", "Vx", "Vy", "Vz"), U):
            save(f"wire_config4_{fmt}_{f}", tg.gather(a))
    del s0, s10, U
    tg.finalize_global_grid()
    # config 5's mesh: 20 Stokes iterations (K4s Stokes modes + K10), residuals
    r = rec["config5"] = grid(N_CFG5)
    s0, p = models.init_stokes3d(dtype=torch.float32)
    models.run_stokes(s0, p, 2, nt_chunk=2)  # warm chunk
    s20, r["steps"] = timed(lambda: models.run_stokes(s0, p, 20, nt_chunk=20), 20)
    res = models.stokes_residuals(s20, p)
    r["residuals"] = list(res)
    for f, a in zip(("P", "Vx", "Vy", "Vz"), s20[:4]):
        save(f"config5_{f}", tg.gather_interior(a))
    save("config5_residuals", np.array(res))
    tg.finalize_global_grid()
    # the README run's mesh (periodic x): 10 plain-route diffusion steps
    # without and with overlap=True, then 10 at comm_every=2 on the
    # halowidth-2 grid (its halos first set to what they mirror)
    r = rec["diffusion_overlap"] = grid(N_MESH, periodx=1)
    T0, Cp, p = models.init_diffusion3d(dtype=torch.float32)
    for name, q in (("plain", p), ("overlap", dataclasses.replace(p, overlap=True))):
        models.run_diffusion(T0, Cp, q, 2, nt_chunk=2, impl="plain")  # warm chunk
        T, r[name] = timed(lambda: models.run_diffusion(T0, Cp, q, 10, nt_chunk=10,
                                                        impl="plain"), 10)
        save(f"diffusion_{name}_T", tg.gather_interior(T))
        if name == "plain":  # phase 13b's containers and hook, across the processes
            from implicitglobalgrid_tpu_torch.io.reducers import make_reduced_post_chunk

            io_state = {"T": T, "Cp": Cp}
            t0 = time.perf_counter()
            tg.save_checkpoint_sharded(os.path.join(out, "io_ckpt"), io_state, step=10)
            r[name]["io_save_ms"] = (time.perf_counter() - t0) * 1e3
            with tg.SnapshotWriter(os.path.join(out, "io_snaps")) as w:
                w.submit(io_state, 10)
            r[name]["io_snapshot"] = w.stats
            plan = tg.io.build_reducer_plan(io_reducers(tg), ("T", "Cp"), io_state)
            r[name]["io_vector"] = make_reduced_post_chunk(("T", "Cp"), plan)(
                (T, Cp)).cpu().tolist()
        # this process's overlap_stats of 2 steps (the hidden share across processes)
        d = os.path.join(out, f"trace_{name}_{pid}")
        with tg.trace(d):
            models.run_diffusion(T0, Cp, q, 2, nt_chunk=2, impl="plain")
        r[name]["overlap_stats"] = tg.overlap_stats(d).get("GPU:0")
        r[name]["op_breakdown"] = tg.op_breakdown(d, top=6)
        shutil.rmtree(d, ignore_errors=True)
    tg.finalize_global_grid()
    # run_resilient on the same mesh's plain route: a shared checkpoint
    # directory, a NaN in process 1's box (z-block 1), a flight stream a
    # process; 10 steps, the rollback's replay included
    r = rec["resilient"] = grid(N_MESH, periodx=1)
    T0, Cp, p = models.init_diffusion3d(dtype=torch.float32)
    fdir = os.path.join(out, "resilient_flight")  # flight_p<rank>.jsonl, one run id
    os.makedirs(fdir, exist_ok=True)
    tg.start_flight_recorder(fdir, run_id="transport_resilient")
    cb.reset_launch_counts()
    t0 = time.perf_counter()
    res, reps = tg.run_resilient(
        lambda s: {"T": models.diffusion_step_local(s["T"], s["Cp"], p, "plain"),
                   "Cp": s["Cp"]},
        {"T": T0, "Cp": Cp}, 10, nt_chunk=5, checkpoint_dir=os.path.join(out, "resilient_ck"),
        faults=[tg.NaNPoke(step=6, name="T", index=(5, 6, N_MESH + 7))])
    r["run"] = dict(wall_ms=(time.perf_counter() - t0) * 1e3, launches=cb.launch_counts())
    fr = tg.stop_flight_recorder()
    rr = tg.run_report(fr, include_metrics=False)
    r["flight"] = dict(procs=sorted({e["proc"] for e in tg.read_flight_events(fr)}),
                       rollbacks=rr["checkpoints"]["rollbacks"], trips=rr["guards"]["trips"],
                       saves=rr["checkpoints"]["saves"],
                       save_ms=[e["dur_s"] * 1e3 for e in rr["sequence"]
                                if e["kind"] == "checkpoint_save"],
                       tripped=[[x.step_begin, x.step_end] for x in reps if not x.ok])
    save("resilient_T", tg.gather_interior(res["T"]))
    del res, T0, Cp
    tg.finalize_global_grid()
    # the audit and the resize across the processes: the same mesh's kernel
    # route under run_resilient(audit=True), resized to TRANSPORT_RESIZE at
    # step 10 with via="auto" (reshard_state refuses to move blocks across
    # processes, so the checkpoint path), against the unresized run
    from implicitglobalgrid_tpu_torch.utils.exceptions import InvalidArgumentError

    r = rec["audit"] = grid(N_MESH, periodx=1)
    T0, Cp, p = models.init_diffusion3d(dtype=torch.float32)
    step_T = models.make_step(p)

    def step(st):
        return {"T": step_T(st["T"], st["Cp"]), "Cp": st["Cp"]}

    ref, _ = tg.run_resilient(step, {"T": T0, "Cp": Cp}, 20, nt_chunk=10)
    G_ref = tg.gather_interior(ref["T"])
    del ref
    fdir = os.path.join(out, "audit_flight")
    os.makedirs(fdir, exist_ok=True)
    tg.start_flight_recorder(fdir, run_id="transport_audit")
    cb.reset_launch_counts()
    run = tg.ResilientRun(step, {"T": T0, "Cp": Cp}, 20, tg.RunSpec(
        nt_chunk=10, audit=True, checkpoint_dir=os.path.join(out, "audit_ck")))
    del T0, Cp
    raised = via = None
    try:
        while run.advance():
            if run.step == 10 and via is None:
                try:
                    tg.reshard_state(run.state, TRANSPORT_RESIZE)
                    raised = "nothing"
                except InvalidArgumentError:
                    raised = "InvalidArgumentError"
                rr = run.resize(TRANSPORT_RESIZE)
                via, r["resize_ms"] = rr["via"], rr["seconds"] * 1e3
    finally:
        run.close()
        fr = tg.stop_flight_recorder()
    r["run"] = dict(launches=cb.launch_counts())
    r["audits"] = [[e["program"], e["ok"]] for e in tg.read_flight_events(fr)
                   if e["kind"] == "audit"]
    r["reshard_raised"], r["via"] = raised, via
    r["dims"] = [int(d) for d in tg.global_grid().dims]
    G = tg.gather_interior(run.state["T"])
    r["bitwise_unresized"] = None if G is None else bool(np.array_equal(G, G_ref))
    del run, G, G_ref
    tg.finalize_global_grid()
    r = rec["diffusion_deep"] = grid(N_MESH, periodx=1, overlaps=(4, 4, 4),
                                     halowidths=(2, 2, 2))
    T0, Cp, p = models.init_diffusion3d(dtype=torch.float32)
    T0, Cp = tg.update_halo(T0, Cp)
    q = dataclasses.replace(p, comm_every=2)
    models.run_diffusion(T0, Cp, q, 2, nt_chunk=2)  # warm chunk
    T, r["steps"] = timed(lambda: models.run_diffusion(T0, Cp, q, 10, nt_chunk=10), 10)
    save("diffusion_deep_T", tg.gather_interior(T))
    tg.finalize_global_grid()
    # an ensemble's diffusion on the all-periodic mesh, E = 1 and 4, 10 steps
    # (the members of E = 4 against the ensemble phase's virtual mesh)
    r = rec["ensemble"] = grid(N_MESH, periodx=1, periody=1, periodz=1)
    T0, Cp, p = models.init_diffusion3d(dtype=torch.float32)
    for E in (1, 4):
        ET, EC = models.ensemble_state((T0, Cp), E, perturb=0.01)
        models.run_diffusion(ET, EC, p, 2, nt_chunk=2, ensemble=E)  # warm chunk
        T, r[f"E{E}"] = timed(lambda: models.run_diffusion(ET, EC, p, 10, nt_chunk=10,
                                                           ensemble=E), 10)
    G = [tg.gather_interior(T[m]) for m in range(4)]
    if pid == 0:
        save("ensemble_diffusion_e4", np.stack(G))
    del T, ET, EC, G
    tg.finalize_global_grid()
    with open(os.path.join(out, f"record_{pid}.json"), "w") as f:
        json.dump(rec, f)
    dist.destroy_process_group()
    print(f"transport child {pid} done", flush=True)
    return 0


def phase_transport(tg, refs, virtual_step_ms):
    """Phase 14: the transport. Two processes of this script share cuda:0
    in a gloo group (NCCL refuses two processes on one card) and run config
    3, config 4's mesh, config 5's mesh and the README run's diffusion mesh
    (plain route, with and without overlap, and at comm_every=2) split
    along z, and config 3's steps and config 4's update_halo under int8 and
    bfloat16; each gathered result is held bitwise against the virtual
    mesh's run of the same steps (``refs``). Returns (launches summed over
    the processes, record)."""
    import shutil
    import socket

    import numpy as np
    import torch

    print(f"phase: transport, {TRANSPORT_PROCS} processes on cuda:0 under gloo, the grids "
          f"split along z; card {card_name()}", flush=True)
    torch.cuda.empty_cache()
    out = _transport_dir()
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "WORLD_SIZE", "IGG_USE_PALLAS")}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--transport-child",
                               str(pid), str(port)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for pid in range(TRANSPORT_PROCS)]
    logs, deadline = [], time.monotonic() + TRANSPORT_TIMEOUT
    try:
        for pr in procs:
            try:
                logs.append(pr.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
            except subprocess.TimeoutExpired:
                logs.append(f"timed out after {TRANSPORT_TIMEOUT} s")
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    for pid, (pr, log) in enumerate(zip(procs, logs)):
        for line in log.splitlines()[-12:]:
            print(f"  [{pid}] {line}")
        check(pr.returncode == 0, f"transport: process {pid} exited {pr.returncode}")
    recs = []
    for pid in range(TRANSPORT_PROCS):
        with open(os.path.join(out, f"record_{pid}.json")) as f:
            recs.append(json.load(f))
    # the supervised run ends as the same mesh's 10 plain-route steps
    refs = dict(refs, resilient_T=refs["diffusion_plain_T"])
    errs = {}
    for name, ref in refs.items():
        got = np.load(os.path.join(out, name + ".npy"))
        same = got.dtype == ref.dtype and got.shape == ref.shape and np.array_equal(
            got.view(np.uint8), ref.view(np.uint8))
        errs[name] = 0.0 if same else (float(np.abs(got.astype(np.float64) - ref).max())
                                       if got.shape == ref.shape else -1.0)
        check(same, f"transport: {name} bitwise equal to the virtual mesh's run "
                    f"(max abs err {errs[name]!r})")
    io = transport_io(recs, out, refs["diffusion_plain_T"])
    mesh_view = transport_mesh_view(tg, os.path.join(out, "resilient_flight"))
    shutil.rmtree(out, ignore_errors=True)
    launches = {}
    for r in recs:
        for cfg in r.values():
            for part in cfg.values():
                if isinstance(part, dict):
                    for k, n in part.get("launches", {}).items():
                        launches[k] = launches.get(k, 0) + n
    r0 = recs[0]
    for cfg, nt in (("config3", 20), ("config4", 10), ("config5", 20)):
        st = r0[cfg]["steps"]
        check(st["launches"]["exchange_slabs"] == 4 * nt,
              f"transport {cfg}: K4s twice along z (moves, send slabs), once along x and y")
        check(st["wire_bytes_per_step"] > 0, f"transport {cfg}: slabs crossed the processes")
    check(r0["config3"]["steps"]["launches"]["diffusion3d_step_exchange"] == 20
          and r0["config3"]["update_halo"]["launches"]["halo_write_combined"] == 1,
          "transport config 3: K4 a step, update_halo through K6")
    check(r0["config4"]["steps"]["launches"]["acoustic_step_exchange"] == 10
          and r0["config4"]["update_halo"]["launches"]["wire_pack"] == 3
          and r0["config4"]["update_halo"]["launches"]["halo_write_multi"] == 3,
          "transport config 4: K9 a step, update_halo through K8 and K7 a dim")
    check(r0["config5"]["steps"]["launches"]["stokes_step_exchange"] == 20,
          "transport config 5: K10 an iteration")
    per = {}
    for cfg in ("config3", "config4", "config5"):
        st = [r[cfg]["steps"] for r in recs]
        per[cfg] = dict(box=r0[cfg]["box"], backend=r0[cfg]["backend"],
                        staged=r0[cfg]["staged"],
                        step_ms=[x["step_ms"] for x in st],
                        wire_bytes_per_step=[x["wire_bytes_per_step"] for x in st],
                        messages_per_step=[x["messages_per_step"] for x in st],
                        exchange_ms_per_step=[x["exchange_ms_per_step"] for x in st],
                        staging_ms_per_step=[x["staging_ms_per_step"] for x in st],
                        virtual_step_ms=virtual_step_ms[cfg],
                        k4s=r0[cfg]["steps"]["k4s"])
        if "update_halo" in r0[cfg]:
            per[cfg]["update_halo"] = {k: [r[cfg]["update_halo"][k] for r in recs] for k in (
                "step_ms", "wire_bytes_per_step", "exchange_ms_per_step", "staging_ms_per_step")}
        print(f"  transport {cfg}: box {per[cfg]['box']} a process, a step "
              f"{per[cfg]['step_ms']} ms wall (virtual mesh {virtual_step_ms[cfg]!r} ms), "
              f"{per[cfg]['wire_bytes_per_step']} wire bytes, exchange "
              f"{per[cfg]['exchange_ms_per_step']} ms of it, gloo staging "
              f"{per[cfg]['staging_ms_per_step']} ms; update_halo "
              f"{per[cfg].get('update_halo')}", flush=True)
    for cfg, part, label in (("diffusion_overlap", "plain", "plain route"),
                             ("diffusion_overlap", "overlap", "overlap=True"),
                             ("diffusion_deep", "steps", "comm_every=2 (hw 2)")):
        st = [r[cfg][part] for r in recs]
        per[f"{cfg}_{part}"] = dict(
            box=r0[cfg]["box"], step_ms=[x["step_ms"] for x in st],
            exchange_ms_per_step=[x["exchange_ms_per_step"] for x in st],
            staging_ms_per_step=[x["staging_ms_per_step"] for x in st],
            messages_per_step=[x["messages_per_step"] for x in st],
            wire_bytes_per_step=[x["wire_bytes_per_step"] for x in st],
            exchange_launches=sum(st[0]["launches"][k] for k in EXCHANGE_KERNELS))
        print(f"  transport diffusion 2x2x2 x {N_MESH}^3, {label}: a step "
              f"{per[f'{cfg}_{part}']['step_ms']} ms wall, exchange "
              f"{per[f'{cfg}_{part}']['exchange_ms_per_step']} ms, "
              f"{per[f'{cfg}_{part}']['messages_per_step']} messages", flush=True)
    ovl = r0["diffusion_overlap"]
    check(ovl["overlap"]["launches"]["halo_write_combined"] == 10
          and ovl["plain"]["launches"]["halo_write_combined"] == 10,
          "transport diffusion: plain and overlapped exchanges through K4s + K6 a step")
    check(r0["diffusion_deep"]["steps"]["messages_per_step"] * 2
          == ovl["plain"]["messages_per_step"],
          "transport diffusion comm_every=2: half the z messages a step of cadence 1")
    for part in ("plain", "overlap"):
        per[f"diffusion_overlap_{part}"]["overlap_stats"] = [
            r["diffusion_overlap"][part]["overlap_stats"] for r in recs]
        per[f"diffusion_overlap_{part}"]["op_breakdown"] = [
            r["diffusion_overlap"][part]["op_breakdown"] for r in recs]
        for pid, r in enumerate(recs):
            st = r["diffusion_overlap"][part]["overlap_stats"]
            check(st is not None and st["comm_us"] > 0,
                  f"transport diffusion {part}: process {pid}'s capture has the exchange's "
                  f"device spans")
            print(f"  transport diffusion {part}, process {pid}: overlap_stats "
                  f"{json.dumps(st)}", flush=True)
    ens = [r["ensemble"] for r in recs]
    per["ensemble_diffusion"] = {f"E{E}": {k: [e[f"E{E}"][k] for e in ens] for k in (
        "step_ms", "messages_per_step", "wire_bytes_per_step", "exchange_ms_per_step")}
        for E in (1, 4)}
    for pid, e in enumerate(ens):
        check(e["E4"]["messages_per_step"] == e["E1"]["messages_per_step"] > 0
              and e["E4"]["wire_bytes_per_step"] == 4 * e["E1"]["wire_bytes_per_step"]
              and e["E4"]["launches"]["wire_pack"] == e["E1"]["launches"]["wire_pack"],
              f"transport ensemble, process {pid}: E = 4 sends E = 1's messages a step "
              f"({e['E4']['messages_per_step']!r}) with 4 times its wire bytes and K8 launches")
    print(f"  transport ensemble diffusion: {json.dumps(per['ensemble_diffusion'])}",
          flush=True)
    for cfg, part, nt in [("config3", f"wire_{f}", TRANSPORT_WIRE_STEPS) for f in FUSED_WIRES] \
            + [("config4", f"update_halo_{f}", 1) for f in FUSED_WIRES]:
        st = [r[cfg][part] for r in recs]
        exact = r0[cfg]["steps" if cfg == "config3" else "update_halo"]
        per[f"{cfg}_{part}"] = dict(
            step_ms=[x["step_ms"] for x in st],
            wire_bytes_per_step=[x["wire_bytes_per_step"] for x in st],
            exact_wire_bytes_per_step=exact["wire_bytes_per_step"],
            exchange_ms_per_step=[x["exchange_ms_per_step"] for x in st],
            staging_ms_per_step=[x["staging_ms_per_step"] for x in st])
        print(f"  transport {cfg} {part}: a step {per[f'{cfg}_{part}']['step_ms']} ms wall, "
              f"{per[f'{cfg}_{part}']['wire_bytes_per_step']} wire bytes (exact wire "
              f"{exact['wire_bytes_per_step']!r}), exchange "
              f"{per[f'{cfg}_{part}']['exchange_ms_per_step']} ms", flush=True)
        ratio = st[0]["wire_bytes_per_step"] / exact["wire_bytes_per_step"]
        check(0 < ratio < 1, f"transport {cfg} {part}: the wire sent fewer bytes than the "
                             f"exact wire (ratio {ratio!r})")
        if part.endswith("bfloat16") and cfg == "config4":
            check(ratio == 0.5, f"transport {cfg} {part}: bfloat16 on float32 state sends "
                                "half the exact wire's bytes")
    for pid, r in enumerate(recs):
        f = r["resilient"]["flight"]
        check(f["procs"] == [pid] and f["rollbacks"] == 1 and f["trips"] == 1
              and f["tripped"] == [[6, 10]],
              f"transport run_resilient, process {pid}: its own flight stream (proc {f['procs']})"
              f" holds the guard trip at steps {f['tripped']} and {f['rollbacks']} rollback")
    per["resilient"] = dict(wall_ms=[r["resilient"]["run"]["wall_ms"] for r in recs],
                            flight=[r["resilient"]["flight"] for r in recs])
    print(f"  transport run_resilient: {json.dumps(per['resilient'])}", flush=True)
    for pid, r in enumerate(recs):
        a = r["audit"]
        check(a["audits"] == [["chunk", True], ["chunk", True]],
              f"transport run_resilient(audit=True), process {pid}: a clean chunk audit "
              f"before and after the resize ({a['audits']})")
        check(a["reshard_raised"] == "InvalidArgumentError" and a["via"] == "checkpoint"
              and a["dims"] == list(TRANSPORT_RESIZE),
              f"transport resize, process {pid}: reshard_state refused across processes "
              f"({a['reshard_raised']}), resize(via='auto') took the {a['via']} path onto "
              f"{a['dims']}")
    check(r0["audit"]["bitwise_unresized"] is True,
          "transport resize: the resized run's gathered interior bitwise the unresized run's")
    per["audit_resize"] = [dict(audits=r["audit"]["audits"], via=r["audit"]["via"],
                                resize_ms=r["audit"]["resize_ms"]) for r in recs]
    print(f"  transport audit and resize: {json.dumps(per['audit_resize'])}", flush=True)
    per["mesh_view"] = mesh_view
    per["residuals"] = r0["config5"]["residuals"]
    per["max_abs_err_vs_virtual"] = errs
    per["checkpoint_io"] = io
    return launches, per


def transport_mesh_view(tg, d):
    """The mesh view of the transport's supervised run: the two processes'
    streams in ``d`` aggregated (`aggregate_flight`), `straggler_report`,
    `run_report` of the directory (its ``mesh`` section) and
    `export_chrome_trace`: both processes present, finite offsets, the
    chunk spans of each chunk ending within 1 ms of each other."""
    import math

    agg = tg.aggregate_flight(d)
    srep = tg.straggler_report(agg)
    rep = tg.run_report(d, include_metrics=False)
    doc = tg.export_chrome_trace(agg, os.path.join(d, "trace.json"))
    with open(doc) as f:
        doc = json.load(f)
    ends = {}
    for e in doc["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "chunk" and e["name"].startswith("chunk "):
            ends.setdefault(e["name"], {})[e["pid"]] = e["ts"] + e["dur"]
    gaps = [abs(v[0] - v[1]) for v in ends.values() if len(v) == 2]
    print(f"  transport mesh view: span end gaps {gaps} us", flush=True)
    check(agg["processes"] == list(range(TRANSPORT_PROCS)),
          f"mesh view: aggregate_flight found both processes ({agg['processes']})")
    check(all(math.isfinite(v) for v in agg["offsets"].values()),
          f"mesh view: finite clock offsets {agg['offsets']}")
    check(rep.get("mesh") is not None and rep["mesh"]["processes"] == agg["processes"],
          "mesh view: run_report of the directory carries the mesh section")
    check(bool(gaps) and max(gaps) < 1e3,
          f"mesh view: the {len(gaps)} chunks' spans end within 1 ms across the processes "
          f"(largest gap {max(gaps) if gaps else None!r} us)")
    out = dict(offsets=agg["offsets"], align=agg["align"], span_end_gap_us=gaps,
               straggler_summary=srep["summary"], imbalance=srep["imbalance"],
               mesh_summary=rep["mesh"]["summary"])
    print(f"  transport mesh view: {json.dumps(out)}", flush=True)
    return out


def transport_io(recs, out, ref):
    """The transport phase's checkpoint and io: the two processes' sharded
    checkpoint of the README mesh's state after 10 plain-route steps (one
    file a process, process 0's commit) restored on the virtual mesh
    bitwise phase 12's state after the same steps (``ref``: its
    `gather_interior`), their snapshot read bitwise the same, and the
    guard-and-reducer vector after `transport.all_sum`, equal on both
    processes, equal to the virtual mesh's on that state (counts, probe,
    line, min and max bitwise; sums within IO_SUM_RTOL)."""
    import numpy as np

    import implicitglobalgrid_tpu_torch as tg
    from implicitglobalgrid_tpu_torch.io.reducers import make_reduced_post_chunk

    grid(tg, N_MESH, N_MESH, N_MESH, dimx=2, dimy=2, dimz=2, periodx=1)
    st, step = tg.restore_checkpoint_sharded(os.path.join(out, "io_ckpt"))
    with np.load(os.path.join(out, "io_ckpt", "meta.npz")) as z:
        nfiles = int(z["__igg_meta__nprocs_files"])
    check(step == 10 and nfiles == TRANSPORT_PROCS
          and np.array_equal(tg.gather_interior(st["T"]), ref),
          f"transport io: the processes' sharded checkpoint ({nfiles} files) restores on the "
          "virtual mesh bitwise phase 12's state after the same steps")
    snaps = tg.list_snapshots(os.path.join(out, "io_snaps"))
    check(len(snaps) == 1 and np.array_equal(tg.open_snapshot(snaps[0][1]).read_global("T"),
                                             ref),
          "transport io: the processes' snapshot reads bitwise the virtual mesh's "
          "gather_interior")
    names = ("T", "Cp")
    plan = tg.io.build_reducer_plan(io_reducers(tg), names, st)
    mine = make_reduced_post_chunk(names, plan)((st["T"], st["Cp"])).cpu().numpy()
    got = [np.asarray(r["diffusion_overlap"]["plain"]["io_vector"], np.float32) for r in recs]
    check(all(np.array_equal(g, got[0], equal_nan=True) for g in got),
          "transport io: the summed vector equal on every process")
    sums = [1, 3] + [4 + off + j for red, off, _, _ in plan._entries
                     if isinstance(red, tg.Stats) for j in (0, 1)]
    exact = [i for i in range(len(mine)) if i not in sums]
    rel = [float(abs(got[0][i] - mine[i]) / max(abs(mine[i]), 1e-30)) for i in sums]
    check(len(got[0]) == len(mine) and np.array_equal(got[0][exact], mine[exact])
          and max(rel) <= IO_SUM_RTOL,
          f"transport io: the vector equals the virtual mesh's (sums' relative errors {rel})")
    tg.finalize_global_grid()
    return dict(files=nfiles, sums_rel_err=rel,
                save_ms=[r["diffusion_overlap"]["plain"]["io_save_ms"] for r in recs],
                snapshot=[r["diffusion_overlap"]["plain"]["io_snapshot"] for r in recs])


# config 5's dx on one 128^3 block and on the 2x2x2 mesh, the 3 of divV/3,
# chip_smoke's spacing, and random divisors of either sign from a seed
CDIV_DIVISORS = (10 / 127, 10 / 253, 3.0, 0.079)
F64_SAMPLE = 1 << 26


def sass_text(cb, info):
    """The SASS of the kernel library (cuobjdump -sass)."""
    cuobjdump = os.path.join(os.path.dirname(cb._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", info["path"]], capture_output=True, text=True,
                          timeout=300)
    check(sass.returncode == 0, "cuobjdump -sass read the kernel library")
    return sass.stdout


def division_report(rep, sass):
    """Add to each template of ``rep`` (a `ptxas_report`) the IEEE
    divisions of its SASS: a kernel's listing ends with the subroutines it
    calls (cdiv.cuh's out-of-line IEEE division and its slow path), so the
    kernel's own code lies below the lowest call target. FCHK is the
    float32 division's range check, MUFU.RCP64H the float64 division's
    reciprocal (an integer division takes MUFU.RCP, not these)."""
    import re

    listing, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if m.group(1) in rep else None
            if fn is not None:
                listing[fn] = []
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*)", line)
        if fn is not None and m:
            listing[fn].append((int(m[1], 16), m[2]))
    for fn, code in listing.items():
        targets = [int(t, 16) for _, ins in code
                   for t in re.findall(r"CALL\.\S+\s+`?\(?(?:0x)?([0-9a-f]+)\)?", ins)]
        end = min(targets, default=1 << 62)
        own = [ins for a, ins in code if a < end]
        rest = [ins for a, ins in code if a >= end]
        rep[fn].update(
            calls=sorted(hex(t) for t in set(targets)), kernel_instructions=len(own),
            division_checks=sum("FCHK" in i or "MUFU.RCP64H" in i for i in own),
            division_checks_in_subroutines=sum("FCHK" in i or "MUFU.RCP64H" in i for i in rest))
    return rep


def print_build_report(label, rep):
    for name, r in rep.items():
        print(f"  {label} {name}: {r.get('registers')} registers, {r.get('stack')} bytes stack "
              f"frame, {r.get('spill_stores')}/{r.get('spill_loads')} bytes spill "
              f"stores/loads; SASS: {r.get('kernel_instructions')} instructions before the "
              f"first subroutine, {r.get('division_checks')} IEEE division checks there, "
              f"{r.get('division_checks_in_subroutines')} in the subroutines, calls "
              f"{r.get('calls')}", flush=True)


def k10_build_report(info, sass):
    """Registers, stack frame and spills of every K10 template (ptxas), and
    the IEEE division in its SASS: the multi-rank kernels' own code must
    hold no division sequence, only calls to cdiv.cuh's out-of-line
    fallback. Returns {kernel: {...}}."""
    rep = division_report(ptxas_report(info.get("ptxas", ""), "stokes_step_kernel"), sass)
    print_build_report("K10", rep)
    # the multi-rank route's templates: the tiles and the per-column kernel
    # with SELF false (mangled "Lb0E")
    multi = {n: r for n, r in rep.items() if "column" not in n or "Lb0E" in n}
    check(len(multi) == 4 and all(r.get("division_checks") == 0 for r in multi.values()),
          "K10 multi-rank kernels (tiles and per-column, float32 and float64): no IEEE "
          "division in the kernels' own SASS (only in cdiv.cuh's out-of-line fallback)")
    return rep


# planes in the unrolled loop of K1 and K4 (SLOTS in csrc/stencil.cu)
STEP_UNROLL = 4


def step_build_report(info, sass):
    """Registers, stack frame and spills of every K1 and K4 template
    (ptxas), and their IEEE divisions (SASS): each template's own code
    divides the IEEE way once a plane of its unrolled loop, by the field
    Cp (the spacings divide through cdiv.cuh, whose fallback is out of
    line); no float32 or bfloat16 template spills. Returns {kernel: {...}}."""
    rep = {}
    for kernel in (KERNEL_NAMES["diffusion3d_step_halo"],
                   KERNEL_NAMES["diffusion3d_step_exchange"]):
        rep.update(ptxas_report(info.get("ptxas", ""), kernel))
    division_report(rep, sass)
    print_build_report("K1/K4", rep)
    check(len(rep) == 6 and all(r.get("division_checks") == STEP_UNROLL for r in rep.values()),
          f"K1 and K4 (float32, float64, bfloat16): {STEP_UNROLL} IEEE divisions in each "
          f"template's own SASS, the division by Cp of each plane of its unrolled loop")
    # the mangled template arguments of float64: "IddE"
    narrow = [r for n, r in rep.items() if "IddE" not in n]
    check(len(narrow) == 4 and all(r.get("spill_stores") == 0 and r.get("spill_loads") == 0
                                   for r in narrow),
          "K1 and K4 float32 and bfloat16 templates: no spills")
    return rep


def phase_cdiv(cb):
    """cdiv.cuh against IEEE division on the card: every float32 bit pattern
    as a numerator for each divisor (against __fdiv_rn), and a random
    float64 sample (bit patterns of every exponent) against __ddiv_rn."""
    import numpy as np
    import torch

    print("phase: the division helper (cdiv.cuh) against IEEE division", flush=True)
    lib = cb.library()
    st = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(6)
    divisors = list(CDIV_DIVISORS) + [float(v * 10 ** e) for v, e in zip(
        rng.uniform(-2, 2, 4), rng.uniform(-4, 4, 4))]
    counts = torch.zeros(2, dtype=torch.int64, device="cuda")
    out = dict(divisors=divisors, f32_mismatches=[], f32_corrected=[], f32_seconds=[])
    for b in divisors:
        counts.zero_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = lib.igg_cdiv_sweep(b, counts.data_ptr(), st)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        bad, fast = (int(v) for v in counts.tolist())
        out["f32_mismatches"].append(bad)
        out["f32_corrected"].append(fast)
        out["f32_seconds"].append(dt)
        check(rc == 0 and bad == 0,
              f"cdiv float32 b={b!r}: {bad} mismatches over all 2^32 numerators "
              f"({fast} on the corrected path), {dt:.4f} s")
    g = torch.Generator(device="cuda").manual_seed(62)
    a = torch.randint(-2 ** 31, 2 ** 31, (F64_SAMPLE, 2), generator=g, device="cuda",
                      dtype=torch.int32).view(torch.float64).view(-1)
    q, r = torch.empty_like(a), torch.empty_like(a)
    out["f64_sample"], out["f64_mismatches"] = F64_SAMPLE, []
    for b in divisors:
        rc = lib.igg_cdiv(1, a.data_ptr(), r.data_ptr(), a.numel(), b, 1, st)
        bad = 0
        for mode in (0, 2):  # cdiv; the passes K10's tiles divide with
            rc |= lib.igg_cdiv(1, a.data_ptr(), q.data_ptr(), a.numel(), b, mode, st)
            same = (q.view(torch.int64) == r.view(torch.int64)) | (q.isnan() & r.isnan())
            bad += int((~same).sum())
        out["f64_mismatches"].append(bad)
        check(rc == 0 and bad == 0,
              f"cdiv float64 b={b!r}: {bad} mismatches over {F64_SAMPLE} random numerators "
              "(cdiv, and the tiles' passes)")
    del a, q, r
    return out


def ptxas_report(log, kernel):
    """{entry: {registers, stack, spill_stores, spill_loads}} of the
    templates of ``kernel`` in a ptxas log."""
    import re

    rep, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1) if kernel in m.group(1) else None
            continue
        if entry is None:
            continue
        # the entry's own properties come first, its callees' after "Used"
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m and "stack" not in rep.setdefault(entry, {}):
            rep[entry].update(stack=int(m[1]), spill_stores=int(m[2]), spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rep.setdefault(entry, {})["registers"] = int(m[1])
            entry = None
    return rep


def k9_build_report(info):
    """Registers, stack frame and spills of every K9 template (ptxas):
    float32, float64 and bfloat16, each route."""
    rep = ptxas_report(info.get("ptxas", ""), "acoustic_step_kernel")
    for name, r in rep.items():
        print(f"  K9 {name}: {r.get('registers')} registers, {r.get('stack')} bytes stack "
              f"frame, {r.get('spill_stores')}/{r.get('spill_loads')} bytes spill "
              "stores/loads", flush=True)
    check(len(rep) == 6, "K9: six templates (three dtypes, two routes) in the ptxas report")
    return rep


def k4s_build_report(info):
    """Registers, stack frame and spills of every K4s template (ptxas): the
    copy (four element sizes), 3-D and 2-D step (float32, float64,
    bfloat16), wave (the same three) and Stokes (float32, float64) modes,
    each along x, y and z."""
    rep = ptxas_report(info.get("ptxas", ""), "exchange_slabs")
    for name, r in sorted(rep.items()):
        print(f"  K4s {name}: {r.get('registers')} registers, {r.get('stack')} bytes stack "
              f"frame, {r.get('spill_stores')}/{r.get('spill_loads')} bytes spill "
              "stores/loads", flush=True)
    check(len(rep) == 45, f"K4s: 45 templates (15 modes and dtypes, 3 dims) in the ptxas "
                          f"report ({len(rep)})")
    return rep


def card_name():
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"


def main() -> int:
    if sys.argv[1:2] == ["--transport-child"]:
        return transport_child(int(sys.argv[2]), int(sys.argv[3]))
    if sys.argv[1:2] == ["--profiling-child"]:
        return profiling_child(sys.argv[2])
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import implicitglobalgrid_tpu_torch as tg
        from implicitglobalgrid_tpu_torch import models
        from implicitglobalgrid_tpu_torch.ops import cuda_build as cb
        from implicitglobalgrid_tpu_torch.ops import cuda_halo as ch
        from implicitglobalgrid_tpu_torch.ops import cuda_stencil as cs
        from implicitglobalgrid_tpu_torch.ops import cuda_stokes as cst
        from implicitglobalgrid_tpu_torch.ops import cuda_wave as cw
    except ImportError as e:
        print(f"chip_smoke: the package is not beside this script: {e}",
              file=sys.stderr)
        return 3
    _load_names()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    try:
        print("phase: build", flush=True)
        info = cb.build_kernels()
        cb.library()
        print(f"  build {info['seconds']:.2f} s (built={info['built']}) -> {info['path']}")
        for line in info.get("ptxas", "").splitlines():
            if any(w in line for w in ("entry function", "registers", "spill")) \
                    or line.startswith("=="):
                print("  " + line.strip())
        sass = sass_text(cb, info)
        k10_build = k10_build_report(info, sass)
        step_build = step_build_report(info, sass)
        k9_build = k9_build_report(info)
        k4s_build = k4s_build_report(info)
        cdiv = phase_cdiv(cb)
        print("phase: kernels vs plain", flush=True)
        rows = phase_kernels((cs, ch, cb, cw, cst, tg), cb.launch_counts())
        periodic = phase_main(tg, models, cb, cs, "periodic", 100,
                              periodx=1, periody=1, periodz=1)
        novis = phase_main(tg, models, cb, cs, "non-periodic", 100)
        mesh_counts, mesh = phase_mesh(tg, models, cb, cs)
        cfg3_counts, cfg3 = phase_config3(tg, models, cb, cs)
        cfg2_counts, cfg2 = phase_config2(tg, models, cb)
        cfg4_counts, cfg4 = phase_config4_single(tg, models, cb, cw)
        cfg4m_counts, cfg4m = phase_config4_mesh(tg, models, cb, cw)
        cfg5_counts, cfg5 = phase_config5_single(tg, models, cb, cst)
        cfg5m_counts, cfg5m = phase_config5_mesh(tg, models, cb, cst)
        ovl_counts, ovl, ovl_refs = phase_overlap_deep(tg, models, cb)
        prof_counts, prof = run_profiling_phase()
        ens_counts, ens, ens_refs = phase_ensemble(tg, models, cb)
        example = phase_example(tg)
        wire_counts, wire, wire_refs = phase_wire(tg, models, cb)
        io_counts, io = phase_io(tg, models, cb)
        sup_counts, sup = phase_supervised(tg, models, cb)
        oracle_counts, oracle, fma_row = phase_oracle(tg, models, cb, cw, cst)
        audit_counts, audit = phase_audit_reshard(tg, models, cb)
        service_counts, service = phase_service(tg, models, cb)
        serve_counts, serve = phase_serve(tg, models, cb)
        refs = {k: v for ph in (cfg3, cfg4m, cfg5m) for k, v in ph.pop("transport_ref").items()}
        refs.update(ovl_refs)
        refs.update(ens_refs)
        refs.update(wire_refs)
        del wire_refs
        transport_counts, transport = phase_transport(tg, 
            refs, {"config3": cfg3["step_ms"], "config4": cfg4m["step_ms"],
                   "config5": cfg5m["step_ms"]})
        del refs
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    paths = [periodic["launches"], novis["launches"], mesh_counts, cfg3_counts, cfg2_counts,
             cfg4_counts, cfg4m_counts, cfg5_counts, cfg5m_counts, ovl_counts, prof_counts,
             ens_counts, wire_counts, io_counts, sup_counts, oracle_counts, audit_counts,
             service_counts, serve_counts, transport_counts]
    launches = {k: sum(c.get(k, 0) for c in paths) for k in KERNEL_NAMES}
    for name, n in launches.items():
        if n == 0:
            print(f"chip_smoke: FAILED: {name} never launched on the main path",
                  file=sys.stderr)
            return 1
    card = card_name()
    stencil, halo = ("implicitglobalgrid_tpu_torch/csrc/stencil.cu",
                     "implicitglobalgrid_tpu_torch/csrc/halo.cu")
    src = {"diffusion3d_step_halo": (stencil, "implicitglobalgrid_tpu/ops/pallas_stencil.py:72,839"),
           "halo_write": (halo, "implicitglobalgrid_tpu/ops/pallas_halo.py:142"),
           "halo_self_exchange": (halo, "implicitglobalgrid_tpu/ops/pallas_halo.py:558"),
           "diffusion3d_step_exchange": (stencil,
                                         "implicitglobalgrid_tpu/ops/pallas_stencil.py:278,314"),
           "diffusion2d_step_exchange": (stencil,
                                         "implicitglobalgrid_tpu/ops/pallas_stencil.py:999"),
           "halo_write_combined": (halo, "implicitglobalgrid_tpu/ops/pallas_halo.py:523"),
           "exchange_slabs": (stencil, "implicitglobalgrid_tpu/ops/pallas_stencil.py:239 "
                                       "(XLA helper) + ops/halo.py:299 + "
                                       "ops/pallas_wave.py:109,127 (wave getters) + "
                                       "ops/pallas_stokes.py:87,102 (Stokes getters)"),
           "wire_pack": (halo, "implicitglobalgrid_tpu/ops/pallas_halo.py:72"),
           "halo_write_multi": (halo, "implicitglobalgrid_tpu/ops/pallas_halo.py:269,347"),
           "acoustic_step_exchange": ("implicitglobalgrid_tpu_torch/csrc/wave.cu",
                                      "implicitglobalgrid_tpu/ops/pallas_wave.py:386 "
                                      "(_wave_kernel :227, _wave_mp_kernel :305)"),
           "stokes_step_exchange": ("implicitglobalgrid_tpu_torch/csrc/stokes.cu",
                                    "implicitglobalgrid_tpu/ops/pallas_stokes.py:132,286"),
           "fma_chain": ("implicitglobalgrid_tpu_torch/csrc/calibrate.cu",
                         "none: a port helper for the FLOP-rate fit "
                         "(implicitglobalgrid_tpu/telemetry/calibrate.py:104, an XLA loop)")}
    rows["fma_chain"] = fma_row
    rows["stokes_step_exchange"]["ptxas_sass"] = k10_build
    for name in ("diffusion3d_step_halo", "diffusion3d_step_exchange"):
        rows[name]["ptxas_sass"] = {k: v for k, v in step_build.items()
                                    if KERNEL_NAMES[name] in k}
    rows["diffusion3d_step_halo"]["own_state_device_ms"] = {
        "periodic_256": periodic["k1_own_state_ms"], "nonperiodic_256": novis["k1_own_state_ms"]}
    rows["diffusion3d_step_exchange"]["own_state_device_ms"] = {
        "mesh_128_f32": mesh["k4_own_state_ms"], "config3_256_f64": cfg3["k4_own_state_ms"]}
    rows["halo_write_combined"]["route_device_ms"] = {  # K6 in "K1 + update_halo", a step
        "mesh_128_f32": mesh["k1_update_halo_route"]["device_ms_by_kernel"].get(
            "halo_write_combined"),
        "config3_256_f64": cfg3["k1_update_halo_route"]["device_ms_by_kernel"].get(
            "halo_write_combined")}
    rows["acoustic_step_exchange"]["ptxas"] = k9_build
    rows["exchange_slabs"]["ptxas"] = k4s_build
    k4s_launches = {}  # the main paths' K4s launches by mode and dim
    for ph in (mesh, cfg3, cfg2, cfg4m, cfg5m):
        for k, n in ph.pop("k4s_launches").items():
            k4s_launches[k] = k4s_launches.get(k, 0) + n
    print(f"K4s launches on the main paths by mode/dim: {json.dumps(k4s_launches)}")
    rows["acoustic_step_exchange"]["k9_kernels_ms"] = {
        "single_block": cfg4["k9_kernels_ms"], "mesh": cfg4m["k9_kernels_ms"]}
    rows["stokes_step_exchange"]["solver_device_ms"] = {
        "single_block": cfg5["k10_solver_device_ms"], "mesh": cfg5m["k10_solver_device_ms"],
        "single_block_kernels": cfg5["k10_solver_kernels_device_ms"],
        "mesh_kernels": cfg5m["k10_solver_kernels_device_ms"]}
    kernels = []
    for name, r in rows.items():
        kernels.append(dict(name=name, route="cuda", source=src[name][0],
                            replaces=src[name][1], launches=launches[name],
                            max_abs_err=r["max_abs_err"], ms=r["ms"],
                            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"], library_ms=r["library_ms"],
                            device_ms=r["device_ms"], shape=r["shape"],
                            **{k: v for k, v in r.items()
                               if k in ("k1_same_shape_ms", "wave_mode_ms", "stokes_mode_ms",
                                        "wave_mode_device_ms", "stokes_mode_device_ms",
                                        "wave_mode_bound_ms", "stokes_mode_bound_ms",
                                        "wave_mode_bound_by", "stokes_mode_bound_by",
                                        "k9_kernels_ms", "ptxas",
                                        "self_route", "single_block", "zeros_device_ms",
                                        "subnormal_device_ms", "solver_device_ms",
                                        "kernels_device_ms", "own_state_device_ms",
                                        "f64_device_ms", "f64_bound_ms",
                                        "ptxas_sass", "dims", "sector_bound_ms", "parts",
                                        "library_device_ms", "library_kernels",
                                        "route_device_ms", "pr13_device_ms")}))
    k1_dev = rows["diffusion3d_step_halo"]["device_ms"]
    if k1_dev is not None:  # the periodic step is one K1 (T,T,T) launch
        periodic["k1_device_share"] = 100 * k1_dev / (periodic["seconds"] * 1e3 / 100)
    print(json.dumps({"main_path": {"periodic_256": periodic, "nonperiodic_256": novis,
                                    "mesh_2x2x2_128": mesh, "config3_2x2x2_256_f64": cfg3,
                                    "config2_2x2_4096_f32": cfg2,
                                    "config4_192_f32": cfg4, "config4_2x2x2_192_f32": cfg4m,
                                    "config5_128_f32": cfg5, "config5_2x2x2_128_f32": cfg5m,
                                    "overlap_deep_virtual_mesh_f32": ovl,
                                    "profiling": prof, "ensemble": ens,
                                    "advanced_modes_example": example,
                                    "wire_formats_and_sr": wire,
                                    "checkpoint_io": io,
                                    "oracle_and_mesh_view": oracle,
                                    "audit_and_reshard": audit,
                                    "transport_2_processes_z": transport},
                      "supervised_run": sup,
                      "cdiv": cdiv, "k4s_launches": k4s_launches,
                      "seconds_total": time.perf_counter() - t_start}))
    print(json.dumps({"service": service}))
    print(json.dumps({"serve": serve}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
