#!/usr/bin/env python3
"""Drive the PyTorch port (`implicitglobalgrid_tpu_torch`) on one CUDA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, in order; any failure exits non-zero without the final line:

1. build the CUDA kernels from `implicitglobalgrid_tpu_torch/csrc/`; print
   each kernel's ptxas report, K9's and K10's registers, stack and spills
   for each template, and check
   K10's SASS for the IEEE division; sweep the division helper of
   `cdiv.cuh` over every float32 numerator (and a float64 sample) against
   IEEE division for config 5's divisors and random ones;
2. hold every kernel against its plain PyTorch version on the card, at the
   main paths' shapes (steps K1/K4/K5 and the slab kernel K4s to TOL; halo
   copies K2/K3/K6, K9 in float32, float64 and bfloat16, K10 and the
   batched K4s wave and Stokes modes bitwise), and time
   kernel, plain version and PyTorch library call (CUDA events), and each
   kernel's device time alone (torch.profiler);
3. main path, periodic: `init_global_grid(256, 256, 256, periodic)` ->
   `init_diffusion3d` -> warm chunk -> tic -> `run_diffusion(nt=100)` -> toc
   -> `update_halo` -> `gather_interior`, against the same run with
   ``IGG_USE_PALLAS=0`` (the plain path on the card);
4. the same, non-periodic (the reference example's novis configuration);
5. the virtual mesh: a 2x2x2 grid of 128^3 blocks (the fused step +
   exchange K4s/K4, the combined `update_halo` K4s/K6), bitwise and
   run-tolerance checks against the plain path, a 2x2x1 `update_halo` with
   z not exchanging and a 2-D `update_halo` with halowidth 2 (the per-dim
   tier, K4s/K2), and a small run against the CPU;
6. BASELINE config 3: 2x2x2 blocks of 256^3, periodic, float64, 20 steps,
   against the plain path and against K1 + `update_halo` for one step;
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
   route's host, wall and device time a step; a bfloat16 run, bitwise
   against the kernels' plain versions on the card for a few steps and
   held to float64 beside the plain route;
10. BASELINE config 5 (3-D pseudo-transient Stokes) on one 128^3 block,
   float32, non-periodic, the example's solver loop
   (`examples/stokes3D_multixpu.py`): `init_stokes3d` -> warm chunk -> tic
   -> `run_stokes` in chunks of 500 with `stokes_residuals` after each until
   max(residuals) < 5e-4 or 6000 iterations -> toc -> `gather_interior(P)`,
   K10 alone; its first 100 iterations against ``IGG_USE_PALLAS=0``;
11. config 5 on a 2x2x2 mesh of 128^3 blocks, 300 iterations of the fused
   route (3 K4s Stokes-mode launches, one a dim for the four fields, + 1
   K10 an iteration); its first 20 against the plain route (K8 + K7 for the
   (Vx, Vy, Vz, P) group);
12. numbers: the card's name and power limit, each kernel's time, bound,
   plain and library times (one JSON line), cell-updates/s, and host
   against device time per step of the fused routes.

The last line is ``{"ok": true, "device": {...}}``. The script imports
nothing of JAX. It needs one card and exits non-zero without CUDA or
without the package beside it.
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
# every kernel of the port, by its launch counter, with the name torch.profiler shows
KERNEL_NAMES = {"diffusion3d_step_halo": "diffusion3d_step_halo_kernel",
                "halo_write": "halo_write_kernel",
                "halo_self_exchange": "self_exchange_kernel",
                "diffusion3d_step_exchange": "diffusion3d_step_exchange_kernel",
                "diffusion2d_step_exchange": "diffusion2d_step_exchange_kernel",
                "halo_write_combined": "halo_write_combined_kernel",
                "exchange_slabs": "exchange_slabs",  # its copy, step and staggered kernels
                "wire_pack": "wire_pack_kernel",
                "halo_write_multi": "halo_write_multi_kernel",
                "acoustic_step_exchange": "acoustic_step_kernel",
                "stokes_step_exchange": "stokes_step_kernel"}
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
        check(close(got, ref, **TOL[name]),
              f"K1 {shape} {name} fuse={fuse} matches plain (max abs err {err:.3e})")
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

    # K2: halo writes of the 2x2x2 grid of 128^3 blocks (stacked 256^3)
    g = torch.Generator(device="cuda").manual_seed(7)
    A = torch.randn((256, 256, 256), generator=g, device="cuda")
    k2_err = 0.0
    for dim in range(3):
        for hw in (1, 2):
            ss = list(A.shape)
            ss[dim] = 2 * hw
            sl = torch.randn(ss, generator=g, device="cuda")
            sr = torch.randn(ss, generator=g, device="cuda")
            a1, a2 = A.clone(), A.clone()
            ch.halo_write(a1, sl, sr, dim=dim, hw=hw, block=128)
            ch.halo_write_plain(a2, sl, sr, dim=dim, hw=hw, block=128)
            torch.cuda.synchronize()
            k2_err = max(k2_err, max_err(a1, a2))
            check(torch.equal(a1, a2), f"K2 dim {dim} hw {hw} bitwise equal to plain")
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

    slab_bytes = sum(sl.numel() + sr.numel() for sl, sr in slabs) * 4
    rows["halo_write"] = dict(
        max_abs_err=k2_err, ms=median_ms(k2_all), plain_ms=median_ms(k2_plain),
        device_ms=device_ms(k2_all, "halo_write_kernel"),
        bound_ms=2 * slab_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=median_ms(k2_library),
        shape="dims 0,1,2 (3 launches) of one update_halo, 2x2x2 x 128^3 float32, hw 1")

    # K3: every non-empty mode combination on a 256^3 block
    import itertools

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

    check(torch.equal(k3_library(), ch.halo_self_exchange(
        A, modes=(True, True, True), ols=(2, 2, 2))), "K3 equals the slice-copy form")
    rows["halo_self_exchange"] = dict(
        max_abs_err=k3_err,
        ms=median_ms(lambda: ch.halo_self_exchange(A, modes=(True, True, True),
                                                   ols=(2, 2, 2))),
        plain_ms=median_ms(lambda: ch.halo_self_exchange_plain(
            A, modes=(True, True, True), ols=(2, 2, 2)), batches=3, per_batch=3, warm=1),
        device_ms=device_ms(lambda: ch.halo_self_exchange(
            A, modes=(True, True, True), ols=(2, 2, 2)), "self_exchange_kernel"),
        bound_ms=2 * A.numel() * 4 / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=median_ms(k3_library),
        shape="256^3 float32, modes (T,T,T)")
    rows["diffusion3d_step_exchange"] = check_k4(cs)
    rows["diffusion2d_step_exchange"] = check_k5(cs)
    rows["halo_write_combined"] = check_k6(ch)
    rows["exchange_slabs"] = check_k4s(cs)
    k4s_wave_err, wave_times = check_k4s_wave(cs, cw, tg)
    rows["exchange_slabs"].update(wave_times)
    rows["exchange_slabs"]["max_abs_err"] = max(rows["exchange_slabs"]["max_abs_err"],
                                                k4s_wave_err)
    rows["wire_pack"], rows["halo_write_multi"] = check_k7_k8(ch, tg)
    rows["acoustic_step_exchange"] = check_k9(cw, tg)
    k4s_stokes_err, stokes_times = check_k4s_stokes(cs, cst, tg)
    rows["exchange_slabs"].update(stokes_times)
    rows["exchange_slabs"]["max_abs_err"] = max(rows["exchange_slabs"]["max_abs_err"],
                                                k4s_stokes_err)
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


def check_k4(cs):
    """K4 on every non-empty mode combination, f32/f64/bf16, 2x2x2 x 64^3;
    then its timing row at 2x2x2 x 256^3 float32, modes (T,T,T)."""
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
            err = max(err, e) if dt != torch.bfloat16 else err
            check(close(got, ref, **TOL[name_of(dt)]),
                  f"K4 2x2x2x{N_CHECK}^3 {name_of(dt)} modes={modes} matches plain "
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
    check(close(out, ref, **TOL["float32"]), f"K4 2x2x2x{n}^3 float32 matches plain ({e:.3e})")
    del ref
    slab_b = sum(s.numel() for p in recvs.values() for s in p) * 4
    bound_b = (cs.step_bytes(T) + slab_b) / HBM_BYTES_PER_S * 1e3
    bound_o = T.numel() * STEP_FLOPS_PER_CELL / F32_FLOPS_PER_S * 1e3
    # K1 on the same stack without halos: what the delivery of received
    # slabs adds to the sweep
    k1_ms = median_ms(lambda: cs.diffusion3d_step(T, Cp, block=block, out=out, **CONSTS))
    return dict(
        max_abs_err=max(err, e), ms=median_ms(k4), k1_same_shape_ms=k1_ms,
        plain_ms=median_ms(lambda: cs.diffusion3d_step_recv_plain(
            T, Cp, recvs, block=block, **CONSTS), batches=3, per_batch=2, warm=1),
        device_ms=device_ms(k4, KERNEL_NAMES["diffusion3d_step_exchange"]),
        bound_ms=max(bound_b, bound_o), bound_by="bytes" if bound_b >= bound_o else "operations",
        library_ms=None, shape=f"2x2x2 x {n}^3 float32, modes (T,T,T)")


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


def halo_cells(block, nblocks, modes, hws):
    """Distinct halo cells of ``nblocks`` blocks: every cell in a flagged
    dim's halo, counted once."""
    import numpy as np

    inner = 1
    for n, m, h in zip(block, modes, hws):
        inner *= n - 2 * h if m else n
    return nblocks * (int(np.prod(block)) - inner)


def check_k6(ch):
    """K6 on every combination its gate admits (z exchanging; hw 1 or 2 on
    x), float32, float64 and int32 (the 4- and 8-byte paths), bitwise; its
    timing row on one `update_halo` of 2x2x2 x 256^3 float32, that call
    also held bitwise against the plain version."""
    import itertools

    import torch

    g = torch.Generator(device="cuda").manual_seed(23)
    block = (N_CHECK,) * 3
    err = 0.0
    for dt, modes, hwx in itertools.product(
            (torch.float32, torch.float64, torch.int32),
            itertools.product((False, True), repeat=2), (1, 2)):
        modes = modes + (True,)
        if hwx == 2 and not modes[0]:
            continue
        hws = (hwx, 1, 1)
        A = (1000 * torch.rand((2 * N_CHECK,) * 3, generator=g, device="cuda")).to(dt)
        recvs = rand_slabs(A.shape, block, [d for d in range(3) if modes[d]], dt, g, hws)
        got = ch.halo_write_combined(A.clone(), recvs, modes=modes, hws=hws, block=block)
        ref = ch.halo_write_combined_plain(A.clone(), recvs, modes=modes, hws=hws, block=block)
        torch.cuda.synchronize()
        err = max(err, max_err(got, ref))
        check(torch.equal(got, ref),
              f"K6 {name_of(dt)} modes={modes} hw_x={hwx} bitwise equal to plain")
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

    cells = halo_cells(block, 8, modes, hws)
    return dict(
        max_abs_err=max(err, e), ms=median_ms(k6),
        plain_ms=median_ms(lambda: ch.halo_write_combined_plain(
            A, recvs, modes=modes, hws=hws, block=block)),
        device_ms=device_ms(k6, KERNEL_NAMES["halo_write_combined"]),
        bound_ms=2 * cells * 4 / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=median_ms(k6_library),
        shape=f"one update_halo of 2x2x2 x {n}^3 float32, hw 1 (all halo cells)")


def check_k4s(cs):
    """K4s: `update_slab` on each dim and range (send and current halo)
    against its plain version (f32/f64/bf16, 2x2x2 x 64^3); the exchange
    form (moves, PROC_NULL edges, two earlier dims' corners; copy and step
    modes) against `exchange_slabs_plain`; its timing row on the y dim of
    the 2x2x2 x 256^3 float32 step (two earlier dims, periodic)."""
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
                err = max(err, e) if dt != torch.bfloat16 else err
                check(close(gs, ref, **TOL[name_of(dt)]),
                      f"K4s update_slab {name_of(dt)} dim {dim} start {st} matches plain ({e:.3e})")
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
                    ok = close(a, b, **TOL["float64"]) if step else torch.equal(a, b)
                    check(ok, f"K4s exchange dim {dim} periodic={periodic} step={step} "
                              f"matches plain ({e:.3e})")
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
    e = max(max_err(a, b) for a, b in zip(k4s(), cs.exchange_slabs_plain(T, 1, 1, moves, **kw)))
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


def phase_main(tg, models, cb, label, nt, **kw):
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
                launches=counts, max_abs_err_vs_plain=err)


def k1_route(tg, cs, p, loc):
    """One step by K1 (no halos) then a standalone `update_halo`: the route
    the port took on multi-block grids before the fused step + exchange."""
    c = dict(lam=p.lam, dt=p.dt, dx=p.dx, dy=p.dy, dz=p.dz)
    return lambda T, Cp: tg.update_halo(cs.diffusion3d_step(T, Cp, block=loc, **c))


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
    print(f"  launches {counts}", flush=True)
    check(counts["diffusion3d_step_exchange"] == 20, "2x2x2: K4 launched once per step")
    check(counts["halo_write_combined"] == 1, "2x2x2: update_halo went through K6")
    check(counts["exchange_slabs"] == 3 * 20 + 3, "2x2x2: K4s launched once per dim")
    check(counts["diffusion3d_step_halo"] == 0 and counts["halo_write"] == 0,
          "2x2x2: neither K1 nor K2 on the fused route")
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
    return counts, dict(k4_route=times, k1_update_halo_route=times_k1,
                        max_abs_err_vs_plain=err)


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
    cells = tg.nx_g() * tg.ny_g() * tg.nz_g()
    rate = cells * nt / t
    print(f"  config 3: nt={nt} in {t:.6f} s = {rate:.6e} cell-updates/s "
          f"(global {tg.nx_g()}x{tg.ny_g()}x{tg.nz_g()}); launches {counts}", flush=True)
    check(counts["diffusion3d_step_exchange"] == nt, "config 3: K4 launched once per step")
    check(counts["halo_write_combined"] == 1, "config 3: update_halo went through K6")
    check(counts["exchange_slabs"] == 3 * nt + 3, "config 3: K4s launched once per dim")
    check(G.shape == (tg.nx_g(), tg.ny_g(), tg.nz_g()) and bool(np.isfinite(G).all()),
          f"config 3: gathered interior finite, shape {G.shape}")
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
    del T, T_run, Up
    Gp = tg.gather_interior(tg.update_halo(models.run_diffusion(T0, Cp, p, nt, nt_chunk=nt)))
    err = float(np.abs(G - Gp).max())
    check(np.allclose(G, Gp, **F64_RUN_TOL),
          f"config 3: matches the plain path on the card (max abs err {err:.3e})")
    check(not np.allclose(G, tg.gather_interior(T0)), "config 3: the state evolved")
    tg.finalize_global_grid()
    os.environ.pop("IGG_USE_PALLAS", None)
    return counts, dict(seconds=t, cell_updates_per_s=rate, global_cells=cells,
                        max_abs_err_vs_plain=err, max_abs_err_vs_k1_route=err_k1,
                        k4_route=times, k1_update_halo_route=times_k1)


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
    return counts, dict(seconds=t, cell_updates_per_s=rate, global_cells=cells,
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


def _y_batch(recv_fn, *args):
    """The y dim's batched K4s arguments (every field, with its z and x
    slabs as earlier dims) of a fused pipeline: ``recv_fn(*args, check)``."""
    seen = {}

    def grab(got, dim, periodic, per_field):
        if dim == 1:
            seen.update(periodic=periodic, per_field=per_field)

    recv_fn(*args, grab)
    return seen["periodic"], seen["per_field"]


def _slab_reads(mode, f, dim):
    """The planes a send-slab cell of field ``f`` at plane j along ``dim``
    reads, as {input field: offsets from j}: the wave mode's face and
    pressure updates (`wave.cuh`), or the Stokes mode's divergence, edge
    stresses, residual and damped update (`stokes.cuh`)."""
    V = ("Vx", "Vy", "Vz")
    vd = V[dim]
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
    """(bound ms, bound_by) of one batched K4s launch along ``dim`` on the
    stacked state ``fields`` ({name: tensor}, every block's): each send slab
    written once, and each plane of an input that some slab cell reads
    (`_slab_reads`, at the slab's start in every block) read once; the
    operations are the three of a face update an output cell, the least
    any cell does. The corners the earlier dims patch in are not counted."""
    local = {g: int(a.shape[dim]) // 2 for g, a in fields.items()}  # 2 blocks along dim
    planes, out_cells = set(), 0
    for f, (moves, _) in per_field.items():
        for m in moves:
            out_cells += fields[f].numel() // local[f]
            for g, offs in _slab_reads(mode, f, dim).items():
                planes.update((g, m.start + o) for o in offs if 0 <= m.start + o < local[g])
    read = sum(fields[g].numel() // local[g] * fields[g].element_size() for g, _ in planes)
    elem = fields["P"].element_size()
    bound_b = (read + out_cells * elem) / HBM_BYTES_PER_S * 1e3
    bound_o = out_cells * 3 / F32_FLOPS_PER_S * 1e3
    return max(bound_b, bound_o), "bytes" if bound_b >= bound_o else "operations"


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
    corners), float32, float64 and bfloat16; the time of the y dim's launch
    (four fields, two slabs each, two earlier dims) at 2x2x2 x 192^3
    float32, config 4's mesh (events and device). Returns (max abs err,
    times)."""
    import torch

    from implicitglobalgrid_tpu_torch.ops.staggered import SlabBatch

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
    n = N_CFG4
    block = (n, n, n)
    gg = _acoustic_grid(tg, n, (2, 2, 2), (1, 1, 1))
    st = _rand_wave_state(cw, block, (2, 2, 2), torch.float32, g)
    periodic, per_field = _y_batch(_wave_recvs, cw, gg, st, block, k)
    # the launcher `AcousticStep` keeps for a run: its arrays built once, no checks
    launcher = SlabBatch("igg_exchange_slabs_wave", block=block, counts=(2, 2, 2), consts=k,
                         const_order=cw._CONST_ORDER, keep=True)

    def launch():
        return launcher(st, 1, 1, periodic, per_field)

    bound, by = slab_batch_bound("wave", dict(zip(cw.FIELDS, st)), 1, per_field)
    times = dict(wave_mode_ms=median_ms(launch),
                 wave_mode_device_ms=device_ms(launch, K4S_STAGGERED),
                 wave_mode_bound_ms=bound, wave_mode_bound_by=by)
    tg.finalize_global_grid()
    return err, times


def check_k7_k8(ch, tg):
    """K8 and K7 against their plain versions, bitwise: slab and flat
    layouts, 2 to 4 fields, float32, float64 and int32, dims 0, 1 and 2,
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
    for (locs, hws), dim, dt in itertools.product(groups, range(3),
                                                  (torch.float32, torch.float64, torch.int32)):
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
    n = N_CFG4
    locs = [(n, n, n), (n + 1, n, n), (n, n + 1, n), (n, n, n + 1)]
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
    shape = "the 3 dims of one coalesced update_halo(P, Vx, Vy, Vz), 2x2x2 x 192^3 float32"
    k8_row = dict(max_abs_err=max(err8, e8), ms=median_ms(k8), plain_ms=median_ms(
        k8_plain, batches=3, per_batch=2, warm=1),
        device_ms=device_ms(k8, KERNEL_NAMES["wire_pack"]),
        bound_ms=2 * slab_b / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=median_ms(k8_library, batches=3, per_batch=3, warm=1), shape=shape)
    k7_row = dict(max_abs_err=max(err7, e7), ms=median_ms(k7), plain_ms=median_ms(
        k7_plain, batches=3, per_batch=2, warm=1),
        device_ms=device_ms(k7, KERNEL_NAMES["halo_write_multi"]),
        bound_ms=2 * slab_b / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=median_ms(k7_library, batches=3, per_batch=3, warm=1), shape=shape)
    return k8_row, k7_row


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
    gg = tg.global_grid()
    block = (n, n, n)
    k = cw.wave_consts(rho=p.rho, K=p.K, dt=p.dt, dx=p.dx, dy=p.dy, dz=p.dz)
    k9_own = dict(initial=k9_kernels_ms(cw, gg, s0, block, k),
                  after_steps=k9_kernels_ms(cw, gg, s, block, k), steps=nt)
    print(f"  K9 on config 4's own states (device ms): {k9_own}", flush=True)
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
    return counts, dict(seconds=t, cell_updates_per_s=rate, global_cells=cells,
                        max_abs_err_vs_plain=err, max_abs_err_plain_route=err_p,
                        k9_route=times, k9_kernels_ms=k9_own, bf16=bf16)


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
    float32 and float64 (one batched launch a dim for the four fields); the
    time of the y dim's launch (four fields, two slabs each, two earlier
    dims) at 2x2x2 x 128^3 float32, config 5's mesh (events and device).
    Returns (max abs err, times)."""
    import torch

    from implicitglobalgrid_tpu_torch.ops.staggered import SlabBatch

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
    n = N_CFG5
    block = (n, n, n)
    gg = _acoustic_grid(tg, n, (2, 2, 2), (0, 0, 0))
    st = _rand_stokes_state(cst, block, (2, 2, 2), torch.float32, g)
    periodic, per_field = _y_batch(_stokes_recvs, cst, gg, st, block, STOKES)
    # the launcher `StokesStep` keeps for a run: its arrays built once, no checks
    launcher = SlabBatch("igg_exchange_slabs_stokes", block=block, counts=(2, 2, 2),
                         consts=STOKES, const_order=cst._CONST_ORDER, keep=True)

    def launch():
        return launcher(st, 1, 1, periodic, per_field)

    bound, by = slab_batch_bound("stokes", dict(zip(cst.STATE, st)), 1, per_field)
    times = dict(stokes_mode_ms=median_ms(launch),
                 stokes_mode_device_ms=device_ms(launch, K4S_STAGGERED),
                 stokes_mode_bound_ms=bound, stokes_mode_bound_by=by)
    tg.finalize_global_grid()
    return err, times


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

    n, chunk, max_iters, tol = N_CFG5, 500, 6000, 5e-4
    print(f"phase: BASELINE config 5, one {n}^3 block float32, <= {max_iters} PT iterations",
          flush=True)
    grid(tg, n, n, n)
    s0, p = models.init_stokes3d(dtype=torch.float32)
    models.stokes_residuals(models.run_stokes(s0, p, chunk, nt_chunk=chunk), p)  # warm
    cb.reset_launch_counts()
    tg.tic()
    it, state, res = 0, s0, (float("inf"), float("inf"))
    history = []
    while it < max_iters:
        state = models.run_stokes(state, p, chunk, nt_chunk=chunk)
        it += chunk
        res = models.stokes_residuals(state, p)
        history.append((it, *res))
        print(f"  iters={it:6d}  max|divV|={res[0]:.3e}  max|R|={res[1]:.3e}", flush=True)
        if max(res) < tol:
            break
    t = tg.toc()
    P = tg.gather_interior(state[0])
    torch.cuda.synchronize()
    counts = cb.launch_counts()
    cells = tg.nx_g() * tg.ny_g() * tg.nz_g()
    rate = cells * it / t
    status = "converged" if max(res) < tol else "max-iters"
    print(f"  config 5 single: {status} after {it} PT iterations in {t:.6f} s = {rate:.6e} "
          f"cell-updates/s (global {tg.nx_g()}x{tg.ny_g()}x{tg.nz_g()}); P range "
          f"[{float(P.min()):+.3e}, {float(P.max()):+.3e}]; launches {counts}", flush=True)
    check(counts["stokes_step_exchange"] == it and sum(counts.values()) == it,
          "config 5 single: K10 once per iteration, nothing else")
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
    f20 = [tg.gather_interior(a) for a in models.run_stokes(s0, p, 20, nt_chunk=20)[:4]]
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
    err = max(float(np.abs(a.astype(np.float64) - b).max()) for a, b in zip(f20, p20))
    ok = all(np.allclose(a, b, rtol=1e-4, atol=1e-5 * max(1e-30, float(np.abs(b).max())))
             for a, b in zip(f20, p20))
    check(ok, f"config 5 mesh: 20 fused iterations match the plain route ({err:.3e})")
    check(not np.allclose(G[3], tg.gather_interior(s0[3])), "config 5 mesh: the flow evolved")
    tg.finalize_global_grid()
    return counts, dict(seconds=t, cell_updates_per_s=rate, global_cells=cells,
                        residuals=list(res), max_abs_err_vs_plain_20=err, k10_route=times,
                        k10_solver_device_ms=solver_ms, k10_solver_kernels_device_ms=both,
                        state_magnitudes=mags)


# config 5's dx on one 128^3 block and on the 2x2x2 mesh, the 3 of divV/3,
# chip_smoke's spacing, and random divisors of either sign from a seed
CDIV_DIVISORS = (10 / 127, 10 / 253, 3.0, 0.079)
F64_SAMPLE = 1 << 26


def k10_build_report(cb, info):
    """Registers, stack frame and spills of every K10 template (ptxas), and
    the IEEE division in its SASS (cuobjdump): the multi-rank kernels' own
    code must hold no division sequence, only calls to cdiv.cuh's
    out-of-line fallback. Returns {kernel: {...}}."""
    import re

    rep = ptxas_report(info.get("ptxas", ""), "stokes_step_kernel")
    cuobjdump = os.path.join(os.path.dirname(cb._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", info["path"]], capture_output=True, text=True,
                          timeout=300)
    check(sass.returncode == 0, "cuobjdump -sass read the kernel library")
    # a kernel's listing ends with the subroutines it calls (cdiv.cuh's
    # out-of-line IEEE division and its slow path): the kernel's own code
    # lies below the lowest call target. FCHK is the float32 division's range
    # check, MUFU.RCP64H the float64 division's reciprocal (an integer
    # division takes MUFU.RCP, not these).
    listing, fn = {}, None
    for line in sass.stdout.splitlines():
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
    for name, r in rep.items():
        print(f"  K10 {name}: {r.get('registers')} registers, {r.get('stack')} bytes stack "
              f"frame, {r.get('spill_stores')}/{r.get('spill_loads')} bytes spill "
              f"stores/loads; SASS: {r.get('kernel_instructions')} instructions before the "
              f"first subroutine, {r.get('division_checks')} IEEE division checks there, "
              f"{r.get('division_checks_in_subroutines')} in the subroutines, calls "
              f"{r.get('calls')}", flush=True)
    # the multi-rank route's templates: the tiles and the per-column kernel
    # with SELF false (mangled "Lb0E")
    multi = {n: r for n, r in rep.items() if "column" not in n or "Lb0E" in n}
    check(len(multi) == 4 and all(r.get("division_checks") == 0 for r in multi.values()),
          "K10 multi-rank kernels (tiles and per-column, float32 and float64): no IEEE "
          "division in the kernels' own SASS (only in cdiv.cuh's out-of-line fallback)")
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


def card_name():
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"


def main() -> int:
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
        k10_build = k10_build_report(cb, info)
        k9_build = k9_build_report(info)
        cdiv = phase_cdiv(cb)
        print("phase: kernels vs plain", flush=True)
        rows = phase_kernels((cs, ch, cb, cw, cst, tg), cb.launch_counts())
        periodic = phase_main(tg, models, cb, "periodic", 100,
                              periodx=1, periody=1, periodz=1)
        novis = phase_main(tg, models, cb, "non-periodic", 100)
        mesh_counts, mesh = phase_mesh(tg, models, cb, cs)
        cfg3_counts, cfg3 = phase_config3(tg, models, cb, cs)
        cfg2_counts, cfg2 = phase_config2(tg, models, cb)
        cfg4_counts, cfg4 = phase_config4_single(tg, models, cb, cw)
        cfg4m_counts, cfg4m = phase_config4_mesh(tg, models, cb, cw)
        cfg5_counts, cfg5 = phase_config5_single(tg, models, cb, cst)
        cfg5m_counts, cfg5m = phase_config5_mesh(tg, models, cb, cst)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    paths = [periodic["launches"], novis["launches"], mesh_counts, cfg3_counts, cfg2_counts,
             cfg4_counts, cfg4m_counts, cfg5_counts, cfg5m_counts]
    launches = {k: sum(c[k] for c in paths) for k in KERNEL_NAMES}
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
                                    "implicitglobalgrid_tpu/ops/pallas_stokes.py:132,286")}
    rows["stokes_step_exchange"]["ptxas_sass"] = k10_build
    rows["acoustic_step_exchange"]["ptxas"] = k9_build
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
                                        "kernels_device_ms",
                                        "ptxas_sass")}))
    k1_dev = rows["diffusion3d_step_halo"]["device_ms"]
    if k1_dev is not None:  # the periodic step is one K1 (T,T,T) launch
        periodic["k1_device_share"] = 100 * k1_dev / (periodic["seconds"] * 1e3 / 100)
    print(json.dumps({"main_path": {"periodic_256": periodic, "nonperiodic_256": novis,
                                    "mesh_2x2x2_128": mesh, "config3_2x2x2_256_f64": cfg3,
                                    "config2_2x2_4096_f32": cfg2,
                                    "config4_192_f32": cfg4, "config4_2x2x2_192_f32": cfg4m,
                                    "config5_128_f32": cfg5, "config5_2x2x2_128_f32": cfg5m},
                      "cdiv": cdiv,
                      "seconds_total": time.perf_counter() - t_start}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
