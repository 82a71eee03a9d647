#!/usr/bin/env python3
"""Drive the PyTorch port (`implicitglobalgrid_tpu_torch`) on one CUDA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, in order; any failure exits non-zero without the final line:

1. build the CUDA kernels from `implicitglobalgrid_tpu_torch/csrc/`;
2. hold every kernel against its plain PyTorch version on the card, at the
   main path's shapes (step K1 bitwise-close, halo copies K2/K3 bitwise),
   and time kernel, plain version and PyTorch slice copies (CUDA events),
   and each kernel's device time alone (torch.profiler);
3. main path, periodic: `init_global_grid(256, 256, 256, periodic)` ->
   `init_diffusion3d` -> warm chunk -> tic -> `run_diffusion(nt=100)` -> toc
   -> `update_halo` -> `gather_interior`, against the same run with
   ``IGG_USE_PALLAS=0`` (the plain path on the card);
4. the same, non-periodic (the reference example's novis configuration);
5. the virtual mesh: a 2x2x2 grid of 128^3 blocks, `update_halo` and
   `gather` bitwise against the plain path, a diffusion run against the
   plain path, and a small run against the CPU;
6. numbers: the card's name and power limit, each kernel's time, bound,
   plain and library times (one JSON line), cell-updates/s.

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
TOL = {"float32": dict(rtol=2e-6, atol=2e-5), "float64": dict(rtol=1e-13, atol=1e-12),
       "bfloat16": dict(rtol=2 ** -7, atol=0.0)}
RUN_TOL = dict(rtol=1e-5, atol=1e-4)  # the JAX suite's multi-step bound
N_MAIN = 256  # local block of the main path (the reference's per-GPU block)
N_MESH = 128  # local block of the 2x2x2 virtual mesh


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


def device_ms(fn, kernel, reps=20):
    """Device time (ms) per call of ``fn`` spent in the kernels whose name
    holds ``kernel``, from torch.profiler (CUPTI) over ``reps`` calls; None
    where the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    tot = sum(ev.device_time_total for ev in prof.key_averages() if kernel in ev.key)
    return tot / reps / 1e3 if tot > 0 else None


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

    cs, ch, cb = igg_ops
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
    counts = cb.launch_counts()
    for name in rows:
        check(counts[name] > counts_before[name], f"{name} launch counter moved")
    return rows


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


def phase_mesh(tg, models, cb):
    """Phase 5: the 2x2x2 virtual mesh of 128^3 blocks."""
    import numpy as np
    import torch

    print(f"phase: virtual mesh 2x2x2 x {N_MESH}^3", flush=True)
    kw = dict(dimx=2, dimy=2, dimz=2, periodx=1)
    grid(tg, N_MESH, N_MESH, N_MESH, **kw)
    g = torch.Generator(device="cuda").manual_seed(11)
    A = torch.randn((2 * N_MESH,) * 3, generator=g, device="cuda")
    T0, Cp, p = models.init_diffusion3d(dtype=torch.float32)
    cb.reset_launch_counts()
    U = tg.update_halo(A.clone())
    T = models.run_diffusion(T0, Cp, p, 20, nt_chunk=20)
    gU, giU, gT = tg.gather(U), tg.gather_interior(U), tg.gather_interior(T)
    counts = cb.launch_counts()
    print(f"  launches {counts}", flush=True)
    check(counts["halo_write"] > 0, "2x2x2: update_halo went through K2")
    check(counts["diffusion3d_step_halo"] == 20, "2x2x2: K1 launched once per step")
    grid(tg, N_MESH, N_MESH, N_MESH, plain=True, **kw)
    Up = tg.update_halo(A.clone())
    check(torch.equal(U, Up), "2x2x2: update_halo bitwise equal to the plain path")
    check(np.array_equal(gU, tg.gather(Up)) and np.array_equal(giU, tg.gather_interior(Up)),
          "2x2x2: gather and gather_interior bitwise equal")
    Gp = tg.gather_interior(models.run_diffusion(T0, Cp, p, 20, nt_chunk=20))
    check(np.isfinite(gT).all() and np.allclose(gT, Gp, **RUN_TOL),
          "2x2x2: 20-step run matches the plain path")

    # a small reference: the card's kernel path against the CPU in float64
    grid(tg, 16, 16, 16, periodx=1, periody=1, periodz=1)
    T0, Cp, p = models.init_diffusion3d(dtype=torch.float64)
    Tg = tg.gather_interior(models.run_diffusion(T0, Cp, p, 10))
    grid(tg, 16, 16, 16, periodx=1, periody=1, periodz=1, device_type="cpu")
    Tc = tg.gather_interior(models.run_diffusion(T0.cpu(), Cp.cpu(), p, 10, impl="plain"))
    check(np.allclose(Tg, Tc, rtol=1e-12, atol=1e-12),
          "16^3 float64: card kernel path matches the CPU plain path")
    tg.finalize_global_grid()
    return counts


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
            if "registers" in line or "spill" in line or line.startswith("=="):
                print("  " + line.strip())
        print("phase: kernels vs plain", flush=True)
        rows = phase_kernels((cs, ch, cb), cb.launch_counts())
        periodic = phase_main(tg, models, cb, "periodic", 100,
                              periodx=1, periody=1, periodz=1)
        novis = phase_main(tg, models, cb, "non-periodic", 100)
        mesh = phase_mesh(tg, models, cb)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    launches = {k: periodic["launches"][k] + novis["launches"][k] + mesh[k]
                for k in mesh}
    for name, n in launches.items():
        if n == 0:
            print(f"chip_smoke: FAILED: {name} never launched on the main path",
                  file=sys.stderr)
            return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    src = {"diffusion3d_step_halo": ("implicitglobalgrid_tpu_torch/csrc/stencil.cu",
                                     "implicitglobalgrid_tpu/ops/pallas_stencil.py:72,839"),
           "halo_write": ("implicitglobalgrid_tpu_torch/csrc/halo.cu",
                          "implicitglobalgrid_tpu/ops/pallas_halo.py:142"),
           "halo_self_exchange": ("implicitglobalgrid_tpu_torch/csrc/halo.cu",
                                  "implicitglobalgrid_tpu/ops/pallas_halo.py:558")}
    kernels = []
    for name, r in rows.items():
        kernels.append(dict(name=name, route="cuda", source=src[name][0],
                            replaces=src[name][1], launches=launches[name],
                            max_abs_err=r["max_abs_err"], ms=r["ms"],
                            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"], library_ms=r["library_ms"],
                            device_ms=r["device_ms"], shape=r["shape"]))
    k1_dev = rows["diffusion3d_step_halo"]["device_ms"]
    if k1_dev is not None:  # the periodic step is one K1 (T,T,T) launch
        periodic["k1_device_share"] = 100 * k1_dev / (periodic["seconds"] * 1e3 / 100)
    print(json.dumps({"main_path": {"periodic_256": periodic, "nonperiodic_256": novis},
                      "seconds_total": time.perf_counter() - t_start}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
