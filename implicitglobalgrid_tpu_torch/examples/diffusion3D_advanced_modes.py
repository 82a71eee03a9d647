"""The modes the reference cannot express, in one script, on the port's API
(the JAX package's `examples/diffusion3D_advanced_modes.py`):

1. STOCHASTIC-ROUNDING bfloat16 storage (``sr=True``): an unbiased store
   a step, so a long run tracks the float32 trajectory where plain
   bfloat16 stagnates.
2. COMMUNICATION-AVOIDING deep halos (``comm_every=2``): a 2-wide exchange
   every 2 steps on a grid with 2-wide halos; the same trajectory, half
   the exchanges.
3. MEASURED overlap: `trace` + `overlap_stats` turn the interior-first
   schedule (``overlap=True``) into numbers.

Run:  python -m implicitglobalgrid_tpu_torch.examples.diffusion3D_advanced_modes [--cpu]

``--cpu``: 8 ranks of 32^3 on the CPU, 40 steps; else one 192^3 block a
process on its card, 400 steps.
"""

import sys
import tempfile

import torch

import implicitglobalgrid_tpu_torch as igg
from implicitglobalgrid_tpu_torch.examples.diffusion3D_multixpu_novis import grid_args
from implicitglobalgrid_tpu_torch.models import init_diffusion3d, run_diffusion


def sr_vs_bf16(cpu: bool, nx: int, nt: int) -> dict:
    """Part 1: the final interiors (`gather_interior`, float64 on process
    0) of float32, plain bfloat16 and stochastic-rounding bfloat16 runs,
    and each bfloat16 run's max-rel distance from float32 (None off
    process 0)."""
    finals = {}
    for tag, dtype, sr in (("f32", torch.float32, False), ("bf16", torch.bfloat16, False),
                           ("bf16_sr", torch.bfloat16, True)):
        igg.init_global_grid(nx, nx, nx, quiet=True, **grid_args(cpu))
        T, Cp, p = init_diffusion3d(dtype=dtype, sr=sr)
        out = run_diffusion(T, Cp, p, nt, nt_chunk=nt, impl="plain" if not sr else None)
        g = igg.gather_interior(out)
        finals[tag] = None if g is None else g.astype("float64")
        igg.finalize_global_grid()
    errs = {}
    if finals["f32"] is not None:
        scale = abs(finals["f32"]).max()
        for tag in ("bf16", "bf16_sr"):
            errs[tag] = float(abs(finals[tag] - finals["f32"]).max() / scale)
            print(f"{tag:8s} vs f32 after {nt} steps: max_rel={errs[tag]:.2e}")
    return errs


def deep_halos(cpu: bool, nx: int, nt: int) -> float:
    """Part 2: ``comm_every=2`` on a grid with 2-wide halos; returns the
    run's seconds (`tic`/`toc`)."""
    igg.init_global_grid(nx + 2, nx + 2, nx + 2, overlaps=(4, 4, 4), halowidths=(2, 2, 2),
                         periodx=1, periody=1, periodz=1, quiet=True, **grid_args(cpu))
    T, Cp, p = init_diffusion3d(dtype=torch.float32, comm_every=2)
    igg.tic()
    run_diffusion(T, Cp, p, nt, nt_chunk=nt)
    t = igg.toc()
    if igg.global_grid().me == 0:
        print(f"comm_every=2: {nt} steps in {t:.3f}s ({nt // 2} exchanges instead of {nt})")
    igg.finalize_global_grid()
    return t


def measured_overlap(cpu: bool, nx: int) -> dict:
    """Part 3: `overlap_stats` of 8 overlapped steps (after 8 warm ones)."""
    igg.init_global_grid(nx, nx, nx, periodx=1, periody=1, periodz=1, quiet=True,
                         **grid_args(cpu))
    T, Cp, p = init_diffusion3d(dtype=torch.float32, overlap=True)
    run_diffusion(T, Cp, p, 8, nt_chunk=8, impl="plain")  # warm
    with tempfile.TemporaryDirectory() as d:
        with igg.trace(d):
            run_diffusion(T, Cp, p, 8, nt_chunk=8, impl="plain")
        stats = igg.overlap_stats(d)
    for dev, s in sorted(stats.items()):
        frac = s["overlap_frac"]
        print(f"overlap[{dev}]: hidden {s['hidden_comm_us']:.0f}us / {s['comm_us']:.0f}us comm "
              f"({'n/a' if frac is None else f'{100 * frac:.0f}%'})")
    igg.finalize_global_grid(finalize_dist=True)
    return stats


def main(cpu: bool = False) -> dict:
    nx = 32 if cpu else 192
    nt = 40 if cpu else 400
    return {"sr": sr_vs_bf16(cpu, nx, nt), "deep_s": deep_halos(cpu, nx, nt),
            "overlap": measured_overlap(cpu, nx)}


if __name__ == "__main__":
    main(cpu="--cpu" in sys.argv)
