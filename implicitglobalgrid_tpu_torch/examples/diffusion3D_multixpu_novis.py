"""3-D heat diffusion on the implicit global grid: the reference's canonical
example (`diffusion3D_multicpu_novis.jl`) on the port's API, the physics and
printed lines of the JAX package's `examples/diffusion3D_multixpu_novis.py`.

Run:  python -m implicitglobalgrid_tpu_torch.examples.diffusion3D_multixpu_novis [--cpu]
      torchrun --nproc_per_node=N -m implicitglobalgrid_tpu_torch.examples.diffusion3D_multixpu_novis

``--cpu``: 8 ranks of 64^3 on the CPU, 100 steps; else one 256^3 block a
process on its card, 1000 steps.
"""

import sys

import torch

import implicitglobalgrid_tpu_torch as igg
from implicitglobalgrid_tpu_torch.models import init_diffusion3d, run_diffusion


def grid_args(cpu: bool) -> dict:
    """The device arguments of `init_global_grid`: 8 ranks on the CPU, else
    one rank a process on its card."""
    return dict(device_type="cpu", nranks=8) if cpu else {}


def diffusion3D(cpu: bool = False, n: int | None = None, nt: int | None = None):
    """Run the example; return the final interior (`gather_interior`) on
    process 0, None elsewhere."""
    n = n or (64 if cpu else 256)
    nt = nt or (100 if cpu else 1000)
    me, dims, nprocs, coords, mesh = igg.init_global_grid(n, n, n, **grid_args(cpu))

    # ICs: two Gaussian anomalies each for Cp and T
    T, Cp, p = init_diffusion3d(lam=1.0, cp_min=1.0, lx=10.0, ly=10.0, lz=10.0,
                                dtype=torch.float32)

    # one warm chunk (the kernels load, buffers are allocated) so tic/toc
    # measures steady state; run_diffusion returns once the device drained
    chunk = max(1, nt // 10)
    run_diffusion(T, Cp, p, chunk, nt_chunk=chunk)
    igg.tic()
    T = run_diffusion(T, Cp, p, nt, nt_chunk=chunk)
    t = igg.toc()

    cells = igg.nx_g() * igg.ny_g() * igg.nz_g()
    G = igg.gather_interior(T)  # collective: every process calls it
    if me == 0:
        print(f"nt={nt} steps on {nprocs} device(s): {t:.3f}s "
              f"({cells * nt / t / 1e9:.2f} G cell-updates/s)")
        print(f"T interior mean: {float(G.mean()):.6f}")
    igg.finalize_global_grid(finalize_dist=True)
    return G


if __name__ == "__main__":
    diffusion3D(cpu="--cpu" in sys.argv)
