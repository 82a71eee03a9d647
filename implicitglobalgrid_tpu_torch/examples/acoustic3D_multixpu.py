"""3-D staggered-grid acoustic wave on the implicit global grid: the JAX
package's `examples/acoustic3D_multixpu.py` (BASELINE config 4) on the
port's API, its physics and printed lines. Leapfrog pressure/velocity
updates on staggered fields (Vx is ``(nx+1, ny, nz)``), all periodic, the
fused step + exchange (K4s + K9).

Run:  python -m implicitglobalgrid_tpu_torch.examples.acoustic3D_multixpu [--cpu]
      torchrun --nproc_per_node=N -m implicitglobalgrid_tpu_torch.examples.acoustic3D_multixpu

``--cpu``: 8 ranks of 32^3 on the CPU, 60 steps; else one 192^3 block a
process on its card, 600 steps.
"""

import sys

import numpy as np
import torch

import implicitglobalgrid_tpu_torch as igg
from implicitglobalgrid_tpu_torch.examples.diffusion3D_multixpu_novis import grid_args
from implicitglobalgrid_tpu_torch.models import init_acoustic3d, run_acoustic


def acoustic3D(cpu: bool = False, n: int | None = None, nt: int | None = None):
    """Run the example; return the final pressure interior
    (`gather_interior`) on process 0, None elsewhere."""
    n = n or (32 if cpu else 192)
    nt = nt or (60 if cpu else 600)
    me, dims, nprocs, coords, mesh = igg.init_global_grid(
        n, n, n, periodx=1, periody=1, periodz=1, **grid_args(cpu))

    state, p = init_acoustic3d(dtype=torch.float32)

    chunk = max(1, nt // 10)
    run_acoustic(state, p, chunk, nt_chunk=chunk)  # warm
    igg.tic()
    state = run_acoustic(state, p, nt, nt_chunk=chunk)
    t = igg.toc()

    P = igg.gather_interior(state[0])
    cells = igg.nx_g() * igg.ny_g() * igg.nz_g()
    if me == 0:
        print(f"nt={nt} steps on {nprocs} device(s): {t:.3f}s "
              f"({cells * nt / t / 1e9:.2f} G cell-updates/s)")
        print(f"P interior: mean {float(P.mean()):+.3e}  "
              f"max |P| {float(np.abs(P).max()):.3e}")
    igg.finalize_global_grid(finalize_dist=True)
    return P


if __name__ == "__main__":
    acoustic3D(cpu="--cpu" in sys.argv)
