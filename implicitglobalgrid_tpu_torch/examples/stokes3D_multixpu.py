"""3-D pseudo-transient Stokes flow on the implicit global grid: the JAX
package's `examples/stokes3D_multixpu.py` (BASELINE config 5) on the port's
API, its physics and printed lines. The damped PT system for a buoyant
sphere is iterated until the global residuals (`stokes_residuals`, a
maximum over every process's box) drop below ``tol``.

Run:  python -m implicitglobalgrid_tpu_torch.examples.stokes3D_multixpu [--cpu]
      torchrun --nproc_per_node=N -m implicitglobalgrid_tpu_torch.examples.stokes3D_multixpu

``--cpu``: 8 ranks of 24^3 on the CPU, at most 300 iterations checked every
100; else one 96^3 block a process on its card, at most 6000 checked every
500.
"""

import sys

import torch

import implicitglobalgrid_tpu_torch as igg
from implicitglobalgrid_tpu_torch.examples.diffusion3D_multixpu_novis import grid_args
from implicitglobalgrid_tpu_torch.models import init_stokes3d, run_stokes, stokes_residuals


def solve(p, state, max_iters, check_every, tol, me, log=print):
    """The solver loop: ``check_every`` iterations, then the residuals,
    until they drop below ``tol`` or ``max_iters``. Returns ``(state,
    iterations, history)``, ``history`` a ``(iterations, max|divV|, max|R|)``
    a check."""
    it, history = 0, []
    while it < max_iters:
        state = run_stokes(state, p, check_every, nt_chunk=check_every)
        it += check_every
        err_div, err_mom = stokes_residuals(state, p)
        history.append((it, err_div, err_mom))
        if me == 0:
            log(f"iters={it:6d}  max|divV|={err_div:.3e}  max|R|={err_mom:.3e}")
        if max(err_div, err_mom) < tol:
            break
    return state, it, history


def stokes3D(cpu: bool = False, n: int | None = None, max_iters: int | None = None,
             check_every: int | None = None, tol: float = 5e-4, finalize: bool = True,
             log=print):
    """Run the example. Returns ``{"P": the final pressure interior
    (gather_interior) on process 0, None elsewhere, "iterations",
    "history", "seconds", "status", "state": the final state, "init": the
    initial state, "params"}``; ``finalize=False`` leaves the grid up for
    the caller."""
    n = n or (24 if cpu else 96)
    max_iters = max_iters or (300 if cpu else 6000)
    check_every = check_every or (100 if cpu else 500)
    me, dims, nprocs, coords, mesh = igg.init_global_grid(n, n, n, **grid_args(cpu))

    s0, p = init_stokes3d(dtype=torch.float32)
    # warm the chunk and the residuals (the advanced state is discarded) so
    # tic/toc measures the solve
    stokes_residuals(run_stokes(s0, p, check_every, nt_chunk=check_every), p)
    igg.tic()
    state, it, history = solve(p, s0, max_iters, check_every, tol, me, log)
    t = igg.toc()
    err = max(history[-1][1:])

    P = igg.gather_interior(state[0])
    status = "converged" if err < tol else "max-iters"
    if me == 0:
        log(f"{status} after {it} PT iterations in {t:.2f}s "
            f"({igg.nx_g()}x{igg.ny_g()}x{igg.nz_g()} global, "
            f"{nprocs} device(s)); P range [{float(P.min()):+.3e}, "
            f"{float(P.max()):+.3e}]")
    if finalize:
        igg.finalize_global_grid(finalize_dist=True)
    return dict(P=P, iterations=it, history=history, seconds=t, status=status,
                state=state, init=s0, params=p)


if __name__ == "__main__":
    stokes3D(cpu="--cpu" in sys.argv)
