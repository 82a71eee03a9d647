"""3-D heat diffusion with in-situ visualization: the JAX package's
`examples/diffusion3D_multixpu.py` on the port's API. The supervised run
(`run_resilient`) writes ASYNC sharded snapshots of T every ``nvis`` steps
(the step loop never waits on disk, no gather ever) and streams T's max and
mean from an in-situ `Stats` reducer after each chunk; after the run the
frames are assembled by the lazy reader, one O(plane) `read_global` box a
snapshot, pulling only the z-midplane.

Run:  python -m implicitglobalgrid_tpu_torch.examples.diffusion3D_multixpu [--cpu]
      torchrun --nproc_per_node=N -m implicitglobalgrid_tpu_torch.examples.diffusion3D_multixpu

``--cpu``: 8 ranks of 64^3 on the CPU, 100 steps, a frame every 10; else one
128^3 block a process on its card (the kernel route), 1000 steps, a frame
every 100. Run as a script it writes diffusion3D.gif where matplotlib can,
else diffusion3D_frames.npy, into the working directory.
"""

import shutil
import sys
import tempfile

import numpy as np
import torch

import implicitglobalgrid_tpu_torch as igg
from implicitglobalgrid_tpu_torch.examples.diffusion3D_multixpu_novis import grid_args
from implicitglobalgrid_tpu_torch.models import init_diffusion3d, make_step


def diffusion3D(cpu: bool = False, n: int | None = None, nt: int | None = None,
                nvis: int | None = None):
    """Run the example. Returns ``(frames, G)`` on process 0: the z-midplane
    of T at every snapshot (an ``(nt // nvis, nx_g, ny_g)`` array, oldest
    first) and the final interior (`gather_interior(T)`); ``(None, None)``
    elsewhere."""
    n = n or (64 if cpu else 128)
    nt = nt or (100 if cpu else 1000)
    nvis = nvis or (10 if cpu else 100)
    me, dims, nprocs, coords, mesh = igg.init_global_grid(n, n, n, **grid_args(cpu))

    T, Cp, p = init_diffusion3d(dtype=torch.float32)
    step_T = make_step(p)  # the kernel route while IGG_USE_PALLAS is on

    def step(s):
        return {"T": step_T(s["T"], s["Cp"]), "Cp": s["Cp"]}

    # Supervised run with async snapshots every nvis steps (O(box) per
    # process, committed in the background by process 0) and an in-situ
    # stats reducer (rides the health guard's one sum). The snapshot root
    # is ONE directory every process writes into: process 0 names it.
    snaps = igg.global_grid().transport.broadcast_one_to_all(
        tempfile.mkdtemp(prefix="diffusion3D_snapshots_") if me == 0 else None)
    state, reports = igg.run_resilient(
        step, {"T": T, "Cp": Cp}, nt, nt_chunk=nvis, key="diffusion3D_vis",
        snapshot_dir=snaps, snapshot_every=nvis, snapshot_fields=("T",),
        reducers=[igg.Stats("T", which=("max", "mean"))],
        on_reduce=lambda s, v: me == 0 and print(
            f"step {s:4d}  max={v['stats:T']['max']:.3f}  "
            f"mean={v['stats:T']['mean']:.4f}"))
    G = igg.gather_interior(state["T"])  # collective: every process calls it

    # Analysis side: ONLY the z-midplane of each snapshot, an O(plane) read
    # a frame, never the global volume (host-only numpy; this part could run
    # on another machine).
    frames = None
    if me == 0:
        listed = igg.list_snapshots(snaps)
        zmid = igg.open_snapshot(listed[0][1]).global_shape("T")[2] // 2
        frames = np.stack([
            igg.open_snapshot(path).read_global("T", box=(None, None, (zmid, zmid + 1)))[:, :, 0]
            for _, path in listed])
        shutil.rmtree(snaps, ignore_errors=True)  # every writer drained in run_resilient
    igg.finalize_global_grid(finalize_dist=True)
    return frames, G


def save_frames(frames) -> None:
    """diffusion3D.gif (matplotlib with pillow), else diffusion3D_frames.npy."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.animation as anim
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots()
        im = ax.imshow(frames[0].T, origin="lower", cmap="inferno", vmin=0,
                       vmax=float(frames.max()))

        def update(f):
            im.set_data(f.T)
            return [im]

        anim.FuncAnimation(fig, update, frames=list(frames), blit=True).save(
            "diffusion3D.gif", writer="pillow", fps=5)
        print("wrote diffusion3D.gif")
    except Exception as e:  # matplotlib/pillow unavailable
        np.save("diffusion3D_frames.npy", frames)
        print(f"wrote diffusion3D_frames.npy ({e.__class__.__name__}: no gif)")


if __name__ == "__main__":
    frames, _ = diffusion3D(cpu="--cpu" in sys.argv)
    if frames is not None:
        save_frames(frames)
