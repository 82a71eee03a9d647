#!/usr/bin/env python3
"""Span-end gaps of the transport's two-process `run_resilient`, by tree and mode.

`chip_smoke.py`'s transport phase holds each chunk's spans, in the aligned
flight streams of its two processes on one card, to end within 1 ms of
each other. This script measures that gap for several trees of the
repository in one call on the card, so that two versions compare on the
same card (arms alternate between launches):

    python3 ab_span_gaps.py <tree>:<mode>[,<tree>:<mode>...] <launches> <reps>

``tree`` is a checkout of the repository (for the parent commit, unpack
`git archive` into a git-ignored directory); ``mode`` is ``default``,
``nogc`` (the cyclic garbage collector off in both processes during the
runs) or a thread count (``OMP_NUM_THREADS``). Each launch starts two
processes (gloo on cuda:0, the 2x2x2 x 128^3 diffusion mesh split along
z, as the transport phase), which run ``reps`` times the phase's
`run_resilient` (10 plain-route steps in chunks of 5, a checkpoint a chunk,
a NaN in process 1's box and its rollback), each into a flight directory
of its own. Prints every run's per-chunk gaps (µs) and, last, a JSON
summary an arm: runs, runs with a gap over 1 ms, the largest gap and the
median gap of each chunk. Needs one card.
"""

import json
import os
import socket
import subprocess
import sys
import tempfile

N = 128  # the transport phase's mesh block


def child(tree, pid, port, root, reps, mode):
    sys.path.insert(0, tree)
    import gc

    import torch
    import torch.distributed as dist

    import implicitglobalgrid_tpu_torch as tg
    from implicitglobalgrid_tpu_torch import models

    torch.cuda.set_device(0)
    os.environ["IGG_TPU_DCN_AXES"] = "z"
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=pid)
    tg.init_global_grid(N, N, N, dimx=2, dimy=2, dimz=2, periodx=1, quiet=True,
                        init_dist=False, select_device=False)
    for r in range(reps):
        T0, Cp, p = models.init_diffusion3d(dtype=torch.float32)
        fdir = os.path.join(root, f"f{r}")
        os.makedirs(fdir, exist_ok=True)
        tg.start_flight_recorder(fdir, run_id=f"gaps{r}")
        if mode == "nogc":
            gc.collect()
            gc.disable()
        try:
            tg.run_resilient(
                lambda s: {"T": models.diffusion_step_local(s["T"], s["Cp"], p, "plain"),
                           "Cp": s["Cp"]},
                {"T": T0, "Cp": Cp}, 10, nt_chunk=5, checkpoint_dir=os.path.join(root, f"ck{r}"),
                faults=[tg.NaNPoke(step=6, name="T", index=(5, 6, N + 7))])
        finally:
            gc.enable()
            tg.stop_flight_recorder()
    tg.finalize_global_grid()
    dist.destroy_process_group()


def gaps(tree, root, reps):
    """Per run, each chunk's gap (µs) between the two processes' aligned
    span ends (`aggregate_flight`, `export_chrome_trace`)."""
    sys.path.insert(0, tree)
    import implicitglobalgrid_tpu_torch as tg

    out = []
    for r in range(reps):
        doc = tg.export_chrome_trace(tg.aggregate_flight(os.path.join(root, f"f{r}")))
        ends = {}
        for e in doc["traceEvents"]:
            if e.get("ph") == "X" and e.get("cat") == "chunk" and e["name"].startswith("chunk "):
                ends.setdefault(e["name"], {})[e["pid"]] = e["ts"] + e["dur"]
        out.append([abs(v[0] - v[1]) for v in ends.values() if len(v) == 2])
    return out


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main():
    if sys.argv[1] == "--child":
        child(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5], int(sys.argv[6]),
              sys.argv[7])
        return 0
    if sys.argv[1] == "--gaps":
        print(json.dumps(gaps(sys.argv[2], sys.argv[3], int(sys.argv[4]))))
        return 0
    arms = [a.rsplit(":", 1) for a in sys.argv[1].split(",")]
    launches, reps = int(sys.argv[2]), int(sys.argv[3])
    me = os.path.abspath(__file__)
    res = {}
    for launch in range(launches):
        for tree, mode in (arms if launch % 2 == 0 else arms[::-1]):
            with tempfile.TemporaryDirectory(prefix="span_gaps_") as root:
                env = dict(os.environ)
                if mode not in ("default", "nogc"):
                    env["OMP_NUM_THREADS"] = mode
                port = str(_free_port())
                procs = [subprocess.Popen([sys.executable, me, "--child", os.path.abspath(tree),
                                           str(i), port, root, str(reps), mode], env=env)
                         for i in range(2)]
                try:
                    rcs = [p.wait(timeout=600) for p in procs]
                finally:
                    for p in procs:
                        if p.poll() is None:
                            p.kill()
                            p.wait()
                if rcs != [0, 0]:
                    print(f"{tree}:{mode} launch {launch}: exit codes {rcs}", flush=True)
                    return 1
                g = json.loads(subprocess.run(
                    [sys.executable, me, "--gaps", os.path.abspath(tree), root, str(reps)],
                    capture_output=True, text=True, timeout=300, check=True).stdout)
            res.setdefault(f"{tree}:{mode}", []).extend(g)
            print(f"{tree}:{mode} launch {launch}: {[[round(x) for x in r] for r in g]}",
                  flush=True)
    print(json.dumps({k: dict(runs=len(v), over_1ms=sum(1 for r in v if max(r) > 1000),
                              max_us=max(max(r) for r in v),
                              chunk_median_us=[sorted(r[i] for r in v)[len(v) // 2]
                                               for i in range(len(v[0]))])
                      for k, v in res.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
