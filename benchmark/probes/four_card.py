"""Probe for a four-card cell: the diffusion deployment over four cards.

    python3 benchmark/probes/four_card.py [--steps 100] [--backend gloo] [--seed 7]
    python3 benchmark/probes/four_card.py --device cpu --local 10   (a rehearsal)

Starts four processes, one a card, each holding a 1x1x2 box of the
2x2x2 x 256^3 float64 grid (`configs/diffusion3d-2x2x2x256-f64.json`),
joined by `torch.distributed` (``tcp://localhost``) through the program's
transport. Each process first runs the same steps on its own card's
virtual mesh (all eight blocks) and keeps its box of that result; then the
four run the fused route together from the same seed-made state. Prints one
JSON line: the wall ms a step of each, the largest gap to the one-card
run, the transport's counters (``Dist.stats``) and the device's idle share
in a traced stretch of steps.
"""

from __future__ import annotations

import argparse
import datetime
import json
import socket
import subprocess
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
WORLD = 4


def child(rank: int, port: int, args) -> dict:
    sys.path[:0] = [str(ROOT), str(BENCH)]
    import torch

    import implicitglobalgrid_tpu_torch as igg
    from implicitglobalgrid_tpu_torch.models import DiffusionParams, run_diffusion
    from benchlib import spec
    from benchlib import trace as tr
    from benchlib.layout import Grid

    cuda = args.device == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
    dev = f"cuda:{rank}" if cuda else "cpu"
    cell = spec.resolve("diffusion3d.fused", ROOT,
                        cfg_override={"local": [args.local] * 3} if args.local else None)
    cfg, ref = cell.cfg, cell.reference
    n, d = cfg["local"], cfg["dims"]
    c = ref.consts(cfg)
    inp = ref.inputs(cfg, None, args.seed, dev)
    grid = Grid(cfg["local"], cfg["dims"], cfg["overlaps"])
    T_all, Cp_all = grid.stack(inp["T"]), grid.stack(inp["Cp"])
    del inp
    p = DiffusionParams(**c)
    # this process's box in plain order: ranks 2r and 2r+1, z whole
    cx, cy = divmod(rank, 2)
    box = (slice(cx * n[0], (cx + 1) * n[0]), slice(cy * n[1], (cy + 1) * n[1]), slice(None))

    # alone, no process group: this process binds its own card, not card 0
    igg.init_global_grid(*n, dimx=d[0], dimy=d[1], dimz=d[2], devices=[dev] * 8,
                         init_dist=False, select_device=False, quiet=True)
    solo = run_diffusion(T_all, Cp_all, p, args.steps, nt_chunk=args.steps)[box].clone()
    igg.finalize_global_grid()

    torch.distributed.init_process_group("nccl" if args.backend == "nccl" else "gloo",
                                         init_method=f"tcp://localhost:{port}",
                                         world_size=WORLD, rank=rank,
                                         timeout=datetime.timedelta(seconds=args.wait))
    igg.init_global_grid(*n, dimx=d[0], dimy=d[1], dimz=d[2],
                         devices=[f"cuda:{r // 2}" if cuda else "cpu" for r in range(8)],
                         init_dist=False,
                         quiet=True)
    T, Cp = T_all[box].contiguous(), Cp_all[box].contiguous()
    del T_all, Cp_all
    gg = igg.global_grid()
    run_diffusion(T, Cp, p, 5, nt_chunk=5)
    gg.transport.reset_stats()
    t0 = time.perf_counter()
    out = run_diffusion(T, Cp, p, args.steps, nt_chunk=args.steps)
    wall = time.perf_counter() - t0
    stats = {k: v for k, v in gg.transport.stats.items()}
    gap = float((out - solo).abs().max()) / float(solo.abs().max())
    if not cuda:
        igg.finalize_global_grid(finalize_dist=True)
        return {"rank": rank, "wall_ms_per_step": 1e3 * wall / args.steps,
                "rel_gap_to_one_card": gap, "stats": stats}
    prof = tr.Profiler(True)
    prof.warm(dev)
    prof.start()
    with torch.profiler.record_function(tr.CALL):
        run_diffusion(T, Cp, p, 20, nt_chunk=20)
    prof.stop()
    td = tr.reduce(prof.collect(), 20)
    busy = td.busy()[1]
    igg.finalize_global_grid(finalize_dist=True)
    return {"rank": rank, "wall_ms_per_step": 1e3 * wall / args.steps, "rel_gap_to_one_card":
            gap, "stats": stats, "idle_pct": 100 * (1 - busy / td.window_us),
            "traced_ms_per_step": td.window_us / 1e3 / 20}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--local", type=int, default=0, help="block size (default: the config's)")
    ap.add_argument("--wait", type=int, default=120,
                    help="seconds any process waits for the others before all stop")
    ap.add_argument("--child", type=int, default=-1)
    ap.add_argument("--port", type=int, default=0)
    args = ap.parse_args(argv)
    if args.child >= 0:
        print("PROBE " + json.dumps(child(args.child, args.port, args), default=str), flush=True)
        return 0
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, __file__, "--child", str(r), "--port", str(port),
                               "--steps", str(args.steps), "--backend", args.backend,
                               "--seed", str(args.seed), "--device", args.device,
                               "--local", str(args.local), "--wait", str(args.wait)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(WORLD)]
    # one process that fails, or the deadline, stops them all
    deadline = time.monotonic() + 3 * args.wait + 60
    while any(pr.poll() is None for pr in procs):
        if time.monotonic() > deadline or any(pr.poll() for pr in procs):
            for pr in procs:
                if pr.poll() is None:
                    pr.kill()
            break
        time.sleep(0.5)
    rows, rc = [], 0
    for r, pr in enumerate(procs):
        out, err = pr.communicate()
        rc |= pr.returncode != 0
        rows += [json.loads(line[6:]) for line in out.splitlines() if line.startswith("PROBE ")]
        if pr.returncode:
            print(f"rank {r} ended with {pr.returncode}:\n{err[-3000:]}", file=sys.stderr)
    print(json.dumps({"backend": args.backend, "steps": args.steps, "ranks": rows}))
    return rc


if __name__ == "__main__":
    sys.exit(main())
