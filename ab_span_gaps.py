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
runs), a thread count (``OMP_NUM_THREADS``) or ``smoke`` (the two processes
are `chip_smoke.py`'s transport phase itself, the tree's kernels built
first, and its one resilient run is measured; ``reps`` does not apply).
Each other launch starts two processes (gloo on cuda:0, the 2x2x2 x 128^3
diffusion mesh split along z, as the transport phase), which run ``reps``
times the phase's
`run_resilient` (10 plain-route steps in chunks of 5, a checkpoint a chunk,
a NaN in process 1's box and its rollback), each into a flight directory
of its own. Each process also notes when each `dist.all_reduce` (the
guard's sum) and each `Dist.release` (in a tree that has it, the driver's
release before the stamp) was entered and when it returned; the chunk's
barrier is the last of them before its stamp. Both processes read one
monotonic clock, so each chunk gives the spread of the barrier's exits
across the processes, each process's exit after the later arrival, and,
per process, the time from the exit to the chunk's stamp.
Prints every run's per-chunk gaps (µs) and, last, a JSON summary an arm:
runs, runs with a gap over 1 ms, the largest gap, the median gap of each
chunk, and the quantiles (median, 95th, max; ms) of the barrier-exit
spread, of the later arrival to each exit, and of the exit-to-stamp time,
and the cyclic garbage collections that ran between an exit and its stamp.
Needs one card.
"""

import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

N = 128  # the transport phase's mesh block


def _note_exits(gc_log):
    """Note each `dist.all_reduce`'s and each `Dist.release`'s entry and
    return (a tree's driver releases its processes before the chunk stamp
    where `Dist` has `release`) and, in ``gc_log``, each cyclic garbage
    collection's generation, start and end. Returns the list of
    ``(entered, returned)`` pairs, monotonic seconds."""
    import gc

    import torch.distributed as dist

    from implicitglobalgrid_tpu_torch.parallel import transport

    exits = []
    all_reduce = dist.all_reduce

    class _Noted:  # an async all_reduce returns when its wait does
        def __init__(self, work, t0):
            self.work, self.t0 = work, t0

        def is_completed(self):
            return self.work.is_completed()

        def wait(self, *a):
            out = self.work.wait(*a)
            exits.append((self.t0, time.monotonic()))
            return out

    def noted_all_reduce(*a, **k):
        t0 = time.monotonic()
        out = all_reduce(*a, **k)
        if k.get("async_op"):
            return _Noted(out, t0)
        exits.append((t0, time.monotonic()))
        return out

    dist.all_reduce = noted_all_reduce
    release = getattr(transport.Dist, "release", None)
    if release is not None:
        def noted_release(self):
            t0 = time.monotonic()
            release(self)
            exits.append((t0, time.monotonic()))

        transport.Dist.release = noted_release

    def noted_gc(phase, info):
        gc_log.append((phase, info["generation"], time.monotonic()))

    gc.callbacks.append(noted_gc)
    return exits


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
    gc_log = []
    exits = _note_exits(gc_log)
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
        with open(os.path.join(fdir, f"exits_p{pid}.json"), "w") as f:
            json.dump(exits, f)
        with open(os.path.join(fdir, f"gc_p{pid}.json"), "w") as f:
            json.dump(gc_log, f)
        exits.clear()
        gc_log.clear()
    tg.finalize_global_grid()
    dist.destroy_process_group()


def smoke_child(tree, pid, port, root):
    """One process of `chip_smoke.py`'s transport phase (its
    ``transport_child``, from ``tree``) with the exits and collections
    noted; its resilient run's flight stream lands in ``root/f0``."""
    import shutil

    sys.path.insert(0, tree)
    import chip_smoke

    gc_log = []
    exits = _note_exits(gc_log)
    chip_smoke.transport_child(pid, port)
    fdir = os.path.join(root, "f0")
    os.makedirs(fdir, exist_ok=True)
    shutil.copy(os.path.join(chip_smoke._transport_dir(), "resilient_flight",
                             f"flight_p{pid}.jsonl"), fdir)
    with open(os.path.join(fdir, f"exits_p{pid}.json"), "w") as f:
        json.dump(exits, f)
    with open(os.path.join(fdir, f"gc_p{pid}.json"), "w") as f:
        json.dump(gc_log, f)


def gaps(tree, root, reps):
    """Per run, each chunk's gap (µs) between the two processes' aligned
    span ends (`aggregate_flight`, `export_chrome_trace`), and each chunk's
    barrier-exit spread and exit-to-stamp times (ms) from the raw stamps,
    and the collections (generation, ms) that ran between a process's exit
    and its stamp."""
    sys.path.insert(0, tree)
    import implicitglobalgrid_tpu_torch as tg

    out, spreads, to_stamp, wake, in_window = [], [], [], [], []
    for r in range(reps):
        fdir = os.path.join(root, f"f{r}")
        doc = tg.export_chrome_trace(tg.aggregate_flight(fdir))
        ends = {}
        for e in doc["traceEvents"]:
            if e.get("ph") == "X" and e.get("cat") == "chunk" and e["name"].startswith("chunk "):
                ends.setdefault(e["name"], {})[e["pid"]] = e["ts"] + e["dur"]
        out.append([abs(v[0] - v[1]) for v in ends.values() if len(v) == 2])
        # the chunk's barrier in each process: the last all_reduce before its stamp
        barrier = {}
        for pid in range(2):
            with open(os.path.join(fdir, f"exits_p{pid}.json")) as f:
                exits = json.load(f)
            with open(os.path.join(fdir, f"gc_p{pid}.json")) as f:
                log = json.load(f)
            runs = [(g, t0, t1) for (_, g, t0), (_, _, t1) in zip(log[::2], log[1::2])]
            for e in tg.read_flight_events(os.path.join(fdir, f"flight_p{pid}.jsonl")):
                if e["kind"] == "chunk":
                    t = float(e["t"])
                    x = max((x for x in exits if x[1] <= t), key=lambda x: x[1])
                    barrier.setdefault(e["chunk"], {})[pid] = x
                    to_stamp.append((t - x[1]) * 1e3)
                    in_window += [(g, (t1 - t0) * 1e3) for g, t0, t1 in runs
                                  if t0 < t and t1 > x[1]]
        for v in barrier.values():
            if len(v) == 2:
                spreads.append(abs(v[0][1] - v[1][1]) * 1e3)
                last = max(v[0][0], v[1][0])  # the later arrival
                wake += [(v[p][1] - last) * 1e3 for p in (0, 1)]
    return {"gaps": out, "spread_ms": spreads, "to_stamp_ms": to_stamp,
            "arrival_to_exit_ms": wake, "gc_in_window": in_window}


def _quantiles(xs):
    xs = sorted(xs)
    return dict(median=xs[len(xs) // 2], p95=xs[min(len(xs) - 1, int(0.95 * len(xs)))],
                max=xs[-1])


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main():
    if sys.argv[1] == "--child":
        child(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5], int(sys.argv[6]),
              sys.argv[7])
        return 0
    if sys.argv[1] == "--smoke-child":
        smoke_child(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
        return 0
    if sys.argv[1] == "--gaps":
        print(json.dumps(gaps(sys.argv[2], sys.argv[3], int(sys.argv[4]))))
        return 0
    arms = [a.rsplit(":", 1) for a in sys.argv[1].split(",")]
    launches, reps = int(sys.argv[2]), int(sys.argv[3])
    me = os.path.abspath(__file__)
    res = {}
    for tree in {t for t, mode in arms if mode == "smoke"}:  # its kernels, once
        subprocess.run([sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
                        "from implicitglobalgrid_tpu_torch.ops import cuda_build as cb; "
                        "cb.build_kernels(); cb.library()", os.path.abspath(tree)],
                       check=True, timeout=900)
    for launch in range(launches):
        for tree, mode in (arms if launch % 2 == 0 else arms[::-1]):
            with tempfile.TemporaryDirectory(prefix="span_gaps_") as root:
                env = dict(os.environ)
                if mode not in ("default", "nogc", "smoke"):
                    env["OMP_NUM_THREADS"] = mode
                port = str(_free_port())
                if mode == "smoke":
                    tdir = os.path.join(os.path.abspath(tree), "implicitglobalgrid_tpu_torch",
                                        "_build", "transport")
                    shutil.rmtree(tdir, ignore_errors=True)
                    os.makedirs(tdir)
                    env = {k: v for k, v in env.items()
                           if k not in ("MASTER_ADDR", "WORLD_SIZE", "IGG_USE_PALLAS")}
                    cmd = [sys.executable, me, "--smoke-child", os.path.abspath(tree)]
                    tail = [port, root]
                else:
                    cmd = [sys.executable, me, "--child", os.path.abspath(tree)]
                    tail = [port, root, str(reps), mode]
                procs = [subprocess.Popen(cmd + [str(i)] + tail, env=env, stdout=subprocess.DEVNULL)
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
                    [sys.executable, me, "--gaps", os.path.abspath(tree), root,
                     str(1 if mode == "smoke" else reps)],
                    capture_output=True, text=True, timeout=300, check=True).stdout)
            arm = res.setdefault(f"{tree}:{mode}", {"gaps": [], "spread_ms": [],
                                                    "to_stamp_ms": [],
                                                    "arrival_to_exit_ms": [],
                                                    "gc_in_window": []})
            for k in arm:
                arm[k].extend(g[k])
            print(f"{tree}:{mode} launch {launch}: {[[round(x) for x in r] for r in g['gaps']]}"
                  f" exit-to-stamp ms {[round(x, 3) for x in g['to_stamp_ms']]}"
                  f" collections in the window {g['gc_in_window']}", flush=True)
    print(json.dumps({k: dict(runs=len(v["gaps"]),
                              over_1ms=sum(1 for r in v["gaps"] if max(r) > 1000),
                              max_us=max(max(r) for r in v["gaps"]),
                              chunk_median_us=[sorted(r[i] for r in v["gaps"])[len(v["gaps"]) // 2]
                                               for i in range(len(v["gaps"][0]))],
                              barrier_spread_ms=_quantiles(v["spread_ms"]),
                              barrier_to_stamp_ms=_quantiles(v["to_stamp_ms"]),
                              last_arrival_to_exit_ms=_quantiles(v["arrival_to_exit_ms"]),
                              collections_in_window=len(v["gc_in_window"]),
                              collection_max_ms=max((d for _, d in v["gc_in_window"]),
                                                    default=0.0))
                      for k, v in res.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
