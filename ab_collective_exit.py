#!/usr/bin/env python3
"""Exit spread of a two-process exchange of a small host vector, by method.

The transport phase of `chip_smoke.py` runs two processes on one card under
gloo; the resilient driver's chunk ends at the guard's small host sum, and
each process stamps the chunk right after that sum returns. This script
measures, for each way of making that exchange, how far apart the two
processes leave it (both read one monotonic clock):

    python3 ab_collective_exit.py <iterations> [--profiled]

Each iteration runs, in each process, a few ms of kernels on cuda:0 (process
1 a varying extra share, so the arrivals differ, as the chunks' do), the
device-to-host copy of an 8-float vector, then every method in turn:

- ``gloo``: `dist.all_reduce` of the pinned host vector (blocking);
- ``gloo_poll``: the same with ``async_op=True``, polling `is_completed`;
- ``socket``: a TCP connection between the two processes, blocking
  `send`/`recv` of the vector on the calling thread;
- ``socket_poll``: the same connection non-blocking, `recv` polled;
- ``gloo_release``: ``gloo``, then a one-byte token each way over the
  connection, polled (both processes leave on the later one's token);
- ``socket_poll_twice``: ``socket_poll``, then the token exchange.

With ``--profiled`` each process first runs a short `torch.profiler`
capture of its kernels, as `telemetry.trace` makes one before the transport
phase's resilient run.

Prints, a method a line, the quantiles (median, 95th, 99th, max; ms) of the
exit spread and of the time from the later arrival to each exit, then a JSON
summary. Needs one card.
"""

import json
import os
import socket
import subprocess
import sys
import tempfile
import time

METHODS = ("gloo", "gloo_poll", "socket", "socket_poll", "gloo_release", "socket_poll_twice")


def _exchange_socket(sock, buf, poll):
    """Send ``buf`` and receive as many bytes from the peer (``poll``: the
    socket is non-blocking and `recv` is retried at once)."""
    sock.sendall(buf)
    got = bytearray(len(buf))
    view = memoryview(got)
    n = 0
    while n < len(buf):
        try:
            k = sock.recv_into(view[n:])
        except BlockingIOError:
            continue
        if k == 0:
            raise ConnectionError("peer closed")
        n += k
    return got


def child(rank, gport, sport, iters, out, profiled):
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{gport}", world_size=2,
                            rank=rank)
    if rank == 0:
        srv = socket.socket()
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("127.0.0.1", sport))
        srv.listen(1)
        dist.barrier()
        sock, _ = srv.accept()
        srv.close()
    else:
        dist.barrier()
        sock = socket.create_connection(("127.0.0.1", sport))
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    a = torch.randn(2048, 2048, device="cuda")
    dev = torch.ones(8, device="cuda")
    host = torch.empty(8, pin_memory=True)
    g = torch.Generator().manual_seed(rank)
    if profiled:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]):
            for _ in range(20):
                a = torch.tanh(a @ a * 1e-3)
            torch.cuda.synchronize()
    notes = {m: [] for m in METHODS}
    for i in range(iters):
        for m in METHODS:
            reps = 4 + (int(torch.randint(0, 8, (1,), generator=g)) if rank == 1 else 0)
            for _ in range(reps):
                a = torch.tanh(a @ a * 1e-3)
            dev.add_(a[0, :8])
            host.copy_(dev)
            t0 = time.monotonic()
            if m.startswith("gloo"):
                if m in ("gloo", "gloo_release"):
                    dist.all_reduce(host)
                else:
                    w = dist.all_reduce(host, async_op=True)
                    while not w.is_completed():
                        pass
                    w.wait()
            else:
                sock.setblocking(m == "socket")
                _exchange_socket(sock, host.numpy().tobytes(), m != "socket")
            if m in ("gloo_release", "socket_poll_twice"):
                sock.setblocking(False)
                _exchange_socket(sock, b"r", True)
            notes[m].append((t0, time.monotonic()))
    with open(os.path.join(out, f"exits_{rank}.json"), "w") as f:
        json.dump(notes, f)
    dist.barrier()
    sock.close()
    dist.destroy_process_group()


def _q(xs):
    xs = sorted(xs)
    pick = lambda p: xs[min(len(xs) - 1, int(p * len(xs)))]
    return dict(median=xs[len(xs) // 2], p95=pick(0.95), p99=pick(0.99), max=xs[-1])


def _port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main():
    if sys.argv[1] == "--child":
        child(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5]),
              sys.argv[6], sys.argv[7:] == ["--profiled"])
        return 0
    iters, extra = int(sys.argv[1]), sys.argv[2:3]
    me = os.path.abspath(__file__)
    with tempfile.TemporaryDirectory(prefix="collective_exit_") as out:
        gport, sport = _port(), _port()
        procs = [subprocess.Popen([sys.executable, me, "--child", str(r), str(gport),
                                   str(sport), str(iters), out, *extra]) for r in range(2)]
        try:
            rcs = [p.wait(timeout=900) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if rcs != [0, 0]:
            print(f"exit codes {rcs}")
            return 1
        notes = []
        for r in range(2):
            with open(os.path.join(out, f"exits_{r}.json")) as f:
                notes.append(json.load(f))
    res = {}
    for m in METHODS:
        spread, wake = [], []
        for x, y in zip(notes[0][m], notes[1][m]):
            spread.append(abs(x[1] - y[1]) * 1e3)
            last = max(x[0], y[0])
            wake += [(x[1] - last) * 1e3, (y[1] - last) * 1e3]
        res[m] = dict(n=len(spread), over_1ms=sum(s > 1.0 for s in spread),
                      spread_ms=_q(spread), later_arrival_to_exit_ms=_q(wake))
        print(m, json.dumps(res[m]), flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
