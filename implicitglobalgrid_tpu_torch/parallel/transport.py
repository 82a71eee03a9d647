"""How halo slabs and gathered boxes move between processes.

The JAX package moves a halo with `ppermute` over the device mesh; the
port's processes each own a box of ranks (`parallel.mesh.process_boxes`),
and a halo exchange between two blocks of one box is a copy inside the
stacked tensor. Along a dim that crosses processes (`topology.crosses`),
the blocks at the box's edges take their neighbour's slabs from another
process. One interface, two implementations:

- `InProcess`: one process owns the whole grid (the virtual mesh); every
  peer is this process and a message is a tensor copy.
- `Dist`: a `torch.distributed` process group. One dim's receives and sends
  are posted together (`batch_isend_irecv`) to the processes `cart_shift`
  names on the process grid. The wire format follows the group's backend:
  NCCL sends the device buffers; gloo, which sends only host tensors,
  copies CUDA buffers through pinned host memory. Nothing falls back from
  one to the other. ``stats`` counts the messages and bytes sent and times
  each exchange (``exchange_s``, host clock; under gloo from the moment the
  device has drained) and its host staging (``staging_s``).

`fill_edges` is the halo routes' entry point: every block's send slabs were
computed on this process's box by the kernels; it moves the ones that cross
a process boundary (or wrap around onto this process) into the received
slabs of the blocks at the box's edges. The order of the messages is the
same on every process, so every process must call it for every crossing
dim, in the same order, as for any collective.

Under a halo wire format (`ops.precision`) a slab crosses in that format:
`fill_edges` sends each item's payload bytes (`ops.wire.SlabCodec`: the cast
slab, or every block's int8 payload with its scale) and decodes them on
arrival; `shift_rows` sends K8's rows coded by the group's `WireSchema`
(`encode_rows`) and decodes them. ``stats["wire_bytes"]`` counts the bytes
sent.

`release` returns on every process together (the resilient driver's
chunk stamp, on which `aggregate_flight` aligns the processes' clocks):
`Dist` exchanges a byte with every peer over loopback sockets.

Under a recording (`analysis.record`) `all_sum` records one ``all-reduce``
and `all_max` a host transfer (its values were fetched to the host); the
halo routes record their logical exchanges themselves (`ops.halo`), not
the messages below.
"""

from __future__ import annotations

import time
from typing import NamedTuple

from ..analysis import record as _record
from ..utils.exceptions import NotSupportedError

# how long `Dist.release` polls for its peers' bytes
_RELEASE_TIMEOUT_S = 60.0

__all__ = ["InProcess", "Dist", "EdgeMessage", "edge_plan", "fill_edges", "shift_rows",
           "wire_view", "transport_for"]


class EdgeMessage(NamedTuple):
    """The slabs of one side of a dim that come from one process offset.

    ``side`` 0: a block's left halo takes the right send slab of the block
    ``disp`` before it; 1: its right halo takes the left send slab of the
    block ``disp`` after it. ``pairs``: ``(t, b)`` for each receiving block
    ``t`` of the box and the source block ``b`` of the source process's box
    (positions along the dim). ``recv_from`` / ``send_to``: the process this
    one receives the message from / sends its own blocks ``b`` to (None on a
    non-periodic edge)."""
    side: int
    pairs: tuple
    recv_from: int | None
    send_to: int | None


def _proc_at(gg, dim, pc):
    """The process at box position ``pc`` along ``dim`` (this process's
    position along the other dims), or None outside a non-periodic axis."""
    P = int(gg.procs.shape[dim])
    if not 0 <= pc < P:
        if not bool(gg.periods[dim]):
            return None
        pc %= P
    pos = [int(c) // int(b) for c, b in zip(gg.coords, gg.box)]
    pos[dim] = pc
    return int(gg.procs[tuple(pos)])


def edge_plan(gg, dim: int):
    """The messages of ``dim`` for this process (`EdgeMessage`, in the order
    every process posts them), kept by the grid's transport."""
    plans = gg.transport.plans
    if dim in plans:
        return plans[dim]
    Db, disp = int(gg.box[dim]), int(gg.disp)
    pc = int(gg.coords[dim]) // Db
    plan = []
    for side, sgn in ((0, -1), (1, 1)):
        by_k: dict = {}
        for t in range(Db):
            u = t + sgn * disp
            if 0 <= u < Db:
                continue  # a block of this box: the kernels moved it
            k, b = divmod(u, Db)
            by_k.setdefault(k, []).append((t, b))
        for k in sorted(by_k):
            plan.append(EdgeMessage(side, tuple(by_k[k]), _proc_at(gg, dim, pc + k),
                                    _proc_at(gg, dim, pc - k)))
    plans[dim] = plan = tuple(plan)
    return plan


def fill_edges(gg, dim: int, items) -> None:
    """Complete one crossing dim's received slabs, in place. ``items``:
    ``(dst, src, side)`` or ``(dst, src, side, codec)`` tensors whose axis
    ``dim`` indexes the box's blocks along ``dim``: ``dst`` the received
    slabs (right inside the box, and a block's own slab on a non-periodic
    edge), ``src`` every block's send slabs for ``side`` (`EdgeMessage`);
    ``codec`` (`ops.wire.SlabCodec`, or None for the exact wire) the wire
    format the slabs cross in. Every process calls it for every crossing
    dim in the same order."""
    import torch

    tr = gg.transport
    items = [tuple(it) + (None,) * (4 - len(it)) for it in items]
    msgs, decodes = [], []
    for m in edge_plan(gg, dim):
        its = [(dst, src, codec) for dst, src, side, codec in items if side == m.side]
        if m.recv_from == tr.rank:  # wraps around onto this process
            for dst, src, codec in its:
                for t, b in m.pairs:
                    if codec is None:
                        dst.select(dim, t).copy_(src.select(dim, b))
                    else:
                        codec.decode_into(codec.encode(src.select(dim, b)), dst.select(dim, t))
            continue
        send = None
        if m.send_to is not None:
            send = [src.select(dim, b) if codec is None else codec.encode(src.select(dim, b))
                    for _, src, codec in its for _, b in m.pairs]
        recv = None
        if m.recv_from is not None:
            recv = []
            for dst, _, codec in its:
                for t, _ in m.pairs:
                    d = dst.select(dim, t)
                    if codec is None:
                        recv.append(d)
                    else:
                        w = torch.empty(codec.nbytes(d), dtype=torch.uint8, device=d.device)
                        recv.append(w)
                        decodes.append((codec, w, d))
        msgs.append((m.send_to, send, m.recv_from, recv))
    tr.exchange(msgs)
    for codec, w, d in decodes:
        codec.decode_into(w, d)


def shift_rows(gg, dim: int, bufs, own, schema=None):
    """The rows a K7 launch with ``disp`` 0 reads, one per block of the box,
    for the two sides of a crossing dim: row ``t`` of side 0 (the left
    halos) is the right buffer row of block ``t - disp``, of side 1 the left
    buffer row of block ``t + disp``; rows inside the box are copied, rows
    from other processes come through `fill_edges`, and a block on a
    non-periodic edge keeps its halo (``own()``: its own halos packed, side
    0 the left ones, exact). ``bufs``: ``(buf_r, buf_l)`` of
    `cuda_halo.wire_pack` viewed with the blocks' coordinates first.
    ``schema``: the group's `WireSchema` when a wire format applies; every
    row then moves as its payload (`WireSchema.encode_rows`), decoded on
    arrival."""
    import torch

    Db, disp = int(gg.box[dim]), int(gg.disp)
    buf_r, buf_l = bufs
    if schema is not None:
        buf_r, buf_l = schema.encode_rows(buf_r), schema.encode_rows(buf_l)
    rows = (torch.empty_like(buf_r), torch.empty_like(buf_l))
    if disp < Db:
        rows[0].narrow(dim, disp, Db - disp).copy_(buf_r.narrow(dim, 0, Db - disp))
        rows[1].narrow(dim, 0, Db - disp).copy_(buf_l.narrow(dim, disp, Db - disp))
    fill_edges(gg, dim, [(rows[0], buf_r, 0), (rows[1], buf_l, 1)])
    if schema is not None:
        rows = (schema.decode_rows(rows[0]), schema.decode_rows(rows[1]))
    nulls = [(m.side, t) for m in edge_plan(gg, dim) if m.recv_from is None
             for t, _ in m.pairs]
    if nulls:
        mine = own()
        for side, t in nulls:
            rows[side].select(dim, t).copy_(mine[side].select(dim, t))
    return rows


def wire_view(t):
    """A tensor's bytes as a flat uint8 tensor (any dtype goes over any
    backend, bfloat16 included)."""
    import torch

    return t.reshape(-1).view(torch.uint8)


class InProcess:
    """The transport of a one-process grid: every peer is this process."""

    rank, world, backend = 0, 1, None

    def __init__(self):
        self.reset_stats()
        self.plans = {}  # dim -> edge_plan of the grid this transport serves

    def __deepcopy__(self, memo):
        return self  # a grid copy shares its process group

    def reset_stats(self):
        self.stats = {"messages": 0, "wire_bytes": 0, "exchange_s": 0.0, "staging_s": 0.0}

    def exchange(self, msgs) -> None:
        """Post ``msgs`` (``(send_to, [send views], recv_from, [recv
        views])``, peers by process rank or None) together and wait."""
        for send_to, send, recv_from, recv in msgs:
            if send_to not in (None, self.rank) or recv_from not in (None, self.rank):
                raise NotSupportedError(
                    f"process {self.rank} of a one-process grid has no peer "
                    f"{send_to if send_to not in (None, self.rank) else recv_from}.")
            if send is not None and recv is not None:
                for d, s in zip(recv, send):
                    d.copy_(s)

    def gather(self, t, root: int, senders):
        """``{p: t of process p}`` on ``root`` for the processes ``senders``
        (one shape and dtype), None elsewhere; a process outside
        ``senders`` sends nothing."""
        return {0: t} if 0 in senders else {}

    def all_max(self, values):
        """The elementwise maximum of ``values`` (floats) over the processes."""
        if _record.ACTIVE is not None:
            _record.ACTIVE.host_transfer(_record.Shape("f64", (len(values),)), site="all_max")
        return [float(v) for v in values]

    def all_sum(self, t):
        """The elementwise sum of tensor ``t`` over the processes, on
        ``t``'s device (JAX's ``lax.psum`` over every mesh axis; here the
        one process's ``t`` itself)."""
        if _record.ACTIVE is not None:
            _record.ACTIVE.all_reduce(t, site="all_sum")
        return t

    def host_values(self, t):
        """``t``'s values on the host, as numpy (the driver's chunk drain).
        A sum this transport's `all_sum` just returned is read from the
        sum's host copy where it has one."""
        return t.detach().cpu().numpy()

    def broadcast_one_to_all(self, obj):
        """Process 0's ``obj`` (any picklable object) on every process."""
        return obj

    def barrier(self) -> None:
        """Return once every process has reached it."""

    def release(self) -> None:
        """Return on every process together, as closely as the host allows
        (the resilient driver's chunk stamp; `Dist.release`)."""

    def all_gather_object(self, obj):
        return [obj]

    def shutdown(self) -> None:
        pass


class Dist(InProcess):
    """The transport of a `torch.distributed` process group (the default
    group). ``device``: the grid's device; CUDA tensors cross a gloo group
    through pinned host memory, a NCCL group in place."""

    def __init__(self, device):
        import torch.distributed as dist

        super().__init__()
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        self.backend = str(dist.get_backend()).lower()
        self.device = device
        if self.backend not in ("gloo", "nccl"):
            raise NotSupportedError(
                f"the transport runs over gloo or NCCL; the process group uses "
                f"{self.backend}.")
        if self.backend == "nccl" and device.type != "cuda":
            raise NotSupportedError("a NCCL process group needs a CUDA grid.")
        # host-side collectives (node grouping, barriers, objects) ride gloo
        self.cpu_group = None if self.backend == "gloo" else dist.new_group(backend="gloo")
        self.stage = self.backend == "gloo" and device.type == "cuda"
        self._pinned: dict = {}
        self._last_sum = None  # (the device tensor all_sum returned, its host copy)
        self._links = None  # the release's sockets, one a peer (made by the first release)

    def _host(self, key, n):
        """A pinned uint8 host buffer of ``n`` bytes, kept per ``key``: every
        copy through it is synchronous, so a later call may reuse it."""
        import torch

        buf = self._pinned.get(key)
        if buf is None or buf.numel() < n:
            buf = self._pinned[key] = torch.empty(n, dtype=torch.uint8, pin_memory=True)
        return buf[:n]

    def exchange(self, msgs) -> None:
        from ..utils.profiling import label

        with label("igg::transport"):
            self._exchange(msgs)

    def _exchange(self, msgs) -> None:
        import torch
        import torch.distributed as dist

        ops, after = [], []
        if self.stage:
            # the slabs' kernels first: the host copies below would wait for them
            torch.cuda.current_stream(self.device).synchronize()
        start = time.perf_counter()
        for j, (send_to, send, recv_from, recv) in enumerate(msgs):
            if send_to is not None:
                wire = torch.cat([wire_view(s.contiguous()) for s in send])
                if self.stage:
                    t0 = time.perf_counter()
                    wire = self._host(("s", j), wire.numel()).copy_(wire)
                    self.stats["staging_s"] += time.perf_counter() - t0
                ops.append(dist.P2POp(dist.isend, wire, send_to, tag=j))
                self.stats["messages"] += 1
                self.stats["wire_bytes"] += wire.numel()
            if recv_from is not None:
                n = sum(r.numel() * r.element_size() for r in recv)
                wire = self._host(("r", j), n) if self.stage else torch.empty(
                    n, dtype=torch.uint8, device=recv[0].device)
                ops.append(dist.P2POp(dist.irecv, wire, recv_from, tag=j))
                after.append((wire, recv))
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        for wire, recv in after:
            if self.stage:
                t0 = time.perf_counter()
                wire = wire.to(self.device)
                self.stats["staging_s"] += time.perf_counter() - t0
            off = 0
            for r in recv:
                n = r.numel() * r.element_size()
                r.copy_(wire[off:off + n].view(r.dtype).view(r.shape))
                off += n
        self.stats["exchange_s"] += time.perf_counter() - start

    def _wire_tensor(self, t):
        """``t`` where the backend takes it: on the host for gloo."""
        t = t.contiguous()
        return t.cpu() if self.backend == "gloo" else t

    def gather(self, t, root: int, senders):
        import torch
        import torch.distributed as dist

        w = wire_view(self._wire_tensor(t))
        ops, got = [], {}
        if self.rank == root:
            for p in senders:
                if p == root:
                    got[p] = t
                    continue
                got[p] = buf = torch.empty_like(w)
                ops.append(dist.P2POp(dist.irecv, buf, p))
        elif self.rank in senders:
            ops.append(dist.P2POp(dist.isend, w, root))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        if self.rank != root:
            return None
        return {p: b if p == root else b.view(t.dtype).view(t.shape) for p, b in got.items()}

    def all_max(self, values):
        import torch
        import torch.distributed as dist

        if _record.ACTIVE is not None:
            _record.ACTIVE.host_transfer(_record.Shape("f64", (len(values),)), site="all_max")
        dev = "cpu" if self.backend == "gloo" else self.device
        v = torch.tensor([float(x) for x in values], dtype=torch.float64, device=dev)
        dist.all_reduce(v, op=dist.ReduceOp.MAX)
        return [float(x) for x in v.cpu()]

    def all_sum(self, t):
        """`dist.all_reduce` (SUM) of a copy of ``t``: on the device under
        NCCL; under gloo a CUDA tensor goes through pinned host memory (as
        `exchange` stages it) and back, asynchronously. Returns a new tensor
        on ``t``'s device."""
        import torch
        import torch.distributed as dist

        if _record.ACTIVE is not None:
            _record.ACTIVE.all_reduce(t, site="all_sum")
        if self.backend != "gloo" or t.device.type != "cuda":
            out = t.contiguous().clone()
            dist.all_reduce(out, op=dist.ReduceOp.SUM)
            return out
        host = self._host("sum", t.numel() * t.element_size()).view(t.dtype)
        host.copy_(t.reshape(-1))
        dist.all_reduce(host, op=dist.ReduceOp.SUM)
        # The sum goes back to the device from a pinned copy of its own
        # (PyTorch's host allocator keeps it until the copy is done), without
        # waiting: `host_values` reads the copy, so the chunk drain that
        # follows (and the driver's chunk stamp) waits on no device work.
        # Two processes sharing one card time-slice it, and a wait there can
        # last a slice of the other process's work.
        kept = torch.empty_like(host, pin_memory=True)
        kept.copy_(host)
        out = kept.to(t.device, non_blocking=True).view(t.shape)
        self._last_sum = (out, kept)
        return out

    def release(self):
        """Each process of this host sends every peer one byte and polls its
        sockets until it holds one byte from each: every process leaves
        when the last one has come, within one loopback delivery. A gloo
        collective gives no such exit: each process leaves it when its own
        threads notice the last message, on a loaded host a millisecond or
        more apart. Across hosts there is no release."""
        links = self._links
        if links is None:
            links = self._links = self._connect_links()
        for s in links:
            s.send(b"\x01")
        pending = list(links)
        deadline = time.monotonic() + _RELEASE_TIMEOUT_S
        while pending:
            for s in tuple(pending):
                try:
                    got = s.recv(1)
                except BlockingIOError:
                    continue
                if not got:
                    raise ConnectionError(
                        f"process {self.rank}: a peer closed its link before the release.")
                pending.remove(s)
            if pending and time.monotonic() > deadline:
                raise TimeoutError(
                    f"process {self.rank}: {len(pending)} peer(s) did not come to the release "
                    f"within {_RELEASE_TIMEOUT_S} s.")

    def _connect_links(self):
        """A TCP connection to every other process over the loopback, when
        all of them share this host's name; else none. Each process connects
        to the lower ranks' listening sockets and accepts the higher ranks'."""
        import socket

        name = socket.gethostname()
        with socket.socket() as srv:
            srv.bind(("127.0.0.1", 0))
            srv.listen(self.world)
            seen = self.all_gather_object((name, srv.getsockname()[1]))
            if any(h != name for h, _ in seen):
                return []
            links = [socket.create_connection(("127.0.0.1", seen[p][1]))
                     for p in range(self.rank)]
            links += [srv.accept()[0] for _ in range(self.rank + 1, self.world)]
        for s in links:
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            s.setblocking(False)
        return links

    def host_values(self, t):
        last, self._last_sum = self._last_sum, None
        if last is not None and last[0] is t:
            return last[1].view(t.shape).numpy()
        return super().host_values(t)

    def broadcast_one_to_all(self, obj):
        return self.all_gather_object(obj)[0]

    def barrier(self) -> None:
        import torch.distributed as dist

        dist.barrier(group=self.cpu_group)

    def all_gather_object(self, obj):
        import torch.distributed as dist

        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.cpu_group)
        return out

    def shutdown(self) -> None:
        """Close the release's sockets and destroy the process group."""
        import torch.distributed as dist

        for s in self._links or ():
            s.close()
        self._links = None
        if dist.is_initialized():
            dist.destroy_process_group()


def transport_for(device):
    """`Dist` when a process group of more than one process is up, else
    `InProcess`."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return Dist(device)
    return InProcess()
