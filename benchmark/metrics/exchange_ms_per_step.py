"""Device milliseconds a step in the kernels that pack, send or write
halos, matched by their names (the send slabs, the halo writes, the wire
pack, the self exchange). Halo cells a fused step kernel delivers itself
are not separated."""

import re

EXCHANGE = re.compile(r"^(exchange_slabs|halo_write|wire_pack|self_exchange)")


def read(run):
    td = run.trace
    if td is None or not td.steps:
        return None
    ops = [o for o in td.call_ops() if EXCHANGE.match(o.kind)]
    if not ops:
        return None
    return sum(o.end - o.start for o in ops) / 1e3 / td.steps
