"""Bounded LRU block cache for the read-side query service.

Counterpart of `implicitglobalgrid_tpu/serve/cache.py`. The snapshot container keys every shard block by BLOCK COORDINATES
(`utils.blockio.shard_key`), so a block is immutable once its directory
commits — the perfect cache unit. `BlockCache` holds decoded blocks
under a byte budget (thread-safe LRU: the query server answers
concurrent clients from `ThreadingHTTPServer` threads);
`CachedSnapshot` plugs it into the reader's `Snapshot._fetch_block`
hook, so a hot block is checksum-verified and decoded ONCE across
requests instead of once per read. Cache entries key on (snapshot
path, save token, block key): a re-committed snapshot at the same path
carries a new token and can never be answered from the old set's
blocks.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np

from ..io.reader import Snapshot
from ..utils.exceptions import InvalidArgumentError

__all__ = ["BlockCache", "CachedSnapshot"]


class BlockCache:
    """Thread-safe bounded-bytes LRU over decoded snapshot blocks."""

    def __init__(self, max_bytes: int = 256 << 20):
        if int(max_bytes) <= 0:
            raise InvalidArgumentError(
                f"BlockCache.max_bytes must be positive; got {max_bytes}.")
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._blocks: OrderedDict = OrderedDict()
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key):
        """The cached block (freshened to most-recent) or None."""
        with self._lock:
            block = self._blocks.get(key)
            if block is None:
                self.misses += 1
                return None
            self._blocks.move_to_end(key)
            self.hits += 1
            return block

    def put(self, key, block) -> None:
        """Insert one decoded block, evicting least-recently-used
        entries past the byte budget. A block larger than the whole
        budget is served but never cached."""
        nbytes = int(block.nbytes)
        with self._lock:
            if nbytes > self.max_bytes:
                return
            old = self._blocks.pop(key, None)
            if old is not None:
                self.bytes -= int(old.nbytes)
            self._blocks[key] = block
            self.bytes += nbytes
            while self.bytes > self.max_bytes:
                _, dropped = self._blocks.popitem(last=False)
                self.bytes -= int(dropped.nbytes)
                self.evictions += 1

    def clear(self) -> None:
        with self._lock:
            self._blocks.clear()
            self.bytes = 0

    def stats(self) -> dict:
        """JSON-able counters (the query service's /v1/snapshots echo —
        cache sizing feedback for the operator)."""
        with self._lock:
            return {"entries": len(self._blocks), "bytes": self.bytes,
                    "max_bytes": self.max_bytes, "hits": self.hits,
                    "misses": self.misses, "evictions": self.evictions}


class CachedSnapshot(Snapshot):
    """A `Snapshot` whose block fetches go through a shared
    `BlockCache`. Fills are sha256-verified exactly like the base
    reader's (the cache sits BEHIND `block_scanner`'s verify-on-first-
    open); reads stay bit-identical to the uncached path."""

    def __init__(self, dirpath, cache: BlockCache):
        if not isinstance(cache, BlockCache):
            raise InvalidArgumentError(
                f"CachedSnapshot needs a BlockCache; got "
                f"{type(cache).__name__}.")
        super().__init__(dirpath)
        self._cache = cache

    def _fetch_block(self, name: str, key: str, find_block):
        ck = (self.path, self.token, key)
        block = self._cache.get(ck)
        if block is None:
            block = np.asarray(find_block(key))
            self._cache.put(ck, block)
        return block
