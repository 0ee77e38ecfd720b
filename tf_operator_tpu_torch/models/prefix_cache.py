"""Content-addressed prefix cache (a copy of the pool's and the chunked
decoder's half of ``tf_operator_tpu/models/prefix_cache.py``).

Keys are rolling token-hash CHAIN keys: the key of block i hashes the
previous block's key together with block i's tokens, so a key addresses
the whole prefix up to and including its block.  Two requests sharing a
system prompt produce identical chain prefixes, and a lookup walks the
chain until the first miss.

The paged pool stores physical block ids as values.  A hit maps the
block into the new seat's table copy-free; the ``can_evict`` hook
(allocator refcount == 1: only the cache holds the block) guarantees a
shared block is never evicted, and so never rewritten, while any seat
maps it.  The chunked decoder keys whole-prompt snapshots by
``exact_key`` (a chain of one maximal block) and reads them with
``get``.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Any, Callable, List, Optional

import numpy as np


def chain_keys(tokens, block_size: int) -> List[bytes]:
    """Rolling hash-chain keys for every FULL block of ``tokens``:
    key_i = H(key_{i-1} || tokens[i*bs:(i+1)*bs]).  A partial trailing
    block gets no key."""

    toks = np.asarray(tokens, np.int32).reshape(-1)
    keys: List[bytes] = []
    prev = b"kv-chain-v1"
    for off in range(0, (toks.size // block_size) * block_size, block_size):
        h = hashlib.sha256()
        h.update(prev)
        h.update(toks[off : off + block_size].tobytes())
        prev = h.digest()
        keys.append(prev)
    return keys


def exact_key(arr) -> bytes:
    """Whole-array content key for exact-prompt snapshot reuse: shape
    and dtype are part of the key (raw bytes alone collide across
    reshapes, [1, 4] against [2, 2], and across dtypes)."""

    a = np.asarray(arr)
    h = hashlib.sha256()
    h.update(repr((a.shape, a.dtype.str)).encode())
    h.update(a.tobytes())
    return h.digest()


class PrefixCache:
    """Refcount-aware LRU keyed by chain keys.  Thread-safe.

    ``capacity`` bounds the entry count (None = unbounded, pressure-
    driven eviction only).  ``can_evict(value)`` gates eviction;
    ``on_evict(value)`` runs after removal.  Hit/miss accounting is per
    request: callers walk the chain with ``peek`` and ``record`` once
    (an exact-prompt client reads with ``get``).  With a ``metrics``
    registry, hits, misses and evictions also count in
    ``serve_prefix_cache_{hits,misses,evictions}_total{mode=...}``,
    ``mode`` being the client ("pool" or "chunked").
    """

    def __init__(
        self,
        capacity: Optional[int] = None,
        metrics=None,
        mode: str = "pool",
        can_evict: Optional[Callable[[Any], bool]] = None,
        on_evict: Optional[Callable[[Any], None]] = None,
    ):
        self._lock = threading.Lock()
        self._entries: "OrderedDict[bytes, Any]" = OrderedDict()
        self.capacity = capacity
        self.metrics = metrics
        self.mode = mode
        self._can_evict = can_evict
        self._on_evict = on_evict
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key: bytes) -> bool:
        with self._lock:
            return key in self._entries

    def peek(self, key: bytes):
        """Value for ``key`` (refreshing its LRU position) without
        hit/miss accounting, or None."""

        with self._lock:
            if key not in self._entries:
                return None
            self._entries.move_to_end(key)
            return self._entries[key]

    def record(self, hit: bool) -> None:
        """Count one request-level hit or miss."""

        with self._lock:
            if hit:
                self.hits += 1
            else:
                self.misses += 1
        if self.metrics is not None:
            name = "serve_prefix_cache_hits_total" if hit else "serve_prefix_cache_misses_total"
            self.metrics.inc(name, mode=self.mode)

    def get(self, key: bytes):
        """``peek`` and ``record`` in one call: the exact-prompt client's
        read."""

        value = self.peek(key)
        self.record(value is not None)
        return value

    def put(self, key: bytes, value: Any) -> None:
        """Insert/refresh; evicts LRU entries past ``capacity`` (the
        ``can_evict`` gate applies)."""

        with self._lock:
            self._entries[key] = value
            self._entries.move_to_end(key)
        if self.capacity is not None and len(self) > self.capacity:
            self.evict_lru(need=len(self) - self.capacity)

    def evict_lru(self, need: int = 1) -> int:
        """Evict up to ``need`` LRU entries whose values pass
        ``can_evict``; returns how many were evicted.  Entries still
        referenced are skipped and keep their LRU position."""

        evicted = 0
        with self._lock:
            for key in list(self._entries):
                if evicted >= need:
                    break
                value = self._entries[key]
                if self._can_evict is not None and not self._can_evict(value):
                    continue
                del self._entries[key]
                self.evictions += 1
                evicted += 1
                if self._on_evict is not None:
                    self._on_evict(value)
        if evicted and self.metrics is not None:
            self.metrics.inc("serve_prefix_cache_evictions_total", float(evicted),
                             mode=self.mode)
        return evicted
