"""Content-addressed prefix cache (a copy of
``tf_operator_tpu/models/prefix_cache.py``): the pool's and the chunked
decoder's ``PrefixCache``, and ``PrefixFabric``, the host-side store
that replicas share for disaggregated serving.

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

``PrefixFabric`` holds finished prompt blocks on the host under the same
chain keys: a prefill replica publishes, a decode replica pulls the
chain's missing tail into fresh arena blocks.  A record is ``{"kv",
"nbytes"}``; the port's ``"kv"`` is one block's host copy, a list of
per-layer ``(K, V)`` numpy arrays [1, Hkv, bs, D] (bf16 as its uint16
words, ``models/fabric_service.py``), where the JAX fabric holds a flax
cache tree.
"""

from __future__ import annotations

import hashlib
import threading
import time
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


class PrefixFabric:
    """Cross-replica prefix-cache fabric: one content-addressed host-side
    store of finished prompt blocks, keyed by the chain keys of every
    replica's local :class:`PrefixCache` (the JAX fabric's semantics).

    Prefill replicas publish (``put`` a block's host copy under its chain
    key); decode replicas pull (``get``) the blocks they miss and upload
    them into their own arena.  ``capacity_blocks`` bounds the host
    footprint (None = unbounded); eviction is LRU, and an entry a
    migration holds (``get(..., pin=True)`` until ``unpin``) is never
    reclaimed.  Pins are leases: one expires after ``pin_ttl_seconds``
    (on ``clock``, default ``time.monotonic``), so a puller that died
    between the two calls blocks eviction for that long at most.
    ``generation`` changes with the key set (the ``/fabric/index``
    stamp).  With a ``metrics`` registry it counts
    ``kv_fabric_publishes_total``, sets ``kv_fabric_blocks`` (both
    ``{model}``) and counts the request-level hits, misses and evictions
    under ``serve_prefix_cache_*_total{mode="fabric"}``.  Thread-safe.
    """

    def __init__(self, capacity_blocks: Optional[int] = None,
                 metrics=None, model_label: str = "",
                 pin_ttl_seconds: float = 120.0, clock=None):
        self.capacity_blocks = None if capacity_blocks is None else int(capacity_blocks)
        self.metrics = metrics
        self.model_label = model_label or "unknown"
        self.pin_ttl_seconds = float(pin_ttl_seconds)
        self._clock = clock if clock is not None else time.monotonic
        self._lock = threading.Lock()
        self._entries: "OrderedDict[bytes, Any]" = OrderedDict()
        self._pins: dict = {}  # key -> [lease deadline, ...] on the clock
        self.hits = 0
        self.misses = 0
        self.publishes = 0
        self.evictions = 0
        self.bytes_published = 0
        self.pin_expiries = 0
        self.generation = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key: bytes) -> bool:
        with self._lock:
            return key in self._entries

    def get(self, key: bytes, pin: bool = False):
        """The block record for ``key`` (refreshing its LRU position), or
        None.  ``pin=True`` takes a lease that keeps the entry from
        eviction until the matching ``unpin`` (or the lease's expiry)."""

        with self._lock:
            rec = self._entries.get(key)
            if rec is None:
                return None
            self._entries.move_to_end(key)
            if pin:
                self._pins.setdefault(key, []).append(self._clock() + self.pin_ttl_seconds)
            return rec

    def unpin(self, key: bytes) -> None:
        with self._lock:
            leases = self._pins.get(key)
            if leases:
                leases.pop(0)
            if not leases:
                self._pins.pop(key, None)

    def _expire_pins_locked(self, now: float) -> int:
        """Drop the leases past their deadline (caller holds the lock)."""

        expired = 0
        for k in list(self._pins):
            live = [d for d in self._pins[k] if d > now]
            expired += len(self._pins[k]) - len(live)
            if live:
                self._pins[k] = live
            else:
                del self._pins[k]
        self.pin_expiries += expired
        return expired

    def record(self, hit: bool) -> None:
        """Count one request-level hit or miss (``mode="fabric"``)."""

        with self._lock:
            if hit:
                self.hits += 1
            else:
                self.misses += 1
        if self.metrics is not None:
            name = "serve_prefix_cache_hits_total" if hit else "serve_prefix_cache_misses_total"
            self.metrics.inc(name, mode="fabric")

    def put(self, key: bytes, kv_tree: Any, nbytes: int) -> None:
        """Publish one block's host copy under its chain key (idempotent:
        a second publisher of the same content refreshes its LRU
        position).  Past ``capacity_blocks`` the LRU unpinned entries go;
        with every entry pinned the fabric stays over capacity."""

        with self._lock:
            fresh = key not in self._entries
            self._entries[key] = {"kv": kv_tree, "nbytes": int(nbytes)}
            self._entries.move_to_end(key)
            if fresh:
                self.publishes += 1
                self.bytes_published += int(nbytes)
                self.generation += 1
            evicted = 0
            if self.capacity_blocks is not None:
                self._expire_pins_locked(self._clock())
                for k in list(self._entries):
                    if len(self._entries) <= self.capacity_blocks:
                        break
                    if self._pins.get(k):
                        continue  # a live lease holds it
                    del self._entries[k]
                    self.evictions += 1
                    self.generation += 1
                    evicted += 1
        if self.metrics is not None:
            if fresh:
                self.metrics.inc("kv_fabric_publishes_total", model=self.model_label)
            self.metrics.set("kv_fabric_blocks", float(len(self)), model=self.model_label)
            if evicted:
                self.metrics.inc("serve_prefix_cache_evictions_total", float(evicted),
                                 mode="fabric")

    def index_keys(self):
        """``(chain keys, generation)``: the ``/fabric/index`` read."""

        with self._lock:
            return list(self._entries.keys()), self.generation

    def snapshot(self) -> dict:
        """The JAX fabric's observability read (``/debug/arena``'s
        ``fabric``)."""

        with self._lock:
            self._expire_pins_locked(self._clock())
            return {
                "blocks": len(self._entries),
                "capacity_blocks": self.capacity_blocks,
                "pinned": sum(1 for v in self._pins.values() if v),
                "pin_expiries": self.pin_expiries,
                "generation": self.generation,
                "hits": self.hits,
                "misses": self.misses,
                "publishes": self.publishes,
                "evictions": self.evictions,
                "bytes_published": self.bytes_published,
            }
