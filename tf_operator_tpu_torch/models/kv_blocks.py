"""Block-granular KV-cache accounting for paged serving (a copy of the
host-side half of ``tf_operator_tpu/models/kv_blocks.py``; the port
keeps its own so it imports nothing of the JAX package).

A free-list allocator with O(1) alloc/free and per-block refcounts over
one pre-allocated device arena.  Refcounts make copy-free prefix
sharing safe: a block mapped by a live seat AND published in the
prefix cache carries one reference per holder and returns to the free
list only when the last holder releases it.

Block id 0 is the SCRATCH block: never allocated; unused block-table
entries point at it and overshoot writes land in it.  Reads of it are
always masked by the seat's length, so its content is never
observable.  The allocator manages ids ``1 .. num_blocks-1``.

Conservation invariant: at all times ``free + live == usable`` with no
id both free and referenced.

:class:`SwapArena` is the host side of preemption: the private blocks of
a seat evicted mid-decode wait there until the request resumes.
:class:`ArenaTimeline` keeps the arena's occupancy history.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

#: the global scratch block id (see module docstring)
SCRATCH_BLOCK = 0


class BlockError(RuntimeError):
    """An allocator-contract violation (double free, release of a
    never-allocated id).  Raised loudly: silent refcount corruption is
    cross-request cache aliasing."""


class NotPageableError(ValueError):
    """This model cannot be paged (rolling-window wrap state aliases
    positions).  Distinct from a plain ValueError so that model-shape
    refusals can be told apart from configuration errors."""


class BlockAllocator:
    """Free-list + refcount bookkeeping over ``num_blocks`` arena rows.

    Thread-safe.  ``alloc`` returns None on shortfall instead of
    raising, so callers can evict or queue.
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (scratch + at least one "
                f"usable block), got {num_blocks}"
            )
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self._lock = threading.Lock()
        # LIFO: the most recently freed block is reused first
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self._refs: Dict[int, int] = {}  # bid -> refcount; absent = free

    @property
    def usable(self) -> int:
        """Blocks the allocator manages (everything but scratch)."""

        return self.num_blocks - 1

    @property
    def free_count(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def in_use(self) -> int:
        with self._lock:
            return len(self._refs)

    def refcount(self, bid: int) -> int:
        with self._lock:
            return self._refs.get(bid, 0)

    def check(self) -> None:
        """Raise BlockError unless the conservation invariant holds."""

        with self._lock:
            free = set(self._free)
            if len(free) != len(self._free):
                raise BlockError("free list holds a duplicate id")
            if free & set(self._refs):
                raise BlockError("an id is both free and referenced")
            if SCRATCH_BLOCK in free or SCRATCH_BLOCK in self._refs:
                raise BlockError("scratch block entered the allocator")
            if len(free) + len(self._refs) != self.num_blocks - 1:
                raise BlockError(
                    f"conservation broken: {len(free)} free + "
                    f"{len(self._refs)} live != {self.num_blocks - 1}"
                )

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` fresh blocks at refcount 1, or None when fewer than
        ``n`` are free (all or nothing)."""

        if n < 0:
            raise ValueError(f"alloc({n})")
        with self._lock:
            if len(self._free) < n:
                return None
            ids = [self._free.pop() for _ in range(n)]
            for bid in ids:
                self._refs[bid] = 1
            return ids

    def retain(self, ids: List[int]) -> None:
        """+1 reference per id (prefix-cache publication, mapping a
        shared block into another seat's table)."""

        with self._lock:
            for bid in ids:
                if bid not in self._refs:
                    raise BlockError(f"retain of unallocated block {bid}")
                self._refs[bid] += 1

    def release(self, ids: List[int]) -> int:
        """-1 reference per id; ids reaching 0 return to the free list.
        Returns how many blocks were actually freed."""

        freed = 0
        with self._lock:
            for bid in ids:
                rc = self._refs.get(bid)
                if rc is None:
                    raise BlockError(f"double free of block {bid}")
                if rc == 1:
                    del self._refs[bid]
                    self._free.append(bid)
                    freed += 1
                else:
                    self._refs[bid] = rc - 1
        return freed


class SwapArena:
    """Host-side store of swapped-out KV blocks (a copy of the JAX
    package's ``SwapArena``).

    Mid-decode preemption frees a victim seat's device blocks by parking
    their content here: one record per preempted request, holding the
    host copies of its private (refcount-1) blocks plus the bookkeeping
    resume needs.  Prefix-cache-shared blocks are swap-exempt: they stay
    on the device under their surviving refcounts and re-map copy-free
    at resume, so a record covers only blocks nothing else holds.

    ``capacity_blocks`` bounds the host footprint (None = unbounded).
    ``admit`` answers whether a prospective swap fits; a full swap arena
    means the scheduler parks the seat without a copy instead of
    preempting it.

    Conservation: device ``free + live`` plus this arena's
    ``swapped_blocks`` accounts for every logical block any request
    owns.
    """

    def __init__(self, capacity_blocks: Optional[int] = None):
        self.capacity_blocks = (
            None if capacity_blocks is None else int(capacity_blocks)
        )
        self._lock = threading.Lock()
        self._records: Dict[int, Dict[str, Any]] = {}  # rid -> record
        self.swapped_blocks = 0
        self.bytes_out_total = 0  # cumulative device -> host
        self.bytes_in_total = 0   # cumulative host -> device (resumes)

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    def admit(self, n_blocks: int) -> bool:
        """Would ``n_blocks`` more swapped blocks fit the cap?"""

        if self.capacity_blocks is None:
            return True
        with self._lock:
            return self.swapped_blocks + int(n_blocks) <= self.capacity_blocks

    def put(self, rid: int, record: Dict[str, Any], n_blocks: int,
            nbytes: int) -> None:
        """Store a preempted request's swap record (keyed by pool rid).
        ``n_blocks``/``nbytes`` are the private blocks actually copied
        (exempt blocks stay on the device and count zero here)."""

        with self._lock:
            if rid in self._records:
                raise BlockError(f"request {rid} already has a swap record")
            record = dict(record)
            record["n_blocks"] = int(n_blocks)
            self._records[rid] = record
            self.swapped_blocks += int(n_blocks)
            self.bytes_out_total += int(nbytes)

    def peek(self, rid: int) -> Optional[Dict[str, Any]]:
        with self._lock:
            return self._records.get(rid)

    def pop(self, rid: int, nbytes: int = 0) -> Dict[str, Any]:
        """Remove and return the record at resume (its blocks are being
        uploaded back into freshly allocated device blocks)."""

        with self._lock:
            rec = self._records.pop(rid, None)
            if rec is None:
                raise BlockError(f"request {rid} has no swap record")
            self.swapped_blocks -= rec["n_blocks"]
            self.bytes_in_total += int(nbytes)
            return rec

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "records": len(self._records),
                "swapped_blocks": self.swapped_blocks,
                "capacity_blocks": self.capacity_blocks,
                "bytes_out_total": self.bytes_out_total,
                "bytes_in_total": self.bytes_in_total,
            }


class ArenaTimeline:
    """Bounded ring of block-arena occupancy samples — the time-series
    twin of the instantaneous ``kv_blocks_pressure`` gauge.

    The gauge answers "how full is the arena NOW"; a stuck p99 needs
    "how full was it while THAT request waited".  The paged pool
    records one sample per decode window (plus admission/retire gauge
    refreshes) — host arithmetic only, nothing touches the device, so
    the no-hot-sync gate over the paged step loop is unaffected.
    Served at ``GET /debug/arena`` on serve_lm, and the tail rides every
    flight-recorder dump (a post-mortem shows the pressure history,
    not just the final value).

    Sample shape (all counts in BLOCKS): ``unix``, ``free``, ``live``
    (allocated: seat-mapped + cache-held), ``prefix_cached`` (blocks
    held by the prefix cache — a subset of live), ``queued_demand``
    (block need of queued-but-unadmitted requests), ``seats_active``,
    and ``swapped`` (blocks whose content currently lives host-side in
    the SwapArena: without this series a preempted request's occupancy
    history would silently truncate at its first eviction).
    """

    def __init__(self, capacity: int = 512, block_size: int = 0,
                 usable: int = 0, replica: str = "", role: str = "unified"):
        self.capacity = max(1, int(capacity))
        self.block_size = int(block_size)
        self.usable = int(usable)
        self.replica = str(replica)
        #: the replica's phase role — a disaggregated fleet's
        #: /debug/arena strips are read per role (a prefill replica's
        #: occupancy is churn, a decode replica's is residency)
        self.role = str(role)
        self._lock = threading.Lock()
        self._samples: deque = deque(maxlen=self.capacity)
        self.dropped = 0  # samples aged out of the ring

    def sample(
        self,
        *,
        free: int,
        live: int,
        prefix_cached: int,
        queued_demand: int,
        seats_active: int,
        swapped: int = 0,
    ) -> None:
        rec = {
            "unix": time.time(),
            "free": int(free),
            "live": int(live),
            "prefix_cached": int(prefix_cached),
            "queued_demand": int(queued_demand),
            "seats_active": int(seats_active),
            "swapped": int(swapped),
        }
        with self._lock:
            # consecutive identical samples collapse to the first: an
            # IDLE pool refreshes gauges every decode-loop tick (~200/s),
            # and letting that flood the ring would age real
            # transitions out within seconds of going quiet
            if self._samples:
                last = self._samples[-1]
                if all(last[k] == rec[k] for k in rec if k != "unix"):
                    return
            if len(self._samples) == self._samples.maxlen:
                self.dropped += 1
            self._samples.append(rec)

    def tail(self, limit: Optional[int] = None) -> List[Dict[str, Any]]:
        """Oldest-first copy of the most recent ``limit`` samples.
        ``None`` = all retained; ``limit <= 0`` = none — never the
        whole ring (the ``[-0:]`` pitfall, same guard as
        RequestLog.recent)."""

        with self._lock:
            items = list(self._samples)
        if limit is None:
            return items
        return items[-limit:] if limit > 0 else []

    def snapshot(self, limit: Optional[int] = None) -> Dict[str, Any]:
        """The ``/debug/arena`` read: ring metadata + the sample tail
        (``limit`` semantics as in :meth:`tail`)."""

        with self._lock:
            samples = list(self._samples)
            dropped = self.dropped
        if limit is not None:
            samples = samples[-limit:] if limit > 0 else []
        return {
            "replica": self.replica,
            "role": self.role,
            "block_size": self.block_size,
            "usable": self.usable,
            "capacity": self.capacity,
            "dropped": dropped,
            "samples": samples,
        }

    def __len__(self) -> int:
        with self._lock:
            return len(self._samples)


def blocks_for(tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``tokens`` positions (ceil division)."""

    return -(-int(tokens) // int(block_size))
