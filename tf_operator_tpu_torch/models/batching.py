"""Continuous batching (the port of ``tf_operator_tpu/models/batching.py``):
the contiguous slot pool, ``ContinuousBatchingDecoder``, and the paged
pool built on it, ``PagedContinuousBatchingDecoder``.  The two share the
records, the queue, ``submit``, ``result`` / ``result_wait``, ``run``,
the SLO observations, spans and gauges, and the samplers.

The contiguous pool (the JAX server's pool for a model the paged pool
refuses: a rolling window, or a learned-position family, gpt and moe,
whose seats read the table at their own positions): every seat owns a
row of one slot stack, per layer K/V [slots, Hkv, cache_len, D] with
cache_len = max_len, or the window for a rolling cache, plus a per-slot
write index and, for a rolling cache, per-slot slot positions.  Admission is FIFO into any free
slot:

- without a rolling cache, one ``admission`` dispatch prefills the
  prompt at its exact length straight into the slot's rows, samples the
  first token and seats it (the JAX pool pads to a power-of-two width
  and rolls the index back: the same greedy tokens);
- a rolling cache takes the staged path: the prompt prefills in chunks
  capped at the window (one ``prefill`` dispatch each) into a fresh
  batch-1 cache and the first token is sampled (one ``sample``
  dispatch), on the submitter's thread while one of 2 x slots staging
  permits is free, else at admission with the pool lock dropped; the
  primed cache is then copied into the slot (one ``scatter`` dispatch).

A ``step`` dispatch runs ``steps_per_sync`` decode steps of the whole
stack, each row at its own position, and fetches the window's tokens
once.  A free slot's rows are never read: its steps write only its own
rows (its index rewinds after each window), which the next admission
overwrites first; a seat's steps past its budget land in its own rows.

The paged pool: one pre-allocated block arena backs every seat through
a per-seat block table, and admission is gated on blocks free.

Reservation (``reserve``):

- ``"lazy"`` (the default, as in the JAX pool and the JAX server that
  builds it): admission commits the prompt's blocks plus one decode
  block (at least the first window's coverage, at most the worst
  case).  Before each window every seat's table grows to cover the
  positions the window will append; when the arena runs dry the pool
  preempts a seat to the host and resumes it later, token-identically;
- ``"worst-case"``: admission commits prompt + budget and nothing
  grows.

SLO tiers (``submit(..., tier=)``): ``"batch"`` (the default) and
``"interactive"``.  Queued requests are admitted by priority: the
higher effective rank first (a batch request queued longer than
``age_boost_seconds`` orders like an interactive one), submit order
within a rank; the top request gates the queue.  A shortfall of blocks
is met in order by allocation, eviction of unmapped prefix-cache
entries (LRU first), preemption of a seat (an admission or resume may
take only a lower tier's seat; growth may take its own tier's or
lower), and demotion of a queued preempted request's swap-exempt pins.
A victim has decoded since it was seated; the lowest tier goes first,
then the seat holding the most blocks, then the least progress.

Preemption: the seat's private blocks (refcount 1) are gathered and
copied to the host :class:`SwapArena` in one synchronous device->host
copy (into pinned memory on CUDA); prefix-shared blocks are swap-exempt
and stay live.  When the swap arena's cap refuses the copy the seat is
parked without one (all its blocks stay live).  The seat's device row
resets before any of its blocks is released, and the request re-queues.
Resume uploads the host copies into fresh blocks, re-maps the live
ones, allocates the first window's coverage and writes the seat's row
at the first free slot.  A sampled request's ``torch.Generator`` stays
with the request, untouched while it is parked, so the resumed draws
continue the same stream.

Admission (one request at a time, under the pool lock):

- the longest cached prompt prefix is mapped copy-free into the seat's
  table (refcounted; the last prompt token always re-runs, because its
  logits seed the first sample);
- the remainder is prefilled at its exact length on a contiguous view
  gathered from the seat's blocks (the JAX pool pads to a power-of-two
  width, rolls the pad rows back, and so trims shared blocks that its
  padded width would push past max_len; the eager port needs none of
  it), and exactly ``blocks_for(remainder)`` blocks are scattered back;
- the first token is sampled from the last prompt row;
- every full prompt block is published in the prefix cache;
- a budget-1 request retires at once.

Decode: ``steps_per_sync`` steps per window over device-resident
tables, lengths, temperatures, top-ks and last tokens.  The window's
table growth lands in the device tables in one batched write before
the window reads them.  Each step runs the paged decode branch (the
CUDA paged-attention kernel on the card); the window's tokens reach
the host in one fetch.  Finished seats retire in one batch that resets
their table rows before their freed blocks can be allocated again.

Speculative decoding (``draft_model=``, ``spec_k``, ``spec_tiers``):
requests of the tiers in ``spec_tiers`` decode through a draft model
whose KV pages through the same allocator as the target's, in an arena
twin of its own (a draft block is a block: refcounted, preemptable,
counted in ``kv_blocks_pressure``; it is never prefix-shared).  A
speculating request commits twice its blocks; its admission adds one
``draft`` dispatch that prefills the full prompt through the draft.  A
window partitions the seats: plain seats take the ``step`` dispatch,
speculating seats one ``draft`` dispatch (spec_k + 1 draft steps over
the shared lengths, each sampled through the plain sampler's transform,
keeping its distribution q) and one ``verify`` dispatch (one target
pass over the last token and the spec_k proposals, the paged attention
at k_new = spec_k + 1).  Greedy seats accept a proposal while it equals
the target's argmax; sampled seats accept while ``u * q(tok) <=
p(tok)`` and draw the correction from ``clip(p - q, 0)`` (from p on full
acceptance).  The lengths rewind in the same pass to ``L + accepted +
1``, so the rejected appends of both arenas are dead by the length
mask.  Each program masks the other partition's seats to scratch: a
mixed window is 3 dispatches, an all-speculating one 2.  A sampled
seat's draft, acceptance and correction draws all come from its
request's generator.  Preemption swaps the draft blocks with the
target's (or parks them live), and resume restores both at the same
shared length.  ``spec_snapshot()`` gives the JAX pool's accounting
plus ``launches_per_token``.

Replicas and the fabric (``replica_label``, ``role``, ``fabric``; the
router of models/pool_router.py fronts the replicas): with a fabric
(``prefix_cache.PrefixFabric``, or ``fabric_service.FleetFabric`` across
processes) the admission, after mapping the longest local prefix,
pulls the chain's missing tail from the fabric, uploads it into fresh
blocks in one ``migrate_in`` dispatch and adds it to the local prefix
cache; ``publish_to_fabric`` (a prefill replica's half) runs an internal
budget-1 request through the normal admission, its throwaway first
token greedy, and copies the prompt's full blocks to the host in one
``migrate_out`` dispatch, into the fabric.  Internal requests keep an
autopsy (``internal``) but observe no SLO histogram.  A request the
router backdated (``submit(..., t_submit=, t_submit_mono=)``) measures
TTFT from the router's entry and its queue wait from this pool's.
``load_components()`` splits the routing pressure by phase: queued
block demand and blocks in use, each over the usable blocks (the
contiguous pool counts requests).

Records (the JAX pool's, at its sites): every group of device calls
runs under ``self.dispatch(phase)`` (admission, step, draft, verify,
retire, swap_out, swap_in, migrate_out, migrate_in), which the
:class:`DispatchLedger` counts,
times and, with a tracer, records as a ``dispatch.<phase>`` span.
Each request carries a trace id (given, or minted at submit) and an
autopsy in the :class:`RequestLog`; its lifecycle spans
(``queue.wait``, ``admission``, ``draft``, ``decode.window``,
``preempt``, ``swap_out``, ``swap_in``, ``migrate``, ``retire``) join
that trace and carry the replica.  With a metrics registry the pool
observes the SLO histograms (queue wait, TTFT, time per output token,
by tier; by replica and role under a fleet), sets the queue, in-flight
and ``kv_blocks_*{model, replica, role}`` gauges at every refresh, and
counts ``serve_preemptions_total``, ``kv_swap_bytes_total`` and
``kv_migrate_bytes_total{direction, transport}``; each
refresh also takes one :class:`ArenaTimeline` sample.  A pool built
bare (no ledger, no metrics) counts its dispatches and keeps the
autopsies and the timeline, as the JAX pool built bare does.

The device cost plane (``costplane=``, a ``utils/costplane.CostPlane``;
one over the pool's registry when not passed, as in the JAX pool): the
arena, and the draft twin's, register as ``kv_arena`` when made, the
seats' device state (tables, lengths, temperatures, top-ks, last
tokens) as ``other``; every refresh sets ``swap_staging`` (the swapped
blocks' host bytes, under ``host:<replica>``); every decode window's wall feeds
the step-time sentinel as ``decode.window``.  A pool with no registry
keeps no cost plane (the JAX pool's then writes to the process
registry).  The pool registers no compiles: eager PyTorch builds no
program per admission width, and the kernels record their own
(``ops/_build.py``).  Nothing here reads a device tensor: gauges come
from host counts, tokens from the window's one fetch.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from tf_operator_tpu_torch.models.decode import (
    check_pageable,
    decode_variant,
    gather_block_view,
    init_cache,
    max_window_chunk,
    paged_arena,
    paged_decode_variant,
    sample_categorical,
    scatter_block_view,
    window_chunks,
)
from tf_operator_tpu_torch.models.kv_blocks import (
    SCRATCH_BLOCK,
    ArenaTimeline,
    BlockAllocator,
    BlockError,
    NotPageableError,
    SwapArena,
    blocks_for,
)
from tf_operator_tpu_torch.models.llama import LlamaLM
from tf_operator_tpu_torch.models.prefix_cache import PrefixCache, chain_keys
from tf_operator_tpu_torch.models.transformer import DecodeCache, Family, PagedCache
from tf_operator_tpu_torch.ops import _build
from tf_operator_tpu_torch.ops import paged_attention as _pa
from tf_operator_tpu_torch.ops import quant_matmul as _qm
from tf_operator_tpu_torch.utils.costplane import CostPlane, tree_device_bytes
from tf_operator_tpu_torch.utils.metrics import DispatchLedger

#: the pool's static top-k width: a request's top_k thresholds within
#: the top TOP_K_MAX candidates
TOP_K_MAX = 64

#: SLO tiers: admission order and the preemption policy key off this
#: closed set.  Higher rank = served first; interactive preempts batch
SLO_TIERS = ("batch", "interactive")
_TIER_RANK = {t: i for i, t in enumerate(SLO_TIERS)}

#: replica phase roles (disaggregated serving): a "prefill" replica
#: prefills prompts and publishes their finished blocks into the
#: prefix-cache fabric; a "decode" replica admits by mapping published
#: chains (pulling the missing tail through the fabric) and decodes;
#: "unified" (the default) does both.  The role labels every kv_blocks_*
#: gauge, and every SLO observation of a replica that is not unified
REPLICA_ROLES = ("unified", "prefill", "decode")


def _masked_scaled(logits: torch.Tensor, temps: torch.Tensor,
                   top_ks: torch.Tensor) -> torch.Tensor:
    """Per-seat temperature + top-k transform: [S, V] -> [S, V] with
    candidates below each seat's k-th largest at -inf (top_k 0 = no
    truncation)."""

    safe_t = torch.where(temps > 0.0, temps, 1.0)
    scaled = logits / safe_t[:, None]
    k_max = min(TOP_K_MAX, scaled.shape[-1])
    top_vals = torch.topk(scaled, k_max, dim=-1).values
    idx = torch.clamp(top_ks.long() - 1, 0, k_max - 1)[:, None]
    kth = torch.gather(top_vals, 1, idx)
    return torch.where((top_ks[:, None] > 0) & (scaled < kth), float("-inf"), scaled)


def _step_sample(logits: torch.Tensor, temps: torch.Tensor,
                 top_ks: torch.Tensor,
                 generators: Dict[int, torch.Generator]) -> torch.Tensor:
    """Next token per seat [S]: greedy for seats without a generator,
    a draw from the transformed logits with the seat's own generator
    for the others."""

    out = torch.argmax(logits, dim=-1)
    if generators:
        scaled = _masked_scaled(logits, temps, top_ks)
        for slot, g in generators.items():
            out[slot] = sample_categorical(scaled[slot], g)
    return out


def _spec_sample_with_dist(logits: torch.Tensor, temps: torch.Tensor,
                           top_ks: torch.Tensor,
                           generators: Dict[int, torch.Generator]):
    """``_step_sample`` plus the distribution each sampled seat's token
    was drawn from, the draft side of rejection sampling: (tok [S],
    q [S, V] or None when no seat samples)."""

    out = torch.argmax(logits, dim=-1)
    if not generators:
        return out, None
    scaled = _masked_scaled(logits, temps, top_ks)
    for slot, g in generators.items():
        out[slot] = sample_categorical(scaled[slot], g)
    return out, torch.softmax(scaled, dim=-1)


def _spec_accept(logits: torch.Tensor, drafts: torch.Tensor, q: Optional[torch.Tensor],
                 temps: torch.Tensor, top_ks: torch.Tensor,
                 generators: Dict[int, torch.Generator]):
    """Acceptance and correction of one verify pass: the target's
    logits [S, K+1, V] over ``[x0, d1..dK]``, the proposals ``drafts``
    [S, K] and their distributions ``q`` [S, K, V].  Greedy seats accept
    d(t+1) while it equals the argmax of row t and correct with the
    argmax of the first rejected row; sampled seats (those in
    ``generators``) accept while ``u * q(d) <= p(d)``, with p and q the
    distributions after the plain sampler's transform, and draw the
    correction from ``clip(p - q, 0)`` at the first rejection (from p
    after K acceptances).  Returns (accepted m [S], correction [S])."""

    s, k1, v = logits.shape
    k = k1 - 1
    g = torch.argmax(logits, dim=-1)  # [S, K+1]
    ok = drafts == g[:, :k]
    if generators:
        p = torch.softmax(_masked_scaled(
            logits.reshape(s * k1, v), temps.repeat_interleave(k1),
            top_ks.repeat_interleave(k1)), dim=-1).reshape(s, k1, v)
        p_tok = torch.gather(p[:, :k], 2, drafts[..., None])[..., 0]
        q_tok = torch.gather(q, 2, drafts[..., None])[..., 0]
        u = torch.zeros((s, k), dtype=p.dtype, device=p.device)
        for slot, gen in generators.items():
            u[slot] = torch.rand(k, generator=gen, device=p.device)
        ok = torch.where(temps[:, None] > 0.0, u * q_tok <= p_tok, ok)
    m = torch.where(ok.all(dim=1), k, torch.argmax((~ok).int(), dim=1))
    corr = torch.gather(g, 1, m[:, None])[:, 0]
    if generators:
        # q padded with a zero row: after K acceptances the correction
        # is a draw from p (the bonus token)
        q_pad = torch.cat([q, torch.zeros_like(q[:, :1])], dim=1)
        at = m[:, None, None].expand(s, 1, v)
        resid = (torch.gather(p, 1, at) - torch.gather(q_pad, 1, at))[:, 0].clamp_min(0.0)
        for slot, gen in generators.items():
            corr[slot] = sample_categorical(torch.log(resid[slot] + 1e-20), gen)
    return m, corr


def _admission_sample(last: torch.Tensor, temperature: float,
                      top_k: Optional[int],
                      generator: Optional[torch.Generator]) -> torch.Tensor:
    """The first token from the last prompt row's logits [V]."""

    if temperature <= 0.0:
        return torch.argmax(last)
    dev = last.device
    scaled = _masked_scaled(
        last[None],
        torch.tensor([temperature], dtype=torch.float32, device=dev),
        torch.tensor([top_k or 0], dtype=torch.int32, device=dev),
    )
    return sample_categorical(scaled[0], generator)


def _nbytes(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def _cat_host(old: Optional[torch.Tensor], new: Optional[torch.Tensor]):
    """Two swap copies [layers, 2, n, ...] of one record, in block order."""

    if old is None or new is None:
        return new if old is None else old
    return torch.cat([old, new], dim=2)


class RequestLog:
    """Bounded ring of per-request lifecycle autopsies (a copy of the JAX
    pool's ``RequestLog``).

    The trace store answers "show me the spans of trace T"; this log
    answers the operator question one level up — "what happened to
    REQUEST R": queue wait, admission accounting (width class, blocks
    reserved, prefix-hit depth, prefill dispatches), decode-window and
    token counts, the per-request dispatch share from the ledger, and
    retirement (blocks freed) — one JSON-safe record per request,
    keyed by the request id (= its trace id), served at
    ``GET /requests/<id>`` on serve_lm and riding flight-recorder
    dumps so a post-mortem names the requests in flight.

    Bounded FIFO (oldest evicted past ``capacity``).  Entries are
    mutated through the log's own lock, so an HTTP read never races a
    decode-loop field write mid-serialization.
    """

    def __init__(self, capacity: int = 256):
        self.capacity = max(1, int(capacity))
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self.evicted = 0

    def open(self, **fields) -> Dict[str, Any]:
        """Insert a fresh entry (state=queued) and return it; the
        pool mutates it through update/count_dispatch/add_window.

        Id collisions (a client reusing an ``x-trace-id``): the plain
        id resolves to the NEWEST request (matching the exemplar
        store's latest-wins), and the older autopsy survives under
        ``<id>~<rid>`` instead of being silently dropped (``~`` is
        URL-unreserved, so the demoted id stays fetchable at
        ``/requests/<id>~<rid>`` — ``#`` would be eaten as a URI
        fragment)."""

        entry: Dict[str, Any] = {
            "state": "queued",
            "submit_unix": time.time(),
            "queue_wait_seconds": None,
            "ttft_seconds": None,
            "tpot_seconds": None,
            "total_seconds": None,
            "admission": None,
            "windows": 0,
            "tokens": 0,
            "dispatches": {},
            "retire": None,
            "slot": None,
            "tier": "batch",
            # a seat can leave and come back — without these the
            # autopsy would silently truncate at the first preemption
            "preempted": 0,
            "swapped_blocks": 0,
            # disaggregated serving: which replica ran each phase (the
            # router annotates both), how many prefix blocks arrived
            # over the fabric instead of being computed here, and
            # whether this is an internal fabric-publish prefill
            # (excluded from the user-facing SLO observations)
            "prefill_replica": None,
            "decode_replica": None,
            "migrated_blocks": 0,
            "internal": False,
        }
        entry.update(fields)
        with self._lock:
            old = self._entries.pop(entry["id"], None)
            if old is not None:
                # rewrite the demoted entry's id too, so /requests
                # listings and the lookup key agree
                old["id"] = f"{old['id']}~{old['rid']}"
                self._entries[old["id"]] = old
            self._entries[entry["id"]] = entry
            while len(self._entries) > self.capacity:
                # evict finished autopsies first: an IN-FLIGHT entry
                # is exactly the one an operator is debugging, and
                # its dict is still being written — only when every
                # entry is live does oldest-first keep the bound
                victim = next(
                    (k for k, e in self._entries.items()
                     if e["state"] == "done"),
                    None,
                )
                if victim is not None:
                    del self._entries[victim]
                else:
                    self._entries.popitem(last=False)
                self.evicted += 1
        return entry

    def update(self, entry: Dict[str, Any], **fields) -> None:
        with self._lock:
            entry.update(fields)

    def count_dispatch(self, entry: Dict[str, Any], phase: str,
                       n: int = 1) -> None:
        """This request's share of the ledger: +n dispatches under
        ``phase`` (shared dispatches like a decode window count once
        per seated request — the share, not the global total)."""

        with self._lock:
            entry["dispatches"][phase] = (
                entry["dispatches"].get(phase, 0) + n
            )

    def add_migrate(self, entry: Dict[str, Any], blocks: int) -> None:
        """``blocks`` prefix blocks arrived through the fabric instead of
        being prefilled here."""

        with self._lock:
            entry["migrated_blocks"] += int(blocks)

    def annotate(self, request_id: str, **fields) -> None:
        """Update a live entry by id (the router's cross-replica
        attribution: it learns the prefill / decode split only after the
        pools opened the entry).  No-op for an unknown id."""

        with self._lock:
            entry = self._entries.get(request_id)
            if entry is not None:
                entry.update(fields)

    def add_swap(self, entry: Dict[str, Any], blocks: int) -> None:
        """More of this request's blocks moved host-side WITHOUT a
        seat eviction (the queued-holder demotion path): count them
        without bumping ``preempted``."""

        with self._lock:
            entry["swapped_blocks"] += int(blocks)

    def count_preempt(self, entry: Dict[str, Any],
                      swapped_blocks: int = 0) -> None:
        """The seat left mid-decode: one preemption, with
        its swapped-block share; the autopsy stays complete across the
        leave-and-return."""

        with self._lock:
            entry["preempted"] += 1
            entry["swapped_blocks"] += int(swapped_blocks)
            entry["state"] = "preempted"
            entry["slot"] = None

    def add_window(self, entry: Dict[str, Any], tokens: int) -> None:
        with self._lock:
            entry["windows"] += 1
            entry["tokens"] += int(tokens)
            entry["dispatches"]["step"] = (
                entry["dispatches"].get("step", 0) + 1
            )

    def _copy(self, entry: Dict[str, Any]) -> Dict[str, Any]:
        # entries nest at most one dict deep — copy those too so the
        # caller's JSON serialization never races a later mutation
        return {
            k: (dict(v) if isinstance(v, dict) else v)
            for k, v in entry.items()
        }

    def get(self, request_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            entry = self._entries.get(request_id)
            return self._copy(entry) if entry is not None else None

    def recent(self, limit: int = 50) -> List[Dict[str, Any]]:
        """Newest-first entry copies (list endpoints, flight dumps).
        ``limit <= 0`` returns none — never the whole ring (the
        ``[-0:]`` slice pitfall)."""

        if limit <= 0:
            return []
        with self._lock:
            items = [
                self._copy(e) for e in list(self._entries.values())[-limit:]
            ]
        return items[::-1]

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


class _Request:
    __slots__ = ("rid", "prompt", "budget", "temperature", "top_k",
                 "generator", "tier", "tokens", "done", "slot", "t_submit",
                 "t_submit_mono", "t_local", "t_local_mono", "t_first", "swapped",
                 "tokens_since_seat", "trace_id", "entry", "queue_waited", "staged",
                 "has_permit", "internal")

    def __init__(self, rid, prompt, budget, temperature, top_k, generator, tier,
                 internal=False):
        self.rid = rid
        self.prompt = prompt  # np.ndarray [P] int32
        self.budget = budget
        self.temperature = temperature
        self.top_k = top_k  # None = no truncation
        self.generator = generator
        self.tier = tier
        self.tokens: List[int] = []
        self.done = False
        self.slot: Optional[int] = None
        #: the SLO clock (TTFT, time per output token); the router
        #: backdates it to its own entry, so TTFT spans a handshake
        self.t_submit = time.perf_counter()
        #: the priority clock (submit order, the age boost), backdated
        #: with it
        self.t_submit_mono = time.monotonic()
        #: this pool's own submit: the queue wait and the queue.wait span
        #: measure this replica's queue only
        self.t_local = self.t_submit
        self.t_local_mono = self.t_submit_mono
        self.t_first: Optional[float] = None
        #: preempted: queued with a swap record
        self.swapped = False
        #: tokens decoded since the request last took a seat; a seat is
        #: a preemption victim only once it has made progress
        self.tokens_since_seat = 0
        #: the request's identity: the trace its lifecycle spans join
        #: and the key of its RequestLog autopsy ``entry``
        self.trace_id: Optional[str] = None
        self.entry: Optional[Dict[str, Any]] = None
        #: the queue.wait span is emitted once
        self.queue_waited = False
        #: the contiguous pool's staged path: (primed batch-1 cache, first
        #: token) until seated, and whether it holds a staging permit
        self.staged = None
        self.has_permit = False
        #: a fabric-publish prefill: real pool work, but no user request,
        #: so it stays out of the SLO histograms
        self.internal = internal


class ContinuousBatchingDecoder:
    """Fixed seats over one contiguous slot stack: the port of the JAX
    package's ``ContinuousBatchingDecoder``, the serving pool of a model
    the paged pool refuses (a rolling window, the gpt and moe families)
    and the base of :class:`PagedContinuousBatchingDecoder` (module
    docstring).

    Thread-safe: ``submit`` may be called from request threads while
    one decode loop thread calls ``step``.  ``ledger`` counts (and
    times) the pool's device work by phase: ``admission``, ``step`` (a
    window of ``steps_per_sync`` decode steps, timed up to its fetch)
    and, on the staged path, ``prefill``, ``sample`` and ``scatter``;
    ``request_log`` keeps each request's autopsy.  ``metrics`` (default:
    the ledger's registry) receives the SLO histograms and the gauges;
    ``model_label`` is their ``model`` label.  ``costplane`` shares a
    cost plane (a server's, over its registry); one is made over the
    pool's registry when not given, and a pool with no registry keeps
    none.  An HTTP read of the records takes their own locks, never the
    pool's."""

    #: speculative decoding, the arena timeline, phase roles and the
    #: fabric are the paged pool's
    spec_enabled = False
    spec_tiers: tuple = ()
    timeline: Optional[ArenaTimeline] = None
    role = "unified"
    fabric = None

    def __init__(self, model: Family, slots: int = 8, steps_per_sync: int = 8,
                 ledger: Optional[DispatchLedger] = None, metrics=None,
                 model_label: str = "", replica_label: str = "", costplane=None):
        self.ledger = ledger if ledger is not None else DispatchLedger()
        self.metrics = metrics if metrics is not None else self.ledger.metrics
        if costplane is None and self.metrics is not None:
            costplane = CostPlane(metrics=self.metrics)
        self.costplane = costplane
        self.model_label = model_label or "unknown"
        #: set under the multi-replica router (models/pool_router.py):
        #: non-empty adds {replica} to every SLO observation and queue
        #: gauge; spans, autopsies, the timeline and the kv_blocks_*
        #: gauges carry it always (else "0")
        self.replica_label = replica_label
        #: the label the pool's records carry ("0" for an unlabelled pool)
        self.replica = replica_label or "0"
        #: the ledger's tracer (None: no spans) carries the lifecycle
        #: spans of every request
        self.tracer = self.ledger.tracer
        self.request_log = RequestLog()
        self.device = model.device
        self.dmodel = decode_variant(model)
        self.slots = int(slots)
        if self.slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        self.steps_per_sync = max(1, int(steps_per_sync))
        self.max_len = model.cfg.max_len
        #: decode windows run
        self.windows = 0
        self._lock = threading.Lock()
        self._done_cond = threading.Condition(self._lock)
        self._rid = 0
        self._queue: List[_Request] = []
        self._active: Dict[int, _Request] = {}
        self._results: Dict[int, _Request] = {}
        #: slot -> the sampled request's generator (greedy seats: none)
        self._generators: Dict[int, torch.Generator] = {}
        self._init_pool_cache()

    def _init_pool_cache(self) -> None:
        """The slot stack and the seats' device state (the paged pool
        builds its block arena instead)."""

        dev = self.device
        #: widths of a rolling cache's staged prefill are capped at the
        #: window; None = every admission is one dispatch
        self._max_chunk = max_window_chunk(self.dmodel.cfg)
        #: eager staged prefills each hold a primed batch-1 cache on the
        #: device until seated; the permits bound them at 2 x slots, and
        #: past that a request primes lazily at admission
        self._staging = threading.BoundedSemaphore(max(1, 2 * self.slots))
        #: slots picked by a staged admission whose prefill runs with the
        #: lock dropped
        self._reserved: set = set()
        self._cache = init_cache(self.dmodel, self.slots)
        self._cache.index = torch.zeros(self.slots, dtype=torch.long, device=dev)
        self._last_tok = torch.zeros(self.slots, dtype=torch.long, device=dev)
        self._temps_dev = torch.zeros(self.slots, dtype=torch.float32, device=dev)
        self._topks_dev = torch.zeros(self.slots, dtype=torch.int32, device=dev)
        if self.costplane is not None:
            self.costplane.hbm.register_tree("kv_arena", self._cache.layers)
            self.costplane.hbm.register_tree("other", [
                self._cache.index, self._cache.pos, self._last_tok, self._temps_dev,
                self._topks_dev])

    # -- public API --------------------------------------------------------

    def submit(self, prompt_ids, max_new_tokens: int, *,
               temperature: float = 0.0, top_k: Optional[int] = None,
               generator: Optional[torch.Generator] = None,
               tier: str = "batch", trace_id: Optional[str] = None,
               internal: bool = False, t_submit: Optional[float] = None,
               t_submit_mono: Optional[float] = None) -> int:
        """Queue one request ([P] ids).  Returns its id; collect the
        output with ``result``/``result_wait``.  A sampled request
        (temperature > 0) draws from its own ``generator``, which must
        live on the pool's device.  ``tier`` is its SLO tier.
        ``trace_id`` is its identity (serve_lm passes the HTTP request's);
        without one the tracer mints one, and a pool without a tracer
        names it ``treq-<replica>-<rid>``.  ``internal`` marks a
        fabric-publish prefill, kept out of the SLO observations.
        ``t_submit`` / ``t_submit_mono`` (``time.perf_counter`` /
        ``time.monotonic``) backdate the SLO and priority clocks to an
        earlier entry: the disaggregated router's, so that TTFT spans the
        whole handshake.  On the contiguous pool's staged path the prompt
        prefills here, on the caller's thread, while a staging permit is
        free."""

        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must contain at least one token")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if prompt.size + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_len={self.max_len}"
            )
        if temperature < 0.0:
            raise ValueError("temperature must be >= 0")
        if temperature > 0.0 and generator is None:
            raise ValueError("temperature sampling needs an explicit torch.Generator")
        if temperature == 0.0:
            top_k, generator = None, None  # greedy ignores both
        if top_k is not None:
            top_k = int(top_k)
            if not 1 <= top_k <= TOP_K_MAX:
                raise ValueError(
                    f"top_k must be in [1, {TOP_K_MAX}] (the pool's static "
                    f"top-k width), got {top_k}"
                )
        if tier not in SLO_TIERS:
            raise ValueError(f"tier must be one of {SLO_TIERS}, got {tier!r}")
        self._check_fits(prompt.size, max_new_tokens, tier)
        with self._lock:
            rid = self._rid
            self._rid += 1
        req = _Request(rid, prompt, int(max_new_tokens), float(temperature), top_k,
                       generator, tier, internal=bool(internal))
        if t_submit is not None:
            req.t_submit = float(t_submit)
        if t_submit_mono is not None:
            req.t_submit_mono = float(t_submit_mono)
        if trace_id is not None:
            req.trace_id = str(trace_id)
        elif self.tracer is not None:
            req.trace_id = self.tracer.mint_trace_id()
        else:
            req.trace_id = f"treq-{self.replica}-{rid}"
        req.entry = self.request_log.open(
            id=req.trace_id, rid=rid, replica=self.replica,
            model=self.model_label, prompt_tokens=int(prompt.size),
            max_new_tokens=int(max_new_tokens), tier=tier, internal=bool(internal),
        )
        self._stage(req)
        with self._lock:
            self._results[rid] = req
            if req.staged is not None and len(req.tokens) >= req.budget:
                # budget 1, prefilled eagerly: complete without a seat
                self._release_staged(req)
                self._finish_locked(req, 0)
            else:
                self._queue.append(req)
            self._update_gauges_locked()
        return rid

    def _check_fits(self, p_len: int, max_new_tokens: int, tier: str) -> None:
        """Refuse a request that no admission could ever seat (every
        slot holds any request that fits max_len)."""

    def _spec_tier(self, tier: str) -> bool:
        """True when requests of ``tier`` decode speculatively."""

        return self.spec_enabled and tier in self.spec_tiers

    def result(self, rid: int):
        """[P + n] int32 (prompt + generated), or None if not done.
        A finished request is evicted on first read."""

        with self._lock:
            req = self._results.get(rid)
            if req is None:
                raise KeyError(f"request {rid} unknown or already collected")
            if not req.done:
                return None
            del self._results[rid]
        return np.concatenate([req.prompt, np.asarray(req.tokens, np.int32)])

    def result_wait(self, rid: int, timeout: Optional[float] = None):
        """Block until request ``rid`` finishes; the [P + n] int32 row,
        or None on timeout.  Evicts like ``result``."""

        with self._done_cond:
            ok = self._done_cond.wait_for(
                lambda: rid not in self._results or self._results[rid].done,
                timeout=timeout,
            )
            if not ok:
                return None
            req = self._results.pop(rid, None)
            if req is None:
                raise KeyError(f"request {rid} unknown or already collected")
        return np.concatenate([req.prompt, np.asarray(req.tokens, np.int32)])

    def in_flight(self) -> int:
        """Requests seated or queued: host counts, read without the
        pool's lock (a decode window may hold it)."""

        return len(self._active) + len(self._queue)

    def load_score(self) -> float:
        """The multi-replica router's routing pressure: the sum of
        ``load_components``."""

        components = self.load_components()
        return components["prefill"] + components["decode"]

    def load_components(self) -> Dict[str, float]:
        """``load_score`` split by phase: ``prefill`` the queued requests
        (admission work to do), ``decode`` the seated ones (the paged pool
        counts blocks instead)."""

        with self._lock:
            return {"prefill": float(len(self._queue)), "decode": float(len(self._active))}

    def run(self) -> None:
        """Step until every submitted request has finished."""

        while True:
            with self._lock:
                if not self._queue and not self._active:
                    return
            self.step()

    # -- records -----------------------------------------------------------

    def _labels(self, **extra) -> Dict[str, str]:
        """{model[, replica][, role]} + extra: the replica key only under
        the router, the role only when not unified (``/slo`` merges both
        away)."""

        out = dict(model=self.model_label, **extra)
        if self.replica_label:
            out["replica"] = self.replica_label
        if self.role != "unified":
            out["role"] = self.role
        return out

    def dispatch(self, phase: str, **attrs):
        """``ledger.dispatch`` with the replica attribute on its span;
        every group of device calls of the pool runs under one."""

        attrs.setdefault("replica", self.replica)
        return self.ledger.dispatch(phase, **attrs)

    def _request_span(self, req: _Request, name: str, **attrs):
        """A lifecycle span on ``req``'s trace, as a context manager
        (a null one without a tracer).  Dispatches issued inside it
        nest under it."""

        if self.tracer is None:
            return contextlib.nullcontext(None)
        attrs.setdefault("rid", req.rid)
        attrs.setdefault("replica", self.replica)
        return self.tracer.start_span(name, trace_id=req.trace_id, attributes=attrs)

    def _emit_span(self, req: _Request, name: str, start_mono: float,
                   end_mono: float, **attrs) -> None:
        """A finished lifecycle span with explicit endpoints."""

        if self.tracer is None:
            return
        attrs.setdefault("rid", req.rid)
        attrs.setdefault("replica", self.replica)
        self.tracer.start_span(
            name, trace_id=req.trace_id, attributes=attrs, start_mono=start_mono,
        ).end(end_mono=end_mono)

    def _emit_queue_wait(self, req: _Request) -> None:
        """queue.wait: this pool's submit -> the first admission work,
        backdated to the submit, once per request (a handshake's phases
        have their own spans)."""

        if req.queue_waited:
            return
        req.queue_waited = True
        self._emit_span(req, "queue.wait", req.t_local_mono, time.monotonic())

    def _observe_first_token(self, req: _Request, work_start: float) -> None:
        """The first token reached the host: queue wait (this pool's
        submit -> first device work) and TTFT (the request's submit ->
        first token), once.  An internal request observes nothing."""

        if req.t_first is not None:
            return
        req.t_first = time.perf_counter()
        wait = max(0.0, work_start - req.t_local)
        self.request_log.update(
            req.entry, queue_wait_seconds=round(wait, 6),
            ttft_seconds=round(req.t_first - req.t_submit, 6),
        )
        if self.metrics is None or req.internal:
            return
        self.metrics.observe_histogram(
            "serve_queue_wait_seconds", wait, exemplar=req.trace_id,
            tier=req.tier, **self._labels(mode="pool"),
        )
        self.metrics.observe_histogram(
            "serve_ttft_seconds", req.t_first - req.t_submit,
            exemplar=req.trace_id, tier=req.tier, **self._labels(mode="pool"),
        )

    def _update_gauges_locked(self) -> None:
        """The queue-depth and tokens-in-flight gauges (caller holds the
        lock; host counts only)."""

        if self.metrics is not None:
            self.metrics.set("serve_admission_queue_depth", float(len(self._queue)),
                             **self._labels())
            inflight = sum(r.budget - len(r.tokens) for r in self._active.values()) \
                + sum(r.budget - len(r.tokens) for r in self._queue)
            self.metrics.set("serve_tokens_in_flight", float(max(0, inflight)),
                             **self._labels())

    def _finish_locked(self, req: _Request, blocks_freed: int) -> None:
        """Retirement (caller holds the lock): the retire span, the
        autopsy's final timings, time per output token, and the
        waiters' wake-up."""

        req.done = True
        req.slot = None
        now = time.monotonic()
        self._emit_span(req, "retire", now, now, blocks_freed=blocks_freed,
                        tokens=len(req.tokens))
        t_done = time.perf_counter()
        t_first = req.t_first if req.t_first is not None else t_done
        tpot = (t_done - t_first) / max(1, len(req.tokens) - 1)
        self.request_log.update(
            req.entry, state="done", retire={"blocks_freed": int(blocks_freed)},
            total_seconds=round(t_done - req.t_submit, 6), tpot_seconds=round(tpot, 6),
            tokens=len(req.tokens),
        )
        if self.metrics is not None and not req.internal:
            self.metrics.observe_histogram(
                "serve_time_per_output_token_seconds", tpot, exemplar=req.trace_id,
                tier=req.tier, **self._labels(mode="pool"),
            )
        self._done_cond.notify_all()

    def _observe_window(self, t_window0: float, t_window1: float) -> None:
        """One decode window ran: its count, and its host wall as one
        sentinel observation (no device call)."""

        self.windows += 1
        if self.costplane is not None:
            self.costplane.sentinel.observe("decode.window", t_window1 - t_window0)

    # -- the contiguous pool's admission ------------------------------------

    def _stage(self, req: _Request) -> None:
        """The staged path of a rolling cache: prefill now, on the
        submitter's thread, while a staging permit is free (past the
        permits the request primes at admission instead)."""

        if self._max_chunk is None or not self._staging.acquire(blocking=False):
            return
        req.has_permit = True
        try:
            self._prefill_request(req)
        except BaseException:
            req.has_permit = False
            self._staging.release()
            raise

    def _release_staged(self, req: _Request) -> None:
        req.staged = None
        if req.has_permit:
            req.has_permit = False
            self._staging.release()

    @torch.inference_mode()
    def _prefill_request(self, req: _Request) -> None:
        """A staged admission's device work with no pool lock held: the
        prompt in chunks capped at the window (one ``prefill`` dispatch
        each) into a fresh batch-1 rolling cache, and the first token
        (one ``sample`` dispatch, its fetch inside)."""

        work_start = time.perf_counter()
        # queue.wait ends at the first device work; seating comes later
        self._emit_queue_wait(req)
        cache = init_cache(self.dmodel, 1)
        off = 0
        for width in window_chunks(req.prompt.size, self._max_chunk):
            ids = torch.as_tensor(req.prompt[off : off + width], device=self.device)[None]
            with self.dispatch("prefill", rid=req.rid):
                last = self.dmodel(ids, cache=cache)[0, -1]
            self.request_log.count_dispatch(req.entry, "prefill")
            off += width
        with self.dispatch("sample", rid=req.rid):
            tok = _admission_sample(last, req.temperature, req.top_k, req.generator)
            tok_h = int(tok)
        req.staged = (cache, tok)
        req.tokens.append(tok_h)
        self.request_log.count_dispatch(req.entry, "sample")
        self._observe_first_token(req, work_start)

    def _seat_row(self, slot: int, length: int, req: _Request, tok) -> None:
        self._cache.index[slot] = length
        self._last_tok[slot] = tok
        self._temps_dev[slot] = req.temperature
        self._topks_dev[slot] = req.top_k or 0

    def _scatter(self, slot: int, req: _Request) -> None:
        """Seat a staged request: its batch-1 cache (and slot positions)
        into the slot's rows, and the seat's state."""

        cache, tok = req.staged
        for (sk, sv), (rk, rv) in zip(self._cache.layers, cache.layers):
            sk[slot] = rk[0]
            sv[slot] = rv[0]
        self._cache.pos[slot] = cache.pos[0]
        self._seat_row(slot, req.prompt.size, req, tok)

    @torch.inference_mode()
    def _admit_fused(self, req: _Request, slot: int) -> None:
        """Seat one request in one ``admission`` dispatch (caller holds
        the lock): the prompt at its exact length straight into the
        slot's rows (positions past it are masked until written), the
        first token from its last row, and the seat's state."""

        p_len = req.prompt.size
        work_start = time.perf_counter()
        self._emit_queue_wait(req)
        with self._request_span(req, "admission", width=p_len, slot=slot):
            with self.dispatch("admission", rid=req.rid, width=p_len):
                view = DecodeCache([(k[slot : slot + 1], v[slot : slot + 1])
                                    for k, v in self._cache.layers])
                ids = torch.as_tensor(req.prompt, device=self.device)[None]
                logits = self.dmodel(ids, cache=view)
                tok = _admission_sample(logits[0, -1], req.temperature, req.top_k,
                                        req.generator)
                self._seat_row(slot, p_len, req, tok)
                tok_h = int(tok)  # the admission's one host fetch, in its dispatch
        req.tokens.append(tok_h)
        self.request_log.count_dispatch(req.entry, "admission")
        self.request_log.update(
            req.entry, state="active", slot=slot,
            admission={"width": int(p_len), "prefill_dispatches": 0,
                       "seconds": round(time.perf_counter() - work_start, 6)},
        )
        self._observe_first_token(req, work_start)
        if len(req.tokens) >= req.budget:
            # budget 1: the admission token completed it; the slot's rows
            # are dead and the slot stays free
            self._finish_locked(req, 0)
        else:
            self._take_seat(req, slot)

    def _take_seat(self, req: _Request, slot: int) -> None:
        req.slot = slot
        self._active[slot] = req
        if req.generator is not None:
            self._generators[slot] = req.generator

    def _admit(self) -> None:
        """Seat queued requests in submit order while a slot is free.
        Without a rolling cache each admission is one dispatch under the
        lock; a rolling cache's staged request prefills with the lock
        dropped (when it was not staged at submit), then is scattered
        into its slot under the lock.  A failed admission puts the
        request back at the queue's head."""

        while True:
            with self._lock:
                if not self._queue:
                    return
                free = [s for s in range(self.slots)
                        if s not in self._active and s not in self._reserved]
                if not free:
                    return
                req = self._queue.pop(0)
                slot = free[0]
                if self._max_chunk is None:
                    try:
                        self._admit_fused(req, slot)
                        self._update_gauges_locked()
                    except BaseException:
                        self._queue.insert(0, req)
                        raise
                    continue
                self._reserved.add(slot)
            try:
                if req.staged is None:
                    self._prefill_request(req)
            except BaseException:
                with self._lock:
                    self._reserved.discard(slot)
                    self._queue.insert(0, req)
                raise
            with self._lock:
                self._reserved.discard(slot)
                if len(req.tokens) >= req.budget:
                    # budget 1 primed at admission: done without the seat
                    self._release_staged(req)
                    self._finish_locked(req, 0)
                    self._update_gauges_locked()
                    continue
                with self._request_span(req, "admission", slot=slot, path="staged"):
                    with self.dispatch("scatter", rid=req.rid):
                        self._scatter(slot, req)
                self._release_staged(req)
                self.request_log.count_dispatch(req.entry, "scatter")
                self.request_log.update(
                    req.entry, state="active", slot=slot,
                    admission={"width": None,
                               "prefill_dispatches": req.entry["dispatches"].get("prefill", 0),
                               "path": "staged"},
                )
                self._take_seat(req, slot)
                self._update_gauges_locked()

    # -- the contiguous pool's decode -----------------------------------------

    @torch.inference_mode()
    def step(self) -> int:
        """Admit, run one window of ``steps_per_sync`` decode steps over
        the slot stack (one ``step`` dispatch, one fetch), hand out the
        tokens and retire the finished seats.  Returns the number of
        seats still active."""

        self._admit()
        with self._lock:
            if not self._active:
                return 0
            seats_active = len(self._active)
            slots = sorted(self._active)
            enabled = self._seat_mask(slots)
            gens = {s: self._generators[s] for s in slots if s in self._generators}
            t_window0 = time.monotonic()
            toks = self._last_tok
            window = []
            with self.dispatch("step", active=seats_active):
                # every slot steps; a free slot writes only its own dead
                # rows, which the next admission overwrites before any read
                for _ in range(self.steps_per_sync):
                    logits = self.dmodel(toks[:, None], cache=self._cache)
                    toks = _step_sample(logits[:, 0], self._temps_dev, self._topks_dev, gens)
                    window.append(toks)
                host = torch.stack(window).cpu().numpy()  # [K, S]: one fetch
            # free slots rewind, so their writes stay at the rows' start
            self._cache.index = torch.where(enabled, self._cache.index, 0)
            self._last_tok = torch.where(enabled, toks, self._last_tok)
            t_window1 = time.monotonic()
            self._observe_window(t_window0, t_window1)
            for slot in slots:
                req = self._active[slot]
                take = min(len(host), req.budget - len(req.tokens))
                req.tokens.extend(int(t) for t in host[:take, slot])
                self._emit_span(req, "decode.window", t_window0, t_window1,
                                tokens=take, seats_active=seats_active)
                self.request_log.add_window(req.entry, take)
                if len(req.tokens) >= req.budget:
                    # its steps past the budget wrote only its own rows
                    del self._active[slot]
                    self._generators.pop(slot, None)
                    self._finish_locked(req, 0)
            self._update_gauges_locked()
            return len(self._active)

    def _seat_mask(self, slots: List[int]) -> torch.Tensor:
        mask = np.zeros(self.slots, bool)
        mask[slots] = True
        return torch.as_tensor(mask, device=self.device)


class PagedContinuousBatchingDecoder(ContinuousBatchingDecoder):
    """Fixed seats over one block arena (module docstring).

    Thread-safe: ``submit`` may be called from request threads while
    one decode loop thread calls ``step``.  ``ledger`` counts (and
    times) the pool's device work by phase: a ``step`` dispatch is one
    window of ``steps_per_sync`` decode steps, timed up to its fetch; ``request_log`` keeps each
    request's autopsy; ``timeline`` the arena's occupancy history;
    ``swap_log`` one record per swap copy (direction, blocks, bytes,
    host seconds, and on CUDA the events around it).  ``metrics``
    (default: the ledger's registry) receives the SLO histograms, the
    gauges and the counters; ``model_label`` is their ``model`` label.
    An HTTP read of the records takes their own locks, never the
    pool's.

    ``draft_model`` (a ``LlamaLM`` with weights, for example the target's
    int8 twin) turns on speculative decoding for the tiers in
    ``spec_tiers``, ``spec_k`` proposals a window (module docstring).  It
    takes the place of the JAX pool's ``draft_model`` + ``draft_params``
    pair.  A configuration that cannot speculate raises here rather than
    serve non-speculatively.  ``costplane`` shares a cost plane (a
    server's, over its registry; module docstring).

    ``replica_label`` and ``role`` (``REPLICA_ROLES``) place the pool in a
    fleet (models/pool_router.py).  ``fabric`` (a
    ``prefix_cache.PrefixFabric``, or a ``fabric_service.FleetFabric``,
    which gets the arena's template) is the migration transport: with one,
    admission pulls the missing tail of a prompt's chain from it (one
    ``migrate_in`` dispatch) and ``publish_to_fabric`` pushes a prompt's
    finished blocks into it (one ``migrate_out`` dispatch); a prefill
    replica needs one."""

    def __init__(self, model: LlamaLM, slots: int = 8, steps_per_sync: int = 8,
                 kv_blocks: Optional[int] = None, kv_block_size: int = 16,
                 reserve: str = "lazy", swap_blocks: Optional[int] = None,
                 age_boost_seconds: float = 30.0,
                 ledger: Optional[DispatchLedger] = None, metrics=None,
                 model_label: str = "", replica_label: str = "", role: str = "unified",
                 fabric=None, draft_model: Optional[LlamaLM] = None,
                 spec_k: int = 4, spec_tiers=("interactive",), costplane=None):
        # before any state is made: a learned-position family or a
        # rolling window raises NotPageableError here
        check_pageable(model)
        if role not in REPLICA_ROLES:
            raise ValueError(f"role must be one of {REPLICA_ROLES}, got {role!r}")
        if role == "prefill" and fabric is None:
            raise ValueError(
                "a prefill-role replica is pointless without a prefix-cache fabric to "
                "publish into — pass fabric="
            )
        if reserve not in ("lazy", "worst-case"):
            raise ValueError(
                f"reserve must be 'lazy' or 'worst-case', got {reserve!r}"
            )
        self.role = role
        self.fabric = fabric
        super().__init__(model, slots=slots, steps_per_sync=steps_per_sync, ledger=ledger,
                         metrics=metrics, model_label=model_label,
                         replica_label=replica_label, costplane=costplane)
        self.reserve = reserve
        self.age_boost_seconds = float(age_boost_seconds)
        self.pmodel = paged_decode_variant(model)
        bs = int(kv_block_size)
        if bs < 1 or self.max_len % bs:
            raise ValueError(
                f"kv_block_size={bs} must divide max_len={self.max_len}"
            )
        self.block_size = bs
        self.max_blocks = self.max_len // bs
        if kv_blocks is None:
            # the HBM a contiguous pool would pin: slots x max_len
            kv_blocks = self.slots * self.max_blocks
        #: arena rows = usable blocks + the scratch block (id 0)
        self.num_blocks = int(kv_blocks) + 1
        self.alloc = BlockAllocator(self.num_blocks, bs)
        self._arena = paged_arena(model, self.num_blocks, bs)
        arena_bytes = sum(tree_device_bytes(self._arena).values())
        #: a block's bytes on the host once swapped (the swap-staging gauge)
        self._block_host_bytes = arena_bytes // self.num_blocks
        if self.costplane is not None:
            self.costplane.hbm.register_tree("kv_arena", self._arena)
        if fabric is not None and hasattr(fabric, "register_template"):
            # a fleet fabric rebuilds pulled blocks against this arena
            fabric.register_template(self._arena)
        self.spec_enabled = draft_model is not None
        self.spec_k = int(spec_k)
        self.spec_tiers = tuple(spec_tiers)
        #: slot -> physical ids behind a speculating seat's draft table
        #: row, in logical order (all private: the draft never shares)
        self._draft_refs: Dict[int, List[int]] = {}
        self._draft_arena = self._draft_tables_dev = None
        # the JAX pool's host counters: dispatches a token = 2 windows /
        # emitted; the port adds the K4 + K7 launches of draft and verify
        self.spec_windows = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_rollbacks = 0
        self.spec_emitted = 0
        self.spec_launches = 0
        if self.spec_enabled:
            self._init_draft(draft_model)
        #: a window's appends (steps_per_sync, or spec_k + 1 for a
        #: speculating seat) straddle at most this many blocks: the
        #: width of the growth written before each window
        adv = max(self.steps_per_sync, self.spec_k + 1 if self.spec_enabled else 1)
        self._step_nbw = (adv - 1) // bs + 2
        #: preempted seats' private blocks wait here until resume
        self.swap = SwapArena(capacity_blocks=swap_blocks)
        self.preemptions = 0
        self.swap_log: "collections.deque[dict]" = collections.deque(maxlen=256)
        #: one record per fabric copy, as ``swap_log``'s
        #: (``migrate_out`` / ``migrate_in``)
        self.migrate_log: "collections.deque[dict]" = collections.deque(maxlen=256)
        dev = self.device
        # device-resident seat state: written at admission and resume,
        # advanced by the step window, reset at retire and preemption —
        # no per-step uploads
        self._tables_dev = torch.full(
            (self.slots, self.max_blocks), SCRATCH_BLOCK, dtype=torch.int32, device=dev
        )
        self._lengths_dev = torch.zeros(self.slots, dtype=torch.int32, device=dev)
        self._temps_dev = torch.zeros(self.slots, dtype=torch.float32, device=dev)
        self._topks_dev = torch.zeros(self.slots, dtype=torch.int32, device=dev)
        self._last_tok = torch.zeros(self.slots, dtype=torch.long, device=dev)
        if self.costplane is not None:
            self.costplane.hbm.register_tree("other", [
                self._tables_dev, self._lengths_dev, self._temps_dev, self._topks_dev,
                self._last_tok, self._draft_tables_dev])
        #: slot -> physical ids behind the seat's table row, in logical
        #: order (admission builds it, growth appends): what preemption
        #: reads to know which block sits at which index
        self._seat_refs: Dict[int, List[int]] = {}
        #: shared prefix store — a block is evictable only while nothing
        #: maps it (refcount 1 = the cache's own reference)
        self.prefix = PrefixCache(
            metrics=self.metrics,
            can_evict=lambda bid: self.alloc.refcount(bid) == 1,
            on_evict=lambda bid: self.alloc.release([bid]),
        )
        #: one occupancy sample at each gauge refresh
        self.timeline = ArenaTimeline(
            block_size=bs, usable=self.alloc.usable, replica=self.replica,
            role=self.role,
        )
        self._update_kv_gauges()

    def _init_pool_cache(self) -> None:
        """No slot stack: the arena is built by ``__init__``."""

    def _stage(self, req: _Request) -> None:
        """Nothing at submit: admission does the device work."""

    def _init_draft(self, draft: LlamaLM) -> None:
        """Validate the speculative configuration (the JAX pool's checks
        and messages) and build the draft's decode views, arena twin and
        table rows."""

        if self.spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {self.spec_k!r}")
        bad = [t for t in self.spec_tiers if t not in _TIER_RANK]
        if bad:
            raise ValueError(
                f"spec_tiers {bad} are not SLO tiers {SLO_TIERS} — failing instead of "
                "silently serving them non-speculatively"
            )
        if draft.device.type == "meta":
            # a module without weights: the JAX pool's draft_model
            # given without draft_params
            raise ValueError("draft_model requires draft weights: its parameters are on "
                             "the meta device")
        if draft.device != self.device:
            raise ValueError(f"draft on {draft.device}, target on {self.device}: the "
                             "speculative window runs both on one device")
        if draft.cfg.max_len != self.max_len:
            raise ValueError(
                f"draft max_len={draft.cfg.max_len} != target max_len={self.max_len} — "
                "the shared block tables need one geometry"
            )
        try:
            self._draft_arena = paged_arena(draft, self.num_blocks, self.block_size)
            self._draft_pmodel = paged_decode_variant(draft)
            # the draft twin is arena memory too
            if self.costplane is not None:
                self.costplane.hbm.register_tree("kv_arena", self._draft_arena)
        except NotPageableError as exc:
            raise ValueError(
                f"draft model cannot page: {exc} — failing instead of silently serving "
                "non-speculatively"
            ) from exc
        self._draft_dmodel = decode_variant(draft)
        self._draft_tables_dev = torch.full(
            (self.slots, self.max_blocks), SCRATCH_BLOCK, dtype=torch.int32, device=self.device
        )

    def _spec_req(self, req: "_Request") -> bool:
        return self._spec_tier(req.tier)

    def spec_snapshot(self) -> Dict[str, float]:
        """The JAX pool's speculative accounting (acceptance rate, and
        dispatches a token: draft + verify dispatches over the tokens
        delivered), plus ``launches_per_token``: the K4 and K7 launches of
        those dispatches over the same tokens, what a dispatch costs in an
        eager step (0 on the CPU, where the plain versions run)."""

        windows, emitted = self.spec_windows, self.spec_emitted
        return {
            "spec_windows": float(windows),
            "spec_proposed": float(self.spec_proposed),
            "spec_accepted": float(self.spec_accepted),
            "spec_rollbacks": float(self.spec_rollbacks),
            "spec_emitted": float(emitted),
            "acceptance_rate": (self.spec_accepted / self.spec_proposed
                                if self.spec_proposed else 0.0),
            "dispatches_per_token": 2.0 * windows / emitted if emitted else float("inf"),
            "launches_per_token": (self.spec_launches / emitted if emitted
                                   else float("inf")),
        }

    def _check_fits(self, p_len: int, max_new_tokens: int, tier: str) -> None:
        need = blocks_for(p_len + max_new_tokens, self.block_size)
        if self._spec_tier(tier):
            # a speculating seat pins a draft twin of every target block
            need *= 2
        if need > self.alloc.usable:
            raise ValueError(
                f"request needs {need} KV blocks but the arena has only "
                f"{self.alloc.usable} — admission could never succeed"
            )

    def _update_gauges_locked(self) -> None:
        """The base gauges, then the arena's (caller holds the lock;
        host counts only)."""

        super()._update_gauges_locked()
        self._update_kv_gauges()

    def _queued_blocks(self) -> int:
        """Block demand of the queue: a fresh request's admission commit,
        a preempted one's blocks to upload (caller holds the lock)."""

        total = 0
        for r in self._queue:
            if r.swapped:
                rec = self.swap.peek(r.rid)
                total += rec["n_blocks"] if rec is not None else 0
            else:
                commit = self._commit_blocks(r.prompt.size, r.budget)
                # the draft twin rides a speculating request's admission
                total += 2 * commit if self._spec_req(r) else commit
        return total

    def _update_kv_gauges(self) -> None:
        """One timeline sample, then the ``kv_blocks_*`` gauges labelled
        ``{model, replica, role}``: pressure is (in use + queued demand)
        / usable; committed = allocated, reserved = the seats' worst
        cases."""

        free = float(self.alloc.free_count)
        total = float(self.alloc.usable)
        queued = float(self._queued_blocks())
        reserved = float(sum(blocks_for(r.prompt.size + r.budget, self.block_size)
                             for r in self._active.values()))
        self.timeline.sample(
            free=int(free), live=int(total - free), prefix_cached=len(self.prefix),
            queued_demand=int(queued), seats_active=len(self._active),
            swapped=int(self.swap.swapped_blocks),
        )
        if self.costplane is not None:
            # host RAM pinned by preempted seats' blocks (host arithmetic)
            self.costplane.hbm.set_component(
                "swap_staging", self.swap.swapped_blocks * self._block_host_bytes,
                device=f"host:{self.replica}")
        if self.metrics is None:
            return
        # {role} on every kv_blocks_* gauge, unified included, so that an
        # autoscaler scales the prefill and decode classes apart
        labels = dict(model=self.model_label, replica=self.replica,
                      role=self.role)
        for name, value in (("kv_blocks_free", free), ("kv_blocks_total", total),
                            ("kv_blocks_in_use", total - free),
                            ("kv_blocks_committed", total - free),
                            ("kv_blocks_reserved", reserved),
                            ("kv_blocks_queued_demand", queued),
                            ("kv_blocks_pressure", (total - free + queued) / total)):
            self.metrics.set(name, value, **labels)

    def _count_swap_bytes(self, direction: str, nbytes: int) -> None:
        if self.metrics is not None and nbytes:
            self.metrics.inc("kv_swap_bytes_total", float(nbytes), direction=direction)

    def _count_migrate_bytes(self, direction: str, nbytes: int,
                             transport: str = "local") -> None:
        """``kv_migrate_bytes_total{direction, transport}``: ``http`` marks
        the bytes that crossed the cross-pod fabric's wire."""

        if self.metrics is not None and nbytes:
            self.metrics.inc("kv_migrate_bytes_total", float(nbytes), direction=direction,
                             transport=transport)

    def load_components(self) -> Dict[str, float]:
        """Block pressure split by phase: ``prefill`` the queued block
        demand, ``decode`` the blocks live in the arena, each over the
        usable blocks.  The disaggregated router picks the prefill replica
        by the first and the decode replica by the second."""

        with self._lock:
            queued = self._queued_blocks()
        usable = max(1, self.alloc.usable)
        return {"prefill": queued / usable, "decode": self.alloc.in_use / usable}

    # -- admission ---------------------------------------------------------

    def _commit_blocks(self, p_len: int, budget: int) -> int:
        """Blocks admission commits for a request: the prompt's blocks
        plus one decode block under lazy reservation (capped at the
        worst case); the full prompt + budget in "worst-case" mode."""

        bs = self.block_size
        full = blocks_for(p_len + budget, bs)
        if self.reserve != "lazy":
            return full
        # the first window's coverage rides along (equal to the +1
        # decode block whenever K <= block_size): a seat that could not
        # run one window would only be parked again
        first = blocks_for(
            min(p_len + self.steps_per_sync, max(p_len + budget - 1, 1)),
            bs,
        )
        return min(max(blocks_for(p_len, bs) + 1, first), full)

    def _plan_admission(self, req: _Request):
        """Reserve the request's commit blocks (caller holds the lock):
        the longest cached prefix is retained first, fresh blocks cover
        the rest of the commit, taken under pressure by
        ``_alloc_blocks_locked`` with the right to preempt lower tiers
        only.  None when the arena cannot give them."""

        bs = self.block_size
        p_len = req.prompt.size
        keys = chain_keys(req.prompt, bs)
        shared: List[int] = []
        # the last prompt token always re-runs: usable prefix stops at
        # the last full block strictly before it
        for key in keys[: (p_len - 1) // bs]:
            bid = self.prefix.peek(key)
            if bid is None:
                break
            shared.append(int(bid))
        if shared:
            self.alloc.retain(shared)
        if self.fabric is not None:
            # the chain's missing tail through the fabric, after the local
            # retain, so that a pressured allocation inside the pull never
            # reclaims a local hit of this plan
            self._migrate_in_locked(req, keys, shared, p_len)
        total = max(self._commit_blocks(p_len, req.budget), len(shared))
        new = self._alloc_blocks_locked(
            total - len(shared), max_victim_rank=_TIER_RANK[req.tier] - 1,
        )
        if new is None:
            if shared:
                self.alloc.release(shared)
            return None
        row = np.full((self.max_blocks,), SCRATCH_BLOCK, np.int32)
        row[: len(shared)] = shared
        row[len(shared) : total] = new
        plan = {"shared": shared, "new": new, "keys": keys, "row": row,
                "draft_new": [], "drow": None}
        if self._spec_req(req):
            # the draft twin: the same commit, all fresh (its KV depends
            # on the draft's weights, so it is never prefix-shared)
            dneed = self._commit_blocks(p_len, req.budget)
            draft_new = self._alloc_blocks_locked(
                dneed, max_victim_rank=_TIER_RANK[req.tier] - 1,
            )
            if draft_new is None:
                self.alloc.release(shared + new)
                return None
            plan["draft_new"] = draft_new
            plan["drow"] = np.full((self.max_blocks,), SCRATCH_BLOCK, np.int32)
            plan["drow"][:dneed] = draft_new
        return plan

    def _release_plan(self, plan) -> None:
        refs = [b for key in ("shared", "new", "extra", "draft_new", "draft_extra")
                for b in plan.get(key, [])]
        if refs:
            self.alloc.release(refs)

    # -- SLO-tier scheduling and preemption --------------------------------

    def _effective_rank(self, req: _Request, now: float) -> int:
        """Admission-order rank: the request's tier, with the bounded
        anti-starvation boost (a batch request queued longer than
        ``age_boost_seconds`` orders like an interactive one; the boost
        grants no preemption rights)."""

        rank = _TIER_RANK[req.tier]
        if rank == 0 and now - req.t_submit_mono >= self.age_boost_seconds:
            rank = _TIER_RANK["interactive"]
        return rank

    def _queue_sort_key(self, req: _Request, now: float):
        """Highest effective rank first, submit order within a rank."""

        return (-self._effective_rank(req, now), req.t_submit_mono, req.rid)

    def _pick_queued_locked(self) -> int:
        now = time.monotonic()
        return min(
            range(len(self._queue)),
            key=lambda i: self._queue_sort_key(self._queue[i], now),
        )

    def _pick_victim_locked(self, max_rank: int,
                            exclude_slot: Optional[int] = None) -> Optional[int]:
        """Among active seats of tier rank <= ``max_rank`` that have
        decoded since seating (the anti-livelock guard) and whose
        preemption would free blocks the swap arena can take: the
        lowest tier, then the most blocks, then the least progress.
        A slot, or None."""

        cands = []
        for slot, r in self._active.items():
            if slot == exclude_slot or _TIER_RANK[r.tier] > max_rank \
                    or r.tokens_since_seat <= 0:
                continue
            refs = self._seat_refs.get(slot, [])
            private = sum(1 for b in refs if self.alloc.refcount(b) == 1)
            dprivate = len(self._draft_refs.get(slot, []))
            if private == 0 or not self.swap.admit(private + dprivate):
                continue
            cands.append((slot, r, len(refs) + dprivate))
        if not cands:
            return None
        return min(
            cands, key=lambda c: (_TIER_RANK[c[1].tier], -c[2], len(c[1].tokens), c[0]),
        )[0]

    def _alloc_blocks_locked(self, n: int, *, max_victim_rank: int,
                             exclude_slot: Optional[int] = None,
                             exclude_rid: Optional[int] = None):
        """``n`` fresh blocks under pressure: allocation, then LRU
        eviction of unmapped prefix-cache entries, then preemption of an
        eligible seat (tier rank <= ``max_victim_rank``), then demotion
        of a queued preempted request's live blocks.  Each round moves
        real block claims, so the loop ends.  None when nothing is left
        to evict, preempt or demote for this caller's tier."""

        ids = self.alloc.alloc(n)
        while ids is None:
            if self.prefix.evict_lru(need=n - self.alloc.free_count) == 0:
                victim = self._pick_victim_locked(max_victim_rank, exclude_slot)
                if victim is not None:
                    self._preempt_seat_locked(victim, "pressure")
                elif not self._demote_queued_locked(max_victim_rank, exclude_rid):
                    return None
            ids = self.alloc.alloc(n)
        return ids

    def _demote_queued_locked(self, max_rank: int,
                              exclude_rid: Optional[int]) -> bool:
        """The deadlock breaker for swap-exempt pins: a preempted queued
        request keeps references on its prefix-published blocks, which
        the cache cannot evict while they are above refcount 1, so a
        pool with no seat to preempt could wedge.  Copy the live blocks
        of the lowest-priority such request into its swap record and
        release them (cache-only blocks become evictable).  True when a
        demotion happened."""

        now = time.monotonic()
        cands = []
        for q in self._queue:
            if not q.swapped or q.rid == exclude_rid or _TIER_RANK[q.tier] > max_rank:
                continue
            rec = self.swap.peek(q.rid)
            if rec is None:
                continue
            n_live = len(rec["live"]) + len(rec["draft_live"])
            if not n_live or not self.swap.admit(n_live):
                continue
            cands.append(q)
        if not cands:
            return False
        q = max(cands, key=lambda r: self._queue_sort_key(r, now))
        rec = self.swap.peek(q.rid)
        live, dlive = rec["live"], rec["draft_live"]
        added = dadded = None
        with self._request_span(q, "swap_out", blocks=len(live) + len(dlive),
                                reason="demote"):
            with self.dispatch("swap_out", rid=q.rid, blocks=len(live) + len(dlive)):
                if live:
                    added = self._swap_out([b for _, b in live])
                if dlive:
                    # a parked speculating seat's draft blocks pin the
                    # arena as its target blocks do
                    dadded = self._swap_out(dlive, self._draft_arena)
        merged = {"live": [], "blocks": rec["blocks"] + [i for i, _ in live],
                  "host": _cat_host(rec["host"], added), "draft_live": [],
                  "draft_n": rec["draft_n"] + len(dlive),
                  "draft_host": _cat_host(rec["draft_host"], dadded)}
        nbytes = _nbytes(added) + _nbytes(dadded)
        self.swap.pop(q.rid)
        self.swap.put(q.rid, merged, n_blocks=rec["n_blocks"] + len(live) + len(dlive),
                      nbytes=nbytes)
        self.alloc.release([b for _, b in live] + list(dlive))
        self._count_swap_bytes("out", nbytes)
        self.request_log.add_swap(q.entry, len(live) + len(dlive))
        self.request_log.count_dispatch(q.entry, "swap_out")
        return True

    # -- swap copies -------------------------------------------------------

    def _swap_mark(self):
        ev = None
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        return time.perf_counter(), ev

    def _log_swap(self, direction: str, blocks: int, nbytes: int, mark) -> None:
        t0, ev0 = mark
        ev1 = None
        if ev0 is not None:
            ev1 = torch.cuda.Event(enable_timing=True)
            ev1.record()
        log = self.migrate_log if direction.startswith("migrate") else self.swap_log
        log.append({
            "direction": direction, "blocks": blocks, "bytes": nbytes,
            "host_s": time.perf_counter() - t0,
            "events": None if ev0 is None else (ev0, ev1),
        })

    def _swap_out(self, ids: List[int], arena=None, direction: str = "out") -> torch.Tensor:
        """Rows ``ids`` of every layer's K and V of ``arena`` (default:
        the target's) as one host tensor [layers, 2, n, Hkv, bs, D]:
        gathered on the device, then one synchronous device->host copy
        (pinned on CUDA), so the record is complete when this returns.
        ``direction`` files the copy's record (``migrate_out``: a fabric
        publish's)."""

        arena = self._arena if arena is None else arena
        mark = self._swap_mark()
        idx = torch.as_tensor(ids, dtype=torch.long, device=self.device)
        k0 = arena[0][0]
        shape = (len(arena), 2, len(ids)) + tuple(k0.shape[1:])
        buf = torch.empty(shape, dtype=k0.dtype, device=self.device)
        for i, pair in enumerate(arena):
            for j, a in enumerate(pair):
                torch.index_select(a, 0, idx, out=buf[i, j])
        host = buf
        if self.device.type == "cuda":
            host = torch.empty(shape, dtype=k0.dtype, pin_memory=True)
            host.copy_(buf)
        self._log_swap(direction, len(ids), _nbytes(host), mark)
        return host

    def _swap_in(self, host: torch.Tensor, ids: List[int], arena=None,
                 direction: str = "in") -> None:
        """Write a record's host rows into rows ``ids`` of ``arena``
        (default: the target's): one synchronous host->device copy (the
        record may go once this returns), then a scatter per layer's K
        and V.  ``direction`` files the copy's record (``migrate_in``: a
        fabric pull's)."""

        arena = self._arena if arena is None else arena
        mark = self._swap_mark()
        idx = torch.as_tensor(ids, dtype=torch.long, device=self.device)
        dev = host.to(self.device)
        for i, pair in enumerate(arena):
            for j, a in enumerate(pair):
                a.index_copy_(0, idx, dev[i, j])
        self._log_swap(direction, len(ids), _nbytes(host), mark)

    # -- KV-block migration over the prefix-cache fabric --------------------

    def _fabric_host(self, kvs) -> torch.Tensor:
        """Fabric records' host forms (``fabric_service.host_block``) as
        one host tensor [layers, 2, n, Hkv, bs, D] in the arena's dtype,
        the layout ``_swap_in`` uploads."""

        first = kvs[0][0][0]
        buf = np.empty((len(kvs[0]), 2, len(kvs)) + first.shape[1:], first.dtype)
        for b, kv in enumerate(kvs):
            for i, pair in enumerate(kv):
                for j in (0, 1):
                    buf[i, j, b] = pair[j][0]
        if buf.dtype == np.uint16:  # a bf16 block's words
            return torch.from_numpy(buf.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(buf)

    def _migrate_in_locked(self, req: _Request, keys, shared: List[int], p_len: int) -> None:
        """Pull the chain's missing tail from the fabric (caller holds the
        lock; ``shared`` holds the retained local hits and is extended in
        place).  The records stay pinned from lookup to upload; the pulled
        blocks are uploaded into fresh ids in one ``migrate_in`` dispatch,
        published in the local prefix cache (its reference becomes the
        cache's) and retained once more for the seat: from then on they
        are local hits.  A shortfall of blocks skips the pull, and the
        admission recomputes those positions, as it does when a prefill
        replica died mid-publish."""

        limit = (p_len - 1) // self.block_size
        fetch = []  # (key, record), chain-consecutive
        for i in range(len(shared), limit):
            if self.prefix.peek(keys[i]) is not None:
                # the local cache still holds this link (an evicted head
                # with a live tail): pulling it would put over the live
                # entry and leak its block; the remainder recomputes
                break
            rec = self.fabric.get(keys[i], pin=True)
            if rec is None:
                break
            fetch.append((keys[i], rec))
        if limit > len(shared):
            # per request, only where something could have been pulled
            self.fabric.record(bool(fetch))
        if not fetch:
            return
        ids = self._alloc_blocks_locked(len(fetch),
                                        max_victim_rank=_TIER_RANK[req.tier] - 1)
        if ids is None:
            for key, _ in fetch:
                self.fabric.unpin(key)
            return
        n = len(fetch)
        nbytes = sum(rec["nbytes"] for _, rec in fetch)
        with self._request_span(req, "migrate", blocks=n, bytes=nbytes):
            with self.dispatch("migrate_in", rid=req.rid, blocks=n):
                self._swap_in(self._fabric_host([rec["kv"] for _, rec in fetch]), ids,
                              direction="migrate_in")
        for (key, _), bid in zip(fetch, ids):
            self.prefix.put(key, int(bid))  # the cache owns the allocation
            self.alloc.retain([int(bid)])  # and the seat one more
            shared.append(int(bid))
            self.fabric.unpin(key)
        pulled = [rec for _, rec in fetch if rec.get("transport") == "http"]
        nbytes_http = sum(rec["nbytes"] for rec in pulled)
        self._count_migrate_bytes("in", nbytes - nbytes_http)
        if pulled:
            self._count_migrate_bytes("in", nbytes_http, transport="http")
        self.request_log.add_migrate(req.entry, n)
        self.request_log.count_dispatch(req.entry, "migrate_in")
        if pulled:
            self.request_log.update(req.entry, fabric_peer=pulled[0].get("peer", ""),
                                    pulled_blocks=len(pulled))

    def publish_to_fabric(self, prompt_ids, *, tier: str = "batch",
                          trace_id: Optional[str] = None,
                          timeout: Optional[float] = None) -> Dict[str, int]:
        """The prefill replica's half of the migration: make every full
        block of ``prompt_ids`` available in the fabric.  Blocks the
        fabric holds cost nothing; for the rest an internal budget-1
        request prefills the prompt through the normal admission
        (publishing the full blocks in the local prefix cache and retiring
        at once; its throwaway sample is greedy, so no generator is
        consumed), then one ``migrate_out`` dispatch gathers the blocks to
        the host and into the fabric.  Blocks until the internal prefill
        completes (a driver thread must be stepping this pool); raises
        TimeoutError past ``timeout``.  Returns {"publishable",
        "published", "computed"}."""

        if self.fabric is None:
            raise ValueError("this replica has no prefix-cache fabric to publish into")
        from tf_operator_tpu_torch.models.fabric_service import block_nbytes, host_block

        prompt = np.array(prompt_ids, np.int32).reshape(-1)
        n_pub = int(prompt.size) // self.block_size
        out = {"publishable": n_pub, "published": 0, "computed": 0}
        if n_pub == 0:
            return out
        keys = chain_keys(prompt, self.block_size)[:n_pub]
        missing = [k for k in keys if k not in self.fabric]
        self.fabric.record(hit=not missing)
        if not missing:
            return out
        with self._lock:
            have_local = all(self.prefix.peek(k) is not None for k in missing)
        if not have_local:
            rid = self.submit(prompt, 1, tier=tier, trace_id=trace_id, internal=True)
            if self.result_wait(rid, timeout=timeout) is None:
                raise TimeoutError(
                    f"fabric publish prefill timed out after {timeout}s "
                    "(is this replica's driver thread running?)"
                )
            out["computed"] = 1
        with self._lock:
            publish = []
            for k in missing:
                if k in self.fabric:
                    continue  # a concurrent publisher won the race
                bid = self.prefix.peek(k)
                if bid is None:
                    # evicted since the admission: publish what survives;
                    # the decode side recomputes the rest
                    continue
                publish.append((k, int(bid)))
            if not publish:
                return out
            bids = [b for _, b in publish]
            # pinned against reclaim for the gather
            self.alloc.retain(bids)
            try:
                with self.dispatch("migrate_out", blocks=len(bids)):
                    host = self._swap_out(bids, direction="migrate_out")
            finally:
                self.alloc.release(bids)
            nbytes_total = 0
            for j, (k, _) in enumerate(publish):
                kv = host_block([(host[i, 0, j : j + 1], host[i, 1, j : j + 1])
                                 for i in range(host.shape[0])])
                nb = block_nbytes(kv)
                self.fabric.put(k, kv, nb)
                nbytes_total += nb
            out["published"] = len(publish)
            self._count_migrate_bytes("out", nbytes_total)
        return out

    # -- preemption and resume ---------------------------------------------

    def _preempt_seat_locked(self, slot: int, reason: str) -> int:
        """Evict seat ``slot`` mid-decode (caller holds the lock): its
        private blocks go to the host swap arena and are freed, its
        prefix-shared blocks stay live (swap-exempt); when the swap
        arena refuses, nothing is copied or freed and the request just
        leaves its seat.  The device row resets before any block is
        released; the request re-queues.  ``reason`` ("pressure": a
        victim; "park": a grower that cannot be fed) tags its spans.
        Returns the blocks freed."""

        req = self._active.pop(slot)
        refs = self._seat_refs.pop(slot)
        drefs = self._draft_refs.pop(slot, [])
        req.slot = None
        exempt = [(i, b) for i, b in enumerate(refs) if self.alloc.refcount(b) > 1]
        private = [(i, b) for i, b in enumerate(refs) if self.alloc.refcount(b) == 1]
        # a speculating seat's draft blocks (all private) go with its
        # target blocks, so that it resumes without a draft re-prefill
        if (private or drefs) and not self.swap.admit(len(private) + len(drefs)):
            live, copied, dlive, dcopied = exempt + private, [], list(drefs), []
        else:
            live, copied, dlive, dcopied = exempt, private, [], list(drefs)
        host = dhost = None
        n_copied = len(copied) + len(dcopied)
        if n_copied:
            with self._request_span(req, "swap_out", slot=slot, blocks=n_copied,
                                    reason=reason):
                with self.dispatch("swap_out", rid=req.rid, blocks=n_copied):
                    if copied:
                        host = self._swap_out([b for _, b in copied])
                    if dcopied:
                        dhost = self._swap_out(dcopied, self._draft_arena)
            self.request_log.count_dispatch(req.entry, "swap_out")
        self._retire_device_locked([slot], [req])
        freed = self.alloc.release([b for _, b in copied] + dcopied) if n_copied else 0
        nbytes = _nbytes(host) + _nbytes(dhost)
        self.swap.put(
            req.rid, {"live": live, "blocks": [i for i, _ in copied], "host": host,
                      "draft_live": dlive, "draft_n": len(dcopied), "draft_host": dhost},
            n_blocks=n_copied, nbytes=nbytes,
        )
        req.swapped = True
        req.tokens_since_seat = 0
        now = time.monotonic()
        self._emit_span(req, "preempt", now, now, reason=reason, tier=req.tier,
                        blocks_swapped=n_copied, blocks_live=len(live) + len(dlive))
        self.request_log.count_preempt(req.entry, swapped_blocks=n_copied)
        self.preemptions += 1
        if self.metrics is not None:
            self.metrics.inc("serve_preemptions_total", tier=req.tier,
                             model=self.model_label, replica=self.replica)
        self._count_swap_bytes("out", nbytes)
        self._queue.append(req)
        return freed

    def _plan_resume_locked(self, req: _Request):
        """Blocks for re-admitting a preempted request: replacements for
        its swapped blocks plus the first window's coverage (a seat that
        could not run one window would only be parked again).  Like a
        fresh admission it may preempt lower tiers; it never demotes
        itself."""

        rec = self.swap.peek(req.rid)
        if rec is None:
            raise BlockError(
                f"request {req.rid} is marked swapped but has no SwapArena "
                "record — its KV cannot be restored"
            )
        n_up, n_up_d = len(rec["blocks"]), rec["draft_n"]
        committed = len(rec["live"]) + n_up
        length = req.prompt.size + len(req.tokens) - 1
        cap = max(req.prompt.size + req.budget - 1, 1)
        spec = self._spec_req(req)
        adv = self.spec_k + 1 if spec else self.steps_per_sync
        target = blocks_for(min(length + adv, cap), self.block_size)
        extra = max(0, target - committed)
        dextra = max(0, target - len(rec["draft_live"]) - n_up_d) if spec else 0
        ids = self._alloc_blocks_locked(
            n_up + extra + n_up_d + dextra, max_victim_rank=_TIER_RANK[req.tier] - 1,
            exclude_rid=req.rid,
        )
        if ids is None:
            return None
        b, c = n_up + extra, n_up + extra + n_up_d
        return {"rec": rec, "new": ids[:n_up], "extra": ids[n_up:b],
                "draft_new": ids[b:c], "draft_extra": ids[c:]}

    def _seat_device_row(self, slot: int, row: np.ndarray, length: int,
                         req: _Request, tok) -> None:
        self._tables_dev[slot] = torch.as_tensor(row, device=self.device)
        self._lengths_dev[slot] = length
        self._temps_dev[slot] = req.temperature
        self._topks_dev[slot] = req.top_k or 0
        self._last_tok[slot] = tok

    def _admit_swapped(self, req: _Request, slot: int, plan) -> None:
        """Resume a preempted request at ``slot`` (caller holds the
        lock): upload its host blocks into the fresh ids, re-map its
        live blocks copy-free, and write the seat's table row, length,
        sampling parameters and last token."""

        rec, new, extra = plan["rec"], plan["new"], plan["extra"]
        committed = len(rec["live"]) + len(new)
        row = np.full((self.max_blocks,), SCRATCH_BLOCK, np.int32)
        refs: List[int] = [SCRATCH_BLOCK] * committed
        for i, bid in rec["live"]:
            row[i] = refs[i] = bid
        for j, i in enumerate(rec["blocks"]):
            row[i] = refs[i] = new[j]
        row[committed : committed + len(extra)] = extra
        refs.extend(extra)
        # the draft twin: live blocks re-map, swapped ones upload into
        # fresh ids, at the same shared length as the target, so the
        # next draft window continues as if nothing had happened
        spec = self._spec_req(req)
        dnew, dlive = plan["draft_new"], rec["draft_live"]
        drefs = list(dlive) + list(dnew) + list(plan["draft_extra"])
        with self._request_span(req, "swap_in", slot=slot,
                                blocks_uploaded=len(new) + len(dnew),
                                blocks_live=len(rec["live"]) + len(dlive)):
            with self.dispatch("swap_in", rid=req.rid, blocks=len(new) + len(dnew)):
                if new:
                    self._swap_in(rec["host"], new)
                if dnew:
                    self._swap_in(rec["draft_host"], dnew, self._draft_arena)
                self._seat_device_row(slot, row, req.prompt.size + len(req.tokens) - 1,
                                      req, req.tokens[-1])
                if spec:
                    drow = np.full((self.max_blocks,), SCRATCH_BLOCK, np.int32)
                    drow[: len(drefs)] = drefs
                    self._draft_tables_dev[slot] = torch.as_tensor(drow, device=self.device)
        nbytes = _nbytes(rec["host"]) + _nbytes(rec["draft_host"])
        self.swap.pop(req.rid, nbytes)
        req.swapped = False
        req.slot = slot
        req.tokens_since_seat = 0
        self._active[slot] = req
        self._seat_refs[slot] = refs
        if spec:
            self._draft_refs[slot] = drefs
        if req.generator is not None:
            self._generators[slot] = req.generator
        self._count_swap_bytes("in", nbytes)
        self.request_log.count_dispatch(req.entry, "swap_in")
        self.request_log.update(req.entry, state="active", slot=slot)

    @torch.inference_mode()
    def _admit(self) -> None:
        """Seat queued requests, resumed and fresh, in priority order
        while a seat and the top request's blocks can be had (the top
        request gates the queue; its plan may preempt lower tiers)."""

        while True:
            with self._lock:
                if not self._queue or len(self._active) == self.slots:
                    return
                idx = self._pick_queued_locked()
                req = self._queue[idx]
                if req.swapped:
                    plan = self._plan_resume_locked(req)
                else:
                    plan = self._plan_admission(req)
                if plan is None:
                    self._update_gauges_locked()
                    return
                self._queue.pop(idx)
                # planning may itself have preempted seats
                slot = min(s for s in range(self.slots) if s not in self._active)
                try:
                    if req.swapped:
                        self._admit_swapped(req, slot, plan)
                    else:
                        self._admit_paged(req, slot, plan)
                    self._update_gauges_locked()
                except BaseException:
                    # the request survives a failed admission: its plan
                    # is rolled back and it goes to the queue's head
                    self._release_plan(plan)
                    self._queue.insert(0, req)
                    raise

    @torch.inference_mode()
    def _admit_paged(self, req: _Request, slot: int, plan) -> None:
        bs = self.block_size
        p_len = req.prompt.size
        n_shared = len(plan["shared"])
        prefix_len = n_shared * bs
        remainder = p_len - prefix_len
        n_fresh = blocks_for(remainder, bs)  # ceil: the straddle block too
        blocks_reserved = len(plan["shared"]) + len(plan["new"])
        work_start = time.perf_counter()
        self._emit_queue_wait(req)
        with self._request_span(req, "admission", width=remainder, slot=slot,
                                blocks_reserved=blocks_reserved,
                                prefix_hit_tokens=prefix_len,
                                prefix_hit_blocks=n_shared):
            with self.dispatch("admission", rid=req.rid, width=remainder,
                               prefix_tokens=prefix_len):
                row = torch.as_tensor(plan["row"], device=self.device)
                view = gather_block_view(self._arena, row[: n_shared + n_fresh],
                                         prefix_len)
                ids = torch.as_tensor(req.prompt[prefix_len:], device=self.device)[None]
                logits = self.dmodel(ids, cache=view)
                tok = _admission_sample(logits[0, -1], req.temperature, req.top_k,
                                        req.generator)
                scatter_block_view(self._arena, view, row, n_shared, n_fresh)
                self._seat_device_row(slot, row, p_len, req, tok)
                tok_h = int(tok)  # the admission's one host fetch, in its dispatch
        req.tokens.append(tok_h)
        self.prefix.record(prefix_len > 0)
        # publish every full prompt block (final content: decode writes
        # start at p_len) under its chain key; the cache holds a ref
        for i in range(p_len // bs):
            key = plan["keys"][i]
            if key not in self.prefix:
                bid = int(plan["row"][i])
                self.alloc.retain([bid])
                self.prefix.put(key, bid)
        self.request_log.count_dispatch(req.entry, "admission")
        self.request_log.update(
            req.entry, state="active", slot=slot,
            admission={
                "width": int(remainder),
                "blocks_reserved": blocks_reserved,
                "prefix_hit_tokens": int(prefix_len),
                "prefix_hit_blocks": n_shared,
                "prefill_dispatches": 0,
                "seconds": round(time.perf_counter() - work_start, 6),
            },
        )
        self._observe_first_token(req, work_start)
        refs = plan["shared"] + plan["new"]
        if len(req.tokens) >= req.budget:
            # budget 1: done at admission.  Its blocks go straight back,
            # so the freshly written device row must be reset first; the
            # draft prefill never runs (nothing is left to speculate on)
            self._retire_device_locked([slot], [req])
            self._finish_locked(req, self.alloc.release(refs + plan["draft_new"]))
            return
        if self._spec_req(req):
            self._draft_prefill_seat(req, slot, plan)
            self._draft_refs[slot] = list(plan["draft_new"])
        req.slot = slot
        req.tokens_since_seat = 0
        self._active[slot] = req
        self._seat_refs[slot] = refs
        if req.generator is not None:
            self._generators[slot] = req.generator

    def _draft_prefill_seat(self, req: _Request, slot: int, plan) -> None:
        """One ``draft`` dispatch: the full prompt through the draft at
        offset 0 into the plan's fresh draft blocks, and the seat's draft
        table row.  The draft never maps a cached prefix (its KV depends on
        its own weights), so a prefix-hit admission pays it too."""

        p_len = req.prompt.size
        n = blocks_for(p_len, self.block_size)
        with self._request_span(req, "draft", width=p_len, slot=slot,
                                blocks=len(plan["draft_new"])):
            with self.dispatch("draft", rid=req.rid, width=p_len):
                row = torch.as_tensor(plan["drow"], device=self.device)
                view = gather_block_view(self._draft_arena, row[:n], 0)
                ids = torch.as_tensor(req.prompt, device=self.device)[None]
                self._draft_dmodel(ids, cache=view)
                scatter_block_view(self._draft_arena, view, row, 0, n)
                self._draft_tables_dev[slot] = row
        self.request_log.count_dispatch(req.entry, "draft")

    # -- decode ------------------------------------------------------------

    def _retire_device_locked(self, slots: List[int], reqs: List[_Request]) -> None:
        """Reset the seats' device rows in one batch: table rows back to
        scratch, lengths/temps/top-ks to zero.  Required before their
        freed blocks re-allocate, or a dead seat's appends would land in
        the new owner's blocks.  ``reqs`` (the seats' requests) each
        count the dispatch in their autopsy."""

        with self.dispatch("retire", slots=len(slots)):
            idx = torch.as_tensor(slots, dtype=torch.long, device=self.device)
            self._tables_dev[idx] = SCRATCH_BLOCK
            self._lengths_dev[idx] = 0
            self._temps_dev[idx] = 0.0
            self._topks_dev[idx] = 0
            if self.spec_enabled:
                # freed draft blocks re-allocate as soon as target ones
                self._draft_tables_dev[idx] = SCRATCH_BLOCK
        for s in slots:
            self._generators.pop(s, None)
        for req in reqs:
            self.request_log.count_dispatch(req.entry, "retire")

    def _grow_seats_locked(self):
        """Lazy growth before a window (caller holds the lock): every
        active seat, in priority order, gets the blocks its next window
        will append into (capped at its budget's last cached position):
        ``steps_per_sync`` positions, or ``spec_k + 1`` for a speculating
        seat, whose target and draft rows both grow.  On shortfall the
        tier policy preempts a seat of the grower's tier or lower; a
        grower that still cannot be fed leaves its seat (swapped, or
        parked without a copy) rather than append into scratch.  Returns
        the [slots, G] host arrays of logical indices and physical ids to
        write into the target's tables and the draft's (None without a
        draft); unused entries index past the table."""

        G = self._step_nbw
        gl = np.full((self.slots, G), self.max_blocks, np.int32)
        gp = np.full((self.slots, G), SCRATCH_BLOCK, np.int32)
        gld = gl.copy() if self.spec_enabled else None
        gpd = gp.copy() if self.spec_enabled else None
        now = time.monotonic()
        order = sorted(self._active.items(),
                       key=lambda kv: self._queue_sort_key(kv[1], now))
        for slot, req in order:
            if slot not in self._active:
                continue  # preempted as an earlier grower's victim
            spec = self._spec_req(req)
            length = req.prompt.size + len(req.tokens) - 1
            cap = max(req.prompt.size + req.budget - 1, 1)
            adv = self.spec_k + 1 if spec else self.steps_per_sync
            target = blocks_for(min(length + adv, cap), self.block_size)
            if not self._grow_row(slot, req, self._seat_refs[slot], target, gl, gp):
                continue
            if spec:
                self._grow_row(slot, req, self._draft_refs[slot], target, gld, gpd)
        # a seat preempted after its growth was staged must not write
        # freed (possibly re-owned) ids into its dead table rows
        for s in range(self.slots):
            if s not in self._active:
                gl[s] = self.max_blocks
                gp[s] = SCRATCH_BLOCK
                if gld is not None:
                    gld[s] = self.max_blocks
                    gpd[s] = SCRATCH_BLOCK
        return gl, gp, gld, gpd

    def _grow_row(self, slot: int, req: _Request, refs: List[int], target: int,
                  gl: np.ndarray, gp: np.ndarray) -> bool:
        """Stage one table row's growth to ``target`` blocks (``refs`` is
        its list of physical ids, extended in place).  False when the
        blocks cannot be had and the seat was parked instead."""

        committed = len(refs)
        delta = target - committed
        if delta <= 0:
            return True
        ids = self._alloc_blocks_locked(
            delta, max_victim_rank=_TIER_RANK[req.tier], exclude_slot=slot,
        )
        if ids is None:
            self._preempt_seat_locked(slot, "park")
            return False
        gl[slot, :delta] = np.arange(committed, committed + delta, dtype=np.int32)
        gp[slot, :delta] = ids
        refs.extend(ids)
        return True

    def _write_growth(self, gl: np.ndarray, gp: np.ndarray, gld: Optional[np.ndarray],
                      gpd: Optional[np.ndarray]) -> None:
        """A window's growth into the device tables, one write a table
        (one upload of (slot, index, id) triples), before the window
        reads them."""

        for lo, ph, tables in ((gl, gp, self._tables_dev),
                               (gld, gpd, self._draft_tables_dev)):
            if lo is None:
                continue
            rows, cols = np.nonzero(lo < self.max_blocks)
            if rows.size == 0:
                continue
            triples = np.stack([rows, lo[rows, cols], ph[rows, cols]]).astype(np.int64)
            t = torch.as_tensor(triples, device=self.device)
            tables[t[0], t[1]] = t[2].to(torch.int32)

    @torch.inference_mode()
    def step(self) -> int:
        """Admit, grow the active seats' tables, run one window for them
        (the plain seats' ``steps_per_sync`` decode steps, the
        speculating seats' draft and verify), retire the finished ones.
        Returns the number of seats still active."""

        self._admit()
        with self._lock:
            if self._active:
                self._write_growth(*self._grow_seats_locked())
            if not self._active:
                # the gauges refresh while only queueing too: a burst the
                # arena cannot admit still ramps kv_blocks_pressure
                self._update_gauges_locked()
                return 0
            seats_active = len(self._active)
            spec = {slot for slot, req in self._active.items() if self._spec_req(req)}
            plain = [slot for slot in self._active if slot not in spec]
            t_window0 = time.monotonic()
            host = self._plain_window(plain) if plain else None
            win = self._spec_window(sorted(spec)) if spec else None
            t_window1 = time.monotonic()
            self._observe_window(t_window0, t_window1)
            finished = []
            for slot in sorted(self._active):
                req = self._active[slot]
                if slot in spec:
                    # verify rewound the length to L + accepted + 1; the
                    # host hands out the accepted tokens and the correction
                    n_tok = int(win[slot, -1])
                    take = min(n_tok, req.budget - len(req.tokens))
                    req.tokens.extend(int(t) for t in win[slot, :take])
                    self._count_spec(req, n_tok - 1, take)
                else:
                    take = min(len(host), req.budget - len(req.tokens))
                    req.tokens.extend(int(t) for t in host[:take, slot])
                req.tokens_since_seat += take
                self._emit_span(req, "decode.window", t_window0, t_window1,
                                tokens=take, seats_active=seats_active)
                # a speculative window counts as a step in the autopsy,
                # as in the JAX pool
                self.request_log.add_window(req.entry, take)
                if len(req.tokens) >= req.budget:
                    finished.append(slot)
            if finished:
                # device rows first, then the blocks (see _retire_device_locked)
                reqs = [self._active.pop(slot) for slot in finished]
                self._retire_device_locked(finished, reqs)
                for slot, req in zip(finished, reqs):
                    refs = self._seat_refs.pop(slot) + self._draft_refs.pop(slot, [])
                    self._finish_locked(req, self.alloc.release(refs))
            self._update_gauges_locked()
            return len(self._active)

    def _plain_window(self, slots: List[int]) -> np.ndarray:
        """One ``step`` dispatch: ``steps_per_sync`` decode steps for the
        seats ``slots`` (the others read and write scratch only and keep
        their lengths, tokens and generators).  Returns the window's
        tokens [K, S] (one fetch)."""

        enabled = self._seat_mask(slots)
        tables = torch.where(enabled[:, None], self._tables_dev, SCRATCH_BLOCK)
        cache = PagedCache(self._arena, tables, self._lengths_dev)
        gens = {s: self._generators[s] for s in slots if s in self._generators}
        toks = self._last_tok
        window = []
        with self.dispatch("step", active=len(slots)):
            for _ in range(self.steps_per_sync):
                logits = self.pmodel(toks[:, None], cache=cache)
                toks = _step_sample(logits[:, 0], self._temps_dev, self._topks_dev, gens)
                window.append(toks)
            host = torch.stack(window).cpu().numpy()  # [K, S]: one fetch
        self._lengths_dev = torch.where(enabled, cache.lengths, self._lengths_dev)
        self._last_tok = torch.where(enabled, toks, self._last_tok)
        return host

    def _spec_window(self, slots: List[int]) -> np.ndarray:
        """The speculating seats' window: one ``draft`` dispatch (spec_k +
        1 draft steps over the shared lengths; the last step's token is
        discarded, its KV append is what counts) and one ``verify``
        dispatch (one target pass over ``[x0, d1..dK]``, acceptance, the
        correction and the lengths' rewind to L + accepted + 1).  The
        other seats read and write scratch only.  Returns [S, K + 2]:
        each seat's accepted tokens and correction (zero past them), then
        their count, from the window's one fetch."""

        K = self.spec_k
        spec = self._seat_mask(slots)
        gens = {s: self._generators[s] for s in slots if s in self._generators}
        launched = _build.launches[_pa.KERNEL] + _build.launches[_qm.KERNEL]
        with self.dispatch("draft", active=len(slots)):
            tables = torch.where(spec[:, None], self._draft_tables_dev, SCRATCH_BLOCK)
            cache = PagedCache(self._draft_arena, tables, self._lengths_dev)
            toks = self._last_tok
            d_toks, d_q = [], []
            for i in range(K + 1):
                logits = self._draft_pmodel(toks[:, None], cache=cache)[:, 0]
                if i == K:
                    break
                toks, q = _spec_sample_with_dist(logits, self._temps_dev, self._topks_dev,
                                                 gens)
                d_toks.append(toks)
                d_q.append(q)
            drafts = torch.stack(d_toks, dim=1)  # [S, K]
            q = torch.stack(d_q, dim=1) if gens else None  # [S, K, V]
        with self.dispatch("verify", active=len(slots)):
            tables = torch.where(spec[:, None], self._tables_dev, SCRATCH_BLOCK)
            cache = PagedCache(self._arena, tables, self._lengths_dev)
            fed = torch.cat([self._last_tok[:, None], drafts], dim=1)  # [S, K+1]
            logits = self.pmodel(fed, cache=cache)
            m, corr = _spec_accept(logits, drafts, q, self._temps_dev, self._topks_dev, gens)
            # the rewind: appends past L + m + 1 are dead by the length mask
            self._lengths_dev = torch.where(spec, self._lengths_dev + m + 1,
                                            self._lengths_dev).to(torch.int32)
            self._last_tok = torch.where(spec, corr, self._last_tok)
            idx = torch.arange(K + 1, device=self.device)[None]
            padded = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
            win = torch.where(idx == m[:, None], corr[:, None], padded)
            win = torch.where(idx <= m[:, None], win, 0)
            counts = torch.where(spec, m + 1, 0)
            host = torch.cat([win, counts[:, None]], dim=1).cpu().numpy()  # one fetch
        self.spec_launches += _build.launches[_pa.KERNEL] + _build.launches[_qm.KERNEL] \
            - launched
        self.spec_windows += 1
        return host

    def _count_spec(self, req: _Request, accepted: int, take: int) -> None:
        """The speculative counters for one seat's window, host and
        registry (``serve_spec_*_total{model, tier}``, the JAX pool's)."""

        rollback = accepted < self.spec_k
        self.spec_proposed += self.spec_k
        self.spec_accepted += accepted
        self.spec_emitted += take
        self.spec_rollbacks += int(rollback)
        if self.metrics is None:
            return
        self.metrics.inc("serve_spec_proposed_total", self.spec_k * 1.0,
                         model=self.model_label, tier=req.tier)
        self.metrics.inc("serve_spec_accepted_total", accepted * 1.0,
                         model=self.model_label, tier=req.tier)
        if rollback:
            self.metrics.inc("serve_spec_rollbacks_total", model=self.model_label,
                             tier=req.tier)
