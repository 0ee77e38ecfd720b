"""Multi-replica serving behind one admission queue (the port of
``tf_operator_tpu/models/pool_router.py``).

``serve_lm --replicas N`` runs N pool replicas, each with its own KV
arena and driver thread, over one shared model, and this router fronts
them with the submit / result surface of one pool.  Routing is least
blocks in use (``load_score()``: a paged pool's live arena occupancy plus
the queued block demand over the arena; a contiguous pool's active and
queued counts), ties to the lowest index.

Each replica carries a ``replica_label``: its SLO observations and
gauges export per replica on ``/metrics`` (``kv_blocks_free{replica=}``),
while ``/slo`` merges the replica label away
(``utils/metrics.histogram_family_merged``), so a fleet reports one
user-facing TTFT.

A fleet with a ``prefill`` replica is disaggregated: a prompt with a full
block before its last token prefills on the least prefill-loaded
prefill replica, which publishes its blocks into the shared fabric
(``publish_to_fabric``); then the request goes to the least
decode-loaded decode replica, whose admission maps the published chain
and pulls only its missing tail (``migrate_in``).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


class _NullSpan:
    """The route span of an untraced router: the call sites keep one
    shape (enter, set_attribute, set_error)."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set_attribute(self, *a, **k):
        pass

    def set_error(self, *a, **k):
        pass


_NULL_SPAN = _NullSpan()


class PoolRouter:
    """N pool replicas, one admission queue, one request-id namespace.

    ``pools`` are ``ContinuousBatchingDecoder`` /
    ``PagedContinuousBatchingDecoder`` instances.  Thread-safe: submit and
    result_wait may race the replicas' driver threads as they do one
    pool's.  With a ``tracer`` every submit emits a ``route`` span on the
    request's trace, with the chosen replica, its ``load_score``, the
    ``phase`` and the replica's ``role``; the router also merges the
    replicas' request logs and arena timelines for ``/requests`` and
    ``/debug/arena``."""

    #: ceiling on one prefill-publish handshake: a dead prefill driver
    #: degrades to the decode replica recomputing, not to a submit
    #: thread hung on result_wait forever
    PUBLISH_TIMEOUT_S = 120.0

    def __init__(self, pools: List, tracer=None, publish_timeout: Optional[float] = None):
        if not pools:
            raise ValueError("router needs at least one pool replica")
        self.pools = list(pools)
        self.tracer = tracer
        self.publish_timeout = (self.PUBLISH_TIMEOUT_S if publish_timeout is None
                                else float(publish_timeout))
        self._lock = threading.Lock()
        self._rid = 0
        #: router rid -> (pool index, pool-local rid)
        self._route: Dict[int, Tuple[int, int]] = {}
        self.prefill_idx = [i for i, p in enumerate(self.pools) if p.role == "prefill"]
        self.decode_idx = [i for i, p in enumerate(self.pools) if p.role != "prefill"]
        self.disaggregated = bool(self.prefill_idx)
        if self.disaggregated:
            if not self.decode_idx:
                raise ValueError(
                    "a disaggregated fleet needs at least one decode/unified replica — "
                    "prefill replicas never decode"
                )
            fabrics = {id(self.pools[i].fabric) for i in self.prefill_idx + self.decode_idx}
            if any(self.pools[i].fabric is None for i in self.prefill_idx) or \
                    len(fabrics) != 1:
                raise ValueError(
                    "disaggregated replicas must share ONE prefix-cache fabric (the "
                    "migration transport) — construct every replica with the same fabric="
                )

    def __len__(self) -> int:
        return len(self.pools)

    def load_scores(self) -> List[float]:
        return [p.load_score() for p in self.pools]

    def _route_span(self, tid, **attrs):
        if self.tracer is None:
            return _NULL_SPAN
        return self.tracer.start_span("route", trace_id=tid, attributes=attrs)

    def _replica_name(self, idx: int) -> str:
        return self.pools[idx].replica_label or str(idx)

    def submit(self, prompt_ids, max_new_tokens: int, **kw) -> int:
        """Route to the least-loaded replica; returns a router rid (collect
        it with this router's result / result_wait).  A disaggregated
        fleet runs the two-phase handshake (``_submit_disaggregated``),
        which blocks until the prefill replica's publish completes."""

        # the request's identity is settled here, so that the route span
        # and the replicas' lifecycle spans share one trace id
        tid = kw.get("trace_id")
        if tid is None and self.tracer is not None:
            tid = self.tracer.mint_trace_id()
            kw["trace_id"] = tid
        if self.disaggregated:
            idx, prid = self._submit_disaggregated(prompt_ids, max_new_tokens, kw)
        else:
            scores = self.load_scores()
            idx = min(range(len(self.pools)), key=lambda i: (scores[i], i))
            span = self._route_span(
                tid, replica=str(idx), load_score=round(scores[idx], 4),
                scores=[round(s, 4) for s in scores], tier=str(kw.get("tier", "batch")),
                phase="unified", role=self.pools[idx].role,
            )
            with span:
                prid = self.pools[idx].submit(prompt_ids, max_new_tokens, **kw)
                span.set_attribute("rid", prid)
            if tid is not None:
                # both phases ran on the one replica
                self.pools[idx].request_log.annotate(
                    tid, prefill_replica=self._replica_name(idx),
                    decode_replica=self._replica_name(idx),
                )
        with self._lock:
            rid = self._rid
            self._rid += 1
            self._route[rid] = (idx, prid)
        return rid

    def _submit_disaggregated(self, prompt_ids, max_new_tokens: int, kw) -> Tuple[int, int]:
        """(decode pool index, pool-local rid) of one request through the
        prefill -> fabric -> decode handshake.  A prompt with no full block
        before its last token skips the prefill phase.  A failed publish
        counts ``serve_fabric_publish_failures_total`` and the decode
        replica recomputes what never reached the fabric.  The decode
        pool's SLO clocks are backdated to this call's entry, so TTFT
        spans the whole handshake."""

        t0, t0m = time.perf_counter(), time.monotonic()
        tid = kw.get("trace_id")
        tier = str(kw.get("tier", "batch"))
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        pi = min(self.prefill_idx,
                 key=lambda i: (self.pools[i].load_components()["prefill"], i))
        di = min(self.decode_idx,
                 key=lambda i: (self.pools[i].load_components()["decode"], i))
        ppool, dpool = self.pools[pi], self.pools[di]
        usable = (int(prompt.size) - 1) // ppool.block_size
        if usable > 0:
            span = self._route_span(
                tid, phase="prefill", role="prefill", replica=self._replica_name(pi),
                tier=tier, load_score=round(ppool.load_components()["prefill"], 4),
            )
            with span:
                try:
                    res = ppool.publish_to_fabric(prompt, tier=tier, trace_id=tid,
                                                  timeout=self.publish_timeout)
                    span.set_attribute("published", res["published"])
                except Exception as exc:
                    if ppool.metrics is not None:
                        ppool.metrics.inc("serve_fabric_publish_failures_total",
                                          model=ppool.model_label)
                    span.set_error(repr(exc))
        span = self._route_span(
            tid, phase="decode", role=dpool.role, replica=self._replica_name(di), tier=tier,
            load_score=round(dpool.load_components()["decode"], 4),
        )
        with span:
            prid = dpool.submit(prompt, max_new_tokens, t_submit=t0, t_submit_mono=t0m, **kw)
            span.set_attribute("rid", prid)
        if tid is not None:
            dpool.request_log.annotate(
                tid,
                prefill_replica=self._replica_name(pi) if usable > 0
                else self._replica_name(di),
                decode_replica=self._replica_name(di),
            )
        return di, prid

    # -- merged reads ---------------------------------------------------------

    def request_autopsy(self, request_id: str) -> Optional[Dict[str, Any]]:
        """The request's autopsy, or None; an id on two replicas (a client
        reusing an ``x-trace-id``, or a prefill replica's internal
        publish) resolves to the newest submit."""

        matches = [entry for p in self.pools
                   if (entry := p.request_log.get(request_id)) is not None]
        if not matches:
            return None
        return max(matches, key=lambda e: e.get("submit_unix", 0.0))

    def recent_requests(self, limit: int = 50) -> List[Dict[str, Any]]:
        """Newest-first autopsies merged across every replica's log."""

        merged: List[Dict[str, Any]] = []
        for p in self.pools:
            merged.extend(p.request_log.recent(limit))
        merged.sort(key=lambda e: e.get("submit_unix", 0.0), reverse=True)
        return merged[:limit]

    def arena_snapshots(self, limit: Optional[int] = None) -> List[Dict[str, Any]]:
        """Each paged replica's arena-timeline snapshot."""

        return [p.timeline.snapshot(limit) for p in self.pools if p.timeline is not None]

    def _lookup(self, rid: int) -> Tuple[int, int]:
        with self._lock:
            entry = self._route.get(rid)
        if entry is None:
            raise KeyError(f"request {rid} unknown or already collected "
                           "(results evict on first read)")
        return entry

    def result(self, rid: int):
        idx, prid = self._lookup(rid)
        row = self.pools[idx].result(prid)
        if row is not None:
            with self._lock:
                self._route.pop(rid, None)
        return row

    def result_wait(self, rid: int, timeout: Optional[float] = None):
        idx, prid = self._lookup(rid)
        row = self.pools[idx].result_wait(prid, timeout=timeout)
        if row is not None:
            with self._lock:
                self._route.pop(rid, None)
        return row

    def step_all(self) -> int:
        """Step every replica once (tests and single-threaded drivers;
        serve_lm runs one driver thread a replica).  Returns the seats
        still active."""

        return sum(p.step() for p in self.pools)

    def run(self) -> None:
        """Step every replica until all queues drain."""

        while True:
            idle = True
            for p in self.pools:
                with p._lock:
                    if p._queue or p._active:
                        idle = False
                        break
            if idle:
                return
            self.step_all()
