"""Paged continuous batching (the port of
``tf_operator_tpu/models/batching.py::PagedContinuousBatchingDecoder`` in
its ``reserve="worst-case"`` mode).

One pre-allocated block arena backs every seat through a per-seat
block table, and admission is gated on blocks free.  The port has only
the JAX pool's ``reserve="worst-case"`` contract: admission reserves the
prompt's and the whole budget's blocks, and a request that does not fit
waits at the head of the FIFO queue.  The JAX pool's default, and the
JAX server's (``examples/serve_lm.py`` passes no ``reserve``), is
``reserve="lazy"``: it admits a request on its prompt's blocks plus one
and grows its table as it decodes, preempting a seat when the arena
runs out.  The two admit alike while the arena holds every seat's worst
case (the default ``kv_blocks``); below that the JAX pool runs requests
together that the port queues, with the same greedy tokens.  Lazy
growth, preemption, swap, SLO tiers, disaggregation and speculation are
not ported yet.

Admission (one request at a time, under the pool lock):

- the longest cached prompt prefix is mapped copy-free into the seat's
  table (refcounted; the last prompt token always re-runs, because its
  logits seed the first sample);
- the remainder is prefilled at its exact length on a contiguous view
  gathered from the seat's blocks (the JAX pool pads to a power-of-two
  width and rolls the pad rows back; the eager port needs neither), and
  exactly ``blocks_for(remainder)`` blocks are scattered back;
- the first token is sampled from the last prompt row;
- every full prompt block is published in the prefix cache;
- a budget-1 request retires at once.

Decode: ``steps_per_sync`` steps per window over device-resident
tables, lengths, temperatures, top-ks and last tokens.  Each step runs
the paged decode branch (the CUDA paged-attention kernel on the card);
the window's tokens reach the host in one fetch.  Finished seats retire
in one batch that resets their table rows before their freed blocks can
be allocated again.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from tf_operator_tpu_torch.models.decode import (
    decode_variant,
    gather_block_view,
    paged_arena,
    paged_decode_variant,
    sample_categorical,
    scatter_block_view,
)
from tf_operator_tpu_torch.models.kv_blocks import (
    SCRATCH_BLOCK,
    BlockAllocator,
    blocks_for,
)
from tf_operator_tpu_torch.models.llama import LlamaLM
from tf_operator_tpu_torch.models.prefix_cache import PrefixCache, chain_keys
from tf_operator_tpu_torch.models.transformer import PagedCache

#: the pool's static top-k width: a request's top_k thresholds within
#: the top TOP_K_MAX candidates
TOP_K_MAX = 64


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


class _Request:
    __slots__ = ("rid", "prompt", "budget", "temperature", "top_k",
                 "generator", "tokens", "done", "slot", "t_submit",
                 "t_first", "prefix_tokens")

    def __init__(self, rid, prompt, budget, temperature, top_k, generator):
        self.rid = rid
        self.prompt = prompt  # np.ndarray [P] int32
        self.budget = budget
        self.temperature = temperature
        self.top_k = top_k  # None = no truncation
        self.generator = generator
        self.tokens: List[int] = []
        self.done = False
        self.slot: Optional[int] = None
        self.t_submit = time.perf_counter()
        self.t_first: Optional[float] = None
        self.prefix_tokens = 0


class PagedContinuousBatchingDecoder:
    """Fixed seats over one block arena (module docstring).

    Thread-safe: ``submit`` may be called from request threads while
    one decode loop thread calls ``step``.  ``dispatches`` counts the pool's
    device work by phase (admission / step / retire); ``recent`` keeps
    the last finished requests' records (prompt and prefix-hit tokens,
    time to first token, tokens)."""

    def __init__(self, model: LlamaLM, slots: int = 8, steps_per_sync: int = 8,
                 kv_blocks: Optional[int] = None, kv_block_size: int = 16):
        cfg = model.cfg
        self.device = model.device
        self.dmodel = decode_variant(model)
        self.pmodel = paged_decode_variant(model)
        self.slots = int(slots)
        if self.slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        self.steps_per_sync = max(1, int(steps_per_sync))
        self.max_len = cfg.max_len
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
        dev = self.device
        # device-resident seat state: written at admission, advanced by
        # the step window, reset at retire — no per-step uploads
        self._tables_dev = torch.full(
            (self.slots, self.max_blocks), SCRATCH_BLOCK, dtype=torch.int32, device=dev
        )
        self._lengths_dev = torch.zeros(self.slots, dtype=torch.int32, device=dev)
        self._temps_dev = torch.zeros(self.slots, dtype=torch.float32, device=dev)
        self._topks_dev = torch.zeros(self.slots, dtype=torch.int32, device=dev)
        self._last_tok = torch.zeros(self.slots, dtype=torch.long, device=dev)
        #: slot -> the sampled request's generator (greedy seats: none)
        self._generators: Dict[int, torch.Generator] = {}
        #: slot -> physical ids behind the seat's table row, in order
        self._seat_refs: Dict[int, List[int]] = {}
        #: shared prefix store — a block is evictable only while nothing
        #: maps it (refcount 1 = the cache's own reference)
        self.prefix = PrefixCache(
            can_evict=lambda bid: self.alloc.refcount(bid) == 1,
            on_evict=lambda bid: self.alloc.release([bid]),
        )
        self._lock = threading.Lock()
        self._done_cond = threading.Condition(self._lock)
        self._rid = 0
        self._queue: List[_Request] = []
        self._active: Dict[int, _Request] = {}
        self._results: Dict[int, _Request] = {}
        self.dispatches = collections.Counter(admission=0, step=0, retire=0)
        #: decode steps run (each is one forward of every layer) and the
        #: host wall of the windows that ran them, fetch included
        self.decode_steps = 0
        self.decode_seconds = 0.0
        self.recent: "collections.deque[dict]" = collections.deque(maxlen=256)

    # -- public API --------------------------------------------------------

    def submit(self, prompt_ids, max_new_tokens: int, *,
               temperature: float = 0.0, top_k: Optional[int] = None,
               generator: Optional[torch.Generator] = None) -> int:
        """Queue one request ([P] ids).  Returns its id; collect the
        output with ``result``/``result_wait``.  A sampled request
        (temperature > 0) draws from its own ``generator``, which must
        live on the pool's device."""

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
        need = blocks_for(prompt.size + max_new_tokens, self.block_size)
        if need > self.alloc.usable:
            raise ValueError(
                f"request needs {need} KV blocks but the arena has only "
                f"{self.alloc.usable} — admission could never succeed"
            )
        with self._lock:
            rid = self._rid
            self._rid += 1
            req = _Request(rid, prompt, int(max_new_tokens), float(temperature),
                           top_k, generator)
            self._results[rid] = req
            self._queue.append(req)
        return rid

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

    def run(self) -> None:
        """Step until every submitted request has finished."""

        while True:
            with self._lock:
                if not self._queue and not self._active:
                    return
            self.step()

    # -- admission ---------------------------------------------------------

    def _plan_admission(self, req: _Request):
        """Reserve the request's blocks (caller holds the lock): the
        longest cached prefix is retained first, fresh blocks cover the
        rest of prompt + budget, and on shortfall unmapped prefix-cache
        entries are evicted LRU-first.  None when the arena is full."""

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
        total = blocks_for(p_len + req.budget, bs)
        need = total - len(shared)
        new = self.alloc.alloc(need)
        while new is None:
            if self.prefix.evict_lru(need=need - self.alloc.free_count) == 0:
                if shared:
                    self.alloc.release(shared)
                return None
            new = self.alloc.alloc(need)
        row = np.full((self.max_blocks,), SCRATCH_BLOCK, np.int32)
        row[: len(shared)] = shared
        row[len(shared) : total] = new
        return {"shared": shared, "new": new, "keys": keys, "row": row}

    def _admit(self) -> None:
        """Seat queued requests in FIFO order while a seat and the head
        request's blocks are free (the head gates the queue)."""

        while True:
            with self._lock:
                if not self._queue or len(self._active) == self.slots:
                    return
                req = self._queue[0]
                plan = self._plan_admission(req)
                if plan is None:
                    return
                self._queue.pop(0)
                slot = min(s for s in range(self.slots) if s not in self._active)
                try:
                    self._admit_paged(req, slot, plan)
                except BaseException:
                    # the request survives a failed admission: its
                    # reservation is rolled back and it keeps its place
                    self.alloc.release(plan["shared"] + plan["new"])
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
        row = torch.as_tensor(plan["row"], device=self.device)
        view = gather_block_view(self._arena, row[: n_shared + n_fresh], prefix_len)
        ids = torch.as_tensor(req.prompt[prefix_len:], device=self.device)[None]
        logits = self.dmodel(ids, cache=view)
        tok = _admission_sample(logits[0, -1], req.temperature, req.top_k,
                                req.generator)
        scatter_block_view(self._arena, view, row, n_shared, n_fresh)
        self._tables_dev[slot] = row
        self._lengths_dev[slot] = p_len
        self._temps_dev[slot] = req.temperature
        self._topks_dev[slot] = req.top_k or 0
        self._last_tok[slot] = tok
        self.dispatches["admission"] += 1
        req.tokens.append(int(tok))  # the admission's one host fetch
        req.t_first = time.perf_counter()
        req.prefix_tokens = prefix_len
        self.prefix.record(prefix_len > 0)
        # publish every full prompt block (final content: decode writes
        # start at p_len) under its chain key; the cache holds a ref
        for i in range(p_len // bs):
            key = plan["keys"][i]
            if key not in self.prefix:
                bid = int(plan["row"][i])
                self.alloc.retain([bid])
                self.prefix.put(key, bid)
        refs = plan["shared"] + plan["new"]
        if len(req.tokens) >= req.budget:
            # budget 1: done at admission.  Its blocks go straight back,
            # so the freshly written device row must be reset first
            self._retire_device_locked([slot])
            self.alloc.release(refs)
            self._finish_locked(req)
            return
        req.slot = slot
        self._active[slot] = req
        self._seat_refs[slot] = refs
        if req.generator is not None:
            self._generators[slot] = req.generator

    # -- decode ------------------------------------------------------------

    def _retire_device_locked(self, slots: List[int]) -> None:
        """Reset the seats' device rows in one batch: table rows back to
        scratch, lengths/temps/top-ks to zero.  Required before their
        freed blocks re-allocate, or a dead seat's appends would land in
        the new owner's blocks."""

        idx = torch.as_tensor(slots, dtype=torch.long, device=self.device)
        self._tables_dev[idx] = SCRATCH_BLOCK
        self._lengths_dev[idx] = 0
        self._temps_dev[idx] = 0.0
        self._topks_dev[idx] = 0
        for s in slots:
            self._generators.pop(s, None)
        self.dispatches["retire"] += 1

    def _finish_locked(self, req: _Request) -> None:
        req.done = True
        req.slot = None
        self.recent.append({
            "rid": req.rid,
            "prompt_tokens": int(req.prompt.size),
            "prefix_tokens": int(req.prefix_tokens),
            "ttft_s": req.t_first - req.t_submit,
            "tokens": len(req.tokens),
        })
        self._done_cond.notify_all()

    @torch.inference_mode()
    def step(self) -> int:
        """Admit, run one window of ``steps_per_sync`` decode steps for
        the active seats, retire the finished ones.  Returns the number
        of seats still active."""

        self._admit()
        with self._lock:
            if not self._active:
                return 0
            enabled = np.zeros(self.slots, bool)
            enabled[list(self._active)] = True
            enabled = torch.as_tensor(enabled, device=self.device)
            # empty seats read and write scratch only
            tables = torch.where(enabled[:, None], self._tables_dev, SCRATCH_BLOCK)
            cache = PagedCache(self._arena, tables, self._lengths_dev)
            toks = self._last_tok
            window = []
            t0 = time.perf_counter()
            for _ in range(self.steps_per_sync):
                logits = self.pmodel(toks[:, None], cache=cache)
                toks = _step_sample(logits[:, 0], self._temps_dev,
                                    self._topks_dev, self._generators)
                window.append(toks)
            host = torch.stack(window).cpu().numpy()  # [K, S]: one fetch
            self.decode_seconds += time.perf_counter() - t0
            self.decode_steps += self.steps_per_sync
            self.dispatches["step"] += 1
            self._lengths_dev = torch.where(enabled, cache.lengths, self._lengths_dev)
            self._last_tok = torch.where(enabled, toks, self._last_tok)
            finished = []
            for slot in sorted(self._active):
                req = self._active[slot]
                take = min(len(host), req.budget - len(req.tokens))
                req.tokens.extend(int(t) for t in host[:take, slot])
                if len(req.tokens) >= req.budget:
                    finished.append(slot)
            if finished:
                # device rows first, then the blocks (see _retire_device_locked)
                self._retire_device_locked(finished)
                for slot in finished:
                    req = self._active.pop(slot)
                    self.alloc.release(self._seat_refs.pop(slot))
                    self._finish_locked(req)
            return len(self._active)
