"""Autoregressive generation with a KV cache, the serving decoder of
one request at a time, and the paged arena's helpers (the port of
``tf_operator_tpu/models/decode.py``).

- :func:`init_cache` / :func:`generate`: the contiguous cache
  [B, Hkv, max_len, D] per layer.  Prefill and decode share one path
  (the decode branch handles s_new = prompt length and s_new = 1).
  Rolling the cache back is :func:`set_cache_index`.  A model whose
  window is shorter than max_len gets a rolling cache of ``window``
  slots with each slot's absolute position (-1 = empty), and
  ``generate`` feeds a longer prompt in window-sized chunks.
- :class:`ChunkedServingDecoder`: ``serve_lm``'s default mode.  The
  prompt is prefilled in its binary chunks (capped at the window for a
  rolling cache), then decoded token by token, with an optional LRU of
  exact-prompt snapshots (``prompt_cache``).
- :func:`paged_arena`, :func:`gather_block_view`,
  :func:`scatter_block_view`: the serving cache as fixed-size token
  blocks over one pre-allocated tensor per layer, addressed through
  per-seat block tables.  Block 0 is scratch (models/kv_blocks.py).

Every decoder family drives them: llama (rope), gpt and moe (learned
positions, read at the cache's own positions; moe routes droplessly in
decode).  Only llama is pageable: the paged helpers raise
``NotPageableError`` for the learned-position families, as the JAX
package's ``paged_arena`` does (their cache carries a position index
the arena has no place for).

Sampling draws from an explicit ``torch.Generator`` per request; the
numbers differ from ``jax.random``'s, the law does not.

A model whose heads are split over tp (a rank's shards under a
``Trainer``'s mesh, ``Family.tp``) decodes over a cache of its own heads
(Hkv / tp) and its vocab columns of the logits: ``generate`` takes the
greedy token through the split argmax and samples from the logits
gathered over the line; its caller makes the ranks feed the same draws
back (``share``: ``Trainer.generate`` broadcasts its first rank's).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from tf_operator_tpu_torch.models.gpt import CausalLM
from tf_operator_tpu_torch.models.kv_blocks import NotPageableError
from tf_operator_tpu_torch.models.llama import LlamaLM
from tf_operator_tpu_torch.models.moe import MoeLM
from tf_operator_tpu_torch.models.prefix_cache import PrefixCache, exact_key
from tf_operator_tpu_torch.models.transformer import DecodeCache, Family
from tf_operator_tpu_torch.parallel.tensor_parallel import argmax, gather_last
from tf_operator_tpu_torch.utils.metrics import DispatchLedger

#: the families that decode autoregressively (the reference's
#: ``SUPPORTS_DECODE``)
DECODER_FAMILIES = (CausalLM, LlamaLM, MoeLM)


def binary_chunks(n: int) -> list:
    """Binary decomposition of n, largest chunk first: the power-of-two
    prefill widths of the chunked decoder and the slot pool."""

    out, bit = [], 1 << n.bit_length()
    while n:
        bit >>= 1
        if n >= bit:
            out.append(bit)
            n -= bit
    return out


def window_chunks(n: int, max_chunk: Optional[int]) -> list:
    """``binary_chunks`` capped for a rolling cache: no width exceeds
    ``max_chunk`` (the largest power of two <= window), because the
    cache takes at most ``window`` tokens an apply.  None = no cap."""

    if max_chunk is None or n <= max_chunk:
        return binary_chunks(n)
    full, rem = divmod(n, max_chunk)
    return [max_chunk] * full + binary_chunks(rem)


def max_window_chunk(cfg) -> Optional[int]:
    """The largest power-of-two prefill width a rolling cache accepts,
    or None for a non-rolling config."""

    w = cfg.window
    if w is not None and w < cfg.max_len:
        return 1 << (w.bit_length() - 1)
    return None


def set_cache_index(cache: DecodeCache, n) -> DecodeCache:
    """Roll a non-rolling cache back to ``n`` (an int, or one per row):
    the decode branch masks by the index, so rows at positions >= n are
    invisible from then on, with no copy.  A rolling cache's slot
    positions cannot be rolled back, so it is refused."""

    if cache.pos is not None:
        raise ValueError("a rolling-window cache cannot be rolled back by its index "
                         "(its slots record wrapped positions)")
    cache.index = n
    return cache


def decode_variant(model: Family) -> Family:
    """The same model with decode=True (the weights are shared); a
    family that cannot decode (the encoders) is refused."""

    if not isinstance(model, DECODER_FAMILIES):
        raise NotImplementedError(
            "decode is supported for the autoregressive decoder families (CausalLM, "
            f"LlamaLM, MoeLM); got {type(model).__name__}")
    return model.variant(decode=True)


def check_pageable(model: Family) -> None:
    """Refuse a model the paged arena cannot hold: a learned-position
    family, or a rolling-window cache."""

    if not isinstance(model, LlamaLM):
        raise NotPageableError(
            f"{type(model).__name__} is not pageable (its learned position table is read "
            "at a cache position index the block arena does not keep)")
    cfg = model.cfg
    if cfg.window is not None and cfg.window < cfg.max_len:
        raise NotPageableError(
            "rolling-window caches are not pageable (wrap state aliases "
            "positions); use ContinuousBatchingDecoder"
        )


def paged_decode_variant(model: LlamaLM) -> LlamaLM:
    """The same model with the paged decode branch enabled."""

    check_pageable(model)
    return model.variant(decode=True, paged=True)


def top_k_mask(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """Logits with everything below the k-th largest set to -inf (k is
    clamped to the vocab)."""

    k = min(int(top_k), logits.shape[-1])
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, float("-inf"), logits)


def sample_categorical(logits: torch.Tensor,
                       generator: torch.Generator) -> torch.Tensor:
    """One draw per row from softmax(logits) [..., V] -> int64 [...],
    on the logits' device and without a host sync: the argmax of
    logits - log(E) with E ~ Exp(1) (the exponential race)."""

    e = torch.empty_like(logits, dtype=torch.float32).exponential_(
        1.0, generator=generator
    )
    return torch.argmax(logits.float() - torch.log(e), dim=-1)


def _rolling(cfg) -> bool:
    return cfg.window is not None and cfg.window < cfg.max_len


def init_cache(model: Family, batch_size: int,
               length: Optional[int] = None) -> DecodeCache:
    """Empty contiguous cache for ``batch_size`` rows: zeros
    [B, Hkv, length, D] per layer (Hkv / tp, the rank's heads, for a
    model split over tp), index 0.  ``length`` defaults to max_len, or to
    the window for a rolling cache, whose slot positions start at -1
    (empty: 0 would admit an unwritten slot as position 0)."""

    cfg = model.cfg
    rolling = _rolling(cfg)
    if length is None:
        length = cfg.window if rolling else cfg.max_len
    length = int(length)
    tp = 1 if model.tp is None else model.tp.size
    if cfg.kv_heads % tp:
        raise ValueError(f"{cfg.kv_heads} KV heads do not split over tp={tp}")
    shape = (batch_size, cfg.kv_heads // tp, length, cfg.head_dim)

    def z():
        return torch.zeros(shape, dtype=cfg.dtype, device=model.device)

    pos = (torch.full((batch_size, length), -1, dtype=torch.long, device=model.device)
           if rolling else None)
    return DecodeCache([(z(), z()) for _ in range(cfg.n_layers)], 0, pos)


def _sampler(temperature: float, top_k: Optional[int],
             generator: Optional[torch.Generator], tp=None):
    """Logits [B, V] -> tokens [B]: the argmax at temperature 0, else a
    draw over logits / temperature (truncated to the top_k) from
    ``generator``.  ``tp``: the line the logits' vocab is split over (the
    argmax over the split, or a draw over the gathered logits)."""

    def sample(logits):
        if temperature == 0.0:
            return argmax(logits, tp)
        logits = gather_last(logits, tp) / temperature
        if top_k is not None:
            logits = top_k_mask(logits, top_k)
        return sample_categorical(logits, generator)

    return sample


def _decode_loop(dmodel: Family, cache: DecodeCache, last: torch.Tensor, n: int,
                 sample) -> torch.Tensor:
    """``n`` tokens [B, n] from the logits of the last prompt row ``last``
    [B, V]: each sampled token is fed back through the cache."""

    tok = sample(last)
    out = [tok]
    for _ in range(n - 1):
        tok = sample(dmodel(tok[:, None], cache=cache)[:, 0])
        out.append(tok)
    return torch.stack(out, dim=1)


@torch.inference_mode()
def generate(
    model: Family,
    prompt_ids: torch.Tensor,
    max_new_tokens: int,
    *,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    share=None,
) -> torch.Tensor:
    """Sample ``max_new_tokens`` continuations of prompt_ids [B, P].
    Returns [B, P + N] int64 ids.  temperature 0 = greedy; otherwise a
    categorical draw over logits / temperature, truncated to the top_k
    logits when given, from ``generator``.  A rolling cache takes a
    prompt longer than the window in window-sized chunks (the same
    cache as a one-shot prefill: the slots behind the band are dead
    either way).  ``share``: applied to each step's tokens [B] before
    they are kept and fed back (``Trainer.generate`` broadcasts its
    mesh's first rank's)."""

    dmodel = decode_variant(model)
    cfg = dmodel.cfg
    b, p = prompt_ids.shape
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if p + max_new_tokens > cfg.max_len:
        raise ValueError(
            f"prompt ({p}) + max_new_tokens ({max_new_tokens}) exceeds "
            f"the cache length max_len={cfg.max_len}"
        )
    if temperature != 0.0 and generator is None:
        raise ValueError(
            "temperature sampling needs an explicit torch.Generator — "
            "otherwise every call returns identical tokens"
        )
    ids = prompt_ids.to(dmodel.device)
    cache = init_cache(dmodel, b)
    w = cfg.window if _rolling(cfg) and p > cfg.window else p
    for off in range(0, p, w):
        logits = dmodel(ids[:, off : off + w], cache=cache)
    sample = _sampler(temperature, top_k, generator, dmodel.tp)
    toks = _decode_loop(dmodel, cache, logits[:, -1], max_new_tokens,
                        sample if share is None else lambda lg: share(sample(lg)))
    return torch.cat([ids.long(), toks], dim=1)


class ChunkedServingDecoder:
    """One request at a time for serving (``serve_lm``'s default mode):
    the port of the JAX package's ``ChunkedServingDecoder``.

    - The prompt is prefilled in its binary chunks (37 = 32 + 4 + 1),
      capped at the largest power of two <= window for a rolling cache:
      the same widths as the JAX decoder, one ``prefill`` dispatch each
      on ``ledger``, then one ``decode`` dispatch that samples the
      tokens and fetches them.
    - ``prompt_cache`` > 0 keeps an LRU of that many exact-prompt
      snapshots (``PrefixCache`` keyed by ``exact_key``, counting
      ``serve_prefix_cache_{hits,misses,evictions}_total{mode="chunked"}``
      on the ledger's registry).  A snapshot is a copy of the prompt's
      filled cache slots (and a rolling cache's slot positions) with the
      last prompt row's logits; a hit copies it into a fresh cache and
      decodes there, so no decode loop ever writes a stored entry, and
      concurrent hits on one entry share nothing but reads.

    Deliberate differences from the JAX decoder: it decodes exactly
    ``max_new_tokens`` steps (the JAX decoder runs a power-of-two budget
    to bound its compiles and keeps the first n tokens: the same tokens);
    it compiles nothing, so it has no ``compile_count``; sampled requests
    draw from a ``torch.Generator``.  Thread-safe: every request builds
    its own cache, and the prompt cache and ledger take their own locks.
    """

    def __init__(self, model: Family, prompt_cache: int = 0,
                 ledger: Optional[DispatchLedger] = None):
        self.ledger = ledger if ledger is not None else DispatchLedger()
        self.dmodel = decode_variant(model)
        self.device = self.dmodel.device
        self.max_len = self.dmodel.cfg.max_len
        self._max_chunk = max_window_chunk(self.dmodel.cfg)
        self._prompt_cache = (
            PrefixCache(capacity=int(prompt_cache), metrics=self.ledger.metrics,
                        mode="chunked")
            if int(prompt_cache) > 0 else None
        )

    @property
    def prompt_cache_hits(self) -> int:
        return 0 if self._prompt_cache is None else self._prompt_cache.hits

    def _chunks(self, n: int) -> list:
        return window_chunks(n, self._max_chunk)

    def _snapshot(self, cache: DecodeCache, p: int, last: torch.Tensor):
        """The prompt's filled slots, slot positions and last logits,
        each a copy."""

        n = min(p, cache.layers[0][0].shape[2])
        layers = [(k[:, :, :n].clone(), v[:, :, :n].clone()) for k, v in cache.layers]
        pos = None if cache.pos is None else cache.pos.clone()
        return layers, pos, last.clone()

    def _restore(self, snap, b: int, p: int):
        """A fresh cache primed from a snapshot (the stored tensors are
        only read), and the last prompt row's logits."""

        layers, pos, last = snap
        cache = init_cache(self.dmodel, b)
        n = layers[0][0].shape[2]
        for (ck, cv), (sk, sv) in zip(cache.layers, layers):
            ck[:, :, :n] = sk
            cv[:, :, :n] = sv
        if pos is not None:
            cache.pos.copy_(pos)
        cache.index = p
        return cache, last

    @torch.inference_mode()
    def generate(
        self,
        prompt_ids: torch.Tensor,
        max_new_tokens: int,
        *,
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """``max_new_tokens`` continuations of prompt_ids [B, P] (the
        JAX decoder's validation and messages).  Returns [B, P + N]
        int64 ids on the host."""

        b, p = prompt_ids.shape
        if p < 1:
            raise ValueError("prompt must contain at least one token")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if p + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({p}) + max_new_tokens ({max_new_tokens}) exceeds "
                f"max_len={self.max_len}"
            )
        if temperature == 0.0:
            top_k = None  # greedy ignores top_k
        elif generator is None:
            raise ValueError("temperature sampling needs an explicit torch.Generator")
        sample = _sampler(temperature, top_k, generator)
        host_ids = prompt_ids.cpu()
        key = snap = None
        if self._prompt_cache is not None:
            key = exact_key(host_ids.numpy().astype(np.int32))
            snap = self._prompt_cache.get(key)  # counts the hit or miss
        if snap is not None:
            cache, last = self._restore(snap, b, p)
        else:
            ids = host_ids.to(self.device)
            cache, offset = init_cache(self.dmodel, b), 0
            for width in self._chunks(p):
                with self.ledger.dispatch("prefill"):
                    last = self.dmodel(ids[:, offset : offset + width], cache=cache)[:, -1]
                offset += width
            if key is not None:
                self._prompt_cache.put(key, self._snapshot(cache, p, last))
        with self.ledger.dispatch("decode"):
            toks = _decode_loop(self.dmodel, cache, last, max_new_tokens, sample).cpu()
        return torch.cat([host_ids.long(), toks], dim=1)


def paged_arena(model: LlamaLM, num_blocks: int, block_size: int
                ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Zeroed arenas for ``model``: per layer (K, V)
    [num_blocks, Hkv, block_size, D] in cfg.dtype on the model's
    device."""

    check_pageable(model)
    cfg = model.cfg
    if cfg.max_len % block_size:
        raise ValueError(
            f"max_len={cfg.max_len} must be a multiple of "
            f"block_size={block_size}"
        )
    shape = (num_blocks, cfg.kv_heads, block_size, cfg.head_dim)

    def z():
        return torch.zeros(shape, dtype=cfg.dtype, device=model.device)

    return [(z(), z()) for _ in range(cfg.n_layers)]


def gather_block_view(arena, table: torch.Tensor, length: int) -> DecodeCache:
    """Batch-1 contiguous cache over the blocks ``table`` ([n] ids):
    K/V [1, Hkv, n*bs, D] per layer, index = ``length``."""

    ids = table.long()

    def view(a):
        g = a[ids]  # [n, Hkv, bs, D]
        n, h, bs, d = g.shape
        return g.permute(1, 0, 2, 3).reshape(1, h, n * bs, d)

    return DecodeCache([(view(k), view(v)) for k, v in arena], int(length))


def scatter_block_view(arena, cache: DecodeCache, table: torch.Tensor,
                       start_block: int, n_blocks: int) -> None:
    """Write blocks ``start_block .. start_block+n_blocks-1`` of a
    batch-1 view back into the arena, at the physical ids ``table``
    gives for them (in place)."""

    ids = table[start_block : start_block + n_blocks].long()
    for (ak, av), (ck, cv) in zip(arena, cache.layers):
        h, bs, d = ak.shape[1], ak.shape[2], ak.shape[3]
        lo, hi = start_block * bs, (start_block + n_blocks) * bs
        if hi > ck.shape[2]:
            raise ValueError(
                f"view holds {ck.shape[2]} positions; blocks up to {hi} "
                "were asked for"
            )
        for a, c in ((ak, ck), (av, cv)):
            win = c[0, :, lo:hi].reshape(h, n_blocks, bs, d)
            a[ids] = win.permute(1, 0, 2, 3).to(a.dtype)
