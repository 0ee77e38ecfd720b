"""Llama-style decoder: rope + RMSNorm + SwiGLU + GQA, untied head, and
its next-token losses (the port of ``tf_operator_tpu/models/llama.py``
and of ``models/gpt.py``'s ``lm_loss``)."""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from tf_operator_tpu_torch.models.transformer import (
    DecodeCache,
    DecoderLayer,
    DenseGeneral,
    Embed,
    Family,
    PagedCache,
    RMSNorm,
    TransformerConfig,
    dropout,
    next_token_loss,
    next_token_xent,
    sp_targets,
)
from tf_operator_tpu_torch.parallel.tensor_parallel import argmax, copy_to


class LlamaLM(Family):
    """Decoder-only LM over a TransformerConfig with rope=True.

    Parameter names follow the flax tree (``tok_embed.embedding``,
    ``layers.{i}.self_attn.query.kernel``, ..., ``lm_head.kernel``);
    models/weights.py maps them to and from flax paths.

    ``trainable=True`` builds float32 master parameters that take
    gradients (models/transformer.py: the two storage modes).  A serving
    model built from a state whose kernels are QTensors holds them as
    int8 (the JAX package's ``quantize_tree`` -> ``apply``):
    ``from_state_dict`` and ``variant`` are :class:`Family`'s."""

    def __init__(self, cfg: TransformerConfig, device=None, trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        self.tok_embed = Embed(cfg, device, trainable)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, device, trainable, activation="swiglu")
            for _ in range(cfg.n_layers)
        )
        self.ln_final = RMSNorm(cfg, device, trainable)
        self.lm_head = DenseGeneral(
            (cfg.hidden,), (cfg.vocab_size,), cfg, False, device, trainable
        )

    @property
    def device(self) -> torch.device:
        return self.ln_final.scale.device

    @staticmethod
    def flax_path(name: str) -> str:
        """The flax param path of a parameter name (models/weights.py)."""

        from tf_operator_tpu_torch.models.weights import name_to_flax_path

        return name_to_flax_path(name)

    def forward(self, input_ids: torch.Tensor, *, mode: str = "full",
                cache=None, train: bool = False) -> torch.Tensor:
        """mode="full": ids [B, S] -> float32 logits [B, S, V].
        mode="hidden": ids -> post-ln_final hidden states [B, S, E].
        mode="head": input_ids is already a hidden-state tensor; apply
        only the lm_head.

        ``cache`` (decode configs only) is a DecodeCache or, for a paged
        config, a PagedCache; it is advanced by the new positions.
        ``train``: a training forward, whose dropout (at ``cfg.dropout``)
        draws from ``dropout_rng``; a decode forward never trains."""

        if mode not in ("full", "hidden", "head"):
            raise ValueError(f"mode must be full|hidden|head, got {mode!r}")
        cfg = self.cfg
        if mode == "head":
            return self.lm_head(copy_to(input_ids, self.tp), cfg.plain_kernels).float()
        if cfg.decode != (cache is not None):
            raise ValueError(
                "a decode config needs a cache and a cache needs a decode "
                f"config (decode={cfg.decode}, cache={type(cache).__name__})"
            )
        if cache is not None and cfg.paged != isinstance(cache, PagedCache):
            raise ValueError(
                f"paged={cfg.paged} does not match a {type(cache).__name__}"
            )
        if train and cache is not None:
            raise ValueError("a decode forward does not train")
        rng = self.dropout_generator(train)
        x = dropout(self.tok_embed(input_ids), cfg.dropout, rng)
        for i, layer in enumerate(self.layers):
            x = layer(x, cache, i, cfg.plain_kernels, rng=rng)
        s_new = input_ids.shape[1]
        if isinstance(cache, DecodeCache):
            cache.advance(s_new)
        elif isinstance(cache, PagedCache):
            cache.lengths = cache.lengths + s_new
        x = self.ln_final(x)
        if mode == "hidden":
            return x
        return self.lm_head(copy_to(x, self.tp), cfg.plain_kernels).float()


def llama_tiny(vocab_size: int = 1024, max_len: int = 256,
               n_kv_heads: Optional[int] = 2, **kw) -> TransformerConfig:
    """Test-scale shape (GQA 4q:2kv by default), no dropout, as the
    reference's ``llama_tiny`` (``dropout=`` overrides it)."""

    kw.setdefault("dropout", 0.0)
    return TransformerConfig(
        vocab_size=vocab_size, hidden=128, n_heads=4, head_dim=32,
        n_layers=2, mlp_dim=352, max_len=max_len, rope=True,
        attn_bias=False, n_kv_heads=n_kv_heads, **kw,
    )


def llama_7b_shape(vocab_size: int = 32000, max_len: int = 4096,
                   **kw) -> TransformerConfig:
    """The canonical 7B shape: 32 layers, hidden 4096, 32 heads x 128,
    MLP 11008, no dropout (the reference's)."""

    kw.setdefault("dropout", 0.0)
    return TransformerConfig(
        vocab_size=vocab_size, hidden=4096, n_heads=32, head_dim=128,
        n_layers=32, mlp_dim=11008, max_len=max_len, rope=True,
        attn_bias=False, **kw,
    )


def llama_wide(vocab_size: int = 32000, max_len: int = 2048,
               window: Optional[int] = None, **kw) -> TransformerConfig:
    """The ~700M wide-llama training config (hidden 2048, 12 layers, GQA
    16 query heads : 8 KV heads of 128, SwiGLU 5632, no dropout): the
    port's copy of ``bench.py``'s ``llama_wide_config``."""

    return TransformerConfig(
        vocab_size=vocab_size, hidden=2048, n_heads=16, head_dim=128,
        n_layers=12, mlp_dim=5632, max_len=max_len, dropout=0.0, rope=True,
        attn_bias=False, n_kv_heads=8, window=window, **kw,
    )


Batch = Mapping[str, torch.Tensor]


def llama_loss(model: LlamaLM, batch: Batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token loss on ``batch["input_ids"]`` [B, S]: float32
    cross-entropy of the head's logits (cast to float32), averaged over
    the B * (S - 1) targets, and the token accuracy (the counterpart of
    ``lm_loss``; ``models/transformer.next_token_loss``).  Returns (loss,
    {"token_accuracy": ...}); under sequence parallelism both are this
    rank's chunk's shares, summed by the trainer over the sp line."""

    ids = batch["input_ids"]
    loss, acc = next_token_loss(model, ids, model(ids, train=model.training))
    return loss, {"token_accuracy": acc}


def llama_loss_chunked(model: LlamaLM, batch: Batch, n_chunks: int = 8
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """:func:`llama_loss` with the head and the cross-entropy streamed
    over sequence chunks, each under ``torch.utils.checkpoint``: only a
    chunk's hidden states are kept for the backward and the full
    [B, S, V] float32 logits never exist.  The chunk count is the
    largest count <= ``n_chunks`` that divides S - 1 (the JAX rule).
    The same math up to summation order.  Under tp each chunk's logits
    are the rank's vocab shard.  Under sequence parallelism
    it takes :func:`llama_loss`'s shares: the chunk's targets, over the
    whole sequence's count, the chunk count dividing the positions that
    have a target."""

    ids = batch["input_ids"]
    if model.cfg.sp_enabled:
        tgt, valid, denom = sp_targets(model.cfg.mesh, ids)
    else:
        tgt, valid, denom = ids[:, 1:], ids.shape[1] - 1, ids.shape[0] * (ids.shape[1] - 1)
    h = model(ids, mode="hidden", train=model.training)[:, :valid]
    tgt = tgt[:, :valid]
    s = h.shape[1]
    c = max(1, min(n_chunks, s))
    while s % c:
        c -= 1
    w = s // c

    def one(hc, tc):
        logits = model(hc, mode="head")
        return (next_token_xent(logits, tc, "sum", model.tp),
                (argmax(logits.detach(), model.tp) == tc).sum())

    loss = h.new_zeros((), dtype=torch.float32)
    hits = torch.zeros((), dtype=torch.long, device=h.device)
    for i in range(c):
        part, n_hit = checkpoint(one, h[:, i * w:(i + 1) * w], tgt[:, i * w:(i + 1) * w],
                                 use_reentrant=False)
        loss = loss + part
        hits = hits + n_hit
    return loss / denom, {"token_accuracy": hits.float() / denom}
