"""GPT-style causal LM (the port of ``tf_operator_tpu/models/gpt.py``):
learned positions, RMSNorm pre-norm blocks with relu MLPs and attention
biases (the generic ``DecoderLayer``), and the tied head.

Parameter names follow the llama family's (``tok_embed.embedding``,
``pos_embed``, ``layers.{i}.self_attn.query.kernel``, ...,
``ln_final.scale``), so the llama weight bridge (models/weights.py)
maps them to and from the flax tree's ``layer_{i}`` paths unchanged.

The learned table has ``max_len`` rows.  A forward over the whole
sequence adds its first S rows; under sequence parallelism a rank adds
its chunk's rows, from the chunk's global offset
(``transformer.sequence_start``: the rank's sp coordinate times S / sp,
where the reference's global array reads them for free).  A decode
forward adds the rows of the
cache's own positions (``DecodeCache.positions``: one shared index, or
one per seat in the slot pool), where the reference keeps a
``pos_index`` cache leaf.  A shared index that would read past the
table raises (the reference's ``dynamic_slice`` clamps silently there;
its registry refusal is what guards it).  A seat's position past the
table is clamped instead: the slot pool steps every seat to the end of
its window, and a seat's steps past its budget produce tokens that are
never kept (its prompt plus budget fits the table, ``_check_fits``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tf_operator_tpu_torch.models.llama import llama_loss
from tf_operator_tpu_torch.models.transformer import (
    DecodeCache,
    DecoderLayer,
    Embed,
    Family,
    PagedCache,
    RMSNorm,
    TransformerConfig,
    _param,
    dropout,
    sequence_start,
)

#: the next-token loss of the gpt family: the reference's ``lm_loss`` is
#: the one llama trains with (float32 cross-entropy of the head's logits
#: over the B * (S - 1) targets, and the token accuracy; under sequence
#: parallelism the chunk's shares)
lm_loss = llama_loss


def learned_positions(table: torch.Tensor, s: int, cache: Optional[DecodeCache],
                      dtype: torch.dtype, start: int = 0) -> torch.Tensor:
    """The rows of the learned position ``table`` [L, E] for ``s`` new
    positions, cast to ``dtype``: [1, S, E] from position ``start`` (no
    cache: 0, or a sequence-parallel chunk's offset) or from the cache's
    shared index, [B, S, E] at the seats' own positions (module
    docstring: the clamp)."""

    rows = table.shape[0]
    if cache is None:
        if start + s > rows:
            raise ValueError(f"sequence {start + s} exceeds the learned position table's "
                             f"{rows} rows")
        return table[start:start + s].to(dtype)[None]
    if isinstance(cache.index, torch.Tensor):
        pos = cache.positions(s, table.device).clamp(max=rows - 1)
        return table[pos].to(dtype)
    start = int(cache.index)
    if start + s > rows:
        raise ValueError(f"positions {start}..{start + s - 1} exceed the learned position "
                         f"table's {rows} rows (max_len)")
    return table[start:start + s].to(dtype)[None]


def check_decode_call(cfg: TransformerConfig, cache, train: bool) -> None:
    """A learned-position family's forward: a decode config needs a
    contiguous cache and a cache needs a decode config; the paged cache
    is refused (these families are not pageable); a decode forward does
    not train."""

    if isinstance(cache, PagedCache):
        raise ValueError("the learned-position families decode over a contiguous cache "
                         "only (they are not pageable)")
    if cfg.decode != (cache is not None):
        raise ValueError(
            "a decode config needs a cache and a cache needs a decode "
            f"config (decode={cfg.decode}, cache={type(cache).__name__})"
        )
    if train and cache is not None:
        raise ValueError("a decode forward does not train")


class CausalLM(Family):
    """The reference's ``CausalLM``: ids [B, S] -> float32 logits
    [B, S, V] (module docstring).  ``from_state_dict`` and ``variant``
    are :class:`Family`'s."""

    def __init__(self, cfg: TransformerConfig, device=None, trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        self.tok_embed = Embed(cfg, device, trainable)
        self.pos_embed = _param((cfg.max_len, cfg.hidden), cfg.dtype, device, trainable)
        self.layers = nn.ModuleList(DecoderLayer(cfg, device, trainable, activation="relu")
                                    for _ in range(cfg.n_layers))
        self.ln_final = RMSNorm(cfg, device, trainable)

    @property
    def device(self) -> torch.device:
        return self.ln_final.scale.device

    @staticmethod
    def flax_path(name: str) -> str:
        from tf_operator_tpu_torch.models.weights import name_to_flax_path

        return name_to_flax_path(name)

    def forward(self, input_ids: torch.Tensor, *, cache: Optional[DecodeCache] = None,
                train: bool = False) -> torch.Tensor:
        """``cache`` (decode configs only) is advanced by the new
        positions; ``train``: a training forward, whose dropout draws
        from ``dropout_rng``."""

        cfg = self.cfg
        check_decode_call(cfg, cache, train)
        rng = self.dropout_generator(train)
        s = input_ids.shape[1]
        x = self.tok_embed(input_ids) + learned_positions(self.pos_embed, s, cache, cfg.dtype,
                                                          sequence_start(cfg, s))
        x = dropout(x, cfg.dropout, rng)
        for i, layer in enumerate(self.layers):
            x = layer(x, cache, i, cfg.plain_kernels, rng=rng)
        if cache is not None:
            cache.advance(s)
        return self.tok_embed.attend(self.ln_final(x)).float()


def gpt_small(vocab_size: int = 50257, max_len: int = 1024, **kw) -> TransformerConfig:
    """GPT-2 small's widths: 12 layers, hidden 768, 12 heads x 64, MLP
    3072 (dropout 0.1, the reference's default)."""

    return TransformerConfig(vocab_size=vocab_size, hidden=768, n_heads=12, head_dim=64,
                             n_layers=12, mlp_dim=3072, max_len=max_len, **kw)


def gpt_tiny(vocab_size: int = 1024, max_len: int = 256, **kw) -> TransformerConfig:
    """Test scale: 2 layers, hidden 128, 4 heads x 32, MLP 512."""

    return TransformerConfig(vocab_size=vocab_size, hidden=128, n_heads=4, head_dim=32,
                             n_layers=2, mlp_dim=512, max_len=max_len, **kw)
