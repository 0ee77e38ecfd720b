"""BERT: the masked-LM pretraining model (the port of
``tf_operator_tpu/models/bert.py``; the reference's BASELINE config 3,
"BERT-base pretrain").

Pre-norm encoder layers (LayerNorm, gelu MLP, non-causal attention) over
token + learned position (+ segment) embeddings, then the MLM head: a
dense transform, gelu, LayerNorm and the untied decoder to the vocab.
``bert_base`` is the BERT-base shape (109M parameters in the embeddings
and the encoder, 133M with the head's untied decoder at vocab 30522, as
the reference's).  Parameter names are the flax
paths joined by dots, without the norms' ``LayerNorm_0`` scope
(``bert.layer_0.attn.query.kernel``, ``mlm.mlm_ln.scale``, ...):
models/weights.py bridges them.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from tf_operator_tpu_torch.models.transformer import (
    DenseGeneral,
    Embed,
    EncoderLayer,
    Family,
    LayerNorm,
    TransformerConfig,
    _param,
    dropout,
    global_count,
    refuse_sequence_parallel,
)
from tf_operator_tpu_torch.parallel.tensor_parallel import argmax, copy_to, cross_entropy


class Bert(Family):
    """The encoder: ids [B, S] -> hidden states [B, S, E] after
    ``ln_final``.  ``segments``: build the segment table (the reference
    creates ``seg_embed`` only when ``segment_ids`` is passed, which
    ``BertForPretraining`` never does)."""

    def __init__(self, cfg: TransformerConfig, device=None, trainable: bool = False,
                 n_segments: int = 2, segments: bool = False):
        super().__init__()
        refuse_sequence_parallel(cfg, "BERT")
        self.cfg = cfg
        self.tok_embed = Embed(cfg, device, trainable)
        self.pos_embed = _param((cfg.max_len, cfg.hidden), cfg.dtype, device, trainable)
        self.seg_embed = (_param((n_segments, cfg.hidden), cfg.dtype, device, trainable)
                          if segments else None)
        self.ln_embed = LayerNorm(cfg, device, trainable)
        for i in range(cfg.n_layers):
            self.add_module(f"layer_{i}", EncoderLayer(cfg, device, trainable))
        self.ln_final = LayerNorm(cfg, device, trainable)

    def forward(self, input_ids: torch.Tensor, *, segment_ids=None, attention_mask=None,
                train: bool = False, plain=None) -> torch.Tensor:
        """``attention_mask`` [B, S]: 1 = a real token (the rest is masked
        out of every row's keys, through the plain attention); ``plain``:
        the caller's ``plain_kernels`` (None: this config's)."""

        cfg = self.cfg
        plain = cfg.plain_kernels if plain is None else plain
        rng = self.dropout_generator(train)
        s = input_ids.shape[1]
        x = self.tok_embed(input_ids) + self.pos_embed[:s].to(cfg.dtype)[None]
        if segment_ids is not None:
            if self.seg_embed is None:
                raise ValueError("segment_ids for a Bert built without segments "
                                 "(Bert(..., segments=True))")
            x = x + self.seg_embed[segment_ids.long()].to(cfg.dtype)
        x = dropout(self.ln_embed(x), cfg.dropout, rng)
        mask = None if attention_mask is None else attention_mask[:, None, None, :].bool()
        for i in range(cfg.n_layers):
            x = getattr(self, f"layer_{i}")(x, mask, None, plain, rng)
        return self.ln_final(x)


class MlmHead(nn.Module):
    """The MLM head: transform, gelu, LayerNorm, decode to the vocab;
    float32 logits (the rank's vocab columns under tp)."""

    #: the tp line the decoder's vocab columns are split over
    tp = None

    def __init__(self, cfg: TransformerConfig, device=None, trainable: bool = False):
        super().__init__()
        e = cfg.hidden
        self.mlm_transform = DenseGeneral((e,), (e,), cfg, True, device, trainable)
        self.mlm_ln = LayerNorm(cfg, device, trainable)
        self.mlm_decoder = DenseGeneral((e,), (cfg.vocab_size,), cfg, True, device, trainable)

    def forward(self, hidden: torch.Tensor, plain: bool = False) -> torch.Tensor:
        y = F.gelu(self.mlm_transform(hidden, plain), approximate="tanh")
        return self.mlm_decoder(copy_to(self.mlm_ln(y), self.tp), plain).float()


class BertForPretraining(Family):
    """ids [B, S] -> float32 MLM logits [B, S, V]."""

    def __init__(self, cfg: TransformerConfig, device=None, trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        self.bert = Bert(cfg, device, trainable)
        self.mlm = MlmHead(cfg, device, trainable)

    def forward(self, input_ids: torch.Tensor, *, attention_mask=None,
                train: bool = False) -> torch.Tensor:
        plain = self.cfg.plain_kernels
        hidden = self.bert(input_ids, attention_mask=attention_mask, train=train, plain=plain)
        return self.mlm(hidden, plain)


def bert_base(vocab_size: int = 30522, max_len: int = 512, **kw) -> TransformerConfig:
    """BERT-base: 12 layers, hidden 768, 12 heads x 64, MLP 3072."""

    return TransformerConfig(vocab_size=vocab_size, hidden=768, n_heads=12, head_dim=64,
                             n_layers=12, mlp_dim=3072, max_len=max_len, **kw)


def bert_tiny(vocab_size: int = 1024, max_len: int = 128, **kw) -> TransformerConfig:
    """Test scale: 2 layers, hidden 128, 4 heads x 32, MLP 512."""

    return TransformerConfig(vocab_size=vocab_size, hidden=128, n_heads=4, head_dim=32,
                             n_layers=2, mlp_dim=512, max_len=max_len, **kw)


def mlm_loss(model: BertForPretraining, batch: Mapping[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``batch``: input_ids (already masked), labels (-100 = a position
    left out of the loss), optional attention_mask.  float32
    cross-entropy over the labelled positions (their mean over the
    global batch, at least one counted: ``global_count``) and their
    accuracy, as ``{"mlm_accuracy": ...}``.  A training forward when the
    model is in train mode."""

    logits = model(batch["input_ids"], attention_mask=batch.get("attention_mask"),
                   train=model.training)
    labels = batch["labels"].long()
    valid = labels >= 0
    safe = torch.where(valid, labels, 0)
    per_tok = cross_entropy(logits.reshape(-1, logits.shape[-1]), safe.reshape(-1), model.tp,
                            "none").reshape(labels.shape)
    total, ranks = global_count(model, valid.sum())
    denom = total.clamp_min(1)
    loss = torch.where(valid, per_tok, 0.0).sum() / denom * ranks
    acc = (valid & (argmax(logits.detach(), model.tp) == safe)).sum() / denom * ranks
    return loss, {"mlm_accuracy": acc}
