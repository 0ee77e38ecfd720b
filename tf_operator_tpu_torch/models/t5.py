"""T5 encoder-decoder (the port of ``tf_operator_tpu/models/t5.py``; the
reference's BASELINE config 5, "T5-base JAX/Flax multi-host").

RMSNorm pre-norm blocks, relu MLPs, a relative-position bias shared by
the layers of each stack (bidirectional in the encoder, causal in the
decoder), and the tied embedding / head with its 1/sqrt(hidden) logit
scale.  The biased self-attentions run the plain attention (a bias sends
them there, as the reference's go to XLA); the cross-attentions, which
have none, run the flash kernels.  Parameter names are the flax paths
joined by dots, without the norms' ``RMSNorm_0`` scope.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
from torch import nn

from tf_operator_tpu_torch.models.transformer import (
    DecoderLayer,
    Embed,
    EncoderLayer,
    Family,
    RMSNorm,
    TransformerConfig,
    _param,
    dropout,
    global_count,
    refuse_sequence_parallel,
)
from tf_operator_tpu_torch.parallel.tensor_parallel import argmax, cross_entropy


def relative_position_bucket(rel_pos: torch.Tensor, bidirectional: bool, num_buckets: int,
                             max_distance: int) -> torch.Tensor:
    """T5's log-bucketed relative positions, in the reference's float32
    arithmetic: log(n / max_exact + 1e-6) / log(max_distance /
    max_exact) * (buckets - max_exact), truncated to int32."""

    ret = torch.zeros_like(rel_pos)
    n = -rel_pos
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).to(rel_pos.dtype) * num_buckets
        n = n.abs()
    else:
        n = n.clamp_min(0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    log_span = torch.log(torch.tensor(max_distance / max_exact, dtype=torch.float32))
    val_if_large = max_exact + (
        torch.log(n.to(torch.float32) / max_exact + 1e-6) / log_span.to(n.device)
        * (num_buckets - max_exact)
    ).to(torch.int32)
    val_if_large = val_if_large.clamp_max(num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large.to(n.dtype))


class RelativePositionBias(nn.Module):
    """A float32 table [buckets, H]; ``(sq, sk)`` -> the bias [1, H, Sq,
    Sk] of key position j for query position i, from bucket(j - i).
    Under tp the table holds the rank's heads, so it biases only them."""

    def __init__(self, cfg: TransformerConfig, device=None, trainable: bool = False,
                 bidirectional: bool = True, num_buckets: int = 32, max_distance: int = 128):
        super().__init__()
        self.bidirectional = bidirectional
        self.num_buckets, self.max_distance = num_buckets, max_distance
        self.rel_embedding = _param((num_buckets, cfg.n_heads), torch.float32, device,
                                    trainable)

    def forward(self, sq: int, sk: int) -> torch.Tensor:
        dev = self.rel_embedding.device
        ctx = torch.arange(sq, device=dev)[:, None]
        mem = torch.arange(sk, device=dev)[None, :]
        buckets = relative_position_bucket(mem - ctx, self.bidirectional, self.num_buckets,
                                           self.max_distance)
        return self.rel_embedding[buckets].permute(2, 0, 1)[None]


class T5(Family):
    """(encoder ids [B, Se], decoder ids [B, Sd]) -> float32 logits [B,
    Sd, V]."""

    def __init__(self, cfg: TransformerConfig, device=None, trainable: bool = False):
        super().__init__()
        refuse_sequence_parallel(cfg, "T5")
        self.cfg = cfg
        self.shared_embed = Embed(cfg, device, trainable)
        self.enc_relpos = RelativePositionBias(cfg, device, trainable, bidirectional=True)
        self.dec_relpos = RelativePositionBias(cfg, device, trainable, bidirectional=False)
        for i in range(cfg.n_layers):
            self.add_module(f"enc_{i}", EncoderLayer(cfg, device, trainable, rms=True,
                                                     activation="relu"))
        self.enc_ln_final = RMSNorm(cfg, device, trainable)
        for i in range(cfg.n_layers):
            self.add_module(f"dec_{i}", DecoderLayer(cfg, device, trainable, cross=True))
        self.dec_ln_final = RMSNorm(cfg, device, trainable)

    def forward(self, encoder_ids: torch.Tensor, decoder_ids: torch.Tensor, *,
                encoder_mask=None, train: bool = False) -> torch.Tensor:
        """``encoder_mask`` [B, Se]: 1 = a real token, masked out of the
        encoder's self-attention and the cross-attention (both then run
        the plain attention)."""

        cfg = self.cfg
        plain = cfg.plain_kernels
        rng = self.dropout_generator(train)
        se, sd = encoder_ids.shape[1], decoder_ids.shape[1]
        enc_bias = self.enc_relpos(se, se)
        dec_bias = self.dec_relpos(sd, sd)
        x = dropout(self.shared_embed(encoder_ids), cfg.dropout, rng)
        mask = None if encoder_mask is None else encoder_mask[:, None, None, :].bool()
        for i in range(cfg.n_layers):
            x = getattr(self, f"enc_{i}")(x, mask, enc_bias, plain, rng)
        enc = self.enc_ln_final(x)
        y = dropout(self.shared_embed(decoder_ids), cfg.dropout, rng)
        for i in range(cfg.n_layers):
            y = getattr(self, f"dec_{i}")(y, plain=plain, enc=enc, self_bias=dec_bias,
                                          enc_mask=mask, rng=rng)
        y = self.dec_ln_final(y)
        # the root taken in the model's dtype, as the reference's
        # jnp.sqrt(jnp.asarray(hidden, y.dtype)): 27.75 in bf16 at 768
        scale = torch.sqrt(torch.tensor(float(cfg.hidden), dtype=y.dtype, device=y.device))
        return (self.shared_embed.attend(y) / scale).float()


def t5_base(vocab_size: int = 32128, **kw) -> TransformerConfig:
    """T5-base: 12 + 12 layers, hidden 768, 12 heads x 64, MLP 3072."""

    return TransformerConfig(vocab_size=vocab_size, hidden=768, n_heads=12, head_dim=64,
                             n_layers=12, mlp_dim=3072, max_len=512, **kw)


def t5_tiny(vocab_size: int = 1024, **kw) -> TransformerConfig:
    """Test scale: 2 + 2 layers, hidden 128, 4 heads x 32, MLP 512."""

    return TransformerConfig(vocab_size=vocab_size, hidden=128, n_heads=4, head_dim=32,
                             n_layers=2, mlp_dim=512, max_len=128, **kw)


def seq2seq_loss(model: T5, batch: Mapping[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``batch``: encoder_ids, decoder_ids (shifted right), targets,
    optional encoder_mask and target_mask (1 = counted).  float32
    cross-entropy over the counted targets (their mean over the global
    batch, at least one counted: ``global_count``) and their accuracy, as
    ``{"token_accuracy": ...}``.  A training forward when the model is in
    train mode."""

    logits = model(batch["encoder_ids"], batch["decoder_ids"],
                   encoder_mask=batch.get("encoder_mask"), train=model.training)
    targets = batch["targets"].long()
    per_tok = cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1), model.tp,
                            "none").reshape(targets.shape)
    tmask = batch.get("target_mask")
    tmask = torch.ones_like(per_tok) if tmask is None else tmask.to(per_tok.dtype)
    total, ranks = global_count(model, tmask.sum())
    denom = total.clamp_min(1)
    loss = (per_tok * tmask).sum() / denom * ranks
    acc = ((argmax(logits.detach(), model.tp) == targets) * tmask).sum() / denom * ranks
    return loss, {"token_accuracy": acc}
