"""ViT: the vision-transformer classifier (the port of
``tf_operator_tpu/models/vit.py``).

The patch embedding is a reshape and one dense product ([B, H, W, C] ->
[B, N, p*p*C] -> hidden), the same function as a stride-p convolution;
learned positions; BERT's encoder layers; a mean-pool over the patches
(no class token) and an untied head.  ``vit_b16`` is ViT-B/16 (~86M
parameters at 224 px and 1000 classes).  Parameter names are the flax
paths joined by dots, without the norms' ``LayerNorm_0`` scope.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple

import torch
from torch import nn

from tf_operator_tpu_torch.models.transformer import (
    DenseGeneral,
    EncoderLayer,
    Family,
    LayerNorm,
    TransformerConfig,
    _param,
    dropout,
    refuse_sequence_parallel,
)
from tf_operator_tpu_torch.parallel.tensor_parallel import argmax, copy_to, cross_entropy


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """The encoder's config and the ViT module's own fields."""

    base: TransformerConfig
    patch: int = 16
    n_classes: int = 1000
    #: image channels (the patch projection's input is p * p * channels)
    channels: int = 3


class PatchEmbed(nn.Module):
    """Non-overlapping p x p patches -> hidden, as one dense product."""

    def __init__(self, cfg: TransformerConfig, patch: int, channels: int, device=None,
                 trainable: bool = False):
        super().__init__()
        self.patch, self.channels, self.dtype = patch, channels, cfg.dtype
        self.proj = DenseGeneral((patch * patch * channels,), (cfg.hidden,), cfg, True,
                                 device, trainable)

    def forward(self, images: torch.Tensor, plain: bool = False) -> torch.Tensor:
        p = self.patch
        b, h, w, c = images.shape
        if h % p or w % p:
            raise ValueError(f"image {h}x{w} not divisible by patch {p}")
        if c != self.channels:
            raise ValueError(f"images have {c} channels; the projection takes {self.channels}")
        gh, gw = h // p, w // p
        x = images.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, gh * gw, p * p * c).to(self.dtype)
        return self.proj(x, plain)


class ViT(Family):
    """images [B, H, W, C] (float) -> float32 logits [B, n_classes]."""

    def __init__(self, vcfg: ViTConfig, device=None, trainable: bool = False):
        super().__init__()
        cfg = vcfg.base
        refuse_sequence_parallel(cfg, "ViT")
        self.cfg, self.patch, self.n_classes = cfg, vcfg.patch, vcfg.n_classes
        self.patch_embed = PatchEmbed(cfg, vcfg.patch, vcfg.channels, device, trainable)
        self.pos_embed = _param((cfg.max_len, cfg.hidden), cfg.dtype, device, trainable)
        for i in range(cfg.n_layers):
            self.add_module(f"layer_{i}", EncoderLayer(cfg, device, trainable))
        self.ln_final = LayerNorm(cfg, device, trainable)
        self.head = DenseGeneral((cfg.hidden,), (vcfg.n_classes,), cfg, True, device,
                                 trainable)

    def forward(self, images: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        cfg = self.cfg
        plain = cfg.plain_kernels
        rng = self.dropout_generator(train)
        x = self.patch_embed(images, plain)
        n = x.shape[1]
        if n > cfg.max_len:
            raise ValueError(f"{n} patches > max_len {cfg.max_len}; raise cfg.max_len")
        x = dropout(x + self.pos_embed[:n].to(cfg.dtype)[None], cfg.dropout, rng)
        for i in range(cfg.n_layers):
            x = getattr(self, f"layer_{i}")(x, None, None, plain, rng)
        x = self.ln_final(x).mean(dim=1)  # mean-pool over the patches
        return self.head(copy_to(x, self.tp), plain).float()


def vit_b16(image_size: int = 224, n_classes: int = 1000, **kw) -> ViTConfig:
    """ViT-Base/16: 12 layers, hidden 768, 12 heads x 64, MLP 3072, one
    position a 16 x 16 patch."""

    n = (image_size // 16) ** 2
    return ViTConfig(TransformerConfig(vocab_size=1, hidden=768, n_heads=12, head_dim=64,
                                       n_layers=12, mlp_dim=3072, max_len=n, **kw),
                     patch=16, n_classes=n_classes)


def vit_tiny(image_size: int = 32, n_classes: int = 10, **kw) -> ViTConfig:
    """Test scale: patch 8, 2 layers, hidden 64, 4 heads x 16, MLP 128."""

    n = (image_size // 8) ** 2
    return ViTConfig(TransformerConfig(vocab_size=1, hidden=64, n_heads=4, head_dim=16,
                                       n_layers=2, mlp_dim=128, max_len=n, **kw),
                     patch=8, n_classes=n_classes)


def vit_loss(model: ViT, batch: Mapping[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Softmax cross-entropy of the float32 logits against the integer
    labels, the batch's mean, and its accuracy (``{"accuracy": ...}``).
    A training forward when the model is in train mode."""

    logits = model(batch["image"], train=model.training)
    labels = batch["label"].long()
    loss = cross_entropy(logits, labels, model.tp)
    acc = (argmax(logits.detach(), model.tp) == labels).float().mean()
    return loss, {"accuracy": acc}
