"""Transformer components (the port of the decoder half of
``tf_operator_tpu/models/transformer.py``).

Parameters keep the flax layout — a dense kernel is [in..., out...],
the attention projections are [E, H, D] and the output projection is
[H, D, E] — so the weight bridge (models/weights.py) is a renaming.
``QDenseGeneral`` casts both x and the kernel to ``cfg.dtype`` before
each product.  Two storage modes, chosen when a model is built:

- serving (``trainable=False``, the default): kernels and the embedding
  are stored in ``cfg.dtype`` from the start (the same numbers, cast
  once) and take no gradients;
- training (``trainable=True``): every parameter is a float32 master
  copy that takes gradients and is cast to ``cfg.dtype`` at each use,
  as flax does.

Norm scales are float32 in both, as flax applies them.

Attention has three branches, chosen by the cache passed in:

- no cache: the causal forward over the whole sequence, through
  ``ops/flash_attention.attention`` (the flash kernels on the card,
  their plain versions on the CPU; ``cfg.plain_attention`` asks for
  the plain versions on the card too);
- a :class:`DecodeCache`: the contiguous decode branch — new K/V are
  written at the running index, queries attend to every filled slot;
- a :class:`PagedCache`: the paged decode branch — each seat's new K/V
  are appended in place to its block in the arena, and attention reads
  the arena through ``ops/paged_attention`` (the CUDA kernel on the
  card).

Caches are updated in place (PyTorch tensors are mutable; the JAX
package returns new ones).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
from torch import nn

from tf_operator_tpu_torch.ops.attention import dot_product_attention
from tf_operator_tpu_torch.ops.flash_attention import attention
from tf_operator_tpu_torch.ops.paged_attention import paged_attention_multi
from tf_operator_tpu_torch.ops.rotary import apply_rope

#: flax's RMSNorm epsilon
NORM_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32128
    hidden: int = 768
    n_heads: int = 12
    head_dim: int = 64
    n_layers: int = 12
    mlp_dim: int = 3072
    max_len: int = 512
    #: training dropout; only 0 is ported (a model in training mode
    #: with dropout > 0 raises)
    dropout: float = 0.0
    dtype: torch.dtype = torch.bfloat16
    #: grouped-query attention: number of K/V heads (None = MHA)
    n_kv_heads: Optional[int] = None
    rope: bool = False
    rope_theta: float = 10000.0
    attn_bias: bool = True
    #: sliding-window attention: position i sees [i - window + 1, i]
    window: Optional[int] = None
    #: autoregressive decode: self-attention reads and writes a cache
    decode: bool = False
    #: paged decode: the cache is the block arena (needs decode=True)
    paged: bool = False
    #: the full-sequence branch's attention: False = the flash kernels
    #: for CUDA tensors and their plain versions for CPU ones; True =
    #: the plain versions everywhere (the reference on the card)
    plain_attention: bool = False

    def __post_init__(self):
        if self.paged:
            if not self.decode:
                raise ValueError("paged attention requires decode=True")
            if self.window is not None and self.window < self.max_len:
                raise ValueError(
                    "rolling-window caches are not pageable (wrap state "
                    "aliases positions)"
                )
        if self.n_kv_heads is not None and self.n_heads % self.n_kv_heads:
            raise ValueError(
                f"n_heads ({self.n_heads}) must be a multiple of "
                f"n_kv_heads ({self.n_kv_heads})"
            )
        if self.window is not None and self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads


@dataclasses.dataclass
class DecodeCache:
    """Contiguous cache: per layer (K, V) [B, Hkv, L, D] and the running
    write index shared by the batch.  Setting ``index`` back to n rolls
    the cache back: slots >= n are masked from then on."""

    layers: List[Tuple[torch.Tensor, torch.Tensor]]
    index: int = 0


@dataclasses.dataclass
class PagedCache:
    """Paged cache: per layer (K, V) arenas [NB, Hkv, bs, D], block
    tables [S, MB] int32 and per-seat lengths [S] int32 (tokens already
    cached, so a seat's first new token sits at ``lengths[s]``).
    ``impl`` is handed to ``paged_attention_multi`` (None: the kernel for
    CUDA tensors, the plain version for CPU ones)."""

    arena: List[Tuple[torch.Tensor, torch.Tensor]]
    tables: torch.Tensor
    lengths: torch.Tensor
    impl: Optional[str] = None


def _param(shape, dtype, device, trainable: bool) -> nn.Parameter:
    """A serving parameter stored in ``dtype`` without gradients, or a
    trainable float32 master parameter."""

    if trainable:
        dtype = torch.float32
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=trainable)


class DenseGeneral(nn.Module):
    """Contracts x's trailing ``len(in_shape)`` axes with a kernel of
    shape ``in_shape + features`` (the flax layout): the dense path of
    the JAX package's ``QDenseGeneral``."""

    def __init__(self, in_shape, features, cfg: TransformerConfig,
                 use_bias: bool, device=None, trainable: bool = False):
        super().__init__()
        self.in_shape = tuple(in_shape)
        self.features = tuple(features)
        self.dtype = cfg.dtype
        self.kernel = _param(self.in_shape + self.features, cfg.dtype, device, trainable)
        self.bias = (_param(self.features, cfg.dtype, device, trainable)
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n_in = len(self.in_shape)
        lead = x.shape[: x.ndim - n_in]
        k_in = 1
        for d in self.in_shape:
            k_in *= d
        out = torch.matmul(x.to(self.dtype).reshape(*lead, k_in),
                           self.kernel.to(self.dtype).reshape(k_in, -1))
        out = out.reshape(*lead, *self.features)
        if self.bias is not None:
            out = out + self.bias.to(self.dtype)
        return out


class RMSNorm(nn.Module):
    """flax ``nn.RMSNorm``: float32 statistics, eps 1e-6, the float32
    scale folded into the reciprocal, one cast to ``cfg.dtype``."""

    def __init__(self, cfg: TransformerConfig, device=None, trainable: bool = False):
        super().__init__()
        self.dtype = cfg.dtype
        self.scale = _param((cfg.hidden,), torch.float32, device, trainable)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = (xf * xf).mean(dim=-1, keepdim=True)
        mul = torch.rsqrt(var + NORM_EPS) * self.scale
        return (xf * mul).to(self.dtype)


class Embed(nn.Module):
    """Token embedding [V, E], looked up and then cast to ``cfg.dtype``
    (the same numbers as flax's cast of the whole table)."""

    def __init__(self, cfg: TransformerConfig, device=None, trainable: bool = False):
        super().__init__()
        self.dtype = cfg.dtype
        self.embedding = _param((cfg.vocab_size, cfg.hidden), cfg.dtype, device, trainable)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embedding[ids.long()].to(self.dtype)


class MultiHeadAttention(nn.Module):
    """Causal self-attention with rope and GQA."""

    def __init__(self, cfg: TransformerConfig, device=None, trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        h, hkv, d, e = cfg.n_heads, cfg.kv_heads, cfg.head_dim, cfg.hidden
        bias = cfg.attn_bias
        self.query = DenseGeneral((e,), (h, d), cfg, bias, device, trainable)
        self.key = DenseGeneral((e,), (hkv, d), cfg, bias, device, trainable)
        self.value = DenseGeneral((e,), (hkv, d), cfg, bias, device, trainable)
        self.out = DenseGeneral((h, d), (e,), cfg, bias, device, trainable)

    def forward(self, x: torch.Tensor, cache=None, layer: int = 0,
                plain_attention: bool = False) -> torch.Tensor:
        cfg = self.cfg
        # [B, S, H, D] -> [B, H, S, D]
        q, k, v = (m(x).transpose(1, 2) for m in (self.query, self.key, self.value))
        if isinstance(cache, PagedCache):
            return self._paged(q, k, v, cache, layer)
        if isinstance(cache, DecodeCache):
            return self._decode(q, k, v, cache, layer)
        if cfg.rope:
            q, k = apply_rope(q, k, theta=cfg.rope_theta)
        out = attention(q, k, v, causal=True, window=cfg.window,
                        impl="plain" if plain_attention else None)
        return self.out(out.transpose(1, 2))

    def _decode(self, q, k, v, cache: DecodeCache, layer: int):
        cfg = self.cfg
        if cfg.window is not None and cfg.window < cfg.max_len:
            raise NotImplementedError(
                "rolling-window decode caches are not ported yet"
            )
        ck, cv = cache.layers[layer]
        idx, s_new = cache.index, q.shape[2]
        end = idx + s_new
        if end > ck.shape[2]:
            raise ValueError(
                f"cache holds {ck.shape[2]} positions; writing {s_new} at "
                f"index {idx} overflows it"
            )
        row_pos = torch.arange(idx, end, device=q.device)
        if cfg.rope:
            q, k = apply_rope(q, k, positions=row_pos, theta=cfg.rope_theta)
        ck[:, :, idx:end] = k.to(ck.dtype)
        cv[:, :, idx:end] = v.to(cv.dtype)
        # causal over absolute positions; slots past `end` are unfilled
        # and left out, which drops only masked (zero-weight) columns
        cols = torch.arange(end, device=q.device)[None, :]
        vis = cols <= row_pos[:, None]
        if cfg.window is not None:
            vis &= row_pos[:, None] - cols < cfg.window
        out = dot_product_attention(
            q, ck[:, :, :end], cv[:, :, :end], mask=vis[None, None]
        )
        return self.out(out.transpose(1, 2))

    def _paged(self, q, k, v, cache: PagedCache, layer: int):
        cfg = self.cfg
        ak, av = cache.arena[layer]
        tables, lengths = cache.tables, cache.lengths
        bs, mb = ak.shape[2], tables.shape[1]
        s_new = q.shape[2]
        pos = lengths.long()  # each seat's first new position
        steps = torch.arange(s_new, device=q.device)
        if cfg.rope:
            q, k = apply_rope(
                q, k, positions=pos[:, None, None] + steps[None, None, :],
                theta=cfg.rope_theta,
            )
        # in-place append: token t of seat s goes to physical block
        # tables[s, (pos+t)//bs] at offset (pos+t)%bs.  Positions past
        # the table go to scratch block 0, whose content is never
        # observable (length-masked); only scratch writes can collide.
        poss = pos[:, None] + steps[None, :]
        li = torch.clamp(poss // bs, 0, mb - 1)
        bids = torch.gather(tables.long(), 1, li)
        bids = torch.where(poss < mb * bs, bids, 0)
        offs = poss % bs
        ak[bids, :, offs, :] = k.transpose(1, 2).to(ak.dtype)
        av[bids, :, offs, :] = v.transpose(1, 2).to(av.dtype)
        # one kernel for every s_new (K = 1 is a plain decode step)
        out = paged_attention_multi(
            q.transpose(1, 2).contiguous(), ak, av, tables, lengths + s_new,
            impl=cache.impl,
        )  # [S, K, H, D]
        return self.out(out)


class MlpBlock(nn.Module):
    """llama's gated MLP: silu(gate) * up, no biases."""

    def __init__(self, cfg: TransformerConfig, device=None, trainable: bool = False):
        super().__init__()
        e, m = cfg.hidden, cfg.mlp_dim
        self.wi_gate = DenseGeneral((e,), (m,), cfg, False, device, trainable)
        self.wi_up = DenseGeneral((e,), (m,), cfg, False, device, trainable)
        self.wo = DenseGeneral((m,), (e,), cfg, False, device, trainable)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.wo(nn.functional.silu(self.wi_gate(x)) * self.wi_up(x))


class DecoderLayer(nn.Module):
    """Pre-norm decoder block: causal self-attention, then the MLP."""

    def __init__(self, cfg: TransformerConfig, device=None, trainable: bool = False):
        super().__init__()
        self.ln_self = RMSNorm(cfg, device, trainable)
        self.self_attn = MultiHeadAttention(cfg, device, trainable)
        self.ln_mlp = RMSNorm(cfg, device, trainable)
        self.mlp = MlpBlock(cfg, device, trainable)

    def forward(self, x: torch.Tensor, cache=None, layer: int = 0,
                plain_attention: bool = False) -> torch.Tensor:
        x = x + self.self_attn(self.ln_self(x), cache, layer, plain_attention)
        return x + self.mlp(self.ln_mlp(x))
