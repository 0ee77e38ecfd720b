"""Transformer components (the port of
``tf_operator_tpu/models/transformer.py``): the llama decoder's blocks
and the encoder half (LayerNorm with a bias, gelu / relu MLPs with
biases, non-causal and cross-attention with a mask or a bias, the
encoder layer, the generic decoder layer and the tied head), which the
BERT, T5 and ViT families build on.

Parameters keep the flax layout — a dense kernel is [in..., out...],
the attention projections are [E, H, D] and the output projection is
[H, D, E] — so the weight bridge (models/weights.py) is a renaming.
``QDenseGeneral`` casts both x and the kernel to ``cfg.dtype`` before
each product.  Two storage modes, chosen when a model is built:

- serving (``trainable=False``, the default): kernels and the embedding
  are stored in ``cfg.dtype`` from the start (the same numbers, cast
  once) and take no gradients.  A serving kernel may instead be held as
  int8 (:meth:`DenseGeneral.hold_int8`, ops/quant.py): its products then
  go through ``ops/quant_matmul`` (the CUDA kernel K7 on the card), as
  the JAX package's ``QDenseGeneral`` does with a ``QTensor`` kernel;
- training (``trainable=True``): every parameter is a float32 master
  copy that takes gradients and is cast to ``cfg.dtype`` at each use,
  as flax does.  It is never quantized (the JAX package quantizes for
  serving only).

Norm scales and biases are float32 in both, as flax applies them, and
so is T5's relative-position table (its bias is added to float32
logits).

Dropout (flax's ``nn.Dropout``, at the reference's sites: the
attention's and the MLP's outputs and each family's embedding sum) acts
only in a forward called with ``train=True``, and draws its masks from
the generator the model holds (``Family.dropout_rng``, which the
``Trainer`` sets): never from the global generator, and never in a
decode or serving forward, which passes no ``train``.

Attention has three branches, chosen by the cache passed in:

- no cache: the forward over the whole sequence (causal in a decoder,
  not in an encoder or a cross-attention, whose K/V come from ``kv``),
  through ``ops/flash_attention.attention`` (the flash kernels on the
  card, their plain versions on the CPU; a ``mask`` or a ``bias`` sends
  it to the plain ``dot_product_attention``, as the reference's
  dispatcher sends it to XLA).  With sequence parallelism (a
  ``cfg.mesh`` whose sp axis is above 1; the decoder families llama,
  gpt and moe, :func:`refuse_sequence_parallel`) each rank holds its
  chunk of the sequence: RoPE (and a learned position table) takes the
  chunk's global positions (:func:`sequence_start`) and attention runs
  ``ops/ring_attention`` or ``ops/ulysses_attention`` by
  ``cfg.sp_impl`` over the rank's heads (under tp its H / tp), as the
  reference's dispatch does for self-attention with no mask or bias;
- a :class:`DecodeCache`: the contiguous decode branch — new K/V are
  written at the running index (shared by the batch, or one per row
  for the slot pool), queries attend to every filled slot.  A model
  whose window is shorter than max_len gets a rolling cache of
  ``window`` slots that records each slot's absolute position: the
  rows attend over [the buffer before the write, the new chunk], so an
  in-chunk write never hides a key that an earlier row of the chunk
  still sees, and RoPE is applied at write time with absolute
  positions;
- a :class:`PagedCache`: the paged decode branch — each seat's new K/V
  are appended in place to its block in the arena, and attention reads
  the arena through ``ops/paged_attention`` (the CUDA kernel on the
  card).

``cfg.plain_kernels`` asks for the plain versions of the flash attention
and of the int8 matmul on the card too (the reference the kernels are
held against); the paged branch's attention follows ``PagedCache.impl``,
so that a paged step can differ from another in one kernel only.

Caches are updated in place (PyTorch tensors are mutable; the JAX
package returns new ones).

Tensor parallelism (a ``Trainer`` over a mesh with tp above 1, which
keeps each rank's shard of the parameters split over tp and hands the
modules their line, :func:`set_model_axes`): the attention runs the
rank's heads (q / k / v column-parallel, H / tp query and Hkv / tp K/V
heads, so GQA keeps its group size; ``out`` row-parallel, its bias
added once after the sum), the MLP its columns, and ``Embed`` its vocab
rows (the lookup summed over the line; ``attend`` gives vocab-split
logits), through ``parallel/tensor_parallel.py``.  A decode under tp
runs the rank's heads over a cache of them (H / tp query and Hkv / tp
K/V heads; ``models/decode.init_cache``), and the ``out`` projection is
summed over the line as in training.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import List, Optional, Tuple, Union

import torch
from torch import nn

from tf_operator_tpu_torch.ops.attention import dot_product_attention
from tf_operator_tpu_torch.ops.flash_attention import attention
from tf_operator_tpu_torch.ops.paged_attention import paged_attention_multi
from tf_operator_tpu_torch.ops.quant import QTensor, materialize_state
from tf_operator_tpu_torch.ops.quant_matmul import quant_matmul_2d
from tf_operator_tpu_torch.ops.ring_attention import ring_attention
from tf_operator_tpu_torch.ops.rotary import apply_rope
from tf_operator_tpu_torch.ops.ulysses_attention import ulysses_attention
from tf_operator_tpu_torch.parallel.tensor_parallel import (
    argmax,
    copy_to,
    cross_entropy,
    reduce_from,
    vocab_embed,
)

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
    #: training dropout: the rate of flax's nn.Dropout at the
    #: reference's sites (a forward with train=True only)
    dropout: float = 0.1
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
    #: False = the flash attention and the int8 matmul run their kernels
    #: for CUDA tensors and their plain versions for CPU ones; True =
    #: their plain versions everywhere (the reference on the card).  The
    #: paged attention follows PagedCache.impl
    plain_kernels: bool = False
    #: sequence parallelism: the mesh (parallel/mesh.py) whose sp axis
    #: splits the sequence (sp 1 or None: every rank sees the whole of
    #: it), and the schedule, "ring" (K/V hops) or "ulysses" (the
    #: heads <-> sequence all-to-all; the heads must split over sp).
    #: Decoding ignores both, as the reference does
    mesh: Optional[object] = None
    sp_impl: str = "ring"

    def __post_init__(self):
        if self.sp_impl not in ("ring", "ulysses"):
            raise ValueError(
                f"sp_impl must be 'ring' or 'ulysses', got {self.sp_impl!r}"
            )
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

    @property
    def sp_enabled(self) -> bool:
        return self.mesh is not None and self.mesh.shape.get("sp", 1) > 1


@dataclasses.dataclass
class DecodeCache:
    """Contiguous cache: per layer (K, V) [B, Hkv, L, D] and the write
    index: an int shared by the batch, or an int64 tensor [B] holding
    each row's own (the slot pool's seats).  ``pos`` marks a rolling
    cache (window < max_len; L is then the window): [B, L] int64, the
    absolute position each slot holds, -1 for an empty one.  Setting
    ``index`` back to n rolls a non-rolling cache back: slots >= n are
    masked from then on (``decode.set_cache_index``)."""

    layers: List[Tuple[torch.Tensor, torch.Tensor]]
    index: Union[int, torch.Tensor] = 0
    pos: Optional[torch.Tensor] = None

    def positions(self, s_new: int, device) -> torch.Tensor:
        """The absolute positions of ``s_new`` new rows: [S] for a
        shared index, [B, S] for per-row ones."""

        steps = torch.arange(s_new, device=device)
        if isinstance(self.index, torch.Tensor):
            return self.index[:, None] + steps
        return self.index + steps

    def advance(self, s_new: int) -> None:
        """After every layer has written ``s_new`` rows: a rolling cache
        records their positions in the slots they took, and the index
        moves on."""

        if self.pos is not None:
            b, length = self.pos.shape
            row_pos = self.positions(s_new, self.pos.device).expand(b, s_new)
            self.pos.scatter_(1, row_pos % length, row_pos)
        self.index = self.index + s_new


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


def dropout(x: torch.Tensor, rate: float, rng: Optional[torch.Generator]) -> torch.Tensor:
    """flax's ``nn.Dropout``: ``x`` itself without a generator (a
    forward that does not train) or at rate 0; zeros at rate 1; else each
    element kept with probability 1 - rate, drawn from ``rng`` on x's
    device, and the kept ones divided by 1 - rate."""

    if rng is None or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=rng, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def _param(shape, dtype, device, trainable: bool) -> nn.Parameter:
    """A serving parameter stored in ``dtype`` without gradients, or a
    trainable float32 master parameter."""

    if trainable:
        dtype = torch.float32
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=trainable)


class DenseGeneral(nn.Module):
    """Contracts x's trailing ``len(in_shape)`` axes with a kernel of
    shape ``in_shape + features`` (the flax layout): the JAX package's
    ``QDenseGeneral``, with a float kernel or, after :meth:`hold_int8`,
    an int8 one."""

    def __init__(self, in_shape, features, cfg: TransformerConfig,
                 use_bias: bool, device=None, trainable: bool = False):
        super().__init__()
        self.in_shape = tuple(in_shape)
        self.features = tuple(features)
        self.dtype = cfg.dtype
        self.kernel = _param(self.in_shape + self.features, cfg.dtype, device, trainable)
        self.bias = (_param(self.features, cfg.dtype, device, trainable)
                     if use_bias else None)

    @property
    def int8(self) -> bool:
        return "kernel_q" in self._buffers

    def hold_int8(self, qt: QTensor) -> None:
        """Hold ``qt`` (``quantize_array`` of this kernel) in place of the
        float kernel, which is dropped so the weights are never held
        twice: the int8 values as a [K, N] buffer ``kernel_q`` (K and N
        the flattened in and out axes, a view of the kernel's layout)
        and the per-output-channel scale repeated over the flattened out
        axes as an [N] float32 buffer ``kernel_scale`` (the same numbers:
        an [E, H, D] kernel keeps its per-D scale, shared across heads).
        A trainable model refuses: the JAX package quantizes for serving
        only."""

        if self.kernel.requires_grad:
            raise ValueError(
                "a trainable (float32 master) model is not quantized: the JAX package "
                "quantizes a model for serving only"
            )
        shape = self.in_shape + self.features
        if tuple(qt.q.shape) != shape or qt.q.dtype != torch.int8:
            raise ValueError(f"int8 kernel {tuple(qt.q.shape)} {qt.q.dtype} does not "
                             f"match the kernel {shape}")
        if qt.scale.numel() != self.features[-1]:
            raise ValueError(f"scale {tuple(qt.scale.shape)} is not per output channel "
                             f"of the kernel {shape}")
        k_in, n = math.prod(self.in_shape), math.prod(self.features)
        scale = qt.scale.reshape(-1).expand(self.features).reshape(n)
        del self.kernel
        self.register_buffer("kernel_q", qt.q.reshape(k_in, n))
        self.register_buffer("kernel_scale", scale.to(torch.float32).contiguous())

    def fit_kernel(self) -> None:
        """Take the in and out shapes from the kernel's (after a trainer
        replaced it by its tensor-parallel shard)."""

        n_in = len(self.in_shape)
        self.in_shape = tuple(self.kernel.shape[:n_in])
        self.features = tuple(self.kernel.shape[n_in:])

    def forward(self, x: torch.Tensor, plain: bool = False, reduce=None) -> torch.Tensor:
        """``reduce``: a row-parallel product's line (a ``ModelAxis``):
        the product is summed over it before the bias is added."""

        n_in = len(self.in_shape)
        lead = x.shape[: x.ndim - n_in]
        k_in = math.prod(self.in_shape)
        if self.int8:
            # the JAX package's quant_matmul on the operands held flat
            out = quant_matmul_2d(x.reshape(-1, k_in), self.kernel_q, self.kernel_scale,
                                  self.dtype, impl="plain" if plain else None)
        else:
            out = torch.matmul(x.to(self.dtype).reshape(*lead, k_in),
                               self.kernel.to(self.dtype).reshape(k_in, -1))
        out = reduce_from(out.reshape(*lead, *self.features), reduce)
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


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: float32 statistics with the fast variance
    max(E[x^2] - E[x]^2, 0), eps 1e-6, (x - mean) times rsqrt(var + eps)
    folded with the float32 scale, plus the float32 bias, one cast to
    ``cfg.dtype``."""

    def __init__(self, cfg: TransformerConfig, device=None, trainable: bool = False,
                 features: Optional[int] = None):
        super().__init__()
        self.dtype = cfg.dtype
        n = features or cfg.hidden
        self.scale = _param((n,), torch.float32, device, trainable)
        self.bias = _param((n,), torch.float32, device, trainable)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp_min((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, 0.0)
        mul = torch.rsqrt(var + NORM_EPS) * self.scale
        return ((xf - mean) * mul + self.bias).to(self.dtype)


def norm(cfg: TransformerConfig, rms: bool, device=None, trainable: bool = False) -> nn.Module:
    """The reference's ``LayerNorm(cfg, rms=...)``: flax's RMSNorm or
    LayerNorm."""

    return (RMSNorm if rms else LayerNorm)(cfg, device, trainable)


class Embed(nn.Module):
    """Token embedding [V, E], looked up and then cast to ``cfg.dtype``
    (the same numbers as flax's cast of the whole table), and the tied
    head (:meth:`attend`)."""

    #: the tp line the table's vocab rows are split over (None: whole)
    tp = None

    def __init__(self, cfg: TransformerConfig, device=None, trainable: bool = False):
        super().__init__()
        self.dtype = cfg.dtype
        self.embedding = _param((cfg.vocab_size, cfg.hidden), cfg.dtype, device, trainable)

    def forward(self, ids: torch.Tensor, attend: bool = False) -> torch.Tensor:
        if attend:
            # x [B, S, E] . table^T in x's dtype (``Embed.attend``)
            return torch.matmul(copy_to(ids, self.tp), self.embedding.to(ids.dtype).t())
        return vocab_embed(self.embedding, ids, self.tp).to(self.dtype)

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        """The tied head: logits [B, S, V] of hidden states ``x`` against
        the table (this rank's vocab columns under tp).  Through the
        module's call, so that a sharded trainer's hooks gather the table
        for it."""

        return self(x, attend=True)


class MultiHeadAttention(nn.Module):
    """Self- or cross-attention with rope and GQA: causal in a decoder,
    not in an encoder (``causal``, as the reference's field).  Under tp
    (``tp``, a ``ModelAxis``) it holds and runs the rank's heads."""

    #: the tp line the heads are split over (None: every head)
    tp = None

    def __init__(self, cfg: TransformerConfig, device=None, trainable: bool = False,
                 causal: bool = False):
        super().__init__()
        self.cfg = cfg
        self.causal = causal
        h, hkv, d, e = cfg.n_heads, cfg.kv_heads, cfg.head_dim, cfg.hidden
        bias = cfg.attn_bias
        self.query = DenseGeneral((e,), (h, d), cfg, bias, device, trainable)
        self.key = DenseGeneral((e,), (hkv, d), cfg, bias, device, trainable)
        self.value = DenseGeneral((e,), (hkv, d), cfg, bias, device, trainable)
        self.out = DenseGeneral((h, d), (e,), cfg, bias, device, trainable)

    def forward(self, x: torch.Tensor, cache=None, layer: int = 0,
                plain: bool = False, *, kv: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None, bias: Optional[torch.Tensor] = None,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """``kv`` [B, Sk, E]: cross-attention to it (None: self-attention);
        ``mask`` (bool, True = attend) and ``bias`` broadcast to the
        logits [B, H, Sq, Sk]; ``rng``: the output's dropout masks (a
        training forward only)."""

        cfg = self.cfg
        is_self = kv is None
        x = copy_to(x, self.tp)
        kv_in = x if is_self else copy_to(kv, self.tp)
        # [B, S, H, D] -> [B, H, S, D]
        q = self.query(x, plain).transpose(1, 2)
        k, v = (m(kv_in, plain).transpose(1, 2) for m in (self.key, self.value))
        if cache is not None:
            if not is_self or mask is not None or bias is not None:
                raise ValueError("decode builds its own masks over the cache: no kv, mask "
                                 "or bias (left-align prompts)")
            if isinstance(cache, PagedCache):
                return self._paged(q, k, v, cache, layer, plain)
            return self._decode(q, k, v, cache, layer, plain)
        if cfg.window is not None and is_self and not self.causal:
            raise NotImplementedError(
                "sliding-window attention is defined for causal self-attention; encoder "
                "self-attention does not support it (cross-attention layers ignore it)")
        if cfg.sp_enabled and is_self and mask is None and bias is None:
            out = self._sequence_parallel(q, k, v, plain)
        else:
            if cfg.rope and is_self:
                q, k = apply_rope(q, k, theta=cfg.rope_theta)
            out = attention(q, k, v, causal=self.causal, bias=bias, mask=mask,
                            window=cfg.window if self.causal and is_self else None,
                            impl="plain" if plain else None)
        return dropout(self.out(out.transpose(1, 2), plain, reduce=self.tp), cfg.dropout, rng)

    def _sequence_parallel(self, q, k, v, plain: bool):
        """This rank's chunk of the sequence: RoPE at the chunk's global
        positions (the reference's arrays are global, so its positions
        are global for free), then the sp schedule of ``cfg.sp_impl``
        over the rank's heads (all of them, or its H / tp under tp).
        K/V enter at Hkv width and travel that way.  Returns the
        attention's output [B, H, S, D]."""

        cfg = self.cfg
        s = q.shape[2]
        if cfg.rope:
            start = sequence_start(cfg, s)
            q, k = apply_rope(q, k, positions=torch.arange(start, start + s, device=q.device),
                              theta=cfg.rope_theta)
        sp_attn = ulysses_attention if cfg.sp_impl == "ulysses" else ring_attention
        return sp_attn(q, k, v, cfg.mesh, causal=self.causal, window=cfg.window,
                       use_flash=False if plain else None)

    def _decode(self, q, k, v, cache: DecodeCache, layer: int, plain: bool):
        cfg = self.cfg
        ck, cv = cache.layers[layer]
        b, _, s_new, _ = q.shape
        cache_len = ck.shape[2]
        rolling = cfg.window is not None and cfg.window < cfg.max_len
        if rolling != (cache.pos is not None):
            raise ValueError(
                f"window={cfg.window}, max_len={cfg.max_len} needs "
                f"{'a rolling' if rolling else 'a non-rolling'} cache "
                "(decode.init_cache builds the right one)"
            )
        if rolling and s_new > cache_len:
            raise ValueError(
                f"windowed rolling decode prefills at most window="
                f"{cfg.window} tokens per apply (got {s_new}); feed "
                "the prompt in chunks <= window — models/decode.py's "
                "generate()/ChunkedServingDecoder do this"
            )
        row_pos = cache.positions(s_new, q.device)  # [S] or [B, S]
        per_row = row_pos.ndim == 2
        if cfg.rope:
            q, k = apply_rope(q, k, positions=row_pos[:, None] if per_row else row_pos,
                              theta=cfg.rope_theta)
        if not rolling and not per_row:
            idx, end = cache.index, cache.index + s_new
            if end > cache_len:
                raise ValueError(
                    f"cache holds {cache_len} positions; writing {s_new} at "
                    f"index {idx} overflows it"
                )
            ck[:, :, idx:end] = k.to(ck.dtype)
            cv[:, :, idx:end] = v.to(cv.dtype)
            # causal over absolute positions; slots past `end` are
            # unfilled and left out, which drops only masked
            # (zero-weight) columns
            cols = torch.arange(end, device=q.device)[None, :]
            vis = cols <= row_pos[:, None]
            if cfg.window is not None:
                vis &= row_pos[:, None] - cols < cfg.window
            out = dot_product_attention(
                q, ck[:, :, :end], cv[:, :, :end], mask=vis[None, None]
            )
            return self.out(out.transpose(1, 2), plain, reduce=self.tp)
        qpos = row_pos.expand(b, s_new)
        if rolling:
            # read [the buffer before the write, the new chunk]: the
            # buffer holds the latest position of each slot below the
            # index, the chunk the rest, so every position any row needs
            # is present once however the writes wrap
            kpos = torch.cat([cache.pos, qpos], dim=1)[:, None, :]
            keys = torch.cat([ck, k.to(ck.dtype)], dim=2)
            vals = torch.cat([cv, v.to(cv.dtype)], dim=2)
            vis = (kpos >= 0) & (kpos <= qpos[:, :, None])
            vis &= qpos[:, :, None] - kpos < cfg.window
            at = qpos % cache_len
        else:
            # per-row writes past the cache's end (a seat's steps after
            # its budget) land on its own last slot, which no kept token
            # reads again
            keys, vals = ck, cv
            kpos = torch.arange(cache_len, device=q.device)[None, None, :]
            vis = kpos <= qpos[:, :, None]
            if cfg.window is not None:
                vis &= qpos[:, :, None] - kpos < cfg.window
            at = qpos.clamp(max=cache_len - 1)
        rows = torch.arange(b, device=q.device)[:, None].expand(b, s_new)
        ck[rows, :, at] = k.transpose(1, 2).to(ck.dtype)
        cv[rows, :, at] = v.transpose(1, 2).to(cv.dtype)
        out = dot_product_attention(q, keys, vals, mask=vis[:, None])
        return self.out(out.transpose(1, 2), plain, reduce=self.tp)

    def _paged(self, q, k, v, cache: PagedCache, layer: int, plain: bool):
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
        return self.out(out, plain, reduce=self.tp)


#: the MLP's activations (the reference's ``MlpBlock.activation``)
ACTIVATIONS = ("gelu", "relu", "swiglu")


class MlpBlock(nn.Module):
    """The reference's MLP: llama's gated ``swiglu`` (silu(gate) * up, no
    biases), or a ``gelu`` (flax's, the tanh form) or ``relu`` MLP with
    biases; dropout on its output.  Under tp the rank's columns."""

    #: the tp line the columns are split over (None: every column)
    tp = None

    def __init__(self, cfg: TransformerConfig, device=None, trainable: bool = False,
                 activation: str = "gelu"):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise ValueError(f"activation must be one of {ACTIVATIONS}, got {activation!r}")
        self.activation = activation
        self.rate = cfg.dropout
        e, m = cfg.hidden, cfg.mlp_dim
        if activation == "swiglu":
            self.wi_gate = DenseGeneral((e,), (m,), cfg, False, device, trainable)
            self.wi_up = DenseGeneral((e,), (m,), cfg, False, device, trainable)
            self.wo = DenseGeneral((m,), (e,), cfg, False, device, trainable)
        else:
            self.wi = DenseGeneral((e,), (m,), cfg, True, device, trainable)
            self.wo = DenseGeneral((m,), (e,), cfg, True, device, trainable)

    def forward(self, x: torch.Tensor, plain: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = copy_to(x, self.tp)
        if self.activation == "swiglu":
            y = nn.functional.silu(self.wi_gate(x, plain)) * self.wi_up(x, plain)
        elif self.activation == "gelu":
            y = nn.functional.gelu(self.wi(x, plain), approximate="tanh")
        else:
            y = nn.functional.relu(self.wi(x, plain))
        return dropout(self.wo(y, plain, reduce=self.tp), self.rate, rng)


class EncoderLayer(nn.Module):
    """Pre-norm encoder block: non-causal self-attention, then the MLP;
    ``rms`` / ``activation`` give the T5 flavour (RMSNorm + relu), the
    defaults BERT's and ViT's (LayerNorm + gelu)."""

    def __init__(self, cfg: TransformerConfig, device=None, trainable: bool = False,
                 rms: bool = False, activation: str = "gelu"):
        super().__init__()
        self.ln_attn = norm(cfg, rms, device, trainable)
        self.attn = MultiHeadAttention(cfg, device, trainable)
        self.ln_mlp = norm(cfg, rms, device, trainable)
        self.mlp = MlpBlock(cfg, device, trainable, activation)

    def forward(self, x: torch.Tensor, mask=None, bias=None, plain: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x + self.attn(self.ln_attn(x), plain=plain, mask=mask, bias=bias, rng=rng)
        return x + self.mlp(self.ln_mlp(x), plain, rng)


class DecoderLayer(nn.Module):
    """Pre-norm decoder block (RMSNorm): causal self-attention, the
    cross-attention to the encoder's output when ``cross`` (T5), then the
    MLP (``activation``: llama's ``swiglu``, T5's ``relu``)."""

    def __init__(self, cfg: TransformerConfig, device=None, trainable: bool = False,
                 cross: bool = False, activation: str = "relu"):
        super().__init__()
        self.ln_self = RMSNorm(cfg, device, trainable)
        self.self_attn = MultiHeadAttention(cfg, device, trainable, causal=True)
        if cross:
            self.ln_cross = RMSNorm(cfg, device, trainable)
            self.cross_attn = MultiHeadAttention(cfg, device, trainable)
        self.cross = cross
        self.ln_mlp = RMSNorm(cfg, device, trainable)
        self.mlp = MlpBlock(cfg, device, trainable, activation)

    def forward(self, x: torch.Tensor, cache=None, layer: int = 0,
                plain: bool = False, *, enc: Optional[torch.Tensor] = None,
                self_bias: Optional[torch.Tensor] = None,
                enc_mask: Optional[torch.Tensor] = None,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x + self.self_attn(self.ln_self(x), cache, layer, plain, bias=self_bias, rng=rng)
        if self.cross:
            x = x + self.cross_attn(self.ln_cross(x), plain=plain, kv=enc, mask=enc_mask,
                                    rng=rng)
        return x + self.mlp(self.ln_mlp(x), plain, rng)


def _dropout_generator(model: nn.Module, train: bool) -> Optional[torch.Generator]:
    """The generator of a forward's dropout masks: None unless it trains
    at a rate above 0; then the model's, which must be set."""

    if not train or model.cfg.dropout == 0.0:
        return None
    if model.dropout_rng is None:
        raise ValueError(
            f"a training forward at dropout {model.cfg.dropout} draws its masks from the "
            "model's dropout_rng, and none is set: the Trainer sets it, or "
            "set_dropout_rng(model, torch.Generator(...))")
    return model.dropout_rng


def refuse_sequence_parallel(cfg: TransformerConfig, family: str) -> None:
    """The encoder families (BERT, T5, ViT) run without sequence
    parallelism: it is ported for the decoder families (llama, gpt and
    moe)."""

    if cfg.sp_enabled:
        raise NotImplementedError(f"sequence parallelism is ported for the decoder families "
                                  f"(llama, gpt, moe); {family} runs with sp 1")


def sequence_start(cfg: TransformerConfig, s: int) -> int:
    """The global position of this rank's first row: its coordinate on
    its sp line times its chunk's length ``s`` (0 without sp)."""

    if not cfg.sp_enabled:
        return 0
    from tf_operator_tpu_torch.runtime.bootstrap import world

    return cfg.mesh.index(("sp",), world()[0]) * s


def next_token_xent(logits: torch.Tensor, targets: torch.Tensor, reduction: str, tp=None):
    """Cross-entropy of ``logits`` [..., V] (vocab-split over ``tp``,
    the model's line, where it has one) against ``targets`` [...]."""

    v = logits.shape[-1]
    return cross_entropy(logits.reshape(-1, v), targets.reshape(-1), tp, reduction)


def sp_targets(mesh, ids: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
    """Under sequence parallelism ``ids`` [B, S/n] is this rank's chunk
    of the sequence: (the next-token targets of its positions, how many
    of them have one, the B * (S - 1) targets of the whole sequence).
    The target of the chunk's last position is the first token of the
    next chunk, received from the next rank of the sp line (the halo
    XLA exchanges for the reference's global ``ids[:, 1:]``); the last
    chunk's last position has none."""

    from tf_operator_tpu_torch.ops.ring_attention import sp_line
    from tf_operator_tpu_torch.parallel.collectives import ppermute

    line = sp_line(mesh)
    b, s = ids.shape
    first_of_next = ppermute(ids[:, :1], line.group, line.stats, "loss_halo", shift=-1)
    targets = torch.cat([ids[:, 1:], first_of_next], dim=1)
    valid = s - 1 if line.index == line.size - 1 else s
    return targets, valid, b * (s * line.size - 1)


def next_token_loss(model: nn.Module, ids: torch.Tensor, logits: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(float32 cross-entropy averaged over the B * (S - 1) targets,
    token accuracy) of a decoder family's ``logits`` [B, S, V] (split
    over ``model.tp``'s vocab under tp) against the next tokens of
    ``ids`` [B, S]: the reference's ``lm_loss``, shared by llama, gpt and
    moe.  Under sequence parallelism (``model.cfg.sp_enabled``) ``ids``
    is this rank's chunk and both values are its share of the whole
    sequence's: its targets' sum (:func:`sp_targets`) over the whole
    sequence's count, so that their sum over the sp line is the mean."""

    if model.cfg.sp_enabled:
        targets, valid, count = sp_targets(model.cfg.mesh, ids)
        logits, targets = logits[:, :valid], targets[:, :valid]
        loss = next_token_xent(logits, targets, "sum", model.tp) / count
        hits = (argmax(logits.detach(), model.tp) == targets).sum()
        return loss, hits.float() / count
    logits, targets = logits[:, :-1], ids[:, 1:]
    return (next_token_xent(logits, targets, "mean", model.tp),
            (argmax(logits.detach(), model.tp) == targets).float().mean())


def set_dropout_rng(model: nn.Module, rng: Optional[torch.Generator]) -> None:
    """Hand ``rng`` to every module of ``model`` that draws dropout masks
    (each one whose class declares a ``dropout_rng``: every
    :class:`Family`, the MNIST CNN)."""

    for m in model.modules():
        if hasattr(type(m), "dropout_rng"):
            m.dropout_rng = rng


def set_model_axes(model: nn.Module, **lines) -> None:
    """Hand the lines of the model axes (``tp=``, ``ep=``, ``ep_tp=``:
    ``parallel/tensor_parallel.ModelAxis`` or None) to every module of
    ``model`` that computes with one (a module with that attribute),
    after the parameters split over them were replaced by this rank's
    shards; each dense product takes its shapes from its kernel."""

    for m in model.modules():
        if isinstance(m, DenseGeneral) and not m.int8:
            m.fit_kernel()
        for name, line in lines.items():
            if hasattr(m, name):
                setattr(m, name, line)


def global_count(model: nn.Module, count: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """A loss's denominator over the global batch: ``(total, ranks)``,
    ``count`` (the positions this rank's loss counts) summed over the
    model's batch group (``Family.set_batch_group``) and that group's
    size; (count, 1) without one.  A rank's ``sum / total * ranks``,
    averaged over the ranks as the ``Trainer`` averages, is the mean over
    the global batch that the reference's loss takes over its global
    array, whatever each rank counts."""

    group = getattr(model, "batch_group", None)
    if group is None:
        return count, 1
    import torch.distributed as dist

    total = count.detach().float().clone()
    dist.all_reduce(total, group=group)
    return total, dist.get_world_size(group)


class Family(nn.Module):
    """What every model family of the port shares: building around a
    state (:meth:`from_state_dict`), a view under another config
    (:meth:`variant`), the dropout generator of its training forwards
    (``dropout_rng``, set by the ``Trainer``) and the ranks that hold the
    rest of the batch (``batch_group``, :meth:`set_batch_group`)."""

    #: the generator of the training forwards' dropout masks
    dropout_rng: Optional[torch.Generator] = None
    #: the batch axes' process group (None: this rank holds the batch)
    batch_group = None
    #: the tp line (``set_model_axes``): the head's logits, and so the
    #: loss's vocab, are split over it
    tp = None
    #: a QTensor kernel is held as int8 (its products run the int8
    #: matmul); False: an int8 state is dequantized to bf16 before it is
    #: loaded (the reference's ``materialize_fn`` for such a family)
    SUPPORTS_QTENSOR = True

    def dropout_generator(self, train: bool) -> Optional[torch.Generator]:
        return _dropout_generator(self, train)

    def set_batch_group(self, group) -> None:
        """The ranks that hold the rest of the batch (the ``Trainer``
        sets them under a mesh: the batch axes and sp, whose ranks hold
        the other chunks of the same rows): a loss whose count differs
        between ranks takes its denominator over them
        (:func:`global_count`), moe's routing fractions their mean."""

        self.batch_group = group

    @classmethod
    def from_state_dict(cls, cfg, state, device, *, trainable: bool = False, **kw):
        """Build the model around ``state`` (name -> tensor, array or
        QTensor), each entry moved to ``device`` and cast to its
        parameter's storage dtype.  A serving model adopts entries already
        in place without a copy, so 7B-width weights are never held
        twice, holds a QTensor kernel as int8
        (``DenseGeneral.hold_int8``), and is returned in eval mode; a
        trainable model copies every entry (the optimizer updates its
        parameters in place), refuses QTensors, and is returned in train
        mode.  ``kw``: the family's other constructor arguments.  A family
        without ``SUPPORTS_QTENSOR`` dequantizes every QTensor first."""

        if not cls.SUPPORTS_QTENSOR:
            state = materialize_state(state)
        model = cls(cfg, device="meta", trainable=trainable, **kw)
        expected = dict(model.named_parameters())
        if set(state) != set(expected):
            missing = sorted(set(expected) - set(state))
            extra = sorted(set(state) - set(expected))
            raise ValueError(
                f"state does not match the model: missing {missing[:4]}, "
                f"unexpected {extra[:4]}"
            )
        placed, held = {}, set()
        for name, value in state.items():
            p = expected[name]
            if not isinstance(value, QTensor):
                value = torch.as_tensor(value)
            if tuple(value.shape) != tuple(p.shape):
                raise ValueError(
                    f"{name}: shape {tuple(value.shape)} != {tuple(p.shape)}"
                )
            if isinstance(value, QTensor):
                module, leaf = name.rsplit(".", 1)
                dense = model.get_submodule(module)
                if leaf != "kernel" or not isinstance(dense, DenseGeneral):
                    raise ValueError(f"{name}: only dense kernels are held as int8")
                dense.hold_int8(QTensor(value.q.to(device), value.scale.to(device)))
                held.update(f"{module}.{b}" for b in ("kernel_q", "kernel_scale"))
                continue
            placed[name] = value.to(device=device, dtype=p.dtype, copy=trainable)
        missing, unexpected = model.load_state_dict(placed, strict=False, assign=True)
        if unexpected or set(missing) != held:
            raise ValueError(f"state does not load: missing {sorted(set(missing) - held)[:4]}, "
                             f"unexpected {unexpected[:4]}")
        return model.train(trainable)

    def variant(self, **changes):
        """The same weights under a config with ``changes`` (e.g.
        decode=True or plain_kernels=True): a shallow copy, so no
        parameter or int8 kernel is duplicated (the pool's decode views
        share the int8 modules)."""

        v = copy.copy(self)
        v.cfg = dataclasses.replace(self.cfg, **changes)
        return v

    def flax_path(self, name: str) -> str:
        """The flax param path of a parameter name: the dots as "/", with
        a norm's ``LayerNorm_0`` or ``RMSNorm_0`` scope put back."""

        parts = name.split(".")
        owner = self.get_submodule(".".join(parts[:-1]))
        if isinstance(owner, (LayerNorm, RMSNorm)):
            parts.insert(-1, f"{type(owner).__name__}_0")
        return "/".join(parts)
