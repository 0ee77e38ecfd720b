"""Llama-style decoder: rope + RMSNorm + SwiGLU + GQA, untied head, and
its next-token losses (the port of ``tf_operator_tpu/models/llama.py``
and of ``models/gpt.py``'s ``lm_loss``)."""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from tf_operator_tpu_torch.models.transformer import (
    DecodeCache,
    DecoderLayer,
    DenseGeneral,
    Embed,
    PagedCache,
    RMSNorm,
    TransformerConfig,
)
from tf_operator_tpu_torch.ops.quant import QTensor


class LlamaLM(nn.Module):
    """Decoder-only LM over a TransformerConfig with rope=True.

    Parameter names follow the flax tree (``tok_embed.embedding``,
    ``layers.{i}.self_attn.query.kernel``, ..., ``lm_head.kernel``);
    models/weights.py maps them to and from flax paths.

    ``trainable=True`` builds float32 master parameters that take
    gradients (models/transformer.py: the two storage modes).  A serving
    model built from a state whose kernels are QTensors holds them as
    int8 (the JAX package's ``quantize_tree`` -> ``apply``)."""

    def __init__(self, cfg: TransformerConfig, device=None, trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        self.tok_embed = Embed(cfg, device, trainable)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, device, trainable) for _ in range(cfg.n_layers)
        )
        self.ln_final = RMSNorm(cfg, device, trainable)
        self.lm_head = DenseGeneral(
            (cfg.hidden,), (cfg.vocab_size,), cfg, False, device, trainable
        )

    @classmethod
    def from_state_dict(cls, cfg: TransformerConfig,
                        state: Mapping[str, object], device, *,
                        trainable: bool = False) -> "LlamaLM":
        """Build the model around ``state`` (name -> tensor, array or
        QTensor), each entry moved to ``device`` and cast to its
        parameter's storage dtype.  A serving model adopts entries already
        in place without a copy, so 7B-width weights are never held
        twice, holds a QTensor kernel as int8
        (``DenseGeneral.hold_int8``), and is returned in eval mode; a
        trainable model copies every entry (the optimizer updates its
        parameters in place), refuses QTensors, and is returned in train
        mode."""

        model = cls(cfg, device="meta", trainable=trainable)
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

    def variant(self, **changes) -> "LlamaLM":
        """The same weights under a config with ``changes`` (e.g.
        decode=True): a shallow copy, so no parameter or int8 kernel is
        duplicated (the pool's decode views share the int8 modules)."""

        v = copy.copy(self)
        v.cfg = dataclasses.replace(self.cfg, **changes)
        return v

    @property
    def device(self) -> torch.device:
        return self.ln_final.scale.device

    @staticmethod
    def flax_path(name: str) -> str:
        """The flax param path of a parameter name (models/weights.py)."""

        from tf_operator_tpu_torch.models.weights import name_to_flax_path

        return name_to_flax_path(name)

    def forward(self, input_ids: torch.Tensor, *, mode: str = "full",
                cache=None) -> torch.Tensor:
        """mode="full": ids [B, S] -> float32 logits [B, S, V].
        mode="hidden": ids -> post-ln_final hidden states [B, S, E].
        mode="head": input_ids is already a hidden-state tensor; apply
        only the lm_head.

        ``cache`` (decode configs only) is a DecodeCache or, for a paged
        config, a PagedCache; it is advanced by the new positions."""

        if mode not in ("full", "hidden", "head"):
            raise ValueError(f"mode must be full|hidden|head, got {mode!r}")
        cfg = self.cfg
        if mode == "head":
            return self.lm_head(input_ids, cfg.plain_kernels).float()
        if cfg.decode != (cache is not None):
            raise ValueError(
                "a decode config needs a cache and a cache needs a decode "
                f"config (decode={cfg.decode}, cache={type(cache).__name__})"
            )
        if cache is not None and cfg.paged != isinstance(cache, PagedCache):
            raise ValueError(
                f"paged={cfg.paged} does not match a {type(cache).__name__}"
            )
        if self.training and cfg.dropout > 0:
            raise NotImplementedError(
                f"dropout {cfg.dropout} in training is not ported; use dropout=0"
            )
        x = self.tok_embed(input_ids)
        for i, layer in enumerate(self.layers):
            x = layer(x, cache, i, cfg.plain_kernels)
        s_new = input_ids.shape[1]
        if isinstance(cache, DecodeCache):
            cache.advance(s_new)
        elif isinstance(cache, PagedCache):
            cache.lengths = cache.lengths + s_new
        x = self.ln_final(x)
        if mode == "hidden":
            return x
        return self.lm_head(x, cfg.plain_kernels).float()


def llama_tiny(vocab_size: int = 1024, max_len: int = 256,
               n_kv_heads: Optional[int] = 2, **kw) -> TransformerConfig:
    """Test-scale shape (GQA 4q:2kv by default)."""

    return TransformerConfig(
        vocab_size=vocab_size, hidden=128, n_heads=4, head_dim=32,
        n_layers=2, mlp_dim=352, max_len=max_len, rope=True,
        attn_bias=False, n_kv_heads=n_kv_heads, **kw,
    )


def llama_7b_shape(vocab_size: int = 32000, max_len: int = 4096,
                   **kw) -> TransformerConfig:
    """The canonical 7B shape: 32 layers, hidden 4096, 32 heads x 128,
    MLP 11008."""

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


def _next_token(logits: torch.Tensor, targets: torch.Tensor, reduction: str):
    v = logits.shape[-1]
    return F.cross_entropy(logits.reshape(-1, v), targets.reshape(-1).long(),
                           reduction=reduction)


def llama_loss(model: LlamaLM, batch: Batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token loss on ``batch["input_ids"]`` [B, S]: float32
    cross-entropy of the head's logits (cast to float32), averaged over
    the B * (S - 1) targets, and the token accuracy (the counterpart of
    ``lm_loss``).  Returns (loss, {"token_accuracy": ...})."""

    ids = batch["input_ids"]
    logits = model(ids)[:, :-1]
    targets = ids[:, 1:]
    loss = _next_token(logits, targets, "mean")
    acc = (logits.detach().argmax(-1) == targets).float().mean()
    return loss, {"token_accuracy": acc}


def llama_loss_chunked(model: LlamaLM, batch: Batch, n_chunks: int = 8
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """:func:`llama_loss` with the head and the cross-entropy streamed
    over sequence chunks, each under ``torch.utils.checkpoint``: only a
    chunk's hidden states are kept for the backward and the full
    [B, S, V] float32 logits never exist.  The chunk count is the
    largest count <= ``n_chunks`` that divides S - 1 (the JAX rule).
    The same math up to summation order."""

    ids = batch["input_ids"]
    h = model(ids, mode="hidden")[:, :-1]
    tgt = ids[:, 1:]
    b, s, _ = h.shape
    c = max(1, min(n_chunks, s))
    while s % c:
        c -= 1
    w = s // c

    def one(hc, tc):
        logits = model(hc, mode="head")
        return _next_token(logits, tc, "sum"), (logits.argmax(-1) == tc).sum()

    loss = h.new_zeros((), dtype=torch.float32)
    hits = torch.zeros((), dtype=torch.long, device=h.device)
    for i in range(c):
        part, n_hit = checkpoint(one, h[:, i * w:(i + 1) * w], tgt[:, i * w:(i + 1) * w],
                                 use_reentrant=False)
        loss = loss + part
        hits = hits + n_hit
    denom = b * s
    return loss / denom, {"token_accuracy": hits.float() / denom}
