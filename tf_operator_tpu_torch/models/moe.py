"""Mixture-of-Experts causal LM (the port of
``tf_operator_tpu/models/moe.py``): the gpt family's learned positions
and tied head, with every layer's MLP a top-2 routed expert FFN.

The routing is the reference's dense dispatch, tensor for tensor:

- the router is a float32 product of the float32 input with a float32
  kernel [E_hidden, experts] (``DenseGeneral`` over a float32 config),
  softmax over the experts; top-1 is the argmax of the probabilities,
  top-2 the argmax with the top-1 zeroed (ties to the first index, as
  ``jnp.argmax``);
- capacity: ``max(int(2 * S * capacity_factor / E), 4)`` in training,
  ``S`` in decode (dropless: a token takes at most one slot an expert);
  each token's slot is a cumsum along the sequence of its row, so the
  rows of a batch (the slot pool's seats) route independently;
- one-hots are built by comparison, so a position of -1 (unrouted) or
  one at or past the capacity gives a row of zeros, as
  ``jax.nn.one_hot`` does (``torch.nn.functional.one_hot`` raises on
  both);
- the surviving gates are renormalised over their sum plus 1e-9; the
  dispatch is the combine tensor's support in ``cfg.dtype``;
- the expert FFN is gelu (flax's tanh form) between the stacked
  ``wi`` [E, H, M] and ``wo`` [E, M, H], as einsums in ``cfg.dtype``.

The auxiliary loss (the reference sows it into a ``losses`` collection):
``aux_loss_weight`` x E x sum(fraction of top-1 routes x mean
probability) per expert, plus ``z_loss_weight`` x mean(logsumexp of the
router logits ^ 2), summed over the layers.  The forward returns it
with ``with_aux=True`` and :func:`moe_lm_loss` adds it.  The two
fractions are means over the global batch, as over the reference's
global arrays: under a batch group (``Family.set_batch_group``, the
trainer's ranks over dp, fsdp and sp) each is all-reduced, the mean probability
through a differentiable all-reduce, so each rank's loss holds the
global load-balance term and its gradient.

Sequence parallelism (a ``cfg.mesh`` with sp above 1: each rank of an
sp line holds a chunk of S / sp positions of the same rows) computes
what the reference computes over its global sequence:

- the capacity is taken from the global length S (training);
- each route's slot is its position in the expert's queue along the
  whole row: the local cumsum plus the count of the row's routes to
  that expert on the earlier ranks of the line, and the second route
  queues behind every first route of the whole row
  (:func:`route_offsets`: the [B, E] counts gathered over the line,
  forward only; the slots take no gradient);
- the fractions and the z-loss are means over dp x sp (the fractions'
  all-reduce runs over the batch group, which the trainer sets to the
  batch axes and sp; a forward outside a trainer sets it itself), and
  each rank returns its share of the auxiliary loss, 1 / sp of it, so
  that the trainer's sum over the line is the whole.

Expert parallelism (a ``Trainer`` over a mesh with ep above 1, the
ranks of an ep line each holding E / ep of the stacks and of the
router's columns; ``set_model_axes`` hands the layer its lines): the
router's float32 logits are gathered over ep in rank order before the
softmax, so the routing, the capacity slots and the gates are computed
whole and alike on every rank; each rank dispatches to and combines
from its own experts, and the outputs are summed over the line
(``parallel/tensor_parallel.py``).  Under tp the stacks' mlp dimension
is split as well, and the sum runs over the ep and tp line together.

Parameter names follow the llama family's (``layers.{i}.moe.router.kernel``,
``layers.{i}.moe.wi``, ``layers.{i}.moe.wo``), which the weight bridge
maps to the flax paths unchanged.  An int8 state (``quantize_state``:
per-expert scales for the stacks) is dequantized to bf16 before it is
loaded (``SUPPORTS_QTENSOR = False``; the reference's
``materialize_fn``), so the int8 matmul kernel is not on this family's
path.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from tf_operator_tpu_torch.models.gpt import check_decode_call, learned_positions
from tf_operator_tpu_torch.models.transformer import (
    DecodeCache,
    DenseGeneral,
    Embed,
    Family,
    MultiHeadAttention,
    RMSNorm,
    TransformerConfig,
    _param,
    dropout,
    next_token_loss,
    sequence_start,
)
from tf_operator_tpu_torch.ops.ring_attention import SpLine, sp_line
from tf_operator_tpu_torch.parallel.collectives import all_gather
from tf_operator_tpu_torch.parallel.tensor_parallel import (
    ModelAxis,
    copy_to,
    gather_last,
    reduce_from,
)


@dataclasses.dataclass(frozen=True)
class MoeConfig:
    base: TransformerConfig
    num_experts: int = 8
    capacity_factor: float = 2.0
    aux_loss_weight: float = 0.01
    z_loss_weight: float = 1e-3


class _AllReduceSum(torch.autograd.Function):
    """Sum over ``group``, differentiable: each rank's input gradient is
    the sum of every rank's output gradient."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def batch_mean(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (a mean over this rank's rows) as the mean over the batch
    group's rows (equal shares); ``x`` itself without a group."""

    if group is None:
        return x
    import torch.distributed as dist

    return _AllReduceSum.apply(x, group) / dist.get_world_size(group)


@torch.no_grad()
def route_offsets(counts: torch.Tensor, line: Optional[SpLine]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the sum of ``counts`` over the ranks before this one on its sp
    ``line``, their sum over the whole line): the routes to each expert
    that queue ahead of this rank's chunk, and the row's total.  (0,
    ``counts``) without a line."""

    if line is None:
        return torch.zeros_like(counts), counts
    every = counts.new_empty((line.size * counts.shape[0],) + tuple(counts.shape[1:]))
    all_gather(every, counts.contiguous(), line.group, line.stats, "moe_route_counts")
    every = every.view((line.size,) + tuple(counts.shape))
    return every[:line.index].sum(0), every.sum(0)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """float32 one-hot of integer ``idx`` over ``n`` classes by
    comparison: an index outside [0, n) gives a row of zeros."""

    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


class MoeMlp(nn.Module):
    """Top-2 routed expert FFNs with fixed capacity buckets (module
    docstring).  ``forward`` returns (output [B, S, H], the layer's
    auxiliary loss)."""

    #: the lines the experts (ep) and their mlp columns (tp) are split
    #: over (None: whole)
    tp: Optional[ModelAxis] = None
    ep: Optional[ModelAxis] = None
    #: the ep and tp lines together (both above 1)
    ep_tp: Optional[ModelAxis] = None

    def __init__(self, moe: MoeConfig, device=None, trainable: bool = False):
        super().__init__()
        cfg = moe.base
        self.moe = moe
        e, h, m = moe.num_experts, cfg.hidden, cfg.mlp_dim
        self.router = DenseGeneral((h,), (e,), dataclasses.replace(cfg, dtype=torch.float32),
                                   False, device, trainable)
        self.wi = _param((e, h, m), cfg.dtype, device, trainable)
        self.wo = _param((e, m, h), cfg.dtype, device, trainable)

    def capacity(self, s: int, decode: bool) -> int:
        if decode:
            return s
        return max(int(2 * s * self.moe.capacity_factor / self.moe.num_experts), 4)

    def _experts_line(self) -> Optional[ModelAxis]:
        """The line the experts' outputs are partial sums over: ep, tp,
        or both together (their combined group)."""

        if self.ep is None or self.tp is None:
            return self.ep or self.tp
        return self.ep_tp

    def forward(self, x: torch.Tensor, decode: bool = False, group=None,
                rng: Optional[torch.Generator] = None, sp: Optional[SpLine] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``group``: the ranks the routing fractions are averaged over;
        ``sp``: the sp line whose ranks hold the rest of the rows'
        sequence (module docstring)."""

        moe = self.moe
        dtype, n_exp = moe.base.dtype, moe.num_experts
        n_sp = 1 if sp is None else sp.size
        capacity = self.capacity(x.shape[1] * n_sp, decode)
        line = self._experts_line()
        # [B, S, E] float32, every expert's column on every rank
        logits = gather_last(self.router(copy_to(x, self.ep).float()), self.ep)
        probs = torch.softmax(logits, dim=-1)
        gate1, idx1 = probs.max(dim=-1)
        mask1 = _one_hot(idx1, n_exp)
        gate2, idx2 = (probs * (1.0 - mask1)).max(dim=-1)
        mask2 = _one_hot(idx2, n_exp)

        frac_tokens = batch_mean(mask1.mean(dim=(0, 1)), group)
        frac_probs = batch_mean(probs.mean(dim=(0, 1)), group)
        aux = n_exp * torch.sum(frac_tokens * frac_probs)
        z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
        aux_loss = (moe.aux_loss_weight * aux + moe.z_loss_weight * z) / n_sp

        # each token's slot in its expert, along its whole row; the
        # second route queues behind every first route of the row
        before, total = route_offsets(torch.stack([mask1.sum(dim=1), mask2.sum(dim=1)]), sp)
        pos1 = (torch.cumsum(mask1, dim=1) + before[0][:, None]) * mask1 - mask1
        count1 = total[0][:, None]
        pos2 = (torch.cumsum(mask2, dim=1) + before[1][:, None] + count1) * mask2 - mask2
        keep1 = mask1 * (pos1 < capacity)
        keep2 = mask2 * (pos2 < capacity)
        denom = gate1 * keep1.sum(-1) + gate2 * keep2.sum(-1) + 1e-9
        gates = copy_to(torch.stack([gate1 / denom, gate2 / denom]), line)
        # this rank's experts (all of them without ep)
        local = self.wi.shape[0]
        lo = 0 if self.ep is None else self.ep.index * local
        pos1, pos2 = (p[..., lo:lo + local] for p in (pos1, pos2))
        keep1, keep2 = (k[..., lo:lo + local] for k in (keep1, keep2))
        combine = (gates[0][..., None, None] * keep1[..., None]
                   * _one_hot(pos1.to(torch.int32), capacity)
                   + gates[1][..., None, None] * keep2[..., None]
                   * _one_hot(pos2.to(torch.int32), capacity))  # [B, S, E_local, C]
        dispatch = (combine > 0.0).to(dtype)

        expert_in = torch.einsum("bsec,bsh->ebch", dispatch, copy_to(x, line).to(dtype))
        hdn = torch.einsum("ebch,ehm->ebcm", expert_in, self.wi.to(dtype))
        hdn = F.gelu(hdn, approximate="tanh")
        expert_out = torch.einsum("ebcm,emh->ebch", hdn, self.wo.to(dtype))
        out = reduce_from(torch.einsum("bsec,ebch->bsh", combine.to(dtype), expert_out), line)
        return dropout(out, moe.base.dropout, rng), aux_loss


class MoeDecoderLayer(nn.Module):
    """Pre-norm decoder block (RMSNorm): causal self-attention, then the
    routed MLP.  Returns (x, the layer's auxiliary loss)."""

    def __init__(self, moe: MoeConfig, device=None, trainable: bool = False):
        super().__init__()
        cfg = moe.base
        self.ln_self = RMSNorm(cfg, device, trainable)
        self.self_attn = MultiHeadAttention(cfg, device, trainable, causal=True)
        self.ln_mlp = RMSNorm(cfg, device, trainable)
        self.moe = MoeMlp(moe, device, trainable)

    def forward(self, x: torch.Tensor, cache=None, layer: int = 0, plain: bool = False,
                decode: bool = False, group=None, rng: Optional[torch.Generator] = None,
                sp: Optional[SpLine] = None):
        x = x + self.self_attn(self.ln_self(x), cache, layer, plain, rng=rng)
        y, aux = self.moe(self.ln_mlp(x), decode, group, rng, sp)
        return x + y, aux


class MoeLM(Family):
    """Decoder-only LM with a routed MLP in every layer: ids [B, S] ->
    float32 logits [B, S, V] (module docstring).  Built on a
    :class:`MoeConfig`; ``cfg`` is its base ``TransformerConfig`` (what
    the caches, decoders and pools read) and :meth:`variant` changes
    both."""

    #: an int8 state is dequantized before it is loaded (module docstring)
    SUPPORTS_QTENSOR = False

    def __init__(self, moe: MoeConfig, device=None, trainable: bool = False):
        super().__init__()
        cfg = moe.base
        self.moe = moe
        self.cfg = cfg
        self.tok_embed = Embed(cfg, device, trainable)
        self.pos_embed = _param((cfg.max_len, cfg.hidden), cfg.dtype, device, trainable)
        self.layers = nn.ModuleList(MoeDecoderLayer(moe, device, trainable)
                                    for _ in range(cfg.n_layers))
        self.ln_final = RMSNorm(cfg, device, trainable)

    @property
    def device(self) -> torch.device:
        return self.ln_final.scale.device

    @staticmethod
    def flax_path(name: str) -> str:
        from tf_operator_tpu_torch.models.weights import name_to_flax_path

        return name_to_flax_path(name)

    def variant(self, **changes):
        v = super().variant(**changes)
        v.moe = dataclasses.replace(self.moe, base=v.cfg)
        return v

    def forward(self, input_ids: torch.Tensor, *, cache: Optional[DecodeCache] = None,
                train: bool = False, with_aux: bool = False):
        """Logits, or (logits, the summed auxiliary loss: under sequence
        parallelism this rank's share) with ``with_aux``.  ``cache``
        (decode configs only: dropless routing) is advanced by the new
        positions; ``train``: a training forward, whose dropout draws
        from ``dropout_rng``."""

        cfg = self.cfg
        check_decode_call(cfg, cache, train)
        rng = self.dropout_generator(train)
        s = input_ids.shape[1]
        x = self.tok_embed(input_ids) + learned_positions(self.pos_embed, s, cache, cfg.dtype,
                                                          sequence_start(cfg, s))
        x = dropout(x, cfg.dropout, rng)
        aux = x.new_zeros((), dtype=torch.float32)
        # the rows' sequence spans the sp line: the slots queue along it.
        # A decode (sp ignored) keeps no auxiliary loss, so its fractions
        # are this rank's own
        sp = sp_line(cfg.mesh) if cfg.sp_enabled and not cfg.decode else None
        group = None if cfg.decode else self.batch_group
        for i, layer in enumerate(self.layers):
            x, layer_aux = layer(x, cache, i, cfg.plain_kernels, cfg.decode, group, rng, sp)
            aux = aux + layer_aux
        if cache is not None:
            cache.advance(s)
        logits = self.tok_embed.attend(self.ln_final(x)).float()
        return (logits, aux) if with_aux else logits


def moe_tiny(vocab_size: int = 1024, max_len: int = 256, num_experts: int = 4,
             **kw) -> MoeConfig:
    """Test scale: 2 layers, hidden 128, 4 heads x 32, MLP 256, 4
    experts; ``kw`` are MoeConfig fields, the rest the base config's."""

    moe_kw = {f.name: kw.pop(f.name) for f in dataclasses.fields(MoeConfig)
              if f.name in kw}
    base = TransformerConfig(vocab_size=vocab_size, hidden=128, n_heads=4, head_dim=32,
                             n_layers=2, mlp_dim=256, max_len=max_len, **kw)
    return MoeConfig(base=base, num_experts=num_experts, **moe_kw)


Batch = Mapping[str, torch.Tensor]


def moe_lm_loss(model: MoeLM, batch: Batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token loss plus the layers' auxiliary losses: float32
    cross-entropy over the B * (S - 1) targets (``xent``,
    ``transformer.next_token_loss``), plus the summed auxiliary loss
    (``moe_aux_loss``); returns (loss, {"token_accuracy", "moe_aux_loss",
    "xent"}).  Under sequence parallelism every term is this rank's
    share, summed by the trainer over the sp line."""

    ids = batch["input_ids"]
    logits, aux = model(ids, train=model.training, with_aux=True)
    xent, acc = next_token_loss(model, ids, logits)
    return xent + aux, {"token_accuracy": acc, "moe_aux_loss": aux.detach(),
                        "xent": xent.detach()}
