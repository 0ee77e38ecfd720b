"""Tensor and expert parallelism over process groups (port only: the
reference's counterpart is GSPMD's partitioning of its logical rules,
``LOGICAL_RULES`` in ``parallel/sharding.py``, which XLA turns into
collectives; the port makes the same split explicitly).

The layout is Megatron's, the one the reference's rules give: under tp
each rank holds its share of the heads ("heads"), of the MLP columns
("mlp") and of the vocab rows ("vocab"); under ep its share of the
experts ("expert").  Activations of the hidden width stay replicated
along the line, and the batch is replicated along it too.  Four
collectives make a line compute what one device computes:

- :func:`copy_to`: identity forward, all-reduce backward, where a
  replicated activation enters a column-parallel product (the q / k / v
  projections, an MLP's first layer, a vocab-split head): each rank's
  input gradient is its shard's share, and the sum is the whole;
- :func:`reduce_from`: all-reduce forward, identity backward, after a
  row-parallel product (the attention output, an MLP's last layer, the
  experts' combine): each rank's product is a partial sum.  The partials
  are added in float32 and cast back to their dtype once;
- :func:`gather_last`: all-gather along the last dimension forward, this
  rank's part of the gradient backward (the moe router's logits over
  ep, whose softmax needs every expert);
- the vocab-split embedding lookup (:func:`vocab_embed`: ids outside the
  rank's rows look up zeros, then a sum, exact since one rank adds a
  non-zero row), the softmax cross-entropy over vocab-split logits
  (:func:`cross_entropy`: the max, the sum of exponentials and the
  target's logit summed over the line) and its argmax (:func:`argmax`).

Under sequence parallelism beside tp (a mesh with sp and tp above 1)
each rank of a tp line holds the same chunk of the sequence: the lookup
and the cross-entropy act on the chunk's rows as on any rows, and the
loss's count is the whole sequence's (``models/transformer.next_token_loss``).

Gradients of a parameter split over tp or ep are never summed over that
axis, and those of a parameter replicated along it are already equal on
every rank of the line (the trainer's grad-sync plan sums over the batch
axes and sp only).  Every collective counts in the mesh's stats under
``{axis}_all_reduce`` (forward sums), ``{axis}_grad_all_reduce``
(backward sums), ``{axis}_all_gather`` and ``{axis}_loss_all_reduce``,
with ``axis`` ``tp``, ``ep`` or ``ep_tp`` (the two together, the
experts' line under both).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence

import torch
from torch.nn import functional as F

from tf_operator_tpu_torch.parallel.collectives import CollectiveStats, all_gather, all_reduce


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """This rank's line over a model axis (or two): its process group,
    its size, this rank's coordinate on it, and the stats its
    collectives count in."""

    name: str
    group: Any
    size: int
    index: int
    stats: CollectiveStats


def model_axis(mesh, axes: Sequence[str], rank: int) -> Optional[ModelAxis]:
    """``rank``'s line over ``axes`` of ``mesh`` (those of size above 1);
    None where it is one rank."""

    axes = tuple(ax for ax in mesh.axis_names if ax in tuple(axes) and mesh.shape[ax] > 1)
    if not axes:
        return None
    return ModelAxis("_".join(axes), mesh.group(axes), math.prod(mesh.shape[ax] for ax in axes),
                     mesh.index(axes, rank), mesh.stats)


def _sum32(t: torch.Tensor, axis: ModelAxis, stage: str) -> torch.Tensor:
    """``t`` summed over the line in float32, cast back to its dtype."""

    total = t.float().contiguous()
    if total is t:
        total = t.clone()
    all_reduce(total, axis.group, axis.stats, f"{axis.name}_{stage}")
    return total.to(t.dtype)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum32(g, ctx.axis, "grad_all_reduce"), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _sum32(x, axis, "all_reduce")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis, ctx.width = axis, x.shape[-1]
        src = x.movedim(-1, 0).contiguous()
        out = src.new_empty((src.shape[0] * axis.size,) + tuple(src.shape[1:]))
        all_gather(out, src, axis.group, axis.stats, f"{axis.name}_all_gather")
        return out.movedim(0, -1)

    @staticmethod
    def backward(ctx, g):
        i, w = ctx.axis.index, ctx.width
        return g[..., i * w:(i + 1) * w], None


def copy_to(x: torch.Tensor, axis: Optional[ModelAxis]) -> torch.Tensor:
    """``x`` entering column-parallel products on ``axis``: itself, its
    gradient summed over the line (module docstring)."""

    return x if axis is None else _Copy.apply(x, axis)


def reduce_from(x: torch.Tensor, axis: Optional[ModelAxis]) -> torch.Tensor:
    """The partial sums ``x`` of a row-parallel product summed over the
    line in float32 (module docstring); ``x`` itself without a line."""

    return x if axis is None else _Reduce.apply(x, axis)


def gather_last(x: torch.Tensor, axis: Optional[ModelAxis]) -> torch.Tensor:
    """Every rank's ``x`` concatenated along the last dimension in
    coordinate order; the backward keeps this rank's part."""

    return x if axis is None else _GatherLast.apply(x, axis)


def vocab_embed(table: torch.Tensor, ids: torch.Tensor,
                axis: Optional[ModelAxis]) -> torch.Tensor:
    """The rows of ``table`` [V / n, E] (this rank's vocab rows) at
    ``ids``, summed over the line: ids outside the rank's rows look up
    zeros, so the sum is exact."""

    ids = ids.long()
    if axis is None:
        return table[ids]
    v = table.shape[0]
    local = ids - axis.index * v
    inside = (local >= 0) & (local < v)
    rows = table[local.clamp(0, v - 1)]
    return reduce_from(torch.where(inside[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                                       device=rows.device)),
                       axis)


class _VocabCrossEntropy(torch.autograd.Function):
    """Per-row softmax cross-entropy of float32 logits [N, V / n] split
    over the line along the vocab; the backward is (softmax - one-hot)
    on the rank's columns, with no collective."""

    @staticmethod
    def forward(ctx, logits, targets, axis):
        v = logits.shape[-1]
        m = logits.detach().amax(-1)
        all_reduce(m, axis.group, axis.stats, f"{axis.name}_loss_all_reduce", op="max")
        shifted = logits - m[:, None]
        local = targets - axis.index * v
        inside = (local >= 0) & (local < v)
        idx = local.clamp(0, v - 1)
        picked = shifted.gather(1, idx[:, None])[:, 0]
        exp = shifted.exp()
        sums = torch.stack([exp.sum(-1), torch.where(inside, picked, torch.zeros_like(picked))])
        all_reduce(sums, axis.group, axis.stats, f"{axis.name}_loss_all_reduce")
        ctx.save_for_backward(exp / sums[0][:, None], idx, inside)
        return torch.log(sums[0]) - sums[1]

    @staticmethod
    def backward(ctx, g):
        softmax, idx, inside = ctx.saved_tensors
        grad = softmax.scatter_add(1, idx[:, None], -inside.to(softmax.dtype)[:, None])
        return grad * g[:, None], None, None


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor, axis: Optional[ModelAxis],
                  reduction: str = "mean") -> torch.Tensor:
    """``F.cross_entropy(logits, targets, reduction=)`` of float32 logits
    [N, V] whose vocab is split over ``axis`` (each rank's [N, V / n])."""

    if axis is None:
        return F.cross_entropy(logits, targets.long(), reduction=reduction)
    per_row = _VocabCrossEntropy.apply(logits.float(), targets.long(), axis)
    if reduction == "none":
        return per_row
    if reduction == "sum":
        return per_row.sum()
    return per_row.mean()


@torch.no_grad()
def argmax(logits: torch.Tensor, axis: Optional[ModelAxis]) -> torch.Tensor:
    """The argmax over the last dimension of logits split over ``axis``
    along it: the first index of the largest value, as ``argmax`` of the
    whole."""

    if axis is None:
        return logits.argmax(-1)
    v = logits.shape[-1]
    best, idx = logits.max(-1)
    top = best.clone()
    all_reduce(top, axis.group, axis.stats, f"{axis.name}_loss_all_reduce", op="max")
    first = torch.where(best == top, idx + axis.index * v,
                        torch.full_like(idx, torch.iinfo(idx.dtype).max))
    return all_reduce(first, axis.group, axis.stats, f"{axis.name}_loss_all_reduce", op="min")
