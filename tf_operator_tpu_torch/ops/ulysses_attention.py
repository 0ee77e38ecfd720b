"""Ulysses attention: all-to-all sequence parallelism over the mesh's
``sp`` axis (the port of ``tf_operator_tpu/ops/ulysses_attention.py``).

Each rank of an sp line holds its contiguous chunk of the sequence for
every head, [B, H, S/n, D].  One all-to-all a tensor
(:func:`collectives.all_to_all`, ``lax.all_to_all(tiled=True)``) moves
the split from the sequence to the heads: every rank then holds the
WHOLE sequence for H/n of the heads, and attention is independent per
head: ``flash_attention.attention`` (K1 forward, K2/K3 backward through
its autograd on CUDA tensors), with causal and window masks exact
because the whole sequence is there.  One all-to-all on the output
moves the split back.

Gradients flow through :class:`_AllToAll`, whose backward is the
reverse all-to-all (the transpose of a tiled all-to-all).

Under tp (the reference's ``heads_axis="tp"``) a rank holds H / tp of
the query heads, and those local heads are what splits over the sp
line; K and V come at Hkv / tp heads, or, where tp does not divide Hkv,
every KV head, repeated to the full width and cut to the rank's query
heads (``ring_attention.rank_kv_heads``).

GQA: when the rank's KV heads split over the line (``kv_native_a2a``:
(Hkv / tp) % sp == 0), K and V ride the all-to-all at that width and
feed the GQA-native attention; otherwise they are expanded to the
rank's query width first.  The query heads a rank keeps must split over
the line, or the call is refused with the reference's message.

The plain route (``use_flash=False``, the CPU's default) runs
``ops/attention.dot_product_attention`` on the gathered sequence and
counts ``flash_attention.plain_calls["ulysses_attention_plain"]``.
"""

from __future__ import annotations

from typing import Optional

import torch

from tf_operator_tpu_torch.ops import flash_attention as fa
from tf_operator_tpu_torch.ops.attention import (
    dot_product_attention,
    repeat_kv_heads,
    validate_window,
)
from tf_operator_tpu_torch.ops.ring_attention import rank_kv_heads, sp_line
from tf_operator_tpu_torch.parallel.collectives import all_to_all

#: the CollectiveStats stage of the schedule's all-to-alls
STAGE = "ulysses_all_to_all"


class _AllToAll(torch.autograd.Function):
    """The tiled all-to-all over an sp line, split along ``split`` and
    concatenated along ``concat``; its backward swaps the two."""

    @staticmethod
    def forward(ctx, x, line, split, concat):
        ctx.line, ctx.split, ctx.concat = line, split, concat
        return all_to_all(x, line.group, line.stats, STAGE, split_dim=split, concat_dim=concat)

    @staticmethod
    def backward(ctx, g):
        line = ctx.line
        return all_to_all(g.contiguous(), line.group, line.stats, STAGE, split_dim=ctx.concat,
                          concat_dim=ctx.split), None, None, None


def ulysses_applicable(heads_local: int, axis_size: int) -> bool:
    """At least one query head a rank after the all-to-all, and an even
    split."""

    return heads_local >= axis_size and heads_local % axis_size == 0


def ulysses_local(q, k, v, line, *, causal: bool, use_flash: bool, group: int,
                  kv_native_a2a: bool, window: Optional[int] = None) -> torch.Tensor:
    """heads <- sequence all-to-all, attention on the whole sequence,
    sequence <- heads all-to-all (the reference's ``_ulysses_local``)."""

    # [B, H, S/n, D] -> [B, H/n, S, D]: give away head groups, gather
    # the whole sequence for the heads kept
    q = _AllToAll.apply(q, line, 1, 2)
    if not kv_native_a2a:
        k, v = repeat_kv_heads(k, group), repeat_kv_heads(v, group)
    k = _AllToAll.apply(k, line, 1, 2)
    v = _AllToAll.apply(v, line, 1, 2)
    if use_flash:
        o = fa.attention(q, k, v, causal=causal, window=window)
    else:
        fa.plain_calls["ulysses_attention_plain"] += 1
        o = dot_product_attention(q, k, v, causal=causal, window=window)
    # [B, H/n, S, D] -> [B, H, S/n, D]
    return _AllToAll.apply(o, line, 2, 1)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh, *,
                      causal: bool = False, axis_name: str = "sp",
                      kv_whole: bool = False,
                      use_flash: Optional[bool] = None,
                      window: Optional[int] = None) -> torch.Tensor:
    """Exact attention over a sequence split on ``axis_name`` by the
    all-to-all schedule: the drop-in of ``ring_attention`` (the same
    arguments, the same per-rank chunks, the rank's heads of the tp
    axis, the same result; ``kv_whole`` as there, reached by no model
    path).

    Refused where the rank's query heads do not split over the axis.
    ``use_flash``: the flash attention on the gathered sequence (the
    kernels for CUDA tensors, their plain versions for CPU ones); None =
    for CUDA tensors, the plain attention for CPU ones."""

    if kv_whole:
        k, v = rank_kv_heads(q, k, v, mesh)
    h, hkv = q.shape[1], k.shape[1]
    if h % hkv:
        raise ValueError(f"q heads ({h}) must be a multiple of kv heads ({hkv})")
    group = h // hkv
    validate_window(window, causal)
    n = mesh.shape[axis_name]
    if n <= 1:
        return fa.attention(q, k, v, causal=causal, window=window)
    if not ulysses_applicable(h, n):
        raise ValueError(
            f"ulysses_attention needs heads-per-shard divisible by the sp "
            f"axis: {h} local heads over sp={n}; use "
            f"ring_attention for head counts that don't split"
        )
    kv_native_a2a = group == 1 or hkv % n == 0
    if use_flash is None:
        use_flash = q.is_cuda
    return ulysses_local(q, k, v, sp_line(mesh, axis_name), causal=causal,
                         use_flash=use_flash, group=group, kv_native_a2a=kv_native_a2a,
                         window=window)
