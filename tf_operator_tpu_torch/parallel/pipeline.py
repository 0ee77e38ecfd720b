"""Pipeline parallelism: the GPipe schedule over the ``pp`` mesh axis
(the port of ``tf_operator_tpu/parallel/pipeline.py``).

S stages x M microbatches over S + M - 1 ticks.  Rank s of a pp line
holds stage s only (its parameters and its layers); at tick t it applies
its stage to microbatch t - s when 0 <= t - s < M, and every rank then
passes the activation it holds one stage on with one ppermute over the
line (the pairs [(i, i + 1)], no wrap: stage 0 receives zeros, as
``lax.ppermute`` gives it).  The last stage's outputs are then shared
over the line (broadcast from the last rank, bytes as they are: the
reference's ``psum`` of the last stage's outputs and the others'
zeros), so every rank returns the whole output.

Deliberate differences from the reference's one jitted ``shard_map``:

- a rank skips its bubble ticks (t - s outside [0, M)): the reference
  applies its stage to a clamped microbatch there and discards the
  result, so each rank runs its stage M times a forward here, not
  S + M - 1;
- the ppermute runs over process groups (gloo stages a CUDA tensor
  through the host: ``parallel/collectives.py``);
- the backward is written out, in one ``torch.autograd.Function``, so
  that every rank posts its point-to-point pairs in one fixed order: the
  forward keeps each tick's stage graph (the stage's input, detached,
  and its output), and the backward walks the ticks in reverse,
  receiving the output's cotangent from the next stage, running
  ``torch.autograd.grad`` through this stage's layers, and sending the
  input's cotangent back.  The reference's transpose of ``scan`` and
  ``ppermute`` makes the same schedule.

Gradients: the shared output's backward is the identity (every rank
holds the same loss of the same output; the last stage reads its own
cotangent), and the input's cotangent, stage 0's, is shared over the
line (the reference sums it there; every other rank holds zeros), so
the leaves outside the pipeline (embedding, norm, positions) get the
one-device gradient on every rank with no sum over pp.  The
stage parameters' gradients are this rank's stage's.

``x`` is this rank's rows: under data parallelism (``batch_axes``) each
pp line pipelines its own shard of the batch, and a caller sums the
gradients over the batch axes itself.  The reference's refusals hold on
the global batch (rows x the batch axes' size): it must divide into the
microbatches, and a microbatch's rows over the batch axes.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Union

import torch

from tf_operator_tpu_torch.parallel.collectives import broadcast, ppermute
from tf_operator_tpu_torch.parallel.mesh import AXIS_PP

#: stage_fn(stage_params, x) -> y, shape-preserving
StageFn = Callable[[Mapping[str, torch.Tensor], torch.Tensor], torch.Tensor]
#: the stages' collectives, by stage name in the mesh's stats
STAGE_PPERMUTE = "pp_ppermute"
STAGE_SHARE = "pp_share_broadcast"
STAGE_INPUT_GRAD = "pp_input_grad_broadcast"


def stack_stage_params(per_stage_params: Sequence[Mapping[str, torch.Tensor]]
                       ) -> Dict[str, torch.Tensor]:
    """[params_stage0, params_stage1, ...] -> one dict with a leading
    stage dimension on every leaf (the reference's pp-sharded layout)."""

    return {k: torch.stack([p[k] for p in per_stage_params]) for k in per_stage_params[0]}


def _check_batch(x: torch.Tensor, mesh, microbatches: int, batch_axes) -> int:
    """The reference's refusals on the global batch; returns this rank's
    rows a microbatch."""

    axes = () if not batch_axes else (
        (batch_axes,) if isinstance(batch_axes, str) else tuple(batch_axes))
    dp_size = math.prod(mesh.shape[a] for a in axes) if mesh is not None else 1
    batch = x.shape[0] * dp_size
    if batch % microbatches:
        raise ValueError(f"batch {batch} not divisible by microbatches {microbatches}")
    mb = batch // microbatches
    if axes and mb % dp_size:
        raise ValueError(
            f"microbatch rows ({mb}) not divisible by the batch-axis "
            f"mesh size ({dp_size}); batch must be a multiple of "
            f"microbatches x {'x'.join(axes)}"
        )
    return x.shape[0] // microbatches


class _Line:
    """This rank's pp line: its group (None for one stage), size, index
    and the stats its collectives count in."""

    def __init__(self, mesh, axis: str):
        from tf_operator_tpu_torch.runtime.bootstrap import world

        if mesh is None:
            self.group, self.size, self.index, self.stats = None, 1, 0, None
            return
        self.size = mesh.shape[axis]
        self.group = mesh.group((axis,))
        self.index = mesh.index((axis,), world()[0]) if self.size > 1 else 0
        self.stats = mesh.stats


class _GPipe(torch.autograd.Function):
    """y = the schedule's output [M, mb, ...] on every rank of the line
    (module docstring).  ``flat``: this stage's parameter tensors, in
    ``names``' order, so that the engine hands their gradients back."""

    @staticmethod
    def forward(ctx, xs, stage_fn, names, line, keep, *flat):
        s, n, m = line.index, line.size, xs.shape[0]
        params = dict(zip(names, flat))
        ticks = m + n - 1
        held = torch.zeros_like(xs[0])
        ins: List[Optional[torch.Tensor]] = [None] * m
        outs: List[Optional[torch.Tensor]] = [None] * m
        ys = torch.zeros_like(xs)
        for t in range(ticks):
            j = t - s
            out = None
            if 0 <= j < m:
                inp = (xs[j] if s == 0 else held).detach().requires_grad_(keep)
                with torch.set_grad_enabled(keep):
                    out = stage_fn(params, inp)
                if keep:
                    ins[j], outs[j] = inp, out
                if s == n - 1:
                    ys[j] = out.detach()
            if n > 1 and t < ticks - 1:
                held = ppermute(out.detach() if out is not None else torch.zeros_like(held),
                                line.group, line.stats, STAGE_PPERMUTE, wrap=False)
        if n > 1:
            broadcast(ys, n - 1, line.group, line.stats, STAGE_SHARE)
        ctx.line, ctx.ins, ctx.outs = line, ins, outs
        ctx.params = list(flat)
        ctx.xs_shape, ctx.xs_dtype = xs.shape, xs.dtype
        return ys

    @staticmethod
    def backward(ctx, g_ys):
        line, ins, outs, params = ctx.line, ctx.ins, ctx.outs, ctx.params
        s, n, m = line.index, line.size, len(ins)
        ticks = m + n - 1
        wants = [p.requires_grad for p in params]
        grads: List[Optional[torch.Tensor]] = [None] * len(params)
        g_xs = torch.zeros(ctx.xs_shape, dtype=ctx.xs_dtype, device=g_ys.device)
        recv = None
        for t in reversed(range(ticks)):
            j = t - s
            g_in = None
            if 0 <= j < m:
                g_out = g_ys[j] if s == n - 1 else recv
                inputs = [ins[j]] + [p for p, w in zip(params, wants) if w]
                got = torch.autograd.grad(outs[j], inputs, g_out.to(outs[j].dtype),
                                          allow_unused=True)
                g_in = got[0]
                it = iter(got[1:])
                for i, w in enumerate(wants):
                    if not w:
                        continue
                    g = next(it)
                    if g is not None:
                        grads[i] = g if grads[i] is None else grads[i] + g
                ins[j] = outs[j] = None
                if s == 0:
                    g_xs[j] = g_in
            if n > 1 and t > 0:
                recv = ppermute(g_in if g_in is not None else torch.zeros_like(g_xs[0]),
                                line.group, line.stats, STAGE_PPERMUTE, shift=-1, wrap=False)
        if n > 1:
            broadcast(g_xs, 0, line.group, line.stats, STAGE_INPUT_GRAD)
        ctx.ins = ctx.outs = ctx.params = None
        return (g_xs, None, None, None, None, *grads)


def pipeline_apply(stage_fn: StageFn, stage_params: Mapping[str, torch.Tensor],
                   x: torch.Tensor, mesh, *, microbatches: int, axis: str = AXIS_PP,
                   batch_axes: Union[str, Sequence[str], None] = None) -> torch.Tensor:
    """Run ``x`` (this rank's rows [batch, ...]) through the line's
    stages; returns the final output on every rank of the line.

    ``stage_params``: THIS rank's stage's parameters (name -> tensor),
    handed to ``stage_fn(stage_params, h)`` as they are; those that
    require grad get their gradients.  ``x`` is split into
    ``microbatches`` equal microbatches along dim 0; ``stage_fn`` must
    be shape-preserving.  ``mesh`` None (or a pp axis of 1) is one stage.
    ``batch_axes`` names the mesh axes the batch is sharded over: the
    refusals read the global batch (module docstring)."""

    mb = _check_batch(x, mesh, microbatches, batch_axes)
    line = _Line(mesh, axis)
    xs = x.reshape(microbatches, mb, *x.shape[1:])
    names = list(stage_params)
    flat = [stage_params[k] for k in names]
    # keep each tick's graph only where a backward can follow
    keep = torch.is_grad_enabled() and (x.requires_grad or any(p.requires_grad for p in flat))
    ys = _GPipe.apply(xs, stage_fn, names, line, keep, *flat)
    return ys.reshape(x.shape[0], *ys.shape[2:])


def pipelined(stage_fn: StageFn, mesh, microbatches: int, axis: str = AXIS_PP,
              batch_axes=None) -> Callable[[Mapping[str, torch.Tensor], torch.Tensor],
                                           torch.Tensor]:
    """Partial-application convenience: a (params, x) -> y callable."""

    return functools.partial(pipeline_apply, stage_fn, mesh=mesh, microbatches=microbatches,
                             axis=axis, batch_axes=batch_axes)
