"""Pipeline-parallel causal LM: the transformer's decoder blocks over the
pp axis (the port of ``tf_operator_tpu/models/pipelined_lm.py``).

The decoder layers are split into ``pp`` stages of ``n_layers / pp``
generic ``DecoderLayer``s (``activation``: gpt's ``relu`` or llama's
``swiglu``; the config carries rope, GQA and the attention biases), and
``parallel/pipeline.py``'s GPipe schedule runs them over the pp line.
The embedding, the position table (when not rope), the final RMSNorm and
the tied head (``Embed.attend``) stay outside the pipeline, replicated
over pp.  Each rank builds and keeps only its own stage's layers, so a
rank holds 1 / pp of the block stack (the reference lays the stacked
stages out over the pp axis; a process here is one rank).

Parameters are float32 masters, computed in ``cfg.dtype``.  Their names
follow the reference's tree: ``embed.embedding``, ``pos``, ``ln.scale``
and ``stages.{j}.<layer>`` for layer j of this rank's stage
(``models/weights.pipelined_state_from_flax`` bridges the reference's
stacked [pp, layers a stage, ...] leaves).  The stages run without
dropout, as the reference's (``train=False``).

Under data parallelism (a mesh with dp or fsdp above 1) each pp line
pipelines its own rows: :meth:`PipelinedLM.sync_grads` averages the
gradients over the batch axes and :meth:`PipelinedLM.global_mean` the
loss, which the reference's jitted step gets from its global arrays.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from tf_operator_tpu_torch.models.transformer import (
    DecoderLayer,
    Embed,
    RMSNorm,
    TransformerConfig,
    _param,
)
from tf_operator_tpu_torch.parallel.mesh import AXIS_PP, BATCH_AXES, MODEL_PARALLEL_AXES
from tf_operator_tpu_torch.parallel.pipeline import pipeline_apply

#: the data-parallel gradient sum's stage in the mesh's stats
STAGE_DP_GRADS = "pp_dp_grad_all_reduce"


def _generator(seed: int, stream: int, device) -> torch.Generator:
    state = int(np.random.SeedSequence([int(seed), int(stream)]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(state)


class _Stage(nn.ModuleList):
    """A stage's layers, applied in order (no cache, no dropout)."""

    def forward(self, h: torch.Tensor, plain: bool = False) -> torch.Tensor:
        for layer in self:
            h = layer(h, None, 0, plain)
        return h


class PipelinedLM(nn.Module):
    """ids [B, S] -> float32 logits [B, S, V] through the pipelined
    stages (module docstring).  ``mesh``: the job's mesh with its pp axis
    (None: one stage holding every layer); ``device``: where this rank's
    parameters live.  Parameters start uninitialised: :meth:`init_params`
    draws them, or load a state (``load_state_dict``)."""

    def __init__(self, cfg: TransformerConfig, mesh=None, *, microbatches: int = 4,
                 activation: str = "relu", device=None):
        super().__init__()
        from tf_operator_tpu_torch.runtime.bootstrap import world

        self.cfg = cfg
        self.mesh = mesh
        self.pp = mesh.shape[AXIS_PP] if mesh is not None else 1
        if cfg.n_layers % self.pp:
            raise ValueError(f"n_layers {cfg.n_layers} not divisible by pp {self.pp}")
        if mesh is not None:
            other = [f"{ax}={mesh.shape[ax]}" for ax in MODEL_PARALLEL_AXES + ("sp",)
                     if mesh.shape[ax] > 1]
            if other:
                raise NotImplementedError(f"mesh axes {', '.join(other)}: the port's pipeline "
                                          "composes with the batch axes (dp, fsdp) only")
        self.layers_per_stage = cfg.n_layers // self.pp
        self.microbatches = microbatches
        #: this rank's stage, and the global index of its first layer
        self.stage_index = mesh.index((AXIS_PP,), world()[0]) if self.pp > 1 else 0
        self.first_layer = self.stage_index * self.layers_per_stage
        self.embed = Embed(cfg, device, trainable=True)
        if not cfg.rope:
            # rope families encode position inside attention: no table
            self.pos = _param((cfg.max_len, cfg.hidden), torch.float32, device, True)
        self.ln = RMSNorm(cfg, device, trainable=True)
        self.stages = _Stage(DecoderLayer(cfg, device, trainable=True, activation=activation)
                             for _ in range(self.layers_per_stage))

    @property
    def device(self) -> torch.device:
        return self.ln.scale.device

    @torch.no_grad()
    def init_params(self, seed: int = 0) -> "PipelinedLM":
        """Draw every parameter at the flax init scales
        (``models/weights.draw_param``): the embedding and the position
        table at normal(0.02); layer i (its global index) from a stream
        of its own, so each rank draws only its stage and every pp gives
        the same weights for the same seed."""

        from tf_operator_tpu_torch.models.weights import draw_param

        dev = self.device
        g = _generator(seed, 0, dev)
        for name, p in self.named_parameters():
            if name.startswith("stages."):
                continue
            if name == "pos":
                p.copy_(torch.empty_like(p).normal_(0.0, 0.02, generator=g))
            else:
                p.copy_(draw_param(name, p.shape, g, dev))
        for j, layer in enumerate(self.stages):
            gl = _generator(seed, 1 + self.first_layer + j, dev)
            for name, p in layer.named_parameters():
                p.copy_(draw_param(name, p.shape, gl, dev))
        return self

    def stage_bytes(self) -> int:
        """Bytes of this rank's stage parameters."""

        return sum(p.numel() * p.element_size() for p in self.stages.parameters())

    def _embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        x = self.embed(input_ids)
        if not self.cfg.rope:
            # gate on the config: a model without the table must not
            # train position-blind
            x = x + self.pos[: input_ids.shape[1]].to(self.cfg.dtype)[None]
        return x

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        return self.embed.attend(self.ln(x)).float()

    def _stage_fn(self, params: Dict[str, torch.Tensor], h: torch.Tensor) -> torch.Tensor:
        return torch.func.functional_call(self.stages, params, (h, self.cfg.plain_kernels))

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        x = pipeline_apply(self._stage_fn, dict(self.stages.named_parameters()),
                           self._embed(input_ids), self.mesh,
                           microbatches=self.microbatches, batch_axes=BATCH_AXES)
        return self._head(x)

    def loss(self, input_ids: torch.Tensor) -> torch.Tensor:
        """Mean softmax cross-entropy of the next token over this rank's
        rows (optax's ``softmax_cross_entropy_with_integer_labels``)."""

        return _next_token_loss(self(input_ids), input_ids)

    def _batch_group(self):
        return self.mesh.group(BATCH_AXES) if self.mesh is not None else None

    @torch.no_grad()
    def sync_grads(self) -> None:
        """Average every parameter's gradient over the batch axes (one
        float32 all-reduce of them all); a no-op without dp or fsdp."""

        import torch.distributed as dist

        from tf_operator_tpu_torch.parallel.collectives import all_reduce

        group = self._batch_group()
        if group is None:
            return
        grads = [p.grad for p in self.parameters() if p.grad is not None]
        flat = torch.cat([g.reshape(-1).float() for g in grads])
        all_reduce(flat, group, self.mesh.stats, STAGE_DP_GRADS)
        flat.div_(dist.get_world_size(group))
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))

    @torch.no_grad()
    def global_mean(self, value: torch.Tensor) -> torch.Tensor:
        """``value`` averaged over the batch axes (the global batch's
        mean of a per-rank mean), on the device."""

        import torch.distributed as dist

        from tf_operator_tpu_torch.parallel.collectives import all_reduce

        group = self._batch_group()
        if group is None:
            return value.detach()
        v = value.detach().float().reshape(1).clone()
        all_reduce(v, group, self.mesh.stats, "pp_dp_loss_all_reduce")
        return v[0] / dist.get_world_size(group)


def lm_reference_apply(model: PipelinedLM, input_ids: torch.Tensor) -> torch.Tensor:
    """The same computation without the pipeline (the layers in order over
    the whole batch): the equivalence oracle.  The model must hold every
    layer (one stage)."""

    if model.pp != 1:
        raise ValueError(f"the sequential oracle runs every layer in one process; this model "
                         f"holds stage {model.stage_index} of {model.pp}")
    return model._head(model.stages(model._embed(input_ids), model.cfg.plain_kernels))


def reference_loss(model: PipelinedLM, input_ids: torch.Tensor) -> torch.Tensor:
    """:meth:`PipelinedLM.loss` through :func:`lm_reference_apply`."""

    return _next_token_loss(lm_reference_apply(model, input_ids), input_ids)


def _next_token_loss(logits: torch.Tensor, input_ids: torch.Tensor) -> torch.Tensor:
    v = logits.shape[-1]
    return F.cross_entropy(logits[:, :-1].reshape(-1, v), input_ids[:, 1:].reshape(-1).long())
