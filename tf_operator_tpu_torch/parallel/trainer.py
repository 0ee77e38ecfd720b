"""Single-device training loop (the port of
``tf_operator_tpu/parallel/trainer.py`` without its mesh and sharding).

The model holds float32 master parameters (``LlamaLM(...,
trainable=True)``) and computes in ``cfg.dtype``; a step is the loss,
its backward and an optimizer update in place.

The optimizer is the JAX package's optax chain, written out so that it
computes the same numbers:

- ``optax.clip_by_global_norm(c)``: when the global norm n of the
  gradients is >= c, each gradient becomes (g / n) * c (not
  ``torch.nn.utils.clip_grad_norm_``, which adds 1e-6 to n);
- ``optax.adamw(schedule, weight_decay, mask=ndim > 1)``: Adam moments
  with bias correction, eps 1e-8 outside the square root, then the
  decay term added for every parameter of more than one dimension,
  which includes the embedding and the 3-d attention kernels;
- ``optax.sgd(schedule, momentum)``: the trace g + momentum * trace;
- ``optax.warmup_cosine_decay_schedule(0, lr, warmup, max(total,
  warmup + 1))`` when ``warmup_steps > 0``, else a constant: the
  schedule counts optimizer updates from 0, so the first update of a
  warmed-up run has learning rate 0;
- ``optax.MultiSteps(every_k_schedule=accum_steps)``: gradients are
  averaged over k steps (a running mean) and the chain runs on the k-th,
  so the schedule and Adam's count advance once per k steps.

``grad_norm`` in the step's metrics is the global norm of that step's
gradients before clipping, as ``optax.global_norm(grads)`` is.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

#: loss_fn(model, batch) -> (scalar loss, {metric name: scalar tensor})
LossFn = Callable[[torch.nn.Module, Mapping[str, torch.Tensor]],
                  Tuple[torch.Tensor, Dict[str, torch.Tensor]]]

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass
class TrainerConfig:
    learning_rate: float = 1e-3
    weight_decay: float = 1e-4
    #: schedule horizons count OPTIMIZER UPDATES (one per accum_steps
    #: train steps)
    warmup_steps: int = 0
    total_steps: int = 10_000
    grad_clip: float = 1.0
    optimizer: str = "adamw"  # adamw | sgd (adafactor is not ported)
    momentum: float = 0.9
    #: apply the optimizer every k train steps on the mean gradient
    accum_steps: int = 1


def learning_rate_at(cfg: TrainerConfig, count: int) -> float:
    """The learning rate of optimizer update number ``count`` (from 0),
    in float32 as optax computes it."""

    f32 = np.float32
    lr = f32(cfg.learning_rate)
    if cfg.warmup_steps <= 0:
        return float(lr)
    warmup = cfg.warmup_steps
    if count < warmup:
        # linear_schedule(0, lr, warmup): (0 - lr) * (1 - c / w) + lr
        frac = f32(1) - f32(count) / f32(warmup)
        return float((f32(0) - lr) * frac + lr)
    decay_steps = max(cfg.total_steps, warmup + 1) - warmup
    c = f32(min(count - warmup, decay_steps))
    cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(decay_steps)))
    return float(lr * cosine)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, float32, on the
    tensors' device (no host sync)."""

    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class Optimizer:
    """clip -> adamw | sgd, under gradient accumulation (module
    docstring), updating ``params`` in place."""

    def __init__(self, cfg: TrainerConfig, params: List[torch.nn.Parameter]):
        if cfg.optimizer == "adafactor":
            raise NotImplementedError("the adafactor optimizer is not ported")
        if cfg.optimizer not in ("adamw", "sgd"):
            raise ValueError(f"optimizer must be adamw or sgd, got {cfg.optimizer!r}")
        if cfg.accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {cfg.accum_steps}")
        for p in params:
            if p.dtype != torch.float32:
                raise ValueError(f"parameters must be float32 masters, got {p.dtype}")
        self.cfg = cfg
        self.params = params
        self.decay = [p.ndim > 1 for p in params]
        #: optimizer updates applied (the schedule's count)
        self.count = 0
        #: train steps since the last update (MultiSteps' mini_step)
        self.mini_step = 0
        self._acc: Optional[List[torch.Tensor]] = None
        self._mu: Optional[List[torch.Tensor]] = None
        self._nu: Optional[List[torch.Tensor]] = None

    def _zeros(self) -> List[torch.Tensor]:
        return [torch.zeros_like(p) for p in self.params]

    def _clip(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        c = self.cfg.grad_clip
        if not c or c <= 0:
            return grads
        n = global_norm(grads)
        keep = n < c
        return [torch.where(keep, g, (g / n) * c) for g in grads]

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        """One train step's gradients: accumulated, and applied on the
        k-th step."""

        k = self.cfg.accum_steps
        if k > 1:
            if self._acc is None:
                self._acc = self._zeros()
            n_acc = self.mini_step
            for a, g in zip(self._acc, grads):
                a.add_((g - a) / (n_acc + 1))
            self.mini_step = (self.mini_step + 1) % k
            if self.mini_step:
                return
            grads, self._acc = self._acc, None
        self._apply(self._clip(list(grads)))
        self.count += 1

    def _apply(self, grads: List[torch.Tensor]) -> None:
        cfg = self.cfg
        lr = learning_rate_at(cfg, self.count)
        if cfg.optimizer == "sgd":
            if self._mu is None:
                self._mu = self._zeros()
            for p, g, t in zip(self.params, grads, self._mu):
                t.copy_(g + cfg.momentum * t)
                p.add_(-lr * t)
            return
        if self._mu is None:
            self._mu, self._nu = self._zeros(), self._zeros()
        f32 = np.float32
        t = self.count + 1
        bc1 = float(f32(1) - f32(ADAM_B1) ** f32(t))
        bc2 = float(f32(1) - f32(ADAM_B2) ** f32(t))
        for p, g, mu, nu, decay in zip(self.params, grads, self._mu, self._nu, self.decay):
            mu.copy_((1 - ADAM_B1) * g + ADAM_B1 * mu)
            nu.copy_((1 - ADAM_B2) * (g * g) + ADAM_B2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)
            if decay:
                u = u + cfg.weight_decay * p
            p.add_(-lr * u)


def make_optimizer(cfg: TrainerConfig, params: List[torch.nn.Parameter]) -> Optimizer:
    return Optimizer(cfg, params)


class Trainer:
    """``train_step`` / ``eval_step`` / ``benchmark`` over one model on
    one device.  ``loss_fn(model, batch)`` returns (loss, metrics)."""

    def __init__(self, model: torch.nn.Module, cfg: TrainerConfig, loss_fn: LossFn):
        self.model = model.train()
        self.cfg = cfg
        self.loss_fn = loss_fn
        self.params = [p for p in model.parameters() if p.requires_grad]
        if not self.params:
            raise ValueError("the model has no trainable parameters; build it with trainable=True")
        self.device = self.params[0].device
        self.optimizer = make_optimizer(cfg, self.params)
        #: train steps run (host-side: reading a device counter would sync)
        self.host_step = 0

    def _to_device(self, batch) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def compute_grads(self, batch) -> Dict[str, torch.Tensor]:
        """Loss and gradients (left in each parameter's ``.grad``) of one
        batch, without an update.  Returns the step's metrics as device
        tensors: loss, grad_norm (before clipping) and the loss's own."""

        self.model.train()
        for p in self.params:
            p.grad = None
        loss, metrics = self.loss_fn(self.model, self._to_device(batch))
        loss.backward()
        out = {k: v.detach() for k, v in metrics.items()}
        out["loss"] = loss.detach()
        out["grad_norm"] = global_norm([p.grad for p in self.params])
        return out

    def train_step(self, batch) -> Dict[str, torch.Tensor]:
        """One step: loss, backward, optimizer update.  The metrics stay
        on the device; the host does not wait for them."""

        metrics = self.compute_grads(batch)
        self.optimizer.step([p.grad for p in self.params])
        for p in self.params:
            p.grad = None
        self.host_step += 1
        return metrics

    @torch.no_grad()
    def eval_step(self, batch) -> Dict[str, torch.Tensor]:
        """Forward-only metrics on a held-out batch: no gradients, no
        update."""

        self.model.eval()
        try:
            loss, metrics = self.loss_fn(self.model, self._to_device(batch))
        finally:
            self.model.train()
        out = dict(metrics)
        out["loss"] = loss
        return out

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def benchmark(self, batch, steps: int = 20, warmup: int = 3) -> Dict[str, float]:
        """Steps per second on a fixed batch: ``warmup`` steps, then two
        windows of steps, each ending in a synchronise; the slope between
        them is the time per step with every fixed cost cancelled (the
        JAX trainer's two-point protocol)."""

        batch = self._to_device(batch)
        for _ in range(warmup):
            self.train_step(batch)
        self._sync()

        def window(n: int) -> float:
            t0 = time.perf_counter()
            for _ in range(n):
                self.train_step(batch)
            self._sync()
            return time.perf_counter() - t0

        if steps < 3:
            n = max(1, steps)
            dt = window(n) / n
        else:
            n1 = max(1, steps // 6)
            n2 = steps - n1
            t1, t2 = window(n1), window(n2)
            dt = (t2 - t1) / (n2 - n1) if t2 > t1 else t2 / n2
        n_batch = next(iter(batch.values())).shape[0]
        return {"steps_per_sec": 1.0 / dt, "examples_per_sec": n_batch / dt,
                "step_ms": 1e3 * dt}


def batchnorm_cross_entropy_loss(model: torch.nn.Module, batch: Mapping[str, torch.Tensor]
                                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Supervised classification loss of BatchNorm models (ResNet):
    softmax cross-entropy of the model's float32 logits against the
    integer labels, mean over the batch (optax's
    ``softmax_cross_entropy_with_integer_labels``), and the batch's
    accuracy.  The JAX package threads the ``batch_stats`` collection
    through the step; here the statistics are the norms' buffers, which
    a train-mode forward updates, and ``Trainer.eval_step`` runs the
    model in eval mode, reading them and updating nothing."""

    logits = model(batch["image"]).float()
    labels = batch["label"].long()
    loss = torch.nn.functional.cross_entropy(logits, labels)
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, {"accuracy": acc}
