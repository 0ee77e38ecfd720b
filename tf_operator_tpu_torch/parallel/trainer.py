"""The training loop (the port of ``tf_operator_tpu/parallel/trainer.py``):
one device, or one device a rank over a mesh of ranks.

The model holds float32 master parameters (``LlamaLM(...,
trainable=True)``) and computes in ``cfg.dtype``; a step is the loss,
its backward and an optimizer update in place.

Under a mesh (``Trainer(..., mesh=make_mesh(...))``, after
``runtime/bootstrap.initialize``) each rank trains on its shard of the
global batch (its rows, ``shard_batch``), as the JAX trainer's jitted
step does over a device mesh:

- ``shardings="fsdp"`` (the auto-rule) or ``"logical"`` (the llama
  family's logical axes) picks each parameter's fsdp dimension
  (``parallel/sharding.py``); a rank keeps only its shard of each such
  float32 master and of its optimizer state, the rest replicated;
  a sharded parameter of the model holds no storage (its shape is
  kept) except while it is in use (``resident_bytes``);
- in a train or eval step each module's sharded weights are gathered
  over fsdp just before its forward and freed just after it; a tensor
  the backward saves that is such a weight (a float32 product saves its
  weight) is kept as a reference and gathered again when the backward
  reads it; each sharded gradient is reduce-scattered to its shard as
  soon as it is complete, and the full gradient and weight are freed
  there.  So a rank holds one module's full weights at a time and never
  every full gradient at once; ``gather`` makes the whole model full
  (``gather_params``, ``export_params``), ``release`` frees it;
- the gradients are summed over the batch axes (dp and fsdp) by the
  grad-sync plan (``parallel/collectives.py``): a sharded parameter's
  is reduce-scattered to its shard, a replicated one's all-reduced
  (``grad_sync="flat"``) or reduced in three stages across slices
  (``"hierarchical"``; ``"auto"`` picks it when the mesh spans slices),
  then divided by the batch ranks: the mean over the global batch;
- the clip's global norm sums the squares of every shard over fsdp, so
  it is the one-device norm, and the clip keeps optax's (g / n) * c;
  the decay mask reads the unsharded ndim;
- the step's loss and metrics are global means, all-reduced on the
  device and left there;
- a model with train-mode batch statistics (ResNet's BatchNorm) is
  given the batch axes' group, so its statistics are the global
  batch's (``set_batch_group``).

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

import contextlib
import dataclasses
import time
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

#: loss_fn(model, batch) -> (scalar loss, {metric name: scalar tensor})
LossFn = Callable[[torch.nn.Module, Mapping[str, torch.Tensor]],
                  Tuple[torch.Tensor, Dict[str, torch.Tensor]]]

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
#: marks a saved tensor kept as a reference to a sharded weight
_SAVED_WEIGHT = object()


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
    docstring), updating ``params`` in place.  ``decay``: the decay mask
    (default ``ndim > 1`` of ``params``; a sharded trainer passes the
    unsharded parameters'); ``norm_fn``: the clip's global norm (a
    sharded trainer's sums over its shards)."""

    def __init__(self, cfg: TrainerConfig, params: List[torch.nn.Parameter],
                 decay: Optional[List[bool]] = None,
                 norm_fn: Callable[[List[torch.Tensor]], torch.Tensor] = None):
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
        self.decay = [p.ndim > 1 for p in params] if decay is None else list(decay)
        self.norm_fn = norm_fn or global_norm
        #: optimizer updates applied (the schedule's count)
        self.count = 0
        #: train steps since the last update (MultiSteps' mini_step)
        self.mini_step = 0
        self._acc: Optional[List[torch.Tensor]] = None
        self._mu: Optional[List[torch.Tensor]] = None
        self._nu: Optional[List[torch.Tensor]] = None

    def _zeros(self) -> List[torch.Tensor]:
        return [torch.zeros_like(p) for p in self.params]

    def _clip(self, grads: List[torch.Tensor],
              norm: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
        c = self.cfg.grad_clip
        if not c or c <= 0:
            return grads
        n = self.norm_fn(grads) if norm is None else norm
        keep = n < c
        return [torch.where(keep, g, (g / n) * c) for g in grads]

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], norm: Optional[torch.Tensor] = None) -> None:
        """One train step's gradients: accumulated, and applied on the
        k-th step.  ``norm``: their global norm, where the caller has it
        (used only when the chain runs on these gradients, k = 1)."""

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
            grads, self._acc, norm = self._acc, None, None
        self._apply(self._clip(list(grads), norm))
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


def _flax_orders(model: torch.nn.Module) -> Dict[str, Tuple[int, ...]]:
    """``{parameter name: order}`` of the tensors a module keeps in
    another layout than flax's (its ``flax_order``; parallel/sharding.py)."""

    out = {}
    for mname, module in model.named_modules():
        for leaf, order in getattr(module, "flax_order", {}).items():
            out[f"{mname}.{leaf}" if mname else leaf] = tuple(order)
    return out


def _flax_key(model: torch.nn.Module, name: str) -> Tuple[str, ...]:
    """The flax path of a parameter as a tuple, the order in which the
    JAX package flattens a param tree (the grad-sync plan's buckets
    follow it)."""

    path = model.flax_path(name) if hasattr(model, "flax_path") else name.replace(".", "/")
    return tuple(path.split("/"))


class Trainer:
    """``train_step`` / ``eval_step`` / ``benchmark`` over one model, on
    one device (``mesh=None``), or one device a rank over ``mesh``
    (module docstring).  ``loss_fn(model, batch)`` returns (loss,
    metrics).  ``shardings``: ``"fsdp"`` or ``"logical"``; ``grad_sync``:
    ``"auto"``, ``"flat"`` or ``"hierarchical"``.  A mesh needs the world it was made in
    (``runtime/bootstrap.initialize``)."""

    def __init__(self, model: torch.nn.Module, cfg: TrainerConfig, loss_fn: LossFn,
                 mesh=None, shardings="fsdp", grad_sync: str = "auto"):
        if grad_sync not in ("auto", "flat", "hierarchical"):
            raise ValueError(f"grad_sync must be auto|flat|hierarchical, got {grad_sync!r}")
        self.model = model.train()
        self.cfg = cfg
        self.loss_fn = loss_fn
        self.mesh = mesh
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        if not self.params:
            raise ValueError("the model has no trainable parameters; build it with trainable=True")
        self.device = self.params[0].device
        #: train steps run (host-side: reading a device counter would sync)
        self.host_step = 0
        self.grad_sync = self.grad_sync_plan = self.specs = None
        #: inside a train or eval step over a mesh (the weight hooks act)
        self._in_step = False
        if mesh is None:
            self.optimizer = make_optimizer(cfg, self.params)
        else:
            self._init_sharded(shardings, grad_sync)

    # -- the mesh ----------------------------------------------------------
    def _init_sharded(self, shardings, grad_sync: str) -> None:
        from tf_operator_tpu_torch.parallel.collectives import build_grad_sync_plan
        from tf_operator_tpu_torch.parallel.mesh import (
            AXIS_FSDP,
            BATCH_AXES,
            data_parallel_size,
            slice_count,
        )
        from tf_operator_tpu_torch.parallel.sharding import (
            check_mesh,
            fsdp_shardings,
            logical_shardings,
            sharded_dim,
        )
        from tf_operator_tpu_torch.runtime.bootstrap import world

        mesh = self.mesh
        check_mesh(mesh)
        rank, world_size = world()
        if mesh.size != world_size:
            raise ValueError(f"a mesh of {mesh.size} ranks in a world of {world_size}")
        shapes = {n: tuple(p.shape) for n, p in zip(self.names, self.params)}
        if shardings == "fsdp":
            specs = fsdp_shardings(shapes, mesh, flax_orders=_flax_orders(self.model))
        elif shardings == "logical":
            specs = logical_shardings(shapes, mesh)
        else:
            raise ValueError(f"shardings must be fsdp|logical, got {shardings!r}")
        self.specs = specs
        self._dims = [sharded_dim(specs[n], mesh) for n in self.names]
        self._fsdp = mesh.shape[AXIS_FSDP]
        self._fsdp_group = mesh.group((AXIS_FSDP,))
        fsdp_index = mesh.index((AXIS_FSDP,), rank)
        #: the ranks the batch is split over, and this rank's shard
        self.batch_ranks = data_parallel_size(mesh)
        self.batch_index = mesh.index(BATCH_AXES, rank)
        self._batch_group = mesh.group(BATCH_AXES)
        #: batch shards replicated across processes (a mesh whose dp x
        #: fsdp is below the world): disjoint per-process data is unsafe
        self._batch_replicated = world_size > 1 and self.batch_ranks < world_size
        #: the indices of the sharded parameters
        self._sharded = [i for i, d in enumerate(self._dims) if d is not None]
        with torch.no_grad():
            #: the float32 masters the optimizer updates: a sharded
            #: parameter's shard (the only copy of its weights this rank
            #: keeps between steps), a replicated one the parameter
            self.masters = [p if d is None else p.detach().chunk(self._fsdp, d)[fsdp_index]
                            .clone(memory_format=torch.contiguous_format)
                            for p, d in zip(self.params, self._dims)]
            for i in self._sharded:
                # storage of its own, which release() frees and gather()
                # refills (a parameter may share a buffer it cannot resize)
                p = self.params[i]
                p.data = torch.empty(p.shape, dtype=p.dtype, device=p.device)
        self.optimizer = Optimizer(self.cfg, self.masters,
                                   decay=[p.ndim > 1 for p in self.params],
                                   norm_fn=self._global_norm)
        if grad_sync == "auto":
            grad_sync = "hierarchical" if slice_count(mesh) > 1 else "flat"
        self.grad_sync = grad_sync
        self._order = sorted(range(len(self.names)),
                             key=lambda i: _flax_key(self.model, self.names[i]))
        self._plan = build_grad_sync_plan(
            [(self.params[i].shape, self.params[i].dtype) for i in self._order],
            [specs[self.names[i]] for i in self._order], mesh, mode=grad_sync)
        #: the hierarchical plan (None under flat sync, as in the JAX trainer)
        self.grad_sync_plan = self._plan if grad_sync == "hierarchical" else None
        #: calls, bytes and host seconds of the step's collectives by stage
        self.collective_stats = self._plan.stats
        self._pos = {i: pos for pos, i in enumerate(self._order)}
        #: the sharded gradients summed in this step's backward, by plan position
        self._done: Dict[int, torch.Tensor] = {}
        #: storage address -> index of each sharded parameter whose full
        #: weight is held now
        self._live: Dict[int, int] = {}
        index = {id(p): i for i, p in enumerate(self.params)}
        sharded = set(self._sharded)
        for module in self.model.modules():
            own = [index[id(p)] for p in module.parameters(recurse=False)
                   if index.get(id(p)) in sharded]
            if own:
                module.register_forward_pre_hook(self._before_module(own))
                module.register_forward_hook(self._after_module(own))
        for i in self._sharded:
            self.params[i].register_post_accumulate_grad_hook(self._grad_ready(i))
        self.release()
        set_group = getattr(self.model, "set_batch_group", None)
        if set_group is not None:
            set_group(self._batch_group)

    def _global_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The global norm of a list aligned with the masters: the squares
        of the sharded entries summed over fsdp, plus the replicated."""

        from tf_operator_tpu_torch.parallel.collectives import all_reduce

        sharded = [g for g, d in zip(grads, self._dims) if d is not None]
        rest = [g for g, d in zip(grads, self._dims) if d is None]
        zero = grads[0].new_zeros((), dtype=torch.float32)
        sq = (torch.stack(torch._foreach_norm(sharded)).square().sum() if sharded else zero)
        all_reduce(sq.reshape(1), self._fsdp_group, self.collective_stats, "norm_all_reduce")
        if rest:
            sq = sq + torch.stack(torch._foreach_norm(rest)).square().sum()
        return torch.sqrt(sq)

    @torch.no_grad()
    def _gather(self, indices: List[int]) -> None:
        """Gather the full weights of the sharded parameters ``indices``
        that hold none now (collective)."""

        from tf_operator_tpu_torch.parallel.collectives import gather_dim

        for i in indices:
            p = self.params[i]
            if p.untyped_storage().nbytes():
                continue
            full = gather_dim(self.masters[i], self._dims[i], self._fsdp_group, self._fsdp,
                              self.collective_stats, "gather_params")
            p.untyped_storage().resize_(p.numel() * p.element_size())
            p.copy_(full)
            self._live[p.untyped_storage().data_ptr()] = i

    def _free(self, indices: List[int]) -> None:
        for i in indices:
            storage = self.params[i].untyped_storage()
            self._live.pop(storage.data_ptr(), None)
            storage.resize_(0)

    def gather(self) -> None:
        """Gather the whole model's full weights over fsdp into its
        parameters (collective; a no-op for those held).  They stay until
        the next train or eval step frees them, or ``release``."""

        if self.mesh is not None:
            self._gather(self._sharded)

    def release(self) -> None:
        """Free the storage of every sharded parameter's full weight (its
        shape is kept): the rank then holds only its shards."""

        if self.mesh is not None:
            self._free(self._sharded)

    def _before_module(self, indices: List[int]):
        def hook(module, args) -> None:
            if self._in_step:
                self._gather(indices)

        return hook

    def _after_module(self, indices: List[int]):
        def hook(module, args, output) -> None:
            if not self._in_step:
                return
            outs = output if isinstance(output, (tuple, list)) else (output,)
            if any(isinstance(t, torch.Tensor) and t.untyped_storage().data_ptr() in self._live
                   for t in outs):
                raise RuntimeError(f"{type(module).__name__} returns a view of a sharded "
                                   "weight, which is freed after its forward")
            self._free(indices)

        return hook

    def _pack(self, t: torch.Tensor):
        """A tensor the backward saves: a sharded weight (or a view of
        one) becomes a reference to it, so that freeing the weight after
        its module's forward leaves the backward what it needs."""

        i = self._live.get(t.untyped_storage().data_ptr()) if t.layout == torch.strided else None
        if i is None:
            return t
        return (_SAVED_WEIGHT, i, t.dtype, t.size(), t.stride(), t.storage_offset())

    def _unpack(self, saved):
        if not (isinstance(saved, tuple) and saved and saved[0] is _SAVED_WEIGHT):
            return saved
        _, i, dtype, size, stride, offset = saved
        self._gather([i])
        p = self.params[i]
        return torch.empty(0, dtype=dtype, device=p.device).set_(
            p.untyped_storage(), offset, size, stride)

    def _grad_ready(self, i: int):
        """The hook run when sharded parameter ``i``'s gradient is
        complete in a train step's backward: reduce-scatter it to this
        rank's shard, then free the full gradient and the full weight
        (no later node of the backward reads either)."""

        def hook(p: torch.nn.Parameter) -> None:
            if not self._in_step:
                return
            self._done[self._pos[i]] = self._plan.apply_leaf(self._pos[i], p.grad)
            p.grad = None
            self._free([i])

        return hook

    def resident_bytes(self) -> Dict[str, int]:
        """Bytes of training state this rank holds on its device, each
        storage counted once: the model's parameters (a released sharded
        parameter holds none), the master shards beside them, and the
        optimizer's moments and accumulator."""

        seen = set()

        def total(tensors) -> int:
            n = 0
            for t in tensors:
                s = t.untyped_storage()
                if s.nbytes() and s.data_ptr() not in seen:
                    seen.add(s.data_ptr())
                    n += s.nbytes()
            return n

        opt = self.optimizer
        state = [t for ts in (opt._mu, opt._nu, opt._acc) if ts for t in ts]
        return {"params": total(self.params), "masters": total(opt.params),
                "optimizer": total(state)}

    def _sync_grads(self) -> List[torch.Tensor]:
        """Each parameter's gradient summed over the batch axes and
        divided by the batch ranks (a sharded one's shard): the mean over
        the global batch, aligned with the masters."""

        done, self._done = self._done, {}
        if len(done) != len(self._sharded):
            raise RuntimeError(f"{len(self._sharded) - len(done)} sharded parameters had no "
                               "gradient in this step's backward")
        summed = self._plan.apply([None if self._dims[i] is not None else self.params[i].grad
                                   for i in self._order], done=done)
        out: List[Optional[torch.Tensor]] = [None] * len(self.params)
        for pos, i in enumerate(self._order):
            out[i] = summed[pos].mul_(1.0 / self.batch_ranks)
        return out  # type: ignore[return-value]

    def _global_means(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Each metric's mean over the batch ranks, reduced on the device."""

        from tf_operator_tpu_torch.parallel.collectives import all_reduce

        keys = sorted(metrics)
        v = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
        all_reduce(v, self._batch_group, self.collective_stats, "metrics_all_reduce")
        v = v / self.batch_ranks
        return {k: v[i] for i, k in enumerate(keys)}

    # -- batches -----------------------------------------------------------
    def _to_device(self, batch) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def shard_batch(self, batch) -> Dict[str, torch.Tensor]:
        """The batch on this rank's device.  One process: ``batch`` is the
        global batch.  Several: each passes its local shard (its rows of
        the global batch, ``batch_index``).  Raises where the mesh
        replicates batch shards across processes: disjoint local data
        would then differ between ranks that must hold the same rows."""

        if self.mesh is not None and self._batch_replicated:
            raise ValueError(
                "shard_batch: this mesh replicates batch shards across "
                "processes (batch shards < processes), so per-process "
                "DISJOINT data would silently diverge — use "
                "shard_global_batch with an identical global batch, or "
                "give the mesh a dp/fsdp extent >= the process count")
        return self._to_device(batch)

    def shard_global_batch(self, batch) -> Dict[str, torch.Tensor]:
        """This rank's rows of an identical global ``batch`` (every
        process passes the same one), on its device."""

        if self.mesh is None:
            return self._to_device(batch)
        out = {}
        for k, v in batch.items():
            v = torch.as_tensor(v)
            local = v.shape[0] // self.batch_ranks
            out[k] = v[self.batch_index * local:(self.batch_index + 1) * local]
        return self._to_device(out)

    # -- steps -------------------------------------------------------------
    def _forward_backward(self, batch) -> Dict[str, torch.Tensor]:
        self.model.train()
        for p in self.params:
            p.grad = None
        saved = (torch.autograd.graph.saved_tensors_hooks(self._pack, self._unpack)
                 if self._in_step else contextlib.nullcontext())
        with saved:
            loss, metrics = self.loss_fn(self.model, self._to_device(batch))
        loss.backward()
        out = {k: v.detach() for k, v in metrics.items()}
        out["loss"] = loss.detach()
        return out

    def compute_grads(self, batch) -> Dict[str, torch.Tensor]:
        """Loss and gradients (left in each parameter's ``.grad``) of one
        batch, without an update.  Returns the step's metrics as device
        tensors: loss, grad_norm (before clipping) and the loss's own.
        Under a mesh: this rank's local gradients and metrics, after the
        gather."""

        self.gather()
        out = self._forward_backward(batch)
        out["grad_norm"] = global_norm([p.grad for p in self.params])
        return out

    def train_step(self, batch) -> Dict[str, torch.Tensor]:
        """One step: loss, backward, optimizer update.  The metrics stay
        on the device; the host does not wait for them."""

        if self.mesh is None:
            metrics = self.compute_grads(batch)
            self.optimizer.step([p.grad for p in self.params])
        else:
            self._in_step = True
            try:
                local = self._forward_backward(batch)
            finally:
                self._in_step = False
            grads = self._sync_grads()
            metrics = self._global_means(local)
            metrics["grad_norm"] = self._global_norm(grads)
            self.optimizer.step(grads, norm=metrics["grad_norm"])
            self.release()
        for p in self.params:
            p.grad = None
        self.host_step += 1
        return metrics

    @torch.no_grad()
    def eval_step(self, batch) -> Dict[str, torch.Tensor]:
        """Forward-only metrics on a held-out batch: no gradients, no
        update (global means under a mesh)."""

        self.model.eval()
        self._in_step = self.mesh is not None
        try:
            loss, metrics = self.loss_fn(self.model, self._to_device(batch))
        finally:
            self._in_step = False
            self.model.train()
        out = dict(metrics)
        out["loss"] = loss
        return out if self.mesh is None else self._global_means(out)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def benchmark(self, batch, steps: int = 20, warmup: int = 3) -> Dict[str, float]:
        """Steps per second on a fixed batch: ``warmup`` steps, then two
        windows of steps, each ending in a synchronise; the slope between
        them is the time per step with every fixed cost cancelled (the
        JAX trainer's two-point protocol).  Under a mesh every rank runs
        it, and examples count the global batch."""

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
        if self.mesh is not None:
            n_batch *= self.batch_ranks
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
