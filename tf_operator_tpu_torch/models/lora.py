"""LoRA fine-tuning: low-rank adapters over frozen base weights (the port
of ``tf_operator_tpu/models/lora.py``).

The adapters merge into the base kernels inside every forward,
``W_eff = W + (alpha / r) * (A @ B)``, so the model's products stay the
dense products they were; the merge costs I * r * O operations a kernel
a step.  Gradients reach only A and B: they are the only parameters
that require them.

The integration is a wrapper, not trainer surgery:

    base = LlamaLM.from_state_dict(cfg, state, device, trainable=True)
    lora = LoraModel(base, rank=8)
    trainer = Trainer(lora, TrainerConfig(...), llama_loss)

``LoraModel`` freezes every base parameter (``requires_grad=False``),
so the ``Trainer``'s optimizer state scopes to the adapters.  The base
keeps its float32 storage: the reference merges float32 leaves and
casts once, and a bf16 base would round twice.  ``merged_params`` bakes
trained adapters into a full state for export and serving
(``parallel/checkpoint.export_params`` on a LoRA trainer does so).

Selection mirrors the reference's: parameters named ``kernel`` with >= 2
dimensions and >= ``min_size`` elements, keyed by their flax path; every
axis but the last is the input side (the query kernel [E, H, D] gets
``a`` [E * H, r] and ``b`` [r, D]).  ``a`` ~ N(0, 0.02) and ``b`` = 0,
so the delta starts at exactly zero and step 0 reproduces the base model
bit for bit.  ``a`` is drawn from an explicit ``torch.Generator``, the
adapters in the order of their flax paths (the reference splits a JAX
key over the tree's leaves; the numbers differ, the law does not).
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import torch
from torch import nn

from tf_operator_tpu_torch.models.weights import name_to_flax_path

DEFAULT_MIN_SIZE = 4096


def _selected(name: str, shape, min_size: int) -> bool:
    return (name.split(".")[-1] == "kernel" and len(shape) >= 2
            and math.prod(shape) >= min_size)


def lora_init(base: Mapping[str, torch.Tensor], generator: torch.Generator, rank: int = 8,
              *, min_size: int = DEFAULT_MIN_SIZE, flax_path=name_to_flax_path
              ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Adapters ``{flax path: {"a": [I, r], "b": [r, O]}}`` (float32, on
    the generator's device) for every selected kernel of ``base`` (name
    -> tensor; ``flax_path`` maps a name to its key).  The reference's
    errors: a rank below 1, and a selection that is empty."""

    if rank < 1:
        raise ValueError(f"rank must be >= 1, got {rank}")
    chosen = sorted((tuple(flax_path(n).split("/")), tuple(t.shape)) for n, t in base.items()
                    if _selected(n, tuple(t.shape), min_size))
    if not chosen:
        raise ValueError(
            "no kernels selected for LoRA — check min_size vs the "
            "model's layer sizes"
        )
    device = generator.device
    adapters = {}
    for path, shape in chosen:
        a = torch.empty((math.prod(shape[:-1]), rank), dtype=torch.float32, device=device)
        a.normal_(0.0, 1.0, generator=generator)
        adapters["/".join(path)] = {
            "a": a * 0.02,
            "b": torch.zeros((rank, shape[-1]), dtype=torch.float32, device=device),
        }
    return adapters


def merge_kernel(w: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 alpha: float) -> torch.Tensor:
    """``W + (alpha / r) * (A @ B)`` in float32, cast once to W's dtype."""

    delta = (a @ b).reshape(w.shape) * (alpha / a.shape[-1])
    return (w.float() + delta).to(w.dtype)


def merge_lora(base: Mapping[str, torch.Tensor], adapters, *, alpha: float = 16.0,
               flax_path=name_to_flax_path) -> Dict[str, torch.Tensor]:
    """``base`` (name -> tensor) with each adapted kernel merged
    (:func:`merge_kernel`); the others as they are."""

    out = {}
    for name, w in base.items():
        ab = adapters.get(flax_path(name))
        out[name] = w if ab is None else merge_kernel(w, ab["a"], ab["b"], alpha)
    return out


class _Adapter(nn.Module):
    def __init__(self, a: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.a = nn.Parameter(a)
        self.b = nn.Parameter(b)


class LoraModel(nn.Module):
    """A trainable family (float32 masters) with its base frozen and
    rank-``rank`` adapters as its only trainable parameters
    (``adapters.<flax path>.{a,b}``).  ``forward`` merges and runs the
    family on the merged kernels (``torch.func.functional_call``), as the
    reference's ``apply`` does; it takes the family's arguments.
    ``generator``: the draw of ``a`` (default: seeded 0 on the base's
    device); ``adapters``: start from these instead (``{flax path: {"a",
    "b"}}``)."""

    def __init__(self, model: nn.Module, rank: int = 8, alpha: float = 16.0,
                 min_size: int = DEFAULT_MIN_SIZE, *,
                 generator: Optional[torch.Generator] = None, adapters=None):
        super().__init__()
        for p in model.parameters():
            if p.dtype != torch.float32:
                raise ValueError(f"the base must keep float32 storage (trainable=True), got "
                                 f"{p.dtype}: a merge into bf16 would round twice")
            p.requires_grad_(False)
        self.model = model
        self.alpha = alpha
        base = dict(model.named_parameters())
        path = self._path
        if adapters is None:
            if generator is None:
                generator = torch.Generator(device=next(iter(base.values())).device)
                generator.manual_seed(0)
            adapters = lora_init(base, generator, rank, min_size=min_size, flax_path=path)
        #: flax path -> the base parameter's name
        self.targets = {path(n): n for n in base
                        if _selected(n, tuple(base[n].shape), min_size)}
        if set(adapters) != set(self.targets):
            raise ValueError(f"adapters {sorted(set(adapters) ^ set(self.targets))[:4]} do "
                             "not match the selected kernels")
        self.adapters = nn.ModuleDict({
            k: _Adapter(ab["a"].to(base[self.targets[k]].device, torch.float32),
                        ab["b"].to(base[self.targets[k]].device, torch.float32))
            for k, ab in adapters.items()})

    def _path(self, name: str) -> str:
        fn = getattr(self.model, "flax_path", None)
        return fn(name) if fn is not None else name_to_flax_path(name)

    # the wrapped family's attributes its losses and callers read
    @property
    def cfg(self):
        return self.model.cfg

    @property
    def tp(self):
        return getattr(self.model, "tp", None)

    def adapter_tree(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The adapters as ``{flax path: {"a", "b"}}`` (the live
        parameters)."""

        return {k: {"a": m.a, "b": m.b} for k, m in self.adapters.items()}

    def _merged(self) -> Dict[str, torch.Tensor]:
        base = dict(self.model.named_parameters())
        return {name: merge_kernel(base[name], m.a, m.b, self.alpha)
                for name, m in ((self.targets[k], m) for k, m in self.adapters.items())}

    def forward(self, *args, **kwargs):
        return torch.func.functional_call(self.model, self._merged(), args, kwargs)

    @torch.no_grad()
    def merged_params(self) -> Dict[str, torch.Tensor]:
        """The family's whole state with the trained adapters baked in
        (detached): export it, or build a serving model on it."""

        state = {n: p.detach() for n, p in self.model.named_parameters()}
        state.update(self._merged())
        return state
