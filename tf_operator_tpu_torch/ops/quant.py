"""Weights-only int8 quantization for serving (the port of
``tf_operator_tpu/ops/quant.py``).

A projection kernel becomes a :class:`QTensor`: int8 values in the
kernel's own shape and a symmetric float32 scale per output channel,
max-abs / 127 reduced over every axis but the last.  So the attention
projections' [E, H, D] kernels get one scale per D channel, shared
across heads, and the out projection's [H, D, E] one per E, as in the
JAX package.  The arithmetic is the JAX package's, in its order
(``w32 / scale``, round half to even, clip to +-127, the scale floored at
1e-8 / 127), so the int8 values and scales are equal bit for bit on the
same float32 input.

Quantize from float32: a model's serving storage casts kernels to bf16,
and quantizing that copy gives other int8 values.  ``init_params`` and
``load_npz`` (models/weights.py) hand each kernel here as it is made or
read, in float32, so a 7B float32 tree is never held whole.

The state-dict counterpart of ``quantize_tree`` is
:func:`quantize_state` over the port's parameter names, with the JAX
package's two rules: a projection kernel (scales reduced over every axis
but the last), and a MoE expert stack (``wi`` / ``wo`` of 3 dims, [E,
in, out]: scales reduced over ``in`` only, so each expert keeps its
own).  :func:`materialize_state` is ``materialize_tree``: every QTensor
dequantized to bf16, for a family whose products do not take int8 (the
moe family's expert einsums, ``Family.SUPPORTS_QTENSOR``).  The
embedding is never quantized (the JAX package's default; its int8
gather waits), so ``quantize_embed`` is not ported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional, Sequence, Union

import torch

#: leaves smaller than this stay float (the JAX package's threshold)
DEFAULT_MIN_SIZE = 4096


@dataclasses.dataclass
class QTensor:
    """int8 values in the kernel's shape and a float32 scale shaped
    (1, ..., 1, out) that broadcasts against them."""

    q: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    @property
    def nbytes(self) -> int:
        return _nbytes(self.q) + _nbytes(self.scale)

    def materialize(self, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        """The dequantized values, q x scale in float32, cast once to
        ``dtype``."""

        return (self.q.to(torch.float32) * self.scale).to(dtype)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def quantize_array(w: torch.Tensor, reduce_axes: Optional[Sequence[int]] = None) -> QTensor:
    """Symmetric int8 of ``w`` (read as float32), the max-abs reduced
    over ``reduce_axes``: by default every axis but the last (one scale
    per output channel); (1,) for an expert stack [E, in, out]."""

    if reduce_axes is None:
        reduce_axes = tuple(range(w.ndim - 1))
    w32 = w.to(torch.float32)
    amax = w32.abs().amax(dim=tuple(reduce_axes), keepdim=True)
    scale = torch.clamp_min(amax, 1e-8) / 127.0
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return QTensor(q=q, scale=scale)


def expert_stack(name: str, shape: Sequence[int]) -> bool:
    """A MoE expert stack: ``wi`` or ``wo`` of 3 dims."""

    return name.rsplit(".", 1)[-1] in ("wi", "wo") and len(shape) == 3


def eligible(name: str, shape: Sequence[int]) -> bool:
    """``quantize_tree``'s rule on a port parameter name: >= 4096
    elements, and the name ends in ``kernel`` with >= 2 dims, or the
    tensor is an expert stack."""

    return math.prod(shape) >= DEFAULT_MIN_SIZE and (
        expert_stack(name, shape)
        or (name.rsplit(".", 1)[-1] == "kernel" and len(shape) >= 2))


def quantize_param(name: str, w: torch.Tensor) -> QTensor:
    """An eligible parameter as ``quantize_tree`` quantizes it: per
    expert and output channel for an expert stack, per output channel
    otherwise."""

    return quantize_array(w, reduce_axes=(1,) if expert_stack(name, w.shape) else None)


State = Mapping[str, Union[torch.Tensor, QTensor]]


def quantize_state(state: State) -> dict:
    """The eligible float kernels of ``state`` as QTensors; every other
    entry is passed through."""

    return {name: quantize_param(name, t)
            if not isinstance(t, QTensor) and eligible(name, t.shape)
            else t for name, t in state.items()}


def materialize_state(state: State, dtype: torch.dtype = torch.bfloat16) -> dict:
    """Every QTensor of ``state`` dequantized to ``dtype`` (bf16, as
    ``materialize_tree``); every other entry passed through."""

    return {name: t.materialize(dtype) if isinstance(t, QTensor) else t
            for name, t in state.items()}


def is_quantized(state: State) -> bool:
    return any(isinstance(t, QTensor) for t in state.values())


def state_bytes(state: State) -> int:
    """Bytes of every tensor and QTensor in ``state`` (``tree_bytes``)."""

    return sum(t.nbytes if isinstance(t, QTensor) else _nbytes(t) for t in state.values())
