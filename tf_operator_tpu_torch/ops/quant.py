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
:func:`quantize_state` over the port's parameter names.  The embedding
is never quantized (the JAX package's default; its int8 gather waits),
and the port has no MoE expert stacks, so neither ``quantize_embed`` nor
``materialize_tree`` is ported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence, Union

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


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def quantize_array(w: torch.Tensor) -> QTensor:
    """Symmetric int8 of ``w`` (read as float32), one scale per index of
    the last axis (the JAX package's default ``reduce_axes``; its other
    use, MoE expert stacks, is not ported)."""

    w32 = w.to(torch.float32)
    amax = w32.abs().amax(dim=tuple(range(w.ndim - 1)), keepdim=True)
    scale = torch.clamp_min(amax, 1e-8) / 127.0
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return QTensor(q=q, scale=scale)


def eligible(name: str, shape: Sequence[int]) -> bool:
    """``quantize_tree``'s rule on a port parameter name: the name ends
    in ``kernel``, and the tensor has >= 2 dims and >= 4096 elements."""

    return (name.rsplit(".", 1)[-1] == "kernel" and len(shape) >= 2
            and math.prod(shape) >= DEFAULT_MIN_SIZE)


State = Mapping[str, Union[torch.Tensor, QTensor]]


def quantize_state(state: State) -> dict:
    """The eligible float kernels of ``state`` as QTensors; every other
    entry is passed through."""

    return {name: quantize_array(t) if not isinstance(t, QTensor) and eligible(name, t.shape)
            else t for name, t in state.items()}


def is_quantized(state: State) -> bool:
    return any(isinstance(t, QTensor) for t in state.values())


def state_bytes(state: State) -> int:
    """Bytes of every tensor and QTensor in ``state`` (``tree_bytes``)."""

    return sum(t.nbytes if isinstance(t, QTensor) else _nbytes(t) for t in state.values())
