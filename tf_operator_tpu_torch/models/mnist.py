"""MNIST CNN, the dist-mnist workload (the port of
``tf_operator_tpu/models/mnist.py``).

conv32 (5x5, "SAME") - ReLU - max-pool 2x2 - conv64 - ReLU - max-pool -
dense 1024 - ReLU - dense ``num_classes``, on NHWC input, float32
logits.  Parameters are float32 masters cast to ``dtype`` at use, as
flax's ``dtype=`` does, and keep the flax layout (convolution kernels
HWIO, dense kernels ``[in, out]``), so the weight bridge
(``models/weights.mnist_state_from_flax``) is a renaming.  The JAX
module's dropout (0.5, after the 1024-wide layer) acts only in a
``forward(x, train=True)``, with masks from the model's
``dropout_rng`` (the ``Trainer`` sets it; flax's law,
``models/transformer.dropout``): ``examples/dist_mnist.py`` and
``dist_multislice.py`` apply ``train=False``, and so does this module's
``cross_entropy_loss`` by default, while ``mnist_with_summaries`` trains
through it with ``train=True``, as the JAX trainer's loss passes
``train``.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tf_operator_tpu_torch.models.resnet import Dense
from tf_operator_tpu_torch.models.transformer import dropout


class ConvBias(nn.Module):
    """flax ``nn.Conv(features, (k, k), padding="SAME")`` with its bias:
    an HWIO float32 ``kernel`` and ``bias``, computed in ``dtype``."""

    def __init__(self, cin: int, features: int, k: int, *, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.k, self.dtype = k, dtype
        self.kernel = nn.Parameter(torch.empty(k, k, cin, features, dtype=torch.float32,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(features, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # stride 1, odd k: "SAME" is the symmetric (k - 1) / 2
        y = F.conv2d(x.permute(0, 3, 1, 2), self.kernel.to(self.dtype).permute(3, 2, 0, 1),
                     self.bias.to(self.dtype), padding=(self.k - 1) // 2)
        return y.permute(0, 2, 3, 1)


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.max_pool(x, (2, 2), strides=(2, 2))`` ("VALID") on NHWC."""

    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


class MnistCNN(nn.Module):
    """The classic dist_mnist topology (module docstring); input
    ``[N, 28, 28, 1]``."""

    #: the generator of a training forward's dropout masks
    dropout_rng: Optional[torch.Generator] = None
    #: a training forward's dropout rate (the reference's)
    DROPOUT = 0.5

    def __init__(self, num_classes: int = 10, dtype: torch.dtype = torch.bfloat16,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = ConvBias(1, 32, 5, dtype=dtype, device=device)
        self.Conv_1 = ConvBias(32, 64, 5, dtype=dtype, device=device)
        self.Dense_0 = Dense(7 * 7 * 64, 1024, dtype=dtype, device=device)
        self.Dense_1 = Dense(1024, num_classes, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.to(self.dtype)
        x = _max_pool(torch.relu(self.Conv_0(x)))
        x = _max_pool(torch.relu(self.Conv_1(x)))
        x = x.reshape(x.shape[0], -1)
        x = torch.relu(self.Dense_0(x))
        if train:
            if self.dropout_rng is None:
                raise ValueError("a training forward draws its dropout masks from the "
                                 "model's dropout_rng, and none is set (the Trainer sets it)")
            x = dropout(x, self.DROPOUT, self.dropout_rng)
        return self.Dense_1(x).float()


@torch.no_grad()
def init_mnist(model: MnistCNN, seed: int) -> MnistCNN:
    """Fill ``model`` in place from ``torch.Generator(seed)`` in flax's
    default distributions: lecun-normal kernels (truncated at 2 sigma,
    fan-in = every axis but the last), zero biases.  The numbers differ
    from flax's (another generator); the laws do not."""

    dev = next(model.parameters()).device
    g = torch.Generator(device=dev).manual_seed(int(seed))
    for name, p in model.named_parameters():
        if name.endswith(".kernel"):
            std = math.sqrt(1.0 / math.prod(p.shape[:-1])) / 0.87962566103423978
            torch.nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std, generator=g)
        else:
            p.zero_()
    return model


def cross_entropy_loss(model: nn.Module, batch: Mapping[str, torch.Tensor],
                       train: bool = False) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """optax's ``softmax_cross_entropy_with_integer_labels`` of the
    model's float32 logits against the integer labels, mean over the
    batch, and the batch's accuracy.  The default is the JAX examples'
    ``train=False`` forward; ``train=True`` is the JAX trainer's
    ``cross_entropy_loss``: the forward trains (its dropout acts) in a
    train step and not in ``eval_step``, as the model's mode says."""

    logits = model(batch["image"], train=train and model.training).float()
    labels = batch["label"].long()
    return F.cross_entropy(logits, labels), {
        "accuracy": (logits.argmax(-1) == labels).float().mean()}
