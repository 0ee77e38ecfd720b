"""ResNet (the port of ``tf_operator_tpu/models/resnet.py``).

Activations are NHWC at every public face, as in the JAX package.  A
convolution feeds ``F.conv2d`` the ``permute(0, 3, 1, 2)`` view of its
input (channels-last memory, so no copy) and permutes the result back,
so the ``[R, C]`` view the fused norm takes is contiguous.
Convolutions stay cuDNN's (the JAX package leaves them to XLA, outside
any Pallas kernel); master weights are float32 and each is cast to
``dtype`` at use, as ``nn.Conv(dtype=...)`` does.

Padding.  flax's ``"SAME"`` pads ``total = max((ceil(in/s) - 1)*s + k -
in, 0)`` as ``(total // 2, total - total // 2)``: (0, 1) for a 3x3
stride-2 window on an even input, where PyTorch's ``padding=1`` would
take other windows.  :func:`same_padding` computes it; an asymmetric pad
is made explicitly (zeros for a convolution, -inf for the max-pool) and
the op runs with ``padding=0``; a symmetric one is handed to the op
itself, which pads with the same zeros.  The stem's explicit (3, 3)
stays symmetric.

Norms.  ``BatchNorm`` holds the flax variables under their names:
float32 parameters ``scale`` and ``bias``, float32 buffers ``mean``
(zeros) and ``var`` (ones).  In train mode ``norm="fused"`` calls
``ops.fused_batchnorm`` (K5 and K6 on the card) and ``norm="batchnorm"``
runs :func:`stock_batchnorm`, flax ``nn.BatchNorm``'s op order followed
by the residual add and ReLU.  Either updates the running statistics by
flax's rule, ``0.9 * old + 0.1 * batch`` with the biased batch variance
(not ``nn.BatchNorm2d``'s update, which keeps the unbiased one).  Eval
mode is the running-statistics composition whatever ``norm`` is, as in
the JAX package: it has no batch reduction to fuse, and runs no kernel.

State.  Module names are the flax scope names (``conv_init``,
``bn_init``, ``BottleneckBlock_i`` / ``BasicBlock_i`` with ``Conv_j``,
``BatchNorm_j``, ``conv_proj``, ``norm_proj``, and ``head``), so
:func:`resnet_state_from_flax` maps a flax ``{params, batch_stats}``
tree onto ``state_dict()`` keys one to one: convolution kernels HWIO ->
OIHW, the Dense kernel kept ``[in, out]``.  :func:`init_resnet` draws a
seeded state in flax's distributions.

Batch statistics across ranks.  In a job whose batch is split over
ranks (``Trainer`` under a mesh), the trainer hands the model the batch
axes' process group (:meth:`ResNet.set_batch_group`), and the stock
norm all-reduces each batch's sum and sum of squares over it before it
divides: the statistics are the global batch's, as the JAX program's
are under pjit, and the backward reduces their gradients the same way.
The fused norm (K5 / K6) reduces within its launch, one rank's rows, so
it is refused with a group, as the JAX package refuses its Pallas norm
on more than one device.

Not ported yet: the ``space_to_depth`` stem, ``bn_fold`` /
``fold_batchnorm`` (eval-mode folding) and ``bn_param_dtype`` (float32
only).
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tf_operator_tpu_torch.models.weights import _flatten
from tf_operator_tpu_torch.ops.fused_batchnorm import fused_batchnorm

NORMS = ("batchnorm", "fused")
MOMENTUM = 0.9
EPSILON = 1e-5


def same_padding(size: int, k: int, s: int) -> Tuple[int, int]:
    """flax / ``lax.padtype_to_pads`` ``"SAME"`` padding of one spatial
    axis: (low, high)."""

    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def stock_batchnorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float = EPSILON, relu: bool = False,
                    residual: Optional[torch.Tensor] = None, group=None):
    """The stock train-mode graph, differentiated by autograd: flax
    ``nn.BatchNorm``'s op order (float32 fast-variance statistics, float32
    normalize, one cast to x's dtype), then ``residual +``, then ReLU (the
    JAX package's ``_fusedbn_xla``).  Returns ``(y, mean, var)``.
    ``group``: the ranks that hold the rest of the batch (equal row
    counts); the sums are all-reduced over it (module docstring)."""

    red = tuple(range(x.ndim - 1))
    xf = x.float()
    if group is None:
        mean = xf.mean(red)
        mean2 = (xf * xf).mean(red)
    else:
        import torch.distributed as dist
        from torch.distributed.nn.functional import all_reduce

        rows = xf.numel() // xf.shape[-1] * dist.get_world_size(group)
        sums = all_reduce(torch.stack([xf.sum(red), (xf * xf).sum(red)]), group=group)
        mean, mean2 = sums[0] / rows, sums[1] / rows
    var = torch.clamp_min(mean2 - mean * mean, 0.0)
    mul = torch.rsqrt(var + eps) * scale
    y = ((xf - mean) * mul + bias).to(x.dtype)
    if residual is not None:
        y = residual + y
    if relu:
        y = torch.relu(y)
    return y, mean, var


class BatchNorm(nn.Module):
    """Train-mode BatchNorm over the last axis with the block epilogue
    (ReLU, residual add); module docstring."""

    def __init__(self, features: int, *, norm: str = "batchnorm", plain_kernels: bool = False,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.norm, self.plain_kernels, self.dtype = norm, plain_kernels, dtype
        #: the batch axes' process group of a job (None: this rank's rows)
        self.group = None
        self.scale = nn.Parameter(torch.ones(features, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(features, dtype=torch.float32, device=device))
        self.register_buffer("mean", torch.zeros(features, dtype=torch.float32, device=device))
        self.register_buffer("var", torch.ones(features, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor, relu: bool = False,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        if not self.training:
            y = x - self.mean
            mul = torch.rsqrt(self.var + EPSILON) * self.scale
            y = (y * mul + self.bias).to(self.dtype)
            if residual is not None:
                y = residual + y
            return torch.relu(y) if relu else y
        if self.norm == "fused":
            if self.group is not None:
                raise NotImplementedError("the fused norm reduces one rank's rows: it is not "
                                          "ported to a batch split over ranks")
            y, mean, var = fused_batchnorm(
                x, self.scale, self.bias, eps=EPSILON, relu=relu, residual=residual,
                impl="plain" if self.plain_kernels else None)
        else:
            y, mean, var = stock_batchnorm(x, self.scale, self.bias, EPSILON, relu, residual,
                                           self.group)
        with torch.no_grad():
            self.mean.copy_(MOMENTUM * self.mean + (1 - MOMENTUM) * mean)
            self.var.copy_(MOMENTUM * self.var + (1 - MOMENTUM) * var)
        return y


class Conv(nn.Module):
    """flax ``nn.Conv(use_bias=False)`` on NHWC input: a float32 OIHW
    ``kernel`` cast to ``dtype`` at use, ``"SAME"`` padding unless
    ``padding`` is given."""

    #: the kernel's dims in flax's HWIO order (parallel/sharding.py)
    flax_order = {"kernel": (3, 2, 0, 1)}

    def __init__(self, cin: int, features: int, k: int, stride: int = 1, *,
                 padding: Optional[Tuple[int, int]] = None, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.k, self.stride, self.padding, self.dtype = k, stride, padding, dtype
        self.kernel = nn.Parameter(torch.empty(features, cin, k, k, dtype=torch.float32,
                                               device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = [self.padding or same_padding(size, self.k, self.stride)
                for size in x.shape[1:3]]
        sym = all(lo == hi for lo, hi in pads)
        if not sym:
            (hl, hh), (wl, wh) = pads
            x = F.pad(x, (0, 0, wl, wh, hl, hh))
        y = F.conv2d(x.permute(0, 3, 1, 2), self.kernel.to(self.dtype), stride=self.stride,
                     padding=tuple(lo for lo, _ in pads) if sym else 0)
        return y.permute(0, 2, 3, 1)


def max_pool_same(x: torch.Tensor, k: int = 3, s: int = 2) -> torch.Tensor:
    """flax ``nn.max_pool(x, (k, k), (s, s), "SAME")`` on NHWC: -inf
    padding, then the window with ``padding=0``."""

    (hl, hh), (wl, wh) = (same_padding(size, k, s) for size in x.shape[1:3])
    x = F.pad(x, (0, 0, wl, wh, hl, hh), value=float("-inf"))
    return F.max_pool2d(x.permute(0, 3, 1, 2), k, s).permute(0, 2, 3, 1)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``kernel`` [in, out] and ``bias``, float32,
    computed in ``dtype``."""

    def __init__(self, cin: int, features: int, *, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(cin, features, dtype=torch.float32,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(features, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.dtype) @ self.kernel.to(self.dtype) + self.bias.to(self.dtype)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (strided) -> 1x1 x4, each norm with the epilogue the
    JAX block passes; the projection when the shape changes; the last
    norm's scale starts at zero."""

    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int, norm_kw: Dict, device=None):
        super().__init__()
        dt = norm_kw["dtype"]
        out = filters * 4
        self.Conv_0 = Conv(cin, filters, 1, dtype=dt, device=device)
        self.BatchNorm_0 = BatchNorm(filters, **norm_kw, device=device)
        self.Conv_1 = Conv(filters, filters, 3, stride, dtype=dt, device=device)
        self.BatchNorm_1 = BatchNorm(filters, **norm_kw, device=device)
        self.Conv_2 = Conv(filters, out, 1, dtype=dt, device=device)
        if cin != out or stride != 1:
            self.conv_proj = Conv(cin, out, 1, stride, dtype=dt, device=device)
            self.norm_proj = BatchNorm(out, **norm_kw, device=device)
        self.BatchNorm_2 = BatchNorm(out, **norm_kw, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        y = self.BatchNorm_0(self.Conv_0(x), relu=True)
        y = self.BatchNorm_1(self.Conv_1(y), relu=True)
        y = self.Conv_2(y)
        if hasattr(self, "conv_proj"):
            residual = self.norm_proj(self.conv_proj(residual))
        return self.BatchNorm_2(y, relu=True, residual=residual)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int, norm_kw: Dict, device=None):
        super().__init__()
        dt = norm_kw["dtype"]
        self.Conv_0 = Conv(cin, filters, 3, stride, dtype=dt, device=device)
        self.BatchNorm_0 = BatchNorm(filters, **norm_kw, device=device)
        self.Conv_1 = Conv(filters, filters, 3, dtype=dt, device=device)
        if cin != filters or stride != 1:
            self.conv_proj = Conv(cin, filters, 1, stride, dtype=dt, device=device)
            self.norm_proj = BatchNorm(filters, **norm_kw, device=device)
        self.BatchNorm_1 = BatchNorm(filters, **norm_kw, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        y = self.BatchNorm_0(self.Conv_0(x), relu=True)
        y = self.Conv_1(y)
        if hasattr(self, "conv_proj"):
            residual = self.norm_proj(self.conv_proj(residual))
        return self.BatchNorm_1(y, relu=True, residual=residual)


class ResNet(nn.Module):
    """The JAX ``ResNet`` with the ``conv7`` stem.  ``norm``:
    ``"batchnorm"`` (the stock graph) or ``"fused"`` (``ops.fused_batchnorm``);
    ``plain_kernels`` runs the fused norm's plain versions on the card
    (the reference the kernels are held against; ``norm="fused"`` only).
    Input ``[N, H, W, 3]``; float32 logits ``[N, num_classes]``."""

    def __init__(self, stage_sizes: Sequence[int], block: type, num_classes: int = 1000,
                 width: int = 64, dtype: torch.dtype = torch.bfloat16, norm: str = "batchnorm",
                 plain_kernels: bool = False, device=None):
        super().__init__()
        if norm not in NORMS:
            raise ValueError(f"norm must be 'batchnorm'|'fused', got {norm!r}")
        if plain_kernels and norm != "fused":
            raise ValueError("plain_kernels applies to norm='fused' only: an ignored "
                             "request is a silent downgrade")
        self.dtype = dtype
        self.block_names: List[str] = []
        norm_kw = dict(norm=norm, plain_kernels=plain_kernels, dtype=dtype)
        self.conv_init = Conv(3, width, 7, 2, padding=(3, 3), dtype=dtype, device=device)
        self.bn_init = BatchNorm(width, **norm_kw, device=device)
        cin = width
        for i, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                name = f"{block.__name__}_{len(self.block_names)}"
                stride = 2 if i > 0 and j == 0 else 1
                self.add_module(name, block(cin, width * 2**i, stride, norm_kw, device))
                self.block_names.append(name)
                cin = width * 2**i * block.expansion
        self.head = Dense(cin, num_classes, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_init(x.to(self.dtype))
        x = self.bn_init(x, relu=True)
        x = max_pool_same(x)
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = x.mean(dim=(1, 2))
        return self.head(x).float()

    def norms(self) -> List[BatchNorm]:
        return [m for m in self.modules() if isinstance(m, BatchNorm)]

    def set_batch_group(self, group) -> None:
        """Reduce every norm's train-mode statistics over ``group``, the
        ranks holding the rest of the batch (None: this rank's rows)."""

        for bn in self.norms():
            bn.group = group


def resnet18(num_classes: int = 1000, **kw) -> ResNet:
    return ResNet([2, 2, 2, 2], BasicBlock, num_classes, **kw)


def resnet50(num_classes: int = 1000, **kw) -> ResNet:
    return ResNet([3, 4, 6, 3], BottleneckBlock, num_classes, **kw)


def _last_norm(name: str, model: ResNet) -> bool:
    """The norm whose scale starts at zero: each block's last one."""

    scope, _, leaf = name.rpartition(".")
    block, _, norm = scope.partition(".")
    if leaf != "scale" or block not in model.block_names:
        return False
    last = "BatchNorm_2" if isinstance(getattr(model, block), BottleneckBlock) else "BatchNorm_1"
    return norm == last


@torch.no_grad()
def init_resnet(model: ResNet, seed: int) -> ResNet:
    """Fill ``model`` in place from ``torch.Generator(seed)`` in flax's
    distributions: lecun-normal (truncated at 2 sigma, the stddev
    corrected for the truncation) for convolution and head kernels with
    fan-in ``kh * kw * cin`` (``in`` for the head); BatchNorm scale ones,
    zeros at each block's last norm; biases zero; running mean 0, var 1.
    The numbers differ from flax's (another generator); the laws do
    not."""

    dev = next(model.parameters()).device
    g = torch.Generator(device=dev).manual_seed(int(seed))
    for name, p in model.named_parameters():
        if name.endswith(".kernel"):
            fan_in = p.shape[0] if p.ndim == 2 else math.prod(p.shape[1:])
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            torch.nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std, generator=g)
        elif name.endswith(".scale"):
            p.fill_(0.0 if _last_norm(name, model) else 1.0)
        else:
            p.zero_()
    for bn in model.norms():
        bn.mean.zero_()
        bn.var.fill_(1.0)
    return model


def resnet_state_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """A flax ResNet's ``{params, batch_stats}`` as ``ResNet.state_dict()``
    keys (loads with ``strict=True``): scope paths joined by dots,
    convolution kernels HWIO -> OIHW, the Dense kernel ``[in, out]`` as
    it is, ``batch_stats`` mean and var onto the norms' buffers."""

    state = {}
    for collection in ("params", "batch_stats"):
        for path, a in _flatten(variables.get(collection, {})).items():
            a = np.array(a, dtype=np.float32)
            if path.endswith("/kernel") and a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            state[path.replace("/", ".")] = torch.from_numpy(np.ascontiguousarray(a))
    return state
