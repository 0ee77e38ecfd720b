"""Fused train-mode BatchNorm (the port of
``tf_operator_tpu/ops/fused_batchnorm.py``).

Replaces the TPU kernels ``tf_operator_tpu/ops/fused_batchnorm.py:166``
``_fwd_kernel`` (K5) and ``:250`` ``_bwd_kernel`` (K6) with the CUDA
kernels in ``csrc/fused_batchnorm.cu``.  The input is any ``[..., C]``
tensor; the statistics reduce over every axis but the last, on the
``[R, C]`` view (R = the product of the leading axes).

K5: ``y = [relu]((x - mean) * (rstd * gamma) + beta [+ residual])`` with
the residual added in float32 before the one cast to x's dtype, and the
float32 batch ``mean`` and biased ``var`` (the fast variance
``max(E[x^2] - mean^2, 0)``) for the caller's running statistics.  K6:
the ReLU mask from the saved ``y > 0`` (zero at the kink), ``dbeta =
sum(g)``, ``dgamma = sum(g * xhat)``, ``dx = gamma * rstd * (g -
sum(g)/R - xhat * sum(g * xhat)/R)`` and ``dres = g``, with rstd
recomputed from the saved var.

The plain versions follow the kernels' op order (``:193-210`` and
``:270-307``), not the JAX package's ``impl="xla"`` composition, which
casts before it adds the residual; the stock composition is
``models/resnet.stock_batchnorm``.

Dispatch (``impl``): ``None`` launches the kernels for a CUDA tensor
and runs the plain versions for a CPU tensor; ``"plain"`` runs the plain
versions.  A CUDA call the kernel cannot take (a dtype other than
float32 or bf16, a residual of another dtype, a non-contiguous input)
raises; nothing falls back.  The JAX kernel also takes a residual of
another dtype (``_Cfg.res_dtype``); ResNet never passes one, and the
kernel here refuses it (the plain version takes any dtype).

``_build.launches`` counts ``fused_batchnorm_fwd`` and
``fused_batchnorm_bwd`` once per kernel call, ``plain_calls`` the plain
versions' calls.  K5 and K6 are each one cooperative launch of a grid
the card holds at once (the occupancy query, :func:`fwd_resources` and
:func:`bwd_resources`); :func:`fwd_plan` and :func:`bwd_plan` set the
row split and the rows each CTA keeps on chip between its sums and its
elementwise pass (K5 x, K6 g and x).
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional, Tuple

import torch

from tf_operator_tpu_torch.ops import _build

KERNEL_FWD = "fused_batchnorm_fwd"
KERNEL_BWD = "fused_batchnorm_bwd"
_SOURCE = "fused_batchnorm"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: channels of one CTA's tile, and the CTA's threads down the rows (the
#: kernels' kTileC and kLanesR)
TILE_C = 64
ROW_LANES = 32

#: plain-version calls since the last ``plain_calls.clear()``
plain_calls: "collections.Counter[str]" = collections.Counter()


def _plan(r: int, c: int, ctas: int, hold_bytes: int, row_bytes: int) -> Tuple[int, int, int]:
    tiles = -(-c // TILE_C)
    chunks = max(1, min(ctas // tiles, r // ROW_LANES))
    rows = -(-r // chunks)
    return -(-r // rows), rows, min(rows, hold_bytes // row_bytes)


def _held_values(r: int, c: int, ctas: int, plan: Tuple[int, int, int]) -> int:
    """Values of one [R, C] tensor a grid of ``ctas`` keeps on chip under
    ``plan``: each CTA keeps the tail of its last item only."""

    chunks, rows, hold_rows = plan
    tiles = -(-c // TILE_C)
    items = tiles * chunks
    held = 0
    for b in range(min(ctas, items)):
        last = b + (items - 1 - b) // ctas * ctas
        chunk, tile = divmod(last, tiles)
        n = min(r, (chunk + 1) * rows) - chunk * rows
        held += min(hold_rows, n) * min(TILE_C, c - tile * TILE_C)
    return held


def fwd_plan(r: int, c: int, ctas: int, hold_bytes: int, elem: int) -> Tuple[int, int, int]:
    """(chunks, rows a chunk, rows held on chip a chunk) of K5 on a grid
    of ``ctas`` CTAs, each keeping up to ``hold_bytes`` of rows of x
    (``TILE_C`` channels, ``elem`` bytes a value) in shared memory.

    The chunks are as many as fill the grid with the channel tiles' work
    items (one item a CTA where the tiles fit), no chunk of fewer than
    ``ROW_LANES`` rows unless R is smaller, no empty chunk; each chunk
    keeps its last rows on chip, as many as fit.  Where the tiles exceed
    the grid a CTA takes several items and keeps the last one's rows.
    The split depends on the grid alone, so every instantiation on the
    same grid adds the same values in the same order."""

    return _plan(r, c, ctas, hold_bytes, TILE_C * elem)


def fwd_held_bytes(r: int, c: int, ctas: int, hold_bytes: int, elem: int) -> int:
    """Bytes of x that K5 keeps on chip between its sums and its
    elementwise pass, over every channel tile."""

    return elem * _held_values(r, c, ctas, fwd_plan(r, c, ctas, hold_bytes, elem))


def bwd_plan(r: int, c: int, ctas: int, hold_bytes: int, elem: int) -> Tuple[int, int, int]:
    """(chunks, rows a chunk, rows held on chip a chunk) of K6: the split
    of :func:`fwd_plan`, each held row being g and x."""

    return _plan(r, c, ctas, hold_bytes, 2 * TILE_C * elem)


def bwd_held_bytes(r: int, c: int, ctas: int, hold_bytes: int, elem: int) -> int:
    """Bytes of g and x that K6 keeps on chip between its sums and its
    elementwise pass, over every channel tile."""

    return 2 * elem * _held_values(r, c, ctas, bwd_plan(r, c, ctas, hold_bytes, elem))


def fused_batchnorm_fwd_plain(x2: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                              eps: float, relu: bool,
                              residual2: Optional[torch.Tensor]):
    """K5's arithmetic in PyTorch: x2 [R, C] -> (y2 in x2's dtype, float32
    mean, float32 biased var)."""

    plain_calls[KERNEL_FWD] += 1
    xf = x2.float()
    inv_n = 1.0 / x2.shape[0]
    mu = xf.sum(0) * inv_n
    var = torch.clamp_min((xf * xf).sum(0) * inv_n - mu * mu, 0.0)
    rstd = torch.rsqrt(var + eps)
    y = (xf - mu) * (rstd * gamma) + beta
    if residual2 is not None:
        y = y + residual2.float()
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.to(x2.dtype), mu, var


def fused_batchnorm_bwd_plain(dy2: torch.Tensor, x2: torch.Tensor, gamma: torch.Tensor,
                              y2: Optional[torch.Tensor], mean: torch.Tensor,
                              var: torch.Tensor, eps: float, relu: bool, has_residual: bool):
    """K6's arithmetic in PyTorch -> (dx2, dgamma, dbeta, dres2 or None);
    dx2 and dres2 in x2's dtype."""

    plain_calls[KERNEL_BWD] += 1
    g = dy2.float()
    if relu:
        g = torch.where(y2 > 0, g, 0.0)
    rstd = torch.rsqrt(var + eps)
    xhat = (x2.float() - mean) * rstd
    sg = g.sum(0)
    sgx = (g * xhat).sum(0)
    inv_n = 1.0 / x2.shape[0]
    dx = (gamma * rstd) * (g - sg * inv_n - xhat * (sgx * inv_n))
    dres = g.to(x2.dtype) if has_residual else None
    return dx.to(x2.dtype), sgx, sg, dres


def _check(name: str, t: torch.Tensor, like: torch.Tensor, shape, dtype) -> None:
    if not t.is_cuda or t.device != like.device:
        raise ValueError(f"fused_batchnorm kernel: {name} is on {t.device}, not on x's "
                         f"CUDA device {like.device}")
    if t.dtype != dtype:
        raise ValueError(f"fused_batchnorm kernel: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"fused_batchnorm kernel: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"fused_batchnorm kernel: {name} is not contiguous (the kernel "
                         "reads the [R, C] view in place and does not copy)")


def _check_x(x2: torch.Tensor) -> None:
    if not x2.is_cuda:
        raise ValueError("fused_batchnorm kernel: x is not on a CUDA device")
    if x2.dtype not in _DTYPE_CODES:
        raise ValueError(f"fused_batchnorm kernel takes float32 or bfloat16 x, got {x2.dtype}")
    if x2.ndim != 2 or x2.shape[0] == 0 or x2.shape[1] == 0:
        raise ValueError(f"fused_batchnorm kernel takes a non-empty [R, C] x, got "
                         f"{tuple(x2.shape)}")
    _check("x", x2, x2, x2.shape, x2.dtype)


def _vector_io(c: int, *tensors: torch.Tensor) -> int:
    """1 when every row is 16-byte aligned: C % 8 == 0 and every [R, C]
    pointer 16-byte aligned (8 channels a thread in 16- or 32-byte
    loads); 0 takes masked scalar loads."""

    return int(c % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


@functools.cache
def _launchers():
    """The C entry points with their argument types declared (pointers
    and the stream as c_void_p, so none is cut to 32 bits)."""

    lib = _build.load(_SOURCE)
    fwd = lib.fused_batchnorm_fwd_launch
    fwd.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_float,
                                                                   ctypes.c_void_p]
    fwd.restype = ctypes.c_int
    bwd = lib.fused_batchnorm_bwd_launch
    bwd.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + [ctypes.c_float,
                                                                    ctypes.c_void_p]
    bwd.restype = ctypes.c_int
    resources = {}
    for kernel in ("fwd", "bwd"):
        res = getattr(lib, f"fused_batchnorm_{kernel}_resources")
        res.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 2
        res.restype = ctypes.c_int
        resources[kernel] = res
    return fwd, bwd, resources


def _resources(kernel: str, dtype_code: int, vec: int, relu: int,
               residual: int) -> Tuple[int, int]:
    ctas, hold = ctypes.c_int(0), ctypes.c_int(0)
    err = _launchers()[2][kernel](dtype_code, vec, relu, residual, ctypes.byref(ctas),
                                  ctypes.byref(hold))
    if err != 0:
        raise RuntimeError(f"fused_batchnorm {kernel} kernel: occupancy query failed: CUDA "
                           f"error {err}")
    return ctas.value, hold.value


@functools.cache
def fwd_resources(dtype_code: int, vec: int, relu: int, residual: int) -> Tuple[int, int]:
    """(CTAs the card holds at once, shared-memory bytes a CTA keeps rows
    in) of the K5 instantiation, from the occupancy query on the current
    device."""

    return _resources("fwd", dtype_code, vec, relu, residual)


@functools.cache
def bwd_resources(dtype_code: int, vec: int, relu: int, residual: int) -> Tuple[int, int]:
    """The same for the K6 instantiation."""

    return _resources("bwd", dtype_code, vec, relu, residual)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def fused_batchnorm_fwd_cuda(x2: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                             eps: float, relu: bool, residual2: Optional[torch.Tensor]):
    """Launch K5 on the current stream, one cooperative launch: x2 [R, C]
    (float32 or bf16, contiguous), gamma and beta float32 [C], residual2
    None or like x2 -> (y2, mean, var).  A launch the card refuses
    raises.  Counts one launch of ``fused_batchnorm_fwd``."""

    _check_x(x2)
    r, c = x2.shape
    for name, t in (("gamma", gamma), ("beta", beta)):
        _check(name, t, x2, (c,), torch.float32)
    if residual2 is not None:
        _check("residual", residual2, x2, x2.shape, x2.dtype)
    y2 = torch.empty_like(x2)
    mean = torch.empty(c, dtype=torch.float32, device=x2.device)
    var = torch.empty_like(mean)
    vec = _vector_io(c, x2, y2, *(() if residual2 is None else (residual2,)))
    code = _DTYPE_CODES[x2.dtype]
    ctas, hold = fwd_resources(code, vec, int(relu), int(residual2 is not None))
    chunks, rows, hold_rows = fwd_plan(r, c, ctas, hold, x2.element_size())
    ws = torch.empty((2 * chunks + 2) * c, dtype=torch.float32, device=x2.device)
    err = _launchers()[0](
        x2.data_ptr(), _ptr(residual2), gamma.data_ptr(), beta.data_ptr(), y2.data_ptr(),
        mean.data_ptr(), var.data_ptr(), ws.data_ptr(),
        code, vec, int(relu), r, c, chunks, rows, hold_rows, ctas, float(eps),
        torch.cuda.current_stream(x2.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_batchnorm forward kernel launch failed: CUDA error {err}")
    _build.launches[KERNEL_FWD] += 1
    return y2, mean, var


def fused_batchnorm_bwd_cuda(dy2: torch.Tensor, x2: torch.Tensor, gamma: torch.Tensor,
                             y2: Optional[torch.Tensor], mean: torch.Tensor,
                             var: torch.Tensor, eps: float, relu: bool, has_residual: bool):
    """Launch K6 on the current stream, one cooperative launch -> (dx2,
    dgamma, dbeta, dres2 or None).  ``y2`` (K5's output) is read for the
    ReLU mask only.  A launch the card refuses raises.  Counts one launch
    of ``fused_batchnorm_bwd``."""

    _check_x(x2)
    r, c = x2.shape
    _check("dy", dy2, x2, x2.shape, x2.dtype)
    if relu:
        if y2 is None:
            raise ValueError("fused_batchnorm kernel: the ReLU backward needs the saved y")
        _check("y", y2, x2, x2.shape, x2.dtype)
    for name, t in (("gamma", gamma), ("mean", mean), ("var", var)):
        _check(name, t, x2, (c,), torch.float32)
    dx2 = torch.empty_like(x2)
    dres2 = torch.empty_like(x2) if has_residual else None
    dgamma = torch.empty(c, dtype=torch.float32, device=x2.device)
    dbeta = torch.empty_like(dgamma)
    vec = _vector_io(c, dy2, x2, dx2, *(t for t in (y2 if relu else None, dres2)
                                        if t is not None))
    code = _DTYPE_CODES[x2.dtype]
    ctas, hold = bwd_resources(code, vec, int(relu), int(has_residual))
    chunks, rows, hold_rows = bwd_plan(r, c, ctas, hold, x2.element_size())
    ws = torch.empty((2 * chunks + 2) * c, dtype=torch.float32, device=x2.device)
    err = _launchers()[1](
        dy2.data_ptr(), x2.data_ptr(), _ptr(y2 if relu else None), gamma.data_ptr(),
        mean.data_ptr(), var.data_ptr(), dx2.data_ptr(), _ptr(dres2), dgamma.data_ptr(),
        dbeta.data_ptr(), ws.data_ptr(),
        code, vec, int(relu), r, c, chunks, rows, hold_rows, ctas, float(eps),
        torch.cuda.current_stream(x2.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_batchnorm backward kernel launch failed: CUDA error {err}")
    _build.launches[KERNEL_BWD] += 1
    return dx2, dgamma, dbeta, dres2


class FusedBatchNormFunction(torch.autograd.Function):
    """(y2, mean, var) with K5 forward and K6 backward (or their plain
    versions).  The cotangents of mean and var are dropped: they are
    bookkeeping outputs for the running statistics (the JAX package's
    VJP contract), and are marked non-differentiable."""

    @staticmethod
    def forward(ctx, x2, gamma, beta, residual2, eps, relu, kernel):
        fwd = fused_batchnorm_fwd_cuda if kernel else fused_batchnorm_fwd_plain
        y2, mean, var = fwd(x2, gamma, beta, eps, relu, residual2)
        ctx.save_for_backward(x2, gamma, y2 if relu else None, mean, var)
        ctx.cfg = (eps, relu, residual2 is not None, kernel)
        ctx.mark_non_differentiable(mean, var)
        return y2, mean, var

    @staticmethod
    def backward(ctx, dy2, _dmean, _dvar):
        x2, gamma, y2, mean, var = ctx.saved_tensors
        eps, relu, has_residual, kernel = ctx.cfg
        bwd = fused_batchnorm_bwd_cuda if kernel else fused_batchnorm_bwd_plain
        # autograd hands dy in the layout the next op's backward chose;
        # no copy where it is contiguous already
        dx2, dgamma, dbeta, dres2 = bwd(dy2.contiguous(), x2, gamma, y2, mean, var, eps,
                                        relu, has_residual)
        return dx2, dgamma, dbeta, dres2, None, None, None


def fused_batchnorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *,
                    eps: float = 1e-5, relu: bool = False,
                    residual: Optional[torch.Tensor] = None, impl: Optional[str] = None):
    """Train-mode BatchNorm over the last axis with the block epilogue:
    ``y = [relu]((x - mean) * rsqrt(var + eps) * gamma + beta [+ residual])``.

    Returns ``(y, mean, var)``: ``y`` in x's dtype and shape, ``mean``
    and ``var`` float32 [C], kept out of any differentiated objective
    (their cotangents are dropped).  ``impl``: ``None`` or ``"plain"``
    (module docstring)."""

    if impl not in (None, "plain"):
        raise ValueError(f"impl must be None or 'plain', got {impl!r}")
    if x.ndim < 2:
        raise ValueError(f"fused_batchnorm needs [..., C] input, got {tuple(x.shape)}")
    c = x.shape[-1]
    if tuple(gamma.shape) != (c,) or tuple(beta.shape) != (c,):
        raise ValueError(f"gamma/beta must be [{c}] to match x {tuple(x.shape)}, got "
                         f"{tuple(gamma.shape)}/{tuple(beta.shape)}")
    if residual is not None and residual.shape != x.shape:
        raise ValueError(f"residual shape {tuple(residual.shape)} != x shape "
                         f"{tuple(x.shape)}")
    kernel = impl is None and x.is_cuda
    if kernel and not (x.is_contiguous()
                       and (residual is None or residual.is_contiguous())):
        raise ValueError("fused_batchnorm kernel: x and the residual must be contiguous "
                         "(the kernel reads the [R, C] view in place and does not copy)")
    x2 = x.reshape(-1, c)
    res2 = residual.reshape(-1, c) if residual is not None else None
    # the parameters enter in float32 outside the Function, as the JAX
    # package casts them outside its custom_vjp
    y2, mean, var = FusedBatchNormFunction.apply(
        x2, gamma.float(), beta.float(), res2, float(eps), bool(relu), kernel)
    return y2.reshape(x.shape), mean, var


def bytes_moved(r: int, c: int, elem: int, relu: bool, residual: bool) -> Tuple[int, int]:
    """(K5, K6) bytes of the least work: K5 reads x (and the residual)
    once and writes y; K6 reads dy, x (and y under ReLU) once and writes
    dx (and dres); the [C] vectors at 4 bytes each."""

    n = r * c * elem
    fwd = n * (2 + residual) + 4 * c * 4
    bwd = n * (3 + relu + residual) + 5 * c * 4
    return fwd, bwd

