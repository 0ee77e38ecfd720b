"""int8 weights-only matmul (the port of
``tf_operator_tpu/ops/quant_matmul.py``).

Replaces the TPU kernel ``tf_operator_tpu/ops/quant_matmul.py:60``
``_kernel`` (launched by ``_quant_matmul_2d``, ``:71``) with the CUDA
kernel K7 in ``csrc/quant_matmul.cu``: ``out[M, N] = cast((x[M, K] @
bf16(q[K, N])) * s[N])``, float32 accumulation and one cast.

Bound.  At the decode shapes (M <= 64 rows) the kernel does 2M flops
per int8 weight byte, below the card's ridge, so its bound is the int8
weight bytes over 3.35 TB/s: 16.8 MB and 5.0 us for a 4096 x 4096
projection, 45.1 MB and 13.5 us for 4096 x 11008, 131 MB and 39.1 us for
the 4096 x 32000 head; the same products in bf16 read twice the bytes.

Range (the JAX package's): the kernel takes M <= 64 rows
(``MAX_GEMV_ROWS``), K % 32 == 0 and N a multiple of one of the JAX
block widths 512, 256, 128.  Outside it the JAX package runs the
output-scale form ``(x @ q.astype(dtype)) * s`` as one XLA dot with
float32 sums; the port runs the same form with ``torch.mm`` asked for
float32 sums (the GEMM route).  The JAX package also gates its kernel
behind ``TPU_OPERATOR_QUANT_KERNEL=1`` on a TPU, a finding about XLA's
fusion barriers there; the port takes the kernel for every CUDA call in
range.

Dispatch: ``impl=None`` routes CUDA tensors to the kernel when the
shape is in range and to the GEMM route when it is not, and runs the
plain version for CPU tensors.  An in-range CUDA call that cannot
launch the kernel raises; nothing falls back to the plain version on
the card.  ``impl="plain"`` asks for the plain version (the reference
the kernel is held against).  ``_build.launches`` counts
``quant_matmul`` (the kernel) and ``quant_matmul_gemm`` (the GEMM
route) where each runs, and ``plain_calls`` the plain version's calls,
so a run on the card can show that no plain version ran on its path.
The first launch of each route and x dtype is recorded in the process
compile ledger (``_build.record_first_launch``, program
``ops.quant_matmul``).
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math
from typing import Optional

import torch

from tf_operator_tpu_torch.ops import _build
from tf_operator_tpu_torch.ops.quant import QTensor

KERNEL = "quant_matmul"
#: launches of the GEMM route (shapes out of the kernel's range, on CUDA)
GEMM = "quant_matmul_gemm"
#: the kernel only below this many activation rows
MAX_GEMV_ROWS = 64
#: the JAX package's N tile widths: N must be a multiple of one of them
BLOCK_N_CANDIDATES = (512, 256, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the compile ledger's program name for the routes' first launches
PROGRAM = "ops.quant_matmul"


def _route_class(route: str, dtype: torch.dtype) -> str:
    return f"route={route},{str(dtype).replace('torch.', '')}"

#: plain-version calls since the last ``plain_calls.clear()``
plain_calls: "collections.Counter[str]" = collections.Counter()


def pick_block_n(n: int) -> Optional[int]:
    for bn in BLOCK_N_CANDIDATES:
        if n % bn == 0:
            return bn
    return None


def in_kernel_range(m: int, k: int, n: int) -> bool:
    """The JAX package's rule for taking the kernel."""

    return pick_block_n(n) is not None and m <= MAX_GEMV_ROWS and k % 32 == 0


def quant_matmul_plain(x2: torch.Tensor, q2: torch.Tensor, s2: torch.Tensor,
                       dtype: torch.dtype) -> torch.Tensor:
    """The plain version: x2 [M, K] and q2 [K, N] upcast to float32 (both
    exact), one float32 product, times the N scales s2, one cast."""

    plain_calls[KERNEL] += 1
    return ((x2.float() @ q2.float()) * s2).to(dtype)


def quant_matmul_gemm(x2: torch.Tensor, q2: torch.Tensor, s2: torch.Tensor,
                      dtype: torch.dtype) -> torch.Tensor:
    """The GEMM route for shapes out of the kernel's range: the
    output-scale form through ``torch.mm`` in ``dtype`` (q2 converted
    eagerly, a temporary copy in ``dtype``), its sums kept in float32
    until after the scale as the JAX dot's are, then one cast."""

    cls = ("gemm", dtype)
    t_first = _build.first_launch(PROGRAM, cls)
    out = (torch.mm(x2, q2.to(dtype), out_dtype=torch.float32) * s2).to(dtype)
    _build.launches[GEMM] += 1
    if t_first is not None:
        _build.record_first_launch(PROGRAM, cls, _route_class(*cls), t_first, (x2, q2))
    return out


def _check_kernel_inputs(x2, q2, s2) -> None:
    m, k = x2.shape
    n = q2.shape[1]
    for name, t in (("x", x2), ("q", q2), ("scale", s2)):
        if not t.is_cuda:
            raise ValueError(f"quant_matmul kernel: {name} is not on a CUDA device")
        if t.device != x2.device:
            raise ValueError(f"quant_matmul kernel: {name} is on {t.device}, x on {x2.device}")
        if not t.is_contiguous():
            raise ValueError(f"quant_matmul kernel: {name} is not contiguous")
        # the bf16 kernel copies q, and bf16 x of up to 16 rows, in 16-byte
        # chunks; it reads bf16 x of more rows in 4-byte words, and the
        # float32 kernel float32 x in floats (q is held to 16 bytes for both)
        wide = name == "q" or (name == "x" and t.dtype == torch.bfloat16 and m <= 16)
        align = 16 if wide else 4
        if t.data_ptr() % align:
            raise ValueError(f"quant_matmul kernel: {name} does not start on a "
                             f"{align}-byte boundary")
    if x2.dtype not in _DTYPE_CODES:
        raise ValueError(f"quant_matmul kernel takes float32 or bfloat16 x, got {x2.dtype}")
    if q2.dtype != torch.int8 or s2.dtype != torch.float32:
        raise ValueError(f"quant_matmul kernel: q must be int8 and the scale float32, "
                         f"got {q2.dtype} and {s2.dtype}")
    if q2.shape[0] != k or s2.numel() != n:
        raise ValueError(f"quant_matmul kernel: x {tuple(x2.shape)}, q {tuple(q2.shape)} and "
                         f"scale {tuple(s2.shape)} do not match")
    if not in_kernel_range(m, k, n):
        raise ValueError(
            f"quant_matmul kernel: M={m}, K={k}, N={n} is out of its range (M <= "
            f"{MAX_GEMV_ROWS}, K % 32 == 0, N a multiple of one of {BLOCK_N_CANDIDATES})")


@functools.cache
def _launcher():
    """The kernel's C entry point with its argument types declared
    (pointers and the stream as c_void_p, so none is cut to 32 bits)."""

    fn = _build.load(KERNEL).quant_matmul_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def quant_matmul_cuda(x2: torch.Tensor, q2: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
    """Launch K7 on the current stream: x2 [M, K] (float32 or bf16),
    q2 [K, N] int8, s2 N float32 scales -> [M, N] in x2's dtype.  Counts
    one launch in ``_build.launches[KERNEL]``."""

    _check_kernel_inputs(x2, q2, s2)
    m, k = x2.shape
    n = q2.shape[1]
    out = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    if m == 0:
        return out
    launch = _launcher()
    cls = ("kernel", x2.dtype)
    t_first = _build.first_launch(PROGRAM, cls)
    err = launch(
        x2.data_ptr(), q2.data_ptr(), s2.data_ptr(), out.data_ptr(),
        _DTYPE_CODES[x2.dtype], m, k, n,
        torch.cuda.current_stream(x2.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"quant_matmul kernel launch failed: CUDA error {err}")
    _build.launches[KERNEL] += 1
    if t_first is not None:
        _build.record_first_launch(PROGRAM, cls, _route_class(*cls), t_first, (x2, q2))
    return out


def quant_matmul_2d(x2: torch.Tensor, q2: torch.Tensor, s2: torch.Tensor,
                    dtype: torch.dtype, impl: Optional[str] = None) -> torch.Tensor:
    """x2 [M, K] (cast to ``dtype`` first) @ q2 [K, N] int8 * s2 (N
    float32 scales, [N] or [1, N]) -> [M, N] in ``dtype`` on every route
    of the module docstring.  The counterpart of the JAX package's
    ``_quant_matmul_2d`` and of its output-scale form;
    models/transformer.DenseGeneral calls it with operands it prepared
    once, so a decode step pays no reshapes here."""

    if impl not in (None, "plain"):
        raise ValueError(f"impl must be None or 'plain', got {impl!r}")
    if x2.dtype != dtype:
        x2 = x2.to(dtype)
    if impl == "plain" or not x2.is_cuda:
        return quant_matmul_plain(x2, q2, s2, dtype)
    if in_kernel_range(x2.shape[0], x2.shape[1], q2.shape[1]):
        return quant_matmul_cuda(x2.contiguous(), q2, s2)
    return quant_matmul_gemm(x2, q2, s2, dtype)


def quant_matmul(x: torch.Tensor, qt: QTensor, dtype: torch.dtype = torch.bfloat16, *,
                 impl: Optional[str] = None) -> torch.Tensor:
    """``x @ qt`` with the weight read as int8.

    x: [..., K]; qt.q: [K, *features] int8 with a per-output-channel
    scale over the last axis.  Contraction is over x's last axis and
    q's first; callers contracting several axes reshape first.  Returns
    [..., *features] in ``dtype`` (module docstring for the routes)."""

    q, s = qt.q, qt.scale
    k = x.shape[-1]
    feat = tuple(q.shape[1:])
    n = math.prod(feat)
    per_channel = bool(feat) and s.numel() == feat[-1]
    if not per_channel:
        raise ValueError(
            f"quant_matmul needs a per-output-channel scale over the last "
            f"axis; got scale shape {tuple(s.shape)} for kernel {tuple(q.shape)}"
        )
    # one scale per FLATTENED output channel: the per-channel scale
    # repeated over the leading feature axes
    s2 = s.reshape(-1).expand(feat).reshape(n).to(torch.float32)
    out = quant_matmul_2d(x.reshape(-1, k), q.reshape(k, n), s2, dtype, impl)
    return out.reshape(*x.shape[:-1], *feat)
