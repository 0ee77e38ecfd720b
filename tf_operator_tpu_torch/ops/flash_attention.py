"""Flash attention: forward, dQ and dK/dV (the port of
``tf_operator_tpu/ops/flash_attention.py``).

Layout: q [B, H, Sq, D]; k, v [B, Hkv, Sk, D] with H % Hkv == 0; the
row logsumexp ``lse`` and ``delta = rowsum(dO * O)`` are [B, H, Sq]
float32.  Logits are (q * scale) . k with scale = 1/sqrt(D); ``causal``
keeps qpos >= kpos with both counted from 0 (top-left aligned, whatever
Sq and Sk are); ``window`` (needs ``causal``) also keeps
qpos - kpos < window; masked logits are finfo(float32).min.

Three functions, each with a plain PyTorch version beside its CUDA
kernel (``csrc/flash_attention.cu``):

- forward -> (out, lse): the softmax in float32, out divided by
  max(l, 1e-37), lse = m + log(max(l, 1e-37)) (K1);
- dQ = scale * sum_k p * (dO . v - delta) . k, with p = exp(logit - lse)
  from the saved lse (K2);
- dK = ds^T . (q * scale), dV = p^T . dO at Hkv width, summed over the
  query heads of each group (K3).

The backward entry points take lse and delta, and ``grad_dtype``
(float32 partials for a caller that sums them), as
``_flash_backward_blocks`` does.

Dispatch: ``impl=None`` launches the kernel for CUDA tensors and runs
the plain version for CPU tensors.  There is no fallback: a CUDA tensor
reaches the kernel or the call raises.  ``impl="plain"`` asks for the
plain version (the reference the kernels are held against), ``"cuda"``
for the kernel.  :func:`attention` sends calls with a bias or a mask to
``ops/attention.dot_product_attention``, as the JAX dispatcher does.

``plain_calls`` counts calls of the plain versions (and of the
dispatcher's masked route) by name, so a run on the card can show that
no plain attention ran on its path.  The first launch of each kernel's
(causal / window, dtype) class is recorded in the process compile
ledger (``_build.record_first_launch``, program
``ops.flash_attention``).
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from tf_operator_tpu_torch.ops import _build
from tf_operator_tpu_torch.ops.attention import (
    NEG_FILL,
    dot_product_attention,
    validate_window,
)

SOURCE = "flash_attention"
KERNEL_FWD = "flash_attention_fwd"
KERNEL_DQ = "flash_attention_bwd_dq"
KERNEL_DKV = "flash_attention_bwd_dkv"
FLASH_IMPLS = ("plain", "cuda")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the compile ledger's program name for the kernels' variant classes
PROGRAM = "ops.flash_attention"

#: plain-version calls by name since the last ``plain_calls.clear()``
plain_calls: "collections.Counter[str]" = collections.Counter()


def _resolve(impl: Optional[str], t: torch.Tensor) -> str:
    if impl is None:
        return "cuda" if t.is_cuda else "plain"
    if impl not in FLASH_IMPLS:
        raise ValueError(f"impl must be None or one of {FLASH_IMPLS}, got {impl!r}")
    return impl


# -- plain versions ---------------------------------------------------------


def _logits(q, k, causal: bool, window: Optional[int]) -> torch.Tensor:
    """float32 masked logits [B, Hkv, group, Sq, Sk]."""

    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(d)
    qg = q.float().reshape(b, hkv, h // hkv, sq, d) * scale
    logits = torch.matmul(qg, k.float()[:, :, None].transpose(-1, -2))
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None]
        kpos = torch.arange(sk, device=q.device)[None, :]
        visible = qpos >= kpos
        if window is not None:
            visible &= qpos - kpos < window
        logits = torch.where(visible, logits, NEG_FILL)
    return logits


def _check_heads(q, k, v) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(
            f"flash attention layout: q [B,H,Sq,D], k/v [B,Hkv,Sk,D]; got "
            f"q{tuple(q.shape)}, k{tuple(k.shape)}, v{tuple(v.shape)}"
        )
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"q heads ({q.shape[1]}) must be a multiple of kv heads ({k.shape[1]})")


def flash_forward_plain(q, k, v, causal: bool = False,
                        window: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's function in plain PyTorch: (out in q's dtype, lse float32)."""

    plain_calls[KERNEL_FWD] += 1
    validate_window(window, causal)
    _check_heads(q, k, v)
    b, h, sq, d = q.shape
    logits = _logits(q, k, causal, window)
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-37)
    out = torch.matmul(p, v.float()[:, :, None]) / l
    lse = (m + torch.log(l))[..., 0]
    return out.reshape(b, h, sq, d).to(q.dtype), lse.reshape(b, h, sq)


def _probs_and_ds(q, k, v, do, lse, delta, causal, window):
    b, h, sq, d = q.shape
    hkv = k.shape[1]
    g = h // hkv
    logits = _logits(q, k, causal, window)
    p = torch.exp(logits - lse.float().reshape(b, hkv, g, sq, 1))
    dof = do.float().reshape(b, hkv, g, sq, d)
    dp = torch.matmul(dof, v.float()[:, :, None].transpose(-1, -2))
    ds = p * (dp - delta.float().reshape(b, hkv, g, sq, 1))
    return p, ds, dof


def flash_backward_dq_plain(q, k, v, do, lse, delta, causal: bool = False,
                            window: Optional[int] = None,
                            grad_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """K2's function in plain PyTorch: dq [B, H, Sq, D]."""

    plain_calls[KERNEL_DQ] += 1
    validate_window(window, causal)
    _check_heads(q, k, v)
    b, h, sq, d = q.shape
    _, ds, _ = _probs_and_ds(q, k, v, do, lse, delta, causal, window)
    dq = torch.matmul(ds, k.float()[:, :, None]) * (1.0 / math.sqrt(d))
    return dq.reshape(b, h, sq, d).to(grad_dtype or q.dtype)


def flash_backward_dkv_plain(q, k, v, do, lse, delta, causal: bool = False,
                             window: Optional[int] = None,
                             grad_dtype: Optional[torch.dtype] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's function in plain PyTorch: (dk, dv) [B, Hkv, Sk, D], each
    summed over the query heads of its group."""

    plain_calls[KERNEL_DKV] += 1
    validate_window(window, causal)
    _check_heads(q, k, v)
    b, h, sq, d = q.shape
    p, ds, dof = _probs_and_ds(q, k, v, do, lse, delta, causal, window)
    qs = q.float().reshape(b, k.shape[1], h // k.shape[1], sq, d) * (1.0 / math.sqrt(d))
    dv = torch.matmul(p.transpose(-1, -2), dof).sum(2)
    dk = torch.matmul(ds.transpose(-1, -2), qs).sum(2)
    return dk.to(grad_dtype or k.dtype), dv.to(grad_dtype or v.dtype)


# -- CUDA kernels -----------------------------------------------------------


def _check_kernel_inputs(name, q, k, v, rows=(), grads=()) -> None:
    _check_heads(q, k, v)
    for label, t in (("q", q), ("k", k), ("v", v), *grads, *rows):
        if not t.is_cuda:
            raise ValueError(f"{name} kernel: {label} is not on a CUDA device")
        if t.device != q.device:
            raise ValueError(f"{name} kernel: {label} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel: {label} is not contiguous")
        if t.data_ptr() % 16:
            # TMA and the 16-byte copies read from a 16-byte boundary
            raise ValueError(f"{name} kernel: {label} does not start on a 16-byte boundary")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name} kernel takes float32 or bfloat16, got {q.dtype}")
    for label, t in (("k", k), ("v", v), *grads):
        if t.dtype != q.dtype:
            raise ValueError(f"{name} kernel: {label} is {t.dtype}, q is {q.dtype}")
    b, h, sq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"{name} kernel: k{tuple(k.shape)} does not match q{tuple(q.shape)}")
    if d % 32 or not 32 <= d <= 128:
        raise ValueError(f"{name} kernel: head_dim must be 32, 64, 96 or 128, got {d}")
    if sq < 1 or k.shape[2] < 1:
        raise ValueError(f"{name} kernel: empty sequence (Sq={sq}, Sk={k.shape[2]})")
    for label, t in grads:
        if t.shape != q.shape:
            raise ValueError(f"{name} kernel: {label}{tuple(t.shape)} != q{tuple(q.shape)}")
    for label, t in rows:
        if t.dtype != torch.float32 or tuple(t.shape) != (b, h, sq):
            raise ValueError(f"{name} kernel: {label} must be float32 [B, H, Sq]")


@functools.cache
def _launchers():
    """The kernels' C entry points with their argument types declared
    (pointers and the stream as c_void_p, so none is cut to 32 bits)."""

    lib = _build.load(SOURCE)
    i, p = ctypes.c_int, ctypes.c_void_p
    fwd = lib.flash_fwd_launch
    fwd.argtypes = [p] * 5 + [i] * 9 + [ctypes.c_float, p]
    dq = lib.flash_bwd_dq_launch
    dq.argtypes = [p] * 7 + [i] * 10 + [ctypes.c_float, p]
    dkv = lib.flash_bwd_dkv_launch
    dkv.argtypes = [p] * 8 + [i] * 10 + [ctypes.c_float, p]
    for fn in (fwd, dq, dkv):
        fn.restype = ctypes.c_int
    return fwd, dq, dkv


def hopper_smem_bytes(kernel: int, head_dim: int) -> int:
    """The dynamic shared memory (bytes) that K1's (``kernel`` 0), K2's
    (1) or K3's (2) Hopper kernel asks for at ``head_dim``."""

    fn = _build.load(SOURCE).flash_hopper_smem_bytes
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(kernel, head_dim)


def _shape_args(q, k, causal, window):
    b, h, sq, d = q.shape
    return (b, h, k.shape[1], sq, k.shape[2], d, int(causal),
            0 if window is None else int(window), 1.0 / math.sqrt(d))


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")


def _launch(which: int, kernel: str, q, causal, window, *args) -> None:
    """Launch kernel ``which`` of :func:`_launchers` with ``args``; count
    it, and record the first launch of its (causal / window, dtype)
    class in the compile ledger."""

    fn = _launchers()[which]
    cls = (kernel, bool(causal), window, q.dtype)
    t_first = _build.first_launch(PROGRAM, cls)
    _raise_on(fn(*args), kernel)
    _build.launches[kernel] += 1
    if t_first is not None:
        mask = f"window={window}" if window is not None else (
            "causal" if causal else "full")
        _build.record_first_launch(
            PROGRAM, cls, f"{kernel},{mask},{str(q.dtype).replace('torch.', '')}",
            t_first, (q,))


def _grad_out(t: torch.Tensor, grad_dtype: Optional[torch.dtype]):
    if grad_dtype not in (None, torch.float32, t.dtype):
        raise ValueError(f"grad_dtype must be None, float32 or {t.dtype}, got {grad_dtype}")
    dt = grad_dtype or t.dtype
    return torch.empty(t.shape, dtype=dt, device=t.device), int(dt == torch.float32)


def flash_forward_cuda(q, k, v, causal: bool = False, window: Optional[int] = None):
    """Launch K1 on the current stream: (out, lse).  Counts one launch
    in ``_build.launches[KERNEL_FWD]``."""

    validate_window(window, causal)
    _check_kernel_inputs("flash forward", q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _launch(
        0, KERNEL_FWD, q, causal, window,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        _DTYPE_CODES[q.dtype], *_shape_args(q, k, causal, window),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    return out, lse


def flash_backward_dq_cuda(q, k, v, do, lse, delta, causal: bool = False,
                           window: Optional[int] = None,
                           grad_dtype: Optional[torch.dtype] = None):
    """Launch K2 on the current stream: dq.  Counts one launch in
    ``_build.launches[KERNEL_DQ]``."""

    validate_window(window, causal)
    _check_kernel_inputs("flash dq", q, k, v, rows=(("lse", lse), ("delta", delta)),
                         grads=(("dO", do),))
    dq, out_f32 = _grad_out(q, grad_dtype)
    _launch(
        1, KERNEL_DQ, q, causal, window,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), _DTYPE_CODES[q.dtype], out_f32,
        *_shape_args(q, k, causal, window),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    return dq


def flash_backward_dkv_cuda(q, k, v, do, lse, delta, causal: bool = False,
                            window: Optional[int] = None,
                            grad_dtype: Optional[torch.dtype] = None):
    """Launch K3 on the current stream: (dk, dv) at Hkv width.  Counts
    one launch in ``_build.launches[KERNEL_DKV]``."""

    validate_window(window, causal)
    _check_kernel_inputs("flash dkv", q, k, v, rows=(("lse", lse), ("delta", delta)),
                         grads=(("dO", do),))
    dk, out_f32 = _grad_out(k, grad_dtype)
    dv, _ = _grad_out(v, grad_dtype)
    _launch(
        2, KERNEL_DKV, q, causal, window,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), _DTYPE_CODES[q.dtype],
        out_f32, *_shape_args(q, k, causal, window),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    return dk, dv


# -- dispatch ---------------------------------------------------------------


def flash_forward(q, k, v, causal: bool = False, window: Optional[int] = None,
                  *, impl: Optional[str] = None):
    """(out, lse): K1 for CUDA tensors, its plain version for CPU ones."""

    if _resolve(impl, q) == "cuda":
        return flash_forward_cuda(q, k, v, causal, window)
    return flash_forward_plain(q, k, v, causal, window)


def flash_backward_blocks(q, k, v, do, lse, delta, causal: bool = False,
                          window: Optional[int] = None,
                          grad_dtype: Optional[torch.dtype] = None,
                          *, impl: Optional[str] = None):
    """(dq, dk, dv) from the saved lse and delta = rowsum(dO * O), both
    [B, H, Sq] float32: K2 then K3 (the counterpart of
    ``_flash_backward_blocks``)."""

    if _resolve(impl, q) == "cuda":
        dq = flash_backward_dq_cuda(q, k, v, do, lse, delta, causal, window, grad_dtype)
        dk, dv = flash_backward_dkv_cuda(q, k, v, do, lse, delta, causal, window, grad_dtype)
    else:
        dq = flash_backward_dq_plain(q, k, v, do, lse, delta, causal, window, grad_dtype)
        dk, dv = flash_backward_dkv_plain(q, k, v, do, lse, delta, causal, window, grad_dtype)
    return dq, dk, dv


def flash_backward(q, k, v, out, lse, do, causal: bool = False,
                   window: Optional[int] = None, *, impl: Optional[str] = None):
    """(dq, dk, dv) of the forward that gave ``out`` and ``lse``:
    delta = rowsum(dO * O) in float32, then :func:`flash_backward_blocks`."""

    delta = (do.float() * out.float()).sum(-1)
    return flash_backward_blocks(q, k, v, do, lse, delta, causal, window, impl=impl)


class FlashAttention(torch.autograd.Function):
    """out = attention(q, k, v); saves (q, k, v, out, lse) for a
    backward through K2 and K3 (the custom VJP of the JAX kernel; the
    lse is always written)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, impl):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_forward(q, k, v, causal, window, impl=impl)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.impl = causal, window, impl
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, do.contiguous(), ctx.causal,
                                    ctx.window, impl=ctx.impl)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, window: Optional[int] = None,
                    *, impl: Optional[str] = None) -> torch.Tensor:
    """Flash attention over [B, H, S, D] with gradients: any Sq and Sk
    (lengths that do not fill a tile are masked inside the kernel)."""

    validate_window(window, causal)
    _check_heads(q, k, v)
    return FlashAttention.apply(q, k, v, causal, window, impl)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = False, bias: Optional[torch.Tensor] = None,
              mask: Optional[torch.Tensor] = None, window: Optional[int] = None,
              impl: Optional[str] = None) -> torch.Tensor:
    """Dispatching attention: :func:`flash_attention` without a bias or
    a mask, ``dot_product_attention`` with one.  Drop-in for
    ``dot_product_attention``."""

    if bias is not None or mask is not None:
        plain_calls["dot_product_attention"] += 1
        return dot_product_attention(q, k, v, causal=causal, bias=bias, mask=mask,
                                     window=window)
    return flash_attention(q, k, v, causal, window, impl=impl)
