"""Paged-attention decode straight off the KV block arena (the port of
``tf_operator_tpu/ops/paged_attention.py``).

Layout contract (the JAX package's):

- ``q``        [S, H, D]        one query per seat, or [S, K, H, D]
                                for ``paged_attention_multi``
- ``k_arena``  [NB, Hkv, bs, D] one layer's arena
- ``v_arena``  [NB, Hkv, bs, D]
- ``tables``   [S, MB] int32    logical block -> physical arena block
- ``lengths``  [S] int32        valid positions per seat, including the
                                just-appended token(s)
- returns      q's shape, in the arena dtype

Query row t of seat s (of K) sees positions p < lengths[s] - (K-1-t).
Unused table entries point at scratch block 0; they sit at positions
>= lengths[s], so the length mask is also the scratch mask.

Dispatch: ``impl=None`` launches the CUDA kernel
(``csrc/paged_attention.cu``) for CUDA tensors and runs the plain
version for CPU tensors.  There is no fallback: a CUDA tensor reaches
the kernel or the call raises.  ``impl="plain"`` asks for the plain
version explicitly (the reference the kernel is held against);
``impl="cuda"`` asks for the kernel.  The kernel splits each seat's
context into up to ``MAX_SPLITS`` ranges sized from ``MB * bs`` alone
(:func:`split_plan`); their partial softmaxes meet inside the one
launch.  The first launch of each variant class (``k_new``, the split
count, the dtype) is recorded in the process compile ledger
(``_build.record_first_launch``, program ``ops.paged_attention``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from tf_operator_tpu_torch.ops import _build
from tf_operator_tpu_torch.ops.attention import dot_product_attention

KERNEL = "paged_attention"
#: the compile ledger's program name for the kernel's variant classes
PROGRAM = "ops.paged_attention"
PAGED_IMPLS = ("plain", "cuda")
KERNEL_BLOCK_SIZES = (8, 12, 16, 32)
KERNEL_HEAD_DIMS = (32, 64, 128)
#: splits of a seat's context: a thread-block cluster of at most 8 CTAs
#: (the portable cluster size), one for every SPLIT_MIN_POSITIONS at most
MAX_SPLITS = 8
SPLIT_MIN_POSITIONS = 128
#: K and V bytes of one warp's tile in the kernel, its ring's stages, and
#: its warps a CTA
TILE_BYTES = 4096
STAGES = 3
WARPS = 4
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _gathered_view(arena: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """[S, Hkv, MB*bs, D]: the seats' blocks laid end to end."""

    s, mb = tables.shape
    _, hkv, bs, d = arena.shape
    g = arena[tables.long()]  # [S, MB, Hkv, bs, D]
    return g.permute(0, 2, 1, 3, 4).reshape(s, hkv, mb * bs, d)


def paged_attention_multi_plain(q, k_arena, v_arena, tables, lengths):
    """The plain version: gather each seat's blocks into a contiguous
    view and run ``dot_product_attention`` with the length/band mask
    (the counterpart of ``_paged_attention_multi_xla``)."""

    s, k_new, _, _ = q.shape
    mb, bs = tables.shape[1], k_arena.shape[2]
    qend = lengths[:, None].long() - (
        k_new - 1 - torch.arange(k_new, device=q.device)
    )[None, :]
    pos = torch.arange(mb * bs, device=q.device)
    mask = (pos[None, None, :] < qend[:, :, None])[:, None]  # [S, 1, K, MB*bs]
    out = dot_product_attention(
        q.transpose(1, 2), _gathered_view(k_arena, tables),
        _gathered_view(v_arena, tables), mask=mask,
    )  # [S, H, K, D]
    return out.transpose(1, 2)


def _check_kernel_inputs(q, k_arena, v_arena, tables, lengths) -> None:
    s, k_new, h, d = q.shape
    nb, hkv, bs, dk = k_arena.shape
    tensors = {"q": q, "k_arena": k_arena, "v_arena": v_arena,
               "tables": tables, "lengths": lengths}
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"paged_attention kernel: {name} is not on a CUDA device")
        if t.device != q.device:
            raise ValueError(f"paged_attention kernel: {name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention kernel: {name} is not contiguous")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"paged_attention kernel takes float32 or bfloat16, got {q.dtype}")
    if k_arena.dtype != q.dtype or v_arena.dtype != q.dtype:
        raise ValueError(
            f"paged_attention kernel: q {q.dtype} and arenas "
            f"{k_arena.dtype}/{v_arena.dtype} must share one dtype"
        )
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("paged_attention kernel: tables and lengths must be int32")
    if v_arena.shape != k_arena.shape or dk != d:
        raise ValueError(
            f"paged_attention kernel: arenas {tuple(k_arena.shape)}/"
            f"{tuple(v_arena.shape)} do not match q head_dim {d}"
        )
    if tables.ndim != 2 or tables.shape[0] != s or tuple(lengths.shape) != (s,):
        raise ValueError(
            f"paged_attention kernel: tables {tuple(tables.shape)} and "
            f"lengths {tuple(lengths.shape)} must be [S, MB] and [S] with S={s}"
        )
    if h % hkv:
        raise ValueError(f"q heads ({h}) must be a multiple of kv heads ({hkv})")
    if bs not in KERNEL_BLOCK_SIZES:
        raise ValueError(f"paged_attention kernel: block size {bs} not in {KERNEL_BLOCK_SIZES}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"paged_attention kernel: head_dim {d} not in {KERNEL_HEAD_DIMS}")
    if k_new < 1:
        raise ValueError(f"paged_attention kernel: K must be >= 1, got {k_new}")


def kernel_rows(g_rows: int) -> int:
    """Query rows a kernel CTA carries: 1, 2 or 4 (G = K * group rounded
    up, at most 4; more rows take more CTAs)."""

    return 1 if g_rows == 1 else 2 if g_rows == 2 else 4


def split_plan(max_positions: int, head_dim: int, elem: int, units: int, resident: int):
    """(splits, chunk) of the kernel's context split: ``splits`` ranges of
    ``chunk`` positions cover ``max_positions`` (= MB * bs).  As many as
    keep the grid of ``units`` (kv head, row group, seat) clusters within
    the ``resident`` CTAs the card holds at once, at most ``MAX_SPLITS``
    and one for every ``SPLIT_MIN_POSITIONS`` positions, at least one;
    none empty, each a whole number of the CTA's passes (its warps' tiles
    of ``TILE_BYTES`` of K and V: 2048 / (head_dim * elem) positions a
    warp)."""

    unit = WARPS * (TILE_BYTES // 2) // (head_dim * elem)
    splits = max(1, min(MAX_SPLITS, -(-max_positions // SPLIT_MIN_POSITIONS),
                        resident // max(1, units)))
    per_split = -(-max_positions // splits)
    chunk = max(unit, -(-per_split // unit) * unit)
    return max(1, -(-max_positions // chunk)), chunk


def kernel_smem_bytes(head_dim: int, rows: int) -> int:
    """Dynamic shared memory of a kernel CTA carrying ``rows`` query rows:
    its warps' rings, then its partial (acc [rows, D], m and l [rows])."""

    return WARPS * STAGES * TILE_BYTES + rows * (head_dim + 2) * 4


@functools.cache
def _launcher():
    """The kernel's C entry point with its argument types declared
    (pointers and the stream as c_void_p, so none is cut to 32 bits)."""

    fn = _build.load(KERNEL).paged_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [
        ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def resident_ctas(dtype_code: int, head_dim: int, rows: int) -> int:
    """CTAs of the kernel instantiation the card holds at once (the
    occupancy query times the SMs of the current device)."""

    fn = _build.load(KERNEL).paged_attention_resident_ctas
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    ctas = ctypes.c_int(0)
    err = fn(dtype_code, head_dim, rows, ctypes.byref(ctas))
    if err != 0 or ctas.value < 1:
        raise RuntimeError(f"paged_attention kernel: occupancy query failed: CUDA error {err}")
    return ctas.value


def launch_plan(q: torch.Tensor, k_arena: torch.Tensor, tables: torch.Tensor):
    """(splits, chunk) the kernel takes for these shapes (:func:`split_plan`
    on the card's resident CTAs); no tensor is read."""

    s, k_new, h, d = q.shape
    hkv, bs = k_arena.shape[1], k_arena.shape[2]
    g_rows = k_new * (h // hkv)
    rows = kernel_rows(g_rows)
    units = hkv * -(-g_rows // rows) * s
    return split_plan(tables.shape[1] * bs, d, q.element_size(), units,
                      resident_ctas(_DTYPE_CODES[q.dtype], d, rows))


def paged_attention_multi_cuda(q, k_arena, v_arena, tables, lengths):
    """Launch the CUDA kernel (K4) on the current stream.  Counts one
    launch in ``_build.launches[KERNEL]``; records the first launch of
    its (k_new, splits, dtype) class in the compile ledger."""

    _check_kernel_inputs(q, k_arena, v_arena, tables, lengths)
    s, k_new, h, d = q.shape
    hkv, bs = k_arena.shape[1], k_arena.shape[2]
    out = torch.empty_like(q)
    if s == 0:
        return out
    splits, chunk = launch_plan(q, k_arena, tables)
    launch = _launcher()
    cls = (k_new, splits, q.dtype)
    t_first = _build.first_launch(PROGRAM, cls)
    err = launch(
        q.data_ptr(), k_arena.data_ptr(), v_arena.data_ptr(),
        tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        _DTYPE_CODES[q.dtype], s, hkv, bs, d, tables.shape[1], k_new,
        h // hkv, splits, chunk, 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA error {err}")
    _build.launches[KERNEL] += 1
    if t_first is not None:
        _build.record_first_launch(
            PROGRAM, cls, f"k_new={k_new},splits={splits},{_DTYPE_NAMES[q.dtype]}", t_first,
            (q, k_arena, tables))
    return out


def paged_attention_multi(
    q: torch.Tensor,
    k_arena: torch.Tensor,
    v_arena: torch.Tensor,
    tables: torch.Tensor,
    lengths: torch.Tensor,
    *,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """K query rows per seat against the block arena: q [S, K, H, D]
    with ``lengths`` including all K appended tokens (module docstring
    for the layout, masking and dispatch)."""

    if q.ndim != 4 or k_arena.ndim != 4 or tables.ndim != 2:
        raise ValueError(
            f"paged_attention_multi layout: q [S,K,H,D], arena "
            f"[NB,Hkv,bs,D], tables [S,MB]; got q{tuple(q.shape)}, "
            f"k{tuple(k_arena.shape)}, tables{tuple(tables.shape)}"
        )
    if impl is None:
        impl = "cuda" if q.is_cuda else "plain"
    if impl == "plain":
        return paged_attention_multi_plain(q, k_arena, v_arena, tables, lengths)
    if impl == "cuda":
        return paged_attention_multi_cuda(q, k_arena, v_arena, tables, lengths)
    raise ValueError(f"impl must be None or one of {PAGED_IMPLS}, got {impl!r}")


def paged_attention(
    q: torch.Tensor,
    k_arena: torch.Tensor,
    v_arena: torch.Tensor,
    tables: torch.Tensor,
    lengths: torch.Tensor,
    *,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """One query per seat: q [S, H, D] -> [S, H, D].  The K = 1 slice
    of :func:`paged_attention_multi` (one kernel serves both)."""

    if q.ndim != 3:
        raise ValueError(f"paged_attention layout: q [S,H,D], got q{tuple(q.shape)}")
    return paged_attention_multi(
        q[:, None], k_arena, v_arena, tables, lengths, impl=impl,
    )[:, 0]
