"""Ring attention: exact attention over a sequence split on the mesh's
``sp`` axis (the port of ``tf_operator_tpu/ops/ring_attention.py``).

Each rank of an sp line holds the queries, keys and values of its
contiguous chunk of the sequence, [B, H, S/n, D] (keys and values at
Hkv width: GQA travels the ring unexpanded), for the heads its tp rank
holds (the reference's ``heads_axis="tp"``: H / tp query heads, and
Hkv / tp KV heads or, where tp does not divide Hkv, K and V repeated to
the full width and cut to the rank's heads, :func:`rank_kv_heads`).
The K/V block rotates around the line by :func:`collectives.ppermute`,
one neighbour a hop, so no rank ever holds more than two chunks of K/V.
Rank ``my`` holds, after i hops, the block that started on rank
(my - i) mod n; its global offset is that rank's chunk offset, so causal
and window masks are exact across chunks.

Two schedules, as in the reference:

- **the flash ring** (:class:`FlashRing`, a ``torch.autograd.Function``;
  the reference's ``_make_flash_ring_local``).  Its forward runs
  ``flash_forward`` (K1 on CUDA tensors) a hop: causal on the diagonal
  hop, non-causal on a visible one, nothing on a masked one, and merges
  the hops' normalised outputs in float32 by their lse.  Its backward
  runs ``flash_backward_blocks`` (K2, K3) a hop against the GLOBAL lse
  and delta = rowsum(dO * O), with float32 partials; dQ accumulates
  here, and the dK/dV accumulators travel the ring with their block and
  come home with one last hop;
- **the plain ring** (:class:`PlainRing`, the reference's XLA ring
  ``_ring_attention_local``): a streaming softmax a hop in plain
  PyTorch; its backward differentiates that arithmetic by autograd and
  sends the dK/dV partials home around the ring.  The CPU's path, and
  the reference the flash ring is held against.

Windows (``window`` needs ``causal``) classify each visiting past block
by its global offset delta = (my - src) * S/n (:func:`band_hop_class`):
fully in the band, a plain non-causal kernel call; crossed by the band's
edge (at most two hops), a **boundary block**: plain PyTorch with the
global-offset mask (:func:`window_block_fwd`, :func:`window_block_bwd`,
XLA code in the reference), counted in :data:`boundary_blocks` and not
as a kernel's plain call; behind the band, skipped.  The diagonal hop
passes the window to the kernel.

A masked hop launches nothing, but its block still travels: every rank
makes the same ppermutes in the same order.

Counters: ``flash_attention.plain_calls["ring_attention_plain"]`` counts
plain-ring calls, :data:`boundary_blocks` the boundary blocks by
direction.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Optional, Tuple

import torch

from tf_operator_tpu_torch.ops.attention import NEG_FILL, repeat_kv_heads, validate_window
from tf_operator_tpu_torch.ops import flash_attention as fa
from tf_operator_tpu_torch.parallel.collectives import CollectiveStats, ppermute

#: boundary blocks computed since the last ``boundary_blocks.clear()``,
#: by direction ("window_block_fwd", "window_block_bwd")
boundary_blocks: "collections.Counter[str]" = collections.Counter()

#: the CollectiveStats stage of the ring's K/V (and dK/dV) hops
STAGE = "ring_ppermute"


@dataclasses.dataclass
class SpLine:
    """This rank's line over the sp axis: its process group (None at
    size 1), its coordinate on the line, the line's size, and the stats
    its collectives count into."""

    group: object
    index: int
    size: int
    stats: CollectiveStats


def sp_line(mesh, axis_name: str = "sp") -> SpLine:
    """The calling rank's :class:`SpLine` over ``axis_name`` of ``mesh``."""

    from tf_operator_tpu_torch.runtime.bootstrap import world

    rank = world()[0]
    return SpLine(mesh.group((axis_name,)), mesh.index((axis_name,), rank),
                  mesh.shape[axis_name], mesh.stats)


def rank_kv_heads(q, k, v, mesh):
    """K and V that hold every KV head (a head count the tp line does
    not divide, replicated along it) cut to the query heads of this
    rank, ``q`` [B, H / tp, S, D]: repeated to the full query width and
    this rank's H / tp of them kept, as the reference goes to full width
    before its shard_map.  Their gradients are this rank's share, to be
    summed over the line."""

    from tf_operator_tpu_torch.runtime.bootstrap import world

    tp = mesh.shape.get("tp", 1)
    local = q.shape[1]
    if (local * tp) % k.shape[1]:
        raise ValueError(f"q heads ({local * tp}) must be a multiple of kv heads ({k.shape[1]})")
    group = local * tp // k.shape[1]
    lo = (mesh.index(("tp",), world()[0]) if tp > 1 else 0) * local
    return (repeat_kv_heads(k, group)[:, lo:lo + local],
            repeat_kv_heads(v, group)[:, lo:lo + local])


def band_hop_class(my: int, src: int, sq: int, window: int) -> Tuple[bool, bool]:
    """(in_band, fully_in) of the past chunk ``src`` visiting rank ``my``
    (the reference's ``_band_hop_class``; the forward and the backward
    both read it):

    - fully_in: every (q, k) pair has qpos - kpos < window: the plain
      non-causal kernel;
    - in_band and not fully_in: the band's edge crosses the hop: a
      boundary block;
    - not in_band: every pair is behind the band: skipped."""

    delta = (my - src) * sq
    return src < my and delta < window + sq - 1, delta + sq - 1 < window


def _hop_kind(my: int, src: int, sq: int, causal: bool, window: Optional[int]) -> str:
    """"visible", "boundary" or "masked" for the block of ``src`` on ``my``
    (a hop after the diagonal one)."""

    if not causal:
        return "visible"
    if window is None:
        return "visible" if src < my else "masked"
    in_band, fully_in = band_hop_class(my, src, sq, window)
    if not in_band:
        return "masked"
    return "visible" if fully_in else "boundary"


def _global_band_mask(sq: int, sk: int, q_off: int, k_off: int, window: int, device):
    """[1, 1, Sq, Sk] bool: causal and in the band, in GLOBAL positions."""

    qpos = q_off + torch.arange(sq, device=device)[:, None]
    kpos = k_off + torch.arange(sk, device=device)[None, :]
    return ((qpos >= kpos) & (qpos - kpos < window))[None, None]


def _scores(q, k):
    """float32 scaled logits [B, H, Sq, Sk] of q against K at q's width."""

    scale = 1.0 / math.sqrt(q.shape[-1])
    return torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale


def window_block_fwd(q, k, v, q_off: int, k_off: int, window: int):
    """One block at the band's edge (the reference's ``_window_block_fwd``):
    (normalised out [B, H, Sq, D] float32, row lse [B, H, Sq] float32,
    ``NEG_FILL`` where a row sees nothing).  k, v at q's head width."""

    boundary_blocks["window_block_fwd"] += 1
    s = _scores(q, k)
    vis = _global_band_mask(q.shape[-2], k.shape[-2], q_off, k_off, window, q.device)
    s = torch.where(vis, s, NEG_FILL)
    m = s.amax(-1, keepdim=True)
    p = torch.where(s <= NEG_FILL / 2, 0.0, torch.exp(s - m))
    l = p.sum(-1, keepdim=True)
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)), NEG_FILL)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l.clamp_min(1e-30)
    return o, lse[..., 0]


def window_block_bwd(q, k_hkv, v_hkv, g, lse, delta, q_off: int, k_off: int, window: int,
                     group: int):
    """The gradients (float32 dq at H width, dk and dv at Hkv width) of
    one boundary block (the reference's ``_window_block_bwd``): with the
    global lse and delta each block's contribution stands alone."""

    boundary_blocks["window_block_bwd"] += 1
    b, h, sq, d = q.shape
    scale = 1.0 / math.sqrt(d)
    k_exp = repeat_kv_heads(k_hkv, group).float()
    v_exp = repeat_kv_heads(v_hkv, group).float()
    s = _scores(q, k_exp)
    vis = _global_band_mask(sq, k_exp.shape[-2], q_off, k_off, window, q.device)
    p = torch.where(vis, torch.exp(s - lse[..., None]), 0.0)
    gf = g.float()
    dv_full = torch.matmul(p.transpose(-1, -2), gf)
    ds = p * (torch.matmul(gf, v_exp.transpose(-1, -2)) - delta[..., None])
    dq = torch.matmul(ds, k_exp) * scale
    dk_full = torch.matmul(ds.transpose(-1, -2), q.float()) * scale

    def fold(x):  # [B, H, Sk, D] -> [B, Hkv, Sk, D]
        return x if group == 1 else x.reshape(b, h // group, group, x.shape[-2], d).sum(2)

    return dq, fold(dk_full), fold(dv_full)


def _merge(o, lse, blk_out, blk_lse):
    """Two normalised partial outputs merged by their lse (float32)."""

    new = torch.logaddexp(lse, blk_lse)
    return (o * torch.exp(lse - new)[..., None]
            + blk_out.float() * torch.exp(blk_lse - new)[..., None]), new


def ring_forward(q, k, v, line: SpLine, causal: bool, window: Optional[int] = None):
    """The flash ring's forward (the reference's
    ``_ring_attention_local_flash``): (out in q's dtype, the global row
    lse [B, H, Sq] float32)."""

    my, n, sq = line.index, line.size, q.shape[-2]
    group = q.shape[1] // k.shape[1]
    out0, lse = fa.flash_forward(q, k, v, causal, window)
    o = out0.float()
    k_blk, v_blk = k, v
    for i in range(n - 1):
        k_blk = ppermute(k_blk, line.group, line.stats, STAGE)
        v_blk = ppermute(v_blk, line.group, line.stats, STAGE)
        src = (my - (i + 1)) % n
        kind = _hop_kind(my, src, sq, causal, window)
        if kind == "masked":
            continue  # its weight is exactly 0: the merge would be the identity
        if kind == "visible":
            bo, bl = fa.flash_forward(q, k_blk, v_blk, False)
        else:
            bo, bl = window_block_fwd(q, repeat_kv_heads(k_blk, group),
                                      repeat_kv_heads(v_blk, group), my * sq, src * sq, window)
        o, lse = _merge(o, lse, bo, bl)
    return o.to(q.dtype), lse.contiguous()


def ring_backward(q, k, v, out, lse, do, line: SpLine, causal: bool,
                  window: Optional[int] = None):
    """The flash ring's backward (the reference's
    ``_ring_flash_backward``): (dq, dk, dv) of this rank's chunk, in
    the inputs' dtypes."""

    my, n, sq = line.index, line.size, q.shape[-2]
    group = q.shape[1] // k.shape[1]
    delta = (do.float() * out.float()).sum(-1)
    # float32 partials: one rounding at the end, as the one-device path
    dq, dk, dv = fa.flash_backward_blocks(q, k, v, do, lse, delta, causal, window,
                                          grad_dtype=torch.float32)
    k_blk, v_blk, dk_blk, dv_blk = k, v, dk, dv
    for i in range(n - 1):
        # the gradient accumulators travel with their block
        k_blk, v_blk, dk_blk, dv_blk = (ppermute(t, line.group, line.stats, STAGE)
                                        for t in (k_blk, v_blk, dk_blk, dv_blk))
        src = (my - (i + 1)) % n
        kind = _hop_kind(my, src, sq, causal, window)
        if kind == "masked":
            continue
        if kind == "visible":
            dqi, dki, dvi = fa.flash_backward_blocks(q, k_blk, v_blk, do, lse, delta, False,
                                                     grad_dtype=torch.float32)
        else:
            dqi, dki, dvi = window_block_bwd(q, k_blk, v_blk, do, lse, delta, my * sq,
                                             src * sq, window, group)
        dq += dqi
        dk_blk += dki
        dv_blk += dvi
    # after n - 1 hops each accumulator is one hop short of its owner
    dk = ppermute(dk_blk, line.group, line.stats, STAGE)
    dv = ppermute(dv_blk, line.group, line.stats, STAGE)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashRing(torch.autograd.Function):
    """out = the flash ring's forward; saves (q, k, v, out, lse) for
    the ring backward (the custom VJP of ``_make_flash_ring_local``)."""

    @staticmethod
    def forward(ctx, q, k, v, line, causal, window):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = ring_forward(q, k, v, line, causal, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.line, ctx.causal, ctx.window = line, causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = ring_backward(q, k, v, out, lse, do.contiguous(), ctx.line, ctx.causal,
                                   ctx.window)
        return dq, dk, dv, None, None, None


def _ring_block(q, k, v, m, l, o, q_off: int, k_off: int, causal: bool,
                window: Optional[int]):
    """One hop of the plain ring's streaming softmax (float32 running
    max m, normaliser l and unnormalised output o)."""

    s = _scores(q, k)
    if causal:
        qpos = q_off + torch.arange(q.shape[-2], device=q.device)[:, None]
        kpos = k_off + torch.arange(k.shape[-2], device=q.device)[None, :]
        visible = qpos >= kpos
        if window is not None:
            visible = visible & (qpos - kpos < window)
        s = torch.where(visible, s, NEG_FILL)
    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
    # a row masked so far has m_new == NEG_FILL, where exp(0) = 1 would
    # pollute l: masked entries are zeroed
    p = torch.where(s <= NEG_FILL / 2, 0.0, torch.exp(s - m_new))
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(-1, keepdim=True)
    o = o * corr + torch.matmul(p.to(v.dtype).float(), v.float())
    return m_new, l, o


def _plain_ring_local(q, blocks, line: SpLine, causal: bool, window: Optional[int]):
    """The plain ring's arithmetic on this rank, every visiting block in
    hand (``blocks[i]``: the (k, v) held after i hops).  A causal hop
    whose chunk is all in the future (or, with a window, all behind the
    band) computes nothing."""

    my, n, sq = line.index, line.size, q.shape[-2]
    group = q.shape[1] // blocks[0][0].shape[1]
    m = torch.full(q.shape[:-1] + (1,), NEG_FILL, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)

    def visible(src: int) -> bool:
        vis = src <= my
        if window is not None:
            # chunks more than ceil((window - 1) / sq) behind hold only
            # keys behind the band for every local row
            vis = vis and (my - src - 1) * sq <= window - 2
        return vis

    for i, (k_blk, v_blk) in enumerate(blocks):
        src = (my - i) % n
        if not causal or visible(src):
            m, l, o = _ring_block(q, repeat_kv_heads(k_blk, group),
                                  repeat_kv_heads(v_blk, group), m, l, o, my * sq, src * sq,
                                  causal, window)
    # causal rows see at least themselves, so l > 0
    return (o / l.clamp_min(1e-30)).to(q.dtype)


class PlainRing(torch.autograd.Function):
    """The plain ring (the reference's XLA ring ``_ring_attention_local``).

    Forward: the K/V block makes its n - 1 hops and each rank runs the
    streaming softmax over the blocks it held.  Backward: autograd
    through that arithmetic on the saved blocks gives dq and each held
    block's dK/dV; an accumulator then travels the ring backwards (a
    block held after i hops came i ranks from its owner), adding this
    rank's partials at each hop, so every rank makes the same collectives
    whichever hops its mask skipped (autograd alone would skip a
    masked block's transposed ppermute on one rank only)."""

    @staticmethod
    def forward(ctx, q, k, v, line, causal, window):
        blocks = [(k, v)]
        for _ in range(line.size - 1):
            k, v = blocks[-1]
            blocks.append((ppermute(k, line.group, line.stats, STAGE),
                           ppermute(v, line.group, line.stats, STAGE)))
        ctx.save_for_backward(q, *[t for kv in blocks for t in kv])
        ctx.line, ctx.causal, ctx.window = line, causal, window
        return _plain_ring_local(q, blocks, line, causal, window)

    @staticmethod
    def backward(ctx, do):
        q, *flat = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        blocks = list(zip(flat[0::2], flat[1::2]))
        line = ctx.line
        with torch.enable_grad():
            out = _plain_ring_local(q, blocks, line, ctx.causal, ctx.window)
            grads = torch.autograd.grad(out, [q] + flat, do, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g for g, t in zip(grads, [q] + flat)]
        dq, dks, dvs = grads[0], grads[1::2], grads[2::2]
        dk, dv = dks[-1], dvs[-1]
        for i in range(line.size - 2, -1, -1):
            dk = ppermute(dk, line.group, line.stats, STAGE, shift=-1) + dks[i]
            dv = ppermute(dv, line.group, line.stats, STAGE, shift=-1) + dvs[i]
        return dq, dk, dv, None, None, None


def ring_attention_plain(q, k, v, line: SpLine, causal: bool,
                         window: Optional[int] = None) -> torch.Tensor:
    """The plain ring (:class:`PlainRing`): the CPU's path and the
    reference the flash ring is held against."""

    fa.plain_calls["ring_attention_plain"] += 1
    return PlainRing.apply(q.contiguous(), k.contiguous(), v.contiguous(), line, causal, window)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh, *,
                   causal: bool = False, axis_name: str = "sp",
                   kv_whole: bool = False,
                   use_flash: Optional[bool] = None,
                   window: Optional[int] = None) -> torch.Tensor:
    """Exact attention over a sequence split on ``axis_name``.

    q: this rank's [B, H, S/n, D] chunk (its rows of the batch, its
    chunk of the sequence, the heads its rank of the tp axis holds:
    H / tp of the model's); k, v: [B, Hkv, S/n, D] with H % Hkv == 0,
    the rank's Hkv / tp KV heads, or with ``kv_whole`` every KV head of
    the model (a count tp does not divide), which :func:`rank_kv_heads`
    cuts to the rank's query heads at full width, as the reference
    does.  ``kv_whole`` is the op's own capability: no model path
    reaches it, because the trainer's sharding refuses an Hkv that tp
    does not divide.  The ring runs within the rank's sp line, over its heads.
    Every rank of the line passes chunks of one length; the cut
    (``parallel/sharding.sequence_chunk``) refuses a sequence that does
    not divide.  At sp 1 this is ``flash_attention.attention`` on the
    whole sequence.

    ``use_flash``: the flash ring (the kernels for CUDA tensors, their
    plain versions for CPU ones); None = for CUDA tensors, the plain
    ring for CPU ones.  The kernels pick their own tiles, so the
    reference's block sizes and ``interpret`` have no counterpart."""

    if kv_whole:
        k, v = rank_kv_heads(q, k, v, mesh)
    h, hkv = q.shape[1], k.shape[1]
    if h % hkv:
        raise ValueError(f"q heads ({h}) must be a multiple of kv heads ({hkv})")
    validate_window(window, causal)
    if mesh.shape[axis_name] <= 1:
        return fa.attention(q, k, v, causal=causal, window=window)
    line = sp_line(mesh, axis_name)
    if use_flash is None:
        use_flash = q.is_cuda
    if use_flash:
        return FlashRing.apply(q, k, v, line, causal, window)
    return ring_attention_plain(q, k, v, line, causal, window)
