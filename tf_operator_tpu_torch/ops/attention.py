"""Plain scaled dot-product attention (the port of
``tf_operator_tpu/ops/attention.py``).

float32 logits and softmax whatever the input dtype, masked logits
filled with ``finfo(float32).min`` (never -inf: a row masked so far
would turn NaN), GQA by a grouped product with no K/V repeat, and the
probabilities cast to v's dtype before the PV product.  The output is
in v's dtype.

Layout: [batch, heads, seq, head_dim].
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_FILL = torch.finfo(torch.float32).min


def validate_window(window, causal: bool) -> None:
    """Shared precondition for every attention entry point that takes
    ``window``."""

    if window is None:
        return
    if not causal:
        raise ValueError("window attention requires causal=True")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    bias: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """q [B, H, Sq, D]; k/v [B, Hkv, Sk, D] with H % Hkv == 0.

    ``bias`` is added to the logits; ``mask`` is a broadcastable
    boolean, True = attend; ``window`` keeps position i's view to
    [i - window + 1, i] and needs ``causal``."""

    validate_window(window, causal)
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[-2]
    if h % hkv:
        raise ValueError(f"q heads ({h}) must be a multiple of kv heads ({hkv})")
    group = h // hkv
    qg = q.reshape(b, hkv, group, sq, d).float()
    logits = torch.matmul(qg, k.float()[:, :, None].transpose(-1, -2))
    logits = logits.reshape(b, h, sq, sk)
    logits = logits * (1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32)))
    if bias is not None:
        logits = logits + bias.float()
    if mask is not None:
        logits = torch.where(mask, logits, NEG_FILL)
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None]
        kpos = torch.arange(sk, device=q.device)[None, :]
        visible = qpos >= kpos
        if window is not None:
            visible &= qpos - kpos < window
        logits = torch.where(visible, logits, NEG_FILL)
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    wg = weights.reshape(b, hkv, group, sq, sk)
    out = torch.matmul(wg.float(), v.float()[:, :, None])
    return out.reshape(b, h, sq, d).to(v.dtype)


def repeat_kv_heads(a: torch.Tensor, group: int) -> torch.Tensor:
    """GQA: expand [B, Hkv, S, D] K/V to the query-head width, each head
    repeated ``group`` times in place (``jnp.repeat(a, group, axis=1)``).
    Only the paths that cannot stay at Hkv width use it: the plain ring's
    blocks and the window's boundary blocks (ops/ring_attention.py), and
    Ulysses when the KV heads do not split over the sp axis."""

    return a if group == 1 else a.repeat_interleave(group, dim=1)
