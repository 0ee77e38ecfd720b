"""The port's flash attention (ops/flash_attention.py) against the JAX
package's flash kernels, on the CPU.

On the CPU the port runs the plain versions of K1 (forward), K2 (dq)
and K3 (dk, dv) through ``FlashAttention``; the JAX side runs its
Pallas kernels in interpret mode (``flash_attention(...,
interpret=True)``) and ``jax.grad`` through their custom VJP.  Both get
the same numpy inputs from a seed and the same output cotangent.
Tolerances: float32 atol = rtol = 5e-5 (the same float32 math summed in
another order); bf16 atol = rtol = 3e-2 (both compute in float32 and
round the result to bf16, so a value may differ by a bf16 ulp, 2^-8
relative, and values here run to |4|).  The port's out and lse are
also held against ``dot_product_attention`` and a float64 logsumexp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.ops import flash_attention as j_flash_attention

from tf_operator_tpu_torch.ops import _build
from tf_operator_tpu_torch.ops import flash_attention as fa
from tf_operator_tpu_torch.ops.attention import dot_product_attention

torch.set_num_threads(2)

TOL = {"float32": dict(atol=5e-5, rtol=5e-5), "bfloat16": dict(atol=3e-2, rtol=3e-2)}
_J = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_T = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# name: (b, h, hkv, sq, sk, d, causal, window, block, dtype)
CASES = {
    "causal_gqa_f32": (1, 4, 2, 128, 128, 32, True, None, 64, "float32"),
    "noncausal_mha_f32": (2, 2, 2, 128, 128, 32, False, None, 64, "float32"),
    "window_gqa_f32": (1, 4, 2, 128, 128, 32, True, 40, 64, "float32"),
    "cross_noncausal_f32": (1, 2, 1, 64, 128, 32, False, None, 64, "float32"),
    "cross_causal_f32": (1, 2, 2, 64, 128, 64, True, None, 64, "float32"),
    "causal_gqa_bf16": (1, 4, 2, 128, 128, 64, True, None, 128, "bfloat16"),
}


def _inputs(name):
    b, h, hkv, sq, sk, d, causal, window, block, dtype = CASES[name]
    r = np.random.default_rng(sorted(CASES).index(name))
    q = r.standard_normal((b, h, sq, d)).astype(np.float32)
    k = r.standard_normal((b, hkv, sk, d)).astype(np.float32)
    v = r.standard_normal((b, hkv, sk, d)).astype(np.float32)
    g = r.standard_normal((b, h, sq, d)).astype(np.float32)
    return (q, k, v, g), causal, window, block, dtype


def _jax(arrays, causal, window, block, dtype):
    q, k, v, g = (jnp.asarray(a, _J[dtype]) for a in arrays)

    def f(q, k, v):
        return j_flash_attention(q, k, v, causal, block, block, True, window)

    out, vjp = jax.vjp(f, q, k, v)
    return [np.asarray(x, np.float32) for x in (out, *vjp(g))]


def _torch(arrays, causal, window, dtype):
    q, k, v, g = (torch.as_tensor(a).to(_T[dtype]) for a in arrays)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = fa.flash_attention(q, k, v, causal, window)
    grads = torch.autograd.grad(out, (q, k, v), g)
    return [t.detach().float().numpy() for t in (out, *grads)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_and_gradients_match_jax_flash(name):
    arrays, causal, window, block, dtype = _inputs(name)
    want = _jax(arrays, causal, window, block, dtype)
    fa.plain_calls.clear()
    _build.launches.clear()
    got = _torch(arrays, causal, window, dtype)
    # CPU tensors run the plain versions, once each, and launch nothing
    assert dict(fa.plain_calls) == {fa.KERNEL_FWD: 1, fa.KERNEL_DQ: 1, fa.KERNEL_DKV: 1}
    assert not _build.launches
    for label, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        assert a.shape == b.shape, label
        np.testing.assert_allclose(a, b, err_msg=label, **TOL[dtype])


@pytest.mark.parametrize("name", ["causal_gqa_f32", "window_gqa_f32", "cross_causal_f32",
                                  "cross_noncausal_f32"])
def test_out_and_lse_match_dot_product_attention(name):
    (q, k, v, _), causal, window, _, _ = _inputs(name)
    qt, kt, vt = (torch.as_tensor(a) for a in (q, k, v))
    out, lse = fa.flash_forward(qt, kt, vt, causal, window)
    want = dot_product_attention(qt, kt, vt, causal=causal, window=window)
    torch.testing.assert_close(out, want, atol=5e-5, rtol=5e-5)
    # lse against a float64 logsumexp of the masked logits
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    kk = np.repeat(k, h // hkv, axis=1).astype(np.float64)
    logits = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), kk) / np.sqrt(d)
    if causal:
        qpos, kpos = np.arange(sq)[:, None], np.arange(sk)[None, :]
        vis = qpos >= kpos
        if window is not None:
            vis &= qpos - kpos < window
        logits = np.where(vis, logits, -np.inf)
    m = logits.max(-1, keepdims=True)
    want_lse = (m + np.log(np.exp(logits - m).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=5e-5, rtol=5e-5)


def test_backward_entry_points_take_lse_delta_and_grad_dtype():
    """The ring-attention reuse contract: the blocks backward takes the
    saved lse and delta = rowsum(dO * O) and writes float32 partials
    when asked, equal to the autograd gradients."""

    (q, k, v, g), causal, window, _, _ = _inputs("causal_gqa_bf16")
    qt, kt, vt, gt = (torch.as_tensor(a).to(torch.bfloat16) for a in (q, k, v, g))
    out, lse = fa.flash_forward(qt, kt, vt, causal)
    delta = (gt.float() * out.float()).sum(-1)
    parts = fa.flash_backward_blocks(qt, kt, vt, gt, lse, delta, causal,
                                     grad_dtype=torch.float32)
    assert [p.dtype for p in parts] == [torch.float32] * 3
    ref = fa.flash_backward(qt, kt, vt, out, lse, gt, causal)
    for p, r in zip(parts, ref):
        assert r.dtype == torch.bfloat16
        torch.testing.assert_close(p.to(torch.bfloat16), r, atol=0, rtol=0)


def test_dispatch_routes_masks_to_dot_product_attention():
    (q, k, v, _), *_ = _inputs("causal_gqa_f32")
    qt, kt, vt = (torch.as_tensor(a) for a in (q, k, v))
    mask = torch.ones(1, 1, 128, 128, dtype=torch.bool).tril()
    fa.plain_calls.clear()
    got = fa.attention(qt, kt, vt, mask=mask)
    assert dict(fa.plain_calls) == {"dot_product_attention": 1}
    torch.testing.assert_close(got, fa.attention(qt, kt, vt, causal=True), atol=5e-5, rtol=5e-5)


def test_wrappers_raise_on_cpu_tensors_and_bad_args():
    q = torch.zeros(1, 2, 8, 32)
    k = torch.zeros(1, 1, 8, 32)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        fa.flash_forward_cuda(q, k, k)
    with pytest.raises(ValueError, match="impl"):
        fa.flash_attention(q, k, k, impl="triton")
    with pytest.raises(ValueError, match="causal"):
        fa.flash_attention(q, k, k, window=4)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention(q, torch.zeros(1, 3, 8, 32), torch.zeros(1, 3, 8, 32))
