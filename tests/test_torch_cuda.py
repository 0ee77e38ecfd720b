"""Tests of the port that need a CUDA device (marker ``cuda``).  They
skip without one; on the GPU machine run them as

    python -m pytest tests/test_torch_cuda.py -q

The paged-attention kernel is held against its plain version on the
same card: float32 atol 5e-5 (the kernel sums in another order than the
plain float32 products), bf16 atol 2e-2 (the plain version rounds the
probabilities to bf16 before the PV product; both round the output).

The flash-attention kernels (K1-K3) are held against their plain
versions two ways.  Kernel by kernel on the same inputs (K2 and K3 get
the plain forward's lse and delta): per row of D values, max |kernel -
plain| over the row's largest |plain|, floored at 1e-3 of the tensor's
largest so that a row of near-zeros does not divide by nothing.
Through autograd (``FlashAttention`` against autograd through the plain
versions): over the tensor's largest |plain|, because there the
kernel's out, one bf16 ulp off the plain out in places, reaches every
gradient through delta = rowsum(dO * O), and a dq row that cancels to
near zero (a causal row that sees one or two keys) then differs by more
than its own size.  float32 2e-5 (another summation order); bf16 2e-2
(the kernels round p and ds to bf16 as tensor-core operands, the plain
versions keep them in float32; readings on the card are under 1e-2).
"""

import numpy as np
import pytest
import torch

from tf_operator_tpu_torch.models.batching import PagedContinuousBatchingDecoder
from tf_operator_tpu_torch.models.decode import generate
from tf_operator_tpu_torch.models.llama import LlamaLM, llama_tiny
from tf_operator_tpu_torch.models.weights import init_params
from tf_operator_tpu_torch.ops import _build
from tf_operator_tpu_torch.ops import flash_attention as fa
from tf_operator_tpu_torch.ops.paged_attention import KERNEL, paged_attention_multi

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 5e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rig(dev, seed, *, s, h, hkv, d, bs, mb, k_new, dtype, overshoot=False):
    r = np.random.default_rng(seed)
    nb = s * mb + 1
    q = r.standard_normal((s, k_new, h, d))
    ka = r.standard_normal((nb, hkv, bs, d))
    va = r.standard_normal((nb, hkv, bs, d))
    ka[0] = va[0] = 1e4  # poisoned scratch
    tables = r.permutation(np.arange(1, nb))[: s * mb].reshape(s, mb).astype(np.int32)
    lengths = r.integers(k_new, mb * bs + 1, s).astype(np.int32)
    lengths[0] = min(bs + 1, mb * bs)  # a block straddle
    for i in range(s):
        tables[i, -(-int(lengths[i]) // bs):] = 0
    if overshoot:
        lengths[-1] = mb * bs + k_new  # appends past the table went to scratch
    to = lambda a, dt: torch.as_tensor(a).to(device=dev, dtype=dt)
    return (to(q, dtype), to(ka, dtype), to(va, dtype),
            to(tables, torch.int32), to(lengths, torch.int32))


CASES = [
    dict(s=3, h=4, hkv=2, d=32, bs=8, mb=5, k_new=1),
    dict(s=3, h=4, hkv=4, d=64, bs=12, mb=6, k_new=3),
    dict(s=4, h=8, hkv=2, d=128, bs=16, mb=20, k_new=1),
    dict(s=2, h=8, hkv=8, d=128, bs=32, mb=9, k_new=4),
    dict(s=2, h=4, hkv=1, d=64, bs=16, mb=4, k_new=2, overshoot=True),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_kernel_matches_plain(dev, case, dtype):
    args = _rig(dev, case, dtype=dtype, **CASES[case])
    before = _build.launches[KERNEL]
    got = paged_attention_multi(*args)
    torch.cuda.synchronize()
    assert _build.launches[KERNEL] == before + 1
    want = paged_attention_multi(*args, impl="plain")
    assert got.dtype == dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype], err


def test_wrapper_refuses_what_the_kernel_does_not_take(dev):
    q, ka, va, tables, lengths = _rig(dev, 0, dtype=torch.float32, **CASES[0])
    before = _build.launches[KERNEL]
    bad = [
        (q.half(), ka.half(), va.half(), tables, lengths),       # dtype
        (q, ka.bfloat16(), va, tables, lengths),                 # mixed dtypes
        (q, ka, va, tables.long(), lengths),                     # table dtype
        (torch.cat([q, q], -1)[..., ::2], ka, va, tables, lengths),  # strided
        (q, ka, va, tables.cpu(), lengths),                      # device
        (q[..., :16].contiguous(), ka[..., :16].contiguous(),
         va[..., :16].contiguous(), tables, lengths),            # head_dim 16
    ]
    for args in bad:
        with pytest.raises(ValueError):
            paged_attention_multi(*args)
    assert _build.launches[KERNEL] == before


def test_tiny_pool_through_the_kernel_matches_generate(dev):
    cfg = llama_tiny(vocab_size=256, max_len=64, dtype=torch.float32)
    model = LlamaLM.from_state_dict(cfg, init_params(cfg, 1, dev), dev)
    pool = PagedContinuousBatchingDecoder(model, slots=2, steps_per_sync=4, kv_block_size=8)
    prompts = [np.arange(n) % 256 for n in (7, 8, 9, 20)]
    _build.launches.clear()
    rids = [pool.submit(p, 10) for p in prompts]
    pool.run()
    assert _build.launches[KERNEL] == cfg.n_layers * pool.decode_steps > 0
    for p, rid in zip(prompts, rids):
        want = generate(model, torch.as_tensor(p[None]).to(dev), 10)[0].cpu().numpy()
        np.testing.assert_array_equal(pool.result(rid), want)


FLASH_RTOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
FLASH_CASES = {
    "causal_gqa": dict(b=2, h=4, hkv=2, sq=130, sk=130, d=64, causal=True),
    "noncausal_cross": dict(b=1, h=2, hkv=1, sq=70, sk=200, d=128, causal=False),
    "causal_sq_gt_sk": dict(b=1, h=2, hkv=2, sq=150, sk=90, d=32, causal=True),
    "causal_sq_lt_sk": dict(b=1, h=4, hkv=1, sq=64, sk=192, d=128, causal=True),
    "window": dict(b=1, h=2, hkv=1, sq=300, sk=300, d=64, causal=True, window=37),
}


def _row_rel(got, want):
    got, want = got.float(), want.float()
    floor = 1e-3 * want.abs().max().clamp_min(1e-30)
    return ((got - want).abs().amax(-1) / want.abs().amax(-1).maximum(floor)).max().item()


def _rel(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def _flash_inputs(dev, case, dtype):
    c = dict(FLASH_CASES[case])
    window = c.pop("window", None)
    r = np.random.default_rng(len(case))
    shapes = {"q": (c["b"], c["h"], c["sq"], c["d"]), "k": (c["b"], c["hkv"], c["sk"], c["d"])}
    q, k, v, g = (torch.as_tensor(r.standard_normal(shapes[n])).to(dev, dtype)
                  for n in ("q", "k", "k", "q"))
    return q, k, v, g, c["causal"], window


def _counts():
    return [_build.launches[n] for n in (fa.KERNEL_FWD, fa.KERNEL_DQ, fa.KERNEL_DKV)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_kernels_match_plain(dev, case, dtype):
    q, k, v, g, causal, window = _flash_inputs(dev, case, dtype)
    _build.launches.clear()
    out, lse = fa.flash_forward(q, k, v, causal, window)
    want_out, want_lse = fa.flash_forward(q, k, v, causal, window, impl="plain")
    delta = (g.float() * want_out.float()).sum(-1)
    rows = (q, k, v, g, want_lse, delta, causal, window)
    got = fa.flash_backward_blocks(*rows)
    want = fa.flash_backward_blocks(*rows, impl="plain")
    torch.cuda.synchronize()
    assert _counts() == [1, 1, 1]
    pairs = [("out", out, want_out), ("lse", lse[..., None], want_lse[..., None])]
    pairs += list(zip(("dq", "dk", "dv"), got, want))
    for name, a, b in pairs:
        assert a.shape == b.shape and a.dtype == b.dtype, name
        err = _row_rel(a, b)
        assert err <= FLASH_RTOL[dtype], (name, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_gradients_match_plain_autograd(dev, case, dtype):
    q, k, v, g, causal, window = _flash_inputs(dev, case, dtype)
    results = {}
    for impl in ("cuda", "plain"):
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        _build.launches.clear()
        out = fa.flash_attention(qq, kk, vv, causal, window, impl=impl)
        results[impl] = (out, *torch.autograd.grad(out, (qq, kk, vv), g))
        torch.cuda.synchronize()
        assert _counts() == ([1, 1, 1] if impl == "cuda" else [0, 0, 0])
    for name, a, b in zip(("out", "dq", "dk", "dv"), results["cuda"], results["plain"]):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        err = _rel(a, b)
        assert err <= FLASH_RTOL[dtype], (name, err)


def test_flash_f32_partials(dev):
    r = np.random.default_rng(5)
    q = torch.as_tensor(r.standard_normal((1, 4, 96, 64))).to(dev, torch.bfloat16)
    k, v = (torch.as_tensor(r.standard_normal((1, 2, 96, 64))).to(dev, torch.bfloat16)
            for _ in range(2))
    do = torch.as_tensor(r.standard_normal((1, 4, 96, 64))).to(dev, torch.bfloat16)
    out, lse = fa.flash_forward(q, k, v, True)
    delta = (do.float() * out.float()).sum(-1)
    got = fa.flash_backward_blocks(q, k, v, do, lse, delta, True, grad_dtype=torch.float32)
    want = fa.flash_backward_blocks(q, k, v, do, lse, delta, True, grad_dtype=torch.float32,
                                    impl="plain")
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        assert _row_rel(a, b) <= FLASH_RTOL[torch.bfloat16]


def test_flash_wrapper_refuses_what_the_kernel_does_not_take(dev):
    q = torch.randn(1, 2, 64, 64, device=dev)
    k = torch.randn(1, 1, 64, 64, device=dev)
    _build.launches.clear()
    for args in [
        (q.half(), k.half(), k.half()),                              # dtype
        (q, k.bfloat16(), k),                                        # mixed dtypes
        (q[..., :16].contiguous(), k[..., :16].contiguous(),
         k[..., :16].contiguous()),                                  # head_dim 16
        (torch.cat([q, q], -1)[..., ::2], k, k),                     # strided
        (q, k.cpu(), k.cpu()),                                       # device
    ]:
        with pytest.raises(ValueError):
            fa.flash_forward_cuda(*args)
    assert sum(_build.launches.values()) == 0
