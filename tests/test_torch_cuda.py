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

The int8 matmul kernel (K7) is held against its plain version per
output row, max |kernel - plain| over the row's largest |plain|: bf16
8e-3, about two bf16 ulps (both round one float32 sum per element once;
the sums run in another order); float32 1e-5 (float32 FMA sums in
another order).  The GEMM route (shapes out of the kernel's range)
keeps torch.mm's sums in float32 until after the scale, as the plain
version does: bf16 within one ulp of each row's largest |plain|,
float32 1e-5.

The fused BatchNorm kernels (K5, K6) are held against their plain
versions on the same inputs.  float32: y within 1e-4 of the tensor's
largest |y| and the moments within 1e-5 relative (the sums run in
another order); dx, dgamma and dbeta within 1e-4 of each tensor's
largest value.  bf16: y within one bf16 ulp of each element, the ulp
taken at no less than |y| = 1/16 (both round one float32 value once, but
the kernel's fused multiply-add and the plain multiply-then-add differ
by a float32 rounding of the O(1) terms, several bf16 ulps of a y that
cancels to near zero), dres
bit for bit (the same masked dy), dx within 1e-2 of the tensor's
largest |dx| (an element that cancels to near zero may round one ulp of
the tensor's scale away).  Through autograd (K5 + K6 against the plain
Function): every gradient within 1e-4 (float32) or 2e-2 (bf16) of its
tensor's largest value.  K5's own cases (every ResNet-50 class, more rows
than the grid holds on chip, ragged shapes up to C = 20000): y as above,
the moments within 1e-4 relative (sums of up to 401,408 rows a channel in
another order), and the same bits from run to run.

At the speculative verify shape (8 seats, spec_k 4, 7B width) K4 runs
5 query rows a head and K7 40 rows, each held as above; a speculating
tiny pool through both kernels decodes the plain pool's tokens.

The paged pool's swap copies (preemption to pinned host memory and back
into other block ids) are held bit for bit, and a preempted request's
tokens, greedy and seeded, equal an undisturbed pool's exactly.
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
from tf_operator_tpu_torch.ops import fused_batchnorm as fb
from tf_operator_tpu_torch.ops import quant_matmul as qm
from tf_operator_tpu_torch.ops.paged_attention import KERNEL, launch_plan, paged_attention_multi
from tf_operator_tpu_torch.ops.quant import QTensor, quantize_array

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 5e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rig(dev, seed, *, s, h, hkv, d, bs, mb, k_new, dtype, overshoot=False, lengths=None):
    r = np.random.default_rng(seed)
    nb = s * mb + 1
    q = r.standard_normal((s, k_new, h, d))
    ka = r.standard_normal((nb, hkv, bs, d))
    va = r.standard_normal((nb, hkv, bs, d))
    ka[0] = va[0] = 1e4  # poisoned scratch
    tables = r.permutation(np.arange(1, nb))[: s * mb].reshape(s, mb).astype(np.int32)
    if lengths is not None:
        lengths = np.asarray(lengths, dtype=np.int32)
    else:
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


#: the context split (launch_plan: 8 ranges of 128 positions at MB * bs =
#: 1024 on a grid this small): seats on and next to a range boundary, a seat under one range
#: beside seats at the table's end, GQA group 4 with 4 draft tokens (16
#: rows: four row groups of CTAs), and appends past the table beside the
#: poisoned scratch block, over several ranges
SPLIT_CASES = {
    "split_boundary": dict(s=4, h=8, hkv=8, d=128, bs=16, mb=64, k_new=1,
                           lengths=[128, 129, 127, 256]),
    "short_beside_full": dict(s=4, h=4, hkv=2, d=64, bs=16, mb=64, k_new=2,
                              lengths=[1024, 5, 1024, 2]),
    "gqa4_k4": dict(s=3, h=16, hkv=4, d=64, bs=16, mb=40, k_new=4),
    # seat 0 appended 2 tokens past its full table (384 positions); the
    # others' unused entries point at the poisoned scratch block
    "overshoot_splits": dict(s=3, h=4, hkv=2, d=32, bs=8, mb=48, k_new=2,
                             lengths=[386, 100, 7]),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_kernel_matches_plain(dev, case, dtype):
    args = _rig(dev, 11, dtype=dtype, **SPLIT_CASES[case])
    splits, chunk = launch_plan(args[0], args[1], args[3])
    assert splits > 1
    if case == "split_boundary":
        assert chunk == 128
    got = paged_attention_multi(*args)
    torch.cuda.synchronize()
    want = paged_attention_multi(*args, impl="plain")
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype], err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_split_kernel_is_bit_identical_across_runs(dev, dtype):
    """The splits meet in rank order, with no atomics: the same bits
    every run."""

    args = _rig(dev, 12, dtype=dtype, s=6, h=8, hkv=2, d=128, bs=16, mb=96, k_new=3)
    first = paged_attention_multi(*args)
    for _ in range(3):
        assert torch.equal(paged_attention_multi(*args), first)


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
    assert _build.launches[KERNEL] == cfg.n_layers * pool.ledger.count("step") * pool.steps_per_sync > 0
    for p, rid in zip(prompts, rids):
        want = generate(model, torch.as_tensor(p[None]).to(dev), 10)[0].cpu().numpy()
        np.testing.assert_array_equal(pool.result(rid), want)


def test_swap_round_trip_is_bit_exact_after_the_blocks_are_reused(dev):
    """Swap-out of arena rows to pinned host memory, the freed rows
    overwritten by another owner, swap-in to other ids: the rows come
    back bit for bit, in every layer's K and V (bf16, as served)."""

    cfg = llama_tiny(vocab_size=256, max_len=64)
    model = LlamaLM.from_state_dict(cfg, init_params(cfg, 1, dev), dev)
    pool = PagedContinuousBatchingDecoder(model, slots=2, kv_block_size=8, kv_blocks=12)
    g = torch.Generator(device=dev).manual_seed(0)
    for k, v in pool._arena:
        for a in (k, v):
            a.copy_(torch.randn(a.shape, generator=g, device=dev, dtype=torch.float32))
    src, dst = [3, 7, 4], [9, 1, 12]
    want = [(k[src].clone(), v[src].clone()) for k, v in pool._arena]
    host = pool._swap_out(src)
    assert host.device.type == "cpu" and host.is_pinned()
    assert tuple(host.shape) == (cfg.n_layers, 2, 3, cfg.kv_heads, 8, cfg.head_dim)
    for k, v in pool._arena:  # the freed blocks are reused and overwritten
        k[src + dst] = 1.0
        v[src + dst] = -1.0
    pool._swap_in(host, dst)
    torch.cuda.synchronize()
    for (k, v), (wk, wv) in zip(pool._arena, want):
        assert torch.equal(k[dst], wk) and torch.equal(v[dst], wv)
    assert [(e["direction"], e["blocks"]) for e in pool.swap_log] == [("out", 3), ("in", 3)]
    assert all(e["events"][0].elapsed_time(e["events"][1]) > 0 for e in pool.swap_log)


@pytest.mark.parametrize("seeded", [False, True], ids=["greedy", "seeded"])
def test_tiny_pool_preempted_request_matches_an_undisturbed_pool(dev, seeded):
    """The preemption scenario of ``tests/test_torch_preemption.py`` on
    the card, through K4: a batch request preempted by an interactive
    admission (its blocks swapped out, the freed blocks taken by the
    interactive seat) resumes and decodes the tokens of an undisturbed
    pool, greedy and seeded."""

    cfg = llama_tiny(vocab_size=256, max_len=64, dtype=torch.float32)
    model = LlamaLM.from_state_dict(cfg, init_params(cfg, 1, dev), dev)
    r = np.random.default_rng(3)
    prompt_a, prompt_i = r.integers(0, 256, 6), r.integers(0, 256, 33)

    def kw():
        if not seeded:
            return {}
        return dict(temperature=0.9, top_k=40,
                    generator=torch.Generator(device=dev).manual_seed(5))

    solo = PagedContinuousBatchingDecoder(model, slots=4, kv_block_size=16, steps_per_sync=8)
    rid = solo.submit(prompt_a, 24, **kw())
    solo.run()
    want = solo.result(rid)
    pool = PagedContinuousBatchingDecoder(model, slots=4, kv_block_size=16, kv_blocks=4,
                                          steps_per_sync=8)
    _build.launches.clear()
    a = pool.submit(prompt_a, 24, **kw())
    pool.step()
    pool.step()
    i = pool.submit(prompt_i, 8, tier="interactive")
    pool.run()
    assert _build.launches[KERNEL] == cfg.n_layers * pool.ledger.count("step") * pool.steps_per_sync > 0
    assert pool.preemptions == 1
    assert pool.swap.bytes_out_total == pool.swap.bytes_in_total > 0
    np.testing.assert_array_equal(pool.result(a), want)
    assert pool.result(i).shape == (41,)
    pool.alloc.check()
    assert len(pool.swap) == 0


FLASH_RTOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
FLASH_CASES = {
    "causal_gqa": dict(b=2, h=4, hkv=2, sq=130, sk=130, d=64, causal=True),
    "noncausal_cross": dict(b=1, h=2, hkv=1, sq=70, sk=200, d=128, causal=False),
    "causal_sq_gt_sk": dict(b=1, h=2, hkv=2, sq=150, sk=90, d=32, causal=True),
    "causal_sq_lt_sk": dict(b=1, h=4, hkv=1, sq=64, sk=192, d=128, causal=True),
    "window": dict(b=1, h=2, hkv=1, sq=300, sk=300, d=64, causal=True, window=37),
}
#: the edges of the Hopper tiling (128 q rows a K1 or K2 CTA, 64 a
#: consumer warpgroup, kv tiles of 64; 64 kv rows a K3 CTA, q tiles of
#: 64): two full 128-row tiles a row of CTAs under a causal GQA mask; a
#: ragged tail inside one TMA box; a kv tile across the diagonal at a
#: non-square offset; the 64-byte swizzle route; a window that cuts
#: tiles; a 128-row q tile cut by Sq inside its second warpgroup (rows
#: 192..199 of 128..255); four query heads a kv head under the causal
#: mask.  bf16 only: the Hopper kernels are the bf16 path (float32 runs
#: the FMA kernels, whose cases are above)
HOPPER_FLASH_CASES = {
    "s2048_causal_gqa": dict(b=1, h=4, hkv=2, sq=2048, sk=2048, d=128, causal=True),
    "ragged_s1000": dict(b=1, h=2, hkv=1, sq=1000, sk=1000, d=64, causal=False),
    "causal_sq192_sk320": dict(b=1, h=2, hkv=1, sq=192, sk=320, d=128, causal=True),
    "d96_causal_gqa": dict(b=1, h=4, hkv=2, sq=300, sk=300, d=96, causal=True),
    "window200_s1024": dict(b=1, h=2, hkv=1, sq=1024, sk=1024, d=128, causal=True,
                            window=200),
    "sq200_causal_d64": dict(b=1, h=2, hkv=1, sq=200, sk=200, d=64, causal=True),
    "gqa4_causal": dict(b=2, h=8, hkv=2, sq=640, sk=640, d=128, causal=True),
}


def _row_rel(got, want):
    got, want = got.float(), want.float()
    floor = 1e-3 * want.abs().max().clamp_min(1e-30)
    return ((got - want).abs().amax(-1) / want.abs().amax(-1).maximum(floor)).max().item()


def _row_ulps(got, want):
    """max over rows of max |got - want| in bf16 ulps of the row's
    largest |want|"""
    got, want = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().amax(-1).clamp_min(1e-30))) - 7)
    return ((got - want).abs().amax(-1) / ulp).max().item()


def _rel(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


_DTYPE_IDS = {torch.float32: "f32", torch.bfloat16: "bf16"}
FLASH_PARAMS = [pytest.param(case, dtype, id=f"{case}-{_DTYPE_IDS[dtype]}")
                for case in sorted(FLASH_CASES) for dtype in (torch.float32, torch.bfloat16)]
FLASH_PARAMS += [pytest.param(case, torch.bfloat16, id=f"{case}-bf16")
                 for case in sorted(HOPPER_FLASH_CASES)]


def _flash_inputs(dev, case, dtype):
    c = dict(FLASH_CASES.get(case) or HOPPER_FLASH_CASES[case])
    window = c.pop("window", None)
    r = np.random.default_rng(len(case))
    shapes = {"q": (c["b"], c["h"], c["sq"], c["d"]), "k": (c["b"], c["hkv"], c["sk"], c["d"])}
    q, k, v, g = (torch.as_tensor(r.standard_normal(shapes[n])).to(dev, dtype)
                  for n in ("q", "k", "k", "q"))
    return q, k, v, g, c["causal"], window


def _counts():
    return [_build.launches[n] for n in (fa.KERNEL_FWD, fa.KERNEL_DQ, fa.KERNEL_DKV)]


@pytest.mark.parametrize("case, dtype", FLASH_PARAMS)
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


@pytest.mark.parametrize("case, dtype", FLASH_PARAMS)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_wrapper_refuses_a_base_off_16_bytes(dev, dtype):
    # a contiguous view that starts one element into its storage: TMA
    # (and the float32 kernels' 16-byte copies) cannot read it
    flat = torch.randn(2 * 64 * 64 + 8, device=dev).to(dtype)
    q = flat[1:1 + 2 * 64 * 64].view(1, 2, 64, 64)
    assert q.is_contiguous() and q.data_ptr() % 16
    k = torch.randn(1, 1, 64, 64, device=dev).to(dtype)
    rows = torch.zeros(1, 2, 64, device=dev)
    _build.launches.clear()
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_forward_cuda(q, k, k, True)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_backward_dkv_cuda(q.clone(), k, k, q, rows, rows, True)
    assert sum(_build.launches.values()) == 0


QM_RTOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}
#: (M, K, N, x dtype): the 7B decode shapes, the small N widths of each
#: JAX block width, every row count a tile boundary can cut, float32;
#: then K split unevenly (4128 = 258 steps of 16 over 8 splits), the
#: smallest N at the most rows, one row at the widest K
QM_CASES = [
    (1, 4096, 4096, torch.bfloat16), (8, 4096, 11008, torch.bfloat16),
    (64, 11008, 4096, torch.bfloat16), (8, 4096, 32000, torch.bfloat16),
    (3, 96, 384, torch.bfloat16), (17, 96, 640, torch.bfloat16),
    (40, 96, 768, torch.bfloat16), (64, 96, 1024, torch.bfloat16),
    (8, 96, 384, torch.float32), (57, 352, 256, torch.float32),
    (8, 4128, 4096, torch.bfloat16), (64, 4096, 128, torch.bfloat16),
    (1, 11008, 4096, torch.bfloat16),
]


def _qm_inputs(dev, seed, m, k, n, dtype):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((m, k), generator=g, device=dev).to(dtype)
    qt = quantize_array(torch.randn((k, n), generator=g, device=dev) * 0.02)
    return x, qt


@pytest.mark.parametrize("case", range(len(QM_CASES)))
def test_quant_matmul_kernel_matches_plain(dev, case):
    m, k, n, dtype = QM_CASES[case]
    x, qt = _qm_inputs(dev, case, m, k, n, dtype)
    _build.launches.clear()
    got = qm.quant_matmul(x, qt, dtype)
    torch.cuda.synchronize()
    assert _build.launches == {qm.KERNEL: 1}
    want = qm.quant_matmul(x, qt, dtype, impl="plain")
    assert got.dtype == dtype and got.shape == (m, n)
    assert _row_rel(got, want) <= QM_RTOL[dtype]


def test_quant_matmul_refuses_a_weight_off_16_bytes(dev):
    """The kernel reads the weight in 16-byte loads: a contiguous weight
    view that starts 4 bytes into its storage raises and launches
    nothing."""

    x, qt = _qm_inputs(dev, 0, 8, 96, 512, torch.bfloat16)
    store = torch.empty(qt.q.numel() + 16, dtype=torch.int8, device=dev)
    shifted = store[4:4 + qt.q.numel()].view(qt.q.shape)
    shifted.copy_(qt.q)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    _build.launches.clear()
    with pytest.raises(ValueError, match="16-byte boundary"):
        qm.quant_matmul(x, QTensor(shifted, qt.scale))
    assert not _build.launches


def test_quant_matmul_x_alignment_follows_its_reads(dev):
    """x is held to 16 bytes only where the kernel copies it in 16-byte
    chunks (bf16, up to 16 rows): there a view 4 bytes into its storage
    raises and launches nothing; bf16 x of more rows and float32 x are
    read in 4-byte words and take such a view, with the aligned call's
    result."""

    def shifted(x):
        store = torch.empty(x.numel() + 16, dtype=x.dtype, device=dev)
        lead = 4 // x.element_size()
        view = store[lead:lead + x.numel()].view(x.shape)
        view.copy_(x)
        assert view.is_contiguous() and view.data_ptr() % 16 == 4
        return view

    x, qt = _qm_inputs(dev, 0, 8, 96, 512, torch.bfloat16)
    _build.launches.clear()
    with pytest.raises(ValueError, match="x does not start on a 16-byte boundary"):
        qm.quant_matmul(shifted(x), qt)
    assert not _build.launches
    for m, dtype in ((32, torch.bfloat16), (8, torch.float32)):
        x, qt = _qm_inputs(dev, m, m, 96, 512, dtype)
        _build.launches.clear()
        got = qm.quant_matmul(shifted(x), qt, dtype)
        assert _build.launches == {qm.KERNEL: 1}
        torch.testing.assert_close(got, qm.quant_matmul(x, qt, dtype), rtol=0, atol=0)


def test_quant_matmul_routes_on_the_card(dev):
    """Out of the kernel's range (M > 64, K % 32 != 0, N not a multiple
    of 128) a CUDA call takes the GEMM route, counted under its own name;
    an in-range call the kernel cannot take raises."""

    for m, k, n in ((65, 96, 384), (8, 100, 384), (8, 96, 320), (200, 4096, 4096)):
        x, qt = _qm_inputs(dev, m + k + n, m, k, n, torch.bfloat16)
        _build.launches.clear()
        got = qm.quant_matmul(x, qt)
        assert _build.launches == {qm.GEMM: 1}
        want = qm.quant_matmul(x, qt, impl="plain")
        assert got.dtype == torch.bfloat16
        assert _row_ulps(got, want) <= 1.0
    x, qt = _qm_inputs(dev, 1, 65, 96, 384, torch.float32)
    _build.launches.clear()
    got = qm.quant_matmul(x, qt, torch.float32)
    assert _build.launches == {qm.GEMM: 1}
    assert _row_rel(got, qm.quant_matmul(x, qt, torch.float32, impl="plain")) <= 1e-5
    # every route returns the asked dtype, whatever x's
    for m in (8, 65):
        x, qt = _qm_inputs(dev, m, m, 96, 384, torch.float32)
        got = qm.quant_matmul(x, qt, torch.bfloat16)
        assert got.dtype == torch.bfloat16
        assert _row_ulps(got, qm.quant_matmul(x, qt, torch.bfloat16, impl="plain")) <= 1.0
    x, qt = _qm_inputs(dev, 0, 8, 96, 256, torch.bfloat16)
    _build.launches.clear()
    wide = QTensor(torch.cat([qt.q, qt.q], 1)[:, ::2], qt.scale)  # strided q
    with pytest.raises(ValueError, match="contiguous"):
        qm.quant_matmul(x, wide)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        qm.quant_matmul(x.half(), qt, torch.float16)
    assert not _build.launches


def test_tiny_int8_pool_through_the_kernel_matches_plain_generate(dev):
    cfg = llama_tiny(vocab_size=256, max_len=64, dtype=torch.float32)
    model = LlamaLM.from_state_dict(cfg, init_params(cfg, 2, dev, quantize=True), dev)
    pool = PagedContinuousBatchingDecoder(model, slots=2, steps_per_sync=4, kv_block_size=8)
    prompts = [np.arange(n) % 256 for n in (7, 9, 20)]
    _build.launches.clear()
    rids = [pool.submit(p, 10) for p in prompts]
    pool.run()
    assert _build.launches[qm.KERNEL] > 0 and _build.launches[qm.GEMM] > 0
    plain = model.variant(plain_kernels=True)
    for p, rid in zip(prompts, rids):
        want = generate(plain, torch.as_tensor(p[None]).to(dev), 10)[0].cpu().numpy()
        np.testing.assert_array_equal(pool.result(rid), want)


#: the speculative verify pass at 7B width (8 seats, spec_k 4): K4 at
#: k_new = 5 query rows a head (MHA), and K7 at M = 8 x 5 = 40 rows at
#: each projection shape (the verify pass of an int8 target)
VERIFY_K7_SHAPES = [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_verify_shape_k4_matches_plain(dev, dtype):
    args = _rig(dev, 21, dtype=dtype, s=8, h=32, hkv=32, d=128, bs=16, mb=24, k_new=5)
    before = _build.launches[KERNEL]
    got = paged_attention_multi(*args)
    torch.cuda.synchronize()
    assert _build.launches[KERNEL] == before + 1
    want = paged_attention_multi(*args, impl="plain")
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype], err


@pytest.mark.parametrize("k, n", VERIFY_K7_SHAPES, ids=lambda v: str(v))
def test_verify_shape_k7_matches_plain(dev, k, n):
    x, qt = _qm_inputs(dev, k + n, 40, k, n, torch.bfloat16)
    _build.launches.clear()
    got = qm.quant_matmul(x, qt, torch.bfloat16)
    torch.cuda.synchronize()
    assert _build.launches == {qm.KERNEL: 1}
    want = qm.quant_matmul(x, qt, torch.bfloat16, impl="plain")
    assert _row_rel(got, want) <= QM_RTOL[torch.bfloat16]


def test_tiny_speculating_pool_through_the_kernels_matches_the_plain_pool(dev):
    """float32 llama_tiny with its int8 self-draft: the speculating
    pool's greedy tokens through K4 (k_new 1 and spec_k + 1) and K7
    equal the plain pool's."""

    cfg = llama_tiny(vocab_size=256, max_len=64, dtype=torch.float32)
    model = LlamaLM.from_state_dict(cfg, init_params(cfg, 2, dev), dev)
    draft = LlamaLM.from_state_dict(cfg, init_params(cfg, 2, dev, quantize=True), dev)
    prompts = [np.arange(n) % 256 for n in (7, 9, 20)]
    plain = PagedContinuousBatchingDecoder(model, slots=3, steps_per_sync=4, kv_block_size=8)
    want = [plain.submit(p, 12, tier="interactive") for p in prompts]
    plain.run()
    spec = PagedContinuousBatchingDecoder(model, slots=3, steps_per_sync=4, kv_block_size=8,
                                          draft_model=draft, spec_k=3)
    _build.launches.clear()
    rids = [spec.submit(p, 12, tier="interactive") for p in prompts]
    spec.run()
    assert _build.launches[KERNEL] > 0 and _build.launches[qm.KERNEL] > 0
    for rid, w in zip(rids, want):
        np.testing.assert_array_equal(spec.result(rid), plain.result(w))
    snap = spec.spec_snapshot()
    assert snap["spec_accepted"] > 0 and snap["launches_per_token"] > 0


BN_SHAPES = [(4, 8, 8, 64), (8, 28, 28, 128), (2, 3, 3, 5), (34, 1, 1, 7), (1, 9, 5, 130),
             (2, 7, 7, 2048)]
BN_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _bn_inputs(dev, shape, dtype, seed=0):
    r = np.random.default_rng(seed)
    c = shape[-1]
    to = lambda a, dt=dtype: torch.as_tensor(a, dtype=torch.float32).to(dev, dt)
    return (to(r.standard_normal(shape) * 2 + 0.3), to(r.standard_normal(c), torch.float32),
            to(r.standard_normal(c), torch.float32), to(r.standard_normal(shape)),
            to(r.standard_normal(shape)))


def _bf16_ulps(got, want):
    """max over elements of |got - want| in bf16 ulps of max(|want|, 1/16)"""
    got, want = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -4))) - 7)
    return ((got - want).abs() / ulp).max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", BN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_fused_batchnorm_kernels_match_plain(dev, shape, dtype):
    x, gamma, beta, res, dy = _bn_inputs(dev, shape, dtype)
    c = shape[-1]
    x2, res2, dy2 = x.reshape(-1, c), res.reshape(-1, c), dy.reshape(-1, c)
    for relu in (False, True):
        for r2 in (None, res2):
            _build.launches.clear()
            fb.plain_calls.clear()
            y, m, v = fb.fused_batchnorm_fwd_cuda(x2, gamma, beta, 1e-5, relu, r2)
            dx, dg, db, dr = fb.fused_batchnorm_bwd_cuda(dy2, x2, gamma, y, m, v, 1e-5, relu,
                                                         r2 is not None)
            torch.cuda.synchronize()
            assert dict(_build.launches) == {fb.KERNEL_FWD: 1, fb.KERNEL_BWD: 1}
            assert not fb.plain_calls
            py, pm, pv = fb.fused_batchnorm_fwd_plain(x2, gamma, beta, 1e-5, relu, r2)
            # the backward on the same inputs (the kernel's y, mean, var)
            pdx, pdg, pdb, pdr = fb.fused_batchnorm_bwd_plain(dy2, x2, gamma, y, m, v, 1e-5,
                                                              relu, r2 is not None)
            assert y.dtype == dtype and dx.dtype == dtype and m.dtype == torch.float32
            torch.testing.assert_close(m, pm, rtol=1e-5, atol=1e-6)
            torch.testing.assert_close(v, pv, rtol=1e-5, atol=1e-6)
            if dtype == torch.float32:
                assert _rel(y, py) <= 1e-4
                assert _rel(dx, pdx) <= 1e-4
            else:
                assert _bf16_ulps(y, py) <= 1.0
                assert _rel(dx, pdx) <= 1e-2
            assert _rel(dg, pdg) <= 1e-4 and _rel(db, pdb) <= 1e-4
            if r2 is None:
                assert dr is None
            else:
                assert torch.equal(dr, pdr)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(4, 8, 8, 64), (1, 9, 5, 130)], ids=["c64", "c130"])
def test_fused_batchnorm_gradients_match_plain_autograd(dev, shape, dtype):
    x, gamma, beta, res, dy = _bn_inputs(dev, shape, dtype, seed=1)
    grads = {}
    for impl in (None, "plain"):
        ts = [t.clone().requires_grad_() for t in (x, gamma, beta, res)]
        _build.launches.clear()
        y, _, _ = fb.fused_batchnorm(ts[0], ts[1], ts[2], relu=True, residual=ts[3], impl=impl)
        y.backward(dy)
        launched = dict(_build.launches)
        assert launched == ({fb.KERNEL_FWD: 1, fb.KERNEL_BWD: 1} if impl is None else {})
        grads[impl] = [y] + [t.grad for t in ts]
    for name, a, b in zip(("y", "dx", "dgamma", "dbeta", "dres"), grads[None], grads["plain"]):
        assert _rel(a, b) <= BN_TOL[dtype], name


def test_fused_batchnorm_vector_and_scalar_paths_agree(dev):
    """A 16-byte-misaligned x takes the masked scalar loads; the result
    is the aligned call's, bit for bit (the same sums in the same order)."""

    x, gamma, beta, _, dy = _bn_inputs(dev, (6, 5, 5, 64), torch.bfloat16)
    x2 = x.reshape(-1, 64)
    store = torch.empty(x2.numel() + 1, dtype=x2.dtype, device=dev)
    shifted = store[1:].view_as(x2)
    shifted.copy_(x2)
    assert shifted.data_ptr() % 16 and shifted.is_contiguous()
    a = fb.fused_batchnorm_fwd_cuda(x2, gamma, beta, 1e-5, True, None)
    b = fb.fused_batchnorm_fwd_cuda(shifted, gamma, beta, 1e-5, True, None)
    for u, w in zip(a, b):
        assert torch.equal(u, w)


def test_fused_batchnorm_wrapper_refuses_what_the_kernel_does_not_take(dev):
    x, gamma, beta, res, _ = _bn_inputs(dev, (2, 4, 4, 64), torch.bfloat16)
    _build.launches.clear()
    fb.plain_calls.clear()
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fb.fused_batchnorm(x.half(), gamma, beta)
    with pytest.raises(ValueError, match="residual must be"):
        fb.fused_batchnorm(x, gamma, beta, residual=res.float())
    with pytest.raises(ValueError, match="contiguous"):
        fb.fused_batchnorm(x.transpose(1, 2), gamma, beta)
    with pytest.raises(ValueError, match="gamma"):
        fb.fused_batchnorm_fwd_cuda(x.reshape(-1, 64), gamma.cpu(), beta, 1e-5, False, None)
    assert not _build.launches and not fb.plain_calls


#: every (R, C, relu, residual) class of ResNet-50's norms at batch 8 and
#: 224 px, as NHWC shapes
RESNET50_B8 = [((8, 112, 112, 64), True, False), ((8, 56, 56, 64), True, False),
               ((8, 56, 56, 256), False, False), ((8, 56, 56, 256), True, True),
               ((8, 56, 56, 128), True, False), ((8, 28, 28, 128), True, False),
               ((8, 28, 28, 512), False, False), ((8, 28, 28, 512), True, True),
               ((8, 28, 28, 256), True, False), ((8, 14, 14, 256), True, False),
               ((8, 14, 14, 1024), False, False), ((8, 14, 14, 1024), True, True),
               ((8, 14, 14, 512), True, False), ((8, 7, 7, 512), True, False),
               ((8, 7, 7, 2048), False, False), ((8, 7, 7, 2048), True, True)]


def _check_bwd(dev, shape, dtype, relu, use_res, seed=0):
    """K6 against its plain version on the same inputs (K5's y, mean and
    var), at the module docstring's tolerances; returns K6's outputs."""

    x, gamma, beta, res, dy = _bn_inputs(dev, shape, dtype, seed)
    c = shape[-1]
    x2, dy2 = x.reshape(-1, c), dy.reshape(-1, c)
    r2 = res.reshape(-1, c) if use_res else None
    y, m, v = fb.fused_batchnorm_fwd_cuda(x2, gamma, beta, 1e-5, relu, r2)
    _build.launches.clear()
    out = fb.fused_batchnorm_bwd_cuda(dy2, x2, gamma, y, m, v, 1e-5, relu, use_res)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {fb.KERNEL_BWD: 1}
    dx, dg, db, dr = out
    pdx, pdg, pdb, pdr = fb.fused_batchnorm_bwd_plain(dy2, x2, gamma, y, m, v, 1e-5, relu,
                                                      use_res)
    assert _rel(dx, pdx) <= (1e-4 if dtype == torch.float32 else 1e-2)
    assert _rel(dg, pdg) <= 1e-4 and _rel(db, pdb) <= 1e-4
    assert dr is None if not use_res else torch.equal(dr, pdr)
    return out, (dy2, x2, gamma, y, m, v, relu, use_res)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("cls", RESNET50_B8,
                         ids=lambda c: "x".join(map(str, c[0])) + "_relu" * c[1] + "_res" * c[2])
def test_fused_batchnorm_backward_every_resnet50_class(dev, cls, dtype):
    shape, relu, use_res = cls
    _check_bwd(dev, shape, dtype, relu, use_res)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fused_batchnorm_backward_past_what_fits_on_chip(dev, dtype):
    """[200704, 64]: more rows than the grid's shared memory holds, so
    each CTA's first rows are read again from device memory or L2."""

    shape = (16, 112, 112, 64)
    elem = torch.finfo(dtype).bits // 8
    ctas, hold = fb.bwd_resources(fb._DTYPE_CODES[dtype], 1, 1, 1)
    r = shape[0] * shape[1] * shape[2]
    assert fb.bwd_held_bytes(r, 64, ctas, hold, elem) < 2 * elem * r * 64
    _check_bwd(dev, shape, dtype, True, True, seed=3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(3, 7, 7, 72), (5, 11, 11, 13), (2, 33, 33, 136),
                                   (1, 9, 5, 130)], ids=lambda s: "x".join(map(str, s)))
def test_fused_batchnorm_backward_ragged_every_epilogue(dev, shape, dtype):
    for relu in (False, True):
        for use_res in (False, True):
            _check_bwd(dev, shape, dtype, relu, use_res, seed=4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(8, 28, 28, 512), (8, 112, 112, 64), (5, 11, 11, 13)],
                         ids=lambda s: "x".join(map(str, s)))
def test_fused_batchnorm_backward_is_bit_identical_across_runs(dev, shape, dtype):
    """Partials and totals are added in a fixed order, with no atomics:
    dgamma, dbeta, dx and dres have the same bits every run."""

    first, args = _check_bwd(dev, shape, dtype, True, True, seed=5)
    for _ in range(2):
        again = fb.fused_batchnorm_bwd_cuda(*args[:6], 1e-5, *args[6:])
        for a, b in zip(first, again):
            assert torch.equal(a, b)


def _check_fwd(dev, shape, dtype, relu, use_res, seed=0):
    """K5 against its plain version on the same inputs: mean and var
    within 1e-4 relative, y within one bf16 ulp (bf16) or 1e-4 of the
    tensor's largest |y| (float32); returns K5's outputs and inputs."""

    x, gamma, beta, res, _ = _bn_inputs(dev, shape, dtype, seed)
    c = shape[-1]
    x2 = x.reshape(-1, c)
    r2 = res.reshape(-1, c) if use_res else None
    _build.launches.clear()
    fb.plain_calls.clear()
    out = fb.fused_batchnorm_fwd_cuda(x2, gamma, beta, 1e-5, relu, r2)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {fb.KERNEL_FWD: 1} and not fb.plain_calls
    y, m, v = out
    py, pm, pv = fb.fused_batchnorm_fwd_plain(x2, gamma, beta, 1e-5, relu, r2)
    assert y.dtype == dtype and m.dtype == torch.float32 and v.dtype == torch.float32
    torch.testing.assert_close(m, pm, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(v, pv, rtol=1e-4, atol=1e-6)
    if dtype == torch.float32:
        assert _rel(y, py) <= 1e-4
    else:
        assert _bf16_ulps(y, py) <= 1.0
    return out, (x2, gamma, beta, 1e-5, relu, r2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("cls", RESNET50_B8,
                         ids=lambda c: "x".join(map(str, c[0])) + "_relu" * c[1] + "_res" * c[2])
def test_fused_batchnorm_forward_every_resnet50_class(dev, cls, dtype):
    shape, relu, use_res = cls
    _check_fwd(dev, shape, dtype, relu, use_res)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fused_batchnorm_forward_past_what_fits_on_chip(dev, dtype):
    """[401408, 64]: more rows of x than the grid's shared memory holds,
    so each CTA's first rows are read again from device memory or L2."""

    shape = (32, 112, 112, 64)
    elem = torch.finfo(dtype).bits // 8
    ctas, hold = fb.fwd_resources(fb._DTYPE_CODES[dtype], 1, 1, 1)
    r = shape[0] * shape[1] * shape[2]
    assert fb.fwd_held_bytes(r, 64, ctas, hold, elem) < elem * r * 64
    _check_fwd(dev, shape, dtype, True, True, seed=3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(3, 7, 7, 72), (5, 11, 11, 13), (2, 33, 33, 136),
                                   (1, 9, 5, 130), (1, 1, 7, 20000)],
                         ids=lambda s: "x".join(map(str, s)))
def test_fused_batchnorm_forward_ragged_every_epilogue(dev, shape, dtype):
    """Ragged C, rows under a chunk, and C = 20000 (more channel tiles
    than CTAs: a CTA takes several items and holds the last one's rows)."""

    for relu in (False, True):
        for use_res in (False, True):
            _check_fwd(dev, shape, dtype, relu, use_res, seed=4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(8, 28, 28, 512), (8, 112, 112, 64), (32, 112, 112, 64),
                                   (5, 11, 11, 13)], ids=lambda s: "x".join(map(str, s)))
def test_fused_batchnorm_forward_is_bit_identical_across_runs(dev, shape, dtype):
    """Partials and totals are added in a fixed order, with no atomics,
    and the held rows are x itself: y, mean and var have the same bits
    every run."""

    first, args = _check_fwd(dev, shape, dtype, True, True, seed=5)
    for _ in range(2):
        again = fb.fused_batchnorm_fwd_cuda(*args)
        for a, b in zip(first, again):
            assert torch.equal(a, b)
