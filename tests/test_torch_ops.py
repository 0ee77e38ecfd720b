"""The port's ops against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and fed to both sides.  The
paged-attention plain version is held against the JAX ``xla`` gather
reference and the JAX Pallas kernel in interpret mode.  Tolerances:
float32 atol 1e-5 (summation order differs between the frameworks);
bfloat16 atol 2e-2 (the two round at different points, and the output
itself is bf16 with a relative step of 2^-8).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tf_operator_tpu.ops.attention import dot_product_attention as j_attention
from tf_operator_tpu.ops.paged_attention import (
    paged_attention as j_paged_attention,
    paged_attention_multi as j_paged_attention_multi,
)
from tf_operator_tpu.ops.rotary import apply_rope as j_apply_rope

from tf_operator_tpu_torch.ops import _build
from tf_operator_tpu_torch.ops.attention import dot_product_attention
from tf_operator_tpu_torch.ops.paged_attention import (
    MAX_SPLITS,
    SPLIT_MIN_POSITIONS,
    kernel_rows,
    paged_attention,
    paged_attention_multi,
    split_plan,
)
from tf_operator_tpu_torch.ops.rotary import apply_rope

torch.set_num_threads(2)

DTYPES = {
    "f32": (torch.float32, jnp.float32, 1e-5),
    "bf16": (torch.bfloat16, jnp.bfloat16, 2e-2),
}


def _pair(a, dtype_name):
    """The same numbers as a torch and a jax array of one dtype."""

    tdt, jdt, _ = DTYPES[dtype_name]
    t = torch.tensor(a, dtype=torch.float32).to(tdt)
    return t, jnp.asarray(t.float().numpy(), jdt)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize(
    "case", ["causal", "masked", "gqa_causal", "window"],
)
def test_dot_product_attention_matches_jax(case, dtype):
    r = np.random.default_rng(0)
    b, h, s, d = 2, 4, 9, 16
    hkv = 2 if case == "gqa_causal" else h
    q, jq = _pair(r.standard_normal((b, h, s, d)), dtype)
    k, jk = _pair(r.standard_normal((b, hkv, s, d)), dtype)
    v, jv = _pair(r.standard_normal((b, hkv, s, d)), dtype)
    kw = {}
    if case in ("causal", "gqa_causal"):
        kw = dict(causal=True)
    elif case == "window":
        kw = dict(causal=True, window=3)
    if case == "masked":
        m = r.random((b, 1, s, s)) < 0.7
        m[..., 0] = True
        got = dot_product_attention(q, k, v, mask=torch.as_tensor(m))
        want = j_attention(jq, jk, jv, mask=jnp.asarray(m))
    else:
        got = dot_product_attention(q, k, v, **kw)
        want = j_attention(jq, jk, jv, **kw)
    assert got.dtype == DTYPES[dtype][0]
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=DTYPES[dtype][2], rtol=0)


def test_fully_masked_row_is_finite_like_jax():
    # the finfo.min fill (not -inf) keeps a row with nothing visible
    # finite: it averages v, as the JAX reference does
    r = np.random.default_rng(1)
    q, k, v = (r.standard_normal((1, 2, 3, 8)).astype(np.float32) for _ in range(3))
    m = np.zeros((1, 1, 3, 3), bool)
    got = dot_product_attention(*map(torch.as_tensor, (q, k, v)), mask=torch.as_tensor(m))
    want = j_attention(*map(jnp.asarray, (q, k, v)), mask=jnp.asarray(m))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-6, rtol=0)


@pytest.mark.parametrize("positions", ["default", "per_seat"])
def test_apply_rope_matches_jax(positions):
    r = np.random.default_rng(2)
    q = r.standard_normal((3, 4, 5, 32)).astype(np.float32)
    k = r.standard_normal((3, 2, 5, 32)).astype(np.float32)
    pos = None
    if positions == "per_seat":
        pos = (np.array([0, 7, 130])[:, None, None] + np.arange(5)[None, None, :])
    tq, tk = apply_rope(torch.as_tensor(q), torch.as_tensor(k),
                        None if pos is None else torch.as_tensor(pos))
    jq, jk = j_apply_rope(jnp.asarray(q), jnp.asarray(k),
                          None if pos is None else jnp.asarray(pos))
    np.testing.assert_allclose(tq.numpy(), _np(jq), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tk.numpy(), _np(jk), atol=1e-6, rtol=0)


def _paged_rig(seed, *, s=3, h=4, hkv=2, d=32, bs=8, mb=4, k_new=1,
               poison_scratch=False):
    r = np.random.default_rng(seed)
    nb = s * mb + 1
    q = r.standard_normal((s, k_new, h, d))
    ka = r.standard_normal((nb, hkv, bs, d))
    va = r.standard_normal((nb, hkv, bs, d))
    if poison_scratch:
        ka[0] = 1e4
        va[0] = 1e4
    tables = r.permutation(np.arange(1, nb))[: s * mb].reshape(s, mb).astype(np.int32)
    lo = k_new
    lengths = r.integers(lo, mb * bs + 1, s).astype(np.int32)
    # block straddles at bs - 1, bs, bs + 1 whenever they fit
    for i, n in enumerate((bs - 1, bs, bs + 1)[:s]):
        if lo <= n <= mb * bs:
            lengths[i] = n
    if poison_scratch:
        # unused table entries point at the poisoned scratch block
        for i in range(s):
            used = -(-int(lengths[i]) // bs)
            tables[i, used:] = 0
    return q, ka, va, tables, lengths


PAGED_CASES = [
    dict(bs=8, hkv=2, k_new=1),
    dict(bs=8, hkv=4, k_new=1),
    dict(bs=12, hkv=2, k_new=1),
    dict(bs=8, hkv=2, k_new=3),
    dict(bs=12, hkv=4, k_new=3),
    dict(bs=8, hkv=2, k_new=1, poison_scratch=True),
    dict(bs=8, hkv=4, k_new=3, poison_scratch=True),
]


@pytest.mark.parametrize("jax_impl", ["xla", "pallas-interpret"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", range(len(PAGED_CASES)))
def test_plain_paged_attention_matches_jax(case, dtype, jax_impl):
    kw = PAGED_CASES[case]
    q, ka, va, tables, lengths = _paged_rig(case, **kw)
    tq, jq = _pair(q, dtype)
    tka, jka = _pair(ka, dtype)
    tva, jva = _pair(va, dtype)
    tt, tl = torch.as_tensor(tables), torch.as_tensor(lengths)
    jt, jl = jnp.asarray(tables), jnp.asarray(lengths)
    if kw["k_new"] == 1:
        got = paged_attention(tq[:, 0], tka, tva, tt, tl)
        want = j_paged_attention(jq[:, 0], jka, jva, jt, jl, impl=jax_impl)
    else:
        got = paged_attention_multi(tq, tka, tva, tt, tl)
        want = j_paged_attention_multi(jq, jka, jva, jt, jl, impl=jax_impl)
    want_shape = tuple(tq[:, 0].shape) if kw["k_new"] == 1 else tuple(tq.shape)
    assert got.dtype == tka.dtype and tuple(got.shape) == want_shape
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=DTYPES[dtype][2], rtol=0)


def test_poisoned_scratch_is_never_observed():
    q, ka, va, tables, lengths = _paged_rig(7, poison_scratch=True, k_new=2)
    args = [torch.as_tensor(a, dtype=torch.float32) for a in (q, ka, va)]
    base = paged_attention_multi(*args, torch.as_tensor(tables), torch.as_tensor(lengths))
    args[1][0] = -3e4  # a different poison in scratch changes nothing
    args[2][0] = 5e4
    again = paged_attention_multi(*args, torch.as_tensor(tables), torch.as_tensor(lengths))
    assert torch.equal(base, again)
    assert base.abs().max() < 100


def test_cuda_impl_on_cpu_tensors_raises_and_never_falls_back():
    q, ka, va, tables, lengths = _paged_rig(3)
    args = [torch.as_tensor(a, dtype=torch.float32) for a in (q[:, 0], ka, va)]
    before = _build.launches["paged_attention"]
    with pytest.raises(ValueError, match="not on a CUDA device"):
        paged_attention(*args, torch.as_tensor(tables), torch.as_tensor(lengths),
                        impl="cuda")
    with pytest.raises(ValueError, match="impl must be"):
        paged_attention(*args, torch.as_tensor(tables), torch.as_tensor(lengths),
                        impl="auto")
    assert _build.launches["paged_attention"] == before


class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports ``is_cuda``: what the dispatcher sees
    of a CUDA tensor on a machine with no card and no nvcc."""

    @property
    def is_cuda(self):
        return True


def test_cuda_tensor_goes_to_the_kernel_or_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("PATH", "/nonexistent-bin")
    q, ka, va, tables, lengths = _paged_rig(4)
    args = [torch.as_tensor(a, dtype=torch.float32).as_subclass(_CudaLooking)
            for a in (q[:, 0], ka, va)]
    tl = [torch.as_tensor(a).as_subclass(_CudaLooking) for a in (tables, lengths)]
    before = _build.launches["paged_attention"]
    # the default dispatch picks the kernel for a CUDA tensor; with no
    # nvcc to build it, the call raises instead of running the plain version
    with pytest.raises((RuntimeError, OSError)):
        paged_attention(*args, *tl)
    assert _build.launches["paged_attention"] == before


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("elem", [2, 4], ids=["bf16", "f32"])
def test_split_plan_covers_the_table(elem, d):
    """The kernel's context split: whole CTA passes, at most 8 ranges
    (one cluster), none empty, together covering MB * bs, and no more
    splits than keep the grid within the card's resident CTAs (528: four
    CTAs on each of 132 SMs)."""

    unit = 4 * 2048 // (d * elem)
    for positions in (1, 8, 40, 128, 129, 384, 1000, 2048, 32768):
        for units in (1, 64, 256, 4096):
            splits, chunk = split_plan(positions, d, elem, units, 528)
            assert 1 <= splits <= MAX_SPLITS and chunk % unit == 0
            assert (splits - 1) * chunk < positions <= splits * chunk
            assert splits <= -(-positions // SPLIT_MIN_POSITIONS)
            assert splits == 1 or splits * units <= 528


def test_split_plan_at_the_7b_decode_shapes():
    # MHA (32 kv heads x 8 seats): 2 ranges of 1024; GQA (8 kv heads): 8
    # of 256; K = 4 on MHA (one row group of 4 rows): as MHA at K = 1
    assert split_plan(2048, 128, 2, 32 * 8, 528) == (2, 1024)
    assert split_plan(2048, 128, 2, 8 * 8, 528) == (8, 256)
    assert kernel_rows(1) == 1 and kernel_rows(2) == 2 and kernel_rows(3) == 4
    assert kernel_rows(16) == 4
