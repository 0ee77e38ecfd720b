"""The port's int8 weights-only serving against the JAX package's, on
the CPU.

- Quantization is bit for bit: the port's ``quantize_array`` and
  ``quantize_state`` give JAX's ``quantize_array`` / ``quantize_tree``
  int8 values and scales on the same float32 inputs, including the
  per-D scale an [E, H, D] kernel shares across heads, the 1e-8 floor of
  a constant-zero column and the name and size gates.
- The matmul: the port's plain ``quant_matmul`` against JAX's K7 run in
  interpret mode (``_quant_matmul_2d(..., interpret=True)``) and against
  JAX's ``quant_matmul`` (the output-scale XLA form).  bf16 outputs agree
  to one bf16 ulp of each output row's largest value (both round one
  float32 sum per element once; the sums run in another order); float32
  outputs to 2e-6 of each row's largest value (float32 sums in another
  order over K <= 100 products).
- The model: ``llama_tiny`` with int8 kernels against ``LlamaLM.apply``
  on JAX's ``quantize_tree(params)`` (float32 logits atol 1e-4 and bf16
  atol 0.1, as the float model's tests hold them), and greedy tokens of
  ``generate`` and of the paged pool identical to JAX's int8 decoding.
"""

import types

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

from tf_operator_tpu.models import llama_tiny as j_llama_tiny
from tf_operator_tpu.models.batching import PagedContinuousBatchingDecoder as JaxPool
from tf_operator_tpu.models.decode import generate as j_generate
from tf_operator_tpu.ops import quant as jquant
from tf_operator_tpu.ops import quant_matmul as jqm

from tf_operator_tpu_torch import serve_lm
from tf_operator_tpu_torch.models.batching import PagedContinuousBatchingDecoder
from tf_operator_tpu_torch.models.decode import generate
from tf_operator_tpu_torch.models.llama import LlamaLM, llama_tiny
from tf_operator_tpu_torch.models.weights import (
    from_flax_params,
    init_params,
    load_npz,
    save_npz,
)
from tf_operator_tpu_torch.ops import _build
from tf_operator_tpu_torch.ops import quant_matmul as qm
from tf_operator_tpu_torch.ops.quant import (
    QTensor,
    is_quantized,
    quantize_array,
    quantize_state,
    state_bytes,
)
from tf_operator_tpu_torch.parallel.checkpoint import export_params

torch.set_num_threads(2)

VOCAB, MAX_LEN, BS = 256, 64, 8


@pytest.fixture(scope="module")
def tiny():
    """llama_tiny float32 params from flax, JAX's quantize_tree of them,
    and the port's int8 model built from that quantized tree."""

    jm = j_llama_tiny(vocab_size=VOCAB, max_len=MAX_LEN, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(5), jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, flax.core.meta.unbox(params))
    qparams = jquant.quantize_tree(params)
    return jm, params, qparams


def _port(state, dtype=torch.float32):
    cfg = llama_tiny(vocab_size=VOCAB, max_len=MAX_LEN, dtype=dtype)
    return LlamaLM.from_state_dict(cfg, state, "cpu")


def _ids(seed, shape):
    return np.random.default_rng(seed).integers(0, VOCAB, shape).astype(np.int32)


def _weights(seed, shape, zero_col=True):
    w = (np.random.default_rng(seed).standard_normal(shape) * 0.05).astype(np.float32)
    if zero_col:
        w[..., 3] = 0.0  # a constant-zero output channel: the 1e-8 floor
    return w


# -- quantization ------------------------------------------------------------


@pytest.mark.parametrize("shape", [(128, 4, 32), (4, 32, 128), (352, 128), (96, 1024)],
                         ids=["EHD", "HDE", "2d", "wide"])
def test_quantize_array_is_bit_exact(shape):
    w = _weights(sum(shape), shape)
    want = jquant.quantize_array(jnp.asarray(w))
    got = quantize_array(torch.from_numpy(w))
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    # one scale per last-axis channel, shared across every other axis
    assert tuple(got.scale.shape) == (1,) * (len(shape) - 1) + (shape[-1],)
    assert got.scale.reshape(-1)[3] == np.float32(1e-8) / np.float32(127.0)


def _gate_tree():
    """Leaves on each side of quantize_tree's gates: a kernel under 4096
    elements, a 1-D kernel, a large bias, an embedding, and kernels at
    and over the size."""

    r = np.random.default_rng(9)

    def w(*shape):
        return (r.standard_normal(shape) * 0.05).astype(np.float32)

    return {"small": {"kernel": w(16, 128)}, "flat": {"kernel": w(5000)},
            "dense": {"kernel": w(64, 64), "bias": w(8192)},
            "tok_embed": {"embedding": w(512, 64)}, "proj": {"kernel": w(32, 4, 64)}}


@pytest.mark.parametrize("which", ["llama_tiny", "gates"])
def test_quantize_state_matches_quantize_tree(tiny, which):
    params = tiny[1] if which == "llama_tiny" else _gate_tree()
    want = from_flax_params(jquant.quantize_tree(params))
    got = quantize_state(from_flax_params(params))
    assert got.keys() == want.keys()
    quantized = {n for n, t in got.items() if isinstance(t, QTensor)}
    assert quantized == {n for n, t in want.items() if isinstance(t, QTensor)}
    for name in got:
        a, b = got[name], want[name]
        if isinstance(a, QTensor):
            assert torch.equal(a.q, b.q) and torch.equal(a.scale, b.scale), name
        else:
            assert torch.equal(a, b), name
    # the name gate: the embedding and norm scales stay float
    assert "tok_embed.embedding" not in quantized
    assert not any(n.endswith((".scale", ".bias")) for n in quantized)
    if which == "gates":
        assert quantized == {"dense.kernel", "proj.kernel"}
    else:
        assert "lm_head.kernel" in quantized and "layers.0.self_attn.key.kernel" in quantized


def test_state_bytes_match_tree_bytes(tiny):
    _, params, qparams = tiny
    float_state, qstate = from_flax_params(params), from_flax_params(qparams)
    assert state_bytes(float_state) == jquant.tree_bytes(params)
    assert state_bytes(qstate) == jquant.tree_bytes(qparams)
    assert is_quantized(qstate) and not is_quantized(float_state)
    assert jquant.is_quantized(qparams)


def test_init_params_quantizes_the_float32_draws():
    """The int8 kernels come from the float32 draws, not from the bf16
    storage copy (quantizing that copy gives other int8 values)."""

    cfg = llama_tiny(vocab_size=VOCAB, max_len=MAX_LEN)  # bf16 storage
    f32 = init_params(cfg, 3, "cpu", trainable=True)
    stored = init_params(cfg, 3, "cpu")
    q = init_params(cfg, 3, "cpu", quantize=True)
    moved = 0
    for name, t in q.items():
        if isinstance(t, QTensor):
            want = quantize_array(f32[name])
            assert torch.equal(t.q, want.q) and torch.equal(t.scale, want.scale), name
            moved += int(not torch.equal(quantize_array(stored[name]).q, t.q))
        else:
            assert torch.equal(t, stored[name]) and t.dtype == stored[name].dtype, name
    assert moved > 0


def test_load_npz_quantizes_as_it_reads(tiny, tmp_path):
    _, params, qparams = tiny
    path = str(tmp_path / "params.npz")
    save_npz(from_flax_params(params), path)
    got = load_npz(path, quantize=True)
    want = from_flax_params(qparams)
    assert got.keys() == want.keys()
    for name, t in got.items():
        if isinstance(t, QTensor):
            assert torch.equal(t.q, want[name].q) and torch.equal(t.scale, want[name].scale)
        else:
            assert torch.equal(t, want[name])


# -- the matmul --------------------------------------------------------------


def _row_ulp_err(got, want):
    """max over rows of max |got - want| in units of one bf16 ulp of the
    row's largest |want|."""

    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    row_max = np.abs(want).max(-1, keepdims=True)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(row_max, 1e-30))) - 7)
    return float((np.abs(got - want) / ulp).max())


def _row_rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    row_max = np.maximum(np.abs(want).max(-1, keepdims=True), 1e-30)
    return float((np.abs(got - want) / row_max).max())


def _matmul_inputs(seed, m, k, feat):
    r = np.random.default_rng(seed)
    x = r.standard_normal((m, k)).astype(np.float32)
    w = _weights(seed + 1, (k, *feat), zero_col=False)
    jqt = jquant.quantize_array(jnp.asarray(w))
    qt = QTensor(torch.tensor(np.asarray(jqt.q)), torch.tensor(np.asarray(jqt.scale)))
    return x, jqt, qt


@pytest.mark.parametrize("n", [384, 640, 768, 1024], ids=lambda n: f"N{n}")
@pytest.mark.parametrize("m", [1, 8, 64])
def test_plain_matches_jax_kernel_in_interpret_mode(m, n):
    """In the kernel's range (K % 32 == 0, N a multiple of 128 at each
    block width, M <= 64): the port's plain version against JAX's
    Pallas K7 in interpret mode, bf16 x."""

    k = 96
    x, jqt, qt = _matmul_inputs(m * n, m, k, (n,))
    block_n = jqm._pick_block_n(n)
    assert qm.pick_block_n(n) == block_n and qm.in_kernel_range(m, k, n)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = jqm._quant_matmul_2d(xb, jqt.q, jqt.scale.reshape(1, n), block_n, interpret=True)
    got = qm.quant_matmul(torch.from_numpy(x).to(torch.bfloat16), qt)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (m, n)
    assert _row_ulp_err(got.float().numpy(), np.asarray(want, np.float32)) <= 1.0


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("k", [96, 100])
@pytest.mark.parametrize("m", [1, 8, 64, 65])
def test_plain_matches_jax_output_scale_form(m, k, dtype):
    """In and out of the kernel's range (K = 100, M = 65), against JAX's
    quant_matmul (the XLA output-scale form), with multi-axis features
    ([K, H, D] and a per-D scale, as the query kernel has)."""

    feat = (4, 96)
    x, jqt, qt = _matmul_inputs(m + k, m, k, feat)
    jdt, tdt = {"bf16": (jnp.bfloat16, torch.bfloat16),
                "f32": (jnp.float32, torch.float32)}[dtype]
    want = np.asarray(jqm.quant_matmul(jnp.asarray(x, jdt), jqt, dtype=jdt), np.float32)
    got = qm.quant_matmul(torch.from_numpy(x).to(tdt), qt, tdt)
    assert got.dtype == tdt and tuple(got.shape) == (m, *feat)
    got, want = got.float().numpy().reshape(m, -1), want.reshape(m, -1)
    if dtype == "bf16":
        assert _row_ulp_err(got, want) <= 1.0
    else:
        assert _row_rel_err(got, want) <= 2e-6
    assert qm.in_kernel_range(m, k, 4 * 96) == (m <= 64 and k == 96)


def test_scale_must_be_per_output_channel():
    q = torch.zeros((96, 128), dtype=torch.int8)
    x = torch.zeros((2, 96))
    bad = jnp.zeros((96, 1), jnp.float32)
    with pytest.raises(ValueError) as jexc:
        jqm.quant_matmul(jnp.asarray(x), jquant.QTensor(jnp.asarray(q.numpy()), bad))
    with pytest.raises(ValueError) as exc:
        qm.quant_matmul(x, QTensor(q, torch.zeros((96, 1))))
    assert str(exc.value) == str(jexc.value)


def test_routes_on_the_cpu():
    """CPU tensors run the plain version and launch nothing, in the
    asked dtype whatever x's; the kernel wrapper refuses CPU tensors."""

    x, _, qt = _matmul_inputs(0, 8, 96, (128,))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    _build.launches.clear()
    out = qm.quant_matmul(xt, qt)
    torch.testing.assert_close(out, qm.quant_matmul(xt, qt, impl="plain"), atol=0, rtol=0)
    assert not _build.launches
    out32 = qm.quant_matmul(xt.float(), qt, torch.bfloat16)
    assert out32.dtype == torch.bfloat16
    torch.testing.assert_close(out32, out, atol=0, rtol=0)
    assert not _build.launches
    with pytest.raises(ValueError, match="not on a CUDA device"):
        qm.quant_matmul_cuda(xt, qt.q, qt.scale)
    with pytest.raises(ValueError, match="impl must be"):
        qm.quant_matmul(xt, qt, impl="triton")
    # the range rule: K % 32, N a multiple of 128, M <= 64
    assert qm.in_kernel_range(64, 4096, 11008) and qm.in_kernel_range(1, 11008, 32000)
    assert not qm.in_kernel_range(8, 100, 128)
    assert not qm.in_kernel_range(8, 96, 64 * 5)
    assert not qm.in_kernel_range(65, 96, 128)


# -- the model ---------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_int8_logits_match_jax(tiny, dtype):
    jm, params, qparams = tiny
    if dtype == "bf16":
        jm = j_llama_tiny(vocab_size=VOCAB, max_len=MAX_LEN)
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    ids = _ids(1, (2, 13))
    want = np.asarray(jm.apply({"params": qparams}, jnp.asarray(ids)))
    model = _port(from_flax_params(qparams), tdt)
    assert model.lm_head.int8 and not model.tok_embed.embedding.dtype == torch.int8
    with torch.inference_mode():
        got = model(torch.as_tensor(ids)).numpy()
        # the port's own quantizer gives the same model, bit for bit
        again = _port(quantize_state(from_flax_params(params)), tdt)(torch.as_tensor(ids))
    np.testing.assert_allclose(got, want, atol=1e-4 if dtype == "f32" else 0.1, rtol=0)
    np.testing.assert_array_equal(again.numpy(), got)


def test_int8_greedy_generate_is_token_identical(tiny):
    jm, _, qparams = tiny
    ids = _ids(2, (2, 11))
    want = np.asarray(j_generate(jm, qparams, jnp.asarray(ids), 24))
    got = generate(_port(from_flax_params(qparams)), torch.as_tensor(ids), 24).numpy()
    np.testing.assert_array_equal(got, want)


def test_int8_pool_is_token_identical_to_jax(tiny):
    """The paged pool on the int8 model against JAX's pool on the
    quantized tree: prompts at the block edge, a shared two-block prefix
    and more requests than seats."""

    jm, _, qparams = tiny
    r = np.random.default_rng(0)
    shared = r.integers(0, VOCAB, 2 * BS)
    mix = [(r.integers(0, VOCAB, 7), 9),
           (np.concatenate([shared, r.integers(0, VOCAB, 5)]), 6),
           (r.integers(0, VOCAB, 9), 5),
           (np.concatenate([shared, r.integers(0, VOCAB, 3)]), 7)]
    jpool = JaxPool(jm, qparams, slots=2, steps_per_sync=4, kv_block_size=BS, kv_blocks=24,
                    paged_kernel="off", reserve="worst-case")
    jrids = [jpool.submit(p, n) for p, n in mix]
    jpool.run()
    model = _port(from_flax_params(qparams))
    pool = PagedContinuousBatchingDecoder(model, slots=2, steps_per_sync=4, kv_block_size=BS,
                                          kv_blocks=24)
    rids = [pool.submit(p, n) for p, n in mix]
    pool.run()
    for rid, jrid in zip(rids, jrids):
        np.testing.assert_array_equal(pool.result(rid), jpool.result(jrid))
    # the pool's decode views hold the same int8 buffers, not copies
    for view in (pool.dmodel, pool.pmodel):
        assert view.lm_head is model.lm_head
        assert view.layers[0].mlp.wo.kernel_q.data_ptr() == model.layers[0].mlp.wo.kernel_q.data_ptr()


def test_int8_model_holds_no_float_kernel(tiny):
    _, params, _ = tiny
    cfg = llama_tiny(vocab_size=VOCAB, max_len=MAX_LEN)
    model = LlamaLM.from_state_dict(cfg, quantize_state(from_flax_params(params)), "cpu")
    names = dict(model.named_parameters())
    assert "lm_head.kernel" not in names and "layers.1.mlp.wi_up.kernel" not in names
    assert names["tok_embed.embedding"].dtype == torch.bfloat16
    buffers = dict(model.named_buffers())
    assert buffers["layers.0.self_attn.query.kernel_q"].shape == (128, 4 * 32)
    # the [E, H, D] kernel's per-D scale, repeated over the 4 heads
    scale = buffers["layers.0.self_attn.query.kernel_scale"].reshape(4, 32)
    assert torch.equal(scale, scale[:1].expand(4, 32))
    plain = LlamaLM.from_state_dict(cfg, from_flax_params(params), "cpu")
    assert state_bytes(model.state_dict()) < 0.6 * state_bytes(plain.state_dict())


def test_trainable_model_refuses_quantization(tiny):
    _, params, qparams = tiny
    cfg = llama_tiny(vocab_size=VOCAB, max_len=MAX_LEN)
    with pytest.raises(ValueError, match="serving only"):
        init_params(cfg, 0, "cpu", trainable=True, quantize=True)
    with pytest.raises(ValueError, match="serving only"):
        LlamaLM.from_state_dict(cfg, from_flax_params(qparams), "cpu", trainable=True)
    state = from_flax_params(params)
    state["tok_embed.embedding"] = quantize_array(state["tok_embed.embedding"])
    with pytest.raises(ValueError, match="only dense kernels"):
        LlamaLM.from_state_dict(cfg, state, "cpu")


def test_load_model_prints_the_weight_bytes(tiny, tmp_path, capsys):
    _, params, _ = tiny
    model = _port(from_flax_params(params))
    export_params(types.SimpleNamespace(model=model), str(tmp_path))
    served = serve_lm.load_model(torch.device("cpu"), max_len=MAX_LEN, artifact=str(tmp_path),
                                 quantize="int8")
    line = capsys.readouterr().out.strip()
    assert line.startswith("int8 weights-only quantization: params ")
    before, after = (float(v) for v in line.split("params ")[1].removesuffix(" MB").split(" MB -> "))
    assert after < before
    assert after == round(state_bytes(served.state_dict()) / 1e6, 1)
    with pytest.raises(ValueError, match="quantize must be"):
        serve_lm.load_model(torch.device("cpu"), max_len=MAX_LEN, quantize="int4")
    # the same prompt, greedy, through the loaded int8 model and the model
    # built from the quantized state in the process
    ids = torch.as_tensor(_ids(8, (1, 9)))
    want = generate(_port(quantize_state(from_flax_params(params))), ids, 8)
    assert torch.equal(generate(served, ids, 8), want)
