"""The port's gpt family (models/gpt.py: ``CausalLM``, learned positions,
relu MLPs with biases, the tied head) against the JAX package's, on the
CPU, at ``gpt_tiny``'s widths (2 layers, hidden 128, vocab 128).

One flax param tree is bridged into the port
(``models/weights.from_flax_params``); both sides get the same seeded
numpy inputs.  Tolerances, each as max |port - JAX| over max |JAX|:

- forward logits: float32 1e-5, bf16 2e-2 (``tests/torch_zoo.FWD_TOL``);
- one step's loss at dropout 0 (float32, rtol 1e-5) and every gradient
  (``torch_zoo.assert_grads_match``: 1e-4 of each tensor's largest
  element plus 1e-6 of the model's largest);
- three ``Trainer`` steps against the JAX ``Trainer`` (float32, AdamW,
  warmup, clip): loss rtol 1e-5 and grad norm rtol 1e-4 a step;
- greedy tokens exactly: ``generate``, the chunked decoder and the
  contiguous slot pool against JAX ``generate`` (float32), and int8
  (``quantize_state`` = ``quantize_tree``; the projections run the int8
  matmul's plain version here) logits atol 1e-4 and tokens exactly.

Also: the learned table read at the cache's positions (refused past it
for a shared index, clamped for a seat), the paged refusals, the
sequence-parallel refusal, gpt_small's full-width shapes and parameter
count, the logical shardings against the JAX trainer's layout and the
seeded init's scales.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.models import gpt as jgpt
from tf_operator_tpu.models.decode import generate as j_generate
from tf_operator_tpu.ops import quant as jquant

import torch_zoo as zoo
from tf_operator_tpu_torch.models import gpt
from tf_operator_tpu_torch.models.batching import (
    ContinuousBatchingDecoder,
    PagedContinuousBatchingDecoder,
)
from tf_operator_tpu_torch.models.decode import (
    ChunkedServingDecoder,
    generate,
    init_cache,
    paged_arena,
    paged_decode_variant,
)
from tf_operator_tpu_torch.models.kv_blocks import NotPageableError
from tf_operator_tpu_torch.models.transformer import DecodeCache, TransformerConfig
from tf_operator_tpu_torch.models.weights import from_flax_params, init_params
from tf_operator_tpu_torch.ops import quant_matmul as qm
from tf_operator_tpu_torch.ops.quant import quantize_state

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tiny():
    return zoo.bridged("gpt", seed=1)


@pytest.mark.parametrize("dtype", sorted(zoo.DTYPES))
def test_forward_matches_jax(dtype):
    params = zoo.jax_params("gpt", seed=2)
    tdtype, jdtype = zoo.DTYPES[dtype]
    x = zoo.ids(3, (2, 24))
    want = zoo.jax_model("gpt", jdtype).apply({"params": params}, jnp.asarray(x))
    model = zoo.port_model("gpt", from_flax_params(params), tdtype)
    got = model(torch.as_tensor(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 24, zoo.VOCAB)
    assert zoo.rel(got.numpy(), want) <= zoo.FWD_TOL[dtype]


def test_loss_and_gradients_match_jax_grad():
    params = zoo.jax_params("gpt", seed=4)
    batch = {"input_ids": zoo.ids(5, (2, 20))}
    jloss, jmetrics, jgrads = zoo.jax_loss_and_grads("gpt", params, batch)
    model = zoo.port_model("gpt", from_flax_params(params), trainable=True, dropout=0.0)
    loss, metrics = gpt.lm_loss(model, {"input_ids": torch.as_tensor(batch["input_ids"])})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=1e-5)
    np.testing.assert_allclose(float(metrics["token_accuracy"]), jmetrics["token_accuracy"])
    zoo.assert_grads_match(model, jgrads)


def test_trainer_matches_the_jax_trainer():
    zoo.trainer_matches("gpt")


# -- decoding ---------------------------------------------------------------


def _full_recompute(model, prompt, n):
    ids = torch.as_tensor(prompt).long()
    with torch.no_grad():
        for _ in range(n):
            nxt = model(ids)[:, -1].argmax(-1)
            ids = torch.cat([ids, nxt[:, None]], dim=1)
    return ids.numpy()


def test_cached_greedy_matches_jax_generate(tiny):
    jm, params, model = tiny
    prompt = zoo.ids(6, (2, 5))
    want = np.asarray(j_generate(jm, params, jnp.asarray(prompt), max_new_tokens=8))
    got = generate(model, torch.as_tensor(prompt), 8).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_full_recompute(model, prompt, 8), want)
    # 37 = 32 + 4 + 1: three prefill chunks, each read at the cache's index
    long_prompt = zoo.ids(7, (1, 37))
    want = np.asarray(j_generate(jm, params, jnp.asarray(long_prompt), max_new_tokens=6))
    got = ChunkedServingDecoder(model).generate(torch.as_tensor(long_prompt), 6).numpy()
    np.testing.assert_array_equal(got, want)


def test_slot_pool_tokens_match_jax_generate(tiny):
    # the JAX pool is not the yardstick here: at this random init the
    # logits hold near-ties that its batched step breaks otherwise than
    # its own generate does; the port's pool matches JAX generate
    jm, params, model = tiny
    prompts = [zoo.ids(20 + i, (n,)) for i, n in enumerate((6, 11, 3))]
    pool = ContinuousBatchingDecoder(model, slots=2)
    rids = [pool.submit(p, max_new_tokens=7) for p in prompts]
    pool.run()
    for rid, p in zip(rids, prompts):
        want = np.asarray(j_generate(jm, params, jnp.asarray(p)[None], max_new_tokens=7))[0]
        np.testing.assert_array_equal(np.asarray(pool.result(rid)), want)


def test_learned_positions_follow_the_cache():
    cfg = gpt.gpt_tiny(32, 8, dtype=torch.float32)
    table = torch.arange(8 * cfg.hidden, dtype=torch.float32).reshape(8, cfg.hidden)
    got = gpt.learned_positions(table, 3, None, torch.float32)
    assert torch.equal(got, table[None, :3])
    shared = DecodeCache([], index=5)
    assert torch.equal(gpt.learned_positions(table, 3, shared, torch.float32), table[None, 5:])
    with pytest.raises(ValueError, match="exceed the learned position table"):
        gpt.learned_positions(table, 4, shared, torch.float32)
    with pytest.raises(ValueError, match="exceeds the learned position table"):
        gpt.learned_positions(table, 9, None, torch.float32)
    # per seat: each row at its own position; a seat past the table (its
    # steps after the budget, never kept) reads the last row
    seats = DecodeCache([], index=torch.tensor([0, 6, 7]))
    got = gpt.learned_positions(table, 2, seats, torch.float32)
    assert torch.equal(got, table[torch.tensor([[0, 1], [6, 7], [7, 7]])])
    # the decode forward reads it at the index: one position past max_len raises
    model = gpt.CausalLM(cfg, trainable=True)
    dmodel = model.variant(decode=True)
    cache = init_cache(dmodel, 1)
    cache.index = 8
    with pytest.raises(ValueError, match="exceed the learned position table"):
        dmodel(torch.zeros((1, 1), dtype=torch.long), cache=cache)
    with pytest.raises(ValueError, match="needs a cache"):
        dmodel(torch.zeros((1, 1), dtype=torch.long))


def test_gpt_is_not_pageable(tiny):
    jm, params, model = tiny
    for make in (lambda: paged_decode_variant(model), lambda: paged_arena(model, 4, 16),
                 lambda: PagedContinuousBatchingDecoder(model, slots=2)):
        with pytest.raises(NotPageableError, match="CausalLM is not pageable"):
            make()
    # the JAX package refuses it too
    from tf_operator_tpu.models.batching import PagedContinuousBatchingDecoder as JPaged
    from tf_operator_tpu.models.kv_blocks import NotPageableError as JNotPageable

    with pytest.raises(JNotPageable):
        JPaged(jm, params, slots=2, paged_kernel="off")


def test_int8_matches_jax_quantize_tree(tiny):
    jm, params, _ = tiny
    qparams = jquant.quantize_tree(params)
    state = quantize_state(from_flax_params(params))
    model = zoo.port_model("gpt", state)
    x = zoo.ids(8, (2, 12))
    want = jm.apply({"params": qparams}, jnp.asarray(x))
    qm.plain_calls.clear()
    got = model(torch.as_tensor(x))
    # 6 projections a layer run the int8 matmul; the tied head stays float
    assert sum(qm.plain_calls.values()) == 6 * 2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    prompt = zoo.ids(9, (2, 5))
    want = np.asarray(j_generate(jm, qparams, jnp.asarray(prompt), max_new_tokens=8))
    np.testing.assert_array_equal(generate(model, torch.as_tensor(prompt), 8).numpy(), want)


# -- shapes, layout, refusals ---------------------------------------------------


def test_gpt_small_shapes_equal_the_jax_model():
    jm = jgpt.gpt_small(vocab_size=256, max_len=1024)
    abstract = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                              jnp.zeros((1, 8), jnp.int32)))["params"]
    flat = flax.traverse_util.flatten_dict(abstract, sep="/")
    model = gpt.CausalLM(gpt.gpt_small(vocab_size=256, max_len=1024), device="meta")
    got = {model.flax_path(n): tuple(p.shape) for n, p in model.named_parameters()}
    assert got == {k: tuple(v.value.shape) for k, v in flat.items()}
    n_layers = sum(int(np.prod(s)) for k, s in got.items() if k.startswith("layer_"))
    assert 84.9e6 < n_layers < 85.1e6 and got["pos_embed"] == (1024, 768)
    assert 85.9e6 < sum(int(np.prod(s)) for s in got.values()) < 86.1e6


@pytest.mark.parametrize("fsdp", [2, 4])
def test_logical_shardings_match_the_jax_trainer_layout(fsdp):
    zoo.logical_shardings_match("gpt", fsdp)


def test_sequence_parallelism_is_refused():
    """Sequence parallelism is ported for gpt (``tests/test_torch_sp_zoo.py``
    trains it): ``CausalLM`` builds on an sp mesh, and the refusal is left
    to the encoder families, whose message names the decoder families."""

    from tf_operator_tpu_torch.models.bert import BertForPretraining

    class SpMesh:
        shape = {"sp": 2}

    cfg = TransformerConfig(**{**gpt.gpt_tiny().__dict__, "mesh": SpMesh()})
    assert gpt.CausalLM(cfg, device="meta").cfg.sp_enabled
    with pytest.raises(NotImplementedError,
                       match=r"decoder families \(llama, gpt, moe\); BERT runs with sp 1"):
        BertForPretraining(cfg, device="meta")


def test_init_params_draws_gpt_at_the_flax_scales():
    cfg = gpt.gpt_tiny(256, 64)
    state = init_params(cfg, 0, "cpu", trainable=True, family=gpt.CausalLM)
    assert set(state) == {n for n, _ in gpt.CausalLM(cfg, device="meta").named_parameters()}
    for n, t in state.items():
        if n.endswith(".scale"):
            assert torch.equal(t, torch.ones_like(t)), n
        elif n.endswith(".bias"):
            assert torch.equal(t, torch.zeros_like(t)), n
        elif n in ("pos_embed", "tok_embed.embedding"):
            assert 0.015 < float(t.std()) < 0.025, n
        elif ".mlp." in n:
            # lecun normal over the fan-in
            assert 0.9 < float(t.std()) * t.shape[0] ** 0.5 < 1.1, n
