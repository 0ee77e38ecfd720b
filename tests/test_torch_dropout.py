"""Dropout in the port (flax's ``nn.Dropout`` at the reference's sites),
on the CPU.

Masks cannot match the JAX package's threefry draws, so dropout is held
to its law, and the port to the reference's configuration:

- ``dropout(x, rate, None)`` is x itself, rate 0 too, rate 1 zeros;
- with a generator, over 2^20 elements at rate 0.1, the kept share is
  within 4 standard deviations (4 sqrt(0.9 * 0.1 / n)) of 0.9, every
  kept element is x / 0.9 exactly (float32) and every other one 0; the
  same seed gives the same masks, another rank another;
- every family's training forward draws (and differs from the forward
  that does not train, which equals the eval forward exactly); a
  training forward with no generator raises; the ``Trainer`` seeds the
  generator from ``TrainerConfig.dropout_seed`` and the rank, so a run
  repeats and another seed differs, and its ``eval_step`` draws nothing;
- a serving model (llama at dropout 0.1, a generator set) draws no mask
  in ``generate`` or in the paged pool, and its tokens equal those of the
  same weights at dropout 0;
- the defaults are the reference's: ``TransformerConfig.dropout`` 0.1,
  llama_tiny and the 7B shape 0 (the reference's explicit values), the
  encoder families 0.1.
"""

import math

import numpy as np
import pytest
import torch

from tf_operator_tpu.models import bert as jbert
from tf_operator_tpu.models import llama as jllama
from tf_operator_tpu.models import t5 as jt5
from tf_operator_tpu.models import vit as jvit
from tf_operator_tpu.models.transformer import TransformerConfig as JTransformerConfig

from tf_operator_tpu_torch.models import bert, t5, vit
from tf_operator_tpu_torch.models.batching import PagedContinuousBatchingDecoder
from tf_operator_tpu_torch.models.decode import generate
from tf_operator_tpu_torch.models.llama import LlamaLM, llama_7b_shape, llama_loss, llama_tiny
from tf_operator_tpu_torch.models.transformer import (
    TransformerConfig,
    dropout,
    set_dropout_rng,
)
from tf_operator_tpu_torch.models.weights import init_params
from tf_operator_tpu_torch.parallel.trainer import Trainer, TrainerConfig, dropout_generator

torch.set_num_threads(2)

RATE = 0.1


def test_dropout_is_the_identity_without_a_generator_or_at_rate_zero():
    x = torch.randn(64, 32)
    g = torch.Generator().manual_seed(0)
    assert dropout(x, RATE, None) is x
    assert dropout(x, 0.0, g) is x
    assert torch.equal(dropout(x, 1.0, g), torch.zeros_like(x))


def test_dropout_law():
    n = 1 << 20
    x = torch.randn(n)
    y = dropout(x, RATE, torch.Generator().manual_seed(1))
    kept = y != 0
    share = kept.float().mean().item()
    sigma = math.sqrt((1 - RATE) * RATE / n)
    assert abs(share - (1 - RATE)) <= 4 * sigma, share
    torch.testing.assert_close(y[kept], x[kept] / (1 - RATE), atol=0, rtol=0)
    # the same seed gives the same masks; another seed or rank others
    again = dropout(x, RATE, torch.Generator().manual_seed(1))
    assert torch.equal(y, again)
    r0, r1 = (dropout(x, RATE, dropout_generator(5, rank, "cpu")) for rank in (0, 1))
    assert torch.equal(r0, dropout(x, RATE, dropout_generator(5, 0, "cpu")))
    assert not torch.equal(r0 != 0, r1 != 0)
    assert not torch.equal(r0 != 0, dropout(x, RATE, dropout_generator(6, 0, "cpu")) != 0)
    # bf16 keeps its dtype, the kept values x / 0.9 rounded once
    xb = x[:4096].bfloat16()
    yb = dropout(xb, RATE, torch.Generator().manual_seed(2))
    assert yb.dtype == torch.bfloat16
    torch.testing.assert_close(yb[yb != 0], (xb[yb != 0] / (1 - RATE)), atol=0, rtol=0)


def _families():
    """(name, model at dropout 0.1 in train mode, its inputs)."""

    r = np.random.default_rng(3)
    out = []
    for name, cls, cfg, ins in (
        ("llama", LlamaLM, llama_tiny(vocab_size=64, max_len=16, dropout=RATE,
                                      dtype=torch.float32),
         (torch.tensor(r.integers(0, 64, (2, 16))),)),
        ("bert", bert.BertForPretraining, bert.bert_tiny(64, 16, dtype=torch.float32),
         (torch.tensor(r.integers(0, 64, (2, 16))),)),
        ("t5", t5.T5, t5.t5_tiny(64, dtype=torch.float32),
         (torch.tensor(r.integers(0, 64, (2, 12))), torch.tensor(r.integers(0, 64, (2, 8))))),
        ("vit", vit.ViT, vit.vit_tiny(32, dtype=torch.float32),
         (torch.tensor(r.random((2, 32, 32, 3)).astype(np.float32)),)),
    ):
        assert (cfg.base if name == "vit" else cfg).dropout == RATE
        state = init_params(cfg, 0, "cpu", trainable=True, family=cls)
        out.append((name, cls.from_state_dict(cfg, state, "cpu", trainable=True), ins))
    return out


@pytest.mark.parametrize("index", range(4), ids=["llama", "bert", "t5", "vit"])
def test_every_family_draws_only_in_a_training_forward(index):
    name, model, ins = _families()[index]
    with torch.no_grad():
        plain = model(*ins)
        with pytest.raises(ValueError, match="dropout_rng"):
            model(*ins, train=True)
        g = torch.Generator().manual_seed(7)
        set_dropout_rng(model, g)
        state = g.get_state()
        assert torch.equal(model(*ins), plain)  # no train: no draw
        assert torch.equal(g.get_state(), state)
        a = model(*ins, train=True)
        assert not torch.equal(g.get_state(), state)
        b = model(*ins, train=True)
        assert torch.isfinite(a).all() and not torch.equal(a, plain) and not torch.equal(a, b)
        set_dropout_rng(model, torch.Generator().manual_seed(7))
        assert torch.equal(model(*ins, train=True), a)  # the same seed, the same masks
        assert torch.equal(model.eval()(*ins, train=False), plain)


def _llama_trainer(seed, dropout_seed):
    cfg = llama_tiny(vocab_size=64, max_len=16, dropout=RATE, dtype=torch.float32)
    model = LlamaLM.from_state_dict(cfg, init_params(cfg, seed, "cpu", trainable=True), "cpu",
                                    trainable=True)
    return Trainer(model, TrainerConfig(learning_rate=1e-3, dropout_seed=dropout_seed),
                   llama_loss)


def test_the_trainer_seeds_dropout_and_a_run_repeats():
    batch = {"input_ids": np.random.default_rng(4).integers(0, 64, (4, 16)).astype(np.int32)}
    runs = {}
    for key, ds in (("a", 0), ("again", 0), ("other", 1)):
        t = _llama_trainer(0, ds)
        assert t.model.dropout_rng is t.dropout_rng
        runs[key] = [float(t.train_step(batch)["loss"]) for _ in range(3)]
    assert runs["a"] == runs["again"]
    assert runs["a"] != runs["other"]
    # eval_step draws nothing: its loss is the forward that does not train
    t = _llama_trainer(0, 0)
    state = t.dropout_rng.get_state()
    got = float(t.eval_step(batch)["loss"])
    assert torch.equal(t.dropout_rng.get_state(), state)
    with torch.no_grad():
        t.model.eval()
        want = float(llama_loss(t.model, {"input_ids": torch.tensor(batch["input_ids"])})[0])
    assert got == want


def test_a_serving_model_draws_no_mask():
    cfg = llama_tiny(vocab_size=256, max_len=64, dropout=RATE)
    state = init_params(cfg, 2, "cpu")
    model = LlamaLM(cfg)  # a serving module built directly: train mode, dropout 0.1
    model.load_state_dict(state, assign=True)
    assert model.training
    g = torch.Generator().manual_seed(0)
    set_dropout_rng(model, g)
    before = g.get_state()
    ref = LlamaLM.from_state_dict(llama_tiny(vocab_size=256, max_len=64, dropout=0.0), state,
                                  "cpu")
    prompt = torch.tensor([list(b"the sharded ")])
    assert torch.equal(generate(model, prompt, 10), generate(ref, prompt, 10))
    rows = []
    for m in (model, ref):
        pool = PagedContinuousBatchingDecoder(m, slots=2, steps_per_sync=3, kv_block_size=8,
                                              kv_blocks=24)
        rids = [pool.submit(torch.tensor(list(p)), n) for p, n in ((b"abc de", 6),
                                                                   (b"the sharded", 5))]
        pool.run()
        rows.append([pool.result(r).tolist() for r in rids])
    assert rows[0] == rows[1]
    assert torch.equal(g.get_state(), before)


def test_defaults_are_the_reference_configurations():
    assert TransformerConfig().dropout == JTransformerConfig().dropout == 0.1
    assert llama_tiny().dropout == jllama.llama_tiny().cfg.dropout == 0.0
    assert llama_7b_shape().dropout == jllama.llama_7b_shape().cfg.dropout == 0.0
    assert bert.bert_base().dropout == jbert.bert_base().cfg.dropout == 0.1
    assert bert.bert_tiny().dropout == jbert.bert_tiny().cfg.dropout == 0.1
    assert t5.t5_base().dropout == jt5.t5_base().cfg.dropout == 0.1
    assert vit.vit_b16().base.dropout == jvit.vit_b16().cfg.dropout == 0.1
    assert llama_tiny(dropout=RATE).dropout == RATE
