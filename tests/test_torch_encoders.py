"""The port's encoder families (BERT, T5, ViT) against the JAX package's,
on the CPU.

One flax param tree per family (``bert_tiny``, ``t5_tiny``, ``vit_tiny``)
is bridged into the port (``models/weights.family_state_from_flax``);
both sides get the same seeded numpy inputs, dropout 0 or a forward
that does not train.  Tolerances, each as max |port - JAX| over max
|JAX| of the compared tensor:

- the pieces: LayerNorm against ``flax.linen.LayerNorm`` 1e-6 in float32
  (the same float32 statistics in another summation order) and one bf16
  rounding of its output (2^-8) in bf16; gelu against ``jax.nn.gelu``
  (the tanh form) 1e-6 in float32, one bf16 rounding in bf16; T5's
  buckets exactly, for every offset in [-1024, 1024];
- the forwards: float32 1e-5 (two layers of float32 products summed in
  another order), bf16 2e-2 (the frameworks round bf16 activations at
  other points; 2.5 bf16 ulps of the largest logit);
- one step's loss (float32, rtol 1e-5) and every gradient (float32: 1e-4
  of each tensor's largest element, backward sums in another order, plus
  1e-6 of the model's largest gradient element, because the key biases'
  gradients are zero in exact arithmetic: a bias shared by every key
  shifts a row's logits by a constant, and both sides leave float32
  noise there);
- three ``Trainer`` steps against the JAX ``Trainer`` (float32, AdamW,
  warmup, clip): loss rtol 1e-5 and grad norm rtol 1e-4 a step, as
  ``tests/test_torch_training.py`` holds llama.

Also: BERT's attention mask (as ``tests/test_models.py``), its segment
table, the patch embedding against the stride-p convolution and its
refusals (as ``tests/test_vit.py``), the bridge both ways, the logical
shardings against the JAX trainer's layout, and the refusals the port
adds (an encoder window, sequence parallelism).
"""

import types

import flax
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.models import bert as jbert
from tf_operator_tpu.models import t5 as jt5
from tf_operator_tpu.models import vit as jvit
from tf_operator_tpu.parallel import Trainer as JTrainer
from tf_operator_tpu.parallel import TrainerConfig as JTrainerConfig
from tf_operator_tpu.parallel import make_mesh as j_make_mesh
from tf_operator_tpu.parallel import mesh as jmesh
from tf_operator_tpu.parallel import sharding as jsharding

from tf_operator_tpu_torch import bert_pretrain, t5_multihost
from tf_operator_tpu_torch.models import bert, t5, vit
from tf_operator_tpu_torch.models.transformer import (
    EncoderLayer,
    LayerNorm,
    MlpBlock,
    TransformerConfig,
)
from tf_operator_tpu_torch.models.weights import (
    family_state_from_flax,
    init_params,
)
from tf_operator_tpu_torch.parallel import mesh, sharding
from tf_operator_tpu_torch.parallel.trainer import Trainer, TrainerConfig

torch.set_num_threads(2)

VOCAB, SEQ, ENC, DEC, BATCH, IMAGE = 128, 16, 12, 8, 2, 32
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
FWD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
BF16_ROUND = 2.0 ** -8


def _unbox(tree):
    return jax.tree_util.tree_map(np.asarray, flax.core.meta.unbox(tree))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _inputs(family, seed, batch=BATCH):
    r = np.random.default_rng(seed)
    if family == "bert":
        return (r.integers(0, VOCAB, (batch, SEQ)).astype(np.int32),)
    if family == "t5":
        return (r.integers(0, VOCAB, (batch, ENC)).astype(np.int32),
                r.integers(0, VOCAB, (batch, DEC)).astype(np.int32))
    return (r.random((batch, IMAGE, IMAGE, 3)).astype(np.float32),)


def _jax_model(family, jdtype=jnp.float32, **kw):
    if family == "bert":
        return jbert.bert_tiny(vocab_size=VOCAB, max_len=SEQ, dtype=jdtype, **kw)
    if family == "t5":
        return jt5.t5_tiny(vocab_size=VOCAB, dtype=jdtype, **kw)
    return jvit.vit_tiny(image_size=IMAGE, dtype=jdtype, **kw)


#: family -> (port class, config builder)
PORT = {"bert": (bert.BertForPretraining, lambda **kw: bert.bert_tiny(VOCAB, SEQ, **kw)),
        "t5": (t5.T5, lambda **kw: t5.t5_tiny(VOCAB, **kw)),
        "vit": (vit.ViT, lambda **kw: vit.vit_tiny(IMAGE, **kw))}
FAMILIES = sorted(PORT)


def _port_model(family, state, dtype=torch.float32, trainable=False, **kw):
    cls, build = PORT[family]
    return cls.from_state_dict(build(dtype=dtype, **kw), state, "cpu", trainable=trainable)


def _jax_params(family, seed=0):
    jm = _jax_model(family)
    return _unbox(jm.init(jax.random.PRNGKey(seed), *_inputs(family, 0), train=False)["params"])


def _batch(family, seed, batch=BATCH):
    """The loss's batch: seeded numpy inputs and targets."""

    r = np.random.default_rng(seed + 100)
    ins = _inputs(family, seed, batch)
    if family == "bert":
        out = bert_pretrain.synthetic_mlm_batch(seed, batch, SEQ, VOCAB)
        out["labels"][:, 0] = r.integers(0, VOCAB, batch)  # at least one label a row
        return out
    if family == "t5":
        return {"encoder_ids": ins[0], "decoder_ids": ins[1],
                "targets": r.integers(0, VOCAB, (batch, DEC)).astype(np.int32)}
    return {"image": ins[0], "label": r.integers(0, 10, batch).astype(np.int32)}


JAX_LOSS = {"bert": jbert.mlm_loss, "t5": jt5.seq2seq_loss, "vit": jvit.vit_loss}
PORT_LOSS = {"bert": bert.mlm_loss, "t5": t5.seq2seq_loss, "vit": vit.vit_loss}
METRIC = {"bert": "mlm_accuracy", "t5": "token_accuracy", "vit": "accuracy"}


# -- the pieces ---------------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_layernorm_matches_flax(dtype):
    tdt, jdt = DTYPES[dtype]
    r = np.random.default_rng(1)
    # an offset mean, so the fast variance E[x^2] - E[x]^2 is exercised
    x = (r.standard_normal((3, 5, 48)) * 2 + 3).astype(np.float32)
    scale = r.standard_normal(48).astype(np.float32)
    bias = r.standard_normal(48).astype(np.float32)
    ln = fnn.LayerNorm(dtype=jdt)
    want = ln.apply({"params": {"scale": scale, "bias": bias}}, jnp.asarray(x, jdt))
    mod = LayerNorm(TransformerConfig(hidden=48, dtype=tdt), trainable=True)
    mod.load_state_dict({"scale": torch.tensor(scale), "bias": torch.tensor(bias)})
    got = mod(torch.tensor(x).to(tdt))
    assert got.dtype == tdt
    assert _rel(got.detach().float(), np.asarray(want, np.float32)) <= (
        1e-6 if dtype == "float32" else BF16_ROUND)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_gelu_matches_jax(dtype):
    tdt, jdt = DTYPES[dtype]
    x = np.linspace(-6, 6, 4097).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x, jdt)), np.float32)
    got = torch.nn.functional.gelu(torch.tensor(x).to(tdt), approximate="tanh").float()
    assert _rel(got, want) <= (1e-6 if dtype == "float32" else BF16_ROUND)
    # the erf form PyTorch defaults to is another function
    erf = torch.nn.functional.gelu(torch.tensor(x)).numpy()
    assert np.abs(erf - np.asarray(jax.nn.gelu(jnp.asarray(x)))).max() > 1e-4


@pytest.mark.parametrize("bidirectional,num_buckets,max_distance",
                         [(True, 32, 128), (False, 32, 128), (True, 16, 64), (False, 8, 20)])
def test_relative_position_bucket_matches_jax_exactly(bidirectional, num_buckets, max_distance):
    rel = np.arange(-1024, 1025)[None, :]
    want = np.asarray(jt5._relative_position_bucket(jnp.asarray(rel), bidirectional,
                                                    num_buckets, max_distance))
    got = t5.relative_position_bucket(torch.tensor(rel), bidirectional, num_buckets,
                                      max_distance).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bidirectional", [True, False])
def test_relative_position_bias_matches_jax(bidirectional):
    cfg = jt5.TransformerConfig(n_heads=4, dtype=jnp.float32)
    jm = jt5.RelativePositionBias(cfg, bidirectional=bidirectional)
    params = _unbox(jm.init(jax.random.PRNGKey(2), 7, 11)["params"])
    want = np.asarray(jm.apply({"params": params}, 7, 11))
    mod = t5.RelativePositionBias(TransformerConfig(n_heads=4), trainable=True,
                                  bidirectional=bidirectional)
    mod.load_state_dict({"rel_embedding": torch.tensor(params["rel_embedding"])})
    got = mod(7, 11)
    assert got.shape == (1, 4, 7, 11) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.detach().numpy(), want)


# -- the families' forwards ---------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("family", FAMILIES)
def test_forward_matches_jax(family, dtype):
    tdt, jdt = DTYPES[dtype]
    params = _jax_params(family)
    ins = _inputs(family, 3)
    want = np.asarray(_jax_model(family, jdt).apply({"params": params}, *ins, train=False))
    model = _port_model(family, family_state_from_flax(params), tdt)
    got = model(*(torch.tensor(a) for a in ins))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert _rel(got.detach(), want) <= FWD_TOL[dtype]


@pytest.mark.parametrize("family", FAMILIES)
def test_bridge_round_trip(family):
    params = _jax_params(family)
    state = family_state_from_flax(params)
    model = _port_model(family, state)
    assert set(state) == {n for n, _ in model.named_parameters()}
    # the model's flax_path is the bridge's inverse
    flat = flax.traverse_util.flatten_dict(params, sep="/")
    assert {model.flax_path(n) for n in state} == set(flat)
    for n, t in state.items():
        np.testing.assert_array_equal(t.numpy(), flat[model.flax_path(n)])


def test_bert_attention_mask_matches_jax_and_hides_padding():
    params = _jax_params("bert")
    ids = _inputs("bert", 4, batch=4)[0]
    m = np.ones((4, SEQ), np.int32)
    m[:, 12:] = 0
    jm = _jax_model("bert", dropout=0.0)
    want = np.asarray(jm.apply({"params": params}, ids, attention_mask=m, train=False))
    model = _port_model("bert", family_state_from_flax(params))
    got = model(torch.tensor(ids), attention_mask=torch.tensor(m)).detach()
    assert _rel(got, want) <= FWD_TOL["float32"]
    # padding positions do not change the unmasked positions' outputs
    ids2 = ids.copy()
    ids2[:, 12:] = 7
    got2 = model(torch.tensor(ids2), attention_mask=torch.tensor(m)).detach()
    np.testing.assert_allclose(got2[:, :12].numpy(), got[:, :12].numpy(), atol=1e-5)


def test_bert_segments_match_jax():
    cfg = jbert.TransformerConfig(vocab_size=VOCAB, hidden=64, n_heads=2, head_dim=32,
                                  n_layers=1, mlp_dim=128, max_len=SEQ, dtype=jnp.float32)
    ids = _inputs("bert", 5)[0]
    seg = np.random.default_rng(5).integers(0, 2, ids.shape).astype(np.int32)
    jm = jbert.Bert(cfg)
    params = _unbox(jm.init(jax.random.PRNGKey(5), ids, segment_ids=seg)["params"])
    want = np.asarray(jm.apply({"params": params}, ids, segment_ids=seg))
    pcfg = TransformerConfig(vocab_size=VOCAB, hidden=64, n_heads=2, head_dim=32, n_layers=1,
                             mlp_dim=128, max_len=SEQ, dtype=torch.float32)
    model = bert.Bert.from_state_dict(pcfg, family_state_from_flax(params), "cpu",
                                      segments=True)
    got = model(torch.tensor(ids), segment_ids=torch.tensor(seg)).detach()
    assert _rel(got, want) <= FWD_TOL["float32"]
    with pytest.raises(ValueError, match="segments"):
        bert.Bert(pcfg, device="meta")(torch.tensor(ids), segment_ids=torch.tensor(seg))


def test_patch_embed_is_the_stride_p_convolution():
    cfg = TransformerConfig(hidden=16, dtype=torch.float32)
    pe = vit.PatchEmbed(cfg, 8, 3, trainable=True)
    r = np.random.default_rng(6)
    with torch.no_grad():
        pe.proj.kernel.copy_(torch.tensor(r.standard_normal((192, 16)).astype(np.float32)))
        pe.proj.bias.copy_(torch.tensor(r.standard_normal(16).astype(np.float32)))
    imgs = torch.tensor(r.random((2, 32, 32, 3)).astype(np.float32))
    out = pe(imgs).detach()
    assert out.shape == (2, 16, 16)  # (32 / 8)^2 patches
    # the dense kernel [p*p*C, hidden] as a conv kernel [hidden, C, p, p]
    weight = pe.proj.kernel.detach().reshape(8, 8, 3, 16).permute(3, 2, 0, 1)
    conv = torch.nn.functional.conv2d(imgs.permute(0, 3, 1, 2), weight, pe.proj.bias.detach(),
                                      stride=8)
    np.testing.assert_allclose(out.numpy(), conv.flatten(2).transpose(1, 2).numpy(),
                               atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="not divisible"):
        pe(torch.zeros(1, 36, 36, 3))
    with pytest.raises(ValueError, match="channels"):
        pe(torch.zeros(1, 32, 32, 1))


def test_vit_refuses_too_many_patches():
    model = vit.ViT(vit.vit_tiny(), trainable=True)  # 16 patches at 32 px, patch 8
    with pytest.raises(ValueError, match="patches"):
        model(torch.zeros(1, 64, 64, 3))


FULL_WIDTH = {
    "bert_base": (lambda: jbert.bert_base(max_len=128), (jnp.zeros((1, 128), jnp.int32),),
                  lambda: bert.BertForPretraining(bert.bert_base(max_len=128), device="meta")),
    "t5_base": (jt5.t5_base, (jnp.zeros((1, 64), jnp.int32), jnp.zeros((1, 32), jnp.int32)),
                lambda: t5.T5(t5.t5_base(), device="meta")),
    "vit_b16": (jvit.vit_b16, (jnp.zeros((1, 224, 224, 3)),),
                lambda: vit.ViT(vit.vit_b16(), device="meta")),
}


@pytest.mark.parametrize("name", sorted(FULL_WIDTH))
def test_full_width_shapes_equal_the_jax_models(name):
    jmodel, args, port = FULL_WIDTH[name]
    abstract = jax.eval_shape(lambda: jmodel().init(jax.random.PRNGKey(0), *args,
                                                    train=False))["params"]
    flat = flax.traverse_util.flatten_dict(abstract, sep="/")
    model = port()
    got = {model.flax_path(n): tuple(p.shape) for n, p in model.named_parameters()}
    assert got == {k: tuple(v.value.shape) for k, v in flat.items()}
    if name == "vit_b16":
        n = sum(int(np.prod(s)) for s in got.values())
        assert 85e6 < n < 88e6, f"got {n / 1e6:.1f}M params"


# -- one step and a few trainer steps -----------------------------------------


@pytest.mark.parametrize("family", FAMILIES)
def test_loss_and_gradients_match_jax_grad(family):
    params = _jax_params(family, seed=1)
    batch = _batch(family, 7)
    jm = _jax_model(family, dropout=0.0)
    state = types.SimpleNamespace(apply_fn=jm.apply)

    def loss_of(p):
        loss, aux = JAX_LOSS[family](p, state, batch, jax.random.PRNGKey(0), train=False)
        return loss, aux["metrics"][METRIC[family]]

    (jloss, jmetric), jgrads = jax.value_and_grad(loss_of, has_aux=True)(params)
    model = _port_model(family, family_state_from_flax(params), trainable=True, dropout=0.0)
    loss, metrics = PORT_LOSS[family](model, {k: torch.tensor(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(metrics[METRIC[family]]), float(jmetric))
    want = {n: t.numpy() for n, t in family_state_from_flax(jgrads).items()}
    floor = 1e-6 * max(np.abs(g).max() for g in want.values())
    for name, p in model.named_parameters():
        err = np.abs(p.grad.numpy() - want[name]).max()
        assert err <= 1e-4 * np.abs(want[name]).max() + floor, name


#: the JAX entry's loss per family, and the trainer step's config
TRAIN_CFG = TrainerConfig(learning_rate=1e-3, weight_decay=0.1, warmup_steps=2, total_steps=6,
                          grad_clip=0.5, optimizer="adamw")


def _jax_trainer(family, batch):
    mesh = j_make_mesh({"dp": 1}, devices=jax.devices()[:1])
    jcfg = JTrainerConfig(**{f: getattr(TRAIN_CFG, f) for f in (
        "learning_rate", "weight_decay", "warmup_steps", "total_steps", "grad_clip",
        "optimizer", "accum_steps")})
    init = tuple(batch[k] for k in {"bert": ("input_ids",), "t5": ("encoder_ids", "decoder_ids"),
                                    "vit": ("image",)}[family])
    return JTrainer(_jax_model(family, dropout=0.0), jcfg, mesh, JAX_LOSS[family], batch,
                    init_args=init, shardings="logical")


@pytest.mark.parametrize("family", FAMILIES)
def test_trainer_matches_the_jax_trainer(family):
    batches = [_batch(family, s, batch=4) for s in (11, 12, 13)]
    jt = _jax_trainer(family, batches[0])
    model = _port_model(family, family_state_from_flax(_unbox(jt.state.params)), trainable=True,
                        dropout=0.0)
    pt = Trainer(model, TRAIN_CFG, PORT_LOSS[family])
    for batch in batches:
        jm = jt.train_step(jt.shard_batch(batch))
        pm = pt.train_step(batch)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    assert pt.optimizer.count == 3


# -- layout and refusals ------------------------------------------------------


def _jspec(sharding_or_spec, ndim):
    spec = getattr(sharding_or_spec, "spec", sharding_or_spec)
    out = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    return tuple(tuple(e) if isinstance(e, list) else e for e in out)


@pytest.mark.parametrize("fsdp", [2, 4])
@pytest.mark.parametrize("family", FAMILIES)
def test_logical_shardings_match_the_jax_trainer_layout(family, fsdp):
    jm = jmesh.make_mesh({"fsdp": fsdp}, devices=jax.devices()[:fsdp])
    jmodel = {"bert": lambda: jbert.bert_tiny(vocab_size=VOCAB, max_len=SEQ, mesh=jm),
              "t5": lambda: jt5.t5_tiny(vocab_size=VOCAB, mesh=jm),
              "vit": lambda: jvit.vit_tiny(image_size=IMAGE, mesh=jm)}[family]()
    args = tuple(jnp.zeros((fsdp,) + a.shape[1:], a.dtype) for a in _inputs(family, 0))
    abstract = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), *args,
                                                  train=False))["params"]
    with jm, fnn.logical_axis_rules(list(jsharding.LOGICAL_RULES)):
        sh = flax.traverse_util.flatten_dict(jsharding.logical_shardings(abstract, jm), sep="/")
    flat = flax.traverse_util.flatten_dict(abstract, sep="/")
    cls, build = PORT[family]
    model = cls(build(), device="meta", trainable=True)
    shapes = {n: p.shape for n, p in model.named_parameters()}
    got = sharding.logical_shardings(shapes, mesh.make_mesh({"fsdp": fsdp}, world=fsdp))
    assert {model.flax_path(n) for n in got} == set(flat)
    for n, spec in got.items():
        path = model.flax_path(n)
        assert spec == _jspec(sh[path], len(flat[path].value.shape)), n
    assert any("fsdp" in str(s) for s in got.values())


def test_encoder_refusals():
    with pytest.raises(NotImplementedError, match="causal self-attention"):
        EncoderLayer(TransformerConfig(hidden=64, n_heads=2, head_dim=32, mlp_dim=64,
                                       window=4, dtype=torch.float32),
                     trainable=True)(torch.zeros(1, 8, 64))
    with pytest.raises(ValueError, match="activation"):
        MlpBlock(TransformerConfig(), device="meta", activation="tanh")

    class SpMesh:
        shape = {"sp": 2}

    for cls, cfg in ((bert.Bert, bert.bert_tiny()), (t5.T5, t5.t5_tiny())):
        with pytest.raises(NotImplementedError, match="sequence parallelism"):
            cls(TransformerConfig(**{**cfg.__dict__, "mesh": SpMesh()}), device="meta")


def test_init_params_draws_every_family_at_the_flax_scales():
    for family in FAMILIES:
        cls, build = PORT[family]
        state = init_params(build(), 0, "cpu", trainable=True, family=cls)
        names = {n for n, _ in cls(build(), device="meta").named_parameters()}
        assert set(state) == names
        for n, t in state.items():
            assert t.dtype == torch.float32, n
            if n.endswith(".scale"):
                assert torch.equal(t, torch.ones_like(t)), n
            elif n.endswith(".bias"):
                assert torch.equal(t, torch.zeros_like(t)), n
            elif n.split(".")[-1] in ("embedding", "pos_embed", "rel_embedding"):
                assert 0.015 < float(t.std()) < 0.025, n
    assert torch.equal(init_params(t5.t5_tiny(), 3, "cpu", family=t5.T5)["dec_1.mlp.wo.kernel"],
                       init_params(t5.t5_tiny(), 3, "cpu", family=t5.T5)["dec_1.mlp.wo.kernel"])


def test_synthetic_batches_are_the_reference_examples():
    import examples.bert_pretrain as jb_entry
    import examples.t5_multihost as jt_entry

    a, b = bert_pretrain.synthetic_mlm_batch(3, 4, 16, 1024), jb_entry.synthetic_mlm_batch(
        3, 4, 16, 1024)
    c = t5_multihost.synthetic_seq2seq_batch(0, 4, 12, 8, 1024)
    d = jt_entry.synthetic_seq2seq_batch(0, 4, 12, 8, 1024)
    for x, y in ((a, b), (c, d)):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
